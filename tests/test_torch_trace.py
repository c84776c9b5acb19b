"""The port's tracer (``webdgs_tpu_torch/trace.py``) on the CPU: off by
default and then silent; the spans a training step, a densify event and a
viewer frame record, with their parents; per-thread parent stacks; the
clock shared with ``torch.profiler``; the slot gauges; and the launch
counters behind ``ops.kernel_launches()``."""

from __future__ import annotations

import dataclasses
import json
import sys
import threading

import numpy as np
import pytest
import torch

from webdgs_tpu_torch import trace
from webdgs_tpu_torch.core.camera import CameraData
from webdgs_tpu_torch.core.scene import scene_from_numpy
from webdgs_tpu_torch.ops import KERNEL_WRAPPERS, kernel_launches
from webdgs_tpu_torch.render.viewer import Viewer
from webdgs_tpu_torch.train.config import TrainerConfig
from webdgs_tpu_torch.train.trainer import Trainer

CPU = torch.device("cpu")
W, H = 64, 48

STEP_SPANS = {("train.step", None), ("project", "train.step"),
              ("bin", "train.step"), ("raster", "train.step"),
              ("loss", "train.step"), ("backward", "train.step"),
              ("sh_vjp", "train.step"), ("project_vjp", "train.step"),
              ("adam", "train.step"),
              ("wait.entry_cap", "train.step"), ("wait.rate", "train.step")}
EVENT_SPANS = {("densify.event", "train.step"),
               ("densify.grow", "densify.event"),
               ("densify.importance", "densify.event"),
               ("densify.prune", "densify.event"),
               ("wait.event_counts", "densify.event")}
FRAME_SPANS = {("view.frame", None), ("project", "view.frame"),
               ("bin", "view.frame"), ("raster", "view.frame"),
               ("view.host_copy", "view.frame")}


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def _scene(n=60, seed=3):
    rng = np.random.default_rng(seed)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    sh = rng.normal(0, 0.3, (n, 16, 3)).astype(np.float32)
    sh[:, 0, :] += 0.8
    params = {"means": rng.normal(0, 1.2, (n, 3)).astype(np.float32),
              "quats": quats / np.linalg.norm(quats, axis=1, keepdims=True),
              "log_scales": rng.uniform(-3.5, -1.5, (n, 3)).astype(
                  np.float32),
              "opacity_logits": rng.uniform(-1, 3, (n,)).astype(np.float32),
              "sh": sh}
    return scene_from_numpy(params, np.ones(n, bool), 0, CPU)


def _trainer(densify: bool = True) -> Trainer:
    rng = np.random.default_rng(4)
    cams, images = [], []
    for i in range(3):
        cams.append(CameraData(
            id=i, position=np.array([0.3 * i - 0.3, 0.1 * i, -5.0],
                                    np.float32),
            rotation=np.eye(3, dtype=np.float32), width=W, height=H,
            fy=40.0, fx=40.0, img_name=f"v{i}.png"))
        images.append({"width": W, "height": H,
                       "image": rng.random((H, W, 3)).astype(np.float32)})
    cfg = TrainerConfig(seed=6)
    cfg = dataclasses.replace(cfg, densify=dataclasses.replace(
        cfg.densify,
        schedule=dataclasses.replace(cfg.densify.schedule, enabled=densify,
                                     warmup_iterations=2, interval=2,
                                     stop_iterations=6),
        metric_views=2, metric_downscale=2, metric_threshold=0.3,
        clone_threshold_count=3, prune_opacity=0.45,
        max_new_points_per_step=24))
    tr = Trainer(_scene(), cams, images, cfg, initial_capacity=64)
    tr.RATE_SYNC_INTERVAL = 2  # a rate read inside the few steps
    return tr


def _pairs(spans) -> set:
    return {(s.name, None if s.parent is None else spans[s.parent].name)
            for s in spans}


def _nested(spans) -> None:
    for s in spans:
        assert s.start <= s.end
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start <= s.start and s.end <= p.end
            assert p.thread == s.thread


def test_tracing_off_records_nothing():
    assert trace.span("a") is trace.span("b")
    with trace.span("a") as inner:
        assert inner is None
    tr = _trainer()
    tr.train(3, log_fn=None)
    assert tr.last_densify_event is not None
    assert not hasattr(tr, "step_ms")  # the enqueue time went
    Viewer(_scene(), W, H, device=CPU).render()
    got = trace.take()
    assert got.spans == [] and got.gauges == []


def test_training_spans_across_an_event():
    tr = _trainer()
    trace.enable()
    tr.train(3, log_fn=None)
    trace.disable()
    spans = trace.take().spans
    assert tr.last_densify_event["iteration"] == 2
    assert _pairs(spans) == STEP_SPANS | EVENT_SPANS
    _nested(spans)
    steps = [s for s in spans if s.name == "train.step"]
    assert len(steps) == 3
    assert sum(s.name == "densify.event" for s in spans) == 1
    for name in ("project", "bin", "raster", "backward", "sh_vjp",
                 "project_vjp", "adam"):
        assert sum(s.name == name for s in spans) == 3, name


def test_viewer_spans():
    v = Viewer(_scene(), W, H, device=CPU)
    trace.enable()
    img = v.render()
    trace.disable()
    assert img.shape == (H, W, 3)
    spans = trace.take().spans
    assert _pairs(spans) == FRAME_SPANS
    _nested(spans)


def test_threads_keep_their_own_parent_stacks():
    trace.enable()
    both_open = threading.Barrier(2)

    def work(tag):
        with trace.span(f"outer.{tag}"):
            both_open.wait()
            with trace.span(f"inner.{tag}"):
                both_open.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    trace.disable()
    spans = trace.take().spans
    assert _pairs(spans) == {("outer.a", None), ("outer.b", None),
                             ("inner.a", "outer.a"), ("inner.b", "outer.b")}
    _nested(spans)
    assert len({s.thread for s in spans}) == 2


def test_an_open_span_waits_for_the_next_take():
    trace.enable()
    with trace.span("outer"):
        with trace.span("inner"):
            pass
        first = trace.take().spans
    trace.disable()
    assert [(s.name, s.parent) for s in first] == [("inner", None)]
    assert [(s.name, s.parent) for s in trace.take().spans] == [
        ("outer", None)]


def test_span_clock_is_the_profiler_clock(tmp_path):
    """A span opened inside a ``record_function`` range lies inside the
    range as the profiler's trace places it (within 50 us of rounding),
    and their ends are a median 0.5 ms apart or less (a busy machine may
    preempt the thread between the two clock reads of one pair)."""
    trace.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("first"):
            pass  # the first range pays a one-time set-up
        for _ in range(9):
            with torch.profiler.record_function("joined"), \
                    trace.span("joined"):
                torch.randn(256, 256) @ torch.randn(256, 256)
    trace.disable()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = doc["baseTimeNanoseconds"]
    ranges = sorted((base + e["ts"] * 1e3, base + (e["ts"] + e["dur"]) * 1e3)
                    for e in doc["traceEvents"]
                    if e.get("name") == "joined"
                    and e.get("cat") == "user_annotation")
    spans = trace.take().spans
    assert len(ranges) == len(spans) == 9
    lead = [s.start - a for (a, _), s in zip(ranges, spans)]
    lag = [b - s.end for (_, b), s in zip(ranges, spans)]
    assert min(lead) > -5e4 and min(lag) > -5e4, (lead, lag)
    assert np.median(lead) < 5e5 and np.median(lag) < 5e5, (lead, lag)


def test_slot_gauges_only_while_tracing():
    tr = _trainer(densify=False)
    tr.train(2, log_fn=None)
    assert trace.take().gauges == []
    trace.enable()
    tr.train(2, log_fn=None)
    trace.disable()
    got = trace.take()
    steps = [s for s in got.spans if s.name == "train.step"]
    assert [g.name for g in got.gauges] == ["slots.alive",
                                            "slots.capacity"] * 2
    for g in got.gauges:
        assert g.value == (tr.num_points if g.name == "slots.alive"
                           else tr.capacity)
        assert any(s.start <= g.time <= s.end and s.thread == g.thread
                   for s in steps)


def test_kernel_launches_are_tracer_counters():
    before = kernel_launches()
    assert tuple(before) == KERNEL_WRAPPERS
    assert "adam_step" in KERNEL_WRAPPERS and len(KERNEL_WRAPPERS) == 9
    trace.count("launches.segment_sum_rows")
    trace.count("launches.entry_counts", 2)
    trace.count("launches.adam_step", 3)
    after = kernel_launches()
    assert {k: after[k] - before[k] for k in after} == {
        **dict.fromkeys(KERNEL_WRAPPERS, 0), "segment_sum_rows": 1,
        "entry_counts": 2, "adam_step": 3}
    assert trace.counters()["launches.entry_counts"] == after["entry_counts"]


def test_counters_lose_no_update_across_threads():
    before = trace.counters().get("launches.expand_fields", 0)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            trace.count("launches.expand_fields") for _ in range(5000)])
            for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert kernel_launches()["expand_fields"] == before + 12 * 5000
