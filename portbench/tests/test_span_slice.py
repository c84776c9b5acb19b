"""CPU tests of the span slice (``span_slice.py``) and its readers.

    python -m pytest portbench/tests -q

The join on a crafted trace: each device event to the innermost span of
its launch (a launch from another thread included), the event's parts,
its blocking calls, the idle gaps' labels and the work outside spans;
each span metric's reader on that join; the readers without a tracer;
and the slices of a tiny cell on the CPU, whose spans and gauges are read
though the CPU trace has no device events.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import run  # noqa: E402
import span_slice  # noqa: E402
from webdgs_tpu_torch.trace import Gauge, Span  # noqa: E402

CPU = torch.device("cpu")
SEED = 4_000_000_011
BASE = 1_000_000_000_000  # the trace's baseTimeNanoseconds
MAIN, WORKER = 11, 12  # threads


def _ns(us: float) -> int:
    return BASE + int(us * 1000)


def _span(name, a, b, parent, thread=MAIN):
    return Span(name, _ns(a), _ns(b), parent, thread)


def _launch(ts, corr, name="cudaLaunchKernel", dur=5.0, tid=MAIN):
    return {"cat": "cuda_runtime", "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": {"correlation": corr}}


def _device(ts, dur, corr, cat="kernel"):
    return {"cat": cat, "name": f"k{corr}", "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def train_trace():
    """Two steps (times in us): the first holds an event, the second is
    plain; a launch between them lies outside every span."""
    spans = [_span("train.step", 0, 10000, None),               # 0
             _span("project", 100, 1000, 0),                    # 1
             _span("backward", 2000, 3000, 0),                  # 2
             _span("densify.event", 4000, 9000, 0),             # 3
             _span("densify.importance", 4500, 6000, 3),        # 4
             _span("train.step", 12000, 14000, None),           # 5
             _span("project", 12100, 12500, 5)]                 # 6
    gauges = [Gauge("slots.alive", _ns(10), 2, MAIN),
              Gauge("slots.capacity", _ns(10), 4, MAIN),
              Gauge("slots.alive", _ns(12010), 3, MAIN),
              Gauge("slots.capacity", _ns(12010), 4, MAIN)]
    events = [
        _launch(50, 4), _device(3700, 800, 4),       # step self, drains
        _launch(200, 1), _device(300, 500, 1),       # project
        _launch(2500, 2, tid=WORKER), _device(2600, 1000, 2),  # autograd
        _launch(4600, 3), _device(4700, 300, 3),     # importance
        _launch(5000, 7, name="cudaMemcpyAsync"),
        _device(5100, 200, 7, cat="gpu_memcpy"),
        _launch(6500, 9, name="cudaStreamSynchronize", dur=1000),
        _launch(11000, 6), _device(11100, 100, 6),   # outside spans
        _launch(12200, 8), _device(12300, 400, 8)]   # project, plain step
    return events, spans, gauges


def view_trace():
    spans = [_span("view.frame", 0, 5000, None),
             _span("project", 10, 500, 0),
             _span("bin", 500, 900, 0),
             _span("raster", 900, 1000, 0),
             _span("view.host_copy", 1000, 4000, 0)]
    events = [_launch(20, 1), _device(100, 600, 1),
              _launch(600, 2), _device(700, 250, 2),
              _launch(950, 3), _device(960, 1000, 3),
              _launch(1100, 4, name="cudaMemcpyAsync", dur=2800),
              _device(2000, 1500, 4, cat="gpu_memcpy")]
    return events, spans


def test_the_join_of_a_crafted_trace():
    events, spans, gauges = train_trace()
    sp = span_slice.join(events, BASE, spans, gauges)
    first, second = sp["units"]
    assert first["event"] and not second["event"]
    assert first["device_ms"] == pytest.approx({
        "train.step": 0.8, "train.step/project": 0.5,
        "train.step/backward": 1.0,  # launched by the other thread
        "train.step/densify.event/densify.importance": 0.5})
    assert first["copy_ms"] == pytest.approx(
        {"train.step/densify.event/densify.importance": 0.2})
    assert first["launches"]["train.step/densify.event/densify.importance"] \
        == 2
    assert first["host_self_ms"]["train.step"] == pytest.approx(
        10.0 - 0.9 - 1.0 - 5.0)
    assert first["host_self_ms"]["train.step/densify.event"] == \
        pytest.approx(5.0 - 1.5)
    assert first["gauges"] == {"slots.alive": 2, "slots.capacity": 4}
    assert second["device_ms"] == pytest.approx({"train.step/project": 0.4})
    (ev,) = sp["events"]
    assert ev["wall_ms"] == pytest.approx(5.0)
    assert ev["device_ms"] == pytest.approx(0.5)
    assert ev["drain_ms"] == pytest.approx(0.5)
    assert ev["idle_ms"] == pytest.approx(4.0)
    assert ev["device_ms"] + ev["drain_ms"] + ev["idle_ms"] == \
        pytest.approx(ev["wall_ms"])
    assert ev["syncs"] == 1
    assert sp["outside"] == {"launches": 1, "device_ms": pytest.approx(0.1),
                             "between": 1,
                             "calls": {"cudaLaunchKernel": 1}}
    gaps = [(label, round(s * 1e6)) for label, s in sp["idle_gaps"]]
    assert gaps[:4] == [
        ("train.step/densify.event: host_between_calls", 5800),
        ("train.step: host_between_calls", 1800),
        ("outside spans: host_between_calls", 1100),
        ("train.step/densify.event/densify.importance: cudaLaunchKernel",
         200)]
    assert sp["device_ops"][0] == ["train.step/backward", pytest.approx(1.0)]
    assert sp["kernels"]["train.step/densify.event/densify.importance"] == [
        ["k3", pytest.approx(0.3)], ["k7", pytest.approx(0.2)]]
    assert sp["lost"] == 0
    # launches after the last one with a device record are a lost tail;
    # a launch without one before it is not
    tail = [e for e in events if e.get("name") != "k8"]
    assert span_slice.join(tail, BASE, spans, gauges)["lost"] == 1
    hole = [e for e in events if e.get("name") != "k1"]
    assert span_slice.join(hole, BASE, spans, gauges)["lost"] == 0


def _read(name: str, ctx: dict):
    return run.read_metric(HERE / "metrics" / f"{name}.py", ctx)


def test_the_span_readers_of_a_crafted_trace():
    events, spans, gauges = train_trace()
    ctx = {"kind": "train", "spans": span_slice.join(events, BASE, spans,
                                                     gauges)}
    assert _read("project_ms.train", ctx) == pytest.approx(0.4)
    assert _read("bin_ms.train", ctx) == 0.0
    assert _read("project_vjp_ms.train", ctx) == 0.0
    assert _read("adam_ms.train", ctx) == 0.0
    assert _read("slot_use.train", ctx) == pytest.approx(75.0)
    assert _read("event_device_ms", ctx) == pytest.approx(0.5)
    assert _read("event_idle_ms", ctx) == pytest.approx(4.0)
    assert _read("event_syncs", ctx) == 1
    assert _read("project_ms.view", ctx) is None
    # a densify-phase cell's twins read what their training readers do
    for name in ("project_ms", "bin_ms", "project_vjp_ms", "adam_ms",
                 "slot_use"):
        assert _read(f"{name}.densify", ctx) == _read(f"{name}.train", ctx)
    events, spans = view_trace()
    ctx = {"kind": "view", "spans": span_slice.join(events, BASE, spans)}
    assert _read("project_ms.view", ctx) == pytest.approx(0.6)
    assert _read("bin_ms.view", ctx) == pytest.approx(0.25)
    assert _read("host_copy_ms.view", ctx) == pytest.approx(1.5)
    assert _read("project_ms.train", ctx) is None
    assert _read("event_device_ms", ctx) is None


def test_a_trace_without_device_events_reads_nothing():
    _, spans, gauges = train_trace()
    ctx = {"kind": "train", "spans": span_slice.join([], BASE, spans,
                                                     gauges)}
    assert _read("project_ms.train", ctx) is None
    assert _read("event_syncs", ctx) is None
    assert _read("slot_use.train", ctx) == pytest.approx(75.0)


def test_no_slice_without_a_tracer_or_a_cell(monkeypatch):
    ctx = {"kind": "train"}
    # the test's own arguments name no cell
    assert _read("project_ms.train", ctx) is None and ctx["spans"] is None
    monkeypatch.setitem(sys.modules, "webdgs_tpu_torch.trace", None)
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload",
                                      "mip360-view", "--seed", "1"])
    ctx = {"kind": "view"}
    assert _read("host_copy_ms.view", ctx) is None and ctx["spans"] is None


@pytest.mark.parametrize("cell", ["tandt-densify", "mip360-view"])
def test_the_slices_of_a_tiny_cell(cell):
    lc = run.load_cell(cell)
    c = lc["config"]
    c.update(gaussians=3000, width=96, height=64, views=12)
    c["trainer"]["densify"].update(metric_views=4)
    sp = span_slice.run_slices(run, lc, SEED, CPU)
    root = "view.frame" if cell == "mip360-view" else "train.step"
    k = lc["traffic"]["profile_frames" if root == "view.frame"
                      else "profile_steps"]
    assert [u["name"] for u in sp["units"]] == [root] * (
        k + (cell == "tandt-densify"))
    assert sp["cost"]["off_ms"] > 0 and sp["cost"]["on_ms"] > 0
    assert sp["device_events"] == 0  # a CPU trace has none
    summary = span_slice.summary(sp)
    if cell == "tandt-densify":
        assert [u["event"] for u in sp["units"]] == [False] * k + [True]
        assert len(sp["events"]) == 1
        assert {"densify.event/densify.importance",
                "densify.event/densify.prune"} <= {
            p.split("/", 1)[1] for p in
            summary["kinds"]["event_step"]["host_self_ms"] if "/" in p}
        ctx = {"kind": "train", "spans": sp}
        assert 0.0 < _read("slot_use.train", ctx) <= 100.0
    else:
        assert set(summary["kinds"]["frame"]["host_self_ms"]) == {
            "view.frame", "view.frame/project", "view.frame/bin",
            "view.frame/raster", "view.frame/view.host_copy"}
