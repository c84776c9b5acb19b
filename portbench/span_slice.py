"""The span slice of a traced run: the port's own spans
(``webdgs_tpu_torch.trace``) joined to the device trace.

The first reader of a span metric in a ``--trace 1`` run calls
:func:`spans`, which runs the slice once, after the harness has taken
every other reading, and keeps the join in ``ctx["spans"]`` for the
readers after it.  A port without the tracer gives None, and so does
every span metric.  The slice builds the cell again from the run's own
``--workload`` and ``--seed``, as ``run.py`` builds it (``setup_train``
and the warm-up steps, or the viewer and its warm-up frames), and
profiles under the harness's ``profiler()``:

- ``off``: ``profile_steps`` plain steps (``profile_frames`` frames),
  tracing off;
- ``on``: as many again, tracing on; with ``off`` it gives tracing's
  cost;
- in a cell whose schedule still holds an event, the trainer goes on
  untraced to ``profile_steps`` steps before the next event, and the
  span slice runs through that event step, tracing on (once more at the
  following event if the trace lost its tail); elsewhere the span slice
  is ``on``.

The join: a device event (kernel, copy, fill) is tied by its
``args.correlation`` to the runtime call that launched it, and that call's
host time to the innermost span, on any thread, whose interval holds it.
The trace's times (``ts`` in us plus ``baseTimeNanoseconds``) and the
spans' (``time.time_ns()``) are one clock.  Nothing here reads or changes
what the harness measured before it.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import statistics
import sys
import time
import traceback

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
# runtime calls that block the host until the device is done
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
# runtime calls that put work on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
                "cudaMemcpy", "cudaMemset")
# the profiler may stop before the runtime has handed over the last
# device records (seen on the card as a lost tail of the event slice):
# seconds it stays open after the work, and attempts at an event slice
# whose tail is still lost
SETTLE_S = 1.0
ATTEMPTS = 2
ROOTS = ("train.step", "view.frame")


# ----------------------------------------------------------------------
# the join

def _union(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


class _Stab:
    """The innermost span holding a host time: of the spans whose
    interval holds it, the one opened last."""

    def __init__(self, spans):
        self.order = sorted(range(len(spans)), key=lambda i: spans[i].start)
        self.starts = [spans[i].start for i in self.order]
        self.spans = spans

    def __call__(self, t: float) -> int | None:
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0:
            i = self.order[j]
            if self.spans[i].end >= t:
                return i
            j -= 1
        return None


def _paths(spans) -> list[str]:
    out: list[str] = []
    for s in spans:
        out.append(s.name if s.parent is None
                   else out[s.parent] + "/" + s.name)
    return out


def _root(spans, i: int) -> int:
    while spans[i].parent is not None:
        i = spans[i].parent
    return i


def _under(spans, i: int | None, top: int) -> bool:
    """Span ``i`` is ``top`` or lies inside it."""
    while i is not None and i != top:
        i = spans[i].parent
    return i == top


def join(events: list, base_ns: int, spans: list, gauges: list = ()) -> dict:
    """The device trace ``events`` (a Chrome trace's ``traceEvents``, times
    from ``base_ns``) joined to the tracer's ``spans`` and ``gauges``.
    Returns one entry per root span (``train.step`` or ``view.frame``):
    device ms, copy ms and launches by span path, host self ms by path,
    the gauges; one entry per ``densify.event``; the ten longest idle gaps
    labelled ``<span path>: <runtime call | host_between_calls>``; the
    top span paths by device ms; and the device work launched outside
    every span."""
    def ns(us):
        return base_ns + us * 1e3

    launch = {}  # correlation -> (host time, runtime call)
    runtime = []
    for e in events:
        if e.get("cat") in HOST_CATS:
            a = ns(e["ts"])
            runtime.append((a, a + e.get("dur", 0.0) * 1e3, e["name"]))
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launch[c] = (a, e["name"])
    # (start, end, launch time or None, is a copy, call, kernel)
    device = []
    recorded = set()
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            a = ns(e["ts"])
            c = (e.get("args") or {}).get("correlation")
            recorded.add(c)
            t, call = launch.get(c, (None, "unmatched"))
            device.append((a, a + e.get("dur", 0.0) * 1e3, t,
                           e["cat"] == "gpu_memcpy", call, e["name"]))
    # the trace's lost tail: launches after the last one that has a
    # device record (a launch may have none mid-trace, such as a copy of
    # no bytes)
    launched = [(t, c in recorded) for c, (t, call) in launch.items()
                if call in LAUNCH_CALLS]
    last = max((t for t, kept in launched if kept), default=None)
    lost = sum(1 for t, kept in launched
               if not kept and (last is None or t > last))
    paths = _paths(spans)
    stab = _Stab(spans)
    units: dict[int, dict] = {}
    for i, s in enumerate(spans):
        if s.parent is None and s.name in ROOTS:
            units[i] = {"name": s.name, "event": False,
                        "wall_ms": (s.end - s.start) * 1e-6,
                        "device_ms": {}, "copy_ms": {}, "launches": {},
                        "host_self_ms": {}, "gauges": {}}
    child_wall: dict[int, float] = {}
    for i, s in enumerate(spans):
        if s.parent is not None:
            child_wall[s.parent] = child_wall.get(s.parent, 0.0) + (
                s.end - s.start)
    for i, s in enumerate(spans):
        r = _root(spans, i)
        if r not in units:
            continue
        u = units[r]
        if s.name == "densify.event":
            u["event"] = True
        self_ms = (s.end - s.start - child_wall.get(i, 0.0)) * 1e-6
        u["host_self_ms"][paths[i]] = u["host_self_ms"].get(
            paths[i], 0.0) + self_ms
    for g in gauges:
        i = stab(g.time)
        if i is not None and _root(spans, i) in units:
            units[_root(spans, i)]["gauges"][g.name] = g.value
    owner = []  # the innermost span of each device event
    # work launched in no span: how much, by runtime call, and how much
    # of it between the first root span's start and the last one's end
    outside = {"launches": 0, "device_ms": 0.0, "between": 0, "calls": {}}
    first = min((spans[r].start for r in units), default=0)
    last = max((spans[r].end for r in units), default=0)
    kernels: dict[str, dict[str, float]] = {}  # by span path
    for a, b, t, copy, call, name in device:
        i = None if t is None else stab(t)
        owner.append(i)
        if i is None:
            outside["launches"] += 1
            outside["device_ms"] += (b - a) * 1e-6
            outside["calls"][call] = outside["calls"].get(call, 0) + 1
            outside["between"] += t is not None and first <= t <= last
            continue
        r = _root(spans, i)
        if r not in units:
            continue
        u, p = units[r], paths[i]
        u["device_ms"][p] = u["device_ms"].get(p, 0.0) + (b - a) * 1e-6
        u["launches"][p] = u["launches"].get(p, 0) + 1
        if copy:
            u["copy_ms"][p] = u["copy_ms"].get(p, 0.0) + (b - a) * 1e-6
        k = kernels.setdefault(p, {})
        k[name] = k.get(name, 0.0) + (b - a) * 1e-6
    ivals = [(a, b) for a, b, *_ in device]
    events_out = []
    for i, s in enumerate(spans):
        if s.name != "densify.event":
            continue
        mine = [(a, b) for (a, b, *_), o in zip(device, owner)
                if _under(spans, o, i)]
        before = [(a, b) for a, b, t, *_ in device
                  if t is not None and t < s.start]
        wall = (s.end - s.start) * 1e-6
        busy = _union(_clip(ivals, s.start, s.end)) * 1e-6
        syncs = sum(1 for a, _, n in runtime
                    if n in SYNC_CALLS and s.start <= a <= s.end)
        events_out.append({
            "wall_ms": wall,
            "device_ms": _union(_clip(mine, s.start, s.end)) * 1e-6,
            "idle_ms": wall - busy,
            "drain_ms": _union(_clip(before, s.start, s.end)) * 1e-6,
            "syncs": syncs})
    # the slice's idle gaps, between the merged device intervals
    merged = []
    for a, b in sorted(ivals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = sorted(((a1 - b0, b0, a1) for (_, b0), (a1, _) in
                   zip(merged, merged[1:]) if a1 > b0), reverse=True)
    idle = []
    for length, a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        i = stab(mid)
        cover = [(e - s0, n) for s0, e, n in runtime if s0 <= mid <= e]
        call = min(cover)[1] if cover else "host_between_calls"
        idle.append([f"{'outside spans' if i is None else paths[i]}: "
                     f"{call}", length * 1e-9])
    by_path: dict[str, float] = {}
    for u in units.values():
        for p, v in u["device_ms"].items():
            by_path[p] = by_path.get(p, 0.0) + v
    top = sorted(by_path.items(), key=lambda kv: -kv[1])[:10]
    # each top path's five longest kernels (names cut to 96 characters)
    by_kernel = {p: [[n[:96], v] for n, v in sorted(
        kernels[p].items(), key=lambda kv: -kv[1])[:5]] for p, _ in top}
    return {"units": list(units.values()), "events": events_out,
            "idle_gaps": idle, "device_ops": [[p, v] for p, v in top],
            "kernels": by_kernel, "outside": outside,
            "device_events": len(device), "lost": lost}


# ----------------------------------------------------------------------
# what the readers take

def _plain_steps(sp: dict) -> list:
    return [u for u in sp["units"] if u["name"] == "train.step"
            and not u["event"]]


def step_ms(ctx: dict, name: str) -> float | None:
    """Device ms per plain step of the work launched in span ``name``
    directly under ``train.step``."""
    sp = spans(ctx)
    if sp is None or not sp["device_events"] or not _plain_steps(sp):
        return None
    return statistics.mean(u["device_ms"].get("train.step/" + name, 0.0)
                           for u in _plain_steps(sp))


def frame_ms(ctx: dict, name: str, copies: bool = False) -> float | None:
    """Device ms per frame of the work (``copies``: of the copies)
    launched in span ``name`` directly under ``view.frame``."""
    sp = spans(ctx)
    frames = [] if sp is None else [u for u in sp["units"]
                                    if u["name"] == "view.frame"]
    if not frames or not sp["device_events"]:
        return None
    key = "copy_ms" if copies else "device_ms"
    return statistics.mean(u[key].get("view.frame/" + name, 0.0)
                           for u in frames)


def slot_use(ctx: dict) -> float | None:
    """Alive Gaussians over capacity slots, in %, over the plain steps."""
    sp = spans(ctx)
    if sp is None:
        return None
    steps = [u["gauges"] for u in _plain_steps(sp)
             if {"slots.alive", "slots.capacity"} <= set(u["gauges"])]
    cap = sum(g["slots.capacity"] for g in steps)
    return (100.0 * sum(g["slots.alive"] for g in steps) / cap
            if cap else None)


def event_value(ctx: dict, key: str) -> float | None:
    """The mean over the slice's events of one of :func:`join`'s event
    fields."""
    sp = spans(ctx)
    if sp is None or not sp["events"] or not sp["device_events"]:
        return None
    return statistics.mean(e[key] for e in sp["events"])


# ----------------------------------------------------------------------
# the slice

def spans(ctx: dict) -> dict | None:
    """The span slice's join, run at the first call of a traced run and
    kept in ``ctx["spans"]``; None where the port has no tracer or the
    run's arguments name no cell."""
    if "spans" not in ctx:
        ctx["spans"] = None
        try:
            import webdgs_tpu_torch.trace  # noqa: F401
        except ImportError:
            return None
        args = _cell_args()
        if args is not None:
            h = sys.modules["__main__"]  # run.py, the harness
            try:
                ctx["spans"] = run_slices(h, h.load_cell(args[0]), args[1])
            except Exception:  # the other readings stand without it
                print("span slice failed:\n" + traceback.format_exc(),
                      file=sys.stderr)
    return ctx["spans"]


def _cell_args():
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    args, _ = ap.parse_known_args(sys.argv[1:])
    if args.workload is None or args.seed is None:
        return None
    return args.workload, args.seed


def _profiled(h, fn, dev, on: bool) -> dict:
    """``fn`` under the harness's profiler, tracing on or off; its wall
    time (synchronised), the spans and the joined trace."""
    from webdgs_tpu_torch import trace
    trace.take()
    with h.profiler() as prof:
        h.sync(dev)
        if on:
            trace.enable()
        try:
            t0 = time.perf_counter()
            fn()
            h.sync(dev)
            wall = time.perf_counter() - t0
        finally:
            trace.disable()
        time.sleep(SETTLE_S)
    rec = trace.take()
    path = h.CACHE / "span_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        doc = h.load_json(path)
    finally:
        path.unlink()
    out = join(doc["traceEvents"], int(doc.get("baseTimeNanoseconds", 0)),
               rec.spans, rec.gauges)
    out["wall_s"] = wall
    return out


def run_slices(h, lc: dict, seed: int, dev=None) -> dict:
    """Build the loaded cell ``lc`` from ``seed`` and run the slices on
    ``dev`` (the card by default); returns the span slice's join with the
    tracing-off and tracing-on walls per unit (``cost``)."""
    dev = dev or torch.device("cuda", 0)
    kind = lc["traffic"]["kind"]
    t0 = time.perf_counter()
    out = (_train_slices if kind == "train" else _view_slices)(
        h, lc, seed, dev)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["slice_s"] = time.perf_counter() - t0
    print("span slice: " + json.dumps(summary(out)), file=sys.stderr)
    return out


def _train_slices(h, lc, seed, dev) -> dict:
    tr = lc["traffic"]
    trainer = h.setup_train(lc, seed, dev)["trainer"]

    def steps(n: int) -> None:
        if n > 0:
            trainer.train(n, log_fn=None)

    steps(tr["warmup_steps"])
    k = tr["profile_steps"]
    sched = trainer.config.densify.schedule
    while any(sched.should_densify(trainer.iteration + i)
              for i in range(1, 2 * k + 1)):
        steps(1)
    off = _profiled(h, lambda: steps(k), dev, on=False)
    on = _profiled(h, lambda: steps(k), dev, on=True)
    span = on
    tries = 0
    while trainer.next_densify_iteration() is not None and tries < ATTEMPTS:
        ahead = trainer.next_densify_iteration() - trainer.iteration
        if ahead >= k + 1:
            steps(ahead - (k + 1))
            span = _profiled(h, lambda: steps(k + 1), dev, on=True)
            tries += 1
            if not span["lost"]:
                break
        else:
            steps(ahead)
    del trainer
    return {**span, "cost": {"unit": "step", "off_ms": off["wall_s"] / k
                             * 1e3, "on_ms": on["wall_s"] / k * 1e3}}


def _view_slices(h, lc, seed, dev) -> dict:
    import scenes
    from webdgs_tpu_torch.core.scene import GaussianScene
    from webdgs_tpu_torch.render.viewer import Viewer

    cfg, tr = lc["config"], lc["traffic"]
    params = scenes.make_scene(cfg, seed, dev)
    n = params["means"].shape[0]
    scene = GaussianScene(alive=torch.ones(n, dtype=torch.bool, device=dev),
                          sh_deg=cfg["sh_degree"], **params)
    del params
    viewer = Viewer(scene, cfg["width"], cfg["height"],
                    h.program_settings(cfg), fov_y_deg=cfg["fov_y_deg"],
                    device=dev)
    poses = scenes.ring_poses(cfg, seed, tr["orbit_frames"], salt=4,
                              ordered=True)
    for i in range(tr["warmup_frames"]):
        h._frame_pose(viewer, poses[-1 - i])
        viewer.render()
    k = tr["profile_frames"]

    def frames() -> None:
        for j in range(k):
            h._frame_pose(viewer, poses[j])
            viewer.render()

    off = _profiled(h, frames, dev, on=False)
    on = _profiled(h, frames, dev, on=True)
    del viewer, scene
    return {**on, "cost": {"unit": "frame", "off_ms": off["wall_s"] / k
                           * 1e3, "on_ms": on["wall_s"] / k * 1e3}}


def summary(sp: dict) -> dict:
    """What the slice found, per step, event step and frame: device ms,
    launches and host self ms by span path (means over the units of a
    kind), the share of device time outside every child span, the events'
    parts, the idle gaps, the work outside spans and tracing's cost."""
    kinds: dict[str, list] = {}
    for u in sp["units"]:
        kind = ("frame" if u["name"] == "view.frame"
                else "event_step" if u["event"] else "step")
        kinds.setdefault(kind, []).append(u)
    out = {}
    for kind, us in kinds.items():
        row = {}
        for key in ("device_ms", "launches", "host_self_ms"):
            names = sorted({p for u in us for p in u[key]})
            row[key] = {p: statistics.mean(u[key].get(p, 0) for u in us)
                        for p in names}
        dev_total = sum(row["device_ms"].values())
        root = us[0]["name"]
        row["outside_children_share"] = (
            row["device_ms"].get(root, 0.0) / dev_total if dev_total
            else None)
        row["units"] = len(us)
        row["wall_ms"] = statistics.mean(u["wall_ms"] for u in us)
        out[kind] = row
    return {"kinds": out, "events": sp["events"],
            "idle_gaps": sp["idle_gaps"], "device_ops": sp["device_ops"],
            "kernels": sp["kernels"],
            "outside": sp["outside"], "lost": sp["lost"],
            "cost": sp.get("cost"),
            "wall_s": sp.get("wall_s"), "slice_s": sp.get("slice_s")}
