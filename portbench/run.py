"""The port's benchmark: one cell of BENCHMARK.json, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell needs is found by name: the cell in BENCHMARK.json, its
configuration in ``configs/<config>.json``, its traffic in
``traffic/<traffic>.json``, the limits of its output check in
``limits/<cell>.json``, one reader per per-layer metric in
``metrics/<metric>.py`` and the configuration's plain reference in
``reference/<name>.py`` (the configuration's ``reference`` key, ``gs``
where it has none).  The run builds the scene, views and targets from the
seed on the card, warms up, measures for ``--seconds``, checks what the
timed path produced against the plain reference, and prints one JSON line
last on standard output.  It exits 2, printing no result, without a CUDA
device, and 3 where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import re  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".portbench_cache"
# every kernel cache at a fixed path inside the checkout; the port builds
# its own kernels into webdgs_tpu_torch/_build/, also inside it
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import counts  # noqa: E402
import scenes  # noqa: E402

# the packed (N, 59) rows of the trainer's Adam moments, by leaf
LEAVES = {"means": (0, 3), "quats": (3, 7), "log_scales": (7, 10),
          "opacity_logits": (10, 11), "sh": (11, 59)}
# an event's decision counts are compared against at least this many
EVENT_FLOOR = 100
# a name of BENCHMARK.json, and so of a file under portbench/
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
# the rate a run of each traffic kind takes over its window
RATE_UNIT = {"train": "it/s", "view": "frames/s"}
# top-level modules that no run may have loaded: JAX and the JAX package
BANNED = frozenset({"jax", "jaxlib", "flax", "webdgs_tpu"})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reference(cfg: dict):
    """The configuration's plain reference: ``reference/<name>.py`` for
    its ``reference`` key, ``gs`` where it has none.  What the harness
    calls in it is listed in ``reference/gs.py``'s docstring."""
    name = cfg.get("reference", "gs")
    missing = FileNotFoundError(
        f"configuration {cfg.get('name')!r} names the plain reference "
        f"{name!r}: no file {HERE / 'reference' / f'{name}.py'}")
    if not (isinstance(name, str) and NAME.fullmatch(name)):
        raise missing
    try:
        return importlib.import_module(f"reference.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"reference.{name}":
            raise
        raise missing from None


def reference(lc: dict):
    """The loaded cell's plain reference."""
    return load_reference(lc["config"])


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell and every file it names, found by name."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    base = root / "portbench"
    config = load_json(base / "configs" / f"{cell['config']}.json")
    load_reference(config)  # a name with no file fails here
    return {"bench": bench, "cell": cell, "e2e": e2e, "per_layer": per_layer,
            "config": config,
            "traffic": load_json(base / "traffic"
                                 / f"{cell['traffic']}.json"),
            "limits": load_json(base / "limits" / f"{name}.json"),
            "readers": {m["name"]: base / "metrics" / f"{m['name']}.py"
                        for m in per_layer}}


def read_metric(path: Path, ctx: dict):
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def ref_settings(lc: dict) -> dict:
    return {**lc["config"]["render"], **reference(lc).TILE}


def program_settings(cfg: dict):
    from webdgs_tpu_torch.config import RenderSettings
    rs = dict(cfg["render"])
    rs["background"] = tuple(rs["background"])
    return RenderSettings(**rs)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def banned_modules() -> list[str]:
    """Loaded modules of JAX or the JAX package, by top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & BANNED)


def gc_counts() -> list[int]:
    return [g["collections"] for g in gc.get_stats()]


def allocator(dev) -> tuple[int, int]:
    """The caching allocator's device segments allocated so far and the
    bytes it holds: (0, 0) off the card."""
    if dev.type != "cuda":
        return 0, 0
    st = torch.cuda.memory_stats(dev)
    return st.get("segment.all.allocated", 0), st.get("reserved_bytes.all"
                                                       ".current", 0)


def report_chunks(stamps: list[float], gc_before: list[int],
                  alloc_before: tuple[int, int], dev) -> None:
    """Print each chunk's time between consecutive ``stamps`` (the
    loop's own clock reads), the three largest stalls (a chunk's time
    over the median chunk's) with where in the window they fell, the
    collector's runs and the allocator's growth in the window."""
    chunks = [b - a for a, b in zip(stamps, stamps[1:])]
    gcs = [b - a for a, b in zip(gc_before, gc_counts())]
    segs, held = allocator(dev)
    print(f"chunks_ms: {[round(c * 1e3, 3) for c in chunks]}",
          file=sys.stderr)
    if chunks:
        med = statistics.median(chunks)
        worst = sorted(range(len(chunks)), key=lambda i: chunks[i] - med,
                       reverse=True)[:3]
        print(f"chunk median {med * 1e3:.3f} ms over {len(chunks)}; stalls: "
              + ", ".join(f"+{(chunks[i] - med) * 1e3:.3f} ms in chunk {i} "
                          f"at {stamps[i] - stamps[0]:.3f} s"
                          for i in worst), file=sys.stderr)
    print(f"gc collections in the window by generation: {gcs}",
          file=sys.stderr)
    print(f"allocator in the window: {segs - alloc_before[0]} segments "
          f"allocated, {alloc_before[1]} -> {held} bytes held",
          file=sys.stderr)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


# ----------------------------------------------------------------------
# profiling

def summarize_profile(prof, wall_s: float, units: int) -> dict:
    """Device busy time, kernels run, device time by operation and the
    longest idle gaps of one profiled slice, from the profiler's trace.
    A gap is labelled by the shortest runtime call the host was in at its
    middle, or as the host's own time between calls."""
    path = CACHE / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        events = load_json(path)["traceEvents"]
    finally:
        path.unlink()
    dev_ev = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    host_ev = [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
               for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    iv = sorted((e["ts"], e["ts"] + e.get("dur", 0.0)) for e in dev_ev)
    by_name: dict[str, float] = {}
    for e in dev_ev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e.get(
            "dur", 0.0) * 1e-6
    merged = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = sorted(((a1 - b0, b0, a1) for (_, b0), (a1, _) in
                   zip(merged, merged[1:]) if a1 > b0), reverse=True)
    idle = []
    for length, a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        cover = [(e - s0, n) for s0, e, n in host_ev if s0 <= mid <= e]
        idle.append([min(cover)[1] if cover else "host between calls",
                     length * 1e-6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": sum(b - a for a, b in merged) * 1e-6,
            "window_s": wall_s, "units": units, "kernels": by_name,
            "launches": sum(1 for e in dev_ev if e["cat"] == "kernel"),
            "device_ops": [[n, v] for n, v in top], "idle_gaps": idle}


def profiler():
    """Device activity only: recording every host operation would slow
    the host several times over and inflate the idle share."""
    acts = torch.profiler.ProfilerActivity
    return torch.profiler.profile(activities=[
        acts.CUDA if torch.cuda.is_available() else acts.CPU])


# ----------------------------------------------------------------------
# comparisons

def gap_by_leaf(prog: dict, refn: dict, skip=()) -> float:
    """Worst leaf of |norm_prog - norm_ref| / max(norm_ref, median)."""
    keep = {k: v for k, v in refn.items() if k not in skip}
    med = statistics.median(keep.values())
    return max(abs(prog[k] - v) / max(v, med, 1e-30)
               for k, v in keep.items())


def negligible_leaves(ref_grad: dict) -> set:
    """Leaves whose reference gradient is under a thousandth of the
    median leaf's: moved by round-off alone, left out of the change."""
    med = statistics.median(ref_grad.values())
    return {k for k, v in ref_grad.items() if v < 1e-3 * med}


def gap_by_groups(prog: dict, refn: dict) -> float:
    """:func:`gap_by_leaf` over each group of leaves (``group/leaf``
    keys), each against its own median; the worst group."""
    groups = {k.split("/")[0] for k in refn}
    return max(gap_by_leaf({k: v for k, v in prog.items()
                            if k.startswith(g + "/")},
                           {k: v for k, v in refn.items()
                            if k.startswith(g + "/")}) for g in groups)


def compare_train(prog: dict, refo: dict) -> dict:
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                           zip(prog["losses"], refo["losses"]))}
    skip = negligible_leaves(refo["grad"])
    out["grad_gap"] = gap_by_leaf(prog["grad"], refo["grad"], skip)
    out["change_gap"] = gap_by_leaf(prog["change"], refo["change"], skip)
    if "event" in refo:
        ev, rev = prog["event"], refo["event"]
        out["event_gap"] = max(abs(ev[k] - rev[k]) / max(rev[k], EVENT_FLOOR)
                               for k in ("cloned", "split", "pruned", "out"))
        out["capacity_gap"] = abs(prog["capacity"] - refo["capacity"])
        out["event_state_gap"] = gap_by_groups(prog["event_state"],
                                               refo["event_state"])
        out["event_moment_gap"] = gap_by_groups(prog["event_moments"],
                                                refo["event_moments"])
    if "post_change" in refo:
        out["post_change_gap"] = gap_by_leaf(prog["post_change"],
                                             refo["post_change"], skip)
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return ok, checks


# ----------------------------------------------------------------------
# training cells

def _norms(rows: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in rows.items()}


def _unpack(m: torch.Tensor, n: int) -> dict:
    return {k: m[:n, a:b] for k, (a, b) in LEAVES.items()}


def _params_rows(scene, n: int) -> dict:
    return {k: getattr(scene, k)[:n].reshape(n, -1) for k in LEAVES}


def state_norms(rows: dict, group: str) -> dict:
    """Each leaf's norm over its rows, and over its rows weighted by their
    position (row i of n by (i + 1) / n), which a row out of its place
    moves: ``group/leaf`` and ``group@/leaf`` keys."""
    out = {}
    for k, v in rows.items():
        v = v.reshape(v.shape[0], -1).double()
        w = torch.arange(1, v.shape[0] + 1, dtype=torch.float64,
                         device=v.device)[:, None] / max(v.shape[0], 1)
        out[f"{group}/{k}"] = float(v.norm())
        out[f"{group}@/{k}"] = float((v * w).norm())
    return out


def trainer_draws(seed: int, count: int, start: int, steps: int,
                  should_densify, metric_views: int):
    """The views a ``Trainer`` of one resolution draws from
    ``random.Random(config.seed)`` for ``steps`` steps after iteration
    ``start``: per step a group pick and an index, and at an event the
    metric views, ``sample(range(count), k)``.  The benchmark's contract
    with the trainer (``tests/test_portbench.py`` holds it); returns the
    step views and {step: metric views}."""
    r = random.Random(seed)
    views, events = [], {}
    for i in range(1, steps + 1):
        r.randrange(count)
        views.append(r.randrange(count))
        if should_densify(start + i):
            events[i] = r.sample(range(count),
                                 k=min(max(1, metric_views), count))
    return views, events


def setup_train(lc: dict, seed: int, dev) -> dict:
    """Build the trainer from the seed, resume it, and drive the compared
    first steps through ``Trainer.train``; returns the trainer and what
    those steps produced: the losses, the first gradient as Adam took it,
    the change up to the step before an event (or over all the steps), and
    with an event its counts, capacity, the state it left (params and
    moments) and the change over the steps after it."""
    from webdgs_tpu_torch.core.camera import CameraData
    from webdgs_tpu_torch.core.scene import GaussianScene
    from webdgs_tpu_torch.train.config import load_trainer_config
    from webdgs_tpu_torch.train.trainer import Trainer

    cfg, tr = lc["config"], lc["traffic"]
    w, h, views = cfg["width"], cfg["height"], cfg["views"]
    params = scenes.make_scene(cfg, seed, dev)
    n = params["means"].shape[0]
    poses = scenes.ring_poses(cfg, seed, views)
    targets = scenes.make_targets(cfg, seed, views, dev)
    host = targets.cpu().numpy()
    del targets
    focal = 0.5 * h / math.tan(math.radians(cfg["fov_y_deg"]) / 2)
    cams = [CameraData(position=p.astype(np.float32),
                       rotation=r.astype(np.float32), fy=focal, height=h,
                       width=w) for p, r in poses]
    images = [{"image": host[i], "width": w, "height": h}
              for i in range(views)]
    tcfg = load_trainer_config({**cfg["trainer"], "seed": seed % (1 << 62)})
    scene = GaussianScene(alive=torch.ones(n, dtype=torch.bool, device=dev),
                          sh_deg=cfg["sh_degree"],
                          **{k: v.clone() for k, v in params.items()})
    trainer = Trainer(scene, cams, images, tcfg,
                      settings=program_settings(cfg))
    del images, host
    trainer.resume_from(trainer.scene, None, tr["resume_iteration"])
    out = {"trainer": trainer, "n": n, "poses": poses, "cams": cams,
           "init": {k: v.cpu() for k, v in params.items()},
           "capacity": trainer.capacity, "noise_seed": tcfg.seed}
    del params
    steps = tr["compare_steps"]
    sched = trainer.config.densify.schedule
    out["views"], out["events"] = trainer_draws(
        tcfg.seed, views, trainer.iteration, steps, sched.should_densify,
        tcfg.densify.metric_views)
    event = min(out["events"], default=None)
    if len(out["events"]) > 1 or event == 1:
        raise ValueError("the compared steps hold at most one event, "
                         "after the first step")
    init_rows = {k: v.reshape(n, -1) for k, v in out["init"].items()}
    prog = {"losses": []}
    post = None
    for i in range(1, steps + 1):
        m = trainer.train(1, log_fn=None)
        prog["losses"].append(m["loss"])
        if i == 1:
            m1 = _unpack(trainer.full_opt_state().m, n)
            b1 = trainer.config.adam.beta1
            prog["grad"] = _norms({k: v / (1.0 - b1) for k, v in m1.items()})
        if i == (event - 1 if event else steps):
            prog["change"] = _norms({
                k: v.cpu() - init_rows[k]
                for k, v in _params_rows(trainer.full_scene(), n).items()})
        if i == event:
            ev = trainer.last_densify_event
            prog["event"] = {k: ev[k] for k in ("cloned", "split", "pruned",
                                                "out")}
            prog["capacity"] = trainer.capacity
            rows = ev["out"]
            post = {k: v.clone() for k, v in
                    _params_rows(trainer.full_scene(), rows).items()}
            opt = trainer.full_opt_state()
            prog["event_state"] = state_norms(post, "params")
            prog["event_moments"] = {
                **state_norms(_unpack(opt.m, rows), "m"),
                **state_norms(_unpack(opt.v, rows), "v")}
            del opt
    if post is not None and event < steps:
        rows = prog["event"]["out"]
        prog["post_change"] = _norms({
            k: v - post[k]
            for k, v in _params_rows(trainer.full_scene(), rows).items()})
    del post
    out["prog"] = prog
    return out


def reference_train(lc: dict, seed: int, st: dict, dev, prec,
                    fault: str | None = None) -> dict:
    """The reference's compared steps from the same start, views and
    targets, and the event when the steps hold one.  ``prec`` (the
    reference's ``Prec``) and ``fault`` make the control and the planted
    faults of the output check's calibration (``calibrate.py``).  A
    reference with a ``prepare`` gets the parameters and every view's
    camera before the steps and after the event, and the parameters it
    returns go on."""
    cfg, ref = lc["config"], reference(lc)
    prepare = getattr(ref, "prepare", None)
    w, h = cfg["width"], cfg["height"]
    fov = math.radians(cfg["fov_y_deg"])
    hp = cfg["trainer"]["adam"]
    dcfg = cfg["trainer"]["densify"]
    events = st["events"]
    event = min(events, default=None)
    used = sorted(set(st["views"]))
    tidx = {v: i for i, v in enumerate(used)}
    targets = scenes.make_targets(cfg, seed, cfg["views"], dev, index=used)
    p = {k: v.to(dev) for k, v in st["init"].items()}
    n = st["n"]
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    state = ref.zero_state(p)
    if prepare is not None:
        every = [ref.camera(*pose, w, h, fov, dev) for pose in st["poses"]]
        p = prepare(p, every, cfg)
    out = {"losses": []}
    post = None
    for i, v in enumerate(st["views"], 1):
        cam = ref.camera(*st["poses"][v], w, h, fov, dev)
        loss, g, vis = ref.gradients(p, alive, cam, targets[tidx[v]],
                                     cfg["sh_degree"], cfg, prec, fault)
        p, state, taken = ref.adam(p, g, state, vis, hp)
        out["losses"].append(loss)
        if i == 1:
            out["grad"] = _norms({k: t.reshape(n, -1)
                                  for k, t in taken.items()})
        del g, taken
        if i == (event - 1 if event else len(st["views"])):
            out["change"] = _norms({
                k: (p[k] - st["init"][k].to(dev)).reshape(n, -1)
                for k in LEAVES})
        if i == event:
            ds = max(1, int(dcfg["metric_downscale"]))
            mw, mh = max(1, w // ds), max(1, h // ds)
            idx = events[event]
            cams = [ref.camera(*st["poses"][j], mw, mh, fov, dev)
                    for j in idx]
            small = ref.resize_targets(scenes.make_targets(
                cfg, seed, cfg["views"], dev, index=idx), mw, mh)
            votes = ref.importance(p, alive, cams, small, cfg["sh_degree"],
                                   cfg, prec, fault)
            del small
            cap = ref.grown_capacity(n, st["capacity"], dcfg)
            r = ref.densify(p, state, votes, dcfg, cap, st["noise_seed"],
                            fault)
            p, state, n = r["params"], r["state"], r["rows"]
            alive = torch.ones(n, dtype=torch.bool, device=dev)
            if prepare is not None:
                p = prepare(p, every, cfg)
            out["event"], out["capacity"] = r["event"], cap
            out["event_state"] = state_norms(
                {k: p[k].reshape(n, -1) for k in LEAVES}, "params")
            out["event_moments"] = {
                **state_norms({k: state[k][0] for k in LEAVES}, "m"),
                **state_norms({k: state[k][1] for k in LEAVES}, "v")}
            post = p
            print(f"event: program {st['prog']['event']}, capacity "
                  f"{st['prog']['capacity']}; reference {r['event']}, "
                  f"capacity {cap}", file=sys.stderr)
    if post is not None and event < len(st["views"]):
        out["post_change"] = _norms({k: (p[k] - post[k]).reshape(n, -1)
                                     for k in LEAVES})
    return out


def probe_train(lc: dict, trainer, targets: dict, dev) -> dict:
    """A fixed probe: ``train_step`` on the first dataset views of the
    scene as the window leaves it, timed without the profiler (see
    :func:`profile_probe`).  It holds that scene and optimizer state (a
    step makes new tensors and updates none in place), so the trainer may
    go on and the probe still times the work counted on them."""
    from webdgs_tpu_torch.config import quantize_budget
    from webdgs_tpu_torch.core.camera import make_camera
    from webdgs_tpu_torch.train.step import train_step

    cfg = lc["config"]
    w, h = cfg["width"], cfg["height"]
    tc = trainer.config
    st = trainer.settings
    scene, opt = trainer.full_scene(), trainer.full_opt_state()
    cams = [make_camera(c, w, h, device=dev) for c in targets["cams"]]
    kw = dict(img_w=w, img_h=h, loss_cfg=tc.loss, hp=tc.adam, settings=st)
    caps = []
    for cam, img in zip(cams, targets["images"]):
        m = train_step(scene, opt, cam, img, entry_capacity=None, **kw)[2]
        caps.append(quantize_budget(float(m["tile_entries"]) * 1.2,
                                    st.chunk, st.chunk * 8))

    def once():
        for cam, img, cap in zip(cams, targets["images"], caps):
            train_step(scene, opt, cam, img, entry_capacity=cap, **kw)

    once()
    reps = lc["traffic"]["probe_repeats"]
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        once()
    sync(dev)
    wall = (time.perf_counter() - t0) / (reps * len(cams))
    return {"kind": "train", "wall_s": wall, "units": len(cams),
            "run": once, "dev": dev,
            "scene": {k: v.detach().cpu() for k, v in scene.params().items()},
            "alive": scene.alive.cpu()}


def profile_probe(probe: dict) -> dict:
    """Device time by kernel of one profiled run of the probe."""
    with profiler() as prof:
        probe.pop("run")()
        sync(probe.pop("dev"))
    return summarize_profile(prof, 0.0, probe["units"])["kernels"]


def run_train(lc: dict, seed: int, seconds: float, trace: bool, dev) -> dict:
    tr, cfg = lc["traffic"], lc["config"]
    st = setup_train(lc, seed, dev)
    trainer = st["trainer"]
    trainer.train(tr["warmup_steps"], log_fn=None)
    probe_in = None
    if trace:
        k = tr["probe_views"]
        probe_in = {"cams": st["cams"][:k],
                    "images": scenes.make_targets(cfg, seed, cfg["views"],
                                                  dev, index=range(k))}
    sync(dev)
    setup_s = time.perf_counter() - T_START

    sched = trainer.config.densify.schedule
    tally = {"attempted": 0, "failed": 0, "broken": False}
    steps = []  # traced window: (seconds, event step) of each step
    events = []  # the window's events: (cloned, split, pruned, out)

    def advance(chunk: int, timed: bool = False) -> None:
        """``chunk`` steps; ``timed`` ends them in a synchronisation and
        records their time."""
        before = trainer.iteration
        last = trainer.last_densify_event
        ts = time.perf_counter()
        try:
            m = trainer.train(chunk, log_fn=None)
        except (RuntimeError, FloatingPointError) as e:
            print(f"step failed: {e!r}", file=sys.stderr)
            tally["attempted"] += chunk
            tally["failed"] += chunk
            tally["broken"] = True
            return
        tally["attempted"] += chunk
        done = trainer.iteration - before
        if done != chunk or not math.isfinite(m["loss"]):
            tally["failed"] += chunk
        ev = trainer.last_densify_event
        if ev is not last and ev is not None:
            events.append(tuple(ev[k] for k in ("cloned", "split", "pruned",
                                                "out")))
        if timed:
            sync(dev)
            steps.append((time.perf_counter() - ts,
                          sched.should_densify(trainer.iteration)))

    it0 = trainer.iteration
    gc0, alloc0 = gc_counts(), allocator(dev)
    t0 = time.perf_counter()
    stamps = [t0]
    while not tally["broken"] and stamps[-1] - t0 < seconds:
        if trace:
            advance(1, timed=True)
        elif tr["chunk"] == "to_next_event":
            # whole periods: each chunk ends in an event, so the window
            # holds as many events as periods whatever its length
            advance(trainer.next_densify_iteration() - trainer.iteration)
        else:
            advance(tr["chunk"])
        stamps.append(time.perf_counter())
    sync(dev)
    window = time.perf_counter() - t0
    iters = trainer.iteration - it0
    print(f"window: {window:.3f} s, {iters} iterations from "
          f"{it0}; events (cloned, split, pruned, out): {events}",
          file=sys.stderr)
    report_chunks(stamps, gc0, alloc0, dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    result = {"attempted": tally["attempted"], "failed": tally["failed"],
              "setup_s": setup_s, "peak": peak,
              "rate": iters / window}
    ctx = None
    if trace:
        # the profiler comes last: once it has run, every launch of the
        # process costs more on the host
        probe = probe_train(lc, trainer, probe_in, dev)
        k = tr["profile_steps"]
        while any(sched.should_densify(trainer.iteration + i)
                  for i in range(1, k + 1)):
            advance(1)
        with profiler() as prof:
            sync(dev)
            ts = time.perf_counter()
            advance(k)
            sync(dev)
            wall = time.perf_counter() - ts
        # read each profile before the next one starts
        ctx = {"kind": "train", "steps": steps, "probe": probe,
               "trace": summarize_profile(prof, wall, k)}
        probe["kernels"] = profile_probe(probe)
    del trainer, st["trainer"], probe_in
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if trace:
        probe = ctx["probe"]
        probe.update(_probe_counts_train(lc, probe.pop("scene"),
                                         probe.pop("alive"), st, dev))
    refo = reference_train(lc, seed, st, dev, reference(lc).Prec("fp32"))
    result["numbers"] = compare_train(st["prog"], refo)
    result["ctx"] = ctx
    return result


def _probe_counts_train(lc, p_cpu, alive_cpu, st, dev) -> dict:
    """The probe's work, counted by the plain reference from its inputs:
    the scene as the run left it and the probe's views."""
    cfg, ref = lc["config"], reference(lc)
    rs = ref_settings(lc)
    w, h = cfg["width"], cfg["height"]
    fov = math.radians(cfg["fov_y_deg"])
    p = {k: v.to(dev) for k, v in p_cpu.items()}
    alive = alive_cpu.to(dev)
    tot = {"flops": 0.0, "fwd_s": 0.0, "bwd_s": 0.0}
    for i in range(lc["traffic"]["probe_views"]):
        cam = ref.camera(*st["poses"][i], w, h, fov, dev)
        r = ref.render(p, alive, cam, cfg["sh_degree"], rs, ref.Prec(),
                       pairs=True)
        tot["flops"] += counts.train_step_flops(r["alive"], cfg["sh_degree"],
                                                r["pairs"], r["pixels"])
        for key, fn in (("fwd", counts.raster_fwd),
                        ("bwd", counts.raster_bwd)):
            s, bound = counts.least_time(*fn(r["pairs"], r["needed_entries"],
                                             r["pixels"], r["tiles"]))
            tot[key + "_s"] += s
            print(f"probe view {i}: {r['pairs']:.0f} pairs, "
                  f"{r['needed_entries']} entries, {key} bound by {bound}",
                  file=sys.stderr)
    return tot


# ----------------------------------------------------------------------
# viewer cell

def _frame_pose(viewer, pose) -> None:
    viewer.control.position = pose[0].astype(np.float32)
    viewer.control.rotation = pose[1].astype(np.float32)


def run_view(lc: dict, seed: int, seconds: float, trace: bool, dev) -> dict:
    from webdgs_tpu_torch.core.scene import GaussianScene
    from webdgs_tpu_torch.render.viewer import Viewer

    cfg, tr = lc["config"], lc["traffic"]
    params = scenes.make_scene(cfg, seed, dev)
    n = params["means"].shape[0]
    init = {k: v.cpu() for k, v in params.items()}
    scene = GaussianScene(alive=torch.ones(n, dtype=torch.bool, device=dev),
                          sh_deg=cfg["sh_degree"], **params)
    del params
    viewer = Viewer(scene, cfg["width"], cfg["height"],
                    program_settings(cfg), fov_y_deg=cfg["fov_y_deg"],
                    device=dev)
    poses = scenes.ring_poses(cfg, seed, tr["orbit_frames"], salt=4,
                              ordered=True)
    for i in range(tr["warmup_frames"]):
        _frame_pose(viewer, poses[-1 - i])
        viewer.render()
    sync(dev)
    setup_s = time.perf_counter() - T_START

    kept = {}
    tally = {"attempted": 0, "failed": 0, "broken": False}

    def frame(i: int) -> None:
        pose = poses[i % len(poses)]
        _frame_pose(viewer, pose)
        tally["attempted"] += 1
        try:
            img = viewer.render()
        except RuntimeError as e:
            print(f"frame failed: {e!r}", file=sys.stderr)
            tally["failed"] += 1
            tally["broken"] = True
            return
        # a frame's values are checked after the window: the compared
        # frames against the reference, where a non-finite pixel fails
        if i < tr["compare_from"]:
            kept[i] = (pose, img)

    gc0, alloc0 = gc_counts(), allocator(dev)
    t0 = time.perf_counter()
    stamps = [t0]
    i = 0
    while not tally["broken"] and stamps[-1] - t0 < seconds:
        frame(i)
        i += 1
        stamps.append(time.perf_counter())
    sync(dev)
    window = time.perf_counter() - t0
    print(f"window: {window:.3f} s, {tally['attempted']} frames",
          file=sys.stderr)
    report_chunks(stamps, gc0, alloc0, dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    result = {"attempted": tally["attempted"], "failed": tally["failed"],
              "setup_s": setup_s, "peak": peak,
              "rate": (tally["attempted"] - tally["failed"]) / window}
    ctx = None
    if trace:
        # the probe frame at a fixed pose, timed; then the profiler, last
        _frame_pose(viewer, poses[0])
        viewer.render()
        reps = tr["probe_repeats"]
        sync(dev)
        ts = time.perf_counter()
        for _ in range(reps):
            viewer.render()
        sync(dev)
        probe = {"kind": "view", "wall_s": (time.perf_counter() - ts) / reps,
                 "units": 1, "run": viewer.render, "dev": dev}
        k = tr["profile_frames"]
        with profiler() as prof:
            sync(dev)
            ts = time.perf_counter()
            for j in range(i, i + k):
                frame(j)
            sync(dev)
            wall = time.perf_counter() - ts
        # read each profile before the next one starts
        ctx = {"kind": "view", "probe": probe,
               "trace": summarize_profile(prof, wall, k)}
        _frame_pose(viewer, poses[0])
        probe["kernels"] = profile_probe(probe)
    del viewer, scene
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference(lc)
    rs = ref_settings(lc)
    fov = math.radians(cfg["fov_y_deg"])
    p = {k: v.to(dev) for k, v in init.items()}
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    # the compared frames: a sample drawn from the seed of the first
    # frames the window finished
    rng = np.random.default_rng([int(seed), 5])
    done = sorted(kept)
    pick = rng.choice(len(done), min(tr["compare_frames"], len(done)),
                      replace=False)
    gaps = []
    for pose, img in (kept[done[j]] for j in sorted(pick)):
        cam = ref.camera(pose[0], pose[1], cfg["width"], cfg["height"], fov,
                         dev)
        r = ref.render(p, alive, cam, cfg["sh_degree"], rs, ref.Prec())
        d = torch.from_numpy(img).to(dev) - r["image"]
        gaps.append(float(torch.sqrt((d.double() ** 2).mean())))
    result["numbers"] = {"frame_rms_gap": max(gaps) if gaps else math.inf}
    if trace:
        pose = poses[0]
        cam = ref.camera(pose[0], pose[1], cfg["width"], cfg["height"], fov,
                         dev)
        r = ref.render(p, alive, cam, cfg["sh_degree"], rs, ref.Prec(),
                       pairs=True)
        s, bound = counts.least_time(*counts.raster_fwd(
            r["pairs"], r["needed_entries"], r["pixels"], r["tiles"]))
        print(f"probe frame: {r['pairs']:.0f} pairs, "
              f"{r['needed_entries']} entries, fwd bound by {bound}",
              file=sys.stderr)
        ctx["probe"].update({
            "flops": counts.frame_flops(r["alive"], cfg["sh_degree"],
                                        r["pairs"]),
            "fwd_s": s})
    result["ctx"] = ctx
    return result


# ----------------------------------------------------------------------

def run_cell(lc: dict, seed: int, seconds: float, trace: bool, dev) -> dict:
    """One run of a loaded cell on ``dev``; the result line's fields."""
    if dev.type == "cuda":
        torch.zeros((), device=dev)  # the allocator exists from here
        torch.cuda.reset_peak_memory_stats(dev)
    kind = lc["traffic"]["kind"]
    run = {"train": run_train, "view": run_view}[kind]
    res = run(lc, seed, seconds, trace, dev)
    print(f"phases: setup {res['setup_s']:.1f} s, reference done at "
          f"{time.perf_counter() - T_START:.1f} s", file=sys.stderr)
    ok, checks = judge(res["numbers"], lc["limits"])
    correct = ok and res["failed"] == 0
    if trace:
        metrics = {}
        for m in lc["per_layer"]:
            v = read_metric(lc["readers"][m["name"]], res["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        # setup_s, and the rate over the window under each other name
        metrics = {}
        for m in lc["e2e"]:
            if m["name"] != "setup_s" and m["unit"] != RATE_UNIT[kind]:
                raise KeyError(f"a {kind} run reads no {m['name']!r}")
            metrics[m["name"]] = {"value": res["setup_s"] if m["name"]
                                  == "setup_s" else res["rate"],
                                  "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": res["peak"]}
    out = {"correct": correct, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": device}
    if trace:
        tr = res["ctx"]["trace"]
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    lc = load_cell(args.workload)
    chips = int(lc["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"card: {power_limit()}", file=sys.stderr)
    out = run_cell(lc, args.seed, args.seconds, bool(args.trace), dev)
    bad = banned_modules()
    if bad:
        print(f"loaded in this process, which the port may not load: {bad}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
