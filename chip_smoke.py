"""On-chip smoke test of the PyTorch + CUDA port (webdgs_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero with no result):
  1. device: CUDA must be available; prints the card's name and power limit;
  2. build: compiles the CUDA kernels of webdgs_tpu_torch/csrc from the
     checkout (nvcc, sm_90a) and prints the build time;
  3. kernels: each kernel against its plain torch version on the card, at
     the shapes the bench frame and the bench training step give it (100k
     random Gaussians, seed 0, 800x600, camera at (0, 0, -8)), and the
     importance kernel at the bench scene's 400x300 metric view (equal to
     its plain version on every slot), with both times, each kernel since
     the first slice run twice and required bit-identical, and the bound
     (bytes or operations) this run's inputs need;
  4. the viewer slice: a Viewer renders 5 bench frames through the render
     kernels (their launch counters are reset just before and must grow),
     and a small frame rendered on the card matches the plain CPU render;
  5. the training slice: bench.py's recipe (target = the scene's own
     render, capacity 1.2x the observed entries), 20 train_steps through
     all five kernels (every counter reset just before and must grow),
     finite parameters and loss, one step from one state twice giving
     bit-identical parameters, and a small step on the card matching the
     CPU;
  6. realistic size: one frame and 3 train steps of 1M Gaussians at
     sh_deg 3, 1920x1080;
  7. server: a view-mode ViewerServer on 127.0.0.1 answers 3 JPEG frames,
     a control post and /stats over HTTP;
  8. the entry point: ``python -m webdgs_tpu_torch train --no-densify`` on
     a synthetic COLMAP dataset (scripts/make_synthetic_colmap.py) exits 0
     with a checkpoint, a PLY and finite losses;
  9. densify at realistic size: a Trainer over the 1M sh3 scene with 10
     synthetic 1920x1080 views runs two densify events (every counter reset
     just before and the importance and segment-sum counters must grow;
     clone, split and prune each > 0; capacity growth; finite parameters;
     the synchronizing calls of each event counted), the importance kernel
     equals its plain version on every slot of one 960x540 metric view of
     the post-event state, and a small event on the card matches the same
     event on the CPU;
 10. ``train`` with densification and ``export`` on the synthetic dataset:
     exit 0, logged point counts that change, a PLY that loads;
 11. a live-training server over HTTP: /stats shows the iteration advancing,
     /loss.jpg returns a JPEG, and an upload of the dataset sets it.
It prints one JSON line of per-kernel results, the card line again, and as
its last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings

import numpy as np

RAST_ATOL = 3e-4  # rgb / acc / T, tests/test_render_forward.py:65-68
NC_MISMATCH = 0.005  # n_contrib, tests/test_render_forward.py:69-71
LOSS_ATOL = 1e-5  # tile-loss dpix; its metric sums within rtol 1e-5
BWD_TOL = 1e-4  # backward raster, scale-normalised (test_gradients.py:82)
SEGSUM_TOL = 1e-5  # segment sum, scale-normalised

# the H100 SXM's published peaks: HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BPS = 3.35e12
FP32_OPS = 67e12
# float32 operations per (pixel, entry) pair the raster kernels evaluate,
# counted from their source (exp and log1p as one operation each): the
# forward's alpha test (~16) plus its compositing (~12); the backward's
# alpha test plus ~38 for dL/dalpha, the 9 per-pixel terms and T
FWD_OPS_PER_PAIR = 28
BWD_OPS_PER_PAIR = 54
# the alpha test alone (the importance kernel's work per pair)
ALPHA_OPS_PER_PAIR = 16


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bench_scene(device, n: int = 100_000):
    """bench.py's scene: seed 0, random Gaussians, RGB as SH DC."""
    from webdgs_tpu_torch.core.scene import scene_from_arrays
    rng = np.random.default_rng(0)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    return scene_from_arrays(
        rng.normal(0, 1.5, (n, 3)).astype(np.float32), quats=quats,
        log_scales=rng.uniform(-4.5, -2.5, (n, 3)).astype(np.float32),
        opacity_logits=rng.uniform(-1, 3, (n,)).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        device=device)


def scene_1m(device, n: int = 1_000_000):
    """scripts/bench_1m.py's scene at sh_deg 3: its seed-0 recipe, then
    higher-order SH coefficients drawn from the same generator."""
    from webdgs_tpu_torch.core.scene import SH_C0, scene_from_arrays
    rng = np.random.default_rng(0)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    means = rng.normal(0, 2.5, (n, 3)).astype(np.float32)
    log_scales = rng.uniform(-5.5, -3.5, (n, 3)).astype(np.float32)
    opacity = rng.uniform(-2, 2, (n,)).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    sh = rng.normal(0, 0.1, (n, 16, 3)).astype(np.float32)
    sh[:, 0, :] = (colors - 0.5) / SH_C0
    return scene_from_arrays(means, quats=quats, log_scales=log_scales,
                             opacity_logits=opacity, sh=sh, sh_deg=3,
                             device=device)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back runs, by CUDA
    events after ``warmup`` runs."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_pair(kernel, plain, iters: int, plain_iters: int):
    """Kernel and plain times in turns (kernel, plain, kernel, plain); the
    mean of each version's two readings."""
    k1 = cuda_ms(kernel, iters)
    p1 = cuda_ms(plain, plain_iters, warmup=1)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, plain_iters, warmup=1)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take: bytes over the HBM rate or
    float32 operations over the peak rate, whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, n_ops / FP32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def evaluated_pairs(fwd_tiles, tile_offsets, settings) -> int:
    """(pixel, entry) pairs the raster kernels evaluate on these inputs: a
    pixel walks its tile's range until its transmittance drops below the
    threshold -- through its last contributor (n_contrib) when saturated,
    the whole range otherwise."""
    import torch
    cnt = (tile_offsets[1:] - tile_offsets[:-1]).to(torch.float64)[:, None]
    sat = fwd_tiles[:, 4] < settings.t_threshold
    per_px = torch.where(sat, fwd_tiles[:, 5].to(torch.float64), cnt)
    return int(per_px.sum())


def max_rel(a, b) -> float:
    """max |a - b| / max(max|b|, 1): the scale-normalised error."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)


# (module of webdgs_tpu_torch.ops, wrapper, kernel name in the JSON line)
KERNEL_COUNTERS = (("expand", "expand_fields", "expand_fields"),
                   ("rasterize", "rasterize_tiles", "rasterize_tiles"),
                   ("tile_loss", "tile_loss_tiles", "tile_loss"),
                   ("rasterize", "rasterize_tiles_backward",
                    "rasterize_tiles_backward"),
                   ("segsum", "segment_sum_rows", "segment_sum_rows"),
                   ("importance", "entry_counts", "entry_counts"))
# the kernels each path must launch: a viewer frame, a training step (the
# densify run, steps and events, launches all six)
VIEWER_KERNELS = ("expand_fields", "rasterize_tiles")
TRAIN_KERNELS = VIEWER_KERNELS + ("tile_loss", "rasterize_tiles_backward",
                                  "segment_sum_rows")


def _wrappers():
    import importlib
    for mod, fn, name in KERNEL_COUNTERS:
        m = importlib.import_module(f"webdgs_tpu_torch.ops.{mod}")
        yield getattr(m, fn), name


def kernel_counters() -> dict:
    """The launch counter of every kernel wrapper, by kernel name."""
    return {name: fn.kernel_launches for fn, name in _wrappers()}


def reset_kernel_counters() -> None:
    for fn, _ in _wrappers():
        fn.kernel_launches = 0


def metric_view_inputs(scene, cam, target, mw: int, mh: int,
                       threshold: float, settings):
    """The importance kernel's inputs for one metric view, built as
    ``view_importance_counts`` builds them: (attrs16, tile_offsets,
    pix_tiles, ntx, nty) and the view's valid entry count."""
    import torch
    from webdgs_tpu_torch.ops import binning, importance, rasterize
    from webdgs_tpu_torch.ops.projection import project_gaussians
    with torch.no_grad():
        attrs, aux = project_gaussians(scene.params(), scene.alive, cam, mw,
                                       mh, scene.sh_deg, settings)
        bins = binning.bin_splats(aux, mw, mh, settings, attrs=attrs,
                                  with_source=True)
        m16 = rasterize.pack_entry_attrs(attrs, bins.entry_gauss,
                                         bins.entry_valid)
        ntx, nty = binning.tile_grid(mw, mh, settings)
        out = rasterize.rasterize_tiles(m16, bins.tile_offsets, ntx, nty,
                                        settings)
        tiles = rasterize.tiles_to_image(out, ntx, nty, mw, mh, settings)
        pred = rasterize.composite_background(tiles, settings)
        flag = importance.metric_flag_map(pred, target, threshold)
        pix = torch.stack([flag, tiles[..., rasterize.OUT_NCONTRIB]], -1)
        pix_tiles = rasterize.image_to_tiles(pix, ntx, nty,
                                             settings).contiguous()
    return ((m16, bins.tile_offsets, pix_tiles, ntx, nty, settings),
            int(bins.total_entries))


def importance_check(label: str, margs, n_valid: int, plain_iters: int
                     ) -> dict:
    """The importance kernel against ``entry_counts_plain`` on one metric
    view's inputs: every slot equal and two runs bit-identical.  Returns
    both times, the bound from these inputs and the view's load."""
    import torch
    from webdgs_tpu_torch.ops import importance
    m16, toff, pix_tiles, ntx, nty, settings = margs
    ik = importance.entry_counts(*margs)
    ik2 = importance.entry_counts(*margs)
    ip = importance.entry_counts_plain(*margs)
    torch.cuda.synchronize()
    check(torch.equal(ik, ik2), f"importance kernel ({label}) is not "
          "bit-identical")
    n_diff = int((ik != ip).sum())
    k_sum, p_sum = float(ik.sum()), float(ip.sum())
    check(p_sum > 0, f"importance view ({label}) counted nothing")
    check(n_diff == 0, f"importance kernel ({label}): {n_diff} of "
          f"{ip.shape[0]} slots differ from the plain version (sum {k_sum} "
          f"vs {p_sum})")
    k_ms, p_ms = time_pair(
        lambda: importance._entry_counts_cuda(*margs),
        lambda: importance.entry_counts_plain(*margs), 50, plain_iters)
    flag = pix_tiles[..., 0] > 0
    nc = torch.where(flag, pix_tiles[..., 1], 0.0).to(torch.float64)
    n_tiles = ntx * nty
    # entries the kernel must read: in each tile with a flagged pixel, its
    # range up to the largest flagged n_contrib (0 in the other tiles)
    needed = int(torch.minimum((toff[1:] - toff[:-1]).to(torch.float64),
                               nc.amax(dim=1)).sum())
    # (flagged pixel, entry) pairs: each flagged pixel walks its tile's
    # range through its n_contrib
    pairs = int(nc.sum())
    # 8 used rows of the needed entries, the offsets and the (T, P, 2)
    # pixels in; the zeroed (E,) counts out
    bound = bound_ms(4 * (8 * needed + n_tiles + 1
                          + 2 * n_tiles * settings.tile_px + m16.shape[1]),
                     ALPHA_OPS_PER_PAIR * pairs)
    res = {"ms": k_ms, "plain_ms": p_ms, "bound": bound,
           "err": float((ik - ip).abs().max()), "sum": p_sum,
           "slots": ip.shape[0], "valid": n_valid,
           "nonzero": int((ip > 0).sum()), "flagged": int(flag.sum()),
           "pixels": int(flag.numel()), "live_tiles": int(flag.any(1).sum()),
           "tiles": n_tiles, "needed": needed, "pairs": pairs}
    print(f"[kernels] entry_counts (importance) {label}: {n_valid} valid "
          f"entries of {res['slots']} slots, {res['flagged']} of "
          f"{res['pixels']} pixels flagged, {res['live_tiles']}/{n_tiles} "
          f"live tiles, {needed} entries read, {pairs} (flagged pixel, "
          f"entry) pairs; all slots equal to the plain version ("
          f"{res['nonzero']} non-zero, sum {p_sum:.0f}); bit-identical "
          f"repeat; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; bound "
          f"{bound[0]:.4f} ms ({bound[1]})", flush=True)
    return res


def densify_phase(dev, s1m, n: int = 1_000_000,
                  size: tuple[int, int] = (1920, 1080)) -> dict:
    """Two densify events through the Trainer at 1M sh3 / 1920x1080 with
    10 synthetic views (the default metric_views=10, metric_downscale=2:
    960x540).  The views are cameras near (0, 0, -10); their targets are
    renders of the scene with positions and SH perturbed by a fixed numpy
    noise.  Thresholds are set so that each event clones, splits and
    prunes."""
    import torch
    from webdgs_tpu_torch.core.camera import CameraData, make_camera
    from webdgs_tpu_torch.render.renderer import render
    from webdgs_tpu_torch.train.config import load_trainer_config
    from webdgs_tpu_torch.train.trainer import Trainer

    W, H = size
    big = scene_1m(dev, n)
    fy = 0.5 * H / math.tan(math.radians(45.0) / 2)
    rng = np.random.default_rng(5)
    cams, imgs = [], []
    with torch.no_grad():
        pert = big.with_params({
            **big.params(),
            "means": big.means + torch.tensor(
                rng.normal(0, 0.01, (big.capacity, 3)), dtype=torch.float32,
                device=dev),
            "sh": big.sh + torch.tensor(
                rng.normal(0, 0.1, (big.capacity, 16, 3)),
                dtype=torch.float32, device=dev)})
        for i in range(10):
            pos = np.array([0.3 * (i % 5) - 0.6, 0.2 * (i // 5) - 0.1, -10.0],
                           np.float32)
            cd = CameraData(id=i, position=pos,
                            rotation=np.eye(3, dtype=np.float32), width=W,
                            height=H, fx=fy, fy=fy, img_name=f"v{i:02d}.png")
            img = render(pert, make_camera(cd, W, H, device=dev), W, H,
                         s1m).image
            cams.append(cd)
            imgs.append({"name": cd.img_name, "width": W, "height": H,
                         "image": img.cpu().numpy()})
    del pert
    cfg = load_trainer_config({
        "densify": {"schedule": {"warmup_iterations": 2, "interval": 2,
                                 "stop_iterations": 4},
                    "metric_threshold": 0.2, "clone_threshold_count": 1,
                    "split_scale_threshold": 0.025, "prune_opacity": 0.15,
                    "max_new_points_per_step": 50_000},
        "seed": 0})
    check(cfg.densify.metric_views == 10 and cfg.densify.metric_downscale
          == 2, "densify phase must use the default metric views")
    trainer = Trainer(big, cams, imgs, cfg, s1m)
    del big, imgs

    events = []
    run_densify = trainer._run_densify

    def timed_densify(w_, h_):
        torch.cuda.synchronize()
        before = (trainer.num_points, trainer.scene.capacity)
        t0 = time.perf_counter()
        # every call that waits for the device (a read back, a blocking
        # copy) warns once; tallied by the line that made it
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run_densify(w_, h_)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        syncs: dict[str, int] = {}
        for wn in caught:
            if "synchronizing" in str(wn.message):
                where = (f"{os.path.relpath(wn.filename)}:{wn.lineno}")
                syncs[where] = syncs.get(where, 0) + 1
        events.append({"ms": 1e3 * (time.perf_counter() - t0),
                       "points": (before[0], trainer.num_points),
                       "capacity": (before[1], trainer.scene.capacity),
                       "syncs": syncs, **trainer.last_densify_event})

    trainer._run_densify = timed_densify
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counters()
    t0 = time.perf_counter()
    for _ in range(4):
        metrics = trainer.step()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = kernel_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    check(len(events) == 2, f"expected 2 densify events, got {len(events)}")
    check(launches["entry_counts"] > 0 and launches["segment_sum_rows"] > 0,
          f"a kernel of the densify path did not launch: {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel did not launch in the densify run: {launches}")
    for ev in events:
        check(ev["cloned"] > 0 and ev["split"] > 0 and ev["pruned"] > 0,
              f"densify event did not clone, split and prune: {ev}")
        check(ev["points"][1] != ev["points"][0], f"points unchanged: {ev}")
    check(events[0]["capacity"][1] > events[0]["capacity"][0],
          f"capacity did not grow: {events[0]}")
    finite = all(bool(torch.isfinite(v).all())
                 for v in trainer.scene.params().values())
    check(finite and math.isfinite(float(metrics["loss"])),
          "densify run produced non-finite parameters or loss")
    check(int(trainer.scene.num_alive()) == trainer.num_points,
          "alive mask disagrees with the point count")
    for i, ev in enumerate(events):
        # the event reads its counts back once, so at least that one shows
        check(sum(ev["syncs"].values()) > 0, "no synchronizing call seen")
        print(f"[densify] {n} sh3 {W}x{H}, event {i + 1} at iteration "
              f"{ev['iteration']}: {ev['ms']:.2f} ms host (synchronized); "
              f"points {ev['points'][0]} -> {ev['points'][1]}; capacity "
              f"{ev['capacity'][0]} -> {ev['capacity'][1]}; cloned "
              f"{ev['cloned']}, split {ev['split']}, pruned {ev['pruned']}; "
              f"{sum(ev['syncs'].values())} synchronizing calls "
              f"{ev['syncs']}", flush=True)
    print(f"[densify] 4 steps + 2 events in {total_s:.2f} s; launches "
          f"{launches}; finite parameters; peak device memory "
          f"{peak_gb:.2f} GiB", flush=True)

    # where an event's time goes: one metric view's importance counts
    # (synchronized host time, then its device time by kernel under
    # torch.profiler) and densify_prune alone, on the post-event state
    import torch.nn.functional as F
    from webdgs_tpu_torch.ops.densify import densify_prune
    from webdgs_tpu_torch.ops.importance import view_importance_counts
    g = trainer.groups[(W, H)]
    mw, mh = W // 2, H // 2
    mcam = trainer._metric_camera(g["cams"][0], mw, mh)
    tgt = F.interpolate(g["imgs"][0:1].permute(0, 3, 1, 2), size=(mh, mw),
                        mode="bilinear", align_corners=False,
                        antialias=True)[0].permute(1, 2, 0).contiguous()
    sc = trainer.scene

    def one_view():
        return view_importance_counts(
            sc.params(), sc.alive, sc.sh_deg, mcam, tgt, mw, mh,
            cfg.densify.metric_threshold, s1m)

    counts = one_view()
    view_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counts = one_view()
        torch.cuda.synchronize()
        view_ms.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    densify_prune(sc, trainer.opt_state, counts, cfg.densify,
                  trainer.generator)
    torch.cuda.synchronize()
    prune_ms = 1e3 * (time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        one_view()
        torch.cuda.synchronize()
    dev_ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in dev_ev:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"[densify] event breakdown, capacity {sc.capacity}: one "
          f"{mw}x{mh} importance view {[round(t, 2) for t in view_ms]} ms "
          f"host (x10 views per event), densify_prune {prune_ms:.2f} ms; "
          f"profiled view: device kernel time {busy:.2f} ms in "
          f"{len(dev_ev)} device ops, top "
          f"{[(k, round(v, 3)) for k, v in top]}", flush=True)
    del counts

    # the importance kernel against its plain version at the load an event
    # gives it: this metric view of the post-event state
    margs, n_valid = metric_view_inputs(sc, mcam, tgt, mw, mh,
                                        cfg.densify.metric_threshold, s1m)
    imp = importance_check(f"{mw}x{mh} densify view", margs, n_valid, 1)
    del trainer, sc, margs
    torch.cuda.empty_cache()
    return {"launches": launches, "events": events, "peak_gb": peak_gb,
            "importance": imp}


def small_event_phase(dev, settings) -> None:
    """One small densify event on the card against the same event on the
    CPU: importance counts of two views, decide, cap and the transforms
    with one injected numpy noise."""
    import torch
    from webdgs_tpu_torch.core.camera import default_camera
    from webdgs_tpu_torch.ops import densify, importance
    from webdgs_tpu_torch.ops.adam import init_adam_state
    from webdgs_tpu_torch.train.config import DensifyPruneConfig

    n, sw, sh = 600, 96, 80
    small = bench_scene("cpu", n=n)
    rng = np.random.default_rng(6)
    targets = rng.random((2, sh, sw, 3)).astype(np.float32)
    noise = (rng.uniform(-1, 1, (n, 3)).astype(np.float32),
             rng.normal(size=(n, 3)).astype(np.float32))

    def counts_on(d):
        sc = small.to(d)
        cams = [default_camera(sw, sh, position=p, device=d)
                for p in ((0.0, 0.0, -6.0), (0.3, 0.1, -6.0))]
        return sc, importance.multiview_importance_counts(
            sc.params(), sc.alive, sc.sh_deg, cams,
            torch.tensor(targets, device=d), sw, sh, 0.3, settings)

    _, cpu_counts = counts_on("cpu")
    # a threshold between the half-integer averages, above 70 % of them
    thr = float(torch.quantile(cpu_counts, 0.7)) + 0.25
    cfg = DensifyPruneConfig(clone_threshold_count=thr,
                             split_scale_threshold=0.05, prune_opacity=0.4,
                             max_new_points_per_step=100)
    res = {}
    for d in ("cpu", dev):
        sc, counts = counts_on(d)
        c, a = densify.decide(sc, counts, cfg)
        max_out = torch.clamp(sc.alive.sum(dtype=torch.int32)
                              + cfg.max_new_points_per_step, max=n)
        c, a, total = densify.cap_counts(c, a, max_out)
        params, opt, valid = densify.compact_transform(
            sc.params(), init_adam_state(sc.params()), c, a, total,
            torch.tensor(noise[0], device=d), torch.tensor(noise[1],
                                                           device=d))
        res[str(d)] = (counts.cpu(), c.cpu(), a.cpu(), int(total),
                       {k: v.cpu() for k, v in params.items()}, valid.cpu())
    rc, rg = res["cpu"], res[str(dev)]
    agree = float((rc[0] == rg[0]).float().mean())
    same = torch.equal(rc[1], rg[1]) and torch.equal(rc[2], rg[2]) and \
        rc[3] == rg[3] and torch.equal(rc[5], rg[5])
    p_err = max(max_rel(rg[4][k], rc[4][k]) for k in rc[4])
    acts = [int((rc[2] == k).sum()) for k in range(4)]
    check(same and p_err <= 1e-5,
          f"small densify event, card vs CPU: decisions identical {same}, "
          f"params scaled err {p_err}, counts agree on {agree}")
    print(f"[densify] 600 Gaussians 2 views 96x80, card vs plain CPU: counts "
          f"equal on {agree:.4f} of Gaussians, decisions identical "
          f"(keep/clone/split/prune {acts}, {rc[3]} out), params scaled err "
          f"{p_err:.2e}", flush=True)


def cli_densify_phase(tmp: str, data: str, sparse: str,
                      device: str = "cuda") -> None:
    """``train`` with densification (events at 10, 20, 30) and ``export``
    of its checkpoint."""
    from webdgs_tpu_torch.io.ply import load_point_cloud
    ck, ply = os.path.join(tmp, "ck_densify.npz"), os.path.join(tmp, "e.ply")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "webdgs_tpu_torch", "train", "--points",
         os.path.join(sparse, "points3D.bin"), "--cameras",
         os.path.join(sparse, "images.bin"),
         os.path.join(sparse, "cameras.bin"), "--images",
         os.path.join(data, "images"), "--iterations", "30",
         "--log-every", "1", "--densify-warmup", "10",
         "--densify-interval", "10", "--densify-stop", "30",
         "--metric-threshold", "0.3", "--clone-threshold", "1",
         "--prune-opacity", "0.72", "--device", device, "--out", ck],
        capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"train (densify) exited {proc.returncode}: {proc.stderr[-3000:]}")
    points = [int(x) for x in re.findall(r"points=(\d+)", proc.stdout)]
    losses = [float(x) for x in re.findall(r"loss=(\S+)", proc.stdout)]
    check(len(points) == 30 and len(set(points)) > 1 and
          all(map(math.isfinite, losses)),
          f"train (densify) logged points {sorted(set(points))}")
    t0 = time.perf_counter()
    exp = subprocess.run(
        [sys.executable, "-m", "webdgs_tpu_torch", "export", ck, "--out",
         ply, "--device", device], capture_output=True, text=True,
        timeout=300)
    exp_s = time.perf_counter() - t0
    check(exp.returncode == 0,
          f"export exited {exp.returncode}: {exp.stderr[-3000:]}")
    n_ply = int(load_point_cloud(ply, "cpu").num_alive())
    check(n_ply == points[-1], f"exported PLY has {n_ply} points, the "
          f"training ended with {points[-1]}")
    changes = [(i + 1, a, b) for i, (a, b) in
               enumerate(zip(points[:-1], points[1:])) if a != b]
    print(f"[cli] train (densify on) 30 iterations on 4 synthetic 800x600 "
          f"views: exit 0 in {cli_s:.1f} s; points {points[0]} -> "
          f"{points[-1]} (changes (iteration, before, after) {changes}); "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; export exit 0 in "
          f"{exp_s:.1f} s, PLY of {n_ply} points loads", flush=True)


def live_server_phase(dev, data: str, sparse: str,
                      viewer_size: tuple[int, int] = (800, 600)) -> None:
    """A ViewerServer with a Trainer attached, over HTTP."""
    import torch
    from webdgs_tpu_torch.io.colmap import load_cameras
    from webdgs_tpu_torch.io.images import load_images
    from webdgs_tpu_torch.io.ply import load_point_cloud
    from webdgs_tpu_torch.render.server import ViewerServer, make_http_server
    from webdgs_tpu_torch.render.viewer import Viewer
    from webdgs_tpu_torch.train.config import load_trainer_config
    from webdgs_tpu_torch.train.trainer import Trainer

    cams = load_cameras([os.path.join(sparse, "images.bin"),
                         os.path.join(sparse, "cameras.bin")])
    imgs = load_images(os.path.join(data, "images"))
    cfg = load_trainer_config({"densify": {"schedule": {
        "warmup_iterations": 5, "interval": 5}}})
    trainer = Trainer(load_point_cloud(os.path.join(sparse, "points3D.bin"),
                                       dev), cams, imgs, cfg)
    trainer.dataset_cameras = cams
    viewer = Viewer(trainer.scene, *viewer_size, device=dev)
    viewer.frame_scene()
    vs = ViewerServer(viewer, trainer=trainer)
    server = make_http_server(vs, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def get(path):
        return urllib.request.urlopen(url + path, timeout=120).read()

    def post(path, body):
        req = urllib.request.Request(url + path, data=body, method="POST")
        return json.loads(urllib.request.urlopen(req, timeout=120).read())

    try:
        its = []
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline:
            tr = json.loads(get("/stats"))["trainer"]
            check(not tr["error"], f"live training failed: {tr['error']}")
            its.append(tr["iteration"])
            if its[-1] >= 12 and len(set(its)) >= 3:
                break
            time.sleep(0.2)
        check(len(set(its)) >= 3 and its[-1] >= 12,
              f"/stats iteration did not advance: {its}")
        frame = get("/frame.jpg")
        loss = get("/loss.jpg")
        check(frame[:2] == loss[:2] == b"\xff\xd8",
              "/frame.jpg or /loss.jpg is not a JPEG")
        post("/control", b'{"toggle_train": 1}')
        check(not vs.training, "toggle_train did not pause training")
        staged = [post(f"/upload?name={name}",
                       open(os.path.join(data, "images", name), "rb").read())
                  ["staged"] for name in sorted(os.listdir(
                      os.path.join(data, "images")))]
        for name in ("images.bin", "cameras.bin"):
            staged.append(post(f"/upload?name={name}", open(
                os.path.join(sparse, name), "rb").read())["staged"])
        done = post("/upload_done", b"")
    finally:
        server.shutdown()
        server.server_close()
        vs.shutdown()
        thread.join(timeout=30)
    check(not thread.is_alive() and not vs._train_thread.is_alive(),
          "server or training thread did not stop")
    check(done == {"dataset": f"dataset set: {len(cams)} views"},
          f"/upload_done answered {done}")
    check(trainer.last_densify_event is not None,
          "live training ran no densify event")
    torch.cuda.synchronize()
    print(f"[server] live training over HTTP: /stats iterations {its[0]} -> "
          f"{its[-1]} ({len(its)} reads), last densify event "
          f"{trainer.last_densify_event}, {trainer.num_points} points; "
          f"/frame.jpg {len(frame)} B and /loss.jpg {len(loss)} B JPEGs; "
          f"uploads staged {staged}; /upload_done {done}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    # --- 1. device ---
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()}",
          flush=True)
    dev = torch.device("cuda")

    # --- 2. build ---
    from webdgs_tpu_torch import _build
    t0 = time.perf_counter()
    lib_path, log = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"[build] {build_s:.2f} s ({'compiled' if log is not None else 'reused'}"
          f" {lib_path.name})", flush=True)
    for line in (log or "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    import torch.nn.functional as F
    from webdgs_tpu_torch.config import RenderSettings, quantize_budget
    from webdgs_tpu_torch.core.camera import default_camera
    from webdgs_tpu_torch.ops import (binning, expand, rasterize, segsum,
                                      tile_loss)
    from webdgs_tpu_torch.ops.adam import init_adam_state
    from webdgs_tpu_torch.ops.loss import LossConfig
    from webdgs_tpu_torch.ops.projection import project_gaussians
    from webdgs_tpu_torch.render.renderer import render
    from webdgs_tpu_torch.render.viewer import Viewer
    from webdgs_tpu_torch.train.step import train_step

    # --- 3. kernels vs their plain versions at the bench shapes ---
    w, h = 800, 600
    settings = RenderSettings()
    scene = bench_scene(dev)
    cam = default_camera(w, h, position=(0.0, 0.0, -8.0), device=dev)
    ntx, nty = binning.tile_grid(w, h, settings)
    with torch.no_grad():
        attrs, aux = project_gaussians(scene.params(), scene.alive, cam, w,
                                       h, scene.sh_deg, settings)
        probe = binning.bin_splats(aux, w, h, settings, attrs=attrs)
        demand = int(probe.expansion_entries)
        # the capacity a Viewer settles on for this frame
        e_cap = quantize_budget(demand * 1.5, settings.chunk,
                                settings.chunk * 8)
        words, counts, _, _ = binning.expansion_inputs(aux, ntx, e_cap,
                                                       attrs, settings)
        bins = binning.bin_splats(aux, w, h, settings, capacity=e_cap,
                                  attrs=attrs)
        attrs16 = rasterize.pack_entry_attrs(attrs, bins.entry_gauss,
                                             bins.entry_valid)
    total = int(counts.sum())
    print(f"[kernels] bench frame: {int(aux.visible.sum())} visible, "
          f"{demand} entries, capacity {e_cap}", flush=True)
    check(total == demand > 0, "bench frame has no entries")

    ek = expand.expand_fields(words, counts, e_cap)
    ep = expand.expand_fields_plain(words, counts, e_cap)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(ek, ep)),
          "expand_fields kernel differs from its plain version")
    expand_err = max(float((a - b).abs().max()) for a, b in zip(ek, ep))
    expand_ms, expand_plain_ms = time_pair(
        lambda: expand.expand_fields(words, counts, e_cap),
        lambda: expand.expand_fields_plain(words, counts, e_cap), 50, 20)
    print(f"[kernels] expand_fields: exact on all {e_cap} slots; "
          f"kernel {expand_ms:.4f} ms, plain {expand_plain_ms:.4f} ms",
          flush=True)

    off = bins.tile_offsets
    rk = rasterize.rasterize_tiles(attrs16, off, ntx, nty, settings)
    rp = rasterize.rasterize_tiles_plain(attrs16, off, ntx, nty, settings)
    torch.cuda.synchronize()
    rast_err = float((rk[:, 0:5] - rp[:, 0:5]).abs().max())
    nc_mis = float((rk[:, 5] != rp[:, 5]).float().mean())
    check(rast_err <= RAST_ATOL, f"rasterize_tiles max abs err {rast_err}")
    check(nc_mis <= NC_MISMATCH, f"n_contrib mismatch {nc_mis}")
    check(float(rk[:, 3].max()) > 0.5, "bench frame rasterized empty")
    # kernels are timed through their launch functions: the public
    # wrappers' input checks read bounds back to the host (a sync)
    rast_ms, rast_plain_ms = time_pair(
        lambda: rasterize._rasterize_tiles_cuda(attrs16, off, ntx, nty,
                                                settings, True),
        lambda: rasterize.rasterize_tiles_plain(attrs16, off, ntx, nty,
                                                settings), 20, 3)
    pairs = evaluated_pairs(rk, off, settings)
    n_tiles, npx = ntx * nty, settings.tile_px
    # expand: words + counts in, (5, E) words + (E,) ids out
    expand_bound = bound_ms(4 * (6 * scene.capacity + 6 * e_cap), 0)
    # forward: 11 attribute rows + offsets in, (T, 8, P) tiles out
    rast_bound = bound_ms(4 * (11 * e_cap + n_tiles + 1 + 8 * n_tiles * npx),
                          FWD_OPS_PER_PAIR * pairs)
    print(f"[kernels] rasterize_tiles: max abs err {rast_err:.3e} (<= "
          f"{RAST_ATOL}), n_contrib mismatch {nc_mis:.5f} (<= "
          f"{NC_MISMATCH}); kernel {rast_ms:.4f} ms, plain "
          f"{rast_plain_ms:.4f} ms; {pairs} (pixel, entry) pairs evaluated; "
          f"bound {rast_bound[0]:.4f} ms ({rast_bound[1]})", flush=True)
    del ek, ep, rk, rp

    # --- 3b. the training kernels at the bench training step's inputs ---
    # capacity as bench.py sizes it: 1.2x the observed entries
    cap = max(-(-demand * 12 // 10 // settings.chunk) * settings.chunk,
              settings.chunk * 8)
    cfg = LossConfig()
    with torch.no_grad():
        tbins = binning.bin_splats(aux, w, h, settings, capacity=cap,
                                   attrs=attrs, with_source=True)
        t16 = rasterize.pack_entry_attrs(attrs, tbins.entry_gauss,
                                         tbins.entry_valid)
        tout = rasterize.rasterize_tiles(t16, tbins.tile_offsets, ntx, nty,
                                         settings, track_ncontrib=False)
        own = render(scene, cam, w, h, settings).image
        # the scene's own render is bench.py's target; it makes every
        # cotangent 0, so the kernels are compared on a fixed perturbation
        noise = np.random.default_rng(1).normal(0.0, 0.05, (h, w, 3))
        target_n = (own + torch.tensor(noise, dtype=torch.float32,
                                       device=dev)).contiguous()
    total_t = int(tbins.total_entries)

    dk, sk = tile_loss.tile_loss_tiles(tout, target_n, w, h, ntx, nty, cfg,
                                       settings)
    dk2, sk2 = tile_loss.tile_loss_tiles(tout, target_n, w, h, ntx, nty,
                                         cfg, settings)
    dp, sp = tile_loss.tile_loss_gradient_plain(tout, target_n, w, h, ntx,
                                                nty, cfg, settings)
    torch.cuda.synchronize()
    check(torch.equal(dk, dk2) and torch.equal(sk, sk2),
          "tile loss kernel is not bit-identical across runs")
    loss_err = float((dk - dp).abs().max())
    sums_rel = float(((sk.sum(0) - sp.sum(0)).abs()
                      / sp.sum(0).abs().clamp(min=1e-30)).max())
    check(loss_err <= LOSS_ATOL and sums_rel <= 1e-5,
          f"tile loss: dpix err {loss_err}, metric sums rel err {sums_rel}")
    check(float(dk[:, 0:3].abs().max()) > 0, "tile loss gradient is all 0")
    loss_ms, loss_plain_ms = time_pair(
        lambda: tile_loss.tile_loss_tiles(tout, target_n, w, h, ntx, nty,
                                          cfg, settings),
        lambda: tile_loss.tile_loss_gradient_plain(
            tout, target_n, w, h, ntx, nty, cfg, settings), 50, 5)
    # 4 tile channels + the target in, (T, 8, P) + (T, 4) sums out; about
    # 150 operations per pixel and channel (5 box sums of 25, SSIM, grad)
    loss_bound = bound_ms(4 * (4 * n_tiles * npx + 3 * w * h
                               + 8 * n_tiles * npx + 4 * n_tiles),
                          150 * 3 * w * h)
    print(f"[kernels] tile_loss: max abs err {loss_err:.3e} (<= "
          f"{LOSS_ATOL}), metric sums rel err {sums_rel:.2e}; bit-identical "
          f"repeat; kernel {loss_ms:.4f} ms, plain {loss_plain_ms:.4f} ms; "
          f"bound {loss_bound[0]:.4f} ms ({loss_bound[1]})", flush=True)

    suffix = (torch.sum(dk[:, 0:4] * tout[:, 0:4], dim=1, keepdim=True)
              + dk[:, 4:5] * tout[:, 4:5])
    gpix5 = torch.cat([dk[:, 0:4], suffix], dim=1).contiguous()
    toff = tbins.tile_offsets
    bk = rasterize.rasterize_tiles_backward(t16, toff, gpix5, ntx, nty,
                                            settings)
    bk2 = rasterize.rasterize_tiles_backward(t16, toff, gpix5, ntx, nty,
                                             settings)
    bp = rasterize.rasterize_tiles_backward_plain(t16, toff, gpix5, ntx,
                                                  nty, settings)
    torch.cuda.synchronize()
    check(torch.equal(bk, bk2), "backward raster is not bit-identical")
    bwd_err = max_rel(bk, bp)
    check(bwd_err <= BWD_TOL, f"backward raster scaled err {bwd_err}")
    check(not bk[11:].any() and float(bk[0:9].abs().max()) > 0,
          "backward raster rows")
    bwd_ms, bwd_plain_ms = time_pair(
        lambda: rasterize._rasterize_tiles_backward_cuda(t16, toff, gpix5,
                                                         ntx, nty, settings),
        lambda: rasterize.rasterize_tiles_backward_plain(
            t16, toff, gpix5, ntx, nty, settings), 20, 1)
    # 11 rows + offsets + (T, 5, P) cotangents in, (16, E) rows out; the
    # pairs evaluated are the forward's (the same per-pixel early exit)
    bwd_bound = bound_ms(4 * (11 * cap + n_tiles + 1 + 5 * n_tiles * npx
                              + 16 * cap), BWD_OPS_PER_PAIR * pairs)
    print(f"[kernels] rasterize_tiles_backward: scaled max err "
          f"{bwd_err:.3e} (<= {BWD_TOL}); bit-identical repeat; kernel "
          f"{bwd_ms:.4f} ms, plain {bwd_plain_ms:.4f} ms; bound "
          f"{bwd_bound[0]:.4f} ms ({bwd_bound[1]})", flush=True)

    inv = segsum.inverse_permutation(tbins.entry_source)
    counts_t = tbins.gauss_counts
    valid_t = tbins.entry_valid
    sg = segsum.segment_sum_rows(bk, counts_t, inv, valid_t)
    sg2 = segsum.segment_sum_rows(bk, counts_t, inv, valid_t)
    sgp = segsum.segment_sum_rows_plain(bk, counts_t, inv, valid_t)
    torch.cuda.synchronize()
    check(torch.equal(sg, sg2), "segment sum is not bit-identical")
    seg_err = max_rel(sg, sgp)
    check(seg_err <= SEGSUM_TOL, f"segment sum scaled err {seg_err}")
    # library yardstick: index_add_ of the rows gathered into expansion
    # order (atomics; the port never calls it)
    rows_exp = bk[:, inv[:total_t].long()].T.contiguous()
    ids_exp = tbins.expansion_gauss[:total_t].long()
    zeros_n = torch.zeros((scene.capacity, 16), dtype=torch.float32,
                          device=dev)
    lib_err = max_rel(zeros_n.clone().index_add_(0, ids_exp, rows_exp), sgp)
    seg_ms, seg_plain_ms = time_pair(
        lambda: segsum._segment_sum_rows_cuda(bk, counts_t, inv, valid_t),
        lambda: segsum.segment_sum_rows_plain(bk, counts_t, inv, valid_t),
        50, 5)
    seg_lib_ms = cuda_ms(
        lambda: zeros_n.clone().index_add_(0, ids_exp, rows_exp), 50)
    # rows (16 per entry), slots, valid flags and starts in, (N, 16) out
    seg_bound = bound_ms(4 * (16 * total_t + total_t + scene.capacity + 1
                              + 16 * scene.capacity) + total_t,
                         16 * total_t)
    print(f"[kernels] segment_sum_rows: scaled max err {seg_err:.3e} (<= "
          f"{SEGSUM_TOL}), index_add_ err {lib_err:.2e}; bit-identical "
          f"repeat; kernel {seg_ms:.4f} ms, plain {seg_plain_ms:.4f} ms, "
          f"index_add_ {seg_lib_ms:.4f} ms; bound {seg_bound[0]:.4f} ms "
          f"({seg_bound[1]}); {total_t} entries, capacity {cap}",
          flush=True)
    del dk, dk2, dp, bk, bk2, bp, sg, sg2, sgp, rows_exp, zeros_n
    torch.cuda.empty_cache()

    # --- 3c. the importance kernel at the bench scene's metric view ---
    # (a densify event renders each view at half size: 400x300; the target
    # is the bench render plus a fixed numpy noise, downscaled as the
    # Trainer does)
    mw, mh = w // 2, h // 2
    with torch.no_grad():
        noise_m = np.random.default_rng(4).normal(0.0, 0.05, (h, w, 3))
        tgt = (own + torch.tensor(noise_m, dtype=torch.float32,
                                  device=dev)).permute(2, 0, 1)[None]
        tgt = F.interpolate(tgt, size=(mh, mw), mode="bilinear",
                            align_corners=False, antialias=True)
        tgt = tgt[0].permute(1, 2, 0).contiguous()
    mcam = default_camera(mw, mh, position=(0.0, 0.0, -8.0), device=dev)
    margs, mtotal = metric_view_inputs(scene, mcam, tgt, mw, mh, 0.5,
                                       settings)
    imp_bench = importance_check(f"{mw}x{mh} bench view", margs, mtotal, 5)
    del margs

    # --- 4. the viewer slice: frames through the render kernels ---
    viewer = Viewer(scene, w, h, settings, device="cuda")
    viewer.control.position = np.array([0.0, 0.0, -8.0], np.float32)
    reset_kernel_counters()
    frame_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        img = viewer.render()  # returns host numpy: synchronized
        frame_s.append(time.perf_counter() - t0)
    launches = {k: v for k, v in kernel_counters().items()
                if k in VIEWER_KERNELS}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path did not launch: {launches}")
    check(img.shape == (h, w, 3) and bool(np.isfinite(img).all()),
          "viewer frame is not a finite 600x800x3 image")
    lit = float((img.max(axis=2) > 0.02).mean())
    check(lit > 0.05, f"viewer frame is almost all background ({lit:.3f})")
    steady_ms = 1e3 * float(np.mean(frame_s[1:]))
    print(f"[slice] Viewer 100k 800x600: frames {[round(1e3 * s, 2) for s in frame_s]} ms; "
          f"steady {steady_ms:.2f} ms/frame, "
          f"{w * h / steady_ms / 1e3:.1f} Mpix/s; {lit:.3f} of pixels lit; "
          f"launches {launches}", flush=True)

    # a small frame on the card against the plain CPU render
    sw, sh = 96, 80
    small = bench_scene("cpu", n=600)
    ref = render(small, default_camera(sw, sh, position=(0.0, 0.0, -6.0),
                                       device="cpu"), sw, sh, settings)
    got = render(small.to(dev), default_camera(sw, sh,
                                               position=(0.0, 0.0, -6.0),
                                               device=dev), sw, sh, settings)
    small_err = float((got.image.cpu() - ref.image).abs().max())
    check(small_err <= RAST_ATOL and
          int(got.binning.total_entries) == int(ref.binning.total_entries),
          f"small render on the card differs from the CPU: {small_err}")
    print(f"[slice] 600 Gaussians 96x80, card vs plain CPU: max abs err "
          f"{small_err:.3e}", flush=True)

    # --- 5. the training slice: bench.py's recipe, 20 steps ---
    opt0 = init_adam_state(scene.params())
    s_cur, o_cur = scene, opt0
    for _ in range(2):  # warm-up: first-use costs of autograd and the libs
        s_cur, o_cur, _ = train_step(s_cur, o_cur, cam, own, img_w=w,
                                     img_h=h, settings=settings,
                                     entry_capacity=cap)
    reset_kernel_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        s_cur, o_cur, m_cur = train_step(s_cur, o_cur, cam, own, img_w=w,
                                         img_h=h, settings=settings,
                                         entry_capacity=cap)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 20 * 1e3
    train_launches = {k: v for k, v in kernel_counters().items()
                      if k in TRAIN_KERNELS}
    check(all(v > 0 for v in train_launches.values()),
          f"a kernel of the training path did not launch: {train_launches}")
    finite = all(bool(torch.isfinite(v).all())
                 for v in s_cur.params().values())
    check(finite and math.isfinite(float(m_cur["loss"])),
          "training produced non-finite parameters or loss")
    check(int(m_cur["tile_entries"]) > 0, "training step binned nothing")
    print(f"[train] bench 100k 800x600, 20 train_steps after 2 warm-up: "
          f"{step_ms:.2f} "
          f"ms/step, {1e3 / step_ms:.2f} it/s; loss "
          f"{float(m_cur['loss']):.6f}, {int(m_cur['visible'])} visible, "
          f"{int(m_cur['tile_entries'])} entries; launches {train_launches}",
          flush=True)

    # one step from one state, twice: bit-identical (no atomics anywhere)
    r1 = train_step(scene, opt0, cam, target_n, img_w=w, img_h=h,
                    settings=settings, entry_capacity=cap)
    r2 = train_step(scene, opt0, cam, target_n, img_w=w, img_h=h,
                    settings=settings, entry_capacity=cap)
    same = all(torch.equal(r1.scene.params()[k], r2.scene.params()[k])
               for k in r1.scene.params()) and \
        torch.equal(r1.opt_state.m, r2.opt_state.m) and \
        torch.equal(r1.opt_state.v, r2.opt_state.v)
    check(same, "one train_step from one state differs between two runs")
    moved = float((r1.scene.means - scene.means).abs().max())
    check(moved > 0, "the perturbed-target step did not move the scene")
    print(f"[train] perturbed target: loss {float(r1.metrics['loss']):.6f}, "
          f"psnr {float(r1.metrics['psnr']):.3f}; two runs from one state "
          f"bit-identical (params and moments); max |d means| {moved:.3e}",
          flush=True)
    del r1, r2, s_cur, o_cur

    # a small step on the card against the same step on the CPU
    sw_, sh_ = 96, 80
    small_t = torch.tensor(np.random.default_rng(2).random((sh_, sw_, 3)),
                           dtype=torch.float32)
    small_res = {}
    for d in ("cpu", dev):
        sc = small.to(d)
        small_res[str(d)] = train_step(
            sc, init_adam_state(sc.params()),
            default_camera(sw_, sh_, position=(0.0, 0.0, -6.0), device=d),
            small_t.to(d), img_w=sw_, img_h=sh_, settings=settings)
    rc, rg = small_res["cpu"], small_res[str(dev)]
    loss_rel = abs(float(rg.metrics["loss"]) - float(rc.metrics["loss"])) \
        / abs(float(rc.metrics["loss"]))
    m_err = max_rel(rg.opt_state.m.cpu() * 10.0, rc.opt_state.m * 10.0)
    check(loss_rel <= 1e-4 and m_err <= 1e-3,
          f"small train step, card vs CPU: loss rel {loss_rel}, grad {m_err}")
    print(f"[train] 600 Gaussians 96x80, card vs plain CPU: loss rel err "
          f"{loss_rel:.2e}, gradient scaled err {m_err:.2e}", flush=True)

    # --- 6. realistic size: 1M Gaussians, sh_deg 3, 1920x1080 ---
    big = scene_1m(dev)
    s1m = RenderSettings(avg_tiles_per_gaussian=6)
    v1m = Viewer(big, 1920, 1080, s1m, device="cuda")
    v1m.control.position = np.array([0.0, 0.0, -10.0], np.float32)
    big_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        img1m = v1m.render()
        big_s.append(time.perf_counter() - t0)
    check(img1m.shape == (1080, 1920, 3) and
          bool(np.isfinite(img1m).all()), "1M frame is not finite")
    tiles_1m = math.prod(binning.tile_grid(1920, 1080, s1m))
    print(f"[realistic] 1M sh3 1920x1080 ({tiles_1m} tiles): frames "
          f"{[round(1e3 * s, 2) for s in big_s]} ms; steady "
          f"{1e3 * big_s[-1]:.2f} ms/frame; {v1m.entry_demand} entries",
          flush=True)
    # 3 train steps; the target is the render of the scene perturbed by a
    # fixed numpy noise (positions and DC colour)
    cam1m = default_camera(1920, 1080, position=(0.0, 0.0, -10.0),
                           device=dev)
    rng1m = np.random.default_rng(3)
    with torch.no_grad():
        pert = big.with_params({
            **big.params(),
            "means": big.means + torch.tensor(
                rng1m.normal(0, 0.01, (big.capacity, 3)),
                dtype=torch.float32, device=dev),
            "sh": big.sh + torch.tensor(
                rng1m.normal(0, 0.1, (big.capacity, 16, 3)),
                dtype=torch.float32, device=dev)})
        target1m = render(pert, cam1m, 1920, 1080, s1m).image
    del pert
    cap1m = quantize_budget(v1m.entry_demand * 1.2, s1m.chunk,
                            s1m.chunk * 8)
    s_big, o_big = big, init_adam_state(big.params())
    torch.cuda.reset_peak_memory_stats()
    big_steps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s_big, o_big, m_big = train_step(s_big, o_big, cam1m, target1m,
                                         img_w=1920, img_h=1080,
                                         settings=s1m, entry_capacity=cap1m)
        torch.cuda.synchronize()
        big_steps.append(1e3 * (time.perf_counter() - t0))
    check(math.isfinite(float(m_big["loss"])) and
          bool(torch.isfinite(s_big.means).all()), "1M training not finite")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[realistic] 1M sh3 1920x1080, 3 train_steps: "
          f"{[round(t, 2) for t in big_steps]} ms (steady "
          f"{big_steps[-1]:.2f} ms/step); loss {float(m_big['loss']):.5f}; "
          f"{int(m_big['tile_entries'])} entries, capacity {cap1m}; peak "
          f"device memory {peak_gb:.2f} GiB", flush=True)
    del big, v1m, img1m, s_big, o_big, target1m
    torch.cuda.empty_cache()

    densify_res = densify_phase(dev, s1m)
    small_event_phase(dev, settings)

    # --- 7. the view-mode server over HTTP ---
    from PIL import Image
    from webdgs_tpu_torch.render.server import ViewerServer, make_http_server
    vs = ViewerServer(viewer)
    server = make_http_server(vs, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        sizes = []
        for _ in range(3):
            body = urllib.request.urlopen(url + "/frame.jpg",
                                          timeout=120).read()
            im = Image.open(io.BytesIO(body))
            im.load()
            sizes.append(im.size)
        req = urllib.request.Request(
            url + "/control", data=b'{"gaussian_scale_delta": 0.5}',
            method="POST")
        reply = json.loads(urllib.request.urlopen(req, timeout=60).read())
        stats = json.loads(urllib.request.urlopen(url + "/stats",
                                                  timeout=60).read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "server thread did not stop")
    check(all(s == (w, h) for s in sizes), f"JPEG frame sizes {sizes}")
    check(reply == {} and viewer.gaussian_scaling == 1.5,
          "control post was not applied")
    check(stats["points"] == 100_000 and stats["fps"] > 0 and
          stats["render_mode"] == "gaussian", f"bad /stats {stats}")
    print(f"[server] 3 JPEG frames {sizes}, control ok, stats {stats}",
          flush=True)

    # --- 8. the entry point: train on a synthetic COLMAP dataset ---
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "scene")
        subprocess.run([sys.executable, os.path.join(
            "scripts", "make_synthetic_colmap.py"), data, "--views", "4",
            "--width", "800", "--height", "600", "--points", "100000"],
            check=True, capture_output=True, timeout=300)
        sparse = os.path.join(data, "sparse", "0")
        ck, ply = os.path.join(tmp, "ck.npz"), os.path.join(tmp, "out.ply")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "webdgs_tpu_torch", "train", "--points",
             os.path.join(sparse, "points3D.bin"), "--cameras",
             os.path.join(sparse, "images.bin"),
             os.path.join(sparse, "cameras.bin"), "--images",
             os.path.join(data, "images"), "--no-densify", "--iterations",
             "30", "--log-every", "1", "--device", "cuda", "--out", ck,
             "--export-ply", ply], capture_output=True, text=True,
            timeout=600)
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"train command exited {proc.returncode}: {proc.stderr[-3000:]}")
        check(os.path.isfile(ck) and os.path.isfile(ply),
              "train command wrote no checkpoint or PLY")
        losses = [float(x) for x in re.findall(r"loss=(\S+)", proc.stdout)]
        ev = json.loads(proc.stdout.split("eval:", 1)[1].strip()
                        .splitlines()[0])
        check(len(losses) == 30 and all(map(math.isfinite, losses)) and
              math.isfinite(ev["train"]["psnr"]),
              f"train command losses {losses[:3]}... eval {ev}")
        print(f"[cli] train --no-densify 30 iterations on 4 synthetic "
              f"800x600 views: exit 0 in {cli_s:.1f} s; loss {losses[0]:.4f}"
              f" -> {losses[-1]:.4f}; eval psnr {ev['train']['psnr']:.3f}; "
              f"{ev['points']} points; checkpoint + PLY written", flush=True)

        cli_densify_phase(tmp, data, sparse)
        live_server_phase(dev, data, sparse)

    dlaunch = densify_res["launches"]
    imp = densify_res["importance"]

    def entry(name, source, replaces, err, ms, plain_ms, bound, lib_ms,
              **extra):
        # launches: the training path's 20 steps; launches_densify: the
        # densify run's 4 steps and 2 events
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": train_launches.get(name, dlaunch[name]),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": lib_ms, "launches_densify": dlaunch[name],
                **extra}

    kernels = [
        entry("expand_fields", "webdgs_tpu_torch/csrc/expand.cu",
              "webdgs_tpu/ops/expand.py:63", expand_err, expand_ms,
              expand_plain_ms, expand_bound, None,
              launches_viewer=launches["expand_fields"]),
        entry("rasterize_tiles", "webdgs_tpu_torch/csrc/rasterize_fwd.cu",
              "webdgs_tpu/ops/rasterize.py:239", rast_err, rast_ms,
              rast_plain_ms, rast_bound, None,
              launches_viewer=launches["rasterize_tiles"]),
        entry("tile_loss", "webdgs_tpu_torch/csrc/tile_loss.cu",
              "webdgs_tpu/ops/tile_loss.py:106", loss_err, loss_ms,
              loss_plain_ms, loss_bound, None),
        entry("rasterize_tiles_backward",
              "webdgs_tpu_torch/csrc/rasterize_bwd.cu",
              "webdgs_tpu/ops/rasterize.py:347", bwd_err, bwd_ms,
              bwd_plain_ms, bwd_bound, None),
        entry("segment_sum_rows", "webdgs_tpu_torch/csrc/segsum.cu",
              "webdgs_tpu/ops/segsum.py:56", seg_err, seg_ms, seg_plain_ms,
              seg_bound, seg_lib_ms),
        # at the densify view's inputs (the event's load); the bench
        # scene's 400x300 view beside it
        entry("entry_counts", "webdgs_tpu_torch/csrc/importance.cu",
              "webdgs_tpu/ops/importance.py:48", imp["err"], imp["ms"],
              imp["plain_ms"], imp["bound"], None,
              launches_per_event=dlaunch["entry_counts"]
              // len(densify_res["events"]),
              bench_view={"max_abs_err": imp_bench["err"],
                          "ms": imp_bench["ms"],
                          "plain_ms": imp_bench["plain_ms"],
                          "bound_ms": imp_bench["bound"][0],
                          "bound_by": imp_bench["bound"][1]}),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
