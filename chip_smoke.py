"""On-chip smoke test of the PyTorch + CUDA port (webdgs_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero with no result):
  1. device: CUDA must be available; prints the card's name and power limit;
  2. build: compiles the CUDA kernels of webdgs_tpu_torch/csrc from the
     checkout (nvcc, sm_90a) and prints the build time;
  3. kernels: each kernel against its plain torch version on the card, at
     the shapes the bench frame and the bench training step give it (100k
     random Gaussians, seed 0, 800x600, camera at (0, 0, -8)), with both
     times, each new kernel run twice and required bit-identical, and the
     bound (bytes or operations) this run's inputs need;
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
     with a checkpoint, a PLY and finite losses.
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

    # --- 4. the viewer slice: frames through the render kernels ---
    viewer = Viewer(scene, w, h, settings, device="cuda")
    viewer.control.position = np.array([0.0, 0.0, -8.0], np.float32)
    expand.expand_fields.kernel_launches = 0
    rasterize.rasterize_tiles.kernel_launches = 0
    frame_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        img = viewer.render()  # returns host numpy: synchronized
        frame_s.append(time.perf_counter() - t0)
    launches = {"expand_fields": expand.expand_fields.kernel_launches,
                "rasterize_tiles": rasterize.rasterize_tiles.kernel_launches}
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
    for fn in (expand.expand_fields, rasterize.rasterize_tiles,
               tile_loss.tile_loss_tiles, rasterize.rasterize_tiles_backward,
               segsum.segment_sum_rows):
        fn.kernel_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        s_cur, o_cur, m_cur = train_step(s_cur, o_cur, cam, own, img_w=w,
                                         img_h=h, settings=settings,
                                         entry_capacity=cap)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 20 * 1e3
    train_launches = {
        "expand_fields": expand.expand_fields.kernel_launches,
        "rasterize_tiles": rasterize.rasterize_tiles.kernel_launches,
        "tile_loss": tile_loss.tile_loss_tiles.kernel_launches,
        "rasterize_tiles_backward":
            rasterize.rasterize_tiles_backward.kernel_launches,
        "segment_sum_rows": segsum.segment_sum_rows.kernel_launches}
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

    def entry(name, source, replaces, err, ms, plain_ms, bound, lib_ms,
              **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": train_launches[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": lib_ms, **extra}

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
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
