"""On-chip smoke test of the PyTorch + CUDA port (webdgs_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

With ``--before-segsum PATH`` it also builds an earlier segsum.cu (for
example ``git archive 8c7f768 webdgs_tpu_torch/csrc/segsum.cu`` unpacked
into a directory that .gitignore lists) and times it beside the
segment-sum kernel on the same inputs, comparing their sums bit for bit.
``--before-bwd PATH`` does the same for an earlier rasterize_bwd.cu (for
example ``git archive 3554122 webdgs_tpu_torch/csrc/rasterize_bwd.cu``):
built beside the backward kernel and timed in turns with it on the same
inputs at both of its shapes, back to back and queued; this one must be
faster in every pairing.  ``--ablate-bwd`` also builds the copies of the
backward kernel that BWD_VARIANTS (and, with ``--before-bwd``,
BEFORE_BWD_VARIANTS) describe, each with one part changed, and times each
at both shapes: timing probes of where the kernel's time goes.
``--before-fwd PATH`` builds an earlier rasterize_fwd.cu (for example
``git archive 217963e webdgs_tpu_torch/csrc/rasterize_fwd.cu
webdgs_tpu_torch/csrc/splat_alpha.cuh``) and times it in turns with the
forward kernel at its three shapes (bench frame, 1M frame, densify view):
all 8 output channels must be bit-identical to it and this one faster in
every pairing.  ``--ablate-fwd`` times the copies of the forward kernel
that FWD_VARIANTS describe at the bench and 1M frames.
``--before-imp PATH`` builds an earlier importance.cu (for example
``git show 2efee97:webdgs_tpu_torch/csrc/importance.cu``) and times it in
turns with the importance kernel at both metric views (bench, densify),
back to back and queued: every slot must be equal to it and this one
faster in every pairing.  ``--ablate-imp`` times the copies of the
importance kernel that IMP_VARIANTS describe at both views.
``--before-expand PATH`` builds an earlier expand.cu (for example ``git
show dcc7ac9:webdgs_tpu_torch/csrc/expand.cu``) and times it in turns with
the expand kernel at its three shapes (bench frame, 1M frame, densify
view), back to back and queued: every slot must be equal to it, and this
kernel alone faster in every queued pairing (no slower on the mean at the
bench frame).  ``--before-loss PATH`` does the same for an earlier
tile_loss.cu at the bench and 1M training steps: all 8 dpix channels must
be bit-identical to it and this one faster in every queued pairing.
``--ablate-expand`` and ``--ablate-loss`` time the copies of those kernels
that EXPAND_VARIANTS and LOSS_VARIANTS describe.

Phases (any failure raises, and the script exits non-zero with no result):
  1. device: CUDA must be available; prints the card's name and power limit;
  2. build: compiles the CUDA kernels of webdgs_tpu_torch/csrc from the
     checkout (nvcc, sm_90a) and prints the build time;
  3. kernels: each kernel against its plain torch version on the card, at
     the shapes the bench frame and the bench training step give it (100k
     random Gaussians, seed 0, 800x600, camera at (0, 0, -8)); expand and
     tile loss also queued, with their launch shapes, and their wrappers
     run in sync debug mode "error"; and the
     importance kernel at the bench scene's 400x300 metric view (equal to
     its plain version on every slot, also queued, with its launch shape
     and registers, and run in sync debug mode "error"), with both times, each kernel since
     the first slice run twice and required bit-identical, and the bound
     (bytes or operations) this run's inputs need; the forward raster also
     queued, with its tiles' work and launch shape, and the public
     rasterize_tiles with its autograd backward run in sync debug mode
     "error"; the segment sum also
     beside the library call index_add_, and timed with the launch queue
     filled first as well as back to back; the backward kernel also queued,
     with its tiles' entry counts and the entries they visit before
     saturating, its launch shape (pixels per thread, butterfly batch,
     CTAs per SM), and its forward + autograd path run in sync debug mode
     "error" (no call may wait for the device);
     the tile cull's two kernels (cull_words, entry_keys) against the
     plain chains run on the same CUDA tensors at the bench step, every
     word, count and key equal, timed back to back and queued; the Adam
     kernel against adam_step_plain on the same CUDA tensors at the bench
     step's gradients (three steps, the moments carried) and at 2,961,408
     random rows (DC only and full SH): every lane outside the quaternion
     equal, the quaternion within 2 ulp, the largest difference over
     every lane measured, a repeat bit-identical, run in sync debug mode
     "error", each timed back to back and queued beside its bound of
     1,656 bytes a row (1,476 with DC only);
     the indexed staging (indexed_check) at the bench training step, the
     bench view, the 1M step and the 960x540 densify view: the forward,
     backward and importance kernels reading the entries through the
     binning's index (invalid slots holding index INT_MAX) bit-identical
     to the same kernels on the packed rows, the five fields' gradients
     the segment sum of the packed cotangents, each indexed wrapper in
     sync debug mode "error", and each kernel timed on both inputs in
     turns beside the pack; the Viewer's frames, the training slice's
     steps and the densify run's Trainer steps and events must leave the
     trace counter raster.packed_calls unchanged (no pack on the card);
  4. the viewer slice: a Viewer renders 5 bench frames through the render
     kernels (their launch counters are reset just before and must grow),
     and a small frame rendered on the card matches the plain CPU render;
  5. the training slice: bench.py's recipe (target = the scene's own
     render, capacity 1.2x the observed entries), 20 train_steps through
     all five kernels (every counter reset just before and must grow),
     finite parameters and loss, one step's synchronizing calls tallied
     by line (none may come from ops/rasterize.py or ops/adam.py), one
     step from one
     state twice giving bit-identical parameters, and a small step on the
     card matching the CPU;
  6. realistic size: one frame and 3 train steps of 1M Gaussians at
     sh_deg 3, 1920x1080, and the forward, backward, tile-loss, expand
     and tile-cull kernels against their plain versions at that frame's
     and step's inputs; one full-SH step (every SH coefficient trained
     through the SH stage's VJP) beside the DC step from the same state,
     held against the same full-SH step with every kernel of the step
     swapped for its plain version on the card;
  6b. banded: the 1M sh3 scene at DCI 8K (8192x4320, 69,120 tiles, over
     the 16-bit tile-key limit: 2 bands) through Viewer.render and through
     render_banded in both modes, run in sync debug mode "error" (every
     counter reset just before; expand and the forward raster launched
     once per band and frame), with frame times, entries per band and peak
     memory; the heaviest band's expand and forward kernels against their
     plain versions; and render_banded with 2 and 3 bands against render
     at 1920x1080, within RAST_ATOL outside threshold ties;
  6c. dp: make_mesh() with no launcher (a 1-rank NCCL group), 3
     dp_train_steps of 2 views at 1M sh3 / 1920x1080 through all five
     training kernels (counters reset just before), one step's
     synchronizing calls by line (none from parallel/sharding.py), one
     step against the single-device composition at rtol 2e-4 / atol 2e-6,
     and render_tile_sharded against render;
  6d. gs: on a 1-rank NCCL group, the band form of the tile-loss kernel at
     the 1M sh3 / 1920x1080 step's forward tiles split into 2, 3 and 4
     bands (each band against its plain version; the bands, garbage halos
     at the frame's borders, reassembling the full-frame kernel's dpix bit
     for bit; each band launch timed queued beside its bound);
     render_gaussian_sharded against render with the f32 exchange and at
     the reference test's f16 class with the f16 one (ms per frame); 3
     gs_train_steps through all five training kernels (counters reset
     just before), ms per step, peak memory, one step's synchronizing
     calls by line (none) and the adaptive-capacity metrics; one f32 step
     against train_step (rtol 2e-4 / atol 2e-6) and twice from one state
     (bit-identical), the f16 step's loss within rtol 2e-3; one step on a
     1x1 dp x band mesh;
  7. server: a view-mode ViewerServer on 127.0.0.1 answers 3 JPEG frames,
     a control post and /stats over HTTP;
  8. the entry point: ``python -m webdgs_tpu_torch train --no-densify`` on
     a synthetic COLMAP dataset (scripts/make_synthetic_colmap.py) exits 0
     with a checkpoint, a PLY and finite losses;
  9. densify at realistic size: a Trainer over the 1M sh3 scene with 10
     synthetic 1920x1080 views runs two densify events (every counter reset
     just before and the importance and segment-sum counters must grow;
     clone, split and prune each > 0; capacity growth; finite parameters;
     the synchronizing calls of each event counted, none of them from the
     segment sum, the raster wrappers or the importance counts), the
     forward kernel matches and
     the importance, expand and tile-cull kernels equal their plain
     versions on every slot of one 960x540 metric view of the post-event
     state (the heuristic capacity) and the
     one-row segment sum of its counts matches its plain version there,
     and a small event on the card matches the same event on the CPU;
  9b. gs-train: on a 1-rank NCCL group, a GsTrainer and a Trainer of the
     same seed over the same scene, views and config, 5 steps with events
     at iterations 2 and 4: parameters, moments, alive masks, losses and
     event counts bit-identical; ms, waits by line and launches per step
     and per event (none of the event's waits from parallel/sharding.py
     or the kernel wrappers, one from parallel/gs_trainer.py), peak
     memory;
 10. ``train`` with densification and ``export`` on the synthetic dataset:
     exit 0, logged point counts that change, a PLY that loads;
 10b. ``python -m torch.distributed.run --nproc_per_node=1 -m
     webdgs_tpu_torch train --shard dp``, then ``--shard gs``, with
     densification on the same dataset: exit 0, a checkpoint and a PLY of
     the logged point count, finite losses, and every kernel launched in
     that process (its report's counts, from 0);
 11. a live-training server over HTTP: /stats shows the iteration advancing,
     /loss.jpg returns a JPEG, and an upload of the dataset sets it;
 12. bench: ``python -m webdgs_tpu_torch bench`` at bench.py's recipe and
     on phase 8's checkpoint (``WEBDGS_BENCH_CHECKPOINT``): exit 0, each
     JSON line printed, finite positive rates, the metric names, and the
     launches of its timed 20 steps and 20 frames (20 per training kernel,
     40 for expand and the forward raster);
 13. validate: scripts/validate_training_torch.py, 600 iterations at
     200x152 with densify events at 300 and 400: exit 0 and the held-out
     PSNR risen.
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
# a threshold tie: a pixel whose last contributor differs between two
# correct forwards stopped, in the one that stopped first, at a
# transmittance this close (relative) to t_threshold
TIE_RTOL = 1e-5
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


def queued_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` with the launch queue filled first: the
    card sleeps while the host enqueues all ``iters`` runs, so a wrapper
    whose host time exceeds its device time is not timed by the host."""
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's clock
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


# each training kernel's CUDA entry and its plain version, by module of
# webdgs_tpu_torch.ops: swapped in (plain_kernels), a step runs its plain
# versions on the card (the raster ones on the packed rows of the entries
# the CUDA entries take)
PLAIN_ROUTES = (("rasterize", "_rasterize_tiles_cuda", "rasterize_tiles_plain"),
                ("rasterize", "_rasterize_tiles_backward_cuda",
                 "rasterize_tiles_backward_plain"),
                ("tile_loss", "_tile_loss_cuda", "tile_loss_gradient_plain"),
                ("segsum", "_segment_sum_rows_cuda", "segment_sum_rows_plain"),
                ("expand", "_expand_fields_cuda", "expand_fields_plain"),
                ("binning", "_cull_words_cuda", "cull_words_plain"),
                ("binning", "_entry_keys_cuda", "entry_keys_plain"),
                ("adam", "_adam_step_cuda", "adam_step_plain"))


class plain_kernels:
    """Within the block every kernel of PLAIN_ROUTES runs its plain
    version, on the tensors' own device."""

    def __enter__(self):
        import importlib
        self.saved = []
        for mod_name, entry, plain in PLAIN_ROUTES:
            mod = importlib.import_module(f"webdgs_tpu_torch.ops.{mod_name}")
            self.saved.append((mod, entry, getattr(mod, entry)))
            fn = getattr(mod, plain)
            if mod_name == "rasterize":
                def fn(entries, *args, fn=fn, mod=mod):
                    return fn(mod.packed_rows(entries), *args)
            setattr(mod, entry, fn)
        return self

    def __exit__(self, *exc):
        for mod, entry, fn in self.saved:
            setattr(mod, entry, fn)
        return False


def full_sh_step_check(scene, cam, target, w: int, h: int, settings,
                       cap: int) -> dict:
    """[realistic]: one train_step training every SH coefficient (the SH
    stage's VJP, the rest bands at ``sh_rest_lr_scale``) beside the DC
    step, from one state on one view at one capacity, each timed after a
    warm-up; and the full-SH step again with every kernel swapped for its
    plain version on the card.  Its first moments (0.1 g) must agree with
    the kernels' at the small step's bound, and only the full-SH step may
    move the rest bands' lanes (14:59 of the packed rows)."""
    import torch
    from webdgs_tpu_torch.ops.adam import AdamHyperparameters, init_adam_state
    from webdgs_tpu_torch.train.step import train_step

    opt0 = init_adam_state(scene.params())
    kw = dict(img_w=w, img_h=h, settings=settings, entry_capacity=cap)
    res, ms = {}, {}
    for label, full in (("dc", False), ("full_sh", True)):
        hp = AdamHyperparameters(full_sh=full)
        train_step(scene, opt0, cam, target, hp=hp, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[label] = train_step(scene, opt0, cam, target, hp=hp, **kw)
        torch.cuda.synchronize()
        ms[label] = 1e3 * (time.perf_counter() - t0)
    with plain_kernels():
        plain = train_step(scene, opt0, cam, target,
                           hp=AdamHyperparameters(full_sh=True), **kw)
    m_full, m_dc = res["full_sh"].opt_state.m, res["dc"].opt_state.m
    err = max_rel(m_full * 10.0, plain.opt_state.m * 10.0)
    loss_rel = abs(float(res["full_sh"].metrics["loss"])
                   - float(plain.metrics["loss"])) \
        / abs(float(plain.metrics["loss"]))
    rest = float(m_full[:, 14:].abs().max())
    check(rest > 0 and not bool(m_dc[:, 14:].any()),
          f"full SH left the rest bands' moments at 0 ({rest}), or DC "
          "moved them")
    check(bool(torch.isfinite(m_full).all()), "full-SH moments not finite")
    check(err <= 1e-3 and loss_rel <= 1e-4,
          f"full-SH step, kernels vs plain versions: gradient {err}, loss "
          f"rel {loss_rel}")
    print(f"[realistic] 1M sh3 {w}x{h}, one train_step from one state: DC "
          f"{ms['dc']:.2f} ms, full SH {ms['full_sh']:.2f} ms; full SH "
          f"with the kernels vs their plain versions on the card: gradient "
          f"scaled err {err:.2e}, loss rel err {loss_rel:.2e}; largest "
          f"rest-band |m| {rest:.3e} (DC: 0)", flush=True)
    return {"dc_ms": ms["dc"], "full_sh_ms": ms["full_sh"], "err": err}


def max_rel(a, b) -> float:
    """max |a - b| / max(max|b|, 1): the scale-normalised error."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)


# (wrapper, kernel name in the JSON line)
KERNEL_COUNTERS = (("expand_fields", "expand_fields"),
                   ("rasterize_tiles", "rasterize_tiles"),
                   ("tile_loss_tiles", "tile_loss"),
                   ("rasterize_tiles_backward", "rasterize_tiles_backward"),
                   ("segment_sum_rows", "segment_sum_rows"),
                   ("entry_counts", "entry_counts"),
                   ("cull_words", "cull_words"),
                   ("entry_keys", "entry_keys"),
                   ("adam_step", "adam_step"))
# the kernels each path must launch: a viewer frame, a training step (the
# densify run, steps and events, launches all nine)
VIEWER_KERNELS = ("expand_fields", "rasterize_tiles", "cull_words",
                  "entry_keys")
TRAIN_KERNELS = VIEWER_KERNELS + ("tile_loss", "rasterize_tiles_backward",
                                  "segment_sum_rows", "adam_step")


def kernel_counters() -> dict:
    """The launch counter of every kernel wrapper, by kernel name."""
    from webdgs_tpu_torch.ops import kernel_launches
    counts = kernel_launches()
    return {name: counts[fn] for fn, name in KERNEL_COUNTERS}


def launches_since(mark: dict) -> dict:
    """Each kernel's launches since ``mark``, a :func:`kernel_counters`."""
    return {k: v - mark[k] for k, v in kernel_counters().items()}


def metric_view_inputs(scene, cam, target, mw: int, mh: int,
                       threshold: float, settings):
    """The importance kernel's inputs for one metric view, built as
    ``view_importance_counts`` builds them, the entries packed: (attrs16,
    tile_offsets, pix_tiles, ntx, nty), the view's valid entry count, its
    binning (whose payloads the one-row segment sum takes) and its
    projected attributes."""
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
            int(bins.total_entries), bins, attrs)


def importance_check(label: str, margs, n_valid: int, plain_iters: int,
                     host_bound: bool = False) -> dict:
    """The importance kernel against ``entry_counts_plain`` on one metric
    view's inputs: every slot equal, two runs bit-identical, and the
    public wrapper run in sync debug mode "error".  Times the kernel back
    to back (in turns with its plain version) and queued, and returns
    both times, the bound from these inputs, the launch shape and the
    view's load.  With BEFORE["imp"], the earlier kernel too, in turns with
    this one, back to back and queued: every slot equal and this one
    faster in every pairing (queued only, where ``host_bound``).  Each
    copy in IMP_ABLATIONS is timed."""
    import ctypes
    import torch
    from webdgs_tpu_torch import _build
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
    # the wrapper never waits for the device: in sync debug mode "error" a
    # synchronizing call raises
    torch.cuda.set_sync_debug_mode("error")
    try:
        ik3 = importance.entry_counts(*margs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(torch.equal(ik3, ik), f"importance kernel ({label}) differs in "
          "sync debug mode")

    def kernel():
        return importance._entry_counts_cuda(*margs)
    k_ms, p_ms = time_pair(
        kernel, lambda: importance.entry_counts_plain(*margs), 50,
        plain_iters)
    dev_ms = queued_ms(kernel, 50)
    shape = (ctypes.c_int * 5)()
    _build.check(_build.library().webdgs_importance_occupancy(
        settings.tile_w, settings.tile_h, shape),
        "webdgs_importance_occupancy")
    launch = dict(zip(IMP_LAUNCH_KEYS, shape))
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
    res = {"ms": k_ms, "plain_ms": p_ms, "device_ms": dev_ms, "bound": bound,
           "err": float((ik - ip).abs().max()), "sum": p_sum,
           "slots": ip.shape[0], "valid": n_valid,
           "nonzero": int((ip > 0).sum()), "flagged": int(flag.sum()),
           "pixels": int(flag.numel()), "live_tiles": int(flag.any(1).sum()),
           "tiles": n_tiles, "needed": needed, "pairs": pairs,
           "launch": launch}
    print(f"[kernels] entry_counts (importance) {label}: {n_valid} valid "
          f"entries of {res['slots']} slots, {res['flagged']} of "
          f"{res['pixels']} pixels flagged, {res['live_tiles']}/{n_tiles} "
          f"live tiles, {needed} entries read, {pairs} (flagged pixel, "
          f"entry) pairs; launch {launch}; all slots equal to the plain "
          f"version ({res['nonzero']} non-zero, sum {p_sum:.0f}); "
          f"bit-identical repeat; sync debug mode \"error\" passed; kernel "
          f"{k_ms:.4f} ms, queued {dev_ms:.4f} ms, plain {p_ms:.4f} ms; "
          f"bound {bound[0]:.4f} ms ({bound[1]})", flush=True)
    if "imp" in BEFORE:
        def before():
            return BEFORE["imp"](*margs)
        same = torch.equal(before(), ik)
        # in turns: new, before, new, before
        b2b = [cuda_ms(f, 50) for f in (kernel, before, kernel, before)]
        queued = [queued_ms(f, 50) for f in (kernel, before, kernel,
                                             before)]
        res["before"] = {"equal": same, "ms": b2b[1::2],
                         "device_ms": queued[1::2], "new_ms": b2b[0::2],
                         "new_device_ms": queued[0::2]}
        print(f"[kernels] entry_counts {label}, the earlier kernel on the "
              f"same inputs: every slot equal {same}; back to back "
              f"{b2b[1]:.4f} / {b2b[3]:.4f} ms (this one {b2b[0]:.4f} / "
              f"{b2b[2]:.4f}); queued {queued[1]:.4f} / {queued[3]:.4f} ms "
              f"(this one {queued[0]:.4f} / {queued[2]:.4f})", flush=True)
        check(same, f"entry_counts ({label}) differs from the earlier "
              "kernel")
        # where the wrapper's host time exceeds the kernel's device time
        # (the light bench view), back to back times the host: there only
        # the queued pairings compare the kernels
        check(max(queued[0::2]) < min(queued[1::2]) and
              (host_bound or max(b2b[0::2]) < min(b2b[1::2])),
              f"entry_counts ({label}) is not faster than the earlier "
              f"kernel: {res['before']}")
    for name, (variant, regs) in IMP_ABLATIONS.items():
        def run_variant(variant=variant):
            return variant(*margs)
        same = torch.equal(run_variant(), ik)
        v_ms = cuda_ms(run_variant, 50)
        v_dev = queued_ms(run_variant, 50)
        shape_v = variant.occupancy(settings)
        print(f"[kernels] entry_counts {label}, variant {name} (a timing "
              f"probe): {regs} registers, launch {shape_v}; every slot "
              f"equal {same}; {v_ms:.4f} ms, queued {v_dev:.4f} ms",
              flush=True)
    return res


def build_before_segsum(path: str):
    """An earlier ``segsum.cu`` -- the one-pass gather kernel of commit
    8c7f768, C interface ``webdgs_segsum(rows, n_rows, row_stride, slots,
    valid, starts, n, out, stream)`` with slots the inverse sort
    permutation -- built with the port's nvcc flags into the build
    directory.  Returns a function of (rows_cm, counts, inverse
    permutation, valid) that runs it as that commit's wrapper did."""
    import ctypes
    import torch
    from webdgs_tpu_torch import _build
    so, _ = _build.build_one(path, "segsum_before")
    lib = ctypes.CDLL(str(so))
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    lib.webdgs_segsum.argtypes = (p_, i_, ctypes.c_longlong, p_, p_, p_, i_,
                                  p_, p_)
    lib.webdgs_segsum.restype = i_

    def run(rows_cm, counts, inv, valid):
        c, e_len = rows_cm.shape
        n = counts.shape[0]
        starts = torch.cat([
            torch.zeros((1,), dtype=torch.int64, device=rows_cm.device),
            torch.cumsum(counts.to(torch.int64), 0)]).to(torch.int32)
        out = torch.empty((n, c), dtype=torch.float32, device=rows_cm.device)
        err = lib.webdgs_segsum(
            rows_cm.data_ptr(), c, e_len, inv.data_ptr(), valid.data_ptr(),
            starts.data_ptr(), n, out.data_ptr(),
            torch.cuda.current_stream(rows_cm.device).cuda_stream)
        check(err == 0, f"the earlier segment-sum kernel: CUDA error {err}")
        return out
    return run


# set by --before-segsum: the earlier kernel segsum_check compares with
BEFORE_SEGSUM = None


def load_bwd(so_path):
    """A library holding ``webdgs_rasterize_bwd``, loaded on its own: this
    checkout's C interface where the library exports
    ``webdgs_rasterize_bwd_occupancy``, else that of commits 0779f1e to
    3554122 (no tile order).  Returns a function of (attrs16,
    tile_offsets, gpix5, ntx, nty, settings) that runs it as the port's
    wrapper does, on a zeroed (16, E) output.  Its ``ctas_per_sm`` is a
    function of the settings with this checkout's interface, else None."""
    import ctypes
    import torch
    from webdgs_tpu_torch import _build
    lib = ctypes.CDLL(str(so_path))
    current = hasattr(lib, "webdgs_rasterize_bwd_occupancy")
    fn = lib.webdgs_rasterize_bwd
    argtypes = _build.SIGNATURES["webdgs_rasterize_bwd"]
    fn.argtypes = argtypes if current else argtypes[:-2] + argtypes[-1:]
    fn.restype = ctypes.c_int

    def run(attrs16, toff, gpix5, ntx, nty, settings):
        d = torch.zeros_like(attrs16)
        args = [attrs16.data_ptr(), attrs16.shape[1], toff.data_ptr(),
                gpix5.data_ptr(), ntx * nty, ntx, settings.tile_w,
                settings.tile_h, settings.chunk, settings.alpha_min,
                settings.alpha_max, settings.t_threshold,
                math.log(settings.t_threshold), d.data_ptr()]
        if current:
            args.append(torch.empty((ntx * nty,), dtype=torch.int32,
                                    device=attrs16.device).data_ptr())
        err = fn(*args, torch.cuda.current_stream(attrs16.device).cuda_stream)
        check(err == 0, f"{so_path}: CUDA error {err} at launch")
        return d

    def ctas_per_sm(settings) -> int:
        out = (ctypes.c_int * 5)()
        occ = lib.webdgs_rasterize_bwd_occupancy
        occ.argtypes = _build.SIGNATURES["webdgs_rasterize_bwd_occupancy"]
        check(occ(settings.tile_w, settings.tile_h, settings.chunk, out) == 0,
              f"{so_path}: occupancy query")
        return out[2]
    run.ctas_per_sm = ctas_per_sm if current else None
    return run


def load_fwd(so_path):
    """A library holding ``webdgs_rasterize_fwd``, loaded on its own: this
    checkout's C interface where the library exports
    ``webdgs_rasterize_fwd_occupancy``, else that of commits 6e479fc to
    217963e (no tile order).  Returns a function of (attrs16, tile_offsets,
    ntx, nty, settings) that runs it as the port's wrapper does, n_contrib
    tracked.  Its ``ctas_per_sm`` is a function of the settings with this
    checkout's interface, else None."""
    import ctypes
    import torch
    from webdgs_tpu_torch import _build
    lib = ctypes.CDLL(str(so_path))
    current = hasattr(lib, "webdgs_rasterize_fwd_occupancy")
    fn = lib.webdgs_rasterize_fwd
    argtypes = _build.SIGNATURES["webdgs_rasterize_fwd"]
    fn.argtypes = argtypes if current else argtypes[:-2] + argtypes[-1:]
    fn.restype = ctypes.c_int

    def run(attrs16, toff, ntx, nty, settings):
        out = torch.empty((ntx * nty, 8, settings.tile_px),
                          dtype=torch.float32, device=attrs16.device)
        args = [attrs16.data_ptr(), attrs16.shape[1], toff.data_ptr(),
                ntx * nty, ntx, settings.tile_w, settings.tile_h,
                settings.chunk, settings.alpha_min, settings.alpha_max,
                settings.t_threshold, math.log(settings.t_threshold), 1,
                out.data_ptr()]
        order = torch.empty((ntx * nty,), dtype=torch.int32,
                            device=attrs16.device)
        if current:
            args.append(order.data_ptr())
        err = fn(*args, torch.cuda.current_stream(attrs16.device).cuda_stream)
        check(err == 0, f"{so_path}: CUDA error {err} at launch")
        return out

    def ctas_per_sm(settings) -> int:
        out = (ctypes.c_int * 4)()
        occ = lib.webdgs_rasterize_fwd_occupancy
        occ.argtypes = _build.SIGNATURES["webdgs_rasterize_fwd_occupancy"]
        check(occ(settings.tile_w, settings.tile_h, settings.chunk, out) == 0,
              f"{so_path}: occupancy query")
        return out[2]
    run.ctas_per_sm = ctas_per_sm if current else None
    return run


# webdgs_importance_occupancy's five numbers
IMP_LAUNCH_KEYS = ("threads", "smem_bytes", "ctas_per_sm", "registers",
                   "ctas_per_tile")


def load_imp(so_path):
    """A library holding ``webdgs_importance``, loaded on its own: this
    checkout's C interface where the library exports
    ``webdgs_importance_occupancy``, else that of commits 8c7f768 to
    2efee97 (with a chunk).  Returns a function of (attrs16,
    tile_offsets, pix_tiles, ntx, nty, settings) that runs it as the
    port's wrapper does, on a zeroed (E,) output.  Its ``occupancy`` gives
    the launch shape for the settings with this checkout's interface, else
    None."""
    import ctypes
    import torch
    from webdgs_tpu_torch import _build
    lib = ctypes.CDLL(str(so_path))
    current = hasattr(lib, "webdgs_importance_occupancy")
    fn = lib.webdgs_importance
    p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = _build.SIGNATURES["webdgs_importance"] if current else (
        p_, i_, p_, p_, i_, i_, i_, i_, i_, f_, f_, p_, p_)
    fn.restype = ctypes.c_int

    def run(attrs16, toff, pix_tiles, ntx, nty, settings):
        out = torch.zeros((attrs16.shape[1],), dtype=torch.float32,
                          device=attrs16.device)
        args = [attrs16.data_ptr(), attrs16.shape[1], toff.data_ptr(),
                pix_tiles.data_ptr(), ntx * nty, ntx, settings.tile_w,
                settings.tile_h]
        if not current:
            args.append(settings.chunk)
        args += [settings.alpha_min, settings.alpha_max, out.data_ptr()]
        err = fn(*args, torch.cuda.current_stream(attrs16.device).cuda_stream)
        check(err == 0, f"{so_path}: CUDA error {err} at launch")
        return out

    def occupancy(settings) -> dict:
        out = (ctypes.c_int * 5)()
        occ = lib.webdgs_importance_occupancy
        occ.argtypes = _build.SIGNATURES["webdgs_importance_occupancy"]
        check(occ(settings.tile_w, settings.tile_h, out) == 0,
              f"{so_path}: occupancy query")
        return dict(zip(IMP_LAUNCH_KEYS, out))
    run.occupancy = occupancy if current else None
    return run


def expand_runner(lib, what: str):
    """``webdgs_expand_fields`` of a loaded library (one C interface since
    the first commit).  Returns a function of (words, counts, e_cap) that
    runs it as the port's wrapper does (the count cumsum, the outputs, the
    launch); its ``launch`` is the bare launch on a given cumsum and
    outputs."""
    import ctypes
    import torch
    from webdgs_tpu_torch import _build
    fn = lib.webdgs_expand_fields
    fn.argtypes = _build.SIGNATURES["webdgs_expand_fields"]
    fn.restype = ctypes.c_int

    def launch(words, cum, e_cap, out_words, out_ids):
        err = fn(words.data_ptr(), cum.data_ptr(), words.shape[1], e_cap,
                 out_words.data_ptr(), out_ids.data_ptr(),
                 torch.cuda.current_stream(words.device).cuda_stream)
        check(err == 0, f"{what}: CUDA error {err} at launch")

    def run(words, counts, e_cap):
        out_words = torch.empty((words.shape[0], e_cap), dtype=torch.int32,
                                device=words.device)
        out_ids = torch.empty((e_cap,), dtype=torch.int32,
                              device=words.device)
        launch(words, torch.cumsum(counts, 0, dtype=torch.int32), e_cap,
               out_words, out_ids)
        return out_words, out_ids
    run.launch = launch
    return run


def load_expand(so_path):
    """A library holding ``webdgs_expand_fields``, loaded on its own: see
    expand_runner."""
    import ctypes
    return expand_runner(ctypes.CDLL(str(so_path)), str(so_path))


def loss_runner(lib, what: str):
    """``webdgs_tile_loss`` of a loaded library (one C interface since the
    first commit).  Returns a function of (out, target, img_w, img_h, ntx,
    nty, cfg, settings) that runs it as the port's wrapper does: (dpix,
    per-tile sums)."""
    import ctypes
    import torch
    from webdgs_tpu_torch import _build
    fn = lib.webdgs_tile_loss
    fn.argtypes = _build.SIGNATURES["webdgs_tile_loss"]
    fn.restype = ctypes.c_int

    def run(out, target, img_w, img_h, ntx, nty, cfg, settings):
        dpix = torch.empty_like(out)
        sums = torch.empty((ntx * nty, 4), dtype=torch.float32,
                           device=out.device)
        bg = settings.background
        err = fn(out.data_ptr(), target.data_ptr(), ntx * nty, ntx,
                 settings.tile_w, settings.tile_h, img_w, img_h,
                 cfg.lambda_l1, cfg.lambda_l2, cfg.lambda_dssim, cfg.c1,
                 cfg.c2, bg[0], bg[1], bg[2], dpix.data_ptr(),
                 sums.data_ptr(),
                 torch.cuda.current_stream(out.device).cuda_stream)
        check(err == 0, f"{what}: CUDA error {err} at launch")
        return dpix, sums
    return run


def load_loss(so_path):
    """A library holding ``webdgs_tile_loss``, loaded on its own: see
    loss_runner."""
    import ctypes
    return loss_runner(ctypes.CDLL(str(so_path)), str(so_path))


# --ablate-imp:copies of the importance kernel's source with one part
# changed, as BWD_VARIANTS below (timing probes that keep the function, so
# each is also compared with the kernel on every slot).  Of this
# checkout's csrc/importance.cu:
IMP_VARIANTS = {
    "no_pixel_order": (("constexpr bool kOrderPixels = true;",
                        "constexpr bool kOrderPixels = false;"),),
    "box_after_expf": ((
        "if (!(fabsf(dx) <= ex && fabsf(dy) <= ey)) continue;  // box first",
        ""),),
    "split_1": (("constexpr int kSplit = 8;", "constexpr int kSplit = 1;"),),
    "split_4": (("constexpr int kSplit = 8;", "constexpr int kSplit = 4;"),),
    "split_16": (("constexpr int kSplit = 8;",
                  "constexpr int kSplit = 16;"),),
    "threads_128": (("constexpr int kThreads = 256;",
                     "constexpr int kThreads = 128;"),),
    "threads_512": (("constexpr int kThreads = 256;",
                     "constexpr int kThreads = 512;"),),
    # at most 32 registers: 8 CTAs per SM instead of 6
    "min_ctas_8": (("__launch_bounds__(kThreads)",
                    "__launch_bounds__(kThreads, 8)"),),
}


# --ablate-fwd: copies of the forward kernel's source with one part
# changed, as BWD_VARIANTS below (timing probes; every copy keeps the
# function, so each is also compared with the kernel bit for bit).  Of
# this checkout's csrc/rasterize_fwd.cu:
FWD_VARIANTS = {
    "no_box_skip": ((
        "if (!(fabsf(dx) <= c89ab.y && fabsf(dy) <= c89ab.z)) continue;",
        ""),),
    "index_order": (("const int t = order[blockIdx.x];",
                     "const int t = blockIdx.x;"),),
    # wait for the next chunk's copies too before computing this one: no
    # overlap of copy and compute
    "no_double_buffer": (("cp_async_wait<1>();", "cp_async_wait<0>();"),),
    "pixels_2": (("constexpr int kR = 4;", "constexpr int kR = 2;"),),
    "pixels_1": (("constexpr int kR = 4;", "constexpr int kR = 1;"),),
    "rows_of_32": (
        ("const bool blocked = tile_w % 8 == 0 && tile_h % 4 == 0;",
         "const bool blocked = false;"),),
}


# --ablate-bwd: copies of a backward kernel's source with one part changed
# by text substitution, built beside it and timed on its inputs.  Each is a
# timing probe, not the function: the time a copy saves is the share of
# the part it takes out.  name -> ((text, replacement), ...); every text
# must occur in the source.  Of this checkout's csrc/rasterize_bwd.cu:
BWD_VARIANTS = {
    "rows_of_32": (
        ("const bool blocked = tile_w % 8 == 0 && tile_h % 4 == 0;",
         "const bool blocked = false;"),),
    "batch_2": (("constexpr int kB = 4;", "constexpr int kB = 2;"),),
    "batch_8": (("constexpr int kB = 4;", "constexpr int kB = 8;"),),
    "pixels_2": (("constexpr int kR = 4;", "constexpr int kR = 2;"),),
    "index_order": (("const int t = order[blockIdx.x];",
                     "const int t = blockIdx.x;"),),
    "no_butterfly": (
        ("if (__any_sync(kFull, live_any)) warp_sum_batch(v, lane);", ""),),
    "no_crosswarp": (("for (int w = 1; w < nwarps; ++w) {",
                      "for (int w = 1; w < 1; ++w) {"),),
    "no_box_skip": ((
        "if (!(fabsf(dx) <= c89ab.y && fabsf(dy) <= c89ab.z)) continue;",
        ""),),
    "fast_transmittance": (("log_t_un[r] += log1pf(-alpha);",
                            "log_t_un[r] += __logf(1.f - alpha);"),
                           ("t_cur[r] = expf(log_t_un[r]);",
                            "t_cur[r] = __expf(log_t_un[r]);")),
}
# of commit 3554122's (the thread-per-pixel kernel), given as --before-bwd
BEFORE_BWD_VARIANTS = {
    "no_shuffles": (
        ("v[k] += __shfl_down_sync(0xffffffffu, v[k], off);", ""),),
    "no_crosswarp": (("for (int w = 1; w < nwarps; ++w) {",
                      "for (int w = 1; w < 1; ++w) {"),),
    "fast_division": (("(suffix - cum_u) / (1.f - alpha)",
                       "__fdividef(suffix - cum_u, 1.f - alpha)"),),
    "fast_transmittance": (("log_t_un += log1pf(-alpha);",
                            "log_t_un += __logf(1.f - alpha);"),
                           ("t_cur = expf(log_t_un);",
                            "t_cur = __expf(log_t_un);")),
}


# --ablate-expand: copies of the expand kernel's source with one part
# changed, as BWD_VARIANTS below (timing probes that keep the function, so
# each is also compared with the kernel on every slot).  Of this
# checkout's csrc/expand.cu:
EXPAND_VARIANTS = {
    # every span searches the cumsum in global memory, none is staged
    "no_window": (("if (last < kWindow) {", "if (false) {"),),
    # each new owner by bisection instead of probing the next Gaussians
    "bisect": (("if (win[j] <= e + v) j = next_above(win, j, last, e + v);",
                "if (win[j] <= e + v) j = first_above(win, j + 1, last, "
                "e + v);"),),
    "scalar_stores": (("if (aligned && n_in >= kVec) {", "if (false) {"),),
    # the registers the compiler picks (44): 5 CTAs per SM
    "ctas_any": (("constexpr int kCtasPerSm = 8;",
                  "constexpr int kCtasPerSm = 1;"),),
}
# --ablate-loss: the same for the tile-loss kernel, of csrc/tile_loss.cu
LOSS_VARIANTS = {
    "rows_2": (("constexpr int kRows = 4;", "constexpr int kRows = 2;"),),
    # each staged element's loads waited for before the next element's
    "stage_1": (("constexpr int kStage = 4;", "constexpr int kStage = 1;"),),
    # the registers the compiler picks, and at most 64
    "regs_any": (("constexpr int kMinCtas = 3;",
                  "constexpr int kMinCtas = 1;"),),
    "regs_64": (("constexpr int kMinCtas = 3;",
                 "constexpr int kMinCtas = 4;"),),
}


# the kernels that build_variants builds copies of: kind -> (stem of the
# built file, loader)
VARIANT_KINDS = {"fwd": ("rasterize_fwd", load_fwd),
                 "bwd": ("rasterize_bwd", load_bwd),
                 "imp": ("importance", load_imp),
                 "expand": ("expand", load_expand),
                 "loss": ("tile_loss", load_loss)}


def build_variants(jobs) -> dict:
    """Build kernels beside the library, every nvcc call started at once.
    ``jobs``: (kind, name, source, ((text, replacement), ...)), kind a key
    of VARIANT_KINDS; a source with substitutions is written with them
    into the build directory first.  Returns (kind, name) -> (the function
    the kind's loader gives, registers per thread of its kernels'
    largest)."""
    import concurrent.futures
    from pathlib import Path
    from webdgs_tpu_torch import _build
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for kind, name, src, subs in jobs:
        key, stem = (kind, name), VARIANT_KINDS[kind][0]
        paths[key] = Path(src)
        if subs:
            body = paths[key].read_text()
            for old, new in subs:
                check(old in body, f"variant {name}: {old!r} is not in {src}")
                body = body.replace(old, new)
            paths[key] = out_dir / f"{stem}_{name}.cu"
            paths[key].write_text(body)
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        built = dict(zip(paths, pool.map(
            lambda k: _build.build_one(
                paths[k], f"{VARIANT_KINDS[k[0]][0]}_{k[1]}"), paths)))
    return {key: (VARIANT_KINDS[key[0]][1](so), max(
        int(r) for r in re.findall(r"Used (\d+) registers", log)))
        for key, (so, log) in built.items()}


# set by --before-bwd, --before-fwd, --before-imp, --before-expand and
# --before-loss: kind -> an earlier kernel of that kind (as its loader
# gives it), timed beside the current one
BEFORE: dict = {}
# set by --ablate-bwd: name -> (variant, its registers), timed beside it
BWD_ABLATIONS: dict = {}
# set by --ablate-fwd, --ablate-imp, --ablate-expand and --ablate-loss:
# the same for the forward, importance, expand and tile-loss kernels
FWD_ABLATIONS: dict = {}
IMP_ABLATIONS: dict = {}
EXPAND_ABLATIONS: dict = {}
LOSS_ABLATIONS: dict = {}


def forward_check(label: str, attrs16, tile_offsets, ntx: int, nty: int,
                  settings, iters: int, plain_iters: int,
                  ablate: bool = False, ties: bool = False) -> dict:
    """The forward kernel against ``rasterize_tiles_plain`` on one frame's
    inputs: rgb, acc and T within RAST_ATOL, n_contrib mismatch within
    NC_MISMATCH, two runs bit-identical.  With ``ties``, a pixel may exceed
    RAST_ATOL only where the two stop at different last contributors at a
    threshold tie (TIE_RTOL): the kernel sums log T entry by entry, the
    plain version by chunk prefix sums, and at millions of pixels a few
    transmittances land within rounding of t_threshold, where the two
    orders decide differently.  Times the kernel back to back
    (in turns with its plain version) and with the launch queue filled
    first, and gives the bound from the pairs these inputs make it
    evaluate, the tiles' work and the launch shape.  With BEFORE["fwd"], the
    earlier kernel too, on the same inputs, in turns with this one: all 8
    channels must be bit-identical and this one faster in every pairing.
    With ``ablate``, each copy in FWD_ABLATIONS, timed."""
    import ctypes
    import torch
    from webdgs_tpu_torch import _build
    from webdgs_tpu_torch.ops import rasterize
    args = (attrs16, tile_offsets, ntx, nty, settings)
    rk = rasterize.rasterize_tiles(*args)
    rk2 = rasterize.rasterize_tiles(*args)
    rp = rasterize.rasterize_tiles_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(rk, rk2), f"rasterize_tiles ({label}) is not "
          "bit-identical")
    diff = (rk[:, 0:5] - rp[:, 0:5]).abs().amax(dim=1)  # (T, P)
    flip = rk[:, 5] != rp[:, 5]
    err = float(diff.max())
    nc_mis = float(flip.float().mean())
    over = diff > RAST_ATOL
    # where they stop at different contributors, the transmittance of the
    # one that stopped first
    t_first = torch.where(rk[:, 5] < rp[:, 5], rk[:, 4], rp[:, 4])
    tie = flip & ((t_first - settings.t_threshold).abs()
                  <= TIE_RTOL * settings.t_threshold)
    n_over, n_ties = int(over.sum()), int((over & tie).sum())
    err_rest = float(diff[~(over & tie)].max())
    check(err <= RAST_ATOL or (ties and err_rest <= RAST_ATOL),
          f"rasterize_tiles ({label}) max abs err {err}: {n_over} pixels "
          f"over {RAST_ATOL}, {n_ties} of them threshold ties; the largest "
          f"error elsewhere {err_rest}")
    check(nc_mis <= NC_MISMATCH,
          f"rasterize_tiles ({label}) n_contrib mismatch {nc_mis}")
    check(float(rk[:, 3].max()) > 0.5 and not rk[:, 6:].any(),
          f"rasterize_tiles ({label}): empty frame or spare channels set")
    del rk2, rp

    def kernel():
        return rasterize._rasterize_tiles_cuda(*args, True)
    ms, plain_ms = time_pair(
        kernel, lambda: rasterize.rasterize_tiles_plain(*args), iters,
        plain_iters)
    dev_ms = queued_ms(kernel, iters)
    pairs = evaluated_pairs(rk, tile_offsets, settings)
    e_len, n_tiles = attrs16.shape[1], ntx * nty
    # 11 attribute rows + offsets in, (T, 8, P) tiles out
    bound = bound_ms(4 * (11 * e_len + n_tiles + 1
                          + 8 * n_tiles * settings.tile_px),
                     FWD_OPS_PER_PAIR * pairs)
    shape = (ctypes.c_int * 4)()
    _build.check(_build.library().webdgs_rasterize_fwd_occupancy(
        settings.tile_w, settings.tile_h, settings.chunk, shape),
        "webdgs_rasterize_fwd_occupancy")
    launch = dict(zip(("threads", "smem_bytes", "ctas_per_sm",
                       "pixels_per_thread"), shape))
    work = tile_work(rk, tile_offsets, settings)
    res = {"err": err, "err_outside_ties": err_rest, "tie_pixels": n_ties,
           "nc_mismatch": nc_mis, "ms": ms, "plain_ms": plain_ms,
           "device_ms": dev_ms, "bound": bound, "pairs": pairs,
           "slots": e_len, "tiles": n_tiles, "launch": launch,
           "tile_work": work}
    print(f"[kernels] rasterize_tiles {label}: {e_len} slots, {n_tiles} "
          f"tiles (entries per tile max {work['count']['max']:.0f}, mean "
          f"{work['count']['mean']:.1f}, p99 {work['count']['p99']:.0f}; "
          f"visited before saturation max {work['visited']['max']:.0f}, "
          f"mean {work['visited']['mean']:.1f}, p99 "
          f"{work['visited']['p99']:.0f}), {pairs} (pixel, entry) pairs; "
          f"launch {launch}; max abs err {err:.3e}, {n_over} pixels over "
          f"{RAST_ATOL} ({n_ties} threshold ties), {err_rest:.3e} outside "
          f"them; n_contrib mismatch {nc_mis:.3e} (<= {NC_MISMATCH}); "
          f"bit-identical repeat; kernel {ms:.4f} ms, queued {dev_ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms; bound {bound[0]:.4f} ms "
          f"({bound[1]})", flush=True)
    if "fwd" in BEFORE:
        def before():
            return BEFORE["fwd"](*args)
        same = torch.equal(before(), rk)
        # in turns: new, before, new, before
        b2b = [cuda_ms(f, iters) for f in (kernel, before, kernel, before)]
        queued = [queued_ms(f, iters) for f in (kernel, before, kernel,
                                                before)]
        res["before"] = {"bit_identical": same, "ms": b2b[1::2],
                         "device_ms": queued[1::2], "new_ms": b2b[0::2],
                         "new_device_ms": queued[0::2]}
        print(f"[kernels] rasterize_tiles {label}, the earlier kernel on the "
              f"same inputs: all 8 channels bit-identical {same}; back to "
              f"back {b2b[1]:.4f} / {b2b[3]:.4f} ms (this one {b2b[0]:.4f} / "
              f"{b2b[2]:.4f}); queued {queued[1]:.4f} / {queued[3]:.4f} ms "
              f"(this one {queued[0]:.4f} / {queued[2]:.4f})", flush=True)
        check(same, f"rasterize_tiles ({label}) differs from the earlier "
              "kernel")
        check(max(b2b[0::2]) < min(b2b[1::2]) and
              max(queued[0::2]) < min(queued[1::2]),
              f"rasterize_tiles ({label}) is not faster than the earlier "
              f"kernel: {res['before']}")
    for name, (variant, regs) in (FWD_ABLATIONS.items() if ablate else ()):
        def run_variant(variant=variant):
            return variant(*args)
        same = torch.equal(run_variant(), rk)
        v_ms = cuda_ms(run_variant, iters)
        v_dev = queued_ms(run_variant, iters)
        ctas = variant.ctas_per_sm and variant.ctas_per_sm(settings)
        print(f"[kernels] rasterize_tiles {label}, variant {name} (a timing "
              f"probe): {regs} registers, {ctas} CTAs per SM; bit-identical "
              f"{same}; {v_ms:.4f} ms, queued {v_dev:.4f} ms", flush=True)
    return res


def indexed_check(label: str, attrs, bins, ntx: int, nty: int, settings,
                  iters: int, pix_tiles=None) -> dict:
    """The three kernels reading each entry through the binning's index
    (``rasterize.EntryAttrs``, the render's path) against the same kernels
    on the packed rows ``pack_entry_attrs`` builds from that index, every
    slot past the total holding index INT_MAX: the forward tiles (with and
    without n_contrib), the backward's (16, E) cotangents and the
    importance counts bit-identical; the autograd path's five fields'
    gradients equal to the segment sum of the packed cotangents, split;
    each indexed wrapper and the autograd path in sync debug mode "error".
    Times each kernel on the two inputs in turns (indexed, packed,
    indexed, packed), back to back and queued, and the pack itself
    queued.  ``bins`` carries the expansion payloads (with_source);
    ``pix_tiles`` is the importance kernel's (flag, n_contrib) input,
    else one from a fixed noise flag on the forward."""
    import torch
    from webdgs_tpu_torch.ops import importance, rasterize
    from webdgs_tpu_torch.ops.projection import SplatAttrs
    valid = bins.entry_valid
    gauss = torch.where(valid, bins.entry_gauss, 2 ** 31 - 1)
    attrs = SplatAttrs(*(a.detach() for a in attrs))
    entries = rasterize.EntryAttrs(attrs, gauss, valid, bins.entry_source,
                                   bins.gauss_counts)
    off = bins.tile_offsets
    with torch.no_grad():
        a16 = rasterize.pack_entry_attrs(attrs, gauss, valid)
        fi = rasterize.rasterize_tiles(entries, off, ntx, nty, settings)
        fp = rasterize.rasterize_tiles(a16, off, ntx, nty, settings)
        fi0 = rasterize.rasterize_tiles(entries, off, ntx, nty, settings,
                                        track_ncontrib=False)
        fp0 = rasterize.rasterize_tiles(a16, off, ntx, nty, settings,
                                        track_ncontrib=False)
    check(torch.equal(fi, fp) and torch.equal(fi0, fp0),
          f"indexed forward ({label}) differs from the packed rows'")
    check(float(fi[:, 3].max()) > 0.5, f"indexed forward ({label}): empty")
    gen = torch.Generator(device=fi.device).manual_seed(21)
    g = torch.randn(fi.shape, generator=gen, device=fi.device)
    suffix = (torch.sum(g[:, 0:4] * fi0[:, 0:4], dim=1, keepdim=True)
              + g[:, 4:5] * fi0[:, 4:5])
    gpix5 = torch.cat([g[:, 0:4], suffix], dim=1).contiguous()
    di = rasterize.rasterize_tiles_backward(entries, off, gpix5, ntx, nty,
                                            settings)
    dp = rasterize.rasterize_tiles_backward(a16, off, gpix5, ntx, nty,
                                            settings)
    check(torch.equal(di, dp) and float(dp[0:9].abs().max()) > 0,
          f"indexed backward ({label}) differs from the packed rows'")
    if pix_tiles is None:
        tiles = rasterize.tiles_to_image(fi, ntx, nty, ntx * settings.tile_w,
                                         nty * settings.tile_h, settings)
        noise = torch.rand(tiles.shape[:2], generator=gen, device=fi.device)
        pix = torch.stack([(noise > 0.7).to(torch.float32),
                           tiles[..., rasterize.OUT_NCONTRIB]], dim=-1)
        pix_tiles = rasterize.image_to_tiles(pix, ntx, nty,
                                             settings).contiguous()
    ci = importance.entry_counts(entries, off, pix_tiles, ntx, nty, settings)
    cp = importance.entry_counts(a16, off, pix_tiles, ntx, nty, settings)
    check(torch.equal(ci, cp) and float(cp.sum()) > 0,
          f"indexed importance counts ({label}) differ from the packed "
          "rows'")
    # the render's autograd path: no wait, the fields' gradients the
    # segment sum of the packed cotangents
    leaves = SplatAttrs(*(a.clone().requires_grad_(True) for a in attrs))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rasterize.rasterize_tiles(entries, off, ntx, nty, settings)
        rasterize.rasterize_tiles_backward(entries, off, gpix5, ntx, nty,
                                           settings)
        importance.entry_counts(entries, off, pix_tiles, ntx, nty, settings)
        out = rasterize.rasterize_tiles(entries._replace(attrs=leaves), off,
                                        ntx, nty, settings,
                                        track_ncontrib=False)
        grads = torch.autograd.grad(out, list(leaves), g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = rasterize.entry_grads(entries, dp)
    check(all(torch.equal(a, b) for a, b in zip(grads, want)),
          f"indexed gradients ({label}) differ from the segment sum of the "
          "packed rows' cotangents")

    def turns(indexed, packed):
        b2b = [cuda_ms(f, iters) for f in (indexed, packed, indexed, packed)]
        queued = [queued_ms(f, iters) for f in (indexed, packed, indexed,
                                                packed)]
        return {"indexed_ms": b2b[0::2], "packed_ms": b2b[1::2],
                "indexed_device_ms": queued[0::2],
                "packed_device_ms": queued[1::2]}
    res = {"slots": a16.shape[1], "valid": int(valid.sum()),
           "fwd": turns(
               lambda: rasterize._rasterize_tiles_cuda(
                   entries, off, ntx, nty, settings, True),
               lambda: rasterize._rasterize_tiles_cuda(
                   a16, off, ntx, nty, settings, True)),
           "bwd": turns(
               lambda: rasterize._rasterize_tiles_backward_cuda(
                   entries, off, gpix5, ntx, nty, settings),
               lambda: rasterize._rasterize_tiles_backward_cuda(
                   a16, off, gpix5, ntx, nty, settings)),
           "imp": turns(
               lambda: importance._entry_counts_cuda(
                   entries, off, pix_tiles, ntx, nty, settings),
               lambda: importance._entry_counts_cuda(
                   a16, off, pix_tiles, ntx, nty, settings)),
           "pack_device_ms": queued_ms(
               lambda: rasterize.pack_entry_attrs(attrs, gauss, valid),
               iters)}
    print(f"[kernels] indexed staging {label}: {res['valid']} valid entries "
          f"of {res['slots']} slots (the rest index INT_MAX); forward tiles, "
          f"backward rows, importance counts and the five fields' gradients "
          f"bit-identical to the packed rows'; sync debug mode \"error\" "
          f"passed; ms in turns (indexed | packed), back to back and queued: "
          + "; ".join(f"{k} {r['indexed_ms'][0]:.4f} / "
                      f"{r['indexed_ms'][1]:.4f} | {r['packed_ms'][0]:.4f} / "
                      f"{r['packed_ms'][1]:.4f}, queued "
                      f"{r['indexed_device_ms'][0]:.4f} / "
                      f"{r['indexed_device_ms'][1]:.4f} | "
                      f"{r['packed_device_ms'][0]:.4f} / "
                      f"{r['packed_device_ms'][1]:.4f}"
                      for k, r in res.items() if isinstance(r, dict))
          + f"; the pack queued {res['pack_device_ms']:.4f} ms", flush=True)
    return res


def packed_calls() -> int:
    """Calls of ``pack_entry_attrs`` on the card so far in this process."""
    from webdgs_tpu_torch import trace
    return trace.counters().get("raster.packed_calls", 0)


def binning_inputs_at(scene, cam, w: int, h: int, settings,
                      cap: int | None):
    """What ``bin_splats`` bins where it bins ``scene`` seen from ``cam``
    at capacity ``cap`` (None: the heuristic capacity a metric view
    takes): (attrs, aux, ntx, e_cap)."""
    import torch
    from webdgs_tpu_torch.ops import binning
    from webdgs_tpu_torch.ops.projection import project_gaussians
    ntx, _ = binning.tile_grid(w, h, settings)
    with torch.no_grad():
        attrs, aux = project_gaussians(scene.params(), scene.alive, cam, w,
                                       h, scene.sh_deg, settings)
    if cap is None:
        cap = binning.entry_capacity(aux.num_tiles.shape[0], settings)
    return attrs, aux, ntx, cap


def expansion_at(scene, cam, w: int, h: int, settings, cap: int | None):
    """The expand kernel's inputs at :func:`binning_inputs_at`'s: (words
    (5, N), counts (N,), e_cap)."""
    import torch
    from webdgs_tpu_torch.ops import binning
    attrs, aux, ntx, cap = binning_inputs_at(scene, cam, w, h, settings, cap)
    with torch.no_grad():
        words, counts, _, _ = binning.expansion_inputs(aux, ntx, cap, attrs,
                                                       settings)
    return words, counts, cap


def expand_check(label: str, words, counts, e_cap: int, plain_iters: int,
                 no_slower: bool = False) -> dict:
    """The expand kernel against ``expand_fields_plain`` on one shape's
    inputs: every slot equal, two runs bit-identical, and the public
    wrapper run in sync debug mode "error".  Times the wrapper (the count
    cumsum and the kernel) back to back, in turns with its plain version,
    and queued, and the kernel alone queued on a precomputed cumsum; gives
    the bound from these inputs.  With BEFORE["expand"], the earlier kernel
    too, in turns with this one, both through the same runner
    (expand_runner): every slot equal, and this kernel alone faster in
    every queued pairing -- with ``no_slower``, no slower on the
    mean of the pairings (at the light bench frame both sit near the
    launch latency).  Each copy in EXPAND_ABLATIONS is timed."""
    import ctypes
    import torch
    from webdgs_tpu_torch import _build
    from webdgs_tpu_torch.ops import expand
    ek = expand.expand_fields(words, counts, e_cap)
    ek2 = expand.expand_fields(words, counts, e_cap)
    ep = expand.expand_fields_plain(words, counts, e_cap)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(ek, ek2)),
          f"expand_fields ({label}) is not bit-identical")
    n_diff = sum(int((a != b).sum()) for a, b in zip(ek, ep))
    check(n_diff == 0, f"expand_fields ({label}): {n_diff} values differ "
          "from the plain version")
    err = max(float((a - b).abs().max()) for a, b in zip(ek, ep))
    del ek2, ep
    # the wrapper never waits for the device
    torch.cuda.set_sync_debug_mode("error")
    try:
        ek3 = expand.expand_fields(words, counts, e_cap)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(all(torch.equal(a, b) for a, b in zip(ek, ek3)),
          f"expand_fields ({label}) differs in sync debug mode")
    del ek3
    n, total = words.shape[1], int(counts.sum())
    run = expand_runner(_build.library(), "csrc/expand.cu")
    cum = torch.cumsum(counts, 0, dtype=torch.int32)
    ow, oi = torch.empty_like(ek[0]), torch.empty_like(ek[1])

    def kernel():
        return expand._expand_fields_cuda(words, counts, e_cap)

    def bare():
        run.launch(words, cum, e_cap, ow, oi)
    ms, plain_ms = time_pair(
        kernel, lambda: expand.expand_fields_plain(words, counts, e_cap), 50,
        plain_iters)
    dev_ms, bare_ms = queued_ms(kernel, 50), queued_ms(bare, 50)
    # the counts and the words of the Gaussians that own a slot in, (5, E)
    # words + (E,) ids out
    owners = int(((counts > 0) & (cum - counts < e_cap)).sum())
    bound = bound_ms(4 * (n + 5 * owners + 6 * e_cap), 0)
    shape = (ctypes.c_int * 6)()
    _build.check(_build.library().webdgs_expand_occupancy(shape),
                 "webdgs_expand_occupancy")
    launch = dict(zip(("threads", "smem_bytes", "ctas_per_sm", "registers",
                       "slots_per_cta", "window"), shape))
    res = {"err": err, "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
           "kernel_device_ms": bare_ms, "bound": bound, "gaussians": n,
           "owners": owners, "slots": e_cap, "valid": total,
           "launch": launch}
    print(f"[kernels] expand_fields {label}: {n} Gaussians ({owners} own a "
          f"slot), {total} valid of {e_cap} slots; launch {launch}; every slot equal to the "
          f"plain version; bit-identical repeat; sync debug mode \"error\" "
          f"passed; wrapper "
          f"{ms:.4f} ms, queued {dev_ms:.4f} ms, the kernel alone queued "
          f"{bare_ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
          f"{bound[0]:.4f} ms ({bound[1]})", flush=True)
    if "expand" in BEFORE:
        before = BEFORE["expand"]
        same = all(torch.equal(a, b)
                   for a, b in zip(before(words, counts, e_cap), ek))

        def new_wrapped():
            return run(words, counts, e_cap)

        def before_wrapped():
            return before(words, counts, e_cap)

        def before_bare():
            before.launch(words, cum, e_cap, ow, oi)
        # in turns: new, before, new, before; one host path for both
        b2b = [cuda_ms(f, 50) for f in (new_wrapped, before_wrapped,
                                        new_wrapped, before_wrapped)]
        queued = [queued_ms(f, 50) for f in (new_wrapped, before_wrapped,
                                             new_wrapped, before_wrapped)]
        alone = [queued_ms(f, 50) for f in (bare, before_bare, bare,
                                            before_bare)]
        res["before"] = {"equal": same, "ms": b2b[1::2],
                         "device_ms": queued[1::2],
                         "kernel_device_ms": alone[1::2],
                         "new_ms": b2b[0::2], "new_device_ms": queued[0::2],
                         "new_kernel_device_ms": alone[0::2]}
        print(f"[kernels] expand_fields {label}, the earlier kernel on the "
              f"same inputs: every slot equal {same}; back to back "
              f"{b2b[1]:.4f} / {b2b[3]:.4f} ms (this one {b2b[0]:.4f} / "
              f"{b2b[2]:.4f}); queued {queued[1]:.4f} / {queued[3]:.4f} ms "
              f"(this one {queued[0]:.4f} / {queued[2]:.4f}); the kernel "
              f"alone queued {alone[1]:.4f} / {alone[3]:.4f} ms (this one "
              f"{alone[0]:.4f} / {alone[2]:.4f})", flush=True)
        check(same, f"expand_fields ({label}) differs from the earlier "
              "kernel")
        new, old = alone[0::2], alone[1::2]
        check(sum(new) <= sum(old) if no_slower else max(new) < min(old),
              f"expand_fields ({label}) is "
              f"{'slower than' if no_slower else 'not faster than'} the "
              f"earlier kernel: {res['before']}")
    for name, (variant, regs) in EXPAND_ABLATIONS.items():
        same = all(torch.equal(a, b)
                   for a, b in zip(variant(words, counts, e_cap), ek))

        def run_variant(variant=variant):
            variant.launch(words, cum, e_cap, ow, oi)
        v_dev = queued_ms(run_variant, 50)
        print(f"[kernels] expand_fields {label}, variant {name} (a timing "
              f"probe): {regs} registers; every slot equal {same}; the "
              f"kernel alone queued {v_dev:.4f} ms", flush=True)
    return res


def cull_check(label: str, attrs, aux, ntx: int, e_cap: int, settings,
               plain_iters: int) -> dict:
    """The tile cull's two kernels against their plain chains on one
    shape's inputs, the chains run on the same CUDA tensors: cull_words'
    five word rows and counts and entry_keys' keys (on the expansion of
    those words at ``e_cap``) equal on every slot, a repeat bit-identical,
    both wrappers run in sync debug mode "error".  Each kernel and its
    plain chain timed in turns, back to back, and the kernel queued; the
    bound from these inputs: cull_words reads 56 bytes and writes 24 per
    slot, entry_keys reads 20 bytes per valid entry and writes 8 per entry
    slot."""
    import torch
    from webdgs_tpu_torch.ops import binning, expand
    n = aux.num_tiles.shape[0]
    words, counts = binning.cull_words(aux, attrs, settings, ntx)
    words2, counts2 = binning.cull_words(aux, attrs, settings, ntx)
    pw, pc = binning.cull_words_plain(aux, attrs, settings, ntx)
    torch.cuda.synchronize()
    check(torch.equal(words, words2) and torch.equal(counts, counts2),
          f"cull_words ({label}) is not bit-identical")
    n_diff = int((words != pw).sum()) + int((counts != pc).sum())
    check(n_diff == 0, f"cull_words ({label}): {n_diff} values differ from "
          "the plain chain")
    ws, c, _, demand = binning.expansion_inputs(aux, ntx, e_cap, attrs,
                                                settings)
    ew, _ = expand.expand_fields(ws, c, e_cap)
    total = c.sum(dtype=torch.int64)
    keys = binning.entry_keys(ew, total, ntx)
    keys2 = binning.entry_keys(ew, total, ntx)
    pk = binning.entry_keys_plain(ew, total, ntx)
    torch.cuda.synchronize()
    check(torch.equal(keys, keys2), f"entry_keys ({label}) is not "
          "bit-identical")
    k_diff = int((keys != pk).sum())
    check(k_diff == 0, f"entry_keys ({label}): {k_diff} of {e_cap} keys "
          "differ from the plain chain")
    del words2, counts2, pw, pc, keys2, pk
    torch.cuda.set_sync_debug_mode("error")
    try:
        w3, c3 = binning.cull_words(aux, attrs, settings, ntx)
        k3 = binning.entry_keys(ew, total, ntx)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(torch.equal(w3, words) and torch.equal(c3, counts) and
          torch.equal(k3, keys), f"the cull ({label}) differs in sync debug "
          "mode")
    del w3, c3, k3
    valid, alive = int(total), int((aux.num_tiles > 0).sum())
    res = {"slots": n, "live_slots": alive, "entry_slots": e_cap,
           "valid": valid, "demand": int(demand), "survivors":
           int(counts.sum(dtype=torch.int64)), "rect_tiles":
           int(aux.num_tiles.sum(dtype=torch.int64))}
    for name, kernel, plain, n_bytes in (
            ("cull_words",
             lambda: binning._cull_words_cuda(aux, attrs, settings, ntx),
             lambda: binning.cull_words_plain(aux, attrs, settings, ntx),
             80 * n),
            ("entry_keys", lambda: binning._entry_keys_cuda(ew, total, ntx),
             lambda: binning.entry_keys_plain(ew, total, ntx),
             20 * valid + 8 * e_cap + 8)):
        ms, plain_ms = time_pair(kernel, plain, 50, plain_iters)
        res[name] = {"err": 0, "ms": ms, "plain_ms": plain_ms,
                     "device_ms": queued_ms(kernel, 50),
                     "bound": bound_ms(n_bytes, 0)}
    cw, ek = res["cull_words"], res["entry_keys"]
    print(f"[kernels] tile cull {label}: {n} slots ({alive} with tiles, "
          f"{res['rect_tiles']} rect tiles, {res['survivors']} survive), "
          f"{valid} valid of {e_cap} entry slots; every word, count and key "
          f"equal to the plain chains; bit-identical repeat; sync debug mode"
          f" \"error\" passed; cull_words {cw['ms']:.4f} ms, queued "
          f"{cw['device_ms']:.4f} ms, plain {cw['plain_ms']:.4f} ms, bound "
          f"{cw['bound'][0]:.4f} ms ({cw['bound'][1]}); entry_keys "
          f"{ek['ms']:.4f} ms, queued {ek['device_ms']:.4f} ms, plain "
          f"{ek['plain_ms']:.4f} ms, bound {ek['bound'][0]:.4f} ms "
          f"({ek['bound'][1]})", flush=True)
    return res


def adam_row_bytes(full_sh: bool) -> int:
    """Bytes of Adam's update a row: p, g, m and v read (59 float32 lanes
    each) and the tile count; p, m and v written.  With the DC coefficient
    alone the gradient's 45 SH rest lanes are not read."""
    return 4 * 59 * 4 + 4 + 3 * 59 * 4 - (0 if full_sh else 45 * 4)


def random_adam_rows(n: int, dev, seed: int):
    """Parameters, gradients (std 1e-2) and tile counts (about a third 0)
    of ``n`` rows, drawn on the card."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = {"means": (n, 3), "quats": (n, 4), "log_scales": (n, 3),
              "opacity_logits": (n,), "sh": (n, 16, 3)}
    params = {k: torch.randn(s, generator=gen, device=dev)
              for k, s in shapes.items()}
    grads = {k: 1e-2 * torch.randn(s, generator=gen, device=dev)
             for k, s in shapes.items()}
    counts = torch.randint(0, 3, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    return params, grads, counts


def adam_check(label: str, params, grads, counts, hps: dict,
               plain_iters: int) -> dict:
    """The Adam kernel against adam_step_plain on the same CUDA tensors,
    for each of ``hps`` ({label: AdamHyperparameters}), three steps with
    the moments carried, each step from the plain chain's state: every lane
    outside the quaternion and both moments equal, the quaternion within 2
    ulp, frozen rows their inputs, a repeat bit-identical, the wrapper run
    in sync debug mode "error"; ``err`` is the largest absolute difference
    from the chain over every lane of p, m and v.  Each of ``hps`` timed in
    turns with the chain, back to back, and the kernel queued, at its third
    step's inputs, against a bound of adam_row_bytes a row: the first's
    times at the top level, each one's under ``by_hp``."""
    import torch
    from webdgs_tpu_torch.ops import adam
    n = counts.shape[0]
    frozen = counts == 0
    res = {"rows": n, "visible": int((~frozen).sum()), "quat_ulps": 0,
           "err": 0.0, "by_hp": {}}
    for name, hp in hps.items():
        p, st = params, adam.init_adam_state(params)
        for step in range(3):
            g = {k: v * (step + 1) for k, v in grads.items()}
            kp, ks = adam._adam_step_cuda(p, g, st, hp, counts)
            kp2, ks2 = adam._adam_step_cuda(p, g, st, hp, counts)
            pp, ps = adam.adam_step_plain(p, g, st, hp, counts)
            torch.cuda.synchronize()
            check(all(torch.equal(kp[k], kp2[k]) for k in kp) and
                  torch.equal(ks.m, ks2.m) and torch.equal(ks.v, ks2.v),
                  f"adam_step ({label}, {name}) is not bit-identical")
            diff = {k: int((kp[k] != pp[k]).sum()) for k in kp
                    if k != "quats"}
            diff["m"] = int((ks.m != ps.m).sum())
            diff["v"] = int((ks.v != ps.v).sum())
            check(not any(diff.values()), f"adam_step ({label}, {name}, "
                  f"step {step + 1}): values differ from the plain chain "
                  f"{diff}")
            res["err"] = max([res["err"]] + [
                float((a - b).abs().max()) for a, b in (
                    *((kp[k], pp[k]) for k in kp), (ks.m, ps.m),
                    (ks.v, ps.v))])
            ulps = int((kp["quats"].view(torch.int32).to(torch.int64)
                        - pp["quats"].view(torch.int32).to(torch.int64))
                       .abs().max())
            res["quat_ulps"] = max(res["quat_ulps"], ulps)
            check(ulps <= 2, f"adam_step ({label}, {name}): quaternion "
                  f"{ulps} ulp from the plain chain")
            check(all(torch.equal(kp[k][frozen], p[k][frozen]) for k in kp)
                  and torch.equal(ks.m[frozen], st.m[frozen]),
                  f"adam_step ({label}, {name}) moved a frozen row")
            if step < 2:
                p, st = pp, ps
            del kp, ks, kp2, ks2, pp, ps
        g = {k: v * 3 for k, v in grads.items()}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            adam.adam_step(p, g, st, hp, counts)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ms, plain_ms = time_pair(
            lambda: adam._adam_step_cuda(p, g, st, hp, counts),
            lambda: adam.adam_step_plain(p, g, st, hp, counts), 20,
            plain_iters)
        res["by_hp"][name] = {
            "ms": ms, "plain_ms": plain_ms,
            "device_ms": queued_ms(
                lambda: adam._adam_step_cuda(p, g, st, hp, counts), 20),
            "bound": bound_ms(adam_row_bytes(hp.full_sh) * n, 0)}
        del p, st, g
        torch.cuda.empty_cache()
    res.update(next(iter(res["by_hp"].values())))
    times = "; ".join(
        f"{name} {r['ms']:.4f} ms, queued {r['device_ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
        f"({r['bound'][1]})" for name, r in res["by_hp"].items())
    print(f"[kernels] adam_step {label}: {n} rows ({res['visible']} "
          f"visible), {', '.join(hps)}, three steps each; every lane outside "
          f"the quaternion and both moments equal to the plain chain, the "
          f"quaternion within {res['quat_ulps']} ulp, max abs err "
          f"{res['err']:.3g}; bit-identical repeat; sync debug mode "
          f"\"error\" passed; {times}", flush=True)
    return res


def loss_check(label: str, out, target, w: int, h: int, ntx: int, nty: int,
               cfg, settings, plain_iters: int) -> dict:
    """The tile-loss kernel against ``tile_loss_gradient_plain`` on one
    step's forward tiles and target: dpix within LOSS_ATOL, the summed
    metric partials within 1e-5 relative, two runs bit-identical, and the
    wrapper run in sync debug mode "error".  Times the kernel back to back
    (in turns with its plain version) and queued, and gives the bound from
    these inputs.  With BEFORE["loss"], the earlier kernel too, in turns
    with this one, both through the same runner (loss_runner): all 8 dpix
    channels bit-identical and this one faster in every queued pairing.  Each copy in LOSS_ABLATIONS is timed."""
    import ctypes
    import torch
    from webdgs_tpu_torch import _build
    from webdgs_tpu_torch.ops import tile_loss
    args = (out, target, w, h, ntx, nty, cfg, settings)
    dk, sk = tile_loss.tile_loss_tiles(*args)
    dk2, sk2 = tile_loss.tile_loss_tiles(*args)
    dp, sp = tile_loss.tile_loss_gradient_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(dk, dk2) and torch.equal(sk, sk2),
          f"tile loss ({label}) is not bit-identical across runs")
    err = float((dk - dp).abs().max())
    sums_rel = float(((sk.sum(0) - sp.sum(0)).abs()
                      / sp.sum(0).abs().clamp(min=1e-30)).max())
    check(err <= LOSS_ATOL and sums_rel <= 1e-5,
          f"tile loss ({label}): dpix err {err}, metric sums rel err "
          f"{sums_rel}")
    check(float(dk[:, 0:3].abs().max()) > 0,
          f"tile loss ({label}): the gradient is all 0")
    del dk2, sk2, dp, sp
    # the wrapper never waits for the device
    torch.cuda.set_sync_debug_mode("error")
    try:
        dk3, sk3 = tile_loss.tile_loss_tiles(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(torch.equal(dk3, dk) and torch.equal(sk3, sk),
          f"tile loss ({label}) differs in sync debug mode")
    del dk3, sk3

    def kernel():
        return tile_loss._tile_loss_cuda(*args)
    ms, plain_ms = time_pair(
        kernel, lambda: tile_loss.tile_loss_gradient_plain(*args), 50,
        plain_iters)
    dev_ms = queued_ms(kernel, 50)
    n_tiles, npx = ntx * nty, settings.tile_px
    # 4 tile channels + the target in, (T, 8, P) + (T, 4) sums out; about
    # 150 operations per pixel and channel (5 box sums of 25, SSIM, grad)
    bound = bound_ms(4 * (4 * n_tiles * npx + 3 * w * h + 8 * n_tiles * npx
                          + 4 * n_tiles), 150 * 3 * w * h)
    shape = (ctypes.c_int * 5)()
    _build.check(_build.library().webdgs_tile_loss_occupancy(
        settings.tile_w, settings.tile_h, shape),
        "webdgs_tile_loss_occupancy")
    launch = dict(zip(("threads", "smem_bytes", "ctas_per_sm", "registers",
                       "rows_per_thread"), shape))
    res = {"err": err, "sums_rel": sums_rel, "ms": ms, "plain_ms": plain_ms,
           "device_ms": dev_ms, "bound": bound, "tiles": n_tiles,
           "launch": launch}
    print(f"[kernels] tile_loss {label}: {n_tiles} tiles of {npx} pixels; "
          f"launch {launch}; max abs err {err:.3e} (<= {LOSS_ATOL}), metric "
          f"sums rel err {sums_rel:.2e}; bit-identical repeat; sync debug "
          f"mode \"error\" passed; kernel {ms:.4f} ms, queued {dev_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]})",
          flush=True)
    if "loss" in BEFORE:
        run = loss_runner(_build.library(), "csrc/tile_loss.cu")

        def new():
            return run(*args)

        def before():
            return BEFORE["loss"](*args)
        db, sb = before()
        same = torch.equal(db, dk)
        sums_diff = float(((sb.sum(0) - sk.sum(0)).abs()
                           / sk.sum(0).abs().clamp(min=1e-30)).max())
        del db, sb
        # in turns: new, before, new, before; one host path for both
        b2b = [cuda_ms(f, 50) for f in (new, before, new, before)]
        queued = [queued_ms(f, 50) for f in (new, before, new, before)]
        res["before"] = {"bit_identical": same, "sums_rel_diff": sums_diff,
                         "ms": b2b[1::2], "device_ms": queued[1::2],
                         "new_ms": b2b[0::2], "new_device_ms": queued[0::2]}
        print(f"[kernels] tile_loss {label}, the earlier kernel on the same "
              f"inputs: all 8 dpix channels bit-identical {same}, summed "
              f"metric partials rel diff {sums_diff:.2e}; back to back "
              f"{b2b[1]:.4f} / {b2b[3]:.4f} ms (this one {b2b[0]:.4f} / "
              f"{b2b[2]:.4f}); queued {queued[1]:.4f} / {queued[3]:.4f} ms "
              f"(this one {queued[0]:.4f} / {queued[2]:.4f})", flush=True)
        check(same, f"tile loss ({label}) dpix differs from the earlier "
              "kernel")
        check(max(queued[0::2]) < min(queued[1::2]),
              f"tile loss ({label}) is not faster than the earlier kernel: "
              f"{res['before']}")
    for name, (variant, regs) in LOSS_ABLATIONS.items():
        def run_variant(variant=variant):
            return variant(*args)
        same = torch.equal(run_variant()[0], dk)
        v_dev = queued_ms(run_variant, 50)
        print(f"[kernels] tile_loss {label}, variant {name} (a timing "
              f"probe): {regs} registers; dpix bit-identical {same}; queued "
              f"{v_dev:.4f} ms", flush=True)
    return res


def backward_step_inputs(scene, cam, w: int, h: int, settings, cap: int,
                         target) -> dict:
    """The backward kernel's inputs at one training step of ``scene`` seen
    from ``cam`` against ``target``: the packed entries (16, cap), the
    tile offsets and the (T, 5, P) pixel cotangents that the tile-loss
    kernel's dpix and the forward tiles give, as ``_RasterizeTiles.
    backward`` folds them.  Also the forward tiles with n_contrib (for the
    pairs the raster kernels evaluate), the tile grid, the projected
    attributes and the binning."""
    import torch
    from webdgs_tpu_torch.ops import binning, rasterize, tile_loss
    from webdgs_tpu_torch.ops.loss import LossConfig
    from webdgs_tpu_torch.ops.projection import project_gaussians
    ntx, nty = binning.tile_grid(w, h, settings)
    with torch.no_grad():
        attrs, aux = project_gaussians(scene.params(), scene.alive, cam, w,
                                       h, scene.sh_deg, settings)
        bins = binning.bin_splats(aux, w, h, settings, capacity=cap,
                                  attrs=attrs, with_source=True)
        a16 = rasterize.pack_entry_attrs(attrs, bins.entry_gauss,
                                         bins.entry_valid)
        out = rasterize.rasterize_tiles(a16, bins.tile_offsets, ntx, nty,
                                        settings)
        dpix, _ = tile_loss.tile_loss_tiles(out, target, w, h, ntx, nty,
                                            LossConfig(), settings)
        suffix = (torch.sum(dpix[:, 0:4] * out[:, 0:4], dim=1, keepdim=True)
                  + dpix[:, 4:5] * out[:, 4:5])
        gpix5 = torch.cat([dpix[:, 0:4], suffix], dim=1).contiguous()
    return {"attrs16": a16, "tile_offsets": bins.tile_offsets,
            "gpix5": gpix5, "ntx": ntx, "nty": nty, "fwd": out,
            "entries": int(bins.total_entries), "attrs": attrs,
            "bins": bins}


def backward_check(label: str, inp: dict, settings, iters: int,
                   plain_iters: int) -> dict:
    """The backward kernel against ``rasterize_tiles_backward_plain`` on
    one step's inputs (``backward_step_inputs``): scaled error within
    BWD_TOL, two runs bit-identical, rows 9-15 zero.  Times the kernel
    back to back (in turns with its plain version) and with the launch
    queue filled first, and gives the bound from the pairs these inputs
    make the raster kernels evaluate, the tiles' work and the launch
    shape.  With BEFORE["bwd"], the earlier kernel too, on the same inputs, in
    turns with this one."""
    import ctypes
    import torch
    from webdgs_tpu_torch import _build
    from webdgs_tpu_torch.ops import rasterize
    args = (inp["attrs16"], inp["tile_offsets"], inp["gpix5"], inp["ntx"],
            inp["nty"], settings)
    bk = rasterize.rasterize_tiles_backward(*args)
    bk2 = rasterize.rasterize_tiles_backward(*args)
    bp = rasterize.rasterize_tiles_backward_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(bk, bk2), f"backward raster ({label}) is not "
          "bit-identical")
    err = max_rel(bk, bp)
    check(err <= BWD_TOL, f"backward raster ({label}) scaled err {err}")
    check(not bk[9:].any() and float(bk[0:9].abs().max()) > 0,
          f"backward raster ({label}) rows")
    del bk2, bp

    def kernel():
        return rasterize._rasterize_tiles_backward_cuda(*args)
    ms, plain_ms = time_pair(
        kernel, lambda: rasterize.rasterize_tiles_backward_plain(*args),
        iters, plain_iters)
    dev_ms = queued_ms(kernel, iters)
    pairs = evaluated_pairs(inp["fwd"], inp["tile_offsets"], settings)
    e_len, n_tiles = inp["attrs16"].shape[1], inp["ntx"] * inp["nty"]
    # 11 rows + offsets + (T, 5, P) cotangents in, (16, E) rows out; the
    # pairs evaluated are the forward's (the same per-pixel early exit)
    bound = bound_ms(4 * (11 * e_len + n_tiles + 1
                          + 5 * n_tiles * settings.tile_px + 16 * e_len),
                     BWD_OPS_PER_PAIR * pairs)
    shape = (ctypes.c_int * 5)()
    _build.check(_build.library().webdgs_rasterize_bwd_occupancy(
        settings.tile_w, settings.tile_h, settings.chunk, shape),
        "webdgs_rasterize_bwd_occupancy")
    launch = dict(zip(("threads", "smem_bytes", "ctas_per_sm",
                       "pixels_per_thread", "batch"), shape))
    work = tile_work(inp["fwd"], inp["tile_offsets"], settings)
    res = {"err": err, "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
           "bound": bound, "pairs": pairs, "entries": inp["entries"],
           "slots": e_len, "launch": launch, "tile_work": work}
    print(f"[kernels] rasterize_tiles_backward {label}: {inp['entries']} "
          f"entries of {e_len} slots, {n_tiles} tiles (entries per tile "
          f"max {work['count']['max']:.0f}, mean {work['count']['mean']:.1f},"
          f" p99 {work['count']['p99']:.0f}; visited before saturation max "
          f"{work['visited']['max']:.0f}, mean "
          f"{work['visited']['mean']:.1f}, p99 {work['visited']['p99']:.0f}"
          f"), {pairs} (pixel, entry) pairs; launch {launch}; scaled max "
          f"err {err:.3e} (<= {BWD_TOL}); bit-identical repeat; rows 9-15 "
          f"zero; kernel {ms:.4f} ms, queued {dev_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]})",
          flush=True)
    if "bwd" in BEFORE:
        def before():
            return BEFORE["bwd"](*args)
        before_err = max_rel(before(), bk)
        # in turns: new, before, new, before
        b2b = [cuda_ms(f, iters) for f in (kernel, before, kernel, before)]
        queued = [queued_ms(f, iters) for f in (kernel, before, kernel,
                                                before)]
        res["before"] = {"scaled_diff": before_err, "ms": b2b[1::2],
                         "device_ms": queued[1::2], "new_ms": b2b[0::2],
                         "new_device_ms": queued[0::2]}
        check(max(b2b[0::2]) < min(b2b[1::2]) and
              max(queued[0::2]) < min(queued[1::2]),
              f"backward raster ({label}) is not faster than the earlier "
              f"kernel: {res['before']}")
        print(f"[kernels] rasterize_tiles_backward {label}, the earlier "
              f"kernel on the same inputs: scaled difference "
              f"{before_err:.3e}; back to back {b2b[1]:.4f} / {b2b[3]:.4f} "
              f"ms (this one {b2b[0]:.4f} / {b2b[2]:.4f}); queued "
              f"{queued[1]:.4f} / {queued[3]:.4f} ms (this one "
              f"{queued[0]:.4f} / {queued[2]:.4f})", flush=True)
    for name, (variant, regs) in BWD_ABLATIONS.items():
        def run_variant(variant=variant):
            return variant(*args)
        diff = max_rel(run_variant(), bk)
        v_ms = cuda_ms(run_variant, iters)
        v_dev = queued_ms(run_variant, iters)
        ctas = variant.ctas_per_sm and variant.ctas_per_sm(settings)
        print(f"[kernels] rasterize_tiles_backward {label}, variant {name} "
              f"(a timing probe): {regs} registers, {ctas} CTAs per SM; "
              f"scaled difference {diff:.3e}; {v_ms:.4f} ms, queued "
              f"{v_dev:.4f} ms", flush=True)
    return res


def tile_work(fwd_tiles, tile_offsets, settings) -> dict:
    """Per-tile entry counts and the entries each tile's raster kernels
    visit: a tile stops after the chunk in which its last pixel saturates
    (through that pixel's n_contrib), or at the end of its range."""
    import torch
    cnt = (tile_offsets[1:] - tile_offsets[:-1]).to(torch.float64)
    sat = fwd_tiles[:, 4] < settings.t_threshold
    per_px = torch.where(sat, fwd_tiles[:, 5].to(torch.float64), cnt[:, None])
    k = settings.chunk
    visited = torch.minimum(torch.ceil(per_px.amax(dim=1) / k) * k, cnt)

    def stats(x):
        return {"max": float(x.max()), "mean": float(x.mean()),
                "p99": float(torch.quantile(x, 0.99)),
                "p50": float(torch.quantile(x, 0.5))}
    return {"tiles": int(cnt.numel()), "count": stats(cnt),
            "visited": stats(visited),
            "saturated_px": float(sat.to(torch.float64).mean())}


def device_us_by_kernel(fn, iters: int = 20) -> dict:
    """Mean device microseconds per call of each kernel ``fn`` launches,
    under torch.profiler."""
    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = re.sub(r"\(anonymous namespace\)::|<.*|\(.*", "",
                          e.name)[:40]
            us[name] = us.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / iters
    return {k: round(v, 2) for k, v in us.items()}


def segsum_check(label: str, rows_cm, counts, src, valid, exp_gauss,
                 plain_iters: int) -> dict:
    """The segment-sum kernel against ``segment_sum_rows_plain`` on one
    shape's inputs (rows in sorted-slot order, the binning's counts,
    entry_source, valid flags and expansion-order Gaussian ids): scaled
    error within SEGSUM_TOL and two runs bit-identical.  Times the kernel,
    its plain version and the library yardstick ``index_add_`` on the rows
    pre-gathered into expansion order (atomics; the port never calls it),
    back to back and with the launch queue filled first, and the kernel's
    device time by launch.  With BEFORE_SEGSUM, the earlier kernel too, on
    the same inputs, in turns with this one."""
    import torch
    from webdgs_tpu_torch.ops import segsum
    c, n = rows_cm.shape[0], counts.shape[0]
    total = int(counts.sum())
    sk = segsum.segment_sum_rows(rows_cm, counts, src, valid)
    sk2 = segsum.segment_sum_rows(rows_cm, counts, src, valid)
    sp = segsum.segment_sum_rows_plain(rows_cm, counts, src, valid)
    torch.cuda.synchronize()
    check(torch.equal(sk, sk2), f"segment sum ({label}) is not bit-identical")
    err = max_rel(sk, sp)
    check(err <= SEGSUM_TOL, f"segment sum ({label}) scaled err {err}")
    inv = segsum.inverse_permutation(src)
    rows_exp = rows_cm[:, inv[:total].long()].T.contiguous()
    ids_exp = exp_gauss[:total].long()
    zeros_n = torch.zeros((n, c), dtype=torch.float32, device=rows_cm.device)

    def kernel():
        return segsum._segment_sum_rows_cuda(rows_cm, counts, src, valid)

    def library():
        return zeros_n.clone().index_add_(0, ids_exp, rows_exp)

    lib_err = max_rel(library(), sp)
    ms, plain_ms = time_pair(
        kernel, lambda: segsum.segment_sum_rows_plain(rows_cm, counts, src,
                                                      valid), 50, plain_iters)
    lib_ms = cuda_ms(library, 50)
    dev_ms, lib_dev_ms = queued_ms(kernel, 50), queued_ms(library, 50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        kernel()
    host_us = (time.perf_counter() - t0) / 50 * 1e6
    torch.cuda.synchronize()
    # rows (C per entry), entry_source, valid flags and the N + 1 segment
    # starts in, (N, C) out: each read or written once
    bound = bound_ms(4 * (c * total + total + n + 1 + c * n) + total,
                     c * total)
    res = {"err": err, "lib_err": lib_err, "ms": ms, "plain_ms": plain_ms,
           "lib_ms": lib_ms, "device_ms": dev_ms, "lib_device_ms": lib_dev_ms,
           "host_us": host_us, "bound": bound, "entries": total,
           "slots": rows_cm.shape[1], "gaussians": n, "channels": c,
           "max_count": int(counts.max()),
           "device_us_by_kernel": device_us_by_kernel(kernel)}
    print(f"[kernels] segment_sum_rows {label}: C = {c}, {total} entries of "
          f"{res['slots']} slots, {n} Gaussians (at most {res['max_count']} "
          f"entries each); scaled max err {err:.3e} (<= {SEGSUM_TOL}), "
          f"index_add_ err {lib_err:.2e}; bit-identical repeat; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ {lib_ms:.4f} "
          f"ms; queued: kernel {dev_ms:.4f} ms, index_add_ "
          f"{lib_dev_ms:.4f} ms; wrapper host {host_us:.1f} us/call; device "
          f"us by launch {res['device_us_by_kernel']}; bound "
          f"{bound[0]:.4f} ms ({bound[1]})", flush=True)
    if BEFORE_SEGSUM is not None:
        def before():
            return BEFORE_SEGSUM(rows_cm, counts, inv, valid)
        same = torch.equal(before(), sk)
        # in turns: new, before, new, before
        b2b = [cuda_ms(f, 50) for f in (kernel, before, kernel, before)]
        queued = [queued_ms(f, 50) for f in (kernel, before, kernel, before)]
        res["before"] = {"bit_identical": same, "ms": b2b[1::2],
                         "device_ms": queued[1::2], "new_ms": b2b[0::2],
                         "new_device_ms": queued[0::2],
                         "device_us_by_kernel": device_us_by_kernel(before)}
        print(f"[kernels] segment_sum_rows {label}, the earlier kernel on the "
              f"same inputs: sums bit-identical to this one's {same}; back to "
              f"back {b2b[1]:.4f} / {b2b[3]:.4f} ms (this one {b2b[0]:.4f} / "
              f"{b2b[2]:.4f}); queued {queued[1]:.4f} / {queued[3]:.4f} ms "
              f"(this one {queued[0]:.4f} / {queued[2]:.4f}); device us by "
              f"launch {res['before']['device_us_by_kernel']}", flush=True)
    return res


def sync_tally(fn):
    """Run ``fn`` with every call that waits for the device (a read back, a
    blocking copy) warned (``torch.cuda.set_sync_debug_mode("warn")``).
    Returns fn's result and the calls tallied by the line that made them,
    {"file:line": count}.  A tally inside another counts its calls
    itself; the outer one sees the rest."""
    import torch
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    syncs: dict[str, int] = {}
    for wn in caught:
        # "called a synchronizing CUDA operation"; not the debug mode's own
        # note that it is a prototype
        if "called a synchronizing" in str(wn.message):
            where = f"{os.path.relpath(wn.filename)}:{wn.lineno}"
            syncs[where] = syncs.get(where, 0) + 1
    return out, syncs


def backward_wrapper_lines() -> list[tuple[str, int, int]]:
    """(file, first line, last line) of the backward raster's Python path:
    the autograd backward, its wrapper, the launch and the checks only it
    runs."""
    import inspect
    from webdgs_tpu_torch.ops import rasterize
    spans = []
    for fn in (rasterize._RasterizeTiles.backward,
               rasterize.rasterize_tiles_backward, rasterize._check_gpix,
               rasterize._rasterize_tiles_backward_cuda):
        lines, first = inspect.getsourcelines(fn)
        spans.append((os.path.relpath(inspect.getsourcefile(fn)), first,
                      first + len(lines) - 1))
    return spans


def densify_setup(dev, s1m, n: int = 1_000_000,
                  size: tuple[int, int] = (1920, 1080)):
    """The densify run's scene, views and config: the 1M sh3 scene, 10
    synthetic views with cameras near (0, 0, -10) whose targets are
    renders of the scene with positions and SH perturbed by a fixed numpy
    noise, and the default metric_views=10, metric_downscale=2 (960x540)
    with events at iterations 2 and 4 and thresholds under which each
    event clones, splits and prunes.  Returns (scene, cameras, images,
    config)."""
    import torch
    from webdgs_tpu_torch.core.camera import CameraData, make_camera
    from webdgs_tpu_torch.render.renderer import render
    from webdgs_tpu_torch.train.config import load_trainer_config

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
    return big, cams, imgs, cfg


def densify_phase(dev, s1m, n: int = 1_000_000,
                  size: tuple[int, int] = (1920, 1080)) -> dict:
    """Two densify events through the Trainer at 1M sh3 / 1920x1080 with
    10 synthetic views (densify_setup)."""
    import torch
    from webdgs_tpu_torch.train.trainer import Trainer

    W, H = size
    big, cams, imgs, cfg = densify_setup(dev, s1m, n, size)
    trainer = Trainer(big, cams, imgs, cfg, s1m)
    del big, imgs

    events = []
    run_densify = trainer._densify_event

    def timed_densify(w_, h_):
        torch.cuda.synchronize()
        before = (trainer.num_points, trainer.scene.capacity)
        t0 = time.perf_counter()
        _, syncs = sync_tally(lambda: run_densify(w_, h_))
        torch.cuda.synchronize()
        events.append({"ms": 1e3 * (time.perf_counter() - t0),
                       "points": (before[0], trainer.num_points),
                       "capacity": (before[1], trainer.scene.capacity),
                       "syncs": syncs, **trainer.last_densify_event})

    trainer._densify_event = timed_densify
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_mark = kernel_counters()
    packed_mark = packed_calls()
    t0 = time.perf_counter()
    for _ in range(4):
        metrics = trainer.step()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = launches_since(launch_mark)
    packed = packed_calls() - packed_mark
    print(f"[densify] raster.packed_calls over 4 Trainer steps and 2 "
          f"events: {packed}", flush=True)
    check(packed == 0, f"the Trainer's steps or events packed entry rows "
          f"{packed} times")
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
        # the segment sum, the raster wrappers and the importance counts
        # read nothing back on this path
        kernel_syncs = {k: v for k, v in ev["syncs"].items()
                        if any(f"ops/{m}.py" in k for m in
                               ("segsum", "rasterize", "importance"))}
        check(not kernel_syncs, f"the segment sum, the raster wrappers or "
              f"the importance counts synchronized: {kernel_syncs}")
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
    from webdgs_tpu_torch.ops import importance
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
    margs, n_valid, mbins, mattrs = metric_view_inputs(
        sc, mcam, tgt, mw, mh, cfg.densify.metric_threshold, s1m)
    # the forward kernel at the same view: each event launches it once per
    # view
    fwd = forward_check(f"{mw}x{mh} densify view", margs[0], margs[1],
                        margs[3], margs[4], s1m, 10, 1, ties=True)
    imp = importance_check(f"{mw}x{mh} densify view", margs, n_valid, 1)
    idx_view = indexed_check(f"{mw}x{mh} densify view", mattrs, mbins,
                             margs[3], margs[4], s1m, 5, pix_tiles=margs[2])
    del mattrs
    # the expansion of the same view (the heuristic capacity)
    exp_view = expand_check(f"{mw}x{mh} densify view",
                            *expansion_at(sc, mcam, mw, mh, s1m, None), 1)
    cull_view = cull_check(
        f"{mw}x{mh} densify view",
        *binning_inputs_at(sc, mcam, mw, mh, s1m, None), s1m, 1)
    # the one-row segment sum an event launches once per view, on this
    # view's importance counts
    with torch.no_grad():
        view_counts = importance.entry_counts(*margs)[None, :]
    seg = segsum_check(f"{mw}x{mh} densify view", view_counts,
                       mbins.gauss_counts, mbins.entry_source,
                       mbins.entry_valid, mbins.expansion_gauss, 1)
    del trainer, sc, margs, mbins, view_counts
    torch.cuda.empty_cache()
    return {"launches": launches, "events": events, "peak_gb": peak_gb,
            "importance": imp, "segsum": seg, "forward": fwd,
            "expand": exp_view, "cull": cull_view, "indexed": idx_view}


def small_event_phase(dev, settings) -> None:
    """One small densify event on the card against the same event on the
    CPU: importance counts of two views, decide, cap and the transforms
    with one injected numpy noise."""
    import torch
    from webdgs_tpu_torch.bench import bench_scene
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


def banded_check(label: str, scene, cam, w: int, h: int, settings,
                 bands: int) -> dict:
    """``render_banded(bands=...)`` against ``render`` at one frame: the
    image within RAST_ATOL except at threshold ties (TIE_RTOL, as
    forward_check has them), the bands' last contributors and final
    transmittance coming from their tiles (``renderer._render_band``, the
    route render_banded takes; its image is checked to be theirs bit for
    bit)."""
    import torch
    from webdgs_tpu_torch.ops import binning, rasterize
    from webdgs_tpu_torch.render import renderer
    ntx, nty = binning.tile_grid(w, h, settings)
    rows = -(-nty // bands)
    with torch.no_grad():
        ref = renderer.render(scene, cam, w, h, settings)
        got = renderer.render_banded(scene, cam, w, h, settings,
                                     bands=bands)
        attrs, aux = renderer._project_frame(scene, cam, w, h, settings,
                                             None, 3.0, False)
        tiles = torch.cat([renderer._render_band(
            attrs, aux, b * rows, w, rows, ntx, settings, None)[0]
            for b in range(bands)])[:h]
    check(torch.equal(rasterize.composite_background(tiles, settings), got),
          f"render_banded ({label}) is not its bands' tiles")
    diff = (got - ref.image).abs().amax(dim=-1)
    nc = tiles[..., rasterize.OUT_NCONTRIB]
    flip = nc != ref.n_contrib.to(torch.float32)
    t_first = torch.where(nc < ref.n_contrib, tiles[..., rasterize.OUT_T],
                          ref.t_final)
    tie = flip & ((t_first - settings.t_threshold).abs()
                  <= TIE_RTOL * settings.t_threshold)
    over = diff > RAST_ATOL
    err = float(diff.max())
    err_rest = float(diff[~(over & tie)].max())
    n_over, n_ties = int(over.sum()), int((over & tie).sum())
    same = bool(torch.equal(got, ref.image))
    print(f"[banded] render_banded(bands={bands}) vs render, {label}: "
          f"{bands} bands of {rows} tile rows; max abs err {err:.3e}, "
          f"{n_over} pixels over {RAST_ATOL} ({n_ties} threshold ties), "
          f"{err_rest:.3e} outside them; bit-identical {same}", flush=True)
    check(err_rest <= RAST_ATOL, f"render_banded ({label}) max abs err "
          f"{err} ({n_over} pixels over {RAST_ATOL}, {n_ties} ties)")
    return {"bands": bands, "max_abs_err": err,
            "max_abs_err_outside_ties": err_rest, "tie_pixels": n_ties,
            "bit_identical": same}


def banded_phase(dev, big, settings, size=(8192, 4320),
                 hd=(1920, 1080)) -> dict:
    """[banded]: the 1M sh3 scene at DCI 8K (over the tile-key limit, two
    bands) through ``Viewer.render`` and through ``render_banded`` in both
    modes (run in sync debug mode "error": a banded frame waits on
    nothing), each band launching expand and the forward raster once; one
    band's expand and forward kernels against their plain versions; and
    ``render_banded`` with 2 and 3 bands against ``render`` at
    1920x1080."""
    import torch
    from webdgs_tpu_torch.core.camera import default_camera
    from webdgs_tpu_torch.ops import binning, rasterize
    from webdgs_tpu_torch.ops.projection import restrict_aux_to_band
    from webdgs_tpu_torch.render import renderer
    from webdgs_tpu_torch.render.viewer import Viewer

    cam_hd = default_camera(*hd, position=(0.0, 0.0, -10.0), device=dev)
    vs_plain = [banded_check(f"1M sh3 {hd[0]}x{hd[1]}", big, cam_hd, *hd,
                             settings, b) for b in (2, 3)]
    W, H = size
    ntx, nty = binning.tile_grid(W, H, settings)
    check(ntx * nty >= binning.TILE_KEY_LIMIT, f"{W}x{H} is under the limit")
    bands = -(-nty // ((binning.TILE_KEY_LIMIT - 1) // ntx))
    rows = -(-nty // bands)
    viewer = Viewer(big, W, H, settings, device="cuda")
    viewer.control.position = np.array([0.0, 0.0, -10.0], np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_mark = kernel_counters()
    frame_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        img = viewer.render()  # a host image: synchronized
        frame_ms.append(1e3 * (time.perf_counter() - t0))
    viewer_launches = {k: v for k, v in launches_since(launch_mark).items()
                       if k in VIEWER_KERNELS}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(v == 3 * bands for v in viewer_launches.values()),
          f"3 banded frames of {bands} bands launched {viewer_launches}")
    check(img.shape == (H, W, 3) and bool(np.isfinite(img).all()),
          f"the {W}x{H} frame is not a finite image")
    lit = float((img.max(axis=2) > 0.02).mean())
    check(lit > 0.05, f"the {W}x{H} frame is almost all background ({lit})")
    print(f"[banded] Viewer 1M sh3 {W}x{H} ({ntx * nty} tiles, {bands} "
          f"bands of {rows} tile rows): frames "
          f"{[round(t, 2) for t in frame_ms]} ms; {viewer.entry_demand} "
          f"entries in the largest band, capacity "
          f"{viewer._entry_budget.value}; "
          f"peak device memory {peak_gib:.2f} GiB; {lit:.3f} of pixels "
          f"lit; launches {viewer_launches}", flush=True)

    cam = viewer.camera()
    cap = viewer._entry_budget.value

    def frame(mode):
        return renderer.render_banded(big, cam, W, H, settings,
                                      entry_capacity=cap, mode=mode,
                                      return_entries=True)
    for mode in ("gaussian", "pointcloud"):
        frame(mode)  # warm-up
    launch_mark = kernel_counters()
    banded_ms = {"gaussian": [], "pointcloud": []}
    outs = {}
    with torch.no_grad():
        for _ in range(3):
            for mode in banded_ms:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    outs[mode] = frame(mode)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                banded_ms[mode].append(1e3 * (time.perf_counter() - t0))
    launches = {k: v for k, v in launches_since(launch_mark).items()
                if k in VIEWER_KERNELS}
    check(all(v == 6 * bands for v in launches.values()),
          f"6 render_banded frames of {bands} bands launched {launches}")
    g_img, g_ent = outs["gaussian"]
    p_img, _ = outs["pointcloud"]
    check(tuple(g_img.shape) == tuple(p_img.shape) == (H, W, 3) and
          bool(torch.isfinite(g_img).all()) and
          float(p_img[..., 0].max()) > 0.5, "render_banded frames")
    check(int(g_ent) == viewer.entry_demand,
          "render_banded's entries differ from the Viewer's")
    print(f"[banded] render_banded 1M sh3 {W}x{H} in sync debug mode "
          f"\"error\" (no synchronizing call): gaussian "
          f"{[round(t, 2) for t in banded_ms['gaussian']]} ms, pointcloud "
          f"{[round(t, 2) for t in banded_ms['pointcloud']]} ms; launches "
          f"{launches}", flush=True)

    # each band's entries; the heaviest band's kernels against their plain
    # versions
    with torch.no_grad():
        attrs, aux = renderer._project_frame(big, cam, W, H, settings, None,
                                             3.0, False)
        per_band = [int(renderer._render_band(attrs, aux, b * rows, W, rows,
                                              ntx, settings, cap)[1])
                    for b in range(bands)]
        b = int(np.argmax(per_band))
        aux_b = restrict_aux_to_band(aux, b * rows, rows)
        attrs_b = renderer.shift_to_band(attrs, b * rows, settings)
        words, counts, _, _ = binning.expansion_inputs(aux_b, ntx, cap,
                                                       attrs_b, settings)
        bins = binning.bin_splats(aux_b, W, rows * settings.tile_h, settings,
                                  capacity=cap, attrs=attrs_b)
        a16 = rasterize.pack_entry_attrs(attrs_b, bins.entry_gauss,
                                         bins.entry_valid)
    del attrs, aux, aux_b, attrs_b
    print(f"[banded] entries per band {per_band} (capacity {cap}); band "
          f"{b} against the plain versions", flush=True)
    exp = expand_check(f"{W}x{H} band {b}", words, counts, cap, 1)
    fwd = forward_check(f"{W}x{H} band {b}", a16, bins.tile_offsets, ntx,
                        rows, settings, 5, 1, ties=True)
    del words, counts, bins, a16, viewer, outs, g_img, p_img, img
    torch.cuda.empty_cache()
    return {"launches": launches, "viewer_launches": viewer_launches,
            "frame_ms": frame_ms, "banded_ms": banded_ms,
            "entries_per_band": per_band, "peak_gib": peak_gib,
            "expand": exp, "forward": fwd, "vs_plain": vs_plain}


def dp_phase(dev, big, settings, size=(1920, 1080)) -> dict:
    """[dp]: ``make_mesh()`` with no launcher (a 1-rank NCCL group on the
    card); 3 ``dp_train_step``s of 2 views on the 1M sh3 scene through all
    five training kernels, one step's synchronizing calls by line (none
    from parallel/sharding.py), one step against the single-device
    composition (the views' ``compute_param_grads_tiled`` summed, divided
    by 2, ``adam_step``) at tests/test_sharding.py's rtol 2e-4 / atol
    2e-6; and ``render_tile_sharded`` against ``render``."""
    import torch
    import torch.distributed as dist
    from webdgs_tpu_torch.config import quantize_budget
    from webdgs_tpu_torch.core.camera import default_camera
    from webdgs_tpu_torch.ops.adam import (AdamHyperparameters, adam_step,
                                           init_adam_state)
    from webdgs_tpu_torch.ops.loss import LossConfig
    from webdgs_tpu_torch.parallel.sharding import (dp_train_step, make_mesh,
                                                    render_tile_sharded)
    from webdgs_tpu_torch.render.renderer import render
    from webdgs_tpu_torch.train.step import compute_param_grads_tiled

    W, H = size
    mesh = make_mesh()
    try:
        check(mesh.size == 1 and mesh.device.type == "cuda" and
              dist.get_backend() == "nccl",
              f"make_mesh(): {mesh}, backend {dist.get_backend()}")
        cams = [default_camera(W, H, position=(0.1 * i, 0.0, -10.0),
                               device=dev) for i in range(2)]
        rng = np.random.default_rng(6)
        with torch.no_grad():
            pert = big.with_params({
                **big.params(),
                "means": big.means + torch.tensor(
                    rng.normal(0, 0.01, (big.capacity, 3)),
                    dtype=torch.float32, device=dev)})
            targets = torch.stack([render(pert, c, W, H, settings).image
                                   for c in cams])
            demand = max(int(render(big, c, W, H, settings)
                             .binning.expansion_entries) for c in cams)
        del pert
        cap = quantize_budget(demand * 1.2, settings.chunk,
                              settings.chunk * 8)
        kw = dict(img_w=W, img_h=H, settings=settings, entry_capacity=cap)
        opt0 = init_adam_state(big.params())
        s_cur, o_cur, _ = dp_train_step(big, opt0, cams, targets, mesh,
                                        **kw)  # warm-up
        launch_mark = kernel_counters()
        step_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s_cur, o_cur, m_cur = dp_train_step(s_cur, o_cur, cams, targets,
                                                mesh, **kw)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
        launches = {k: v for k, v in launches_since(launch_mark).items()
                    if k in TRAIN_KERNELS}
        check(all(v > 0 for v in launches.values()),
              f"a kernel of the dp step did not launch: {launches}")
        check(math.isfinite(float(m_cur["loss"])) and
              bool(torch.isfinite(s_cur.means).all()), "dp training")
        _, syncs = sync_tally(lambda: dp_train_step(s_cur, o_cur, cams,
                                                    targets, mesh, **kw))
        torch.cuda.synchronize()
        mine = {k: v for k, v in syncs.items() if "parallel/sharding" in k}
        check(not mine, f"parallel/sharding.py synchronized: {mine}")
        print(f"[dp] 1-rank NCCL mesh ({mesh.device}), 1M sh3 {W}x{H}, 2 "
              f"views per step, 3 steps after a warm-up: "
              f"{[round(t, 2) for t in step_ms]} ms/step; loss "
              f"{float(m_cur['loss']):.5f}, {int(m_cur['tile_entries'])} "
              f"entries (max of the views), capacity {cap}; one step waits "
              f"on the device {sum(syncs.values())} times {syncs}, none "
              f"from parallel/sharding.py; launches {launches}", flush=True)

        # one step against the single-device composition
        new, _, _ = dp_train_step(big, opt0, cams, targets, mesh, **kw)
        params = big.params()
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        counts = torch.zeros((big.capacity,), dtype=torch.int32, device=dev)
        for c, t in zip(cams, targets):
            _, g, aux, _ = compute_param_grads_tiled(
                big, c, t, W, H, LossConfig(), settings, parity_sh=True,
                entry_capacity=cap)
            grads = {k: grads[k] + g[k] for k in grads}
            counts = counts + aux.num_tiles
        with torch.no_grad():
            ref, _ = adam_step(params, {k: v / 2 for k, v in grads.items()},
                               opt0, AdamHyperparameters(), counts)
        over = {k: float(((new.params()[k] - ref[k]).abs()
                          - (2e-6 + 2e-4 * ref[k].abs())).max())
                for k in ref}
        err = {k: float((new.params()[k] - ref[k]).abs().max()) for k in ref}
        same = all(torch.equal(new.params()[k], ref[k]) for k in ref)
        print(f"[dp] one dp step vs the single-device composition: max abs "
              f"err {err}; bit-identical {same}", flush=True)
        check(all(v <= 0 for v in over.values()),
              f"dp step differs from the composition beyond rtol 2e-4 / "
              f"atol 2e-6: {err}")
        del new, ref, grads, s_cur, o_cur

        with torch.no_grad():
            sharded = render_tile_sharded(big, cams[0], W, H, mesh, settings)
            plain = render(big, cams[0], W, H, settings).image
        ts_err = float((sharded - plain).abs().max())
        check(sharded.shape == plain.shape and ts_err <= RAST_ATOL,
              f"render_tile_sharded max abs err {ts_err}")
        print(f"[dp] render_tile_sharded 1M sh3 {W}x{H} on 1 rank vs render:"
              f" max abs err {ts_err:.3e}", flush=True)
    finally:
        mesh.close()
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "syncs": syncs,
            "max_abs_err": max(err.values()), "bit_identical": same,
            "tile_sharded_err": ts_err}


def cli_shard_phase(tmp: str, data: str, sparse: str, shard: str,
                    device: str = "cuda") -> dict:
    """[cli]: ``python -m torch.distributed.run --nproc_per_node=1 -m
    webdgs_tpu_torch train --shard dp|gs`` with densification (events at
    10, 20, 30): exit 0, a checkpoint and a PLY of the logged point count,
    finite losses, changing point counts, and the run's kernel launches
    (its report) from 0 up for all six kernels."""
    import socket
    from webdgs_tpu_torch.io.checkpoint import load_checkpoint
    from webdgs_tpu_torch.io.ply import load_point_cloud
    ck = os.path.join(tmp, f"ck_{shard}.npz")
    ply = os.path.join(tmp, f"{shard}.ply")
    report = os.path.join(tmp, f"report_{shard}.json")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=1",
         "--master_port", str(port), "-m", "webdgs_tpu_torch", "train",
         "--shard", shard, "--points", os.path.join(sparse, "points3D.bin"),
         "--cameras", os.path.join(sparse, "images.bin"),
         os.path.join(sparse, "cameras.bin"), "--images",
         os.path.join(data, "images"), "--iterations", "30",
         "--log-every", "1", "--densify-warmup", "10",
         "--densify-interval", "10", "--densify-stop", "30",
         "--metric-threshold", "0.3", "--clone-threshold", "1",
         "--prune-opacity", "0.72", "--device", device, "--out", ck,
         "--export-ply", ply, "--report", report], capture_output=True,
        text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"train --shard {shard} exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    check(f"sharding '{shard}' over 1 device(s)" in proc.stdout,
          f"train --shard {shard} did not report its mesh")
    points = [int(x) for x in re.findall(r"points=(\d+)", proc.stdout)]
    losses = [float(x) for x in re.findall(r"loss=(\S+)", proc.stdout)]
    check(len(losses) == 30 and all(map(math.isfinite, losses)) and
          len(set(points)) > 1, f"train --shard {shard} logged points "
          f"{sorted(set(points))}, losses {losses[:3]}...")
    scene, _, meta = load_checkpoint(ck, "cpu")
    n_ply = int(load_point_cloud(ply, "cpu").num_alive())
    check(meta["iteration"] == 30 and int(scene.num_alive()) == points[-1]
          == n_ply, f"checkpoint at {meta['iteration']} of "
          f"{int(scene.num_alive())} points, PLY {n_ply}, logged "
          f"{points[-1]}")
    with open(report) as f:
        launches = json.load(f)["kernel_launches"]
    check(all(v > 0 for v in launches.values()),
          f"a kernel of train --shard {shard} did not launch: {launches}")
    print(f"[cli] torchrun --nproc_per_node=1 -m webdgs_tpu_torch train "
          f"--shard {shard}, 30 iterations with densification on 4 "
          f"synthetic 800x600 views: exit 0 in {cli_s:.1f} s; points "
          f"{points[0]} -> {points[-1]}; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; checkpoint at iteration 30 and PLY of "
          f"{n_ply} points; launches {launches}", flush=True)
    return {"launches": launches, "seconds": cli_s}


# the bench's launches in its timed window: 20 steps and 20 frames
BENCH_LAUNCHES = {"expand_fields": 40, "rasterize_tiles": 40,
                  "tile_loss_tiles": 20, "rasterize_tiles_backward": 20,
                  "segment_sum_rows": 20, "entry_counts": 0,
                  "cull_words": 40, "entry_keys": 40, "adam_step": 20}


def bench_phase(ckpt: str) -> dict:
    """[bench]: ``python -m webdgs_tpu_torch bench`` at bench.py's recipe
    and on a trained checkpoint (``WEBDGS_BENCH_CHECKPOINT``): exit 0, one
    JSON line each (printed here on a line of its own), finite positive
    rates, the metric names, and each kernel's launches in the timed window
    (``BENCH_LAUNCHES``)."""
    import torch

    from webdgs_tpu_torch.bench import card_tag
    card = card_tag(torch.cuda.get_device_name(0))
    lines = {}
    for label, extra in (("recipe", {}),
                         ("checkpoint", {"WEBDGS_BENCH_CHECKPOINT": ckpt})):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("WEBDGS_BENCH_")}
        env.update(extra)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "webdgs_tpu_torch", "bench"],
            capture_output=True, text=True, timeout=600, env=env)
        secs = time.perf_counter() - t0
        check(proc.returncode == 0, f"bench ({label}) exited "
              f"{proc.returncode}: {proc.stderr[-3000:]}")
        out = proc.stdout.strip().splitlines()
        check(len(out) == 1, f"bench ({label}) printed {out}")
        line = json.loads(out[0])
        print(f"[bench] {label}: exit 0 in {secs:.1f} s; its line:",
              flush=True)
        print(json.dumps(line), flush=True)
        check(all(math.isfinite(line[k]) and line[k] > 0 for k in (
            "value", "render_mpix_per_sec_per_chip", "step_ms",
            "frame_ms")), f"bench ({label}) rates {line}")
        tag = ("100k_splats" if label == "recipe"
               else f"trained_{line['splats']}_splats")
        check(line["metric"] == f"train_iters_per_sec_{tag}_800x600_{card}",
              f"bench ({label}) metric {line['metric']}")
        check(line["kernel_launches"] == BENCH_LAUNCHES,
              f"bench ({label}) launches {line['kernel_launches']}, want "
              f"{BENCH_LAUNCHES}")
        lines[label] = line
    return lines


def validate_phase() -> None:
    """[validate]: scripts/validate_training_torch.py at a size where two
    densify events fire (iterations 300 and 400): exit 0, the last event
    at 400, and the held-out PSNR risen."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join("scripts", "validate_training_torch.py"),
         "--iters", "600", "--views", "8", "--size", "200", "152",
         "--gt-points", "5000", "--init-points", "1000"],
        capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"validate_training_torch.py exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    event = json.loads(proc.stdout.split("last densify event:", 1)[1]
                       .splitlines()[0])
    check(event["iteration"] == 400 and res["iters"] == 600,
          f"validate: last event {event}, {res['iters']} iterations")
    check(res["psnr_holdout_final"] > res["psnr_holdout_init"],
          f"validate: held-out PSNR did not rise: {res}")
    print(f"[validate] validate_training_torch.py 600 iterations, 8 views at "
          f"200x152, 5000 ground-truth / 1000 initial points: exit 0 in "
          f"{secs:.1f} s; last densify event {event}; {res}", flush=True)


def band_loss_check(out, target, w: int, h: int, ntx: int, nty: int, cfg,
                    settings, splits=(2, 3, 4)) -> dict:
    """The band form of the tile-loss kernel at one step's forward tiles:
    for each split into D bands (the grid padded to a multiple of D, with
    the true neighbour slices as halos and garbage at the frame's
    borders), each band against its plain version (LOSS_ATOL), the bands'
    dpix reassembling the full-frame kernel's bit for bit and their
    summed metric partials within 1e-6 relative, tiles wholly below the
    frame zero; each band launch timed queued beside its bound (bytes:
    the band's 4 used tile channels, its target rows and the two slices
    in, dpix and sums out; operations: ~150 per valid pixel and
    channel)."""
    import torch
    from webdgs_tpu_torch.ops import tile_loss
    full_d, full_s = tile_loss.tile_loss_tiles(out, target, w, h, ntx, nty,
                                               cfg, settings)
    th, tw, npx = settings.tile_h, settings.tile_w, settings.tile_px
    gen = torch.Generator(device=out.device).manual_seed(7)
    res, errs, rels = {}, [], []
    for d in splits:
        rows = -(-nty // d)
        tiles = torch.cat([out, torch.zeros(((rows * d - nty) * ntx,)
                                            + tuple(out.shape[1:]),
                                            dtype=out.dtype,
                                            device=out.device)])
        dpix, sums, band_ms, band_plain_ms, bounds = [], [], [], [], []
        for b in range(d):
            band = tiles[b * rows * ntx:(b + 1) * rows * ntx]
            garbage = torch.rand((ntx, 8, 2 * tw), generator=gen,
                                 device=out.device) * 5.0
            top = (tile_loss.halo_slices(tiles[(b - 1) * rows * ntx:
                                               b * rows * ntx], ntx,
                                         settings)[0]
                   if b > 0 else garbage)
            bot = (tile_loss.halo_slices(tiles[(b + 1) * rows * ntx:
                                               (b + 2) * rows * ntx], ntx,
                                         settings)[1]
                   if b < d - 1 else garbage)
            args = (band, top, bot, target, b * rows, w, h, ntx, rows, cfg,
                    settings)
            dk, sk = tile_loss.band_tile_loss_gradient(*args)
            dp, sp = tile_loss.band_tile_loss_gradient_plain(*args)
            errs.append(float((dk - dp).abs().max()))
            rels.append(float(((sk.sum(0) - sp.sum(0)).abs()
                               / sp.sum(0).abs().clamp(min=1e-30)).max()))
            dpix.append(dk)
            sums.append(sk)
            band_ms.append(queued_ms(
                lambda a=args: tile_loss._band_tile_loss_cuda(*a), 50))
            band_plain_ms.append(cuda_ms(
                lambda a=args: tile_loss.band_tile_loss_gradient_plain(*a),
                1, warmup=1))
            h_b = max(min(h - b * rows * th, rows * th), 0)  # frame rows
            n_t = rows * ntx
            bounds.append(bound_ms(
                4 * (4 * n_t * npx + 3 * w * h_b + 2 * 4 * ntx * 2 * tw
                     + 8 * n_t * npx + 4 * n_t), 150 * 3 * w * h_b))
        dpix = torch.cat(dpix)
        same = bool(torch.equal(dpix[:ntx * nty], full_d))
        zeros = not bool(dpix[ntx * nty:].any())
        tot = torch.cat(sums).sum(0)
        sums_rel = float(((tot - full_s.sum(0)).abs()
                          / full_s.sum(0).abs().clamp(min=1e-30)).max())
        check(same and zeros and sums_rel <= 1e-6,
              f"band tile loss, {d} bands: dpix bit-identical {same}, "
              f"padding zero {zeros}, sums rel err {sums_rel}")
        res[d] = {"rows": rows, "band_ms": band_ms,
                  "band_plain_ms": band_plain_ms,
                  "bound_ms": [x[0] for x in bounds],
                  "bound_by": [x[1] for x in bounds], "sums_rel": sums_rel}
        print(f"[gs] band tile loss, 1M sh3 {w}x{h} step split into {d} "
              f"bands of {rows} tile rows (garbage halos at the borders): "
              f"dpix bit-identical to the full-frame kernel, padding tiles "
              f"zero, summed partials rel err {sums_rel:.2e}; band kernel "
              f"queued {[round(x, 4) for x in band_ms]} ms (full frame "
              f"split), plain {[round(x, 3) for x in band_plain_ms]} ms; "
              f"bound {[round(x[0], 4) for x in bounds]} ms "
              f"({bounds[0][1]})", flush=True)
    err, rel = max(errs), max(rels)
    check(err <= LOSS_ATOL and rel <= 1e-5,
          f"band tile loss vs its plain version: dpix err {err}, sums rel "
          f"err {rel}")
    print(f"[gs] band tile loss vs its plain version, every band of the 3 "
          f"splits: max abs err {err:.3e} (<= {LOSS_ATOL}), sums rel err "
          f"{rel:.2e}", flush=True)
    two = res[2]
    return {"max_abs_err": err, "sums_rel_err": rel,
            "bit_identical_to_full_frame": True,
            # the frame in two bands: both launches
            "ms": sum(two["band_ms"]), "plain_ms": sum(two["band_plain_ms"]),
            "bound_ms": sum(two["bound_ms"]), "bound_by": two["bound_by"][0],
            "library_ms": None, "splits": res}


def gs_phase(dev, big, settings, size=(1920, 1080)) -> dict:
    """[gs]: the Gaussian-sharded path on a 1-rank NCCL group (the one
    card holds the one shard): the band tile loss at the 1M sh3 step's
    forward tiles (band_loss_check); ``render_gaussian_sharded`` with the
    f32 exchange against ``render`` and with the f16 exchange at the
    reference test's f16 class (max < 2e-2, mean < 2e-4), no drops, ms
    per frame; 3 ``gs_train_step``s on a perturbed target through all
    five training kernels (counters reset just before), ms per step, peak
    memory, one step's synchronizing calls by line (none), the
    adaptive-capacity metrics;
    one f32 step against ``train_step`` (rtol 2e-4 / atol 2e-6) and twice
    from one state (bit-identical), the f16 step's loss within rtol 2e-3;
    and one step on a 1x1 dp x band mesh."""
    import torch
    import torch.distributed as dist
    import dataclasses
    from webdgs_tpu_torch.config import quantize_budget
    from webdgs_tpu_torch.core.camera import default_camera
    from webdgs_tpu_torch.ops import binning
    from webdgs_tpu_torch.ops.adam import init_adam_state
    from webdgs_tpu_torch.ops.loss import LossConfig
    from webdgs_tpu_torch.ops.projection import project_gaussians
    from webdgs_tpu_torch.parallel.sharding import (gaussian_shard,
                                                    gs_train_step, make_mesh,
                                                    render_gaussian_sharded)
    from webdgs_tpu_torch.render.renderer import render, render_from_attrs
    from webdgs_tpu_torch.train.step import train_step

    W, H = size
    exact = dataclasses.replace(settings, exchange_f16=False)
    cam = default_camera(W, H, position=(0.0, 0.0, -10.0), device=dev)
    rng = np.random.default_rng(6)
    with torch.no_grad():
        pert = big.with_params({
            **big.params(),
            "means": big.means + torch.tensor(
                rng.normal(0, 0.01, (big.capacity, 3)), dtype=torch.float32,
                device=dev)})
        target = render(pert, cam, W, H, settings).image
        del pert
        ref = render(big, cam, W, H, settings)
        demand = int(ref.binning.expansion_entries)
        attrs, aux = project_gaussians(big.params(), big.alive, cam, W, H,
                                       big.sh_deg, settings)
        out, _ = render_from_attrs(attrs, aux, W, H, settings)
        del attrs, aux
    cap = quantize_budget(demand * 1.2, settings.chunk, settings.chunk * 8)
    ntx, nty = binning.tile_grid(W, H, settings)
    band = band_loss_check(out, target, W, H, ntx, nty, LossConfig(),
                           settings)
    del out
    torch.cuda.empty_cache()

    mesh = make_mesh()
    try:
        check(mesh.size == 1 and mesh.band_size == 1 and
              dist.get_backend() == "nccl", f"make_mesh(): {mesh}")
        shard = gaussian_shard(big, mesh)
        img = {}
        for name, st in (("f32", exact), ("f16", settings)):
            img[name], dropped = render_gaussian_sharded(shard, cam, W, H,
                                                         mesh, st)
            check(int(dropped) == 0, f"gs render ({name}) dropped "
                  f"{int(dropped)}")
        frame_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render_gaussian_sharded(shard, cam, W, H, mesh, settings)
            torch.cuda.synchronize()
            frame_ms.append(1e3 * (time.perf_counter() - t0))
        r_err = float((img["f32"] - ref.image).abs().max())
        r_same = bool(torch.equal(img["f32"], ref.image))
        e16 = (img["f16"] - ref.image).abs()
        f16_max, f16_mean = float(e16.max()), float(e16.mean())
        print(f"[gs] render_gaussian_sharded 1M sh3 {W}x{H}, 1 rank: f32 "
              f"exchange vs render max abs err {r_err:.3e}, bit-identical "
              f"{r_same}; f16 exchange max {f16_max:.3e} (< 2e-2), mean "
              f"{f16_mean:.3e} (< 2e-4); 0 dropped; f16 frames "
              f"{[round(t, 2) for t in frame_ms]} ms", flush=True)
        check(r_err <= RAST_ATOL and f16_max < 2e-2 and f16_mean < 2e-4,
              f"gs render: f32 err {r_err}, f16 max {f16_max} mean "
              f"{f16_mean}")
        del img, ref, e16
        torch.cuda.empty_cache()

        opt0 = init_adam_state(shard.params())
        kw = dict(img_w=W, img_h=H, settings=settings, entry_capacity=cap)
        s_cur, o_cur, _ = gs_train_step(shard, opt0, cam, target, mesh,
                                        **kw)  # warm-up
        launch_mark = kernel_counters()
        torch.cuda.reset_peak_memory_stats()
        step_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s_cur, o_cur, m_cur = gs_train_step(s_cur, o_cur, cam, target,
                                                mesh, **kw)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
        launches = {k: v for k, v in launches_since(launch_mark).items()
                    if k in TRAIN_KERNELS}
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        check(all(v > 0 for v in launches.values()),
              f"a kernel of the gs step did not launch: {launches}")
        check(math.isfinite(float(m_cur["loss"])) and
              bool(torch.isfinite(s_cur.means).all()), "gs training")
        adapt = {k: int(m_cur[k]) for k in ("entries_dropped",
                                            "entries_local_max", "send_max",
                                            "tile_entries", "visible")}
        _, syncs = sync_tally(lambda: gs_train_step(s_cur, o_cur, cam,
                                                    target, mesh, **kw))
        torch.cuda.synchronize()
        check(not syncs, f"the gs step synchronized: {syncs}")
        print(f"[gs] gs_train_step 1M sh3 {W}x{H}, 1-rank NCCL band group, "
              f"3 steps after a warm-up: {[round(t, 2) for t in step_ms]} "
              f"ms/step; peak {peak_gb:.2f} GiB; loss "
              f"{float(m_cur['loss']):.5f}; capacity {cap}; {adapt}; one "
              f"step waits on the device {sum(syncs.values())} times "
              f"{syncs}; launches "
              f"{launches}", flush=True)
        del s_cur, o_cur

        # one step against train_step; twice from one state; f16
        ref_s = train_step(big, init_adam_state(big.params()), cam, target,
                           **kw)
        ref_p = ref_s.scene.params()
        ref_m, ref_loss = ref_s.opt_state.m, float(ref_s.metrics["loss"])
        del ref_s
        g1 = gs_train_step(shard, opt0, cam, target, mesh,
                           **{**kw, "settings": exact})
        g2 = gs_train_step(shard, opt0, cam, target, mesh,
                           **{**kw, "settings": exact})
        repeat = all(torch.equal(g1.scene.params()[k], g2.scene.params()[k])
                     for k in ref_p) and torch.equal(g1.opt_state.m,
                                                     g2.opt_state.m)
        del g2
        err = {k: float((g1.scene.params()[k] - ref_p[k]).abs().max())
               for k in ref_p}
        over = {k: float(((g1.scene.params()[k] - ref_p[k]).abs()
                          - (2e-6 + 2e-4 * ref_p[k].abs())).max())
                for k in ref_p}
        same = all(torch.equal(g1.scene.params()[k], ref_p[k])
                   for k in ref_p) and torch.equal(g1.opt_state.m, ref_m)
        del g1
        g16 = gs_train_step(shard, opt0, cam, target, mesh, **kw)
        loss16 = float(g16.metrics["loss"])
        del g16
        print(f"[gs] one f32 gs step vs train_step: max abs err {err}; "
              f"bit-identical (params and moments) {same}; two runs from "
              f"one state bit-identical {repeat}; f16 step loss {loss16:.6f}"
              f" vs {ref_loss:.6f} (rel {abs(loss16 - ref_loss) / ref_loss:.2e})",
              flush=True)
        check(all(v <= 0 for v in over.values()),
              f"gs step differs from train_step beyond rtol 2e-4 / atol "
              f"2e-6: {err}")
        check(repeat, "two gs steps from one state differ")
        check(abs(loss16 - ref_loss) <= 2e-3 * abs(ref_loss),
              f"f16 gs step loss {loss16} vs {ref_loss}")
        del ref_p, ref_m
        torch.cuda.empty_cache()

        mesh2 = make_mesh(shape=(1, 1))
        check(mesh2.dp_group is not None and mesh2.band_size == 1,
              f"make_mesh(shape=(1, 1)): {mesh2}")
        g2d = gs_train_step(shard, opt0, [cam], target[None], mesh2, **kw)
        loss2d = float(g2d.metrics["loss"])
        check(math.isfinite(loss2d) and
              bool(torch.isfinite(g2d.scene.means).all()), "gs 2D step")
        print(f"[gs] gs_train_step on a 1x1 dp x band mesh (NCCL band and dp "
              f"groups): loss {loss2d:.6f}", flush=True)
        del g2d
    finally:
        mesh.close()
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "frame_ms": frame_ms,
            "peak_gb": peak_gb, "syncs": syncs, "adapt": adapt,
            "render_err": r_err, "render_bit_identical": r_same,
            "f16_max": f16_max, "f16_mean": f16_mean, "step_err": err,
            "step_bit_identical": same, "band": band}


def gs_train_phase(dev, s1m, n: int = 1_000_000,
                   size: tuple[int, int] = (1920, 1080)) -> dict:
    """[gs-train]: GsTrainer on a 1-rank NCCL band group beside a Trainer
    of the same seed, over the densify run's scene, views and config
    (densify_setup: 1M sh3, 10 views at 1920x1080, events at iterations 2
    and 4), 5 steps each, with the f32 entry exchange.  After both events
    the GsTrainer's parameters,
    moments and alive mask must equal the Trainer's bit for bit, with its
    losses and its events' counts.  Records ms per step and per event
    (host clock, synchronized), peak memory, each step's and each event's
    synchronizing calls by line, and the kernels' launches per step and
    per event (every counter reset just before the GsTrainer's run); the
    Trainer's ms per step and per event beside them."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from webdgs_tpu_torch.parallel.gs_trainer import GsTrainer
    from webdgs_tpu_torch.parallel.sharding import make_mesh
    from webdgs_tpu_torch.train.trainer import Trainer

    W, H = size
    # the f32 exchange: the f16 one rounds the entry rows on their way to
    # the band's owner, even with one band
    s1m = dataclasses.replace(s1m, exchange_f16=False)
    big, cams, imgs, cfg = densify_setup(dev, s1m, n, size)
    keys = ("iteration", "in", "out", "cloned", "split", "pruned")
    ref = Trainer(big, cams, imgs, cfg, s1m)
    ref_events, ref_ms = [], []
    ref_densify = ref._densify_event

    def recorded(w_, h_):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_densify(w_, h_)
        torch.cuda.synchronize()
        ref_events.append({k: ref.last_densify_event[k] for k in keys})
        ref_events[-1]["ms"] = 1e3 * (time.perf_counter() - t0)

    ref._densify_event = recorded
    ref_losses = []
    for _ in range(5):
        n_ev = len(ref_events)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_losses.append(ref.step()["loss"])
        torch.cuda.synchronize()
        ref_ms.append(1e3 * (time.perf_counter() - t0) - (
            ref_events[-1]["ms"] if len(ref_events) > n_ev else 0.0))
    ref_losses = [float(x) for x in ref_losses]
    ref_event_ms = [ev.pop("ms") for ev in ref_events]

    mesh = make_mesh(axis_name="band")
    try:
        check(mesh.size == 1 and mesh.band_size == 1 and
              dist.get_backend() == "nccl", f"make_mesh(): {mesh}")
        tr = GsTrainer(big, cams, imgs, cfg, s1m, mesh=mesh)
        del big, imgs
        events = []
        run_densify = tr._densify_event

        def timed_densify(w_, h_):
            torch.cuda.synchronize()
            before = (kernel_counters(), tr.num_points, tr.capacity)
            t0 = time.perf_counter()
            _, syncs = sync_tally(lambda: run_densify(w_, h_))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            after = kernel_counters()
            events.append({
                "ms": ms, "syncs": syncs,
                "launches": {k: after[k] - before[0][k] for k in after},
                "points": (before[1], tr.num_points),
                "capacity": (before[2], tr.capacity),
                **{k: tr.last_densify_event[k] for k in keys}})

        tr._densify_event = timed_densify
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launch_mark = kernel_counters()
        steps, losses = [], []
        for _ in range(5):
            n_ev = len(events)
            before = kernel_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics, syncs = sync_tally(tr.step)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            after = kernel_counters()
            launches = {k: after[k] - before[k] for k in after}
            if len(events) > n_ev:  # the step's own share
                ms -= events[-1]["ms"]
                launches = {k: v - events[-1]["launches"][k]
                            for k, v in launches.items()}
            steps.append({"ms": ms, "syncs": syncs, "launches": launches})
            losses.append(float(metrics["loss"]))
        launches = launches_since(launch_mark)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

        full, fopt = tr.full_scene(), tr.full_opt_state()
        same = {k: torch.equal(full.params()[k], ref.scene.params()[k])
                for k in full.params()}
        same["alive"] = torch.equal(full.alive, ref.scene.alive)
        same["m"] = torch.equal(fopt.m, ref.opt_state.m)
        same["v"] = torch.equal(fopt.v, ref.opt_state.v)
        got_events = [{k: ev[k] for k in keys} for ev in events]
        print(f"[gs-train] GsTrainer {n} sh3 {W}x{H}, 1-rank NCCL band group"
              f", 5 steps with events at iterations 2 and 4 beside a "
              f"Trainer of the same seed: bit-identical {same}; losses "
              f"{losses} (Trainer {ref_losses}); events {got_events} "
              f"(Trainer {ref_events}); points {tr.num_points} (Trainer "
              f"{ref.num_points}); capacity {tr.capacity}", flush=True)
        for i, st in enumerate(steps):
            print(f"[gs-train] step {i + 1}: {st['ms']:.2f} ms host "
                  f"(synchronized, its event excluded; the Trainer's "
                  f"{ref_ms[i]:.2f}); "
                  f"{sum(st['syncs'].values())} waits {st['syncs']}; "
                  f"launches {st['launches']}", flush=True)
        for i, ev in enumerate(events):
            print(f"[gs-train] event {i + 1} at iteration {ev['iteration']}"
                  f": {ev['ms']:.2f} ms host (synchronized; the Trainer's "
                  f"{ref_event_ms[i]:.2f}); points "
                  f"{ev['points'][0]} -> {ev['points'][1]}; capacity "
                  f"{ev['capacity'][0]} -> {ev['capacity'][1]}; cloned "
                  f"{ev['cloned']}, split {ev['split']}, pruned "
                  f"{ev['pruned']}; {sum(ev['syncs'].values())} waits "
                  f"{ev['syncs']}; launches {ev['launches']}", flush=True)
        print(f"[gs-train] 5 steps + 2 events: launches {launches}; peak "
              f"device memory {peak_gb:.2f} GiB; caps entry "
              f"{tr._shard_entries.value}, send {tr._send.value}",
              flush=True)
        check(len(events) == 2, f"expected 2 gs events, got {len(events)}")
        check(all(v > 0 for v in launches.values()),
              f"a kernel did not launch in the GsTrainer run: {launches}")
        # the event's one read is the .tolist() of Trainer._densify_event,
        # which both trainers run; the GsTrainer's hooks wait nowhere
        import inspect
        src, first = inspect.getsourcelines(Trainer._densify_event)
        event_read = "webdgs_tpu_torch/train/trainer.py:%d" % (first + next(
            i for i, line in enumerate(src) if ".tolist()" in line))
        for ev in events:
            check(ev["cloned"] > 0 and ev["split"] > 0 and ev["pruned"] > 0
                  and ev["points"][1] != ev["points"][0],
                  f"gs event did not clone, split and prune: {ev}")
            mine = {k: v for k, v in ev["syncs"].items()
                    if any(f"{m}.py" in k for m in (
                        "ops/segsum", "ops/rasterize", "ops/importance",
                        "parallel/sharding", "parallel/gs_trainer"))}
            own = sum(v for k, v in ev["syncs"].items()
                      if k.endswith(event_read))
            check(not mine and own == 1, f"the gs event waits: "
                  f"{ev['syncs']}")
        check(events[0]["capacity"][1] > events[0]["capacity"][0],
              f"capacity did not grow: {events[0]}")
        for i, st in enumerate(steps):
            mine = {k: v for k, v in st["syncs"].items()
                    if "parallel/" in k and (i > 0 or "sharding" in k)}
            check(not mine, f"gs step {i + 1} waits: {st['syncs']}")
            check(all(st["launches"][k] == 1 for k in TRAIN_KERNELS),
                  f"gs step {i + 1} launches {st['launches']}")
        check(all(same.values()) and losses == ref_losses and
              got_events == ref_events and tr.num_points == ref.num_points,
              "the 1-rank GsTrainer differs from the Trainer")
        del tr, full, fopt
    finally:
        mesh.close()
    del ref
    torch.cuda.empty_cache()
    return {"launches": launches, "steps": steps, "events": events,
            "peak_gb": peak_gb, "bit_identical": same, "ref_ms": ref_ms,
            "ref_event_ms": ref_event_ms}


def main(argv: list[str] | None = None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before-segsum", metavar="SEGSUM_CU",
                    help="an earlier csrc/segsum.cu (commit 8c7f768's "
                    "interface) to time and compare beside the segment-sum "
                    "kernel at both of its shapes")
    ap.add_argument("--before-bwd", metavar="RASTERIZE_BWD_CU",
                    help="an earlier csrc/rasterize_bwd.cu (the interface "
                    "of commits 0779f1e to 3554122) to time beside the "
                    "backward kernel at both of its shapes")
    ap.add_argument("--ablate-bwd", action="store_true",
                    help="also time BWD_VARIANTS of the backward kernel "
                    "(and BEFORE_BWD_VARIANTS of the --before-bwd source) "
                    "at both of its shapes")
    ap.add_argument("--before-fwd", metavar="RASTERIZE_FWD_CU",
                    help="an earlier csrc/rasterize_fwd.cu (the interface "
                    "of commits 6e479fc to 217963e) to time beside the "
                    "forward kernel at its three shapes; all 8 channels "
                    "must be bit-identical")
    ap.add_argument("--ablate-fwd", action="store_true",
                    help="also time FWD_VARIANTS of the forward kernel at "
                    "the bench and 1M frames")
    ap.add_argument("--before-imp", metavar="IMPORTANCE_CU",
                    help="an earlier csrc/importance.cu (the interface of "
                    "commits 8c7f768 to 2efee97) to time beside the "
                    "importance kernel at both metric views; every slot "
                    "must be equal")
    ap.add_argument("--ablate-imp", action="store_true",
                    help="also time IMP_VARIANTS of the importance kernel "
                    "at both metric views")
    ap.add_argument("--before-expand", metavar="EXPAND_CU",
                    help="an earlier csrc/expand.cu (every commit's "
                    "interface) to time beside the expand kernel at its "
                    "three shapes; every slot must be equal")
    ap.add_argument("--ablate-expand", action="store_true",
                    help="also time EXPAND_VARIANTS of the expand kernel at "
                    "its three shapes")
    ap.add_argument("--ablate-loss", action="store_true",
                    help="also time LOSS_VARIANTS of the tile-loss kernel "
                    "at both training steps")
    ap.add_argument("--before-loss", metavar="TILE_LOSS_CU",
                    help="an earlier csrc/tile_loss.cu (every commit's "
                    "interface) to time beside the tile-loss kernel at "
                    "both training steps; dpix must be bit-identical")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    # --- 1. device ---
    from webdgs_tpu_torch.bench import card_name
    dev = torch.device("cuda")
    card = card_name(dev)
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()}",
          flush=True)

    # --- 2. build ---
    from webdgs_tpu_torch import _build
    t0 = time.perf_counter()
    lib_path, log = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"[build] {build_s:.2f} s ({'compiled' if log is not None else 'reused'}"
          f" {lib_path.name})", flush=True)
    for line in (log or "").splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print(f"[build] {line.strip()}")
    if args.before_segsum:
        global BEFORE_SEGSUM
        BEFORE_SEGSUM = build_before_segsum(args.before_segsum)
        print(f"[build] the earlier segment-sum kernel {args.before_segsum}",
              flush=True)
    befores = {"bwd": args.before_bwd, "fwd": args.before_fwd,
               "imp": args.before_imp, "expand": args.before_expand,
               "loss": args.before_loss}
    jobs = [(kind, "before", path, ()) for kind, path in befores.items()
            if path]
    if args.ablate_bwd:
        jobs += [("bwd", n, _build.CSRC / "rasterize_bwd.cu", subs)
                 for n, subs in BWD_VARIANTS.items()]
        if args.before_bwd:
            jobs += [("bwd", f"before_{n}", args.before_bwd, subs)
                     for n, subs in BEFORE_BWD_VARIANTS.items()]
    if args.ablate_fwd:
        jobs += [("fwd", n, _build.CSRC / "rasterize_fwd.cu", subs)
                 for n, subs in FWD_VARIANTS.items()]
    if args.ablate_imp:
        jobs += [("imp", n, _build.CSRC / "importance.cu", subs)
                 for n, subs in IMP_VARIANTS.items()]
    if args.ablate_expand:
        jobs += [("expand", n, _build.CSRC / "expand.cu", subs)
                 for n, subs in EXPAND_VARIANTS.items()]
    if args.ablate_loss:
        jobs += [("loss", n, _build.CSRC / "tile_loss.cu", subs)
                 for n, subs in LOSS_VARIANTS.items()]
    if jobs:
        built = build_variants(jobs)
        for kind, path in befores.items():
            if path:
                BEFORE[kind], regs = built.pop((kind, "before"))
                print(f"[build] the earlier {kind} kernel {path}: {regs} "
                      "registers", flush=True)
        for kind, table in (("bwd", BWD_ABLATIONS), ("fwd", FWD_ABLATIONS),
                            ("imp", IMP_ABLATIONS),
                            ("expand", EXPAND_ABLATIONS),
                            ("loss", LOSS_ABLATIONS)):
            table.update({n: v for (k, n), v in built.items() if k == kind})
            if table:
                print(f"[build] {kind} variants: {sorted(table)}",
                      flush=True)

    import torch.nn.functional as F
    from webdgs_tpu_torch.bench import bench_scene, entry_capacity
    from webdgs_tpu_torch.config import RenderSettings, quantize_budget
    from webdgs_tpu_torch.core.camera import default_camera
    from webdgs_tpu_torch.ops import binning, rasterize, segsum, tile_loss
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

    exp_bench = expand_check(f"{w}x{h} bench frame", words, counts, e_cap,
                             20, no_slower=True)

    # the forward kernel at the viewer's capacity for the bench frame
    fwd = forward_check(f"{w}x{h} bench frame", attrs16, bins.tile_offsets,
                        ntx, nty, settings, 20, 3, ablate=True)
    del words, counts

    # --- 3b. the training kernels at the bench training step's inputs ---
    # capacity as bench.py sizes it: 1.2x the observed entries
    cap = entry_capacity(demand, settings.chunk)
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

    # the tile cull at the bench training step's capacity
    cull_bench = cull_check(f"{w}x{h} training step", attrs, aux, ntx, cap,
                            settings, 5)
    loss_bench = loss_check(f"{w}x{h} training step", tout, target_n, w, h,
                            ntx, nty, cfg, settings, 5)
    dk, _ = tile_loss.tile_loss_tiles(tout, target_n, w, h, ntx, nty, cfg,
                                      settings)
    suffix = (torch.sum(dk[:, 0:4] * tout[:, 0:4], dim=1, keepdim=True)
              + dk[:, 4:5] * tout[:, 4:5])
    gpix5 = torch.cat([dk[:, 0:4], suffix], dim=1).contiguous()
    toff = tbins.tile_offsets
    with torch.no_grad():
        tfwd = rasterize.rasterize_tiles(t16, toff, ntx, nty, settings)
    bwd = backward_check(f"{w}x{h} training step", {
        "attrs16": t16, "tile_offsets": toff, "gpix5": gpix5, "ntx": ntx,
        "nty": nty, "fwd": tfwd, "entries": int(tbins.total_entries)},
        settings, 20, 1)
    bk = rasterize.rasterize_tiles_backward(t16, toff, gpix5, ntx, nty,
                                            settings)
    # the raster's whole path, the public forward wrapper and autograd's
    # backward included, never waits for the device: in sync debug mode
    # "error" a synchronizing call raises
    a16g = t16.detach().requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fwd_g = rasterize.rasterize_tiles(a16g, toff, ntx, nty, settings,
                                          track_ncontrib=False)
        (g_auto,) = torch.autograd.grad(fwd_g, a16g, dk)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(torch.equal(g_auto, bk), "the backward through autograd differs "
          "from rasterize_tiles_backward")
    check(torch.equal(fwd_g.detach(), tout), "the public forward differs "
          "from the training step's tiles")
    print("[kernels] rasterize_tiles + autograd backward ran in sync debug "
          "mode \"error\" (no synchronizing call); the forward equals the "
          "step's tiles and the gradient the wrapper's rows bit for bit",
          flush=True)

    seg = segsum_check(f"{w}x{h} training step", bk, tbins.gauss_counts,
                       tbins.entry_source, tbins.entry_valid,
                       tbins.expansion_gauss, 5)
    idx_bench = indexed_check(f"{w}x{h} training step", attrs, tbins, ntx,
                              nty, settings, 20)
    del dk, bk, tfwd, a16g, fwd_g, g_auto
    torch.cuda.empty_cache()

    # Adam at the bench step's gradients (the perturbed target), and at the
    # largest training cell's 2,961,408 rows
    from webdgs_tpu_torch.ops.adam import AdamHyperparameters
    from webdgs_tpu_torch.train.step import compute_param_grads_tiled
    _, agrads, aaux, _ = compute_param_grads_tiled(
        scene, cam, target_n, w, h, cfg, settings, parity_sh=True,
        entry_capacity=cap)
    agrads = {k: v.detach() for k, v in agrads.items()}
    adam_bench = adam_check(
        f"{w}x{h} training step", scene.params(), agrads, aaux.num_tiles,
        {"dc": AdamHyperparameters(),
         "full_sh": AdamHyperparameters(full_sh=True, bias_correction=True,
                                        lr_pos_final=1.6e-6)}, 5)
    del agrads, aaux
    adam_big = adam_check(
        "2,961,408 random rows", *random_adam_rows(2_961_408, dev, 5),
        {"dc": AdamHyperparameters(),
         "full_sh": AdamHyperparameters(full_sh=True)}, 2)
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
    margs, mtotal, mbins, mattrs = metric_view_inputs(
        scene, mcam, tgt, mw, mh, 0.5, settings)
    imp_bench = importance_check(f"{mw}x{mh} bench view", margs, mtotal, 5,
                                 host_bound=True)
    idx_bench_view = indexed_check(f"{mw}x{mh} bench view", mattrs, mbins,
                                   margs[3], margs[4], settings, 20,
                                   pix_tiles=margs[2])
    del margs, mbins, mattrs

    # --- 4. the viewer slice: frames through the render kernels ---
    viewer = Viewer(scene, w, h, settings, device="cuda")
    viewer.control.position = np.array([0.0, 0.0, -8.0], np.float32)
    launch_mark = kernel_counters()
    packed_mark = packed_calls()
    frame_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        img = viewer.render()  # returns host numpy: synchronized
        frame_s.append(time.perf_counter() - t0)
    launches = {k: v for k, v in launches_since(launch_mark).items()
                if k in VIEWER_KERNELS}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path did not launch: {launches}")
    packed_viewer = packed_calls() - packed_mark
    check(packed_viewer == 0, f"the Viewer's frames packed entry rows "
          f"{packed_viewer} times")
    check(img.shape == (h, w, 3) and bool(np.isfinite(img).all()),
          "viewer frame is not a finite 600x800x3 image")
    lit = float((img.max(axis=2) > 0.02).mean())
    check(lit > 0.05, f"viewer frame is almost all background ({lit:.3f})")
    steady_ms = 1e3 * float(np.mean(frame_s[1:]))
    print(f"[slice] Viewer 100k 800x600: frames {[round(1e3 * s, 2) for s in frame_s]} ms; "
          f"steady {steady_ms:.2f} ms/frame, "
          f"{w * h / steady_ms / 1e3:.1f} Mpix/s; {lit:.3f} of pixels lit; "
          f"launches {launches}; raster.packed_calls {packed_viewer}",
          flush=True)

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
    launch_mark = kernel_counters()
    packed_mark = packed_calls()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        s_cur, o_cur, m_cur = train_step(s_cur, o_cur, cam, own, img_w=w,
                                         img_h=h, settings=settings,
                                         entry_capacity=cap)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 20 * 1e3
    train_launches = {k: v for k, v in launches_since(launch_mark).items()
                      if k in TRAIN_KERNELS}
    check(all(v > 0 for v in train_launches.values()),
          f"a kernel of the training path did not launch: {train_launches}")
    packed_train = packed_calls() - packed_mark
    check(packed_train == 0, f"the training steps packed entry rows "
          f"{packed_train} times")
    finite = all(bool(torch.isfinite(v).all())
                 for v in s_cur.params().values())
    check(finite and math.isfinite(float(m_cur["loss"])),
          "training produced non-finite parameters or loss")
    check(int(m_cur["tile_entries"]) > 0, "training step binned nothing")
    # one step's synchronizing calls, by line; none may come from the
    # backward raster
    _, step_syncs = sync_tally(lambda: train_step(
        s_cur, o_cur, cam, own, img_w=w, img_h=h, settings=settings,
        entry_capacity=cap))
    torch.cuda.synchronize()
    bwd_syncs = {k: v for k, v in step_syncs.items()
                 for f, a, b in backward_wrapper_lines()
                 if k.rsplit(":", 1)[0] == f and a <= int(k.rsplit(":", 1)[1])
                 <= b}
    check(not bwd_syncs, f"the backward raster synchronized: {bwd_syncs}")
    rast_syncs = {k: v for k, v in step_syncs.items()
                  if "ops/rasterize.py" in k or "ops/adam.py" in k}
    check(not rast_syncs, f"ops/rasterize.py or ops/adam.py synchronized: "
          f"{rast_syncs}")
    print(f"[train] one bench train_step waits on the device "
          f"{sum(step_syncs.values())} times {step_syncs}; none from "
          f"ops/rasterize.py or ops/adam.py", flush=True)
    print(f"[train] bench 100k 800x600, 20 train_steps after 2 warm-up: "
          f"{step_ms:.2f} "
          f"ms/step, {1e3 / step_ms:.2f} it/s; loss "
          f"{float(m_cur['loss']):.6f}, {int(m_cur['visible'])} visible, "
          f"{int(m_cur['tile_entries'])} entries; launches {train_launches}; "
          f"raster.packed_calls {packed_train}", flush=True)

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
    # the backward kernel at this step's inputs
    inp1m = backward_step_inputs(big, cam1m, 1920, 1080, s1m, cap1m,
                                 target1m)
    # the forward kernel at the same frame (the step's capacity)
    fwd1m = forward_check("1M sh3 1920x1080 frame", inp1m["attrs16"],
                          inp1m["tile_offsets"], inp1m["ntx"], inp1m["nty"],
                          s1m, 10, 1, ablate=True, ties=True)
    bwd1m = backward_check("1M sh3 1920x1080 training step", inp1m, s1m, 5,
                           1)
    idx1m = indexed_check("1M sh3 1920x1080 training step", inp1m["attrs"],
                          inp1m["bins"], inp1m["ntx"], inp1m["nty"], s1m, 5)
    # the tile loss at the same step, and the expansion of that frame
    loss1m = loss_check("1M sh3 1920x1080 training step", inp1m["fwd"],
                        target1m, 1920, 1080, inp1m["ntx"], inp1m["nty"],
                        LossConfig(), s1m, 1)
    del inp1m
    exp1m = expand_check(
        "1M sh3 1920x1080 frame",
        *expansion_at(big, cam1m, 1920, 1080, s1m, cap1m), 1)
    cull1m = cull_check(
        "1M sh3 1920x1080 frame",
        *binning_inputs_at(big, cam1m, 1920, 1080, s1m, cap1m), s1m, 1)
    torch.cuda.empty_cache()
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
    del s_big, o_big
    full_sh_step_check(big, cam1m, target1m, 1920, 1080, s1m, cap1m)
    del v1m, img1m, target1m
    torch.cuda.empty_cache()

    # --- 6b. the serial-band renderer at DCI 8K; 6c. data parallelism ---
    banded_res = banded_phase(dev, big, s1m)
    dp_res = dp_phase(dev, big, s1m)
    gs_res = gs_phase(dev, big, s1m)
    del big
    torch.cuda.empty_cache()

    densify_res = densify_phase(dev, s1m)
    small_event_phase(dev, settings)
    gs_train_res = gs_train_phase(dev, s1m)

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
        cli_dp_res = cli_shard_phase(tmp, data, sparse, "dp")
        cli_gs_res = cli_shard_phase(tmp, data, sparse, "gs")
        live_server_phase(dev, data, sparse)
        bench_res = bench_phase(ck)
    validate_phase()

    dlaunch = densify_res["launches"]
    imp = densify_res["importance"]
    dseg = densify_res["segsum"]
    dfwd = densify_res["forward"]

    def reading(r):
        # one forward_check reading for the kernels line
        return {"max_abs_err": r["err"],
                "max_abs_err_outside_ties": r["err_outside_ties"],
                "tie_pixels": r["tie_pixels"], "nc_mismatch": r["nc_mismatch"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": None, "device_ms": r["device_ms"],
                "pairs": r["pairs"], "tile_work": r["tile_work"],
                "before": r.get("before")}

    # the train command's report names the wrappers, this line the kernels
    cli_dp_launches = {name: cli_dp_res["launches"][fn]
                       for fn, name in KERNEL_COUNTERS}
    cli_gs_launches = {name: cli_gs_res["launches"][fn]
                       for fn, name in KERNEL_COUNTERS}
    bench_launches = {name: bench_res["recipe"]["kernel_launches"][fn]
                      for fn, name in KERNEL_COUNTERS}

    def entry(name, source, replaces, err, ms, plain_ms, bound, lib_ms,
              **extra):
        # launches: the training path's 20 steps; launches_densify: the
        # densify run's 4 steps and 2 events; launches_banded: 6
        # render_banded frames at 8K; launches_dp: 3 dp steps of 2 views;
        # launches_gs: 3 gs_train_steps on one rank; launches_gs_trainer:
        # the GsTrainer's 5 steps and 2 events (its per step and per event
        # beside them); launches_cli_dp / launches_cli_gs: the train --shard
        # dp / gs command's 30 iterations; launches_bench: the bench
        # command's 20 timed steps and 20 frames
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": train_launches.get(name, dlaunch[name]),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": lib_ms, "launches_densify": dlaunch[name],
                "launches_banded": banded_res["launches"].get(name, 0),
                "launches_dp": dp_res["launches"].get(name, 0),
                "launches_gs": gs_res["launches"].get(name, 0),
                "launches_cli_dp": cli_dp_launches[name],
                "launches_gs_trainer": gs_train_res["launches"][name],
                "launches_gs_trainer_per_step":
                    gs_train_res["steps"][-1]["launches"][name],
                "launches_gs_trainer_per_event":
                    gs_train_res["events"][-1]["launches"][name],
                "launches_cli_gs": cli_gs_launches[name],
                "launches_bench": bench_launches[name],
                **extra}

    def expand_reading(r):
        # one expand_check reading for the kernels line
        return {"max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                "bound_by": r["bound"][1], "library_ms": None,
                "device_ms": r["device_ms"],
                "kernel_device_ms": r["kernel_device_ms"],
                "slots": r["slots"], "valid": r["valid"],
                "launch": r["launch"], "before": r.get("before")}

    def loss_reading(r):
        # one loss_check reading for the kernels line
        return {"max_abs_err": r["err"], "sums_rel_err": r["sums_rel"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": None, "device_ms": r["device_ms"],
                "launch": r["launch"], "before": r.get("before")}

    def cull_reading(r, name):
        # one cull_check reading of one of its kernels for the kernels line
        k = r[name]
        return {"max_abs_err": k["err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound"][0],
                "bound_by": k["bound"][1], "library_ms": None,
                "device_ms": k["device_ms"],
                **{f: r[f] for f in ("slots", "live_slots", "entry_slots",
                                     "valid", "survivors", "rect_tiles")}}

    def cull_entry(name):
        # at the bench training step; the 1M frame and the densify view
        # beside it
        r = cull_reading(cull_bench, name)
        return entry(name, "webdgs_tpu_torch/csrc/tile_cull.cu",
                     "none (the XLA chains at webdgs_tpu/ops/binning.py:174 "
                     "_cull_bitmask and :263 _select_nth_set_bit)",
                     r.pop("max_abs_err"), r.pop("ms"), r.pop("plain_ms"),
                     (r.pop("bound_ms"), r.pop("bound_by")),
                     r.pop("library_ms"), **r,
                     launches_viewer=launches[name],
                     # a step bins once, beside the backward raster; each
                     # metric view once
                     launches_per_event=(dlaunch[name]
                                         - dlaunch["rasterize_tiles_backward"])
                     // len(densify_res["events"]),
                     frame_1m=cull_reading(cull1m, name),
                     densify_view=cull_reading(densify_res["cull"], name))

    kernels = [
        # at the bench frame; the 1M frame and the densify view beside it
        entry("expand_fields", "webdgs_tpu_torch/csrc/expand.cu",
              "webdgs_tpu/ops/expand.py:63", exp_bench["err"],
              exp_bench["ms"], exp_bench["plain_ms"], exp_bench["bound"],
              None,
              launches_viewer=launches["expand_fields"],
              # a step expands once, beside the backward raster; each
              # metric view once
              launches_per_event=(dlaunch["expand_fields"]
                                  - dlaunch["rasterize_tiles_backward"])
              // len(densify_res["events"]),
              device_ms=exp_bench["device_ms"],
              kernel_device_ms=exp_bench["kernel_device_ms"],
              launch=exp_bench["launch"],
              before=exp_bench.get("before"), frame_1m=expand_reading(exp1m),
              densify_view=expand_reading(densify_res["expand"]),
              band_8k=expand_reading(banded_res["expand"])),
        # at the bench frame; the 1M frame and the densify view beside it
        entry("rasterize_tiles", "webdgs_tpu_torch/csrc/rasterize_fwd.cu",
              "webdgs_tpu/ops/rasterize.py:239", fwd["err"], fwd["ms"],
              fwd["plain_ms"], fwd["bound"], None,
              launches_viewer=launches["rasterize_tiles"],
              # a step launches it once, beside the backward raster
              launches_per_event=(dlaunch["rasterize_tiles"]
                                  - dlaunch["rasterize_tiles_backward"])
              // len(densify_res["events"]),
              nc_mismatch=fwd["nc_mismatch"], device_ms=fwd["device_ms"],
              launch=fwd["launch"], tile_work=fwd["tile_work"],
              before=fwd.get("before"), frame_1m=reading(fwd1m),
              densify_view=reading(dfwd),
              band_8k=reading(banded_res["forward"])),
        # at the bench training step; the 1M step beside it
        entry("tile_loss", "webdgs_tpu_torch/csrc/tile_loss.cu",
              "webdgs_tpu/ops/tile_loss.py:106", loss_bench["err"],
              loss_bench["ms"], loss_bench["plain_ms"], loss_bench["bound"],
              None, sums_rel_err=loss_bench["sums_rel"],
              device_ms=loss_bench["device_ms"],
              launch=loss_bench["launch"],
              before=loss_bench.get("before"), step_1m=loss_reading(loss1m),
              band=gs_res["band"]),
        # at the training step's inputs; the 1M sh3 / 1920x1080 step's
        # beside it
        entry("rasterize_tiles_backward",
              "webdgs_tpu_torch/csrc/rasterize_bwd.cu",
              "webdgs_tpu/ops/rasterize.py:347", bwd["err"], bwd["ms"],
              bwd["plain_ms"], bwd["bound"], None,
              device_ms=bwd["device_ms"], launch=bwd["launch"],
              tile_work=bwd["tile_work"], before=bwd.get("before"),
              step_1m={"max_abs_err": bwd1m["err"], "ms": bwd1m["ms"],
                       "plain_ms": bwd1m["plain_ms"],
                       "bound_ms": bwd1m["bound"][0],
                       "bound_by": bwd1m["bound"][1], "library_ms": None,
                       "device_ms": bwd1m["device_ms"],
                       "tile_work": bwd1m["tile_work"],
                       "before": bwd1m.get("before")}),
        # at the training step's inputs (C = 16); the one-row launch at
        # the densify view beside it
        entry("segment_sum_rows", "webdgs_tpu_torch/csrc/segsum.cu",
              "webdgs_tpu/ops/segsum.py:56", seg["err"], seg["ms"],
              seg["plain_ms"], seg["bound"], seg["lib_ms"],
              device_ms=seg["device_ms"],
              library_device_ms=seg["lib_device_ms"],
              before=seg.get("before"),
              # a step launches it once, beside the backward raster
              launches_per_event=(dlaunch["segment_sum_rows"]
                                  - dlaunch["rasterize_tiles_backward"])
              // len(densify_res["events"]),
              densify_view={
                  "max_abs_err": dseg["err"], "ms": dseg["ms"],
                  "plain_ms": dseg["plain_ms"],
                  "bound_ms": dseg["bound"][0],
                  "bound_by": dseg["bound"][1], "library_ms": dseg["lib_ms"],
                  "device_ms": dseg["device_ms"],
                  "library_device_ms": dseg["lib_device_ms"],
                  "before": dseg.get("before")}),
        # at the densify view's inputs (the event's load); the bench
        # scene's 400x300 view beside it
        entry("entry_counts", "webdgs_tpu_torch/csrc/importance.cu",
              "webdgs_tpu/ops/importance.py:48", imp["err"], imp["ms"],
              imp["plain_ms"], imp["bound"], None,
              launches_per_event=dlaunch["entry_counts"]
              // len(densify_res["events"]),
              device_ms=imp["device_ms"], launch=imp["launch"],
              pairs=imp["pairs"], before=imp.get("before"),
              bench_view={"max_abs_err": imp_bench["err"],
                          "ms": imp_bench["ms"],
                          "plain_ms": imp_bench["plain_ms"],
                          "bound_ms": imp_bench["bound"][0],
                          "bound_by": imp_bench["bound"][1],
                          "library_ms": None,
                          "device_ms": imp_bench["device_ms"],
                          "pairs": imp_bench["pairs"],
                          "before": imp_bench.get("before")}),
        cull_entry("cull_words"),
        cull_entry("entry_keys"),
        # at the bench step; 2,961,408 random rows beside it
        entry("adam_step", "webdgs_tpu_torch/csrc/adam.cu",
              "none (the XLA chain at webdgs_tpu/ops/adam.py:130 adam_step)",
              adam_bench["err"], adam_bench["ms"], adam_bench["plain_ms"],
              adam_bench["bound"], None, device_ms=adam_bench["device_ms"],
              quat_ulps=adam_bench["quat_ulps"], rows=adam_bench["rows"],
              full_sh=adam_bench["by_hp"]["full_sh"],
              rows_2_96m={k: adam_big[k] for k in (
                  "rows", "quat_ulps", "err", "by_hp")}),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"indexed_staging": {
        "bench_step": idx_bench, "bench_view": idx_bench_view,
        "step_1m": idx1m, "densify_view": densify_res["indexed"],
        "packed_calls": {"viewer_frames": packed_viewer,
                         "train_steps": packed_train}}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
