"""Where the device time goes in the PyTorch port, on a CUDA card.

    python scripts/profile_torch.py [--frames 5] [--steps 5] [--out DIR]
                                    [--large]

bench.py's scene (100k random Gaussians, seed 0, 800x600, camera at
(0, 0, -8)) through ``torch.profiler`` over a short steady window, after 3
warm-up iterations: (a) Viewer frames (host image included), (b) training
steps (``train_step`` at 1.2x the observed entries, target = the scene's
own render as in bench.py).  With ``--large``, scripts/bench_1m.py's scene
at sh_deg 3 (chip_smoke.py's ``scene_1m``) too: (c) ``render_banded``
frames at DCI 8K (8192x4320, two bands; the device image, no host copy)
at 1.5x the largest band's entries, (d) ``dp_train_step`` of 2 views at
1920x1080 on a 1-rank NCCL group (``make_mesh()``), targets the renders
of the scene with its positions perturbed.  For each it prints one JSON line: wall ms per
iteration unprofiled and profiled (host clock, synchronised; the
profiler's per-op host cost inflates the second), device-busy ms per
iteration (the union of the CUDA kernel and memcpy intervals), the idle
share of the unprofiled wall time, the CUDA launches per iteration, and
the top device-time consumers.  Chrome traces go to ``--out``.  Needs a
CUDA device; raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from webdgs_tpu_torch.bench import (bench_scene,  # noqa: E402
                                    card_name, entry_capacity)
from webdgs_tpu_torch.config import (RenderSettings,  # noqa: E402
                                     quantize_budget)
from webdgs_tpu_torch.core.camera import default_camera  # noqa: E402
from webdgs_tpu_torch.core.scene import (SH_C0,  # noqa: E402
                                         scene_from_arrays)
from webdgs_tpu_torch.ops.adam import init_adam_state  # noqa: E402
from webdgs_tpu_torch.parallel.sharding import (  # noqa: E402
    dp_train_step, make_mesh)
from webdgs_tpu_torch.render.renderer import (render,  # noqa: E402
                                              render_banded)
from webdgs_tpu_torch.render.viewer import Viewer  # noqa: E402
from webdgs_tpu_torch.train.step import train_step  # noqa: E402


def scene_1m(device, n: int = 1_000_000):
    """scripts/bench_1m.py's seed-0 scene at sh_deg 3 (as chip_smoke.py
    builds it)."""
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


def profile_large(dev, args) -> None:
    """(c) the DCI 8K banded frame and (d) the 2-view dp step, both of the
    1M sh3 scene."""
    big = scene_1m(dev)
    s1m = RenderSettings(avg_tiles_per_gaussian=6)
    cam8k = default_camera(8192, 4320, position=(0.0, 0.0, -10.0),
                           device=dev)
    with torch.no_grad():
        _, entries = render_banded(big, cam8k, 8192, 4320, s1m,
                                   return_entries=True)
        cap8k = quantize_budget(int(entries) * 1.5, s1m.chunk, s1m.chunk * 8)

        def frame():
            render_banded(big, cam8k, 8192, 4320, s1m, entry_capacity=cap8k)

        profile("banded_8k_frame", frame, args.frames, args.out)

    w, h = 1920, 1080
    cams = [default_camera(w, h, position=(0.1 * i, 0.0, -10.0),
                           device=dev) for i in range(2)]
    rng = np.random.default_rng(6)
    with torch.no_grad():
        pert = big.with_params({**big.params(), "means": big.means
                                + torch.tensor(rng.normal(
                                    0, 0.01, (big.capacity, 3)),
                                    dtype=torch.float32, device=dev)})
        targets = torch.stack([render(pert, c, w, h, s1m).image
                               for c in cams])
        demand = max(int(render(big, c, w, h, s1m).binning.expansion_entries)
                     for c in cams)
    del pert
    cap = quantize_budget(demand * 1.2, s1m.chunk, s1m.chunk * 8)
    mesh = make_mesh()
    state = {"s": big, "o": init_adam_state(big.params())}

    def step():
        state["s"], state["o"], _ = dp_train_step(
            state["s"], state["o"], cams, targets, mesh, img_w=w, img_h=h,
            settings=s1m, entry_capacity=cap)

    try:
        profile("dp_step_1m_2views", step, args.steps, args.out)
    finally:
        mesh.close()


def _union_ms(intervals) -> float:
    total, end = 0.0, -1.0
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3  # profiler times are in us


def _wall_ms(fn, iters) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def profile(name, fn, iters, out_dir):
    for _ in range(3):
        fn()
    wall_ms = _wall_ms(fn, iters)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        profiled_ms = _wall_ms(fn, iters)
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = _union_ms([(e.time_range.start, e.time_range.end)
                         for e in dev_events]) / iters
    by_name: dict[str, float] = {}
    for e in dev_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / iters
    launches = sum(1 for e in prof.events()
                   if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                 "cudaLaunchKernelExC")) / iters
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}_trace.json"))
    line = {"phase": name, "wall_ms": wall_ms,
            "profiled_wall_ms": profiled_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "launches_per_iter": launches,
            "top_device_ms": [[k[:90], v] for k, v in top]}
    print(json.dumps(line), flush=True)
    return line


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--large", action="store_true",
                    help="also the 1M sh3 scene: a DCI 8K render_banded "
                    "frame and a 2-view dp_train_step at 1920x1080")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch.py needs a CUDA device")
    dev = torch.device("cuda")
    print(f"[profile] {card_name(dev)}", flush=True)
    w, h = 800, 600
    settings = RenderSettings()
    scene = bench_scene(dev)
    cam = default_camera(w, h, position=(0.0, 0.0, -8.0), device=dev)

    viewer = Viewer(scene, w, h, settings, device="cuda")
    viewer.control.position = np.array([0.0, 0.0, -8.0], np.float32)
    profile("viewer_frame", viewer.render, args.frames, args.out)

    with torch.no_grad():
        res = render(scene, cam, w, h, settings)
    target = res.image
    demand = int(res.binning.expansion_entries)
    cap = entry_capacity(demand, settings.chunk)
    state = {"s": scene, "o": init_adam_state(scene.params())}

    def step():
        state["s"], state["o"], _ = train_step(
            state["s"], state["o"], cam, target, img_w=w, img_h=h,
            settings=settings, entry_capacity=cap)

    profile("train_step", step, args.steps, args.out)
    if args.large:
        del scene, viewer, state, target, res
        torch.cuda.empty_cache()
        profile_large(dev, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
