"""On-chip smoke test of the PyTorch + CUDA port (webdgs_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero with no result):
  1. device: CUDA must be available; prints the card's name and power limit;
  2. build: compiles the CUDA kernels of webdgs_tpu_torch/csrc from the
     checkout (nvcc, sm_90a) and prints the build time;
  3. kernels: each kernel against its plain torch version on the card, at
     the shapes the bench frame gives it (100k random Gaussians, seed 0,
     800x600, camera at (0, 0, -8)), with both times;
  4. the slice: a Viewer renders 5 bench frames through both kernels (their
     launch counters are reset just before and must grow), and a small
     frame rendered on the card matches the plain CPU render;
  5. realistic size: one frame of 1M Gaussians at sh_deg 3, 1920x1080;
  6. server: a view-mode ViewerServer on 127.0.0.1 answers 3 JPEG frames,
     a control post and /stats over HTTP.
It prints one JSON line of per-kernel results, the card line again, and as
its last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import io
import json
import math
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

RAST_ATOL = 3e-4  # rgb / acc / T, tests/test_render_forward.py:65-68
NC_MISMATCH = 0.005  # n_contrib, tests/test_render_forward.py:69-71


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
    p1 = cuda_ms(plain, plain_iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, plain_iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


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
    from webdgs_tpu_torch.ops import binning, expand, rasterize
    from webdgs_tpu_torch.ops.projection import project_gaussians
    from webdgs_tpu_torch.render.renderer import render
    from webdgs_tpu_torch.render.viewer import Viewer

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
    rast_ms, rast_plain_ms = time_pair(
        lambda: rasterize.rasterize_tiles(attrs16, off, ntx, nty, settings),
        lambda: rasterize.rasterize_tiles_plain(attrs16, off, ntx, nty,
                                                settings), 20, 3)
    print(f"[kernels] rasterize_tiles: max abs err {rast_err:.3e} (<= "
          f"{RAST_ATOL}), n_contrib mismatch {nc_mis:.5f} (<= "
          f"{NC_MISMATCH}); kernel {rast_ms:.4f} ms, plain "
          f"{rast_plain_ms:.4f} ms", flush=True)
    del ek, ep, rk, rp

    # --- 4. the slice: Viewer frames through both kernels ---
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

    # --- 5. realistic size: 1M Gaussians, sh_deg 3, 1920x1080 ---
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
    del big, v1m, img1m
    torch.cuda.empty_cache()

    # --- 6. the view-mode server over HTTP ---
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

    kernels = [
        {"name": "expand_fields", "route": "cuda",
         "source": "webdgs_tpu_torch/csrc/expand.cu",
         "replaces": "webdgs_tpu/ops/expand.py:63",
         "launches": launches["expand_fields"], "max_abs_err": expand_err,
         "ms": expand_ms, "plain_ms": expand_plain_ms},
        {"name": "rasterize_tiles", "route": "cuda",
         "source": "webdgs_tpu_torch/csrc/rasterize_fwd.cu",
         "replaces": "webdgs_tpu/ops/rasterize.py:239",
         "launches": launches["rasterize_tiles"], "max_abs_err": rast_err,
         "ms": rast_ms, "plain_ms": rast_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
