"""Build and load the port's CUDA kernels.

At first use, one ``nvcc`` call compiles every ``csrc/*.cu`` of the package
into a shared library with a plain C interface for Hopper (``sm_90a``) and
loads it with ctypes.  The library lands in ``_build/`` beside this file
(listed in ``.gitignore``), named by a hash of the sources and the flags,
so an edited source always rebuilds and an unchanged one is reused.
Nothing is fetched: the toolkit's ``nvcc`` (``$CUDA_HOME/bin``,
``/usr/local/cuda/bin`` or ``PATH``) and the sources in the checkout are
all it needs.  A missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# -fmad=false: no multiply-add contraction, so each float op rounds once,
# like the plain torch version the kernels are held against (the alpha
# thresholds 1/255 and T >= 0.01 decide n_contrib).  No --use_fast_math:
# expf/log1pf stay the accurate library versions, not __expf.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C entry points of csrc/*.cu: name -> argtypes (all return cudaError_t)
SIGNATURES = {
    # words, cum_incl, n, e_cap, out_words, out_ids, stream
    "webdgs_expand_fields": (_P, _P, _I, _I, _P, _P, _P),
    # out (6 ints: threads, shared bytes, CTAs per SM, registers, slots per
    # CTA, staged cumsum window)
    "webdgs_expand_occupancy": (_P,),
    # attrs16, e_len, tile_offsets, n_tiles, ntx, tile_w, tile_h, chunk,
    # alpha_min, alpha_max, t_threshold, log_t_min, track_ncontrib, out,
    # tile_order ((T,) int32 scratch for the launch order), stream
    "webdgs_rasterize_fwd": (_P, _I, _P, _I, _I, _I, _I, _I, _F, _F, _F,
                             _F, _I, _P, _P, _P),
    # tile_w, tile_h, chunk, out (4 ints: threads, smem bytes, CTAs per
    # SM, pixels per thread)
    "webdgs_rasterize_fwd_occupancy": (_I, _I, _I, _P),
    # attrs16, e_len, tile_offsets, gpix5, n_tiles, ntx, tile_w, tile_h,
    # chunk, alpha_min, alpha_max, t_threshold, log_t_min, d_attrs,
    # tile_order ((T,) int32 scratch for the launch order), stream
    "webdgs_rasterize_bwd": (_P, _I, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                             _F, _F, _P, _P, _P),
    # tile_w, tile_h, chunk, out (5 ints: threads, smem bytes, CTAs per
    # SM, pixels per thread, entries per batch)
    "webdgs_rasterize_bwd_occupancy": (_I, _I, _I, _P),
    # out, target, n_tiles, ntx, tile_w, tile_h, img_w, img_h, l1, l2,
    # ldssim, c1, c2, bg0, bg1, bg2, dpix, sums, stream
    "webdgs_tile_loss": (_P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F,
                         _F, _F, _F, _F, _P, _P, _P),
    # out, halo_top, halo_bot, target, row_base, rows, ntx, tile_w, tile_h,
    # img_w, img_h, l1, l2, ldssim, c1, c2, bg0, bg1, bg2, dpix, sums,
    # stream
    "webdgs_tile_loss_band": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _F, _F, _F, _F, _F, _F, _F, _F, _P, _P, _P),
    # tile_w, tile_h, out (5 ints: threads, dynamic shared bytes, CTAs per
    # SM, registers, output rows per thread)
    "webdgs_tile_loss_occupancy": (_I, _I, _P),
    # rows, n_rows, row_stride, entry_source, valid, e_len, counts, n,
    # work, work_bytes, out, device, stream
    "webdgs_segsum": (_P, _I, _L, _P, _P, _I, _P, _I, _P, _L, _P, _I, _P),
    # attrs16, e_len, tile_offsets, pix, n_tiles, ntx, tile_w, tile_h,
    # alpha_min, alpha_max, out, stream
    "webdgs_importance": (_P, _I, _P, _P, _I, _I, _I, _I, _F, _F, _P, _P),
    # tile_w, tile_h, out (5 ints: threads, shared bytes, CTAs per SM,
    # registers, CTAs per tile)
    "webdgs_importance_occupancy": (_I, _I, _P),
    # conic, opacity, center, extents, tile_min, tile_dims, num_tiles,
    # depth, n, ntx, tile_w, tile_h, 1 / alpha_min, words, counts, stream
    "webdgs_cull_words": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _F, _P, _P, _P),
    # words, total, e_cap, ntx, keys, stream
    "webdgs_entry_keys": (_P, _P, _I, _I, _P, _P),
    # params (5 pointers, PACK_LAYOUT order), grads (5), m, v, tile_counts,
    # out params (5), m_out, v_out, n, lrs (6 floats: lanes 0, 3, 7, 10,
    # 11, 14), full_sh, beta1, 1 - beta1, beta2, 1 - beta2, eps,
    # 1 / corr1, 1 / corr2, stream
    "webdgs_adam_step": (_P, _P, _P, _P, _P, _P, _P, _P, _L, _P, _I, _F,
                         _F, _F, _F, _F, _F, _F, _P),
}


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of webdgs_tpu_torch cannot be built")
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libwebdgs_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str | None]:
    """Compile the kernels unless a library of the same sources exists.

    Returns (library path, compiler log or None when it was reused).  The
    output is written under a per-process name and renamed into place, so
    processes building at the same time never load a half-written file."""
    out = library_path()
    if out.is_file():
        return out, None
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def build_one(src, name: str) -> tuple[Path, str]:
    """Compile one CUDA source on its own, with the library's flags, into
    ``_build/<name>.so``.  For measurement tools that load a variant or an
    earlier version of a kernel beside the library; the port itself loads
    only :func:`library`.  Returns (path, compiler log)."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{name}.so"
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    return out, proc.stdout + proc.stderr


_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call.  Thread-safe: the
    live-training server launches kernels from its frame and training
    threads, and only one of them may build."""
    with _LOCK:
        return _load()


@functools.cache
def _load() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.webdgs_error_string.argtypes = (ctypes.c_int,)
    lib.webdgs_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch: a refused
    launch never runs, and a later synchronize would not report it."""
    if err != 0:
        msg = library().webdgs_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch ({msg})")
