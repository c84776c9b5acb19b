"""Shared harness of the PyTorch-port parity tests (tests/test_torch_*.py).

One numpy scene and camera go to both packages: the JAX reference runs as
its own tests run it (CPU, Pallas kernels in interpret mode) with the
f32-exact matmul tier pinned (``matmul_precision="highest"``), because the
port computes in plain float32; the port runs on the CPU, where its kernel
wrappers take their plain torch versions.
"""

from __future__ import annotations

import numpy as np
import torch

from webdgs_tpu.config import RenderSettings as JaxSettings
from webdgs_tpu.core import camera as jax_camera
from webdgs_tpu.core.scene import scene_from_arrays as jax_scene_from_arrays
from webdgs_tpu.ops.projection import SplatAttrs as JaxSplatAttrs
from webdgs_tpu_torch.config import RenderSettings
from webdgs_tpu_torch.core import camera as torch_camera
from webdgs_tpu_torch.core.scene import scene_from_numpy
from webdgs_tpu_torch.ops.projection import SplatAttrs, SplatAux

CPU = "cpu"

# image / transmittance tolerances of tests/test_render_forward.py:65-68,
# and its n_contrib mismatch budget (:69-71)
IMG_RTOL, IMG_ATOL = 1e-4, 3e-4
NC_MISMATCH = 0.005


def jax_settings(**kw) -> JaxSettings:
    return JaxSettings(matmul_precision="highest", **kw)


def torch_settings(**kw) -> RenderSettings:
    return RenderSettings(**kw)


def numpy_scene(n: int, seed: int = 0, spread: float = 1.0,
                opacity_shift: float = 0.0) -> dict[str, np.ndarray]:
    """The random-scene recipe of tests/test_render_forward.py:18-28."""
    rng = np.random.default_rng(seed)
    means = rng.normal(0, spread, (n, 3)).astype(np.float32)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    log_scales = rng.uniform(-3.5, -1.5, (n, 3)).astype(np.float32)
    opacity = (rng.uniform(-1.0, 3.0, (n,)) + opacity_shift).astype(
        np.float32)
    sh = rng.normal(0, 0.3, (n, 16, 3)).astype(np.float32)
    sh[:, 0, :] += 0.8
    return {"means": means, "quats": quats, "log_scales": log_scales,
            "opacity_logits": opacity, "sh": sh}


def both_scenes(params: dict[str, np.ndarray], sh_deg: int = 0):
    """(JAX scene, port scene on the CPU) from one numpy parameter set."""
    js = jax_scene_from_arrays(params["means"], params["quats"],
                               params["log_scales"],
                               params["opacity_logits"], params["sh"],
                               sh_deg=sh_deg)
    ts = scene_from_numpy(params, np.ones(params["means"].shape[0], bool),
                          sh_deg, CPU)
    return js, ts


def both_cameras(w: int, h: int, position=(0.0, 0.0, -5.0)):
    return (jax_camera.default_camera(w, h, position=position),
            torch_camera.default_camera(w, h, position=position,
                                        device=CPU))


def np_(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t_(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x))


def attrs_to_torch(attrs: JaxSplatAttrs) -> SplatAttrs:
    return SplatAttrs(*(t_(v) for v in attrs))


def aux_to_torch(aux) -> SplatAux:
    return SplatAux(*(t_(v) for v in aux))


def assert_tiles_close(got, want) -> None:
    """(T, 8, P) tile buffers: rgb/acc/T within the image tolerances,
    n_contrib within the mismatch budget, channels 6-7 zero."""
    got, want = np_(got), np_(want)
    np.testing.assert_allclose(got[:, 0:5], want[:, 0:5], rtol=IMG_RTOL,
                               atol=IMG_ATOL)
    mismatch = np.mean(got[:, 5] != want[:, 5])
    assert mismatch <= NC_MISMATCH, f"n_contrib mismatch {mismatch:.4f}"
    assert not got[:, 6:].any()
