"""PyTorch port vs the JAX reference: parameter gradients of both loss
paths (``compute_param_grads_tiled`` and ``compute_param_grads``), per
parameter group, scale-normalised (``/ max(|ref|, 1)``) at rtol 1e-3 /
atol 1e-4, the tolerance of tests/test_gradients.py:81-82.  Inputs are
made from a seed with numpy; the JAX side runs its Pallas kernels in
interpret mode with the f32-exact matmul tier.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from webdgs_tpu.ops import loss as jloss
from webdgs_tpu.train import step as jstep
from webdgs_tpu_torch.ops import kernel_launches
from webdgs_tpu_torch.ops import loss as tloss
from webdgs_tpu_torch.train import step as tstep

from tests.torch_parity import (both_cameras, both_scenes, jax_settings, np_,
                                numpy_scene, t_, torch_settings)

GROUPS = ("means", "quats", "log_scales", "opacity_logits", "sh")


def _setup(n, seed, w, h, sh_deg=0, **settings):
    params = numpy_scene(n, seed=seed)
    js, ts = both_scenes(params, sh_deg=sh_deg)
    jc, tc = both_cameras(w, h)
    rng = np.random.default_rng(seed + 100)
    target = rng.random((h, w, 3)).astype(np.float32)
    return (js, ts, jc, tc, target, jax_settings(**settings),
            torch_settings(**settings))


def _assert_grads_close(got, want):
    for k in GROUPS:
        g, r = np_(got[k]), np.asarray(want[k])
        assert g.shape == r.shape, k
        scale = max(np.abs(r).max(), 1.0)
        np.testing.assert_allclose(g / scale, r / scale, rtol=1e-3,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("sh_deg,parity_sh,radius", [
    (0, True, 128.0),
    (2, False, 3.0),  # autodiff through SH; radius-capped Gaussians
    (3, False, 128.0),  # every SH band through the colour stage's VJP
])
def test_param_grads_tiled_match_jax(sh_deg, parity_sh, radius):
    w, h = 48, 32
    js, ts, jc, tc, target, sj, st = _setup(
        60, 21 + sh_deg, w, h, sh_deg, max_splat_radius_px=radius)
    cfg_j, cfg_t = jloss.LossConfig(), tloss.LossConfig()
    met_j, gj, aux_j, dem_j = jstep.compute_param_grads_tiled(
        js, jc, jnp.asarray(target), w, h, cfg_j, sj, parity_sh)
    launches = kernel_launches()
    met_t, gt, aux_t, dem_t = tstep.compute_param_grads_tiled(
        ts, tc, t_(target), w, h, cfg_t, st, parity_sh)
    assert kernel_launches() == launches  # CPU: plain versions
    if radius < 100.0:
        assert bool(np.asarray(aux_j.radius_capped).any())
    np.testing.assert_array_equal(np_(aux_t.radius_capped),
                                  np.asarray(aux_j.radius_capped))
    assert int(dem_t) == int(dem_j)
    for k in ("l1", "l2", "dssim", "loss", "psnr"):
        np.testing.assert_allclose(float(met_t[k]), float(met_j[k]),
                                   rtol=1e-4, err_msg=k)
    assert np.abs(np_(gt["means"])).max() > 0
    _assert_grads_close(gt, gj)


def test_param_grads_image_path_match_jax():
    w, h = 48, 32
    js, ts, jc, tc, target, sj, st = _setup(50, 31, w, h, sh_deg=2)
    img_j, gj, _, _ = jstep.compute_param_grads(
        js, jc, jnp.asarray(target), w, h, jloss.LossConfig(), sj, True)
    img_t, gt, _, _ = tstep.compute_param_grads(
        ts, tc, t_(target), w, h, tloss.LossConfig(), st, True)
    np.testing.assert_allclose(np_(img_t), np.asarray(img_j), rtol=1e-4,
                               atol=3e-4)
    _assert_grads_close(gt, gj)
    # parity SH routing: only the DC coefficient carries a gradient
    assert not np_(gt["sh"])[:, 1:].any()
