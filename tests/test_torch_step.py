"""PyTorch port vs the JAX reference: the whole training step, on both
branches (tile loss, and the image-space loss of frames under 5x5).

``train_step``: metrics within rtol 1e-4 and the new Adam moments within
the gradient tolerance (scaled by 1 - beta1 for m, (1 - beta2) g^2 for v).
New parameters follow this rule: the first Adam step moves each
coordinate by about +-3.16 * lr * sign(g) (adam.py:165-167), so a
near-zero gradient whose sign differs between two correct
implementations moves a parameter by up to 6.3 lr.  Wherever |g_ref| >=
1e-4 * max|g_ref| in the group, the new parameter must agree within
atol 1e-6; the rest may be at most 6.5 lr away and must be under 1 % of
the group's coordinates.  A quaternion is renormalised as a whole, so its
four lanes count as significant only when all four are.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from webdgs_tpu.ops import adam as jadam
from webdgs_tpu.train import step as jstep
from webdgs_tpu_torch.ops import adam as tadam
from webdgs_tpu_torch.ops import tile_loss as ttl
from webdgs_tpu_torch.train import step as tstep

from tests.test_torch_train import GROUPS, _setup
from tests.torch_parity import np_, t_


def _assert_params_follow_rule(new_t, new_j, m_ref, hp):
    g_ref = jadam.unpack_rows(np.asarray(m_ref) / (1.0 - hp.beta1))
    lrs = hp.group_lrs()
    for k in GROUPS:
        pt, pj = np_(new_t[k]), np.asarray(new_j[k])
        g = np.abs(np.asarray(g_ref[k]))
        sig = g >= 1e-4 * g.max() if g.max() > 0 else np.zeros_like(g, bool)
        if k == "quats":
            sig = np.broadcast_to(sig.all(axis=1, keepdims=True), sig.shape)
        diff = np.abs(pt - pj)
        assert (diff[sig] <= 1e-6 + 1e-6 * np.abs(pj[sig])).all(), \
            f"{k}: max diff {diff[sig].max()} on significant coordinates"
        rest = ~sig & (diff > 1e-6)
        assert (diff[rest] <= 6.5 * lrs[k]).all(), k
        assert rest.mean() < 0.01, f"{k}: {rest.mean():.4f} of coordinates"


@pytest.mark.parametrize("w,h,full_sh,sh_deg", [
    pytest.param(48, 32, False, 1, id="48-32-False"),
    pytest.param(4, 4, True, 1, id="4-4-True"),
    # the tiled step training all 48 coefficients: the SH stage's VJP
    pytest.param(48, 32, True, 3, id="48-32-True-sh3")])
def test_train_step_matches_jax(w, h, full_sh, sh_deg):
    """Both branches: the tile-loss path (48x32) and, for frames under
    5x5, the image-space path."""
    js, ts, jc, tc, target, sj, st = _setup(40, 41, w, h, sh_deg=sh_deg)
    hp_j = jadam.AdamHyperparameters(full_sh=full_sh)
    hp_t = tadam.AdamHyperparameters(full_sh=full_sh)
    assert ttl.supports_tile_loss(w, h, st) == (w >= 5)
    res_j = jstep.train_step(js, jadam.init_adam_state(js.params()), jc,
                             jnp.asarray(target), img_w=w, img_h=h, hp=hp_j,
                             settings=sj)
    res_t = tstep.train_step(ts, tadam.init_adam_state(ts.params()), tc,
                             t_(target), img_w=w, img_h=h, hp=hp_t,
                             settings=st)
    assert set(res_t.metrics) == set(res_j.metrics) == {
        "l1", "l2", "dssim", "loss", "psnr", "visible", "tile_entries"}
    for k in ("l1", "l2", "dssim", "loss", "psnr"):
        np.testing.assert_allclose(float(res_t.metrics[k]),
                                   float(res_j.metrics[k]), rtol=1e-4,
                                   err_msg=k)
    for k in ("visible", "tile_entries"):
        assert int(res_t.metrics[k]) == int(res_j.metrics[k]), k
    assert res_t.opt_state.iteration == 1
    m_j, v_j = np.asarray(res_j.opt_state.m), np.asarray(res_j.opt_state.v)
    # m = 0.1 g and v = 0.001 g^2 on a first step: the gradient tolerance
    m_scale = max(np.abs(m_j).max(), 0.1)
    np.testing.assert_allclose(np_(res_t.opt_state.m) / m_scale,
                               m_j / m_scale, rtol=1e-3, atol=1e-4)
    v_scale = max(np.abs(v_j).max(), 1e-3)
    np.testing.assert_allclose(np_(res_t.opt_state.v) / v_scale,
                               v_j / v_scale, rtol=2e-3, atol=2e-4)
    _assert_params_follow_rule(res_t.scene.params(), res_j.scene.params(),
                               m_j, hp_j)
    np.testing.assert_array_equal(np_(res_t.scene.alive),
                                  np.asarray(res_j.scene.alive))


def test_train_step_leaves_inputs_untouched():
    """Steps build new tensors: the input scene and moments are not
    updated in place (the trainer's rollback snapshot relies on it)."""
    w, h = 16, 16
    _, ts, _, tc, target, _, st = _setup(20, 5, w, h)
    before = {k: v.clone() for k, v in ts.params().items()}
    opt = tadam.init_adam_state(ts.params())
    res = tstep.train_step(ts, opt, tc, t_(target), img_w=w, img_h=h,
                           settings=st)
    for k, v in ts.params().items():
        assert np.array_equal(np_(v), np_(before[k])), k
        assert not v.requires_grad
    assert not opt.m.any() and opt.iteration == 0
    assert res.scene is not ts
    assert dataclasses.asdict(tadam.AdamHyperparameters()) == \
        dataclasses.asdict(jadam.AdamHyperparameters())
