"""PyTorch port vs the JAX reference: the loss module, the tile-loss kernel
(plain version on the CPU) and Adam.

Same numpy inputs through both packages.  Tolerances: loss functions
rtol 1e-5, with atol 1e-5 on the [-1, 1] SSIM map (its variance
cancellation makes values near 0 carry the window sums' rounding, whose
order differs from XLA's reduce_window); tile loss dpix rtol 1e-5 / atol 1e-6 and metrics rtol 1e-5
(those of tests/test_tile_loss.py); Adam rtol 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webdgs_tpu.ops import adam as jadam
from webdgs_tpu.ops import loss as jloss
from webdgs_tpu.ops import rasterize as jras
from webdgs_tpu.ops import tile_loss as jtl
from webdgs_tpu_torch.ops import adam as tadam
from webdgs_tpu_torch.ops import kernel_launches
from webdgs_tpu_torch.ops import loss as tloss
from webdgs_tpu_torch.ops import rasterize as tras
from webdgs_tpu_torch.ops import tile_loss as ttl

from tests.torch_parity import jax_settings, np_, t_, torch_settings

SETTINGS_T = torch_settings()


def _images(h, w, seed):
    rng = np.random.default_rng(seed)
    pred = rng.random((h, w, 3)).astype(np.float32)
    target = rng.random((h, w, 3)).astype(np.float32)
    pred[: h // 3] = target[: h // 3]  # some exact zeros of the difference
    return pred, target


@pytest.mark.parametrize("h,w", [(32, 48), (17, 23)])
def test_loss_functions_match_jax(h, w):
    pred, target = _images(h, w, seed=h)
    cfg_t, cfg_j = tloss.LossConfig(), jloss.LossConfig()
    np.testing.assert_allclose(
        np_(tloss.ssim_map(t_(pred), t_(target))),
        np.asarray(jloss.ssim_map(jnp.asarray(pred), jnp.asarray(target))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        np_(tloss.pixel_loss_gradient(t_(pred), t_(target), cfg_t)),
        np.asarray(jloss.pixel_loss_gradient(jnp.asarray(pred),
                                             jnp.asarray(target), cfg_j)),
        rtol=1e-5, atol=1e-6)
    mt = tloss.loss_metrics(t_(pred), t_(target), cfg_t)
    mj = jloss.loss_metrics(jnp.asarray(pred), jnp.asarray(target), cfg_j)
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(
        float(tloss.ssim(t_(pred), t_(target))),
        float(jloss.ssim(jnp.asarray(pred), jnp.asarray(target))),
        rtol=1e-5)


def test_loss_sign_of_zero_is_zero():
    """Untouched pixels (diff exactly 0) get no L1 gradient."""
    x = torch.rand(8, 9, 3)
    g = tloss.pixel_loss_gradient(x, x.clone(), tloss.LossConfig(
        lambda_l1=1.0, lambda_l2=0.0, lambda_dssim=0.0))
    assert torch.count_nonzero(g) == 0


def _tiles(img_w, img_h, seed, s=SETTINGS_T):
    ntx, nty = -(-img_w // s.tile_w), -(-img_h // s.tile_h)
    rng = np.random.default_rng(seed)
    n_tiles = ntx * nty
    out = np.zeros((n_tiles, tras.NUM_OUT, s.tile_px), np.float32)
    out[:, 0:3, :] = rng.random((n_tiles, 3, s.tile_px)) * 0.9
    out[:, 3, :] = rng.random((n_tiles, s.tile_px))
    out[:, tras.OUT_T, :] = rng.random((n_tiles, s.tile_px))
    target = rng.random((img_h, img_w, 3)).astype(np.float32)
    return out, target, ntx, nty


def _oracle(out, target, img_w, img_h, ntx, nty, cfg, settings):
    """The image-space path of the port: tiles -> image, pixel gradient,
    back to tiles by autograd of the layout."""
    o = out.clone().requires_grad_(True)
    tiles = tras.tiles_to_image(o, ntx, nty, img_w, img_h, settings)
    image = tras.composite_background(tiles, settings)
    pgrad = tloss.pixel_loss_gradient(image.detach(), target, cfg)
    (dpix,) = torch.autograd.grad(image, o, pgrad)
    return dpix, tloss.loss_metrics(image.detach(), target, cfg)


# (5, 5): the smallest frame the kernel takes; (32, 16): exactly one tile
@pytest.mark.parametrize("img_w,img_h", [(64, 64), (70, 52), (48, 48),
                                         (33, 20), (49, 33), (5, 5),
                                         (32, 16)])
@pytest.mark.parametrize("bg", [(0.0, 0.0, 0.0), (0.2, 0.5, 0.9)])
def test_tile_loss_matches_jax_and_oracle(img_w, img_h, bg):
    _check_tile_loss(img_w, img_h, bg, SETTINGS_T.tile_w, SETTINGS_T.tile_h)


# tiles other than the default 32x16: 256 and 1,024 pixels, and 240 (not a
# multiple of 32).  The JAX function takes each of them, so the port is
# held against it and against the oracle.
@pytest.mark.parametrize("tile_w,tile_h,img_w,img_h", [
    (16, 16, 40, 37), (16, 16, 16, 16), (32, 32, 70, 52), (32, 32, 33, 40),
    (15, 16, 23, 11)])
def test_tile_loss_other_tiles_match_jax_and_oracle(tile_w, tile_h, img_w,
                                                    img_h):
    _check_tile_loss(img_w, img_h, (0.2, 0.5, 0.9), tile_w, tile_h)


def test_tile_loss_refuses_tiles_the_kernel_cannot_take():
    """A tile of more than 1,024 pixels, which the kernel refuses, is
    refused on the CPU too."""
    s = dataclasses.replace(SETTINGS_T, tile_w=64, tile_h=32)
    out, target, ntx, nty = _tiles(100, 40, seed=1, s=s)
    with pytest.raises(ValueError, match="1 to 1024 pixels"):
        ttl.tile_loss_gradient(t_(out), t_(target), 100, 40, ntx, nty,
                               tloss.LossConfig(), s)


def _check_tile_loss(img_w, img_h, bg, tile_w, tile_h):
    """dpix and the metrics of the port's tile loss (plain version on the
    CPU) against the JAX function and the image-space oracle."""
    st = dataclasses.replace(SETTINGS_T, background=bg, tile_w=tile_w,
                             tile_h=tile_h)
    sj = jax_settings(background=bg, tile_w=tile_w, tile_h=tile_h)
    out, target, ntx, nty = _tiles(img_w, img_h, seed=7, s=st)
    cfg_t, cfg_j = tloss.LossConfig(), jloss.LossConfig()
    assert ttl.supports_tile_loss(img_w, img_h, st)

    launches = kernel_launches()["tile_loss_tiles"]
    dpix, met = ttl.tile_loss_gradient(t_(out), t_(target), img_w, img_h,
                                       ntx, nty, cfg_t, st)
    assert kernel_launches()["tile_loss_tiles"] == launches  # CPU: plain
    dj, mj = jtl.tile_loss_gradient(jnp.asarray(out), jnp.asarray(target),
                                    img_w, img_h, ntx, nty, cfg_j, sj)
    np.testing.assert_allclose(np_(dpix), np.asarray(dj), rtol=1e-5,
                               atol=1e-6)
    do, mo = _oracle(t_(out), t_(target), img_w, img_h, ntx, nty, cfg_t, st)
    np.testing.assert_allclose(np_(dpix), np_(do), rtol=1e-5, atol=1e-6)
    for k in ("l1", "l2", "dssim", "loss", "psnr"):
        np.testing.assert_allclose(float(met[k]), float(mj[k]), rtol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(float(met[k]), float(mo[k]), rtol=1e-5,
                                   err_msg=k)


def test_tile_loss_zero_diff():
    """pred == target: l1/l2 and their gradient vanish (the dssim term is
    off here), as tests/test_tile_loss.py:68 checks for the reference."""
    cfg = tloss.LossConfig(lambda_l1=1.0, lambda_l2=1.0, lambda_dssim=0.0)
    img_w = img_h = 64
    ntx = nty = 4
    rng = np.random.default_rng(3)
    target = torch.tensor(rng.random((img_h, img_w, 3)).astype(np.float32))
    tiles = tras.image_to_tiles(target, ntx, nty, SETTINGS_T)  # (T, P, 3)
    out = torch.zeros((ntx * nty, tras.NUM_OUT, SETTINGS_T.tile_px))
    out[:, 0:3, :] = tiles.permute(0, 2, 1)
    dpix, met = ttl.tile_loss_gradient(out, target, img_w, img_h, ntx, nty,
                                       cfg, SETTINGS_T)
    assert float(met["l1"]) < 1e-6
    assert float(met["l2"]) < 1e-10
    assert torch.count_nonzero(dpix) == 0


def test_tile_loss_rejects_bad_shapes():
    out, target, ntx, nty = _tiles(48, 32, seed=1)
    with pytest.raises(ValueError):
        ttl.tile_loss_gradient(t_(out), t_(target[:-1]), 48, 32, ntx, nty,
                               tloss.LossConfig(), SETTINGS_T)


def _adam_inputs(n, seed):
    rng = np.random.default_rng(seed)
    params = {
        "means": rng.normal(0, 1, (n, 3)), "quats": rng.normal(0, 1, (n, 4)),
        "log_scales": rng.normal(-3, 1, (n, 3)),
        "opacity_logits": rng.normal(0, 1, (n,)),
        "sh": rng.normal(0, 1, (n, 16, 3))}
    grads = {k: rng.normal(0, 1e-2, v.shape) for k, v in params.items()}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    grads = {k: v.astype(np.float32) for k, v in grads.items()}
    counts = rng.integers(0, 3, n).astype(np.int32)  # ~1/3 invisible
    return params, grads, counts


@pytest.mark.parametrize("opts", [
    {}, {"full_sh": True}, {"bias_correction": True},
    {"lr_pos_final": 1.6e-6, "lr_pos_decay_steps": 10},
])
def test_adam_step_matches_jax(opts):
    n = 50
    params, grads, counts = _adam_inputs(n, seed=len(opts))
    hp_t = tadam.AdamHyperparameters(**opts)
    hp_j = jadam.AdamHyperparameters(**opts)
    pt = {k: t_(v) for k, v in params.items()}
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    st = tadam.init_adam_state(pt)
    sj = jadam.init_adam_state(pj)
    launches = kernel_launches()["adam_step"]
    for step in range(3):  # moments carried across steps
        g = {k: v * (step + 1) for k, v in grads.items()}
        pt, st = tadam.adam_step(pt, {k: t_(v) for k, v in g.items()}, st,
                                 hp_t, t_(counts))
        pj, sj = jadam.adam_step(pj, {k: jnp.asarray(v)
                                      for k, v in g.items()}, sj, hp_j,
                                 jnp.asarray(counts))
    assert st.iteration == int(sj.iteration) == 3
    # CPU tensors take adam_step_plain and launch no kernel
    assert kernel_launches()["adam_step"] == launches
    for k in params:
        np.testing.assert_allclose(np_(pt[k]), np.asarray(pj[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(np_(st.m), np.asarray(sj.m), rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(np_(st.v), np.asarray(sj.v), rtol=1e-6,
                               atol=1e-12)
    # invisible Gaussians are frozen, quaternions renormalised
    frozen = counts == 0
    np.testing.assert_array_equal(np_(pt["means"])[frozen],
                                  params["means"][frozen])
    qn = np.linalg.norm(np_(pt["quats"])[~frozen], axis=1)
    np.testing.assert_allclose(qn, 1.0, rtol=1e-5)


def test_adam_step_checks_its_inputs():
    params, grads, counts = _adam_inputs(7, seed=11)
    pt = {k: t_(v) for k, v in params.items()}
    gt = {k: t_(v) for k, v in grads.items()}
    st = tadam.init_adam_state(pt)
    tadam._check_adam_inputs(pt, gt, st, t_(counts))
    with pytest.raises(ValueError, match="d_sh"):
        tadam._check_adam_inputs(pt, {**gt, "sh": gt["sh"][:, :9]}, st,
                                 t_(counts))
    with pytest.raises(TypeError, match="quats"):
        tadam._check_adam_inputs({**pt, "quats": pt["quats"].double()}, gt,
                                 st, t_(counts))
    with pytest.raises(ValueError, match="tile_counts"):
        tadam._check_adam_inputs(pt, gt, st, t_(counts[:-1]))
    with pytest.raises(TypeError, match="tile_counts"):
        tadam._check_adam_inputs(pt, gt, st, t_(counts).long())
    meta = tadam.AdamState(st.m.to("meta"), st.v.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tadam.adam_step(pt, gt, meta, tadam.AdamHyperparameters(),
                        t_(counts))


def test_pack_layout_roundtrip():
    params, _, _ = _adam_inputs(7, seed=9)
    pt = {k: t_(v) for k, v in params.items()}
    packed = tadam.pack_rows(pt)
    assert packed.shape == (7, tadam.PACK_DIM)
    np.testing.assert_array_equal(
        np_(packed), np.asarray(jadam.pack_rows(
            {k: jnp.asarray(v) for k, v in params.items()})))
    back = tadam.unpack_rows(packed)
    for k in params:
        np.testing.assert_array_equal(np_(back[k]), params[k])
