"""PyTorch port vs the JAX reference: densify / prune (``ops/densify.py``)
and the densify phase's target downscale.

``jax.random`` cannot be reproduced in torch, so each event gets one
numpy-seeded ``(jitter_u, split_d)``: ``densify_rng`` is replaced in both
modules (the JAX event looks it up as a module global).  Counts, actions,
totals and the alive mask must be exact; parameters agree at rtol 1e-6 /
atol 1e-6 (quaternion rotations sum in another order); moments are exact
(gathers and resets only).  The target downscale
(``F.interpolate(mode="bilinear", antialias=True)``) agrees with
``jax.image.resize(..., "linear")`` at atol 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from webdgs_tpu.ops import densify as jden
from webdgs_tpu.ops.adam import AdamState as JAdamState
from webdgs_tpu.train.config import DensifyPruneConfig as JCfg
from webdgs_tpu_torch.ops import densify as tden
from webdgs_tpu_torch.ops.adam import AdamState
from webdgs_tpu_torch.train.config import DensifyPruneConfig

from tests.torch_parity import both_scenes, np_, numpy_scene, t_

CFG = dict(prune_opacity=0.01, clone_threshold_count=500,
           split_scale_threshold=1.0, max_new_points_per_step=5000)


def _event_inputs(n, seed, max_new):
    """Both packages' scene, moments, counts and config, and the injected
    noise, for one event over ``n`` slots with dead slots."""
    rng = np.random.default_rng(seed)
    params = numpy_scene(n, seed=seed)
    params["opacity_logits"] = rng.uniform(-6, 4, n).astype(np.float32)
    params["log_scales"] = rng.uniform(-3, 0.5, (n, 3)).astype(np.float32)
    alive = rng.random(n) < 0.8
    js, ts = both_scenes(params)
    js = js.replace(alive=jnp.asarray(alive))
    ts = dataclasses.replace(ts, alive=torch.tensor(alive))
    m = rng.normal(size=(n, 59)).astype(np.float32)
    v = rng.random((n, 59)).astype(np.float32)
    jopt = JAdamState(m=jnp.asarray(m), v=jnp.asarray(v),
                      iteration=jnp.int32(7))
    topt = AdamState(m=t_(m), v=t_(v), iteration=7)
    metric = rng.choice([0, 400, 600, 900], size=n).astype(np.float32)
    noise = (rng.uniform(-1, 1, (n, 3)).astype(np.float32),
             rng.normal(size=(n, 3)).astype(np.float32))
    cfg = dict(CFG, max_new_points_per_step=max_new)
    return (js, jopt, JCfg(**cfg)), (ts, topt, DensifyPruneConfig(**cfg)), \
        metric, noise


def _inject(monkeypatch, noise):
    u, d = noise
    monkeypatch.setattr(jden, "densify_rng",
                        lambda key, n: (jnp.asarray(u[:n]),
                                        jnp.asarray(d[:n])))
    monkeypatch.setattr(tden, "densify_rng",
                        lambda gen, n: (t_(u[:n]), t_(d[:n])))


def test_decide_matches_jax():
    (js, _, jcfg), (ts, _, tcfg), metric, _ = _event_inputs(64, 20, 5000)
    jc, ja = jden.decide(js, jnp.asarray(metric), jcfg)
    tc, ta = tden.decide(ts, t_(metric), tcfg)
    assert tc.dtype == ta.dtype == torch.int32
    np.testing.assert_array_equal(np_(tc), np.asarray(jc))
    np.testing.assert_array_equal(np_(ta), np.asarray(ja))
    assert set(np_(ta).tolist()) == {0, 1, 2, 3}  # every action occurs


@pytest.mark.parametrize("max_out", [40, 25, 0])
def test_cap_counts_matches_jax(max_out):
    (js, _, jcfg), (ts, _, tcfg), metric, _ = _event_inputs(32, 21, 5000)
    jc, ja = jden.decide(js, jnp.asarray(metric), jcfg)
    tc, ta = tden.decide(ts, t_(metric), tcfg)
    jres = jden.cap_counts(jc, ja, jnp.int32(max_out))
    tres = tden.cap_counts(tc, ta, torch.tensor(max_out, dtype=torch.int32))
    for got, want in zip(tres, jres):
        np.testing.assert_array_equal(np_(got), np.asarray(want))


@pytest.mark.parametrize("seed,max_new", [(10, 5000), (11, 3), (12, 0)])
def test_densify_prune_matches_jax(monkeypatch, seed, max_new):
    """The whole event (the seeds and max_new of
    tests/test_densify.py:test_densify_event_randomized_oracle)."""
    (js, jopt, jcfg), (ts, topt, tcfg), metric, noise = _event_inputs(
        32, seed, max_new)
    _inject(monkeypatch, noise)
    want = jden.densify_prune(js, jopt, jnp.asarray(metric), jcfg,
                              jax.random.PRNGKey(seed))
    got = tden.densify_prune(ts, topt, t_(metric), tcfg,
                             torch.Generator().manual_seed(seed))
    for k in ("out_total", "in_alive", "n_cloned", "n_split", "n_pruned"):
        assert int(getattr(got, k)) == int(getattr(want, k)), k
    np.testing.assert_array_equal(np_(got.scene.alive),
                                  np.asarray(want.scene.alive))
    for k, v in want.scene.params().items():
        np.testing.assert_allclose(np_(got.scene.params()[k]), np.asarray(v),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(np_(got.opt_state.m),
                                  np.asarray(want.opt_state.m))
    np.testing.assert_array_equal(np_(got.opt_state.v),
                                  np.asarray(want.opt_state.v))
    assert got.opt_state.iteration == 7
    assert got.scene.capacity == ts.capacity


def test_compact_transform_matches_jax():
    """The transforms on a hand-made event: a prune, a clone, a split with
    its opacity clamped, and a boundary split degraded to keep."""
    n = 8
    params = numpy_scene(n, seed=22)
    params["opacity_logits"] = np.array([2., -6., 2., 2., 3., -6., 2., 2.],
                                        np.float32)
    params["log_scales"] = np.full((n, 3), -2.0, np.float32)
    params["log_scales"][4] = 0.3
    js, ts = both_scenes(params)
    metric = np.array([0., 0., 700., 0., 700., 0., 0., 700.], np.float32)
    rng = np.random.default_rng(23)
    u = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    m = np.ones((n, 59), np.float32)
    jopt = JAdamState(m=jnp.asarray(m), v=jnp.asarray(m),
                      iteration=jnp.int32(5))
    topt = AdamState(m=t_(m), v=t_(m), iteration=5)
    jcfg, tcfg = JCfg(**CFG), DensifyPruneConfig(**CFG)

    jc, ja = jden.decide(js, jnp.asarray(metric), jcfg)
    jc, ja, jt = jden.cap_counts(jc, ja, jnp.int32(n))
    want = jden.compact_transform(js.params(), jopt, jc, ja, jt,
                                  jnp.asarray(u), jnp.asarray(d))
    tc, ta = tden.decide(ts, t_(metric), tcfg)
    tc, ta, tt = tden.cap_counts(tc, ta, torch.tensor(n))
    assert int(tt) == n and int(ta[7]) == tden.ACTION_KEEP  # degraded
    got = tden.compact_transform(ts.params(), topt, tc, ta, tt, t_(u), t_(d))
    for k, v in want[0].items():
        np.testing.assert_allclose(np_(got[0][k]), np.asarray(v), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(np_(got[1].m), np.asarray(want[1].m))
    np.testing.assert_array_equal(np_(got[2]), np.asarray(want[2]))
    # split children mirror about the parent, scale divided by 1.6
    c0 = np_(got[0]["means"][4]) - params["means"][4]
    c1 = np_(got[0]["means"][5]) - params["means"][4]
    np.testing.assert_allclose(c0, -c1, atol=1e-6)
    assert float(got[0]["opacity_logits"][4]) == pytest.approx(
        tden.OPACITY_MAX_RAW)


def test_densify_rng_is_seeded():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    u1, d1 = tden.densify_rng(g1, 1000)
    u2, d2 = tden.densify_rng(g2, 1000)
    assert torch.equal(u1, u2) and torch.equal(d1, d2)
    assert u1.shape == d1.shape == (1000, 3)
    assert float(u1.min()) >= -1.0 and float(u1.max()) < 1.0
    assert abs(float(d1.mean())) < 0.1 and 0.9 < float(d1.std()) < 1.1
    u3, _ = tden.densify_rng(g1, 1000)  # the generator advances
    assert not torch.equal(u1, u3)


@pytest.mark.parametrize("src,dst", [((80, 60), (40, 30)),
                                     ((47, 33), (23, 16)),
                                     ((97, 55), (48, 27)),
                                     ((32, 24), (32, 24))])
def test_target_resize_matches_jax(src, dst):
    """The densify phase's target downscale (Trainer._run_densify)."""
    (w, h), (mw, mh) = src, dst
    imgs = np.random.default_rng(w).random((2, h, w, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(imgs), (2, mh, mw, 3),
                                       "linear"))
    got = F.interpolate(t_(imgs).permute(0, 3, 1, 2), size=(mh, mw),
                        mode="bilinear", align_corners=False,
                        antialias=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(np_(got), want, atol=1e-6, rtol=0)
