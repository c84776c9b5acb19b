"""PyTorch port: the Gaussian-sharded training step on gloo ranks, against
the JAX single-device step (mirroring tests/test_sharding.py:234 and :656; the JAX gs_train_step itself takes 145 s here, so tier-1 holds the
port against the single-device functions, as the JAX tests do).

Ranks are spawned as in tests/test_torch_gs_render.py; each holds 1/B of
the scene and of the Adam moments, and the parent concatenates the shards
in band order.  Tolerances: the updated parameters within rtol 2e-4 /
atol 2e-6 and the loss within rtol 1e-4 (tests/test_sharding.py:260-268),
``visible`` and ``tile_entries`` exact, the moments within rtol 1e-2 /
atol 1e-6 (:278); the f16 exchange at :656's f16-class bounds.  Against
the port's own single-device step the f32 exchange is bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest

from webdgs_tpu.ops import adam as jadam
from webdgs_tpu.ops.loss import LossConfig as JLossConfig
from webdgs_tpu.render.renderer import render as jrender
from webdgs_tpu.train.step import train_step

from tests.test_torch_gs_render import spawn
from tests.torch_parity import (both_cameras, both_scenes, jax_settings,
                                numpy_scene)

GROUPS = ("means", "quats", "log_scales", "opacity_logits", "sh")
PARAM_TOL = dict(rtol=2e-4, atol=2e-6)
JS = jax_settings(chunk=128, exchange_f16=False)


def _gt_image(w, h, positions):
    gt = numpy_scene(30, seed=28)
    gt["opacity_logits"] = gt["opacity_logits"] + 2.0
    js, _ = both_scenes(gt)
    return np.stack([np.asarray(jrender(
        js, both_cameras(w, h, position=tuple(p))[0], w, h, JS).image)
        for p in positions])


def _concat(res, key, ranks):
    return np.concatenate([res[r][key] for r in ranks])


def _jax_step(params, w, h, target):
    js, _ = both_scenes(params)
    cam, _ = both_cameras(w, h)
    return train_step(js, jadam.init_adam_state(js.params()), cam,
                      jnp.asarray(target), img_w=w, img_h=h,
                      loss_cfg=JLossConfig(), settings=JS)


@pytest.fixture(scope="module")
def step_case(tmp_path_factory):
    """:234 -- 64x64, 64 Gaussians (32 per rank), the target a brighter
    30-Gaussian scene; plus a 64x4 frame for the image-space branch."""
    w = h = 64
    inp = {"w": w, "h": h, "params": numpy_scene(64, seed=27),
           "target": _gt_image(w, h, [(0.0, 0.0, -5.0)])[0],
           "small_size": (64, 4),
           "small_target": np.random.default_rng(9).random(
               (4, 64, 3)).astype(np.float32)}
    return inp, spawn("gs_step", tmp_path_factory.mktemp("gs_step"), inp, 2)


@pytest.fixture(scope="module")
def jax_ref(step_case):
    inp, _ = step_case
    return _jax_step(inp["params"], inp["w"], inp["h"], inp["target"])


def _assert_matches(res, prefix, ref, ranks=(0, 1)):
    got = res[ranks[0]]
    assert int(got[f"{prefix}metric_entries_dropped"]) == 0
    np.testing.assert_allclose(got[f"{prefix}metric_loss"],
                               float(ref.metrics["loss"]), rtol=1e-4)
    for k in ("visible", "tile_entries"):
        assert int(got[f"{prefix}metric_{k}"]) == int(ref.metrics[k]), k
    for k in GROUPS:
        np.testing.assert_allclose(_concat(res, f"{prefix}p_{k}", ranks),
                                   np.asarray(ref.scene.params()[k]),
                                   **PARAM_TOL, err_msg=k)
    np.testing.assert_allclose(_concat(res, f"{prefix}m", ranks),
                               np.asarray(ref.opt_state.m), rtol=1e-2,
                               atol=1e-6)


def test_gs_train_step_matches_jax(step_case, jax_ref):
    _, res = step_case
    _assert_matches(res, "f32_", jax_ref)
    # the port's own single-device step, bit for bit: each Gaussian's entry
    # cotangents are summed in expansion order on both paths
    for k in GROUPS:
        np.testing.assert_array_equal(_concat(res, f"f32_p_{k}", (0, 1)),
                                      res[0][f"single_p_{k}"], err_msg=k)
    np.testing.assert_array_equal(_concat(res, "f32_m", (0, 1)),
                                  res[0]["single_m"])


def test_gs_train_step_ranks_agree_and_repeat(step_case):
    """Every rank reports the same metrics; two runs of the step give
    bit-identical shards and moments."""
    _, res = step_case
    metrics = [k for k in res[0] if "metric_" in k]
    assert {k.split("metric_")[1] for k in metrics if k.startswith(
        "f32_")} == {"loss", "l1", "l2", "dssim", "psnr", "visible",
                     "tile_entries", "entries_dropped", "entries_local_max",
                     "send_max"}
    for k in metrics:
        np.testing.assert_array_equal(res[1][k], res[0][k], err_msg=k)
    for r in res:
        for k in [k for k in r if k.startswith("f32_")]:
            np.testing.assert_array_equal(r["again_" + k[4:]], r[k],
                                          err_msg=k)
    assert int(res[0]["f32_metric_send_max"]) > 0
    assert int(res[0]["f32_metric_entries_local_max"]) > 0


def test_gs_train_step_f16_class(step_case, jax_ref):
    """:656 -- the f16 exchange rounds the forward rows only: the loss
    within rtol 2e-3, 97% of every parameter group tight and the rest
    within ~2 Adam steps, and the updated scenes render alike."""
    inp, res = step_case
    w, h = inp["w"], inp["h"]
    np.testing.assert_allclose(res[0]["f16_metric_loss"],
                               float(jax_ref.metrics["loss"]), rtol=2e-3)
    step_scale = {"means": 16e-5, "quats": 1e-3, "log_scales": 5e-3,
                  "opacity_logits": 5e-2, "sh": 2.5e-3}
    new = {}
    for k in GROUPS:
        ref_p = np.asarray(jax_ref.scene.params()[k])
        new[k] = _concat(res, f"f16_p_{k}", (0, 1))
        err = np.abs(new[k] - ref_p)
        assert np.mean(err <= 5e-3 * np.abs(ref_p) + 1e-5) > 0.97, k
        assert err.max() <= 8.0 * step_scale[k], (k, err.max())
    js_new, _ = both_scenes(new)
    cam, _ = both_cameras(w, h)
    f_ref = np.asarray(jrender(jax_ref.scene, cam, w, h, JS).image)
    f_new = np.asarray(jrender(js_new, cam, w, h, JS).image)
    assert np.abs(f_new - f_ref).max() < 2e-2


def test_gs_train_step_image_branch(step_case):
    """A 64x4 frame (under the 5x5 window) takes the image-space loss with
    2 halo rows; the second band lies wholly below the frame."""
    inp, res = step_case
    sw, sh = inp["small_size"]
    ref = _jax_step(inp["params"], sw, sh, inp["small_target"])
    _assert_matches(res, "small_", ref)


@pytest.mark.slow
def test_gs_train_step_matches_jax_gs_step(step_case):
    """The port against the JAX gs_train_step itself on a 2-device
    sub-mesh of conftest's virtual CPU devices (145 s here, so not in
    tier-1).  The JAX step reports ``tile_entries`` and
    ``entries_local_max`` before the tile cull (sums of the rect tile
    counts); the port reports the culled demand, as the single-device
    step's ``tile_entries`` is: those two are held to that relation."""
    import jax
    from jax.sharding import Mesh
    from webdgs_tpu.parallel.sharding import gs_train_step
    inp, res = step_case
    w, h = inp["w"], inp["h"]
    js, _ = both_scenes(inp["params"])
    cam, _ = both_cameras(w, h)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("band",))
    new_j, opt_j, m_j = gs_train_step(
        js, jadam.init_adam_state(js.params()), cam,
        jnp.asarray(inp["target"]), mesh, img_w=w, img_h=h,
        loss_cfg=JLossConfig(), settings=JS)
    got = res[0]
    np.testing.assert_allclose(got["f32_metric_loss"], float(m_j["loss"]),
                               rtol=1e-4)
    for k in ("visible", "send_max", "entries_dropped"):
        assert int(got[f"f32_metric_{k}"]) == int(m_j[k]), k
    assert int(got["f32_metric_tile_entries"]) <= int(m_j["tile_entries"])
    assert int(got["f32_metric_entries_local_max"]) <= int(
        m_j["entries_local_max"])
    for k in GROUPS:
        np.testing.assert_allclose(_concat(res, f"f32_p_{k}", (0, 1)),
                                   np.asarray(new_j.params()[k]),
                                   **PARAM_TOL, err_msg=k)
    np.testing.assert_allclose(_concat(res, "f32_m", (0, 1)),
                               np.asarray(opt_j.m), rtol=1e-2, atol=1e-6)
