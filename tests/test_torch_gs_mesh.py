"""PyTorch port: the Gaussian-sharded training step on a 2x2 dp x band
mesh of gloo ranks (mirroring tests/test_sharding.py:284), against the JAX
single-device composition, at tests/test_torch_gs_step.py's tolerances;
and the same four processes as one band group, rendering and training
on a frame whose last band is padding."""

import jax
import jax.numpy as jnp
import numpy as np

from webdgs_tpu.ops import adam as jadam
from webdgs_tpu.ops.loss import LossConfig as JLossConfig
from webdgs_tpu.render.renderer import render as jrender
from webdgs_tpu.train.step import compute_param_grads

from tests.test_torch_gs_render import spawn
from tests.test_torch_gs_step import GROUPS, JS, PARAM_TOL, _concat, _gt_image
from tests.torch_parity import both_cameras, both_scenes, numpy_scene


def test_gs_train_step_2d_mesh(tmp_path):
    """:284 -- a 2x2 dp x band mesh (4 ranks): each mesh row trains its
    view band-sharded and the gradients are averaged over the dp group;
    against the JAX single-device composition (the two views' gradients
    summed, halved, then adam_step).  The same 4 processes as one band
    group render a 64x48 frame (3 tile rows: the fourth band is padding)
    against the JAX render."""
    w = h = 64
    positions = np.asarray([(0.15 * i, 0.0, -5.0) for i in range(2)],
                           np.float32)
    images = _gt_image(w, h, positions)
    inp = {"w": w, "h": h, "params": numpy_scene(64, seed=29),
           "positions": positions, "images": images, "mesh_shape": (2, 2),
           "render_size": (64, 48), "render_params": numpy_scene(80,
                                                                 seed=25)}
    res = spawn("gs_mesh2d", tmp_path, inp, 4)
    assert [(int(r["dp_rank"]), int(r["band_rank"])) for r in res] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]

    js, _ = both_scenes(inp["params"])
    params = js.params()
    grads = jax.tree.map(jnp.zeros_like, params)
    counts = jnp.zeros((js.capacity,), jnp.int32)
    for i, p in enumerate(positions):
        cam, _ = both_cameras(w, h, position=tuple(p))
        _, g, aux, _ = compute_param_grads(
            js, cam, jnp.asarray(images[i]), w, h, JLossConfig(), JS,
            parity_sh=True)
        grads = jax.tree.map(jnp.add, grads, g)
        counts = counts + aux.num_tiles
    grads = jax.tree.map(lambda x: x / 2, grads)
    ref, _ = jadam.adam_step(params, grads,
                             jadam.init_adam_state(params),
                             jadam.AdamHyperparameters(), counts)
    for k in GROUPS:
        for row in ((0, 1), (2, 3)):  # each mesh row holds the whole scene
            np.testing.assert_allclose(_concat(res, f"p_{k}", row),
                                       np.asarray(ref[k]), **PARAM_TOL,
                                       err_msg=k)
    for k in [k for k in res[0] if k.startswith("metric_")]:
        for r in res[1:]:
            np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)
    assert int(res[0]["metric_entries_dropped"]) == 0
    assert np.isfinite(res[0]["metric_loss"])

    rw, rh = inp["render_size"]
    js_r, _ = both_scenes(inp["render_params"])
    cam, _ = both_cameras(rw, rh)
    want = np.asarray(jrender(js_r, cam, rw, rh, JS).image)
    for r in res:
        assert int(r["render_dropped"]) == 0
        np.testing.assert_allclose(r["render_image"], want, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r["render_image"], r["render_single"],
                                   rtol=1e-5, atol=1e-5)
    assert not res[3]["render_band"].any()
    # the 4-band step: a ring of distinct neighbours and a padding band,
    # bit for bit the port's single-device step (the 2-rank case's
    # property)
    for k in GROUPS:
        np.testing.assert_array_equal(_concat(res, f"flat_p_{k}",
                                              (0, 1, 2, 3)),
                                      res[0][f"flat_single_p_{k}"],
                                      err_msg=k)
    assert int(res[0]["flat_metric_entries_dropped"]) == 0
