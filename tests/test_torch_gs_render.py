"""PyTorch port: the Gaussian-sharded render on gloo ranks, against the
JAX single-device render and the port's own (mirroring
tests/test_sharding.py:189, :209 and :634).

Each case spawns CPU ranks with ``torch.multiprocessing.spawn`` (a
``file://`` store under ``tmp_path``, 60 s group timeout); they run a case
of tests/torch_dist_workers.py (no jax), each rank holding 1/B of the
Gaussians, and save their arrays.  The JAX render runs here.  With the f32
exchange the frame must match within 1e-5 (tests/test_sharding.py:189);
with the default f16 exchange within the f16 class, max < 2e-2 and mean
< 2e-4 (:634)."""

import os

import numpy as np
import pytest
import torch.multiprocessing as mp

from webdgs_tpu.render.renderer import render as jrender

from tests import torch_dist_workers as workers
from tests.torch_parity import (both_cameras, both_scenes, jax_settings,
                                numpy_scene)

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def spawn(case: str, out_dir, inp: dict, world: int) -> list[dict]:
    """Run ``case`` on ``world`` gloo ranks; their saved arrays, by rank."""
    out_dir = str(out_dir)
    mp.spawn(workers.rank_main,
             args=(world, os.path.join(out_dir, "store"), case, out_dir,
                   inp), nprocs=world, join=True)
    return [dict(np.load(os.path.join(out_dir, f"{case}_r{r}.npz")))
            for r in range(world)]


def jax_image(params, w, h) -> np.ndarray:
    js, _ = both_scenes(params)
    cam, _ = both_cameras(w, h)
    return np.asarray(jrender(js, cam, w, h, jax_settings(chunk=128)).image)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """:189 / :634 at 64x64 (80 Gaussians, 40 per rank) and :209's
    concentrated 400-Gaussian scene."""
    drop = numpy_scene(400, seed=26)
    drop["log_scales"] = drop["log_scales"] + 1.5
    inp = {"w": 64, "h": 64, "params": numpy_scene(80, seed=25),
           "drop_params": drop}
    return inp, spawn("gs_render", tmp_path_factory.mktemp("gs2"), inp, 2)


def test_gs_render_two_ranks_matches_jax(two_ranks):
    inp, res = two_ranks
    want = jax_image(inp["params"], 64, 64)
    assert want.max() > 0.1
    for r in res:
        assert r["f32_image"].shape == (64, 64, 3)
        assert int(r["f32_dropped"]) == 0
        np.testing.assert_allclose(r["f32_image"], want, **F32_TOL)
        np.testing.assert_allclose(r["f32_image"], r["single"], **F32_TOL)
        assert r["f32_band"].shape == (32, 64, 3)
    np.testing.assert_array_equal(
        np.concatenate([r["f32_band"] for r in res]), res[0]["f32_image"])


def test_gs_render_f16_class(two_ranks):
    inp, res = two_ranks
    want = jax_image(inp["params"], 64, 64)
    for r in res:
        assert int(r["f16_dropped"]) == 0
        err = np.abs(r["f16_image"] - want)
        assert err.max() < 2e-2, err.max()
        assert err.mean() < 2e-4, err.mean()
    np.testing.assert_array_equal(res[0]["f16_image"], res[1]["f16_image"])


def test_gs_render_drop_budget(two_ranks):
    """A one-chunk send budget at 16x16 tiles overflows: the frame degrades
    but stays finite, and every rank reports the same drops."""
    _, res = two_ranks
    for r in res:
        assert r["drop_image"].shape == (64, 64, 3)
        assert np.isfinite(r["drop_image"]).all()
        assert int(r["drop_dropped"]) > 0
    assert int(res[0]["drop_dropped"]) == int(res[1]["drop_dropped"])


def test_gs_render_four_ranks_with_padding_band(tmp_path):
    """64x48 is 3 tile rows: on 4 ranks the last band lies wholly below
    the frame (an empty band)."""
    inp = {"w": 64, "h": 48, "params": numpy_scene(80, seed=25)}
    res = spawn("gs_render", tmp_path, inp, 4)
    want = jax_image(inp["params"], 64, 48)
    for r in res:
        assert int(r["f32_dropped"]) == 0
        np.testing.assert_allclose(r["f32_image"], want, **F32_TOL)
        np.testing.assert_allclose(r["f32_image"], r["single"], **F32_TOL)
        assert r["f32_band"].shape == (16, 64, 3)
    assert not res[3]["f32_band"].any()  # padding: background only
