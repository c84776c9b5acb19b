"""PyTorch port vs the JAX reference: the whole forward render (project ->
bin -> pack -> rasterize -> image) at sh_deg 0 and 3, with the tile cull on
and off, at the tolerances of tests/test_render_forward.py."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from webdgs_tpu.render import renderer as jrenderer
from webdgs_tpu_torch.render import renderer as trenderer

from tests.torch_parity import (IMG_ATOL, IMG_RTOL, NC_MISMATCH,
                                both_cameras, both_scenes, jax_settings, np_,
                                numpy_scene, torch_settings)


def _assert_render_close(got, want):
    np.testing.assert_allclose(np_(got.image), np.asarray(want.image),
                               rtol=IMG_RTOL, atol=IMG_ATOL)
    np.testing.assert_allclose(np_(got.accum), np.asarray(want.accum),
                               rtol=IMG_RTOL, atol=IMG_ATOL)
    np.testing.assert_allclose(np_(got.t_final), np.asarray(want.t_final),
                               rtol=IMG_RTOL, atol=IMG_ATOL)
    assert got.n_contrib.dtype == torch.int32
    mismatch = np.mean(np_(got.n_contrib) != np.asarray(want.n_contrib))
    assert mismatch <= NC_MISMATCH, f"n_contrib mismatch {mismatch:.4f}"


@pytest.mark.parametrize("n,size,sh_deg,cull,pos", [
    (300, (96, 80), 0, True, (0.0, 0.0, -5.0)),
    (250, (80, 96), 3, True, (0.3, -0.2, -4.5)),
    (200, (64, 48), 3, False, (0.0, 0.0, -5.0)),
])
def test_render_matches_jax(n, size, sh_deg, cull, pos):
    w, h = size
    params = numpy_scene(n, seed=40 + sh_deg)
    js, ts = both_scenes(params, sh_deg=sh_deg)
    jc, tc = both_cameras(w, h, position=pos)
    want = jrenderer.render(js, jc, w, h, jax_settings(tile_cull=cull))
    with torch.no_grad():
        got = trenderer.render(ts, tc, w, h, torch_settings(tile_cull=cull))
    assert got.image.shape == (h, w, 3)
    assert float(got.accum[..., 3].max()) > 0.1, "frame should have content"
    _assert_render_close(got, want)
    assert int(got.binning.total_entries) == int(want.binning.total_entries)
    assert int(got.binning.expansion_entries) == \
        int(want.binning.expansion_entries)


def test_render_capacity_and_background_match_jax():
    """A tight entry capacity drops whole Gaussians the same way, and the
    background composites behind T_final."""
    w, h = 64, 48
    params = numpy_scene(150, seed=51)
    js, ts = both_scenes(params)
    jc, tc = both_cameras(w, h)
    bg = (0.2, 0.3, 0.4)
    want = jrenderer.render(js, jc, w, h, jax_settings(background=bg),
                            entry_capacity=128)
    got = trenderer.render(ts, tc, w, h, torch_settings(background=bg),
                           entry_capacity=128)
    assert int(want.binning.expansion_entries) > 128
    assert got.binning.capacity == 128
    _assert_render_close(got, want)


def test_empty_scene_renders_background():
    params = numpy_scene(8)
    _, ts = both_scenes(params)
    ts.alive[:] = False
    _, tc = both_cameras(32, 32)
    res = trenderer.render(ts, tc, 32, 32,
                           torch_settings(background=(0.2, 0.3, 0.4)))
    np.testing.assert_allclose(
        np_(res.image),
        np.broadcast_to(np.array([0.2, 0.3, 0.4], np.float32), (32, 32, 3)),
        atol=1e-6)
    assert np.all(np_(res.t_final) == 1.0)


def test_render_points_matches_jax():
    w, h = 64, 48
    params = numpy_scene(60, seed=34)
    js, ts = both_scenes(params)
    jc, tc = both_cameras(w, h)
    want = jrenderer.render_points(js, jc, w, h, jax_settings(),
                                   point_size_px=2.0)
    got = trenderer.render_points(ts, tc, w, h, torch_settings(),
                                  point_size_px=2.0)
    img = np_(got)
    lit = img[..., 0] > 0.5
    assert lit.any() and (img[lit][:, 2] < 1e-5).all()  # yellow dots
    np.testing.assert_allclose(img, np.asarray(want), rtol=IMG_RTOL,
                               atol=IMG_ATOL)


def test_frames_past_the_tile_key_limit_raise(monkeypatch):
    """An 8192x4352 frame (69,632 tiles at 32x16) renders in two bands of
    136 tile rows, each under the 16-bit tile-key limit, assembled to the
    full height; a single band still raises ``check_tile_key_limit``'s
    ValueError, and 7680x4320 (64,800 tiles) stays one plain render.  The
    bands are stubbed one pixel wide (background 0: each band's value
    passes the composite): the plan is checked, not the pixels."""
    from webdgs_tpu_torch.ops import binning as tbin
    from webdgs_tpu_torch.ops.projection import restrict_aux_to_band
    w, h = 8192, 4352
    _, ts = both_scenes(numpy_scene(40, seed=2))
    _, tc = both_cameras(w, h)
    s = torch_settings()
    bands = []

    def band(attrs, aux, row0, img_w, rows, ntx, settings, cap):
        tbin.check_tile_key_limit(ntx * rows)
        n = restrict_aux_to_band(aux, row0, rows).num_tiles.sum()
        bands.append((row0, rows, ntx))
        return (torch.full((rows * settings.tile_h, 1, 8),
                           float(len(bands))), n)

    monkeypatch.setattr(trenderer, "_render_band", band)
    img, ent = trenderer.render_banded(ts, tc, w, h, s, return_entries=True)
    assert bands == [(0, 136, 256), (136, 136, 256)]
    assert img.shape == (h, 1, 3)
    assert float(img[0, 0, 0]) == 1.0 and float(img[-1, 0, 0]) == 2.0
    assert int(ent) > 0
    with pytest.raises(ValueError, match="tile-key limit"):
        trenderer.render_banded(ts, tc, w, h, s, bands=1)
    plain = []
    monkeypatch.setattr(trenderer, "render", lambda *a, **k: plain.append(
        a[2:4]) or SimpleNamespace(image="the plain image"))
    got = trenderer.render_banded(ts, both_cameras(7680, 4320)[1], 7680,
                                  4320, s)
    assert got == "the plain image" and plain == [(7680, 4320)]
    assert len(bands) == 2
