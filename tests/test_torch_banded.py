"""PyTorch port: serial-band rendering above the 16-bit tile-key limit.

The cases of tests/test_banded_render.py against the port's own plain
render (rtol/atol 1e-5), and the JAX reference at the same numpy inputs:
``restrict_aux_to_band`` exactly, ``render_banded(bands=3)`` in both modes
at the image tolerances of tests/test_torch_render.py.
"""

import numpy as np
import pytest
import torch

from webdgs_tpu.ops.projection import project_gaussians as jproject
from webdgs_tpu.ops.projection import restrict_aux_to_band as jrestrict
from webdgs_tpu.render import renderer as jrenderer
from webdgs_tpu_torch.ops import binning as binning_ops
from webdgs_tpu_torch.ops.projection import (project_gaussians,
                                             restrict_aux_to_band)
from webdgs_tpu_torch.render import renderer as trenderer
from webdgs_tpu_torch.render import viewer as tviewer

from tests.torch_parity import (IMG_ATOL, IMG_RTOL, both_cameras,
                                both_scenes, jax_settings, np_, numpy_scene,
                                torch_settings)

TOL = dict(rtol=1e-5, atol=1e-5)


def _scene_cam(n, seed, w, h):
    _, ts = both_scenes(numpy_scene(n, seed=seed))
    _, tc = both_cameras(w, h)
    return ts, tc


@pytest.mark.parametrize("bands", [2, 3])
def test_banded_matches_plain(bands):
    w, h = 64, 96
    ts, tc = _scene_cam(97, 11, w, h)
    s = torch_settings()
    ref = trenderer.render(ts, tc, w, h, s).image
    got = trenderer.render_banded(ts, tc, w, h, s, bands=bands)
    assert got.shape == ref.shape == (h, w, 3)
    np.testing.assert_allclose(np_(got), np_(ref), **TOL)


def test_banded_auto_single_band_is_plain():
    w, h = 64, 48
    ts, tc = _scene_cam(50, 3, w, h)
    s = torch_settings()
    ref = trenderer.render(ts, tc, w, h, s).image
    got = trenderer.render_banded(ts, tc, w, h, s)
    np.testing.assert_allclose(np_(got), np_(ref), **TOL)


def test_band_count_math():
    """The auto band count keeps every band under the limit and covers the
    grid: at the default 32x16 tiles a DCI 8K frame (8192x4320, 69,120
    tiles) takes 2 bands; at 16x16 tiles 7680x4320 (129,600 tiles) takes
    more, and the whole grid raises in one band."""
    for s in (torch_settings(), torch_settings(tile_w=16, tile_h=16)):
        for w, h in [(8192, 4320), (7680, 4320), (4096, 4096),
                     (3840, 2160)]:
            ntx, nty = binning_ops.tile_grid(w, h, s)
            rows_max = max((binning_ops.TILE_KEY_LIMIT - 1) // ntx, 1)
            bands = -(-nty // rows_max)
            rows = -(-nty // bands)
            assert ntx * rows < binning_ops.TILE_KEY_LIMIT
            assert bands * rows >= nty > (bands - 1) * rows
            if ntx * nty >= binning_ops.TILE_KEY_LIMIT:
                assert bands > 1
                with pytest.raises(ValueError):
                    binning_ops.check_tile_key_limit(ntx * nty)
    ntx, nty = binning_ops.tile_grid(8192, 4320, torch_settings())
    assert (ntx, nty) == (256, 270)
    assert -(-nty // ((binning_ops.TILE_KEY_LIMIT - 1) // ntx)) == 2


def test_banded_nonuniform_last_band():
    """Band rows that do not divide the grid: the tail band is padded and
    cropped, not wrapped."""
    w, h = 64, 80  # 5 tile rows: bands of 2, the last holds 1
    ts, tc = _scene_cam(64, 7, w, h)
    s = torch_settings()
    ref = trenderer.render(ts, tc, w, h, s).image
    got = trenderer.render_banded(ts, tc, w, h, s, bands=3)
    np.testing.assert_allclose(np_(got), np_(ref), **TOL)


def test_banded_pointcloud_matches_plain():
    w, h = 64, 96
    ts, tc = _scene_cam(80, 5, w, h)
    s = torch_settings()
    ref = trenderer.render_points(ts, tc, w, h, s, point_size_px=3.0)
    got = trenderer.render_banded(ts, tc, w, h, s, bands=3,
                                  mode="pointcloud", point_size_px=3.0)
    assert float(got[..., 0].max()) > 0.5  # yellow dots
    np.testing.assert_allclose(np_(got), np_(ref), **TOL)


def test_banded_return_entries():
    """``return_entries`` gives the largest per-band pre-drop demand as a
    device scalar; one band gives the frame's."""
    w, h = 64, 96
    ts, tc = _scene_cam(97, 11, w, h)
    s = torch_settings()
    img, ent = trenderer.render_banded(ts, tc, w, h, s, bands=2,
                                       return_entries=True)
    assert img.shape == (h, w, 3)
    assert isinstance(ent, torch.Tensor) and ent.dim() == 0
    assert int(ent) > 0
    img1, ent1 = trenderer.render_banded(ts, tc, w, h, s, bands=1,
                                         return_entries=True)
    full = trenderer.render(ts, tc, w, h, s).binning.expansion_entries
    assert int(ent1) == int(full)
    assert int(full) // 2 <= int(ent) <= int(full)


def test_viewer_banded_branch_adapts_capacity(monkeypatch):
    """With the tile-key limit lowered below the frame's 12 tiles, the
    Viewer renders through render_banded in both modes, matches the plain
    frame, and adapts its entry capacity from the largest band."""
    w, h = 64, 96  # 2 x 6 tiles at 32x16
    ts, _ = _scene_cam(64, 9, w, h)
    v = tviewer.Viewer(ts, width=w, height=h, device="cpu")
    v.frame_scene()
    plain = v.render()
    calls = []
    real = tviewer.render_banded

    def spy(*args, **kw):
        calls.append(kw["mode"])
        return real(*args, **kw)

    monkeypatch.setattr(tviewer, "render_banded", spy)
    monkeypatch.setattr(binning_ops, "TILE_KEY_LIMIT", 7)  # bands of 3 rows
    v._entry_budget.value = None
    img = v.render()
    assert calls == ["gaussian"]
    assert img.shape == (h, w, 3)
    np.testing.assert_allclose(img, plain, **TOL)
    assert v._entry_budget.value is not None
    assert v._entry_budget.value > 0
    assert 0 < v.entry_demand
    cap = v._entry_budget.value
    v.set_render_mode("pointcloud")
    img2 = v.render()
    assert calls == ["gaussian", "pointcloud"]
    assert img2.shape == (h, w, 3)
    assert v._entry_budget.value == cap  # the point bands keep the capacity


@pytest.mark.parametrize("row0,rows", [(0, 2), (1, 2), (2, 3), (5, 4)])
def test_restrict_aux_to_band_matches_jax(row0, rows):
    """Exact against the reference, with row0 as a Python int and as a 0-d
    tensor."""
    w, h = 64, 96
    params = numpy_scene(120, seed=17)
    js, ts = both_scenes(params)
    jc, tc = both_cameras(w, h)
    _, jaux = jproject(js.params(), js.alive, jc, w, h, 0, jax_settings())
    _, taux = project_gaussians(ts.params(), ts.alive, tc, w, h, 0,
                                torch_settings())
    want = jrestrict(jaux, np.int32(row0), rows)
    for r0 in (row0, torch.tensor(row0)):
        got = restrict_aux_to_band(taux, r0, rows)
        assert int(got.visible.sum()) > 0 or row0 >= 5
        for name in want._fields:
            g, e = np_(getattr(got, name)), np.asarray(getattr(want, name))
            if g.dtype.kind == "f":
                np.testing.assert_array_equal(g, e, err_msg=name)
            else:
                np.testing.assert_array_equal(g.astype(e.dtype), e,
                                              err_msg=name)
        assert got.num_tiles.dtype == got.tile_min.dtype == torch.int32


@pytest.mark.parametrize("mode", ["gaussian", "pointcloud"])
def test_render_banded_matches_jax(mode):
    w, h = 64, 96
    params = numpy_scene(110, seed=23)
    js, ts = both_scenes(params)
    jc, tc = both_cameras(w, h)
    want = jrenderer.render_banded(js, jc, w, h, jax_settings(), bands=3,
                                   mode=mode, point_size_px=2.5)
    got = trenderer.render_banded(ts, tc, w, h, torch_settings(), bands=3,
                                  mode=mode, point_size_px=2.5)
    assert float(got.max()) > 0.1
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=IMG_RTOL,
                               atol=IMG_ATOL)


def test_render_banded_reads_nothing_back(monkeypatch):
    """A banded frame reads nothing back to the host: every tensor method
    that would copy to the host raises while it renders in both modes,
    except inside the forward's plain version, which stands in for the
    kernel on the CPU; the image is the same bit for bit."""
    from webdgs_tpu_torch.ops import rasterize as tras
    w, h = 64, 96
    ts, tc = _scene_cam(60, 4, w, h)
    s = torch_settings()
    ref = trenderer.render_banded(ts, tc, w, h, s, bands=3)
    plain = tras.rasterize_tiles_plain
    armed = [True]

    def guard(method):
        orig = getattr(torch.Tensor, method)

        def read(self, *a, **k):
            if armed[0]:
                raise AssertionError(f"host read: Tensor.{method}")
            return orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, method, read)

    def unguarded_plain(*a, **k):
        armed[0] = False
        try:
            return plain(*a, **k)
        finally:
            armed[0] = True

    for method in ("tolist", "item", "__bool__", "__int__", "__float__",
                   "__index__", "numpy"):
        guard(method)
    monkeypatch.setattr(tras, "rasterize_tiles_plain", unguarded_plain)
    try:
        with torch.no_grad():
            got, ent = trenderer.render_banded(ts, tc, w, h, s, bands=3,
                                               return_entries=True)
            pts = trenderer.render_banded(ts, tc, w, h, s, bands=3,
                                          mode="pointcloud")
    finally:
        armed[0] = False
    monkeypatch.undo()
    np.testing.assert_array_equal(np_(got), np_(ref))
    assert pts.shape == (h, w, 3) and int(ent) > 0
