"""PyTorch port vs the JAX reference: the densification importance counts
(``ops/importance.py``).

The flag map, the per-entry replay (``entry_counts``, its plain version on
the CPU, against the JAX kernel ``_entry_counts`` in interpret mode on the
same ``attrs16``/offsets/pixel tiles) and the per-Gaussian counts of one
view and of several.  Tolerances: flags equal on >= 99.9 % of pixels (the
normalised error of pixels at the threshold may round either way); entry
counts equal on >= 99.5 % of valid slots with their sum within 0.5 % (the
0.5 % n_contrib budget of the forward raster); per-Gaussian counts within
0.5 on >= 99.5 % of Gaussians.  A brute-force replay of every pixel's tile
prefix checks the port on its own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webdgs_tpu.ops import binning as jbin
from webdgs_tpu.ops import importance as jimp
from webdgs_tpu.ops import rasterize as jras
from webdgs_tpu.ops.projection import project_gaussians as jproject
from webdgs_tpu_torch.core.camera import default_camera
from webdgs_tpu_torch.ops import binning as tbin
from webdgs_tpu_torch.ops import importance as timp
from webdgs_tpu_torch.ops import rasterize as tras
from webdgs_tpu_torch.ops.projection import project_gaussians as tproject
from webdgs_tpu_torch.render.renderer import render

from tests.test_torch_cuda import IMPORTANCE_CASES, crafted_importance_case
from tests.torch_parity import (both_cameras, both_scenes, jax_settings, np_,
                                numpy_scene, t_, torch_settings)

FLAG_AGREE = 0.999
SLOT_AGREE = 0.995
SUM_RTOL = 0.005


def _noisy_target(shape, seed, base=None):
    rng = np.random.default_rng(seed)
    noise = rng.normal(0.0, 0.2, shape).astype(np.float32)
    return noise if base is None else (np.asarray(base) + noise)


@pytest.mark.parametrize("seed,threshold", [(0, 0.5), (1, 0.2), (2, -1.0)])
def test_metric_flag_map_matches_jax(seed, threshold):
    rng = np.random.default_rng(seed)
    pred = rng.random((37, 53, 3)).astype(np.float32)
    target = rng.random((37, 53, 3)).astype(np.float32)
    got = np_(timp.metric_flag_map(t_(pred), t_(target), threshold))
    want = np.asarray(jimp.metric_flag_map(jnp.asarray(pred),
                                           jnp.asarray(target), threshold))
    assert got.dtype == np.float32 and got.shape == (37, 53)
    assert np.mean(got == want) >= FLAG_AGREE
    # constant error: the normalised map is 0, so no pixel is flagged
    flat = timp.metric_flag_map(t_(pred), t_(pred), 0.5)
    assert not flat.any()


def _jax_view(n, seed, w, h, threshold, spread=1.0):
    """The JAX side of one importance view: entry rows, offsets and the
    (flag, n_contrib) pixel tiles, as view_importance_counts builds them."""
    params = numpy_scene(n, seed=seed, spread=spread)
    js, _ = both_scenes(params)
    jc, _ = both_cameras(w, h)
    s = jax_settings()
    attrs, aux = jproject(js.params(), js.alive, jc, w, h, 0, s)
    bins = jbin.bin_splats(aux, w, h, s, attrs=attrs, with_source=False)
    a16 = jras.pack_entry_attrs(attrs, bins.entry_gauss, bins.entry_valid, s)
    ntx, nty = jbin.tile_grid(w, h, s)
    out = jras.rasterize_tiles(a16, bins.tile_offsets, ntx, nty, s)
    tiles = jras.tiles_to_image(out, ntx, nty, w, h, s)
    pred = jras.composite_background(tiles, s)
    target = _noisy_target((h, w, 3), seed + 100, base=pred)
    flag = jimp.metric_flag_map(pred, jnp.asarray(target), threshold)
    pix = jnp.stack([flag, tiles[..., jras.OUT_NCONTRIB]], axis=-1)
    pix_tiles = jras.image_to_tiles(pix, ntx, nty, s)
    return a16, bins, pix_tiles, ntx, nty


@pytest.mark.parametrize("n,seed,w,h,threshold", [
    (300, 3, 96, 80, 0.5),
    (400, 4, 130, 70, 0.2),   # ragged tile grid
    (250, 5, 64, 48, -1.0),   # every pixel flagged
])
def test_entry_counts_plain_matches_jax(n, seed, w, h, threshold):
    a16, bins, pix_tiles, ntx, nty = _jax_view(n, seed, w, h, threshold)
    want = np.asarray(jimp._entry_counts(a16, bins.tile_offsets, pix_tiles,
                                         ntx, nty, jax_settings())[0])
    launches = timp.entry_counts.kernel_launches
    got = timp.entry_counts(t_(a16), t_(bins.tile_offsets), t_(pix_tiles),
                            ntx, nty, torch_settings())
    assert timp.entry_counts.kernel_launches == launches  # CPU: plain
    assert got.shape == (bins.capacity,) and got.dtype == torch.float32
    got = np_(got)
    total = int(bins.total_entries)
    assert want[:total].sum() > 0, "test view should have contributors"
    assert np.mean(got[:total] == want[:total]) >= SLOT_AGREE
    np.testing.assert_allclose(got[:total].sum(), want[:total].sum(),
                               rtol=SUM_RTOL)
    assert not got[total:].any()
    assert got.max() <= 512 and np.all(got == np.round(got))


def test_entry_counts_blocking_is_invisible():
    """The chunk and the two work bounds (flag-free tiles, chunks past the
    largest flagged n_contrib) change no count."""
    a16, bins, pix_tiles, ntx, nty = _jax_view(300, 6, 96, 64, 0.4)
    args = (t_(a16), t_(bins.tile_offsets), t_(pix_tiles), ntx, nty)
    full = timp.entry_counts_plain(*args, torch_settings())
    for chunk in (16, 40):
        other = timp.entry_counts_plain(*args, torch_settings(chunk=chunk))
        assert torch.equal(other, full)
    # unflag everything: nothing counts
    none = t_(pix_tiles).clone()
    none[..., 0] = 0.0
    assert not timp.entry_counts_plain(args[0], args[1], none, ntx, nty,
                                       torch_settings()).any()


def test_entry_counts_checks_inputs():
    a16 = torch.zeros((16, 256))
    off = torch.zeros(3, dtype=torch.int32)
    pix = torch.zeros((2, 512, 2))
    s = torch_settings()
    timp.entry_counts(a16, off, pix, 2, 1, s)
    with pytest.raises(ValueError):
        timp.entry_counts(a16[:12], off, pix, 2, 1, s)
    with pytest.raises(ValueError):
        timp.entry_counts(a16, off.long(), pix, 2, 1, s)
    with pytest.raises(ValueError):
        timp.entry_counts(a16, off, pix[:, :, :1], 2, 1, s)
    with pytest.raises(ValueError, match="multiple of 32"):
        timp.entry_counts(a16, off, torch.zeros((2, 15 * 16, 2)), 2, 1,
                          torch_settings(tile_w=15))
    with pytest.raises(ValueError, match="at most 1024"):
        timp.entry_counts(a16, off, torch.zeros((2, 64 * 32, 2)), 2, 1,
                          torch_settings(tile_w=64, tile_h=32))
    # ranges outside attrs16 are clamped to [0, E], as the kernel clamps
    # them: no read back, no error, the clamped ranges' counts
    a16c, _, pixc, _, _ = crafted_importance_case("all_flagged", seed=1)
    a16c, pixc = t_(a16c), t_(pixc)
    e_len = a16c.shape[1]
    for bad in ([0, 5, e_len + 88], [-1, 0, 0], [-9, 200, 2 ** 30]):
        bad = torch.tensor(bad, dtype=torch.int32)
        got = timp.entry_counts(a16c, bad, pixc, 2, 1, s)
        want = timp.entry_counts_plain(a16c, bad.clamp(0, e_len), pixc, 2,
                                       1, s)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float(got.sum()) > 0


def _torch_view(n, seed, w, h, threshold):
    """One importance view's inputs built by the port on the CPU: entry
    rows, offsets, (flag, n_contrib) pixel tiles and the tile grid."""
    _, ts = both_scenes(numpy_scene(n, seed=seed))
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0), device="cpu")
    s = torch_settings()
    attrs, aux = tproject(ts.params(), ts.alive, cam, w, h, 0, s)
    bins = tbin.bin_splats(aux, w, h, s, attrs=attrs)
    a16 = tras.pack_entry_attrs(attrs, bins.entry_gauss, bins.entry_valid)
    ntx, nty = tbin.tile_grid(w, h, s)
    out = tras.rasterize_tiles(a16, bins.tile_offsets, ntx, nty, s)
    tiles = tras.tiles_to_image(out, ntx, nty, w, h, s)
    pred = tras.composite_background(tiles, s)
    target = t_(_noisy_target((h, w, 3), seed + 100, base=np_(pred)))
    flag = timp.metric_flag_map(pred, target, threshold)
    pix = torch.stack([flag, tiles[..., tras.OUT_NCONTRIB]], dim=-1)
    pix_tiles = tras.image_to_tiles(pix, ntx, nty, s).contiguous()
    return a16, bins.tile_offsets, pix_tiles, ntx, nty


@pytest.mark.parametrize("fault", ["past_end", "below_zero", "both"])
def test_entry_counts_clamps_out_of_range_offsets(fault):
    """Tile ranges reaching outside [0, E]: the wrapper (plain on the CPU)
    gives what the plain version gives on the clamped offsets, bit for
    bit, as the kernel clamps them."""
    a16, off, pix, ntx, nty = _torch_view(300, 3, 96, 80, 0.3)
    e_len = a16.shape[1]
    bad = off.clone()
    if fault in ("past_end", "both"):
        bad[-3:] = torch.tensor([e_len - 5, e_len + 5, 2 ** 30],
                                dtype=torch.int32)
    if fault in ("below_zero", "both"):
        bad[0:2] = torch.tensor([-7, -2], dtype=torch.int32)
    clamped = bad.clamp(0, e_len)
    assert not torch.equal(bad, clamped)
    s = torch_settings()
    want = timp.entry_counts_plain(a16, clamped, pix, ntx, nty, s)
    got = timp.entry_counts(a16, bad, pix, ntx, nty, s)
    assert got.shape == (e_len,) and float(want.sum()) > 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_entry_counts_reads_nothing_back(monkeypatch):
    """The wrapper reads nothing back to the host (the kernel clamps the
    ranges itself): every host read of a tensor raises while it runs,
    except inside the plain version that stands in for the kernel on the
    CPU; the result is the plain version's, bit for bit."""
    a16, off, pix, ntx, nty = _torch_view(200, 4, 64, 48, 0.3)
    args = (a16, off, pix, ntx, nty, torch_settings())
    plain = timp.entry_counts_plain
    want = plain(*args)
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
    monkeypatch.setattr(timp, "entry_counts_plain", unguarded_plain)
    got = timp.entry_counts(*args)
    armed[0] = False
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float(want.sum()) > 0
    # the guard does catch a read
    armed[0] = True
    with pytest.raises(AssertionError, match="host read"):
        off.tolist()
    armed[0] = False


@pytest.mark.parametrize("case", IMPORTANCE_CASES)
def test_entry_counts_crafted_cases_match_jax(case):
    """Crafted inputs (tests/test_torch_cuda.py:crafted_importance_case)
    through the JAX kernel in interpret mode and the port: every alpha lies
    clearly above or below alpha_min and no pixel centre near a box edge,
    so every slot is equal, with no tolerance."""
    a16, off, pix, ntx, nty = crafted_importance_case(case, seed=11)
    want = np.asarray(jimp._entry_counts(
        jnp.asarray(a16), jnp.asarray(off), jnp.asarray(pix), ntx, nty,
        jax_settings())[0])
    got = np_(timp.entry_counts(t_(a16), t_(off), t_(pix), ntx, nty,
                                torch_settings()))
    np.testing.assert_array_equal(got, want)
    assert not got[off[-1]:].any()
    if case == "nc_zero":
        # tile 0's flagged pixels all have n_contrib 0: nothing counts
        assert not got[off[0]:off[1]].any() and got.sum() > 0
    else:
        assert got[off[0]:off[1]].sum() > 0 and got[off[1]:off[2]].sum() > 0


def _both_counts(n, seed, w, h, threshold, views):
    params = numpy_scene(n, seed=seed, spread=1.2)
    js, ts = both_scenes(params, sh_deg=1)
    positions = [(0.3 * i - 0.2, 0.1 * i, -5.0) for i in range(views)]
    cams = [both_cameras(w, h, position=p) for p in positions]
    targets = np.stack([_noisy_target((h, w, 3), seed + 10 * i)
                        for i in range(views)])
    targets = np.clip(targets + 0.5, 0.0, 1.0)
    js_, ts_ = jax_settings(), torch_settings()
    if views == 1:
        want = jimp.view_importance_counts(
            js.params(), js.alive, js.sh_deg, cams[0][0],
            jnp.asarray(targets[0]), w, h, threshold, js_)
        got = timp.view_importance_counts(
            ts.params(), ts.alive, ts.sh_deg, cams[0][1], t_(targets[0]), w,
            h, threshold, ts_)
    else:
        jcams = jax.tree.map(lambda *xs: jnp.stack(xs), *[c[0] for c in cams])
        want = jimp.multiview_importance_counts(
            js.params(), js.alive, js.sh_deg, jcams, jnp.asarray(targets), w,
            h, threshold, js_)
        got = timp.multiview_importance_counts(
            ts.params(), ts.alive, ts.sh_deg, [c[1] for c in cams],
            t_(targets), w, h, threshold, ts_)
    return np_(got), np.asarray(want)


@pytest.mark.parametrize("n,seed,w,h,threshold,views", [
    (300, 7, 96, 80, 0.3, 1),
    (200, 8, 64, 48, 0.5, 3),
])
def test_view_and_multiview_counts_match_jax(n, seed, w, h, threshold,
                                             views):
    got, want = _both_counts(n, seed, w, h, threshold, views)
    assert got.shape == want.shape == (n,) and got.dtype == np.float32
    assert want.sum() > 0, "test views should flag contributors"
    assert np.mean(np.abs(got - want) <= 0.5) >= SLOT_AGREE


def test_importance_counts_match_bruteforce():
    """Replay each flagged pixel's tile prefix in numpy (the brute force of
    tests/test_densify.py) against the port's counts, every pixel
    flagged."""
    w, h = 32, 32
    params = numpy_scene(20, seed=5)
    _, ts = both_scenes(params)
    s = torch_settings()
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0), device="cpu")
    res = render(ts, cam, w, h, s)
    counts = timp.view_importance_counts(
        ts.params(), ts.alive, ts.sh_deg, cam, torch.zeros_like(res.image),
        w, h, threshold=-1.0, settings=s)

    attrs, aux = tproject(ts.params(), ts.alive, cam, w, h, 0, s)
    bins = tbin.bin_splats(aux, w, h, s, attrs=attrs)
    ntx, _ = tbin.tile_grid(w, h, s)
    offs, eg, ev = np_(bins.tile_offsets), np_(bins.entry_gauss), \
        np_(bins.entry_valid)
    nc = np_(res.n_contrib)
    a = {k: np_(v) for k, v in attrs._asdict().items()}
    expect = np.zeros(ts.capacity)
    for y in range(h):
        for x in range(w):
            lo = offs[(y // s.tile_h) * ntx + x // s.tile_w]
            for j in range(nc[y, x]):
                e = lo + j
                if not ev[e]:
                    continue
                gi = eg[e]
                dx = x + 0.5 - a["center_px"][gi, 0]
                dy = y + 0.5 - a["center_px"][gi, 1]
                if abs(dx) > a["extents"][gi, 0] or \
                        abs(dy) > a["extents"][gi, 1]:
                    continue
                ca, cb, cc = a["conic"][gi]
                g = np.exp(-0.5 * (ca * dx * dx + 2 * cb * dx * dy
                                   + cc * dy * dy))
                if min(0.99, a["opacity"][gi] * g) >= 1.0 / 255.0:
                    expect[gi] += 1
    assert expect.sum() > 0
    np.testing.assert_allclose(np_(counts), expect, atol=0.5)
