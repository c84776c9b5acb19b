"""PyTorch port vs the JAX reference: the forward rasterizer
(``rasterize_tiles``, plain version on the CPU), the entry pack and the
tile/image layout helpers.

``rasterize_tiles`` is fed the same numpy ``attrs16``/``tile_offsets`` as
the JAX kernel (interpret mode, f32-exact matmul tier) and is also held
against the sequential numpy oracle tests/reference_raster.py, at the
tolerances of tests/test_render_forward.py: rtol 1e-4 / atol 3e-4 on image
and T, at most 0.5 % n_contrib mismatch."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from webdgs_tpu.ops import binning as jbin
from webdgs_tpu.ops import rasterize as jras
from webdgs_tpu.ops.projection import project_gaussians as jproject
from webdgs_tpu_torch.ops import kernel_launches
from webdgs_tpu_torch.ops import rasterize as tras
from webdgs_tpu_torch.ops.rasterize import rasterize_tiles

from tests.reference_raster import render_reference
from tests.torch_parity import (IMG_ATOL, IMG_RTOL, NC_MISMATCH,
                                assert_tiles_close, attrs_to_torch,
                                both_cameras, both_scenes, jax_settings, np_,
                                numpy_scene, t_, torch_settings)


def _jax_frame(n, seed, w, h, sh_deg=0, spread=1.0, opacity_shift=0.0):
    """JAX projection + binning + pack of one random frame."""
    params = numpy_scene(n, seed=seed, spread=spread,
                         opacity_shift=opacity_shift)
    js, _ = both_scenes(params, sh_deg=sh_deg)
    jc, _ = both_cameras(w, h)
    s = jax_settings()
    attrs, aux = jproject(js.params(), js.alive, jc, w, h, sh_deg, s)
    bins = jbin.bin_splats(aux, w, h, s, attrs=attrs, with_source=False)
    a16 = jras.pack_entry_attrs(attrs, bins.entry_gauss, bins.entry_valid,
                                s)
    ntx, nty = jbin.tile_grid(w, h, s)
    return attrs, bins, a16, ntx, nty


@pytest.mark.parametrize("n,seed,w,h,shift", [
    (300, 1, 96, 80, 0.0),
    (200, 2, 64, 96, 2.5),   # opaque: tiles saturate and exit early
])
def test_rasterize_plain_matches_jax_and_oracle(n, seed, w, h, shift):
    attrs, bins, a16, ntx, nty = _jax_frame(n, seed, w, h,
                                            opacity_shift=shift)
    want = jras.rasterize_tiles(a16, bins.tile_offsets, ntx, nty,
                                jax_settings())
    launches = kernel_launches()["rasterize_tiles"]
    got = rasterize_tiles(t_(a16), t_(bins.tile_offsets), ntx, nty,
                          torch_settings())
    assert kernel_launches()["rasterize_tiles"] == launches  # CPU: plain
    assert got.shape == (ntx * nty, tras.NUM_OUT, 512)
    assert got.dtype == torch.float32
    assert_tiles_close(got, want)

    img = np_(tras.tiles_to_image(got, ntx, nty, w, h, torch_settings()))
    np_attrs = {k: np.asarray(v) for k, v in attrs._asdict().items()}
    ref_img, ref_t, ref_nc = render_reference(
        np_attrs, np.asarray(bins.entry_gauss), np.asarray(bins.entry_valid),
        np.asarray(bins.tile_offsets), ntx, nty, w, h, 32, 16)
    assert img[..., 3].max() > 0.1, "test frame should have content"
    np.testing.assert_allclose(img[..., 0:3], ref_img, rtol=IMG_RTOL,
                               atol=IMG_ATOL)
    np.testing.assert_allclose(img[..., tras.OUT_T], ref_t, rtol=IMG_RTOL,
                               atol=IMG_ATOL)
    assert np.mean(img[..., tras.OUT_NCONTRIB] != ref_nc) <= NC_MISMATCH


def test_rasterize_without_ncontrib_and_chunk_sizes():
    _, bins, a16, ntx, nty = _jax_frame(300, 3, 96, 64)
    off = t_(bins.tile_offsets)
    full = rasterize_tiles(t_(a16), off, ntx, nty, torch_settings())
    bare = rasterize_tiles(t_(a16), off, ntx, nty, torch_settings(),
                           track_ncontrib=False)
    assert not bare[:, tras.OUT_NCONTRIB].any()
    np.testing.assert_array_equal(np_(bare[:, 0:5]), np_(full[:, 0:5]))
    # the chunk is an execution parameter: the image does not depend on it
    for chunk in (16, 48):
        other = rasterize_tiles(t_(a16), off, ntx, nty,
                                torch_settings(chunk=chunk))
        np.testing.assert_allclose(np_(other[:, 0:5]), np_(full[:, 0:5]),
                                   rtol=1e-5, atol=1e-5)
        assert np.mean(np_(other[:, 5] != full[:, 5])) <= NC_MISMATCH


def test_rasterize_saturation_early_exit():
    """Opaque splats stacked at one spot: n_contrib stops short of the
    stack and T falls below the threshold (tests/test_render_forward.py
    test_saturation_early_termination, on the port)."""
    n, e = 64, 128
    a16 = np.zeros((16, e), np.float32)
    a16[tras.ROW_CX, :n] = 16.0
    a16[tras.ROW_CY, :n] = 8.0
    a16[tras.ROW_CA, :n] = a16[tras.ROW_CC, :n] = 0.01
    a16[tras.ROW_R:tras.ROW_B + 1, :n] = 0.9
    # alpha 0.8 at the center: T = 0.2, 0.04, 0.008 (off the 0.01 edge)
    a16[tras.ROW_OP, :n] = 0.8
    a16[tras.ROW_EX:tras.ROW_EY + 1, :n] = 40.0
    off = torch.tensor([0, n], dtype=torch.int32)
    out = rasterize_tiles(torch.tensor(a16), off, 1, 1, torch_settings())
    want = jras.rasterize_tiles(jnp.asarray(a16), jnp.asarray(np_(off)), 1,
                                1, jax_settings())
    assert_tiles_close(out, want)
    center = 8 * 32 + 16
    assert int(out[0, tras.OUT_NCONTRIB, center]) == 3
    assert float(out[0, tras.OUT_T, center]) < 0.01


def _splats(e, rng, x0=0.0, x1=64.0, op=(0.05, 0.3)):
    """(16, e) random splats with centres in [x0, x1) x [0, 16) (two
    32 x 16 tiles span x in [0, 64)): anisotropic conics, extent boxes of
    half-width 3 / sqrt(conic diagonal)."""
    a16 = np.zeros((16, e), np.float32)
    a16[tras.ROW_CX] = rng.uniform(x0, x1, e)
    a16[tras.ROW_CY] = rng.uniform(0.0, 16.0, e)
    a16[tras.ROW_CA] = rng.uniform(0.02, 0.3, e)
    a16[tras.ROW_CC] = rng.uniform(0.02, 0.3, e)
    a16[tras.ROW_CB] = rng.uniform(-0.5, 0.5, e) * np.sqrt(
        a16[tras.ROW_CA] * a16[tras.ROW_CC])
    a16[tras.ROW_R:tras.ROW_B + 1] = rng.uniform(0, 1, (3, e))
    a16[tras.ROW_OP] = rng.uniform(*op, e)
    a16[tras.ROW_EX] = 3.0 / np.sqrt(a16[tras.ROW_CA])
    a16[tras.ROW_EY] = 3.0 / np.sqrt(a16[tras.ROW_CC])
    return a16


def test_rasterize_plain_multichunk_unaligned_saturating_matches_jax():
    """Two tiles whose ranges start off any chunk boundary and span 3.5
    chunks each (chunk 128); tile 0 holds an opaque stack mid-range that
    saturates the pixels around its centre, while faint splats keep the
    other pixels compositing to the end of the range."""
    rng = np.random.default_rng(21)
    e = 1024
    a16 = np.zeros((16, e), np.float32)
    a16[:, 3:453] = _splats(450, rng, 0.0, 32.0)
    a16[:, 453:903] = _splats(450, rng, 32.0, 64.0)
    stack = slice(3 + 200, 3 + 240)  # entries 200-239 of tile 0
    a16[tras.ROW_CX, stack] = 16.0
    a16[tras.ROW_CY, stack] = 8.0
    a16[tras.ROW_CA, stack] = a16[tras.ROW_CC, stack] = 0.01
    a16[tras.ROW_CB, stack] = 0.0
    a16[tras.ROW_OP, stack] = 0.8
    a16[tras.ROW_EX:tras.ROW_EY + 1, stack] = 40.0
    off = np.array([3, 453, 903], np.int32)
    st = torch_settings()
    assert (off[1:] - off[:-1]).min() > 3 * st.chunk
    got = rasterize_tiles(torch.tensor(a16), torch.tensor(off), 2, 1, st)
    want = jras.rasterize_tiles(jnp.asarray(a16), jnp.asarray(off), 2, 1,
                                jax_settings())
    assert_tiles_close(got, want)
    t_final, nc = np_(got[:, tras.OUT_T]), np_(got[:, tras.OUT_NCONTRIB])
    # the stack saturates tile 0's centre within its 40 entries...
    center = 8 * 32 + 16
    assert t_final[0, center] < st.t_threshold
    assert 200 < nc[0, center] <= 240
    # ...while pixels elsewhere composite past the third chunk
    assert (nc > 3 * st.chunk).any() and (t_final >= st.t_threshold).any()


@pytest.mark.parametrize("fault", ["past_end", "below_zero", "both"])
def test_rasterize_plain_clamps_out_of_range_offsets(fault):
    """Tile ranges reaching outside [0, E]: the plain forward gives what it
    gives on the clamped offsets, bit for bit, as the kernel clamps them."""
    _, bins, a16, ntx, nty = _jax_frame(300, 1, 96, 80)
    a16, off = t_(a16), t_(bins.tile_offsets)
    e_len = a16.shape[1]
    bad = off.clone()
    if fault in ("past_end", "both"):
        bad[-3:] = torch.tensor([e_len - 5, e_len + 5, 2 ** 30],
                                dtype=torch.int32)
    if fault in ("below_zero", "both"):
        bad[0:2] = torch.tensor([-7, -2], dtype=torch.int32)
    clamped = bad.clamp(0, e_len)
    assert not torch.equal(bad, clamped)
    st = torch_settings()
    want = tras.rasterize_tiles_plain(a16, clamped, ntx, nty, st)
    got = tras.rasterize_tiles_plain(a16, bad, ntx, nty, st)
    assert bool(torch.isfinite(got).all())
    assert float(want[:, tras.OUT_ACC_ALPHA].max()) > 0.1
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_rasterize_checks_inputs():
    a16 = torch.zeros((16, 128))
    off = torch.zeros(3, dtype=torch.int32)
    s = torch_settings()
    with pytest.raises(ValueError):
        rasterize_tiles(a16[:12], off, 2, 1, s)
    with pytest.raises(TypeError):
        rasterize_tiles(a16.double(), off, 2, 1, s)
    with pytest.raises(TypeError):
        rasterize_tiles(a16, off.long(), 2, 1, s)
    with pytest.raises(ValueError):
        rasterize_tiles(a16, off, 3, 1, s)
    with pytest.raises(ValueError):
        rasterize_tiles(a16, off, 2, 1, torch_settings(tile_w=128))
    with pytest.raises(ValueError):
        rasterize_tiles(a16, off, 2, 1, torch_settings(chunk=4096))
    # ranges outside attrs16 are clamped to [0, E], as the kernel clamps
    # them: no read back, no error, the clamped ranges' result
    a16r = torch.tensor(_splats(128, np.random.default_rng(9)))
    for bad in ([0, 5, 129], [-1, 0, 0]):
        bad = torch.tensor(bad, dtype=torch.int32)
        got = rasterize_tiles(a16r, bad, 2, 1, s)
        want = tras.rasterize_tiles_plain(a16r, bad.clamp(0, 128), 2, 1, s)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_pack_entry_attrs_matches_jax():
    attrs, bins, a16, _, _ = _jax_frame(120, 4, 64, 48, sh_deg=0)
    # the reference leaves ids past the total unwritten; the port's own
    # binning defines them (0), so hand it defined ids
    valid = np.asarray(bins.entry_valid)
    ids = np.where(valid, np.asarray(bins.entry_gauss), 0)
    got = tras.pack_entry_attrs(attrs_to_torch(attrs), t_(ids), t_(valid))
    assert got.shape == (16, bins.capacity) and got.is_contiguous()
    np.testing.assert_array_equal(np_(got), np.asarray(a16))


def test_layout_helpers_match_jax():
    rng = np.random.default_rng(5)
    ntx, nty, w, h = 3, 4, 80, 60
    s_t, s_j = torch_settings(background=(0.2, 0.3, 0.4)), \
        jax_settings(background=(0.2, 0.3, 0.4))
    tiles = rng.normal(size=(ntx * nty, 8, 512)).astype(np.float32)
    img_t = tras.tiles_to_image(torch.tensor(tiles), ntx, nty, w, h, s_t)
    img_j = jras.tiles_to_image(jnp.asarray(tiles), ntx, nty, w, h, s_j)
    np.testing.assert_array_equal(np_(img_t), np.asarray(img_j))
    np.testing.assert_allclose(
        np_(tras.composite_background(img_t, s_t)),
        np.asarray(jras.composite_background(img_j, s_j)), rtol=1e-6)
    img = rng.normal(size=(h, w, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        np_(tras.image_to_tiles(torch.tensor(img), ntx, nty, s_t)),
        np.asarray(jras.image_to_tiles(jnp.asarray(img), ntx, nty, s_j)))
