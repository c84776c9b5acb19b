"""PyTorch port vs the JAX reference: the single-process pieces of the
Gaussian-sharded path -- the band form of the tile loss and its boundary
slices (webdgs_tpu/ops/tile_loss.py:253, :268; Pallas in interpret mode),
the chunk-aligned layout (webdgs_tpu/ops/binning.py:395, :413) and the
entry exchange's encoding (webdgs_tpu/parallel/sharding.py:317-355).

Tolerances: band dpix within 1e-6 of JAX and the summed metric sums
within 1e-5 relative (the port's plain version adds the 5x5 windows in
another order than XLA); the port's bands reassembled equal its
full-frame version bit for bit; the index arithmetic and the f16/f32
encodings are compared exactly."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webdgs_tpu.ops import binning as jbin
from webdgs_tpu.ops import tile_loss as jtl
from webdgs_tpu.ops.loss import LossConfig as JLossConfig
from webdgs_tpu.parallel import sharding as jsh
from webdgs_tpu_torch.core.camera import default_camera
from webdgs_tpu_torch.core.scene import scene_from_numpy
from webdgs_tpu_torch.ops import binning as tbin
from webdgs_tpu_torch.ops import rasterize as tras
from webdgs_tpu_torch.ops import tile_loss as ttl
from webdgs_tpu_torch.ops.loss import LossConfig
from webdgs_tpu_torch.ops.projection import project_gaussians
from webdgs_tpu_torch.parallel import sharding as tsh

from tests.torch_cases import (BAND_FRAME, BAND_SPLITS, aligned_entries,
                               band_loss_frame, split_bands)
from tests.torch_parity import (jax_settings, np_, numpy_scene, t_,
                                torch_settings)

SUM_RTOL = 1e-5


def _frame(seed=17):
    s = torch_settings()
    w, h = BAND_FRAME
    out, target = band_loss_frame(seed, w, h, s.tile_w, s.tile_h)
    ntx, nty = tbin.tile_grid(w, h, s)
    return s, w, h, out, target, ntx, nty


@pytest.mark.parametrize("n_bands", [4, 3])
def test_band_tile_loss_matches_jax(n_bands):
    """Every band (with a padding band at n_bands=3) against JAX's
    band_tile_loss_gradient, true neighbour slices and garbage halos at the
    frame's borders."""
    s, w, h, out, target, ntx, nty = _frame()
    js = jax_settings()
    dpix_all, sums_t, sums_j = [], 0.0, 0.0
    for row_base, rows, band, top, bot in split_bands(
            out, ntx, nty, n_bands, s.tile_w, s.tile_h, seed=3):
        dj, sj = jtl.band_tile_loss_gradient(
            jnp.asarray(band), jnp.asarray(top), jnp.asarray(bot),
            jnp.asarray(target), jnp.int32(row_base), w, h, ntx, rows,
            JLossConfig(), js)
        dt, st = ttl.band_tile_loss_gradient(
            t_(band), t_(top), t_(bot), t_(target), row_base, w, h, ntx,
            rows, LossConfig(), s)
        assert dt.shape == (rows * ntx, 8, s.tile_px)
        np.testing.assert_allclose(np_(dt), np.asarray(dj), rtol=0,
                                   atol=1e-6)
        dpix_all.append(np_(dt))
        sums_t = sums_t + np_(st).sum(0, dtype=np.float64)
        sums_j = sums_j + np.asarray(sj)[:, :4].sum(0, dtype=np.float64)
        if row_base * s.tile_h >= h:  # a padding band
            assert not np_(dt).any() and not np_(st).any()
    np.testing.assert_allclose(sums_t, sums_j, rtol=SUM_RTOL)
    full, _ = ttl.tile_loss_tiles(t_(out), t_(target), w, h, ntx, nty,
                                  LossConfig(), s)
    np.testing.assert_array_equal(
        np.concatenate(dpix_all)[:ntx * nty], np_(full))


@pytest.mark.parametrize("n_bands", BAND_SPLITS)
def test_band_plain_reassembles_full_frame(n_bands):
    """The port's bands, garbage halos at the borders, reassemble its
    full-frame dpix and sums bit for bit; the padding tiles are zero."""
    s, w, h, out, target, ntx, nty = _frame(seed=23)
    cfg = LossConfig()
    full_d, full_s = ttl.tile_loss_gradient_plain(
        t_(out), t_(target), w, h, ntx, nty, cfg, s)
    parts = [ttl.band_tile_loss_gradient_plain(
        t_(band), t_(top), t_(bot), t_(target), row_base, w, h, ntx, rows,
        cfg, s) for row_base, rows, band, top, bot in split_bands(
            out, ntx, nty, n_bands, s.tile_w, s.tile_h, seed=4)]
    dpix = torch.cat([d for d, _ in parts])
    sums = torch.cat([x for _, x in parts])
    assert torch.equal(dpix[:ntx * nty], full_d)
    assert torch.equal(sums[:ntx * nty], full_s)
    assert not dpix[ntx * nty:].any() and not sums[ntx * nty:].any()


def test_halo_slices_match_jax():
    s, w, h, out, _, ntx, nty = _frame()
    for a, b in zip(ttl.halo_slices(t_(out), ntx, s),
                    jtl.halo_slices(jnp.asarray(out), ntx, jax_settings())):
        np.testing.assert_array_equal(np_(a), np.asarray(b))
        assert a.shape == (ntx, 8, 2 * s.tile_w) and a.is_contiguous()


def test_band_tile_loss_checks_inputs():
    s, w, h, out, target, ntx, nty = _frame()
    (row_base, rows, band, top, bot), = split_bands(out, ntx, nty, 1,
                                                    s.tile_w, s.tile_h, 0)
    args = [t_(band), t_(top), t_(bot), t_(target), 0, w, h, ntx, rows,
            LossConfig(), s]
    with pytest.raises(ValueError, match="halo_top"):
        ttl.band_tile_loss_gradient(*(args[:1] + [t_(top[:, :, :3])]
                                      + args[2:]))
    with pytest.raises(ValueError, match="row_base"):
        ttl.band_tile_loss_gradient(*(args[:4] + [-1] + args[5:]))
    with pytest.raises(ValueError, match="tiles of at least"):
        ttl.band_tile_loss_gradient(*(args[:10] + [dataclasses.replace(
            s, tile_w=512, tile_h=1)]))


def _crafted_counts():
    """Per-tile counts with empty tiles, multiples of the chunk (8) and a
    ragged tail."""
    return np.array([0, 8, 3, 0, 0, 16, 9, 1, 0, 24, 7, 0], np.int32)


@pytest.mark.parametrize("a_cap_extra", [0, 3])
def test_aligned_layout_matches_jax(a_cap_extra):
    chunk, counts = 8, _crafted_counts()
    recv = int(counts.sum()) + 5
    total_tiles = counts.shape[0]
    a_cap = -(-recv // chunk) * chunk + (total_tiles + a_cap_extra) * chunk
    got = tbin.aligned_tile_layout(torch.tensor(counts), chunk)
    want = jbin.aligned_tile_layout(jnp.asarray(counts), chunk)
    for g, w_ in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np_(g), np.asarray(w_))
    src, valid = tbin.realign_sorted(*got, torch.tensor(counts), a_cap,
                                     chunk, total_tiles, recv)
    src_j, valid_j = jbin.realign_sorted(*want, jnp.asarray(counts), a_cap,
                                         chunk, total_tiles, recv)
    np.testing.assert_array_equal(np_(src), np.asarray(src_j))
    np.testing.assert_array_equal(np_(valid), np.asarray(valid_j))
    assert int(valid.sum()) == int(counts.sum())


def _exchange_inputs(seed=5, n=300):
    rng = np.random.default_rng(seed)
    ntx = 7
    tiles = rng.integers(0, ntx * 6, n)
    keys = (tiles.astype(np.uint32) << 16) | rng.integers(
        0, 0xFFFF, n).astype(np.uint32)
    valid = rng.random(n) < 0.8
    keys = np.where(valid, keys, np.uint32(0xFFFFFFFF)).astype(np.uint32)
    rows = rng.normal(0, 3.0, (n, 16)).astype(np.float32)
    rows[:, 0] = rng.uniform(0, ntx * 32, n)  # centers in pixels
    rows[:, 1] = rng.uniform(0, 6 * 16, n)
    rows[~valid] = 0.0
    return ntx, keys, valid, rows


@pytest.mark.parametrize("f16", [True, False])
def test_exchange_encoding_matches_jax(f16):
    """_encode_exchange / _decode_exchange equal JAX's bit for bit, with
    the band shift of band 2 of 3-row bands."""
    ntx, keys, valid, rows = _exchange_inputs()
    s = dataclasses.replace(torch_settings(), exchange_f16=f16)
    js = jax_settings(exchange_f16=f16)
    keys_t = torch.tensor(keys.astype(np.int64))
    enc = tsh._encode_exchange(t_(rows), keys_t, t_(valid), ntx, s)
    enc_j = jsh._encode_exchange(jnp.asarray(rows), jnp.asarray(keys),
                                 jnp.asarray(valid), ntx, js)
    assert enc.dtype == (torch.float16 if f16 else torch.float32)
    np.testing.assert_array_equal(np_(enc), np.asarray(enc_j))
    shift = 2 * 3 * s.tile_h
    dec = tsh._decode_exchange(enc, keys_t, t_(valid), ntx, float(shift), s)
    dec_j = jsh._decode_exchange(enc_j, jnp.asarray(keys),
                                 jnp.asarray(valid), ntx,
                                 jnp.float32(shift), js)
    assert dec.dtype == torch.float32
    np.testing.assert_array_equal(np_(dec), np.asarray(dec_j))
    assert np.signbit(np_(dec)).tolist() == np.signbit(
        np.asarray(dec_j)).tolist()


def test_aligned_zero_rows_are_no_ops_plain():
    """The aligned layout's all-zero rows (opacity 0: alpha 0, below
    alpha_min) change nothing in the plain forward, n_contrib (a 1-based
    position in the tile's range) included, and get zero cotangents in the
    plain backward; the real entries' cotangents are unchanged."""
    s = torch_settings(chunk=16)
    w, h = 96, 64
    sc = scene_from_numpy(numpy_scene(120, seed=31), np.ones(120, bool), 0,
                          "cpu")
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0), device="cpu")
    attrs, aux = project_gaussians(sc.params(), sc.alive, cam, w, h, 0, s)
    bins = tbin.bin_splats(aux, w, h, s, attrs=attrs)
    a16 = tras.pack_entry_attrs(attrs, bins.entry_gauss, bins.entry_valid)
    ntx, nty = tbin.tile_grid(w, h, s)
    rows, offsets, src, valid = aligned_entries(a16, bins.tile_offsets,
                                                s.chunk, slack=2)
    assert int(valid.sum()) == int(bins.total_entries)
    assert (offsets[1:] - offsets[:-1] > bins.tile_counts).any()  # padded
    out = tras.rasterize_tiles_plain(a16, bins.tile_offsets, ntx, nty, s)
    out_a = tras.rasterize_tiles_plain(rows, offsets, ntx, nty, s)
    assert torch.equal(out_a, out)
    assert out[:, tras.OUT_NCONTRIB].max() > 1
    gpix = torch.tensor(np.random.default_rng(2).normal(
        0, 1, (ntx * nty, tras.NUM_GPIX, s.tile_px)), dtype=torch.float32)
    d = tras.rasterize_tiles_backward_plain(a16, bins.tile_offsets, gpix,
                                            ntx, nty, s)
    d_a = tras.rasterize_tiles_backward_plain(rows, offsets, gpix, ntx, nty,
                                              s)
    assert torch.equal(d_a[:, valid], d[:, src[valid]])
    assert not d_a[:, ~valid].any()
