"""Crafted inputs shared by the port's tests, with no jax import: the
parity tests (which hold them against the JAX package) and
tests/test_torch_cuda.py (which holds the kernels against their plain
versions on a machine without jax) both take them from here."""

from __future__ import annotations

import numpy as np

from webdgs_tpu_torch.ops.expand import NWORDS
from webdgs_tpu_torch.ops.rasterize import NUM_OUT, OUT_T

# crafted expansion inputs (tests/test_torch_binning.py holds them against
# JAX, tests/test_torch_cuda.py the kernel against its plain version).  The kernel gives each CTA a span of 1,024 slots
# and stages the span's owner window of the cumsum when it holds at most
# 4,096 Gaussians; "zero_run" exceeds that window (its global-search
# route), "long_owner" spans several CTA spans with one owner.
EXPAND_CASES = ("zero_run", "long_owner", "total_is_cap", "all_zero",
                "single", "trailing_zeros", "odd_cap")


def crafted_expand_case(case: str, seed: int):
    """Numpy inputs of expand_fields: (words (5, N) int32, counts (N,)
    int32, e_cap)."""
    rng = np.random.default_rng(seed)

    def some(n, lo=0, hi=9):
        return rng.integers(lo, hi, n)
    if case == "zero_run":  # 5,000 zero-count Gaussians between owners
        counts = np.concatenate([some(400, 1), np.zeros(5000, np.int64),
                                 some(400, 1)])
        e_cap = int(counts.sum()) + 700
    elif case == "long_owner":  # one Gaussian of 5,000 entries
        counts = np.concatenate([some(60), [5000], some(60)])
        e_cap = int(counts.sum()) + 300
    elif case == "total_is_cap":
        counts = some(1500)
        e_cap = int(counts.sum())
    elif case == "all_zero":
        counts = np.zeros(300, np.int64)
        e_cap = 1024
    elif case == "single":  # N = 1
        counts = np.array([7])
        e_cap = 13
    elif case == "trailing_zeros":
        counts = np.concatenate([some(700), np.zeros(3000, np.int64)])
        e_cap = int(counts.sum()) + 2100
    elif case == "odd_cap":  # rows of the output not 16-byte aligned
        counts = some(1200)
        e_cap = int(counts.sum()) + 1023
        assert e_cap % 4 != 0
    else:
        raise ValueError(case)
    counts = counts.astype(np.int32)
    words = rng.integers(-2**31, 2**31 - 1, (NWORDS, counts.shape[0]),
                         dtype=np.int64).astype(np.int32)
    return words, counts, e_cap


# band splits of the 70x52 tile-loss frame (tests/test_tile_loss.py:132):
# with 32x16 tiles it is 3x4 tiles; 4 bands of one tile row, 2 bands of
# two, and 3 bands of two rows, whose last band lies wholly below the frame
BAND_FRAME = (70, 52)
BAND_SPLITS = (4, 2, 3)


def band_loss_frame(seed: int, w: int, h: int, tile_w: int, tile_h: int):
    """Random planar forward tiles (ntx*nty, NUM_OUT, P) and a target
    (h, w, 3), float32 numpy, as tests/test_tile_loss.py:132 makes them."""
    ntx, nty = -(-w // tile_w), -(-h // tile_h)
    rng = np.random.default_rng(seed)
    out = np.zeros((ntx * nty, NUM_OUT, tile_w * tile_h), np.float32)
    out[:, 0:3] = rng.random((ntx * nty, 3, tile_w * tile_h)) * 0.9
    out[:, OUT_T] = rng.random((ntx * nty, tile_w * tile_h))
    target = rng.random((h, w, 3)).astype(np.float32)
    return out, target


def split_bands(out: np.ndarray, ntx: int, nty: int, n_bands: int,
                tile_w: int, tile_h: int, seed: int):
    """The frame's tiles cut into ``n_bands`` bands of tile rows (the grid
    padded with zero tiles to a multiple), each with the true boundary
    slices of its neighbours and random garbage (values up to 5) at the
    frame's borders.  A list of (row_base, rows, band, halo_top,
    halo_bot), numpy float32."""
    rows = -(-nty // n_bands)
    pad = np.zeros(((rows * n_bands - nty) * ntx,) + out.shape[1:],
                   np.float32)
    tiles = np.concatenate([out, pad])
    t4 = tiles.reshape(-1, NUM_OUT, tile_h, tile_w)
    rng = np.random.default_rng(seed)

    def garbage():
        return (rng.random((ntx, NUM_OUT, 2 * tile_w)) * 5.0).astype(
            np.float32)

    bands = []
    for b in range(n_bands):
        lo, hi = b * rows * ntx, (b + 1) * rows * ntx
        top = (t4[lo - ntx:lo, :, -2:, :].reshape(ntx, NUM_OUT, 2 * tile_w)
               if b > 0 else garbage())
        bot = (t4[hi:hi + ntx, :, :2, :].reshape(ntx, NUM_OUT, 2 * tile_w)
               if b < n_bands - 1 else garbage())
        bands.append((b * rows, rows, np.ascontiguousarray(tiles[lo:hi]),
                      np.ascontiguousarray(top), np.ascontiguousarray(bot)))
    return bands


def aligned_entries(attrs16, tile_offsets, chunk: int, slack: int = 0):
    """The (16, E) entry rows of a tile-sorted layout moved into the
    chunk-aligned layout of the Gaussian-sharded paths
    (``ops/binning.py:aligned_tile_layout``): each tile's entries followed
    by all-zero rows up to a chunk boundary, ``slack`` spare chunks at the
    end.  Returns (rows (16, A), tile_offsets (T+1,) i32, src (A,) i64 the
    original slot of each aligned slot, valid (A,) bool)."""
    import torch

    from webdgs_tpu_torch.ops.binning import (aligned_tile_layout,
                                              realign_sorted)
    counts = tile_offsets[1:] - tile_offsets[:-1]
    offsets, aligned_off, unaligned_off = aligned_tile_layout(counts, chunk)
    n_tiles, e_len = counts.shape[0], attrs16.shape[1]
    a_cap = (-(-e_len // chunk) + n_tiles + slack) * chunk
    src, valid = realign_sorted(offsets, aligned_off, unaligned_off, counts,
                                a_cap, chunk, n_tiles, e_len)
    src = src.to(torch.int64)
    rows = torch.where(valid[None, :], attrs16[:, src], 0.0).contiguous()
    return rows, offsets, src, valid
