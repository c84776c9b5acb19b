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


# crafted inputs of the tile cull (ops/binning.py:cull_words and
# entry_keys).  tests/test_torch_cuda.py holds the kernels against the
# plain chains on the card on every case, tests/test_torch_binning.py the
# plain chains against JAX on the CPU on all but "edge", whose opacities
# sit within a few ulps of the cull threshold, where torch's and XLA's logf
# round independently.  Every case mixes in dead slots (no tiles).
CULL_CASES = ("rect_sizes", "conics", "opacity", "depth", "geometry",
              "drop", "dead", "edge")
CULL_GRID = (80, 64)  # tiles (ntx, nty): 2,560 x 1,024 px at 32 x 16
# rect shapes (tiles_x, tiles_y) of 1, 31, 32, 33, 64, 65 and 2,048
# positions ("rect_sizes" adds rects of 0)
CULL_RECTS = ((1, 1), (31, 1), (1, 31), (8, 4), (4, 8), (11, 3), (3, 11),
              (8, 8), (16, 4), (13, 5), (5, 13), (64, 32))


def _cull_qmin64(ca, cb, cc, x0, y0, tile_w, tile_h, ex, ey):
    """The cull's quadratic minimum over one tile's box, in float64 (the
    chain's formula without its roundings)."""
    x1, y1 = x0 + (tile_w - 1), y0 + (tile_h - 1)
    exm, eym = ex + 1e-3, ey + 1e-3
    x0, x1 = np.maximum(x0, -exm), np.minimum(x1, exm)
    y0, y1 = np.maximum(y0, -eym), np.minimum(y1, eym)
    inside = (x0 <= 0) & (x1 >= 0) & (y0 <= 0) & (y1 >= 0)

    def edge_x(dxf):
        dy = np.clip(-cb * dxf / np.maximum(cc, 1e-12), y0, y1)
        return (ca * dxf + 2.0 * cb * dy) * dxf + cc * dy * dy

    def edge_y(dyf):
        dx = np.clip(-cb * dyf / np.maximum(ca, 1e-12), x0, x1)
        return (ca * dx + 2.0 * cb * dyf) * dx + cc * dyf * dyf
    qmin = np.minimum(np.minimum(edge_x(x0), edge_x(x1)),
                      np.minimum(edge_y(y0), edge_y(y1)))
    return np.where(inside, 0.0, qmin) * (1.0 - 2.0 ** -12)


def crafted_cull_case(case: str, seed: int, tile_w: int = 32,
                      tile_h: int = 16, alpha_min: float = 1.0 / 255.0):
    """Numpy inputs of the tile cull: (attrs, aux, ntx, e_cap), where attrs
    and aux are dicts of the SplatAttrs / SplatAux fields the cull reads
    (float32 and int32 arrays) and e_cap never drops a Gaussian but in
    "drop" (:func:`cull_inputs` makes the port's tuples of them)."""
    rng = np.random.default_rng(seed)
    ntx, nty = CULL_GRID
    per_shape = 40 if case == "rect_sizes" else 0
    n = len(CULL_RECTS) * per_shape or (20_000 if case == "edge" else 3000)
    if per_shape:
        dims = np.repeat(np.array(CULL_RECTS), per_shape, axis=0)
    else:
        dims = rng.integers(1, 9, (n, 2))
    tmin = np.stack([rng.integers(0, ntx - dims[:, 0] + 1),
                     rng.integers(0, nty - dims[:, 1] + 1)], axis=1)
    num_tiles = dims[:, 0] * dims[:, 1]
    # splat centres in and around the rects, conics of 1 to 60 px sigmas
    cx = (tmin[:, 0] + rng.uniform(-1.0, dims[:, 0] + 1.0)) * tile_w
    cy = (tmin[:, 1] + rng.uniform(-1.0, dims[:, 1] + 1.0)) * tile_h
    sig = np.exp(rng.uniform(np.log(1.0), np.log(60.0), (n, 2)))
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    va, vb = 1.0 / sig[:, 0] ** 2, 1.0 / sig[:, 1] ** 2
    conic = np.stack([c * c * va + s * s * vb, c * s * (va - vb),
                      s * s * va + c * c * vb], axis=1)
    ext = np.minimum(3.0 * sig * rng.uniform(0.5, 1.5, (n, 2)), 128.0)
    opacity = rng.uniform(0.003, 1.0, n)
    depth = rng.normal(0.0, 30.0, n)

    def pick(share):
        return rng.random(n) < share

    if case == "conics":
        bad = rng.integers(0, 9, n)
        for k, sel in enumerate((bad[:, None] == np.arange(9)).T):
            if k == 0:  # a < 0
                conic[sel, 0] *= -1
            elif k == 1:  # c < 0
                conic[sel, 2] *= -1
            elif k == 2:  # det < 0
                conic[sel, 1] = np.sqrt(conic[sel, 0] * conic[sel, 2]) * 1.5
            elif k == 3:  # all zero
                conic[sel] = 0.0
            elif k == 4:  # det = 0
                conic[sel] = conic[sel][:, [0, 0, 0]]
            elif k == 5:  # a NaN in one of the three
                conic[sel, rng.integers(0, 3)] = np.nan
            elif k == 6:  # below the 1e-12 floor, and huge
                conic[sel, 0] = 1e-30
                conic[sel, 2] = 1e30
            elif k == 7:
                conic[sel, rng.integers(0, 3)] = np.inf
    elif case == "opacity":
        a32 = np.float32(alpha_min)
        special = np.array([a32, np.nextafter(a32, np.float32(0)),
                            np.nextafter(a32, np.float32(1)), 0.0, -1.0,
                            np.nan, 1e-13, 1.0, np.inf], np.float32)
        sel = pick(0.6)
        opacity[sel] = special[rng.integers(0, len(special), sel.sum())]
    elif case == "depth":
        special = np.array([0.0, -0.0, 1e-30, -1e-30, 1e30, -1e30, np.inf,
                            -np.inf, np.nan, 0.01, -0.01], np.float32)
        sel = pick(0.5)
        depth[sel] = special[rng.integers(0, len(special), sel.sum())]
    elif case == "geometry":
        for arr, k in ((cx, 0), (cy, 1)):
            arr[pick(0.05)] = np.nan
            arr[pick(0.05)] = np.inf * rng.choice([-1, 1])
        for k in (0, 1):
            ext[pick(0.05), k] = np.nan
            ext[pick(0.05), k] = np.inf
            ext[pick(0.05), k] = 0.0
            ext[pick(0.05), k] = -5.0
    elif case == "dead":
        # 90 % dead slots, whose other fields are garbage as a dead
        # capacity slot's may be
        dead = pick(0.9)
        num_tiles[dead] = 0
        conic[dead & pick(0.5)] = np.nan
        cx[dead & pick(0.5)] = np.inf
        opacity[dead & pick(0.5)] = -3.0
    elif case == "edge":
        # opacities at the cull threshold of one rect position each: qthr
        # = 2 ln(op / alpha_min)(1 + 1e-5) + 1e-4 solved for op at the
        # position's float64 qmin, then moved by -3 to +3 ulps
        p = rng.integers(0, num_tiles)
        q_loc, r_loc = p // dims[:, 0], p % dims[:, 0]
        x0 = (tmin[:, 0] + r_loc) * tile_w + 0.5 - cx
        y0 = (tmin[:, 1] + q_loc) * tile_h + 0.5 - cy
        qmin = _cull_qmin64(conic[:, 0], conic[:, 1], conic[:, 2], x0, y0,
                            tile_w, tile_h, ext[:, 0], ext[:, 1])
        qmin = np.clip(qmin, 0.0, 40.0)
        opacity = alpha_min * np.exp((qmin - 1e-4) / (2.0 * (1.0 + 1e-5)))
        opacity = opacity.astype(np.float32)
        steps = rng.integers(-3, 4, n)
        for _ in range(3):
            up = steps > 0
            down = steps < 0
            opacity[up] = np.nextafter(opacity[up], np.float32(np.inf))
            opacity[down] = np.nextafter(opacity[down], np.float32(0))
            steps = steps - up + down
    # dead slots in every case; a rect's dims stay, as the projection
    # leaves them for a culled splat
    dead = pick(0.3) if case != "dead" else num_tiles == 0
    num_tiles[dead] = 0
    total = int(num_tiles.sum())
    # the cull keeps about a fifth of these rects' tiles
    e_cap = total // 12 if case == "drop" else total + 100
    attrs = {"conic": conic.astype(np.float32),
             "opacity": opacity.astype(np.float32),
             "center_px": np.stack([cx, cy], axis=1).astype(np.float32),
             "extents": ext.astype(np.float32)}
    aux = {"depth": depth.astype(np.float32),
           "tile_min": tmin.astype(np.int32),
           "tile_dims": dims.astype(np.int32),
           "num_tiles": num_tiles.astype(np.int32)}
    return attrs, aux, ntx, e_cap


def cull_inputs(attrs: dict, aux: dict, device):
    """The port's (SplatAttrs, SplatAux) of a :func:`crafted_cull_case`
    on ``device``; the fields the cull does not read are zeros."""
    import torch

    from webdgs_tpu_torch.ops.projection import SplatAttrs, SplatAux

    def t(x):
        return torch.tensor(x, device=device)
    n = aux["num_tiles"].shape[0]
    zeros = torch.zeros((n,), dtype=torch.bool, device=device)
    return (SplatAttrs(center_px=t(attrs["center_px"]),
                       conic=t(attrs["conic"]),
                       color=torch.zeros((n, 3), device=device),
                       opacity=t(attrs["opacity"]),
                       extents=t(attrs["extents"])),
            SplatAux(depth=t(aux["depth"]), visible=t(aux["num_tiles"] > 0),
                     tile_min=t(aux["tile_min"]),
                     tile_dims=t(aux["tile_dims"]),
                     num_tiles=t(aux["num_tiles"]), radius_capped=zeros))
