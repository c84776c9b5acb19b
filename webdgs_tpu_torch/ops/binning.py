"""Tile binning: expand Gaussians into per-tile entries and depth-sort them
(counterpart of webdgs_tpu/ops/binning.py:45-496).

The reference's integer semantics, carried in int64 masked to 32 bits
(torch has no uint32 shift or popcount on the CPU): entries carry the
32-bit key ``(tile << 16) | ordered_depth16``, invalid slots the sentinel
``0xFFFFFFFF``; one stable sort on the key (``torch.sort(stable=True)``, as
``lax.sort`` is stable) gives the final entry layout; tile ranges are a
``searchsorted`` of the sorted keys (cull on) or a cumsum of the corner
histogram of the tile rects (cull off).  The ragged expansion always goes
through :func:`webdgs_tpu_torch.ops.expand.expand_fields`, whose CUDA
kernel replaces the TPU expansion kernel.  Gaussians that would overflow
the entry capacity are dropped whole.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from webdgs_tpu_torch.config import RenderSettings
from webdgs_tpu_torch.ops.expand import expand_fields
from webdgs_tpu_torch.ops.projection import SplatAttrs, SplatAux

MASK32 = 0xFFFFFFFF
SENTINEL_KEY = 0xFFFFFFFF

# tile ids share a 32-bit key with 16 depth bits: ~4K x 4K images at most
TILE_KEY_LIMIT = 0xFFFF

CULL_POSITIONS = 64  # local rect positions covered by the cull bitmask


def tile_grid(img_w: int, img_h: int,
              settings: RenderSettings) -> tuple[int, int]:
    """Tile-grid dimensions for an image size."""
    return -(-img_w // settings.tile_w), -(-img_h // settings.tile_h)


class Binning(NamedTuple):
    entry_gauss: torch.Tensor  # (E,) i32 gaussian index per sorted slot
    entry_valid: torch.Tensor  # (E,) bool, False past the real total
    tile_offsets: torch.Tensor  # (T+1,) i32 cumulative entry counts
    tile_counts: torch.Tensor  # (T,) i32 entries per tile
    total_entries: torch.Tensor  # () real entries across all tiles
    # with_source=True only (the gradient path, render_from_attrs(for_grad))
    entry_source: torch.Tensor | None  # (E,) i32 pre-sort expansion slot
    gauss_counts: torch.Tensor | None  # (N,) i32 kept entries per Gaussian
    expansion_gauss: torch.Tensor | None = None  # (E,) i32 monotone ids
    # pre-overflow-drop entry demand (post-cull): what adaptive capacity
    # must observe, since total_entries saturates at the capacity
    expansion_entries: torch.Tensor | None = None

    @property
    def capacity(self) -> int:
        return self.entry_gauss.shape[0]


def entry_capacity(n: int, settings: RenderSettings) -> int:
    """Default tile-entry capacity for ``n`` Gaussians."""
    est = min(max(n, 1) * settings.avg_tiles_per_gaussian,
              settings.max_tile_entries)
    chunk = settings.chunk
    return max(-(-est // chunk) * chunk, chunk)


def check_tile_key_limit(total_tiles: int) -> None:
    if total_tiles >= TILE_KEY_LIMIT:
        raise ValueError(
            f"{total_tiles} tiles exceeds the 16-bit tile-key limit; "
            "increase tile size or shard the image")


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit pattern -> int32 with the same bits."""
    x = x & MASK32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 -> int64 holding its unsigned 32-bit value."""
    return x.to(torch.int64) & MASK32


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values in [0, 2^32) (SWAR), as int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def _ordered_depth16(depth: torch.Tensor) -> torch.Tensor:
    """f32 depth -> monotonic u32 -> top 16 bits (int64), clamped to
    0xFFFE (0xFFFF is reserved)."""
    bits = _to_u32(depth.contiguous().view(torch.int32))
    mask = torch.where((bits >> 31) != 0, MASK32, 0x80000000)
    ordered = bits ^ mask
    return torch.clamp(ordered >> 16, max=0xFFFE)


def _tile_histogram(aux: SplatAux, keep: torch.Tensor, ntx: int,
                    nty: int) -> torch.Tensor:
    """Per-tile entry counts of the kept Gaussians' tile rects: +-1 corner
    marks on an (nty+1, ntx+1) grid, then a 2D prefix sum (exact integer
    arithmetic, like the reference's corner matmul)."""
    emitting = keep & (aux.num_tiles > 0)
    x0 = aux.tile_min[:, 0].to(torch.int64)[emitting]
    y0 = aux.tile_min[:, 1].to(torch.int64)[emitting]
    x1 = x0 + aux.tile_dims[:, 0].to(torch.int64)[emitting]  # exclusive
    y1 = y0 + aux.tile_dims[:, 1].to(torch.int64)[emitting]
    grid = torch.zeros(((nty + 1) * (ntx + 1),), dtype=torch.int64,
                       device=x0.device)
    stride = ntx + 1
    ones = torch.ones_like(x0)
    for ys, xs, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1),
                         (y1, x1, 1)):
        grid.index_add_(0, ys * stride + xs, sign * ones)
    grid = grid.reshape(nty + 1, ntx + 1).cumsum(0).cumsum(1)
    return grid[:nty, :ntx].reshape(-1).to(torch.int32)


def _cull_bitmask(aux: SplatAux, attrs: SplatAttrs,
                  settings: RenderSettings):
    """Per-Gaussian 64-bit SURVIVOR mask of rect positions (bit i = local
    position i = q*tiles_x + r stays), as (lo, hi) int64 words, plus the
    survivor counts.  A position is culled when the maximum alpha over the
    tile's pixel box is provably < alpha_min (exact convex-quadratic
    minimum over the box, conservatively rounded).  Gaussians with more
    than 64 rect positions (or a non-convex conic) keep their full rect."""
    conic = attrs.conic.detach()
    ca, cb, cc = conic[:, 0:1], conic[:, 1:2], conic[:, 2:3]  # (N, 1)
    op = attrs.opacity.detach()
    center = attrs.center_px.detach()
    tw, th = settings.tile_w, settings.tile_h
    dev = conic.device

    # cull iff qmin > qthr = 2 ln(op / alpha_min), rounded up for safety
    qthr = (2.0 * torch.log(torch.clamp(op, min=1e-12) / settings.alpha_min)
            * (1.0 + 1e-5) + 1e-4)[:, None]  # (N, 1)

    pos = torch.arange(CULL_POSITIONS, dtype=torch.int32,
                       device=dev)[None, :]  # (1, R)
    num_tiles = aux.num_tiles[:, None]
    tiles_x = torch.clamp(aux.tile_dims[:, 0:1], min=1)  # (N, 1)
    q_loc = torch.div(pos, tiles_x, rounding_mode="floor")  # (N, R)
    r_loc = pos - q_loc * tiles_x
    eligible = (pos < num_tiles) & (num_tiles <= CULL_POSITIONS)

    # tile pixel-center box relative to the splat center
    x0 = ((aux.tile_min[:, 0:1] + r_loc) * tw).to(torch.float32) \
        + 0.5 - center[:, 0:1]
    y0 = ((aux.tile_min[:, 1:2] + q_loc) * th).to(torch.float32) \
        + 0.5 - center[:, 1:2]
    x1 = x0 + (tw - 1)
    y1 = y0 + (th - 1)

    # intersect with the extent box the rasterizer also tests (1e-3 px
    # slack keeps the clip conservative)
    ext = attrs.extents.detach()
    exm = ext[:, 0:1] + 1e-3
    eym = ext[:, 1:2] + 1e-3
    empty = (x0 > exm) | (x1 < -exm) | (y0 > eym) | (y1 < -eym)
    x0 = torch.maximum(x0, -exm)
    x1 = torch.minimum(x1, exm)
    y0 = torch.maximum(y0, -eym)
    y1 = torch.minimum(y1, eym)
    inside = (x0 <= 0.0) & (x1 >= 0.0) & (y0 <= 0.0) & (y1 >= 0.0)

    # exact min of the convex quadratic over the box: interior (0) or one
    # of the four edges, each a 1D quadratic clamped to its segment
    def edge_x(dxf):
        dy = torch.clamp(-cb * dxf / torch.clamp(cc, min=1e-12), y0, y1)
        return (ca * dxf + 2.0 * cb * dy) * dxf + cc * dy * dy

    def edge_y(dyf):
        dx = torch.clamp(-cb * dyf / torch.clamp(ca, min=1e-12), x0, x1)
        return (ca * dx + 2.0 * cb * dyf) * dx + cc * dyf * dyf

    qmin = torch.minimum(torch.minimum(edge_x(x0), edge_x(x1)),
                         torch.minimum(edge_y(y0), edge_y(y1)))
    qmin = torch.where(inside, 0.0, qmin) * (1.0 - 2.0 ** -12)
    convex = (ca > 0.0) & (cc > 0.0) & (ca * cc - cb * cb > 0.0)
    culled = eligible & convex & ((qmin > qthr) | empty)

    in_rect = pos < num_tiles
    bit = (in_rect & ~culled).to(torch.int64)
    w = bit << (pos % 32).to(torch.int64)  # unique bits: a sum is an OR
    lo = torch.where(pos < 32, w, 0).sum(dim=1)
    hi = torch.where(pos >= 32, w, 0).sum(dim=1)

    n_surv = (_popcount32(lo) + _popcount32(hi)).to(torch.int32)
    small = aux.num_tiles <= CULL_POSITIONS
    surv_counts = torch.where(small, n_surv, aux.num_tiles)
    # identity masks for large rects keep the per-entry bit-select total
    lo = torch.where(small, lo, MASK32)
    hi = torch.where(small, hi, MASK32)
    return lo, hi, surv_counts


def _select_nth_set_bit(lo: torch.Tensor, hi: torch.Tensor,
                        s: torch.Tensor) -> torch.Tensor:
    """Position of the (s+1)-th set bit of the 64-bit mask (hi:lo), by a
    popcount binary search.  ``lo``/``hi`` are int64 in [0, 2^32); callers
    guarantee s < popcount(mask).  All-ones masks yield the identity."""
    s = s.to(torch.int64)
    pc_lo = _popcount32(lo)
    use_hi = s >= pc_lo
    m = torch.where(use_hi, hi, lo)
    s32 = torch.where(use_hi, s - pc_lo, s)
    p = torch.where(use_hi, 32, 0)
    for width in (16, 8, 4, 2, 1):
        c = _popcount32(m & ((1 << width) - 1))
        go_hi = s32 >= c
        s32 = s32 - torch.where(go_hi, c, 0)
        p = p + torch.where(go_hi, width, 0)
        m = torch.where(go_hi, m >> width, m)
    return p


def _culling(attrs: SplatAttrs | None,
             settings: RenderSettings | None) -> bool:
    return attrs is not None and settings is not None and settings.tile_cull


def expansion_inputs(aux: SplatAux, ntx: int, e_cap: int,
                     attrs: SplatAttrs | None = None,
                     settings: RenderSettings | None = None):
    """What the ragged expansion is given: (word_stack (5, N) i32, counts
    (N,) i32, keep (N,) bool, demand ()).  Per Gaussian, the five binning
    words are the key base ``(base_tile << 16) | depth16``, the first
    entry slot, tiles_x and the cull survivor mask lo/hi (zero without the
    cull); counts are the kept entries, after Gaussians that would
    overflow ``e_cap`` are dropped whole; demand is the entry count before
    that drop."""
    cull_on = _culling(attrs, settings)
    if cull_on:
        mask_lo, mask_hi, counts0 = _cull_bitmask(aux, attrs, settings)
    else:
        counts0 = aux.num_tiles
    counts0 = counts0.to(torch.int64)
    cum_all = torch.cumsum(counts0, 0)
    demand = cum_all[-1]
    keep = cum_all <= e_cap
    counts = torch.where(keep, counts0, 0)
    offsets = torch.cumsum(counts, 0) - counts

    base_tile = (aux.tile_min[:, 1].to(torch.int64) * ntx
                 + aux.tile_min[:, 0].to(torch.int64))
    zeros = torch.zeros_like(base_tile)
    words = torch.stack([
        (base_tile << 16) | _ordered_depth16(aux.depth),
        offsets,
        aux.tile_dims[:, 0].to(torch.int64),
        mask_lo if cull_on else zeros,
        mask_hi if cull_on else zeros,
    ])
    return _to_i32(words), counts.to(torch.int32), keep, demand


def expand_entries(aux: SplatAux, ntx: int, e_cap: int,
                   attrs: SplatAttrs | None = None,
                   settings: RenderSettings | None = None):
    """Ragged expansion of per-Gaussian tile rects into per-entry sort keys,
    in expansion (Gaussian-grouped) order.

    Returns (key, g, counts, total, keep, demand): the key per expansion
    slot (int64 holding the u32 ``(tile<<16)|depth16``, sentinel past the
    total), the Gaussian id per slot (i32), the per-Gaussian kept entry
    counts, the total kept entries, the keep mask and the pre-drop entry
    demand.  With ``attrs`` and ``settings.tile_cull``, only the
    (gaussian, tile) pairs that survive :func:`_cull_bitmask` are emitted;
    each entry maps its survivor slot back to a rect position by
    :func:`_select_nth_set_bit`."""
    cull_on = _culling(attrs, settings)
    dev = aux.num_tiles.device
    words, counts, keep, demand = expansion_inputs(aux, ntx, e_cap, attrs,
                                                   settings)
    total_expansion = counts.sum(dtype=torch.int64)
    ew, g = expand_fields(words, counts, e_cap)
    w_key = _to_u32(ew[0])
    w_off = ew[1].to(torch.int64)
    w_tx = ew[2].to(torch.int64)

    e_idx = torch.arange(e_cap, dtype=torch.int64, device=dev)
    valid = e_idx < total_expansion
    slot = e_idx - w_off
    if cull_on:
        pos = _select_nth_set_bit(_to_u32(ew[3]), _to_u32(ew[4]),
                                  torch.clamp(slot, min=0))
        # large rects (identity mask, may exceed 64 positions): p == slot
        pos = torch.where(slot >= CULL_POSITIONS, slot, pos)
    else:
        pos = slot
    tiles_x = torch.clamp(w_tx, min=1)
    q = torch.div(pos, tiles_x, rounding_mode="floor")
    r = pos - q * tiles_x

    key = torch.where(valid, (w_key + ((q * ntx + r) << 16)) & MASK32,
                      SENTINEL_KEY)
    return key, g, counts, total_expansion, keep, demand


def bin_splats(aux: SplatAux, img_w: int, img_h: int,
               settings: RenderSettings,
               capacity: int | None = None,
               with_source: bool = False,
               attrs: SplatAttrs | None = None) -> Binning:
    """Expand, sort and range the entries of one frame.  ``attrs`` (with
    ``settings.tile_cull``) enables the exact per-(gaussian, tile) alpha
    cull; ``with_source`` also returns the expansion-order payloads the
    gradient path needs."""
    n = aux.num_tiles.shape[0]
    e_cap = capacity if capacity is not None else entry_capacity(n, settings)
    ntx, nty = tile_grid(img_w, img_h, settings)
    total_tiles = ntx * nty
    check_tile_key_limit(total_tiles)
    dev = aux.num_tiles.device

    key, g, counts, total_kept, keep, demand = expand_entries(
        aux, ntx, e_cap, attrs=attrs, settings=settings)
    culling = _culling(attrs, settings)

    # ONE stable depth sort; the sorted order is the final entry layout
    sorted_key, perm = torch.sort(key, stable=True)
    sorted_gauss = g[perm]

    if culling:
        # tile ranges from the sorted keys: valid keys are < T << 16, so
        # offsets[T] lands on the surviving-entry count
        bounds = torch.arange(total_tiles + 1, dtype=torch.int64,
                              device=dev) << 16
        tile_offsets = torch.searchsorted(sorted_key, bounds,
                                          side="left").to(torch.int32)
        tile_counts = tile_offsets[1:] - tile_offsets[:-1]
    else:
        tile_counts = _tile_histogram(aux, keep, ntx, nty)
        tile_offsets = torch.cat([
            torch.zeros((1,), dtype=torch.int32, device=dev),
            torch.cumsum(tile_counts, 0, dtype=torch.int32)])

    e_idx = torch.arange(e_cap, dtype=torch.int64, device=dev)
    return Binning(
        entry_gauss=sorted_gauss,
        entry_valid=e_idx < total_kept,
        tile_offsets=tile_offsets,
        tile_counts=tile_counts,
        total_entries=total_kept,
        entry_source=perm.to(torch.int32) if with_source else None,
        gauss_counts=counts if with_source else None,
        expansion_gauss=g if with_source else None,
        expansion_entries=demand,
    )
