"""Tiled alpha-compositing rasterizer, forward and backward (counterpart
of webdgs_tpu/ops/rasterize.py:63-86, 347-740, 743-950).

The kernels read each entry slot's attributes from one of two inputs:
- :class:`EntryAttrs`, the render's: the per-Gaussian ``SplatAttrs``
  fields, read through the binning's ``entry_gauss``/``entry_valid`` by
  the kernels' own staging of each tile's range (``csrc/tile_stage.cuh``);
  nothing of size (16, E) is built;
- packed (16, E) per-entry rows (``pack_entry_attrs``, or the
  Gaussian-sharded exchange's received rows).
The choice follows the argument.  ``rasterize_tiles`` is differentiable
with respect to the packed rows, or to the five fields, whose gradient is
the per-entry cotangents summed per Gaussian by the segment-sum kernel
(``ops/segsum.py``, :func:`entry_grads`): always the exact-f32 segment
sum, deterministic, and never an autograd scatter of an index gather.
``tile_offsets`` gets no gradient, and the cotangents of channels 5-7 --
n_contrib and the spare channels -- are ignored.  Its forward is the
wrapper of CUDA kernel ``csrc/rasterize_fwd.cu`` (one CTA per tile, four
pixels per thread, entries staged through shared memory, tiles launched
heaviest first); its backward folds the per-pixel suffix term outside the
kernel and calls :func:`rasterize_tiles_backward`, the wrapper of
``csrc/rasterize_bwd.cu``.  On a CPU tensor each wrapper runs its plain
torch version on the packed rows (:func:`rasterize_tiles_plain`,
:func:`rasterize_tiles_backward_plain`; :func:`packed_rows` packs
:class:`EntryAttrs`), blocked like the TPU kernels: all tiles in parallel,
chunks of ``settings.chunk`` entries, the exclusive log-transmittance
carried across chunks, and a tile dropping out once all its pixels have
saturated.  On a CUDA tensor each launches its kernel or raises.

``pack_entry_attrs`` gathers per-Gaussian attributes into per-entry rows;
the trace counter ``raster.packed_calls`` counts its calls on the card
(the render, the training step and the metric views make none).

Alpha semantics (the reference's): alpha = min(alpha_max, op *
exp(-0.5 * conic quad form)); pixels outside the splat's SnugBox extents
are skipped; alpha < alpha_min contributes nothing; a splat counts only
while the exclusive transmittance is >= t_threshold; n_contrib is the
1-based index of the last contributing splat in the tile's range.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from webdgs_tpu_torch import _build, trace
from webdgs_tpu_torch.config import RenderSettings
from webdgs_tpu_torch.ops.projection import SplatAttrs
from webdgs_tpu_torch.ops.segsum import segment_reduce_entries

# attribute-row layout of the packed per-entry splat array (16, E)
ROW_CX, ROW_CY = 0, 1
ROW_CA, ROW_CB, ROW_CC = 2, 3, 4
ROW_R, ROW_G, ROW_B = 5, 6, 7
ROW_OP = 8
ROW_EX, ROW_EY = 9, 10
NUM_ROWS = 16

# output-channel layout of the per-tile pixel buffer (T, NUM_OUT, P),
# channel-planar: pixels on the minor axis
OUT_R, OUT_G, OUT_B = 0, 1, 2
OUT_ACC_ALPHA = 3
OUT_T = 4
OUT_NCONTRIB = 5
NUM_OUT = 8
# backward-kernel pixel-cotangent channels: d(r, g, b, acc) + the pixel's
# suffix term sum_c g_c*out_c + g_T*T_final
GPIX_SUFFIX = 4
NUM_GPIX = 5

# the forward kernel stages ROW_CX..ROW_EY of each entry as a 12-float
# record, two chunks at a time, in dynamic shared memory, which it sizes up
# to 48 KB without an opt-in attribute
_RECORD_FLOATS = 12
_MAX_CHUNK = 48 * 1024 // (2 * 4 * _RECORD_FLOATS)
# elements of one (tiles, P, K) temporary of the plain forward
_PLAIN_GROUP_ELEMS = 2 ** 26


class EntryAttrs(NamedTuple):
    """Per-entry splat attributes read through the binning's index: slot
    e holds Gaussian ``entry_gauss[e]``'s ``SplatAttrs`` where
    ``entry_valid[e]``, and zeros elsewhere (its index is then never
    read): the rows :func:`pack_entry_attrs` would build, never built.
    With ``entry_source`` and ``gauss_counts`` (``bin_splats(...,
    with_source=True)``) the fields are differentiable through
    :func:`rasterize_tiles` (:func:`entry_grads`)."""

    attrs: SplatAttrs
    entry_gauss: torch.Tensor  # (E,) int32
    entry_valid: torch.Tensor  # (E,) bool
    entry_source: torch.Tensor | None = None  # (E,) int32
    gauss_counts: torch.Tensor | None = None  # (N,) int32

    @classmethod
    def of(cls, attrs: SplatAttrs, bins) -> "EntryAttrs":
        """The entries of ``bins``, a ``binning.Binning`` of ``attrs``."""
        return cls(attrs, bins.entry_gauss, bins.entry_valid,
                   bins.entry_source, bins.gauss_counts)


def entry_slots(entries) -> int:
    """E, the slots of packed (16, E) rows or of an :class:`EntryAttrs`."""
    if isinstance(entries, torch.Tensor):
        return entries.shape[1]
    return entries.entry_gauss.shape[0]


def check_entries(entries, device: torch.device):
    """Shapes, types and devices (``device``) of packed (16, E) rows or an
    :class:`EntryAttrs`; returns them as the kernels read them (the
    fields, index and flags contiguous).  Reads nothing back."""
    if isinstance(entries, torch.Tensor):
        if entries.dim() != 2 or entries.shape[0] != NUM_ROWS:
            raise ValueError(f"attrs16 must be ({NUM_ROWS}, E), got "
                             f"{tuple(entries.shape)}")
        if entries.dtype != torch.float32:
            raise TypeError(f"attrs16 must be float32, got {entries.dtype}")
        if not entries.is_contiguous():
            raise ValueError("attrs16 must be contiguous")
        if entries.device != device:
            raise ValueError(f"attrs16 is on {entries.device}, the tile "
                             f"offsets on {device}")
        return entries
    a, gauss, valid = entries.attrs, entries.entry_gauss, entries.entry_valid
    if gauss.dim() != 1 or gauss.dtype != torch.int32:
        raise TypeError("entry_gauss must be (E,) int32")
    if valid.shape != gauss.shape or valid.dtype != torch.bool:
        raise TypeError(f"entry_valid must be ({gauss.shape[0]},) bool")
    n = a.opacity.shape[0]
    for name, t, shape in zip(SplatAttrs._fields, a,
                              ((n, 2), (n, 3), (n, 3), (n,), (n, 2))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in zip(("entry_gauss", "entry_valid") + SplatAttrs._fields,
                       (gauss, valid, *a)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the tile offsets on "
                             f"{device}")
    return entries._replace(
        attrs=SplatAttrs(*(t.contiguous() for t in a)),
        entry_gauss=gauss.contiguous(), entry_valid=valid.contiguous())


def packed_rows(entries) -> torch.Tensor:
    """The (16, E) rows the plain versions read: packed rows themselves,
    or the pack of an :class:`EntryAttrs` (zeros at invalid slots)."""
    if isinstance(entries, torch.Tensor):
        return entries
    return _gather_pack(_pack_per_gauss(entries.attrs), entries.entry_gauss,
                        entries.entry_valid)


def entry_kernel(lib, name: str, entries):
    """The C entry point ``name`` that reads ``entries`` and its leading
    arguments: the packed rows and E, or (``<name>_indexed``) the index,
    the flags, the five fields and E."""
    if isinstance(entries, torch.Tensor):
        return getattr(lib, name), (entries.data_ptr(), entries.shape[1])
    ptrs = [t.data_ptr() for t in (entries.entry_gauss, entries.entry_valid,
                                   *entries.attrs)]
    return getattr(lib, name + "_indexed"), (*ptrs, entry_slots(entries))


def _check_inputs(entries, tile_offsets, ntx, nty, settings):
    entries = check_entries(entries, tile_offsets.device)
    if tile_offsets.dtype != torch.int32:
        raise TypeError(f"tile_offsets must be int32, got "
                        f"{tile_offsets.dtype}")
    if tile_offsets.shape != (ntx * nty + 1,):
        raise ValueError(f"tile_offsets must be ({ntx * nty + 1},), got "
                         f"{tuple(tile_offsets.shape)}")
    if not tile_offsets.is_contiguous():
        raise ValueError("tile_offsets must be contiguous")
    if not 0 < settings.tile_px <= 1024:
        raise ValueError(f"tile of {settings.tile_px} pixels: one CUDA "
                         "block holds 1 to 1024")
    if not 0 < settings.chunk <= _MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {_MAX_CHUNK}]")
    return entries


def _pixel_coords(ntx: int, n_tiles: int, settings: RenderSettings,
                  device) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel-center coordinates of every tile, (T, P, 1) each."""
    t = torch.arange(n_tiles, dtype=torch.int32, device=device)[:, None]
    pix = torch.arange(settings.tile_px, dtype=torch.int32,
                       device=device)[None, :]
    pxf = ((t % ntx) * settings.tile_w + pix % settings.tile_w).to(
        torch.float32) + 0.5
    pyf = ((t // ntx) * settings.tile_h + pix // settings.tile_w).to(
        torch.float32) + 0.5
    return pxf[..., None], pyf[..., None]


def _chunk_alpha(sub: torch.Tensor, pxf: torch.Tensor, pyf: torch.Tensor,
                 settings: RenderSettings):
    """Per-(pixel, entry) alpha of one chunk, op for op as the kernels
    compute it (csrc/splat_alpha.cuh).  ``sub``: (t, 16, 1, K) entry rows;
    ``pxf``/``pyf``: (t, P, 1) pixel centres.  Returns (alpha, gw, dx, dy,
    keep), each (t, P, K): the clamped alpha and the Gaussian weight before
    masking, and ``keep`` = inside the extent box and alpha >= alpha_min."""
    def row(i):
        return sub[:, i]  # (t, 1, K)

    dx = pxf - row(ROW_CX)
    dy = pyf - row(ROW_CY)
    u1 = row(ROW_CA) * dx + row(ROW_CB) * dy
    u2 = row(ROW_CB) * dx + row(ROW_CC) * dy
    power = dx * u1 + dy * u2
    gw = torch.exp(-0.5 * power)
    alpha = torch.clamp(row(ROW_OP) * gw, max=settings.alpha_max)
    keep = ((dx.abs() <= row(ROW_EX)) & (dy.abs() <= row(ROW_EY))
            & (alpha >= settings.alpha_min))
    return alpha, gw, dx, dy, keep


def rasterize_tiles_plain(attrs16: torch.Tensor, tile_offsets: torch.Tensor,
                          num_tiles_x: int, num_tiles_y: int,
                          settings: RenderSettings,
                          track_ncontrib: bool = True) -> torch.Tensor:
    """Plain torch version of the kernel, (T, NUM_OUT, P) float32.  Each
    tile's range is clamped to 0 <= uo <= end <= E, as the kernel clamps
    it."""
    dev = attrs16.device
    n_tiles = num_tiles_x * num_tiles_y
    p, k = settings.tile_px, settings.chunk
    log_t_min = math.log(settings.t_threshold)
    e_len = attrs16.shape[1]

    off = tile_offsets.to(torch.int64)
    uo = off[:-1].clamp(0, e_len)
    cnt = torch.maximum(off[1:], uo).clamp(max=e_len) - uo
    nch = (cnt + k - 1) // k
    pxf, pyf = _pixel_coords(num_tiles_x, n_tiles, settings, dev)
    lane = torch.arange(k, dtype=torch.int64, device=dev)

    log_t_un = torch.zeros((n_tiles, p, 1), dtype=torch.float32, device=dev)
    log_t_gated = torch.zeros_like(log_t_un)
    nmax = torch.zeros_like(log_t_un)
    acc = torch.zeros((n_tiles, 4, p), dtype=torch.float32, device=dev)

    # the live tiles take a chunk in groups, so that each (t, P, K)
    # temporary holds at most _PLAIN_GROUP_ELEMS elements whatever the
    # frame (an 8K band has ~35k tiles); tiles are independent
    group = max(1, _PLAIN_GROUP_ELEMS // (p * k))
    n_chunks = int(nch.max()) if n_tiles else 0
    for c in range(n_chunks):
        # tiles with a chunk left and an unsaturated pixel (the TPU
        # kernel's while-loop test, rasterize.py:318-320)
        live = (c < nch) & (log_t_un.amax(dim=(1, 2)) >= log_t_min)
        live_tiles = torch.nonzero(live).squeeze(1)
        if live_tiles.numel() == 0:
            break
        for tl in live_tiles.split(group):
            sl = uo[tl, None] + c * k + lane  # (t, K) entry slots
            in_range = sl < (uo + cnt)[tl, None]
            sub = attrs16[:, torch.clamp(sl, max=e_len - 1)]  # (16, t, K)
            sub = sub.permute(1, 0, 2)[:, :, None, :]  # (t, 16, 1, K)
            alpha, _, _, _, keep = _chunk_alpha(sub, pxf[tl], pyf[tl],
                                                settings)
            alpha = torch.where(keep & in_range[:, None, :], alpha, 0.0)

            lt = log_t_un[tl]
            alog = torch.log1p(-alpha)
            alog_incl = torch.cumsum(alog, dim=2)
            t_excl = torch.exp(alog_incl - alog + lt)
            incl = (t_excl >= settings.t_threshold).to(torch.float32)
            w = alpha * t_excl * incl  # (t, P, K)

            c4 = torch.cat([sub[:, ROW_R:ROW_B + 1, 0, :],
                            torch.ones_like(sub[:, 0:1, 0, :])], dim=1)
            acc[tl] += torch.einsum("tck,tpk->tcp", c4, w)
            log_t_un[tl] = lt + alog_incl[:, :, k - 1:k]
            log_t_gated[tl] += (alog * incl).sum(dim=2, keepdim=True)
            if track_ncontrib:
                pos = (c * k + lane + 1).to(torch.float32)
                contrib = (alpha > 0.0) & (incl > 0.0)
                cand = torch.where(contrib, pos, 0.0).amax(dim=2,
                                                           keepdim=True)
                nmax[tl] = torch.maximum(nmax[tl], cand)

    out = torch.zeros((n_tiles, NUM_OUT, p), dtype=torch.float32, device=dev)
    out[:, 0:4] = acc
    out[:, OUT_T] = torch.exp(log_t_gated[..., 0])
    out[:, OUT_NCONTRIB] = nmax[..., 0]
    return out


def _rasterize_tiles_cuda(entries, tile_offsets, ntx, nty, settings,
                          track_ncontrib):
    lib = _build.library()
    dev = tile_offsets.device
    n_tiles = ntx * nty
    out = torch.empty((n_tiles, NUM_OUT, settings.tile_px),
                      dtype=torch.float32, device=dev)
    if n_tiles == 0:
        return out
    # scratch for the launch order the kernel computes (heaviest tiles
    # first, by entry count)
    order = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    fn, head = entry_kernel(lib, "webdgs_rasterize_fwd", entries)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*head, tile_offsets.data_ptr(), n_tiles, ntx,
                 settings.tile_w, settings.tile_h, settings.chunk,
                 settings.alpha_min, settings.alpha_max,
                 settings.t_threshold, math.log(settings.t_threshold),
                 int(track_ncontrib), out.data_ptr(), order.data_ptr(),
                 stream)
    _build.check(err, "rasterize_tiles")
    trace.count("launches.rasterize_tiles")
    return out


def _entries(index, data):
    """The entries a :class:`_RasterizeTiles` holds: its one packed tensor
    (``index`` None), or the five fields with ``index``, the rest of an
    :class:`EntryAttrs`."""
    return data[0] if index is None else EntryAttrs(SplatAttrs(*data),
                                                    *index)


class _RasterizeTiles(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its VJP: with
    respect to the packed rows, or to the five fields of an
    :class:`EntryAttrs` (then summed per Gaussian, :func:`entry_grads`).
    ``data`` are the tensors differentiated; ``index`` the rest."""

    @staticmethod
    def forward(ctx, index, tile_offsets, num_tiles_x, num_tiles_y,
                settings, track_ncontrib, *data):
        entries = _entries(index, data)
        dev = tile_offsets.device
        if dev.type == "cpu":
            out = rasterize_tiles_plain(packed_rows(entries), tile_offsets,
                                        num_tiles_x, num_tiles_y, settings,
                                        track_ncontrib)
        elif dev.type == "cuda":
            out = _rasterize_tiles_cuda(entries, tile_offsets, num_tiles_x,
                                        num_tiles_y, settings, track_ncontrib)
        else:
            raise ValueError(f"unsupported device {dev}")
        ctx.save_for_backward(tile_offsets, out, *data)
        ctx.index = index
        ctx.grid = (num_tiles_x, num_tiles_y, settings)
        return out

    @staticmethod
    def backward(ctx, g):
        tile_offsets, out, *data = ctx.saved_tensors
        entries = _entries(ctx.index, data)
        ntx, nty, settings = ctx.grid
        # the forward outputs enter the backward only through the
        # per-pixel suffix term sum_c g_c*out_c (c = r,g,b,acc) + g_T*T
        suffix = (torch.sum(g[:, 0:4] * out[:, 0:4], dim=1, keepdim=True)
                  + g[:, OUT_T:OUT_T + 1] * out[:, OUT_T:OUT_T + 1])
        gpix5 = torch.cat([g[:, 0:4], suffix], dim=1).contiguous()
        d_attrs = rasterize_tiles_backward(entries, tile_offsets, gpix5, ntx,
                                           nty, settings)
        grads = ((d_attrs,) if ctx.index is None
                 else tuple(entry_grads(entries, d_attrs)))
        return (None,) * 6 + grads


def rasterize_tiles(entries, tile_offsets: torch.Tensor,
                    num_tiles_x: int, num_tiles_y: int,
                    settings: RenderSettings,
                    track_ncontrib: bool = True) -> torch.Tensor:
    """entries: (16, E) f32 packed per-entry attributes in sorted
    tile/depth order, or an :class:`EntryAttrs` (the same rows read
    through the binning's index); tile_offsets: (T+1,) i32 entry ranges (a
    plain cumsum of per-tile counts, ending at most at E).

    Returns (T, NUM_OUT, P) channel-planar per-tile pixels
    [r, g, b, acc_alpha, T_final, n_contrib, 0, 0] without background;
    channel 5 reads 0 unless ``track_ncontrib``.  Differentiable with
    respect to the packed rows or the fields.  Tile ranges past [0, E]
    are clamped (by the kernels and the plain versions alike), so the
    offsets are never read back to the host: nothing here waits for the
    device.  ``kernel_launches()["rasterize_tiles"]`` counts the forward
    kernel's launches.
    """
    entries = _check_inputs(entries, tile_offsets, num_tiles_x, num_tiles_y,
                            settings)
    if isinstance(entries, torch.Tensor):
        index, data = None, (entries,)
    else:
        index, data = tuple(entries[1:]), tuple(entries.attrs)
    return _RasterizeTiles.apply(index, tile_offsets, num_tiles_x,
                                 num_tiles_y, settings, track_ncontrib, *data)


def _check_gpix(gpix5, n_tiles, settings):
    if tuple(gpix5.shape) != (n_tiles, NUM_GPIX, settings.tile_px):
        raise ValueError(f"gpix5 must be ({n_tiles}, {NUM_GPIX}, "
                         f"{settings.tile_px}), got {tuple(gpix5.shape)}")
    if gpix5.dtype != torch.float32 or not gpix5.is_contiguous():
        raise ValueError("gpix5 must be contiguous float32")


def rasterize_tiles_backward_plain(attrs16: torch.Tensor,
                                   tile_offsets: torch.Tensor,
                                   gpix5: torch.Tensor, num_tiles_x: int,
                                   num_tiles_y: int,
                                   settings: RenderSettings) -> torch.Tensor:
    """Plain torch version of the backward kernel, (16, E) float32: the
    TPU kernel's chunked formulation (rasterize.py:426-494) in f32.  Each
    tile's range is clamped to 0 <= uo <= end <= E, as the kernel clamps
    it."""
    dev = attrs16.device
    n_tiles = num_tiles_x * num_tiles_y
    p, k = settings.tile_px, settings.chunk
    log_t_min = math.log(settings.t_threshold)
    e_len = attrs16.shape[1]

    off = tile_offsets.to(torch.int64)
    uo = off[:-1].clamp(0, e_len)
    cnt = torch.maximum(off[1:], uo).clamp(max=e_len) - uo
    nch = (cnt + k - 1) // k
    pxf, pyf = _pixel_coords(num_tiles_x, n_tiles, settings, dev)
    lane = torch.arange(k, dtype=torch.int64, device=dev)
    g4 = gpix5[:, 0:4].permute(0, 2, 1)[..., None]  # (T, P, 4, 1)
    suffix_all = gpix5[:, GPIX_SUFFIX][..., None]  # (T, P, 1)

    log_t_un = torch.zeros((n_tiles, p, 1), dtype=torch.float32, device=dev)
    cum_u = torch.zeros_like(log_t_un)
    d_attrs = torch.zeros((NUM_ROWS, e_len), dtype=torch.float32, device=dev)

    n_chunks = int(nch.max()) if n_tiles else 0
    for c in range(n_chunks):
        live_t = (c < nch) & (log_t_un.amax(dim=(1, 2)) >= log_t_min)
        tl = torch.nonzero(live_t).squeeze(1)
        if tl.numel() == 0:
            break
        sl = uo[tl, None] + c * k + lane  # (t, K) entry slots
        in_range = sl < (uo + cnt)[tl, None]
        sub = attrs16[:, torch.clamp(sl, max=e_len - 1)]  # (16, t, K)
        sub = sub.permute(1, 0, 2)[:, :, None, :]  # (t, 16, 1, K)

        def row(i):
            return sub[:, i]  # (t, 1, K)

        alpha, gw, dx, dy, keep = _chunk_alpha(sub, pxf[tl], pyf[tl],
                                               settings)
        op = row(ROW_OP)
        alpha = torch.where(keep & in_range[:, None, :], alpha, 0.0)

        lt = log_t_un[tl]
        alog = torch.log1p(-alpha)
        alog_incl = torch.cumsum(alog, dim=2)
        t_excl = torch.exp(alog_incl - alog + lt)
        incl = (t_excl >= settings.t_threshold).to(torch.float32)
        live = (alpha > 0.0).to(torch.float32) * incl
        w = alpha * t_excl * incl

        gt = g4[tl]  # (t, P, 4, 1)
        gamma = (gt[:, :, 0] * row(ROW_R) + gt[:, :, 1] * row(ROW_G)
                 + gt[:, :, 2] * row(ROW_B) + gt[:, :, 3])  # (t, P, K)
        u_incl = torch.cumsum(gamma * w, dim=2)
        u_prefix = cum_u[tl] + u_incl
        dl_da = (gamma * t_excl
                 - (suffix_all[tl] - u_prefix) / (1.0 - alpha)) * live
        unclamped = (op * gw < settings.alpha_max).to(torch.float32)
        dl_dg = dl_da * op * unclamped
        d_op = torch.sum(dl_da * gw * unclamped, dim=1)  # (t, K)
        d_col = torch.einsum("tpc,tpk->tck", gt[..., 0][:, :, 0:3], w)
        q = dl_dg * (-0.5 * gw)
        qx = q * dx
        qy = q * dy
        s_qx = qx.sum(dim=1)
        s_qy = qy.sum(dim=1)
        ca, cb, cc = (sub[:, ROW_CA, 0], sub[:, ROW_CB, 0],
                      sub[:, ROW_CC, 0])  # (t, K)
        rows = torch.zeros((NUM_ROWS,) + tuple(s_qx.shape),
                           dtype=torch.float32, device=dev)
        rows[ROW_CX] = -2.0 * (ca * s_qx + cb * s_qy)
        rows[ROW_CY] = -2.0 * (cb * s_qx + cc * s_qy)
        rows[ROW_CA] = (qx * dx).sum(dim=1)
        rows[ROW_CB] = 2.0 * (qx * dy).sum(dim=1)
        rows[ROW_CC] = (qy * dy).sum(dim=1)
        rows[ROW_R:ROW_B + 1] = d_col.permute(1, 0, 2)
        rows[ROW_OP] = d_op
        d_attrs[:, sl[in_range]] = rows[:, in_range]

        log_t_un[tl] = lt + alog_incl[:, :, k - 1:k]
        cum_u[tl] = u_prefix[:, :, k - 1:k]
    return d_attrs


def _rasterize_tiles_backward_cuda(entries, tile_offsets, gpix5, ntx, nty,
                                   settings):
    lib = _build.library()
    dev = tile_offsets.device
    n_tiles = ntx * nty
    d_attrs = torch.zeros((NUM_ROWS, entry_slots(entries)),
                          dtype=torch.float32, device=dev)
    if n_tiles == 0:
        return d_attrs
    # scratch for the launch order the kernel computes (heaviest tiles
    # first, by entry count)
    order = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    fn, head = entry_kernel(lib, "webdgs_rasterize_bwd", entries)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*head, tile_offsets.data_ptr(), gpix5.data_ptr(), n_tiles,
                 ntx, settings.tile_w, settings.tile_h, settings.chunk,
                 settings.alpha_min, settings.alpha_max,
                 settings.t_threshold, math.log(settings.t_threshold),
                 d_attrs.data_ptr(), order.data_ptr(), stream)
    _build.check(err, "rasterize_tiles_backward")
    trace.count("launches.rasterize_tiles_backward")
    return d_attrs


def rasterize_tiles_backward(entries, tile_offsets: torch.Tensor,
                             gpix5: torch.Tensor, num_tiles_x: int,
                             num_tiles_y: int,
                             settings: RenderSettings) -> torch.Tensor:
    """Per-entry cotangents (16, E) of the rasterizer: rows 0-8 (centre,
    conic, colour, opacity) for the slots of each tile's range, zero
    elsewhere (extent rows, spare rows, slots past the total, chunks a
    saturated tile never reached).  ``entries`` as :func:`rasterize_tiles`
    takes them.

    gpix5: (T, NUM_GPIX, P) planar pixel cotangents d(r, g, b, acc) plus
    the per-pixel suffix term in channel GPIX_SUFFIX.  Tile ranges past
    [0, E] are clamped (by the kernel and the plain version alike), so the
    offsets are never read back to the host: nothing here waits for the
    device.  ``kernel_launches()["rasterize_tiles_backward"]`` counts
    the CUDA kernel's launches."""
    entries = _check_inputs(entries, tile_offsets, num_tiles_x, num_tiles_y,
                            settings)
    _check_gpix(gpix5, num_tiles_x * num_tiles_y, settings)
    dev = tile_offsets.device
    if gpix5.device != dev:
        raise ValueError("gpix5 and the entries are on different devices")
    if dev.type == "cpu":
        return rasterize_tiles_backward_plain(packed_rows(entries),
                                              tile_offsets, gpix5,
                                              num_tiles_x, num_tiles_y,
                                              settings)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _rasterize_tiles_backward_cuda(entries, tile_offsets, gpix5,
                                          num_tiles_x, num_tiles_y, settings)


def _pack_per_gauss(attrs) -> torch.Tensor:
    n = attrs.opacity.shape[0]
    return torch.cat([
        attrs.center_px,  # 2
        attrs.conic,  # 3
        attrs.color,  # 3
        attrs.opacity[:, None],  # 1
        attrs.extents,  # 2
        torch.zeros((n, NUM_ROWS - 11), dtype=torch.float32,
                    device=attrs.opacity.device),
    ], dim=1)  # (N, 16); column order matches ROW_*


def _gather_pack(per_gauss, entry_gauss, entry_valid):
    # an invalid slot's index may hold anything: gather row 0 there
    idx = torch.where(entry_valid, entry_gauss, 0).to(torch.int64)
    gathered = torch.where(entry_valid[:, None], per_gauss[idx], 0.0)
    return gathered.T.contiguous()


def entry_grads(entries: EntryAttrs, d_attrs: torch.Tensor) -> SplatAttrs:
    """The fields' gradient from per-entry cotangents (16, E): summed per
    Gaussian in expansion order by the segment sum (never autograd's
    scatter of the index gather, which accumulates by atomics on the
    card), then split into the five fields, as the transpose of
    :func:`pack_entry_attrs` would."""
    if entries.entry_source is None or entries.gauss_counts is None:
        raise ValueError("the gradient through the entry index needs "
                         "entry_source and gauss_counts (bin_splats(..., "
                         "with_source=True))")
    d = segment_reduce_entries(d_attrs.T, entries.entry_valid,
                               entries.entry_source, entries.gauss_counts)
    return SplatAttrs(center_px=d[:, ROW_CX:ROW_CY + 1],
                      conic=d[:, ROW_CA:ROW_CC + 1],
                      color=d[:, ROW_R:ROW_B + 1], opacity=d[:, ROW_OP],
                      extents=d[:, ROW_EX:ROW_EY + 1])


def pack_entry_attrs(attrs, entry_gauss: torch.Tensor,
                     entry_valid: torch.Tensor) -> torch.Tensor:
    """Gather per-Gaussian SplatAttrs into depth-sorted per-entry rows
    (16, E), contiguous.  Invalid slots are zeroed everywhere (their index
    is never read): opacity 0 makes them exact no-ops in the compositor.
    The kernels read an :class:`EntryAttrs` of the same entries without
    this pack; ``raster.packed_calls`` counts the calls on the card."""
    if entry_gauss.device.type == "cuda":
        trace.count("raster.packed_calls")
    return _gather_pack(_pack_per_gauss(attrs), entry_gauss, entry_valid)


def composite_background(tiles: torch.Tensor,
                         settings: RenderSettings) -> torch.Tensor:
    """accum + background * T_final; tiles: (..., NUM_OUT) image-space
    pixel channels (after :func:`tiles_to_image`) -> (..., 3).  The
    background enters as Python scalars: no upload from the host, which
    would wait for the device."""
    t_final = tiles[..., OUT_T]
    return torch.stack([tiles[..., c] + b * t_final
                        for c, b in enumerate(settings.background)], dim=-1)


def tiles_to_image(out: torch.Tensor, num_tiles_x: int, num_tiles_y: int,
                   img_w: int, img_h: int,
                   settings: RenderSettings) -> torch.Tensor:
    """(T, C, P) channel-planar per-tile pixels -> (H, W, C) image crop."""
    c = out.shape[1]
    img = out.reshape(num_tiles_y, num_tiles_x, c, settings.tile_h,
                      settings.tile_w)
    img = img.permute(0, 3, 1, 4, 2).reshape(
        num_tiles_y * settings.tile_h, num_tiles_x * settings.tile_w, c)
    return img[:img_h, :img_w]


def image_to_tiles(img: torch.Tensor, num_tiles_x: int, num_tiles_y: int,
                   settings: RenderSettings) -> torch.Tensor:
    """(H, W, C) -> channel-minor (T, P, C), zero-padding to the tile grid
    (the per-pixel layout the importance replay consumes)."""
    h, w, c = img.shape
    ph = num_tiles_y * settings.tile_h - h
    pw = num_tiles_x * settings.tile_w - w
    img = torch.nn.functional.pad(img, (0, 0, 0, pw, 0, ph))
    img = img.reshape(num_tiles_y, settings.tile_h, num_tiles_x,
                      settings.tile_w, c)
    return img.permute(0, 2, 1, 3, 4).reshape(
        num_tiles_y * num_tiles_x, settings.tile_px, c)
