"""Per-Gaussian gradient accumulation: segment sums of per-entry rows
(counterpart of webdgs_tpu/ops/segsum.py:136-201 and the sum half of
webdgs_tpu/ops/rasterize.py:774-869).

Entries in expansion order are grouped by Gaussian: Gaussian g owns the
contiguous range ``[starts[g], starts[g+1])`` of the exclusive count
cumsum.  ``segment_sum_rows`` is the wrapper of CUDA kernel
``csrc/segsum.cu`` (one thread per (Gaussian, row), summing its range in
index order, reading each entry through a slot map -- the inverse sort
permutation -- so the expansion-order gather and the sum fuse).  On a CPU
tensor it runs :func:`segment_sum_rows_plain` (gather, then
exclusive-prefix differences in float64, so each sum is exact to float32
rounding); on a CUDA tensor it launches the kernel or raises.
Both are deterministic.  Accumulation is float32 in the kernel, with no
bf16 hi/lo split and no f16 tier: those were TPU matrix-unit workarounds.
"""

from __future__ import annotations

import torch

from webdgs_tpu_torch import _build


def _starts(gauss_counts: torch.Tensor) -> torch.Tensor:
    """(N+1,) i32 exclusive cumsum of the per-Gaussian counts."""
    z = torch.zeros((1,), dtype=torch.int64, device=gauss_counts.device)
    return torch.cat([z, torch.cumsum(gauss_counts.to(torch.int64), 0)]
                     ).to(torch.int32)


def _check_inputs(rows_cm, gauss_counts, slots, slot_valid):
    if rows_cm.dim() != 2:
        raise ValueError(f"rows_cm must be (C, L), got "
                         f"{tuple(rows_cm.shape)}")
    if rows_cm.dtype != torch.float32:
        raise TypeError(f"rows_cm must be float32, got {rows_cm.dtype}")
    if gauss_counts.dim() != 1 or gauss_counts.dtype != torch.int32:
        raise TypeError("gauss_counts must be (N,) int32")
    if slots.dim() != 1 or slots.dtype != torch.int32:
        raise TypeError("slots must be (E,) int32")
    # the kernel reads slots[k] for every k below the count total, and
    # rows_cm / slot_valid at those slots: keep both in bounds
    total = int(gauss_counts.sum(dtype=torch.int64))
    if total > slots.shape[0]:
        raise ValueError(f"{total} entries counted, {slots.shape[0]} slots")
    if total:
        lo, hi = torch.stack(torch.aminmax(slots[:total])).tolist()
        if lo < 0 or hi >= rows_cm.shape[1]:
            raise ValueError(f"slots span [{lo}, {hi}], outside the "
                             f"{rows_cm.shape[1]} columns of rows_cm")
    if slot_valid.shape != (rows_cm.shape[1],) or \
            slot_valid.dtype != torch.bool:
        raise TypeError(f"slot_valid must be ({rows_cm.shape[1]},) bool")
    for name, t in (("rows_cm", rows_cm), ("gauss_counts", gauss_counts),
                    ("slots", slots), ("slot_valid", slot_valid)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != rows_cm.device:
            raise ValueError(f"{name} is on {t.device}, rows_cm on "
                             f"{rows_cm.device}")


def segment_sum_rows_plain(rows_cm: torch.Tensor, gauss_counts: torch.Tensor,
                           slots: torch.Tensor, slot_valid: torch.Tensor
                           ) -> torch.Tensor:
    """Plain torch version of the kernel, (N, C) float32."""
    c = rows_cm.shape[0]
    starts = _starts(gauss_counts).to(torch.int64)
    total = int(starts[-1])
    rows = torch.where(slot_valid[None, :], rows_cm, 0.0)
    rows = rows[:, slots[:total].to(torch.int64)]
    cum = torch.cat([torch.zeros((c, 1), dtype=torch.float64,
                                 device=rows.device),
                     torch.cumsum(rows[:, :total].to(torch.float64), 1)],
                    dim=1)
    return (cum[:, starts[1:]] - cum[:, starts[:-1]]).T.to(torch.float32)


def _segment_sum_rows_cuda(rows_cm, gauss_counts, slots, slot_valid):
    lib = _build.library()
    n = gauss_counts.shape[0]
    out = torch.empty((n, rows_cm.shape[0]), dtype=torch.float32,
                      device=rows_cm.device)
    starts = _starts(gauss_counts)
    with torch.cuda.device(rows_cm.device):
        stream = torch.cuda.current_stream(rows_cm.device).cuda_stream
        err = lib.webdgs_segsum(
            rows_cm.data_ptr(), rows_cm.shape[0], rows_cm.shape[1],
            slots.data_ptr(), slot_valid.data_ptr(), starts.data_ptr(), n,
            out.data_ptr(), stream)
    _build.check(err, "segment_sum_rows")
    segment_sum_rows.kernel_launches += 1
    return out


def segment_sum_rows(rows_cm: torch.Tensor, gauss_counts: torch.Tensor,
                     slots: torch.Tensor, slot_valid: torch.Tensor
                     ) -> torch.Tensor:
    """Per-Gaussian sums of entry rows: out[g, c] = sum over the expansion
    indices k of Gaussian g of ``rows_cm[c, slots[k]]``, skipping slots
    whose ``slot_valid`` is False.

    rows_cm: (C, L) f32 channel-major rows; gauss_counts: (N,) i32;
    slots: (E,) i32 expansion index -> column of rows_cm, at least
    sum(gauss_counts) long; slot_valid: (L,) bool.  Returns (N, C) f32.
    ``segment_sum_rows.kernel_launches`` counts the CUDA kernel's launches.
    """
    _check_inputs(rows_cm, gauss_counts, slots, slot_valid)
    if rows_cm.device.type == "cpu":
        return segment_sum_rows_plain(rows_cm, gauss_counts, slots,
                                      slot_valid)
    if rows_cm.device.type != "cuda":
        raise ValueError(f"unsupported device {rows_cm.device}")
    return _segment_sum_rows_cuda(rows_cm, gauss_counts, slots, slot_valid)


segment_sum_rows.kernel_launches = 0


def inverse_permutation(entry_source: torch.Tensor) -> torch.Tensor:
    """(E,) i32 expansion index -> sorted slot, from the sort's
    ``entry_source`` (sorted slot -> expansion index, a true permutation):
    one scatter of unique indices."""
    inv = torch.empty_like(entry_source)
    inv[entry_source.to(torch.int64)] = torch.arange(
        entry_source.shape[0], dtype=torch.int32, device=entry_source.device)
    return inv


def segment_reduce_entries(rows: torch.Tensor, entry_valid: torch.Tensor,
                           entry_source: torch.Tensor,
                           gauss_counts: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian accumulation of per-entry values in sorted-slot order,
    without a scatter-add: (E, C) ``rows`` (any strides; the rasterizer's
    (16, E) cotangent transposed is read in place) -> (N, C) sums.

    Invalid slots are masked; valid slots are exactly the first
    sum(gauss_counts) expansion indices' slots, so the sum never reaches
    past them."""
    rows_cm = rows.T.contiguous()
    inv = inverse_permutation(entry_source)
    return segment_sum_rows(rows_cm, gauss_counts.to(torch.int32), inv,
                            entry_valid.contiguous())
