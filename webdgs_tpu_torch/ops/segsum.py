"""Per-Gaussian gradient accumulation: segment sums of per-entry rows
(counterpart of webdgs_tpu/ops/segsum.py:136-201 and the sum half of
webdgs_tpu/ops/rasterize.py:774-869).

Entries arrive in sorted-slot order; ``entry_source`` maps each sorted
slot to its expansion index.  In expansion order entries are grouped by
Gaussian: Gaussian g owns the contiguous range ``[cum[g-1], cum[g])`` of
the inclusive count cumsum.  ``segment_sum_rows`` is the wrapper of CUDA
kernel ``csrc/segsum.cu``, two passes: a reorder of the sorted rows into
an (L, C) scratch in expansion order (coalesced loads, one contiguous row
per entry), then one group of C threads per Gaussian summing its range in
index order.  On a CPU tensor it runs :func:`segment_sum_rows_plain` (the
same scatter into expansion order, then exclusive-prefix differences in
float64, so each sum is exact to float32 rounding); on a CUDA tensor it
launches the kernel or raises.  Both are deterministic.  Accumulation is
float32 in the kernel, with no bf16 hi/lo split and no f16 tier: those
were TPU matrix-unit workarounds.
"""

from __future__ import annotations

import torch

from webdgs_tpu_torch import _build, trace

# Gaussians per block of the kernel's count scan (csrc/segsum.cu kScan)
SCAN_BLOCK = 1024
# the kernel indexes its scratch and output with 32-bit integers
MAX_ELEMENTS = 2 ** 31 - 1


def _check_inputs(rows_cm, gauss_counts, entry_source, slot_valid):
    """Shapes, types, devices and contiguity: reads nothing back."""
    if rows_cm.dim() != 2:
        raise ValueError(f"rows_cm must be (C, L), got "
                         f"{tuple(rows_cm.shape)}")
    if rows_cm.dtype != torch.float32:
        raise TypeError(f"rows_cm must be float32, got {rows_cm.dtype}")
    if gauss_counts.dim() != 1 or gauss_counts.dtype != torch.int32:
        raise TypeError("gauss_counts must be (N,) int32")
    if entry_source.shape != (rows_cm.shape[1],) or \
            entry_source.dtype != torch.int32:
        raise TypeError(f"entry_source must be ({rows_cm.shape[1]},) int32")
    if slot_valid.shape != (rows_cm.shape[1],) or \
            slot_valid.dtype != torch.bool:
        raise TypeError(f"slot_valid must be ({rows_cm.shape[1]},) bool")
    c, e_len = rows_cm.shape
    if max(e_len, gauss_counts.shape[0]) * c > MAX_ELEMENTS:
        raise ValueError(f"(L, C) = {(e_len, c)} and (N, C) = "
                         f"{(gauss_counts.shape[0], c)} must stay below "
                         "2^31 elements")
    for name, t in (("rows_cm", rows_cm), ("gauss_counts", gauss_counts),
                    ("entry_source", entry_source),
                    ("slot_valid", slot_valid)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != rows_cm.device:
            raise ValueError(f"{name} is on {t.device}, rows_cm on "
                             f"{rows_cm.device}")


def _check_values(gauss_counts, entry_source):
    """What the kernel cannot take: a count total past the slots, or a
    first ``total`` slots' entry_source that is not a permutation of
    [0, total).  One read back of the device."""
    total = int(gauss_counts.sum(dtype=torch.int64))
    if total > entry_source.shape[0]:
        raise ValueError(f"{total} entries counted, {entry_source.shape[0]} "
                         "slots")
    if total:
        src = entry_source[:total]
        lo, hi = torch.aminmax(src)
        seen = torch.zeros(total, dtype=torch.bool, device=src.device)
        seen[src.clamp(0, total - 1).to(torch.int64)] = True
        lo, hi, covered = torch.stack(
            [lo, hi, seen.all().to(lo.dtype)]).tolist()
        if lo < 0 or hi >= total or not covered:
            raise ValueError(f"entry_source[:{total}] (span [{lo}, {hi}]) "
                             f"is not a permutation of [0, {total})")


def segment_sum_rows_plain(rows_cm: torch.Tensor, gauss_counts: torch.Tensor,
                           entry_source: torch.Tensor,
                           slot_valid: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel, (N, C) float32: the first
    ``total`` sorted slots scattered into expansion order (a slot whose
    flag is False as a zero row), then float64 prefix differences."""
    c = rows_cm.shape[0]
    cum = torch.cumsum(gauss_counts.to(torch.int64), 0)
    total = int(cum[-1]) if cum.numel() else 0
    rows = torch.where(slot_valid[None, :total], rows_cm[:, :total], 0.0)
    exp = torch.zeros((c, total), dtype=torch.float64, device=rows.device)
    exp[:, entry_source[:total].to(torch.int64)] = rows.to(torch.float64)
    prefix = torch.cat([torch.zeros((c, 1), dtype=torch.float64,
                                    device=rows.device),
                        torch.cumsum(exp, 1)], dim=1)
    starts = torch.cat([cum.new_zeros(1), cum])
    return (prefix[:, starts[1:]] - prefix[:, starts[:-1]]).T.to(
        torch.float32)


def _segment_sum_rows_cuda(rows_cm, gauss_counts, entry_source, slot_valid):
    lib = _build.library()
    c, e_len = rows_cm.shape
    n = gauss_counts.shape[0]
    dev = rows_cm.device
    out = rows_cm.new_empty((n, c))
    # the kernel's workspace: the (L, C) f32 scratch in expansion order,
    # then the count scan's (N,) local sums, block totals and offsets
    nb = -(-n // SCAN_BLOCK)
    work = torch.empty(4 * (e_len * c + n + 2 * nb + 1), dtype=torch.uint8,
                       device=dev)
    err = lib.webdgs_segsum(
        rows_cm.data_ptr(), c, e_len, entry_source.data_ptr(),
        slot_valid.data_ptr(), e_len, gauss_counts.data_ptr(), n,
        work.data_ptr(), work.numel(), out.data_ptr(), dev.index,
        # the current stream's handle, without building a Stream object
        # (a few microseconds of host time per call)
        torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(err, "segment_sum_rows")
    trace.count("launches.segment_sum_rows")
    return out


def _segment_sum(rows_cm, gauss_counts, entry_source, slot_valid):
    if rows_cm.device.type == "cpu":
        return segment_sum_rows_plain(rows_cm, gauss_counts, entry_source,
                                      slot_valid)
    if rows_cm.device.type != "cuda":
        raise ValueError(f"unsupported device {rows_cm.device}")
    return _segment_sum_rows_cuda(rows_cm, gauss_counts, entry_source,
                                  slot_valid)


def segment_sum_rows(rows_cm: torch.Tensor, gauss_counts: torch.Tensor,
                     entry_source: torch.Tensor, slot_valid: torch.Tensor
                     ) -> torch.Tensor:
    """Per-Gaussian sums of sorted-slot rows: out[g, c] = sum, in expansion
    order over the indices k of Gaussian g, of ``rows_cm[c, s]`` for the
    slot s < total with ``entry_source[s] == k``, or 0 where
    ``slot_valid[s]`` is False.  total = sum(gauss_counts).

    rows_cm: (C, L) f32 channel-major rows in sorted-slot order;
    gauss_counts: (N,) i32; entry_source: (L,) i32 sorted slot ->
    expansion index, whose first ``total`` entries must be a permutation
    of [0, total); slot_valid: (L,) bool.  Returns (N, C) f32.  Raises
    when the total exceeds L or entry_source is not such a permutation
    (this check reads the device back).
    ``kernel_launches()["segment_sum_rows"]`` counts the CUDA kernel's
    launches.
    """
    _check_inputs(rows_cm, gauss_counts, entry_source, slot_valid)
    _check_values(gauss_counts, entry_source)
    return _segment_sum(rows_cm, gauss_counts, entry_source, slot_valid)


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

    The inputs come from ``bin_splats(..., with_source=True)``, which makes
    them what the kernel takes by construction: Gaussians that would
    overflow the capacity are dropped whole, so the count total is at most
    E; ``entry_source`` is the stable sort's permutation of [0, E), and
    its valid slots are the prefix below the total, holding the expansion
    indices [0, total).  So the value checks of :func:`segment_sum_rows`,
    which read the device back, are skipped here; the kernel still bounds
    every index it uses."""
    rows_cm = rows.T.contiguous()
    counts = gauss_counts.to(torch.int32)
    valid = entry_valid.contiguous()
    _check_inputs(rows_cm, counts, entry_source, valid)
    return _segment_sum(rows_cm, counts, entry_source, valid)
