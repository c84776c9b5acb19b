"""Ragged per-Gaussian expansion: counts -> per-entry ids + binning words
(counterpart of webdgs_tpu/ops/expand.py:144-208).

``expand_fields`` is the wrapper of CUDA kernel ``csrc/expand.cu`` (a CTA
per span of 1,024 slots: the span's owner window of the count cumsum,
found by a warp-wide search, staged in shared memory; 16-byte stores).
The cumsum is ``torch.cumsum``, launched here.  On a CPU tensor it runs
:func:`expand_fields_plain`, the same function as a ``repeat_interleave``
plus a gather; on a CUDA tensor it launches the kernel or raises.  Unlike
the TPU kernel, whose slots past the real total are unwritten, both
versions define them: id 0 and words 0.
"""

from __future__ import annotations

import torch

from webdgs_tpu_torch import _build, trace

NWORDS = 5  # per-Gaussian binning words selected per entry


def _check_inputs(word_stack: torch.Tensor, gauss_counts: torch.Tensor,
                  e_cap: int) -> None:
    if word_stack.dim() != 2 or word_stack.shape[0] != NWORDS:
        raise ValueError(f"word_stack must be ({NWORDS}, N), got "
                         f"{tuple(word_stack.shape)}")
    n = word_stack.shape[1]
    if gauss_counts.shape != (n,):
        raise ValueError(f"gauss_counts must be ({n},), got "
                         f"{tuple(gauss_counts.shape)}")
    for name, t in (("word_stack", word_stack),
                    ("gauss_counts", gauss_counts)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if word_stack.device != gauss_counts.device:
        raise ValueError("word_stack and gauss_counts are on different "
                         "devices")
    if e_cap <= 0:
        raise ValueError(f"e_cap must be positive, got {e_cap}")


def expand_fields_plain(word_stack: torch.Tensor, gauss_counts: torch.Tensor,
                        e_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel: (words (5, E) i32, ids (E,) i32),
    zeros past the total."""
    n = word_stack.shape[1]
    dev = word_stack.device
    ids = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=dev),
        gauss_counts.to(torch.int64))[:e_cap]
    m = ids.shape[0]
    out_ids = torch.zeros((e_cap,), dtype=torch.int32, device=dev)
    out_ids[:m] = ids
    out_words = torch.zeros((NWORDS, e_cap), dtype=torch.int32, device=dev)
    out_words[:, :m] = word_stack[:, ids.to(torch.int64)]
    return out_words, out_ids


def _expand_fields_cuda(word_stack, gauss_counts, e_cap):
    lib = _build.library()
    n = word_stack.shape[1]
    dev = word_stack.device
    out_words = torch.empty((NWORDS, e_cap), dtype=torch.int32, device=dev)
    out_ids = torch.empty((e_cap,), dtype=torch.int32, device=dev)
    if n == 0:
        out_words.zero_()
        out_ids.zero_()
        return out_words, out_ids
    cum_incl = torch.cumsum(gauss_counts, 0, dtype=torch.int32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.webdgs_expand_fields(
            word_stack.data_ptr(), cum_incl.data_ptr(), n, e_cap,
            out_words.data_ptr(), out_ids.data_ptr(), stream)
    _build.check(err, "expand_fields")
    trace.count("launches.expand_fields")
    return out_words, out_ids


def expand_fields(word_stack: torch.Tensor, gauss_counts: torch.Tensor,
                  e_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand per-Gaussian words into per-entry words + Gaussian ids.

    word_stack: (5, N) i32 per-Gaussian binning words; gauss_counts: (N,)
    i32 entries per Gaussian (post-drop, summing to at most ``e_cap``).
    Returns (words (5, E) i32, ids (E,) i32): per-entry words and monotone
    Gaussian ids in expansion order; slots past the total hold zeros.
    ``kernel_launches()["expand_fields"]`` counts the CUDA kernel's
    launches."""
    _check_inputs(word_stack, gauss_counts, e_cap)
    if word_stack.device.type == "cpu":
        return expand_fields_plain(word_stack, gauss_counts, e_cap)
    if word_stack.device.type != "cuda":
        raise ValueError(f"unsupported device {word_stack.device}")
    return _expand_fields_cuda(word_stack, gauss_counts, e_cap)
