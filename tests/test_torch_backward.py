"""PyTorch port vs the JAX reference: the rasterizer's VJP (backward
kernel, plain version on the CPU) and the per-Gaussian segment sum.

The rasterizer VJP is ``torch.autograd`` through ``rasterize_tiles``
against ``jax.vjp`` of the JAX ``rasterize_tiles`` (Pallas backward kernel
in interpret mode, f32-exact matmul tier), with random cotangents on all
8 channels, at normal opacity and at opacity +5 (the 0.99 clamp and the
saturation masks).  Rows 0-10 are compared scale-normalised at rtol 1e-3 /
atol 1e-4, the tolerance of tests/test_gradients.py:81-82; rows 11-15 must
be zero.  Segment sums: f32 rows, scale-normalised rtol 2e-5 (the JAX
kernel's bf16 hi/lo split carries about 2^-17 relative per row).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webdgs_tpu.ops import binning as jbin
from webdgs_tpu.ops import rasterize as jras
from webdgs_tpu.ops import segsum as jseg
from webdgs_tpu.ops.projection import project_gaussians as jproject
from webdgs_tpu_torch.ops import kernel_launches
from webdgs_tpu_torch.ops import rasterize as tras
from webdgs_tpu_torch.ops import segsum as tseg

from tests.torch_parity import (both_cameras, both_scenes, jax_settings, np_,
                                numpy_scene, t_, torch_settings)


def _frame(n, seed, w, h, opacity_shift=0.0):
    params = numpy_scene(n, seed=seed, opacity_shift=opacity_shift)
    js, _ = both_scenes(params)
    jc, _ = both_cameras(w, h)
    s = jax_settings()
    attrs, aux = jproject(js.params(), js.alive, jc, w, h, 0, s)
    bins = jbin.bin_splats(aux, w, h, s, attrs=attrs, with_source=False)
    a16 = jras.pack_entry_attrs(attrs, bins.entry_gauss, bins.entry_valid,
                                s)
    ntx, nty = jbin.tile_grid(w, h, s)
    return a16, bins, ntx, nty


def _assert_rows_close(got, want):
    got, want = np_(got), np.asarray(want)
    assert not got[11:].any(), "rows 11-15 must be zero"
    scale = max(np.abs(want[:11]).max(), 1.0)
    np.testing.assert_allclose(got[:11] / scale, want[:11] / scale,
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("opacity_shift", [0.0, 5.0])
def test_rasterize_vjp_matches_jax(opacity_shift):
    a16, bins, ntx, nty = _frame(80, 3, 48, 32, opacity_shift)
    sj, st = jax_settings(), torch_settings()
    rng = np.random.default_rng(0)
    g = rng.normal(0, 1, (ntx * nty, jras.NUM_OUT, st.tile_px)).astype(
        np.float32)

    out_j, vjp = jax.vjp(lambda a: jras.rasterize_tiles(
        a, bins.tile_offsets, ntx, nty, sj), a16)
    (want,) = vjp(jnp.asarray(g))

    a = t_(a16).requires_grad_(True)
    launches = kernel_launches()["rasterize_tiles_backward"]
    out_t = tras.rasterize_tiles(a, t_(bins.tile_offsets), ntx, nty, st)
    (got,) = torch.autograd.grad(out_t, a, t_(g))
    assert kernel_launches()["rasterize_tiles_backward"] == launches
    np.testing.assert_allclose(np_(out_t)[:, 0:5], np.asarray(out_j)[:, 0:5],
                               rtol=1e-4, atol=3e-4)
    _assert_rows_close(got, want)
    # slots past the entry total read 0
    total = int(bins.tile_offsets[-1])
    assert not np_(got)[:, total:].any()


def test_rasterize_vjp_ignores_ncontrib_cotangent():
    a16, bins, ntx, nty = _frame(60, 5, 48, 32)
    st = torch_settings()
    rng = np.random.default_rng(1)
    g = torch.tensor(rng.normal(0, 1, (ntx * nty, 8, st.tile_px)),
                     dtype=torch.float32)
    a = t_(a16).requires_grad_(True)
    out = tras.rasterize_tiles(a, t_(bins.tile_offsets), ntx, nty, st)
    (d1,) = torch.autograd.grad(out, a, g, retain_graph=True)
    g2 = g.clone()
    g2[:, tras.OUT_NCONTRIB:] = 0.0
    (d2,) = torch.autograd.grad(out, a, g2)
    torch.testing.assert_close(d1, d2, rtol=0, atol=0)


def _backward_inputs(seed):
    """A frame's packed entries and offsets (torch, CPU) and random pixel
    cotangents (T, 5, P)."""
    a16, bins, ntx, nty = _frame(80, 3, 48, 32)
    st = torch_settings()
    rng = np.random.default_rng(seed)
    gpix5 = torch.tensor(rng.normal(0, 1, (ntx * nty, tras.NUM_GPIX,
                                           st.tile_px)), dtype=torch.float32)
    return t_(a16), t_(bins.tile_offsets), gpix5, ntx, nty, st


@pytest.mark.parametrize("fault", ["past_end", "below_zero", "both"])
def test_backward_clamps_out_of_range_offsets(fault):
    """Tile ranges reaching outside [0, E] are clamped, as the kernel
    clamps them: the wrapper (plain on the CPU) gives what the plain
    version gives on the clamped offsets, bit for bit."""
    a16, off, gpix5, ntx, nty, st = _backward_inputs(2)
    e_len = a16.shape[1]
    bad = off.clone()
    if fault in ("past_end", "both"):
        bad[-2:] = torch.tensor([e_len + 5, 2 ** 30], dtype=torch.int32)
    if fault in ("below_zero", "both"):
        bad[0] = -7
    clamped = bad.clamp(0, e_len)
    assert not torch.equal(bad, clamped)
    want = tras.rasterize_tiles_backward_plain(a16, clamped, gpix5, ntx,
                                               nty, st)
    got = tras.rasterize_tiles_backward(a16, bad, gpix5, ntx, nty, st)
    assert got.shape == (16, e_len) and bool(torch.isfinite(got).all())
    assert float(want[0:9].abs().max()) > 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("wrapper", ["forward", "backward"])
def test_rasterize_backward_reads_nothing_back(monkeypatch, wrapper):
    """Neither raster wrapper reads the offsets (or anything else) back to
    the host: each kernel clamps its tile ranges itself.  Every host read
    of a tensor raises while the wrapper runs, except inside the plain
    version that stands in for the kernel on the CPU; the result is the
    plain version's, bit for bit."""
    a16, off, gpix5, ntx, nty, st = _backward_inputs(3)
    if wrapper == "forward":
        name, args = "rasterize_tiles_plain", (a16, off, ntx, nty, st)
        public = tras.rasterize_tiles
    else:
        name = "rasterize_tiles_backward_plain"
        args = (a16, off, gpix5, ntx, nty, st)
        public = tras.rasterize_tiles_backward
    plain = getattr(tras, name)
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
    monkeypatch.setattr(tras, name, unguarded_plain)
    got = public(*args)
    armed[0] = False
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the guard does catch a read
    armed[0] = True
    with pytest.raises(AssertionError, match="host read"):
        off.tolist()
    armed[0] = False


def _segments(n, e_cap, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 9, n).astype(np.int32)
    while counts.sum() > e_cap:
        counts[rng.integers(0, n)] = 0
    total = int(counts.sum())
    ids_real = np.repeat(np.arange(n, dtype=np.int32), counts)
    pad = ids_real[-1] if total else 0
    ids = np.concatenate([ids_real, np.full(e_cap - total, pad, np.int32)])
    return counts, ids, total, rng


def _assert_sums_close(got, want):
    got, want = np_(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("n,e_cap,cols,seed", [
    (100, 512, 16, 0), (700, 2048, 16, 1), (37, 256, 16, 2),
    (1201, 4096, 1, 3)])
def test_segment_sum_rows_matches_jax(n, e_cap, cols, seed):
    counts, ids, total, rng = _segments(n, e_cap, seed)
    rows = (rng.standard_normal((cols, e_cap)) * 8).astype(np.float32)
    rows[:, total:] = 0
    want = jseg.segment_sum_rows(jnp.asarray(rows), jnp.asarray(ids),
                                 jnp.asarray(counts))
    launches = kernel_launches()["segment_sum_rows"]
    # rows already in expansion order: the identity slot map
    got = tseg.segment_sum_rows(t_(rows), t_(counts),
                                torch.arange(e_cap, dtype=torch.int32),
                                torch.ones(e_cap, dtype=torch.bool))
    assert kernel_launches()["segment_sum_rows"] == launches  # CPU: plain
    assert got.shape == (n, cols) and got.dtype == torch.float32
    _assert_sums_close(got, want)


def test_segment_reduce_entries_matches_jax():
    """Rows in sorted-slot order, a random permutation as the sort's
    entry_source, invalid tail slots holding garbage that must be
    masked."""
    n, e_cap = 300, 1024
    counts, ids, total, rng = _segments(n, e_cap, 7)
    perm = rng.permutation(e_cap).astype(np.int32)  # slot -> expansion
    # valid sorted slots are those whose expansion index is < total
    order = np.argsort(perm >= total, kind="stable")
    perm = perm[order]
    valid = np.arange(e_cap) < total
    rows = rng.standard_normal((e_cap, 16)).astype(np.float32)
    rows[~valid] = 1e6  # masked garbage
    want = jras.segment_reduce_entries(
        e_cap, jnp.asarray(rows), jnp.asarray(valid), jnp.asarray(perm),
        jnp.asarray(counts), jax_settings(), jnp.asarray(ids))
    got = tseg.segment_reduce_entries(t_(rows), t_(valid), t_(perm),
                                      t_(counts))
    _assert_sums_close(got, want)
    # the exact per-Gaussian sums, by numpy
    exp_rows = np.zeros((e_cap, 16), np.float64)
    exp_rows[perm[valid]] = rows[valid]
    ref = np.zeros((n, 16))
    np.add.at(ref, ids[:total], exp_rows[:total])
    _assert_sums_close(got, ref.astype(np.float32))


def _binned(n, e_cap, cols, seed, long_seg):
    """Segment-sum inputs in the binning's layout: ragged counts (zeros
    included; Gaussian n // 2 holds ``long_seg`` entries when non-zero),
    rows in sorted-slot order with NaN garbage past the total, and an
    entry_source whose first ``total`` slots hold the expansion indices
    [0, total).  Also the expansion-order rows, ids and the inverse map."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 9, n).astype(np.int32)
    counts[n // 2] = long_seg or counts[n // 2]
    while counts.sum() > e_cap:
        counts[rng.integers(0, n)] = 0
    total = int(counts.sum())
    perm = rng.permutation(e_cap).astype(np.int32)
    perm = perm[np.argsort(perm >= total, kind="stable")]
    rows = (rng.standard_normal((cols, e_cap)) * 8).astype(np.float32)
    rows[:, total:] = np.nan
    valid = np.arange(e_cap) < total
    inv = np.argsort(perm).astype(np.int32)  # expansion index -> slot
    rows_exp = np.zeros_like(rows)
    rows_exp[:, :total] = rows[:, inv[:total]]
    ids = np.repeat(np.arange(n, dtype=np.int32), counts)
    ids = np.concatenate([ids, np.full(e_cap - total, ids[-1], np.int32)])
    return counts, perm, rows, valid, rows_exp, ids


@pytest.mark.parametrize("cols,long_seg", [(16, 0), (16, 320), (1, 0),
                                           (1, 400)])
def test_segment_sum_rows_sorted_slots_match_jax(cols, long_seg):
    """The plain version on sorted-slot rows (C = 16 and the importance
    counts' C = 1, ragged segments with zero counts, one long segment)
    against JAX's kernel on the same rows in expansion order."""
    counts, perm, rows, valid, rows_exp, ids = _binned(500, 4096, cols, 11,
                                                       long_seg)
    assert long_seg == 0 or counts.max() == long_seg
    assert (counts == 0).any()
    want = jseg.segment_sum_rows(jnp.asarray(rows_exp), jnp.asarray(ids),
                                 jnp.asarray(counts))
    got = tseg.segment_sum_rows(t_(rows), t_(counts), t_(perm), t_(valid))
    assert got.shape == (500, cols) and bool(torch.isfinite(got).all())
    _assert_sums_close(got, want)


@pytest.mark.parametrize("cols", [16, 1])
def test_segment_reduce_entries_long_segment_matches_jax(cols):
    counts, perm, rows, valid, _, ids = _binned(300, 2048, cols, 12, 310)
    rows_ec = rows.T.copy()  # (E, C), the rasterizer's cotangent layout
    want = jras.segment_reduce_entries(
        2048, jnp.asarray(np.nan_to_num(rows_ec)), jnp.asarray(valid),
        jnp.asarray(perm), jnp.asarray(counts), jax_settings(),
        jnp.asarray(ids))
    got = tseg.segment_reduce_entries(t_(rows_ec), t_(valid), t_(perm),
                                      t_(counts))
    assert got.shape == (300, cols) and bool(torch.isfinite(got).all())
    _assert_sums_close(got, want)


def test_segment_sum_rows_flag_zero_in_prefix_adds_nothing():
    counts, perm, rows, valid, rows_exp, ids = _binned(200, 1024, 16, 13, 0)
    total = int(counts.sum())
    valid[[0, 5, total - 1]] = False
    rows_exp[:, perm[[0, 5, total - 1]]] = 0.0
    ref = np.zeros((200, 16))
    np.add.at(ref, ids[:total], rows_exp[:, :total].T.astype(np.float64))
    got = tseg.segment_sum_rows(t_(rows), t_(counts), t_(perm), t_(valid))
    _assert_sums_close(got, ref.astype(np.float32))


@pytest.mark.parametrize("fault", ["past_total", "negative", "duplicate",
                                   "total_exceeds_slots"])
def test_segment_sum_rows_raises_on_bad_values(fault):
    """What the kernel cannot take raises before any launch, on the CPU as
    on the card."""
    counts, perm, rows, valid, _, _ = _binned(100, 512, 16, 14, 0)
    total = int(counts.sum())
    if fault == "past_total":
        perm[3] = total + 2
    elif fault == "negative":
        perm[3] = -1
    elif fault == "duplicate":
        perm[3] = perm[4]
    else:
        counts[0] += 512
    with pytest.raises(ValueError):
        tseg.segment_sum_rows(t_(rows), t_(counts), t_(perm), t_(valid))


@pytest.mark.parametrize("fault", ["dtype", "length", "strides"])
def test_segment_sum_rows_raises_on_bad_layout(fault):
    counts, perm, rows, valid, _, _ = _binned(100, 512, 16, 15, 0)
    rows_t, perm_t = t_(rows), t_(perm)
    if fault == "dtype":
        rows_t = rows_t.double()
    elif fault == "length":
        perm_t = perm_t[:-1]
    else:
        rows_t = t_(rows.T.copy()).T
    with pytest.raises((TypeError, ValueError)):
        tseg.segment_sum_rows(rows_t, t_(counts), perm_t, t_(valid))


def test_segment_reduce_entries_skips_the_value_checks(monkeypatch):
    """The training and densify paths read nothing back: their binning
    inputs are in bounds by construction, so segment_reduce_entries never
    runs the checks that read the device (segment_sum_rows does)."""
    counts, perm, rows, valid, _, _ = _binned(150, 1024, 16, 16, 0)
    want = tseg.segment_sum_rows(t_(rows), t_(counts), t_(perm), t_(valid))

    def read_back(*args):
        raise AssertionError("value check ran")

    monkeypatch.setattr(tseg, "_check_values", read_back)
    got = tseg.segment_reduce_entries(t_(rows).T, t_(valid), t_(perm),
                                      t_(counts))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(AssertionError, match="value check ran"):
        tseg.segment_sum_rows(t_(rows), t_(counts), t_(perm), t_(valid))


def test_inverse_permutation():
    perm = torch.tensor(np.random.default_rng(4).permutation(97),
                        dtype=torch.int32)
    inv = tseg.inverse_permutation(perm)
    assert torch.equal(perm[inv.long()], torch.arange(97, dtype=torch.int32))


def test_pack_gradient_is_segment_sum():
    """The fields' gradient through the entry index (``entry_grads``, the
    segment sum) equals autograd of the plain gather."""
    from webdgs_tpu_torch.ops.projection import SplatAttrs
    rng = np.random.default_rng(6)
    n, e_cap = 40, 256
    counts, ids, total, _ = _segments(n, e_cap, 6)
    perm = torch.tensor(rng.permutation(e_cap).astype(np.int32))
    perm = perm[torch.argsort((perm >= total).to(torch.int8), stable=True)]
    entry_gauss = torch.tensor(ids)[perm.long()]
    valid = torch.arange(e_cap) < total

    def leaves():
        return SplatAttrs(*(torch.tensor(rng.normal(0, 1, s),
                                         dtype=torch.float32,
                                         requires_grad=True)
                            for s in [(n, 2), (n, 3), (n, 3), (n,),
                                      (n, 2)]))

    a = leaves()
    b = SplatAttrs(*(x.detach().clone().requires_grad_(True) for x in a))
    g = torch.tensor(rng.normal(0, 1, (16, e_cap)), dtype=torch.float32)
    entries = tras.EntryAttrs(a, entry_gauss, valid, perm,
                              torch.tensor(counts))
    out_b = tras.pack_entry_attrs(b, entry_gauss, valid)
    torch.testing.assert_close(tras.packed_rows(entries), out_b, rtol=0,
                               atol=0)
    ga = tras.entry_grads(entries, g)
    gb = torch.autograd.grad(out_b, list(b), g)
    for x, y in zip(ga, gb):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-5)
