"""PyTorch port vs the JAX reference: the ragged expansion
(``expand_fields``, plain version on the CPU), the binning bit tricks, and
``expand_entries``/``bin_splats`` with the tile cull on and off.

The integer outputs are compared exactly.  Both binners are fed the SAME
projected attrs/aux (JAX's, converted), because the cull's conservative
margins sit at the rounding edge of exp/log, which torch and XLA round
independently.  Slots past the real entry total are don't-care in the
reference, so entry-level ids are compared on valid slots only."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from webdgs_tpu.ops import binning as jbin
from webdgs_tpu.ops.expand import expand_fields as jexpand
from webdgs_tpu.ops.projection import SplatAttrs as JAttrs
from webdgs_tpu.ops.projection import SplatAux as JAux
from webdgs_tpu.ops.projection import project_gaussians as jproject
from webdgs_tpu_torch.ops import binning as tbin
from webdgs_tpu_torch.ops import kernel_launches
from webdgs_tpu_torch.ops.expand import NWORDS, expand_fields

from tests.torch_cases import (CULL_CASES, EXPAND_CASES, crafted_cull_case,
                               crafted_expand_case, cull_inputs)
from tests.torch_parity import (aux_to_torch, attrs_to_torch, both_cameras,
                                both_scenes, jax_settings, np_,
                                numpy_scene, torch_settings)


@pytest.mark.parametrize("n,e_cap,seed", [
    (100, 512, 0),
    (700, 2048, 1),
    (1300, 4096, 2),
    (40, 512, 3),
])
def test_expand_fields_plain_matches_jax(n, e_cap, seed):
    """The four cases of tests/test_expand.py."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 9, n).astype(np.int32)
    while counts.sum() > e_cap:
        counts[rng.integers(0, n)] = 0
    total = int(counts.sum())
    words = rng.integers(-2**31, 2**31 - 1, (NWORDS, n),
                         dtype=np.int64).astype(np.int32)
    jw, jids = jexpand(jnp.asarray(words), jnp.asarray(counts), e_cap)
    launches = kernel_launches()["expand_fields"]
    tw, tids = expand_fields(torch.tensor(words), torch.tensor(counts),
                             e_cap)
    assert kernel_launches()["expand_fields"] == launches  # CPU: plain version
    assert tw.shape == (NWORDS, e_cap) and tids.shape == (e_cap,)
    assert tw.dtype == tids.dtype == torch.int32
    np.testing.assert_array_equal(np_(tids)[:total],
                                  np.asarray(jids)[:total])
    np.testing.assert_array_equal(np_(tw)[:, :total],
                                  np.asarray(jw)[:, :total])
    # the port defines the slots past the total: id 0, words 0
    assert not np_(tids)[total:].any() and not np_(tw)[:, total:].any()


@pytest.mark.parametrize("case", EXPAND_CASES)
def test_expand_fields_crafted_cases_match_jax(case):
    """The crafted cases of tests/test_torch_cuda.py (a run of 5,000
    zero-count Gaussians, one Gaussian of 5,000 entries, total == e_cap,
    every count 0, N = 1, trailing zero counts, an e_cap that is not a
    multiple of 4) through the JAX kernel (interpret mode) and the port:
    valid slots equal, the port's zeros past the total."""
    words, counts, e_cap = crafted_expand_case(case, seed=30)
    total = min(int(counts.sum()), e_cap)
    jw, jids = jexpand(jnp.asarray(words), jnp.asarray(counts), e_cap)
    tw, tids = expand_fields(torch.tensor(words), torch.tensor(counts),
                             e_cap)
    assert tw.shape == (NWORDS, e_cap) and tids.shape == (e_cap,)
    np.testing.assert_array_equal(np_(tids)[:total],
                                  np.asarray(jids)[:total])
    np.testing.assert_array_equal(np_(tw)[:, :total],
                                  np.asarray(jw)[:, :total])
    assert not np_(tids)[total:].any() and not np_(tw)[:, total:].any()


def test_expand_fields_checks_inputs():
    w = torch.zeros((NWORDS, 4), dtype=torch.int32)
    c = torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        expand_fields(w[:4], c, 8)
    with pytest.raises(TypeError):
        expand_fields(w, c.to(torch.int64), 8)
    with pytest.raises(ValueError):
        expand_fields(w, c[:3], 8)
    with pytest.raises(ValueError):
        expand_fields(w.T.contiguous().T, c, 8)
    with pytest.raises(ValueError):
        expand_fields(w, c, 0)


def test_bit_tricks_match_jax():
    rng = np.random.default_rng(9)
    depth = np.concatenate([rng.normal(0, 30, 500),
                            [0.0, -0.0, 1e-30, -1e30, 5.0]]).astype(
                                np.float32)
    np.testing.assert_array_equal(
        np_(tbin._ordered_depth16(torch.tensor(depth))),
        np.asarray(jbin._ordered_depth16(jnp.asarray(depth))).astype(
            np.int64))

    lo = rng.integers(0, 2**32, 300, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 2**32, 300, dtype=np.uint64).astype(np.uint32)
    lo[:3], hi[:3] = 0xFFFFFFFF, 0xFFFFFFFF
    pop = np.array([bin(int(a)).count("1") + bin(int(b)).count("1")
                    for a, b in zip(lo, hi)])
    s = (rng.uniform(size=300) * pop).astype(np.int32)
    tlo = torch.tensor(lo.astype(np.int64))
    thi = torch.tensor(hi.astype(np.int64))
    np.testing.assert_array_equal(
        np_(tbin._popcount32(tlo) + tbin._popcount32(thi)), pop)
    want = jbin._select_nth_set_bit(jnp.asarray(lo), jnp.asarray(hi),
                                    jnp.asarray(s))
    got = tbin._select_nth_set_bit(tlo, thi, torch.tensor(s))
    np.testing.assert_array_equal(np_(got), np.asarray(want))

    for v in (0, 1, 2**31 - 1, 2**31, 2**32 - 1):
        x = torch.tensor([v], dtype=torch.int64)
        assert int(tbin._to_u32(tbin._to_i32(x))) == v


def _projected(n, seed, w, h):
    params = numpy_scene(n, seed=seed, opacity_shift=2.0)
    js, _ = both_scenes(params)
    jc, _ = both_cameras(w, h)
    ja, jx = jproject(js.params(), js.alive, jc, w, h, 0, jax_settings())
    return ja, jx


@pytest.mark.parametrize("cull", [True, False])
def test_expand_entries_matches_jax(cull):
    w = h = 96
    ja, jx = _projected(300, 5, w, h)
    ntx = -(-w // 32)
    e_cap = 2048
    want = jbin.expand_entries(jx, ntx, e_cap, attrs=ja,
                               settings=jax_settings(tile_cull=cull))
    got = tbin.expand_entries(aux_to_torch(jx), ntx, e_cap,
                              attrs=attrs_to_torch(ja),
                              settings=torch_settings(tile_cull=cull))
    key_j, g_j, counts_j, total_j, keep_j, demand_j = want
    key_t, g_t, counts_t, total_t, keep_t, demand_t = got
    total = int(total_j)
    assert total == int(total_t) > 0
    assert int(demand_t) == int(demand_j)
    np.testing.assert_array_equal(np_(counts_t), np.asarray(counts_j))
    np.testing.assert_array_equal(np_(keep_t), np.asarray(keep_j))
    np.testing.assert_array_equal(np_(key_t),
                                  np.asarray(key_j).astype(np.int64))
    np.testing.assert_array_equal(np_(g_t)[:total], np.asarray(g_j)[:total])


@pytest.mark.parametrize("cull,capacity,with_source", [
    (True, None, False),
    (False, None, True),
    (True, 512, True),    # tight capacity: whole-Gaussian drops
    (False, 512, False),
])
def test_bin_splats_matches_jax(cull, capacity, with_source):
    w, h = 96, 80
    ja, jx = _projected(300, 21, w, h)
    js = jax_settings(tile_cull=cull)
    ts = torch_settings(tile_cull=cull)
    jb = jbin.bin_splats(jx, w, h, js, capacity=capacity,
                         with_source=with_source, attrs=ja)
    tb = tbin.bin_splats(aux_to_torch(jx), w, h, ts, capacity=capacity,
                         with_source=with_source, attrs=attrs_to_torch(ja))
    assert tb.capacity == jb.capacity
    total = int(jb.total_entries)
    assert int(tb.total_entries) == total > 0
    if capacity is not None:
        assert int(jb.expansion_entries) > capacity  # drops happened
    assert int(tb.expansion_entries) == int(jb.expansion_entries)
    for name in ("tile_offsets", "tile_counts", "entry_valid"):
        np.testing.assert_array_equal(np_(getattr(tb, name)),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)
    assert tb.tile_offsets.dtype == torch.int32
    np.testing.assert_array_equal(np_(tb.entry_gauss)[:total],
                                  np.asarray(jb.entry_gauss)[:total])
    if with_source:
        np.testing.assert_array_equal(np_(tb.gauss_counts),
                                      np.asarray(jb.gauss_counts))
        np.testing.assert_array_equal(np_(tb.expansion_gauss)[:total],
                                      np.asarray(jb.expansion_gauss)[:total])
        np.testing.assert_array_equal(np_(tb.entry_source)[:total],
                                      np.asarray(jb.entry_source)[:total])
    else:
        assert tb.entry_source is None and tb.gauss_counts is None


def test_capacity_and_tile_key_limit_match_jax():
    for n in (0, 1, 1000, 10**7):
        assert tbin.entry_capacity(n, torch_settings()) == \
            jbin.entry_capacity(n, jax_settings())
    assert tbin.tile_grid(800, 600, torch_settings()) == (25, 38)
    assert tbin.TILE_KEY_LIMIT == jbin.TILE_KEY_LIMIT
    tbin.check_tile_key_limit(tbin.TILE_KEY_LIMIT - 1)
    with pytest.raises(ValueError):
        tbin.check_tile_key_limit(tbin.TILE_KEY_LIMIT)


def _jax_cull_inputs(attrs: dict, aux: dict):
    n = aux["num_tiles"].shape[0]
    return (JAttrs(center_px=jnp.asarray(attrs["center_px"]),
                   conic=jnp.asarray(attrs["conic"]),
                   color=jnp.zeros((n, 3), jnp.float32),
                   opacity=jnp.asarray(attrs["opacity"]),
                   extents=jnp.asarray(attrs["extents"])),
            JAux(depth=jnp.asarray(aux["depth"]),
                 visible=jnp.asarray(aux["num_tiles"] > 0),
                 tile_min=jnp.asarray(aux["tile_min"]),
                 tile_dims=jnp.asarray(aux["tile_dims"]),
                 num_tiles=jnp.asarray(aux["num_tiles"]),
                 radius_capped=jnp.zeros((n,), bool)))


@pytest.mark.parametrize("case", [c for c in CULL_CASES if c != "edge"])
def test_cull_crafted_cases_match_jax(case):
    """The crafted tile-cull cases of tests/test_torch_cuda.py (rects of
    0 to 2,048 positions; non-convex, degenerate, NaN and infinite conics;
    opacities at and below alpha_min, 0, NaN; depths of both signs and
    the specials; NaN and infinite centres and extents; an e_cap that
    drops Gaussians whole; 90 % dead slots) through the plain chains and
    JAX: survivor masks, counts and every expand_entries output equal."""
    attrs, aux, ntx, e_cap = crafted_cull_case(case, seed=40)
    ta, tx = cull_inputs(attrs, aux, "cpu")
    ja, jx = _jax_cull_inputs(attrs, aux)
    words, counts = tbin.cull_words(tx, ta, torch_settings(), ntx)
    lo, hi, jcounts = jbin._cull_bitmask(jx, ja, jax_settings())
    np.testing.assert_array_equal(np_(words[3]), np.asarray(lo))
    np.testing.assert_array_equal(np_(words[4]), np.asarray(hi))
    np.testing.assert_array_equal(np_(counts), np.asarray(jcounts))
    got = tbin.expand_entries(tx, ntx, e_cap, attrs=ta,
                              settings=torch_settings())
    want = jbin.expand_entries(jx, ntx, e_cap, attrs=ja,
                               settings=jax_settings())
    total = int(want[3])
    assert int(got[3]) == total > 0
    assert int(got[5]) == int(want[5])
    if case == "drop":
        assert int(want[5]) > e_cap  # Gaussians dropped whole
    np.testing.assert_array_equal(np_(got[0]),
                                  np.asarray(want[0]).astype(np.int64))
    np.testing.assert_array_equal(np_(got[1])[:total],
                                  np.asarray(want[1])[:total])
    for g, w in zip(got[2:5:2], want[2:5:2]):
        np.testing.assert_array_equal(np_(g), np.asarray(w))


@pytest.mark.parametrize("case", CULL_CASES)
def test_cull_wrappers_take_the_plain_chains_on_cpu(case):
    """On CPU tensors cull_words and entry_keys run their plain versions
    and launch nothing."""
    attrs, aux, ntx, e_cap = crafted_cull_case(case, seed=41)
    ta, tx = cull_inputs(attrs, aux, "cpu")
    s = torch_settings()
    before = kernel_launches()
    words, counts = tbin.cull_words(tx, ta, s, ntx)
    pw, pc = tbin.cull_words_plain(tx, ta, s, ntx)
    assert words.dtype == counts.dtype == torch.int32
    assert words.shape == (NWORDS, counts.shape[0])
    assert torch.equal(words, pw) and torch.equal(counts, pc)
    assert not words[1].any()  # the offsets row is the caller's
    ws, c, _, _ = tbin.expansion_inputs(tx, ntx, e_cap, ta, s)
    ew, _ = expand_fields(ws, c, e_cap)
    total = c.sum(dtype=torch.int64)
    keys = tbin.entry_keys(ew, total, ntx)
    assert keys.dtype == torch.int64 and keys.shape == (e_cap,)
    assert torch.equal(keys, tbin.entry_keys_plain(ew, total, ntx))
    assert (keys[int(total):] == tbin.SENTINEL_KEY).all()
    assert (keys[:int(total)] < tbin.SENTINEL_KEY).all()
    assert kernel_launches() == before


def test_cull_wrappers_check_inputs():
    attrs, aux, ntx, e_cap = crafted_cull_case("rect_sizes", seed=42)
    ta, tx = cull_inputs(attrs, aux, "cpu")
    s = torch_settings()
    with pytest.raises(TypeError):
        tbin.cull_words(tx._replace(num_tiles=tx.num_tiles.long()), ta, s,
                        ntx)
    with pytest.raises(TypeError):
        tbin.cull_words(tx, ta._replace(conic=ta.conic.double()), s, ntx)
    with pytest.raises(ValueError):
        tbin.cull_words(tx, ta._replace(opacity=ta.opacity[:-1]), s, ntx)
    ew = torch.zeros((NWORDS, 64), dtype=torch.int32)
    total = torch.tensor(3, dtype=torch.int64)
    with pytest.raises(ValueError):
        tbin.entry_keys(ew[:4], total, ntx)
    with pytest.raises(TypeError):
        tbin.entry_keys(ew.long(), total, ntx)
    with pytest.raises(TypeError):
        tbin.entry_keys(ew, total.int(), ntx)
    with pytest.raises(TypeError):
        tbin.entry_keys(ew.T.contiguous().T, total, ntx)
