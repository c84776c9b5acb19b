"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips (the kernels
have no interpret mode).  The file imports no jax (the card's machine need
not have it), so on a machine with an H100 it runs without the suite's
conftest:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from webdgs_tpu_torch.config import RenderSettings
from webdgs_tpu_torch.core.camera import (CameraData, default_camera,
                                          make_camera)
from webdgs_tpu_torch.core.scene import scene_from_arrays
from webdgs_tpu_torch.ops import kernel_launches
from webdgs_tpu_torch.ops import binning as tbin
from webdgs_tpu_torch.ops import rasterize as tras
from webdgs_tpu_torch.ops.binning import bin_splats
from webdgs_tpu_torch.ops.expand import (NWORDS, expand_fields,
                                         expand_fields_plain)
from webdgs_tpu_torch.ops.projection import project_gaussians
from webdgs_tpu_torch.render.renderer import render

# tests/ is on the path (pytest's rootdir-less import mode); a machine may
# also have an unrelated top-level package named "tests"
from torch_cases import (BAND_FRAME, BAND_SPLITS, CULL_CASES, EXPAND_CASES,
                         aligned_entries, band_loss_frame,
                         crafted_cull_case, crafted_expand_case, cull_inputs,
                         split_bands)

pytestmark = pytest.mark.cuda


def _scene(n, seed, spread=1.0, sh_deg=0):
    rng = np.random.default_rng(seed)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    sh = rng.normal(0, 0.3, (n, 16, 3)).astype(np.float32)
    sh[:, 0, :] += 0.8
    return scene_from_arrays(
        rng.normal(0, spread, (n, 3)).astype(np.float32), quats=quats,
        log_scales=rng.uniform(-3.5, -1.5, (n, 3)).astype(np.float32),
        opacity_logits=rng.uniform(-1.0, 3.0, (n,)).astype(np.float32),
        sh=sh, sh_deg=sh_deg, device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("n,e_cap,seed", [(100, 512, 0), (1300, 4096, 2),
                                          (100_000, 1_200_000, 3)])
def test_expand_kernel_matches_plain(cuda, n, e_cap, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 9, n).astype(np.int32)
    while counts.sum() > e_cap:
        counts[rng.integers(0, n)] = 0
    words = torch.tensor(rng.integers(-2**31, 2**31 - 1, (NWORDS, n),
                                      dtype=np.int64).astype(np.int32))
    counts = torch.tensor(counts)
    launches = kernel_launches()["expand_fields"]
    got = expand_fields(words.to(cuda), counts.to(cuda), e_cap)
    torch.cuda.synchronize()
    assert kernel_launches()["expand_fields"] == launches + 1
    want = expand_fields_plain(words, counts, e_cap)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("case", EXPAND_CASES)
def test_expand_kernel_crafted_cases(cuda, case):
    """Every slot of the kernel equal to the plain version on the crafted
    cases, bit-identical on repeat."""
    words, counts, e_cap = (torch.tensor(x) if isinstance(x, np.ndarray)
                            else x for x in crafted_expand_case(case, 31))
    launches = kernel_launches()["expand_fields"]
    k1 = expand_fields(words.to(cuda), counts.to(cuda), e_cap)
    k2 = expand_fields(words.to(cuda), counts.to(cuda), e_cap)
    torch.cuda.synchronize()
    assert kernel_launches()["expand_fields"] == launches + 2
    want = expand_fields_plain(words, counts, e_cap)
    for a, b, w in zip(k1, k2, want):
        assert torch.equal(a, b)
        assert torch.equal(a.cpu(), w)


def _check_cull_kernels(attrs, aux, settings, ntx, e_cap):
    """Both tile-cull kernels against their plain chains on the same CUDA
    tensors, every value equal, and a repeat bit-identical; the expansion
    of the words is expand_entries'.  Returns (demand, total)."""
    launches = kernel_launches()
    words, counts = tbin.cull_words(aux, attrs, settings, ntx)
    words2, counts2 = tbin.cull_words(aux, attrs, settings, ntx)
    pw, pc = tbin.cull_words_plain(aux, attrs, settings, ntx)
    torch.cuda.synchronize()
    assert torch.equal(words, words2) and torch.equal(counts, counts2)
    for row in range(NWORDS):
        diff = int((words[row] != pw[row]).sum())
        assert diff == 0, f"cull_words row {row}: {diff} slots differ"
    assert torch.equal(counts, pc), int((counts != pc).sum())
    ws, c, _, demand = tbin.expansion_inputs(aux, ntx, e_cap, attrs,
                                             settings)
    ew, _ = expand_fields(ws, c, e_cap)
    total = c.sum(dtype=torch.int64)
    keys = tbin.entry_keys(ew, total, ntx)
    keys2 = tbin.entry_keys(ew, total, ntx)
    plain = tbin.entry_keys_plain(ew, total, ntx)
    torch.cuda.synchronize()
    assert torch.equal(keys, keys2)
    diff = int((keys != plain).sum())
    assert diff == 0, f"entry_keys: {diff} of {e_cap} slots differ"
    after = kernel_launches()
    assert after["cull_words"] == launches["cull_words"] + 3
    assert after["entry_keys"] == launches["entry_keys"] + 2
    return int(demand), int(total)


@pytest.mark.parametrize("case", CULL_CASES)
def test_tile_cull_kernels_crafted_cases(cuda, case):
    """cull_words and entry_keys equal to the plain chains on the crafted
    cases of tests/torch_cases.py: rects of 0 to 2,048 positions,
    non-convex, degenerate, NaN and infinite conics, opacities at and
    below alpha_min, special depths of both signs, NaN and infinite
    geometry, an e_cap that drops Gaussians whole, 90 % dead slots, and
    20,000 opacities within 3 ulps of the cull threshold."""
    attrs, aux, ntx, e_cap = crafted_cull_case(case, seed=43)
    ta, tx = cull_inputs(attrs, aux, cuda)
    demand, total = _check_cull_kernels(ta, tx, RenderSettings(), ntx,
                                        e_cap)
    assert total > 0
    if case == "drop":
        assert demand > e_cap


def _bench_config_draw(name: str, n: int, seed: int, device):
    """A seeded draw of n Gaussians of a benchmark configuration
    (portbench/configs, portbench/scenes.py) seen from one of its ring
    views at the configuration's view size, with 37 % dead slots (a
    trainer's capacity past its alive rows): (attrs, aux, settings, w,
    h)."""
    root = Path(__file__).resolve().parents[1] / "portbench"
    spec = importlib.util.spec_from_file_location("bench_scenes",
                                                  root / "scenes.py")
    scenes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(scenes)
    cfg = json.loads((root / "configs" / f"{name}.json").read_text())
    cfg["gaussians"] = n
    w, h = cfg["width"], cfg["height"]
    params = scenes.make_scene(cfg, seed, device)
    pos, rot = scenes.ring_poses(cfg, seed, 1)[0]
    focal = 0.5 * h / math.tan(math.radians(cfg["fov_y_deg"]) / 2)
    cam = make_camera(CameraData(position=pos.astype(np.float32),
                                 rotation=rot.astype(np.float32), fy=focal,
                                 width=w, height=h), w, h, device=device)
    render = dict(cfg["render"], background=tuple(
        cfg["render"]["background"]))
    settings = RenderSettings(**render)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    alive = torch.rand((n,), generator=g, device=device) >= 0.37
    with torch.no_grad():
        attrs, aux = project_gaussians(params, alive, cam, w, h,
                                       cfg["sh_degree"], settings)
    return attrs, aux, settings, w, h


@pytest.mark.parametrize("config", ["tandt-1.66m-sh3", "mip360-2.96m-sh3"])
def test_tile_cull_kernels_bench_scene_draws(cuda, config):
    """Both kernels equal to the plain chains on a 200k-slot draw of each
    benchmark configuration at its view size: at the heuristic capacity
    (most entry slots past the total), at 1.2x the demand (the trainer's)
    and at 0.9x (Gaussians dropped whole)."""
    attrs, aux, s, w, h = _bench_config_draw(config, 200_000, 2**31 + 7,
                                             cuda)
    ntx, _ = tbin.tile_grid(w, h, s)
    demand, _ = _check_cull_kernels(attrs, aux, s, ntx,
                                    tbin.entry_capacity(200_000, s))
    assert demand > 100_000
    for share in (1.2, 0.9):
        _check_cull_kernels(attrs, aux, s, ntx, int(demand * share))


def test_bin_splats_launches_each_cull_kernel_once(cuda, monkeypatch):
    """bin_splats on the card launches cull_words and entry_keys once each
    and bins exactly as with the plain chains, in sync debug mode "error"
    (no host read)."""
    attrs, aux, s, w, h = _bench_config_draw("tandt-1.66m-sh3", 50_000, 3,
                                             cuda)
    launches = kernel_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = bin_splats(aux, w, h, s, attrs=attrs, with_source=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = kernel_launches()
    assert {k: after[k] - launches[k] for k in after} == {
        **dict.fromkeys(after, 0), "cull_words": 1, "entry_keys": 1,
        "expand_fields": 1}
    monkeypatch.setattr(tbin, "cull_words", tbin.cull_words_plain)
    monkeypatch.setattr(tbin, "entry_keys", tbin.entry_keys_plain)
    want = bin_splats(aux, w, h, s, attrs=attrs, with_source=True)
    assert kernel_launches()["cull_words"] == after["cull_words"]
    assert int(got.total_entries) == int(want.total_entries) > 0
    for name in ("entry_gauss", "entry_valid", "tile_offsets",
                 "tile_counts", "entry_source", "gauss_counts",
                 "expansion_gauss", "expansion_entries"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_expand_runs_without_host_sync(cuda):
    """expand_fields on CUDA tensors waits for the device nowhere: in sync
    debug mode "error" any synchronizing call raises."""
    words, counts, e_cap = crafted_expand_case("zero_run", seed=32)
    w, c = torch.tensor(words).to(cuda), torch.tensor(counts).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = expand_fields(w, c, e_cap)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g, p in zip(got, expand_fields_plain(w, c, e_cap)):
        assert torch.equal(g, p)


@pytest.mark.parametrize("n,w,h,shift,case", [
    (300, 96, 80, 0.0, "plain"), (20_000, 640, 480, 0.0, "plain"),
    # ranges of several chunks whose counts are multiples of neither 4
    # nor the chunk (faint splats: few pixels saturate)
    (20_000, 96, 80, -3.0, "multichunk"),
    # every range starts 3 slots later: no tile is 16-byte aligned
    (5000, 320, 240, 0.0, "unaligned"),
    # nearly opaque and dense: whole warps saturate within a few entries
    (20_000, 96, 80, 6.0, "plain"),
    # offsets reaching past E (and one below 0): clamped, no fault
    (5000, 320, 240, 0.0, "past_end")])
def test_rasterize_kernel_matches_plain(cuda, n, w, h, shift, case):
    s = RenderSettings()
    ts = _scene(n, seed=7, spread=2.0)
    ts.opacity_logits += shift
    ts = ts.to(cuda)
    cam = default_camera(w, h, position=(0.0, 0.0, -6.0), device=cuda)
    attrs, aux = project_gaussians(ts.params(), ts.alive, cam, w, h, 0, s)
    bins = bin_splats(aux, w, h, s, attrs=attrs)
    a16 = tras.pack_entry_attrs(attrs, bins.entry_gauss, bins.entry_valid)
    ntx, nty = -(-w // s.tile_w), -(-h // s.tile_h)
    off = bins.tile_offsets
    cnt = (off[1:] - off[:-1]).cpu()
    if case == "multichunk":
        assert int(cnt.max()) > 2 * s.chunk
        assert bool(((cnt > s.chunk) & (cnt % 4 != 0)).any())
    elif case == "unaligned":
        a16 = torch.cat([torch.zeros((16, 3), device=cuda), a16],
                        dim=1).contiguous()
        off = off + 3
    elif case == "past_end":
        e_len = a16.shape[1]
        off = off.clone()
        off[0] = -5
        off[-3:] = torch.tensor([e_len + 7, e_len + 100, 2 ** 30],
                                dtype=torch.int32, device=cuda)
    launches = kernel_launches()["rasterize_tiles"]
    got = tras.rasterize_tiles(a16, off, ntx, nty, s)
    got2 = tras.rasterize_tiles(a16, off, ntx, nty, s)
    bare = tras.rasterize_tiles(a16, off, ntx, nty, s, track_ncontrib=False)
    torch.cuda.synchronize()
    assert kernel_launches()["rasterize_tiles"] == launches + 3
    assert torch.equal(got, got2)  # bit-identical
    # without n_contrib: channel 5 reads 0, the others are unchanged
    assert not bare[:, tras.OUT_NCONTRIB].any()
    assert torch.equal(bare[:, 0:5], got[:, 0:5])
    want = tras.rasterize_tiles_plain(a16, off, ntx, nty, s)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert want[:, 3].max() > 0.1
    assert np.abs(got[:, 0:5] - want[:, 0:5]).max() <= 3e-4
    assert np.mean(got[:, 5] != want[:, 5]) <= 0.005
    assert not got[:, 6:].any()
    if case == "plain" and shift > 0:
        assert (got[:, 4] < s.t_threshold).mean() > 0.5  # saturated


def test_render_on_cuda_matches_cpu(cuda):
    w, h = 96, 80
    ts = _scene(300, seed=8, sh_deg=3)
    s = RenderSettings()
    got = render(ts.to(cuda), default_camera(w, h, position=(0, 0, -5.0),
                                             device=cuda), w, h, s)
    want = render(ts, default_camera(w, h, position=(0, 0, -5.0),
                                     device="cpu"), w, h, s)
    np.testing.assert_allclose(got.image.cpu().numpy(),
                               want.image.numpy(), rtol=1e-4, atol=3e-4)
    assert int(got.binning.total_entries) == int(want.binning.total_entries)


def _train_frame(cuda, n, w, h, seed, opacity_shift=0.0):
    """A training frame on the card: projected leaves, binning with the
    expansion payloads, packed entries, forward tiles."""
    s = RenderSettings()
    ts = _scene(n, seed=seed, spread=2.0)
    ts.opacity_logits += opacity_shift
    ts = ts.to(cuda)
    cam = default_camera(w, h, position=(0.0, 0.0, -6.0), device=cuda)
    attrs, aux = project_gaussians(ts.params(), ts.alive, cam, w, h, 0, s)
    bins = bin_splats(aux, w, h, s, attrs=attrs, with_source=True)
    a16 = tras.pack_entry_attrs(attrs, bins.entry_gauss, bins.entry_valid)
    ntx, nty = -(-w // s.tile_w), -(-h // s.tile_h)
    out = tras.rasterize_tiles(a16, bins.tile_offsets, ntx, nty, s,
                               track_ncontrib=False)
    return s, bins, a16, out, ntx, nty


@pytest.mark.parametrize("w,h,bg", [(96, 80, (0.0, 0.0, 0.0)),
                                    (333, 250, (0.3, 0.6, 0.9))])
def test_tile_loss_kernel_matches_plain(cuda, w, h, bg):
    import dataclasses
    from webdgs_tpu_torch.ops import tile_loss as ttl
    from webdgs_tpu_torch.ops.loss import LossConfig
    s, _, _, out, ntx, nty = _train_frame(cuda, 2000, w, h, seed=11)
    s = dataclasses.replace(s, background=bg)
    rng = np.random.default_rng(12)
    target = torch.tensor(rng.random((h, w, 3)), dtype=torch.float32,
                          device=cuda)
    cfg = LossConfig()
    launches = kernel_launches()["tile_loss_tiles"]
    dk, sk = ttl.tile_loss_tiles(out, target, w, h, ntx, nty, cfg, s)
    dk2, sk2 = ttl.tile_loss_tiles(out, target, w, h, ntx, nty, cfg, s)
    torch.cuda.synchronize()
    assert kernel_launches()["tile_loss_tiles"] == launches + 2
    assert torch.equal(dk, dk2) and torch.equal(sk, sk2)  # bit-identical
    dp, sp = ttl.tile_loss_gradient_plain(out, target, w, h, ntx, nty, cfg,
                                          s)
    assert float((dk - dp).abs().max()) <= 1e-5
    torch.testing.assert_close(sk.sum(0), sp.sum(0), rtol=1e-5, atol=0)


def _loss_tiles(cuda, w, h, tile_w, tile_h, seed):
    """Random planar forward tiles and a target for a w x h frame in
    tile_w x tile_h tiles, on the card."""
    import dataclasses
    s = dataclasses.replace(RenderSettings(), tile_w=tile_w, tile_h=tile_h,
                            background=(0.2, 0.5, 0.9))
    ntx, nty = -(-w // tile_w), -(-h // tile_h)
    rng = np.random.default_rng(seed)
    out = np.zeros((ntx * nty, tras.NUM_OUT, s.tile_px), np.float32)
    out[:, 0:3] = rng.random((ntx * nty, 3, s.tile_px)) * 0.9
    out[:, tras.OUT_T] = rng.random((ntx * nty, s.tile_px))
    target = rng.random((h, w, 3)).astype(np.float32)
    target[: h // 3] = 0.0  # flat areas
    return (torch.tensor(out).to(cuda), torch.tensor(target).to(cuda), ntx,
            nty, s)


@pytest.mark.parametrize("tile_w,tile_h", [(16, 16), (32, 32), (15, 16),
                                           (256, 1), (1024, 1)])
def test_tile_loss_kernel_other_tiles(cuda, tile_w, tile_h):
    """Tiles other than the default 32x16 -- 256 and 1,024 pixels, 240
    (not a multiple of 32), a 256x1 row, whose halo rows lie two tiles up
    and down, and a 1024x1 row, whose halo needs more than 48 KB of shared
    memory -- against the plain version, bit-identical on repeat."""
    from webdgs_tpu_torch.ops import tile_loss as ttl
    from webdgs_tpu_torch.ops.loss import LossConfig
    w, h = 333, 250
    out, target, ntx, nty, s = _loss_tiles(cuda, w, h, tile_w, tile_h, 14)
    cfg = LossConfig()
    launches = kernel_launches()["tile_loss_tiles"]
    dk, sk = ttl.tile_loss_tiles(out, target, w, h, ntx, nty, cfg, s)
    dk2, sk2 = ttl.tile_loss_tiles(out, target, w, h, ntx, nty, cfg, s)
    torch.cuda.synchronize()
    assert kernel_launches()["tile_loss_tiles"] == launches + 2
    assert torch.equal(dk, dk2) and torch.equal(sk, sk2)
    dp, sp = ttl.tile_loss_gradient_plain(out, target, w, h, ntx, nty, cfg,
                                          s)
    assert float((dk - dp).abs().max()) <= 1e-5
    torch.testing.assert_close(sk.sum(0), sp.sum(0), rtol=1e-5, atol=0)


def test_tile_loss_runs_without_host_sync(cuda):
    """tile_loss_tiles on CUDA tensors waits for the device nowhere: in
    sync debug mode "error" any synchronizing call raises."""
    from webdgs_tpu_torch.ops import tile_loss as ttl
    from webdgs_tpu_torch.ops.loss import LossConfig
    w, h = 200, 120
    out, target, ntx, nty, s = _loss_tiles(cuda, w, h, 32, 16, 15)
    cfg = LossConfig()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dk, sk = ttl.tile_loss_tiles(out, target, w, h, ntx, nty, cfg, s)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    dp, _ = ttl.tile_loss_gradient_plain(out, target, w, h, ntx, nty, cfg, s)
    assert float((dk - dp).abs().max()) <= 1e-5


def _band_frames(cuda, frame):
    """(tiles, target, w, h, ntx, nty, settings) on the card: the 70x52
    band frame of tests/test_tile_loss.py:132, or a 333x250 frame of
    16 tile rows."""
    if frame == "70x52":
        s = RenderSettings()
        w, h = BAND_FRAME
        out, target = band_loss_frame(17, w, h, s.tile_w, s.tile_h)
        ntx, nty = -(-w // s.tile_w), -(-h // s.tile_h)
        return (torch.tensor(out).to(cuda), torch.tensor(target).to(cuda),
                w, h, ntx, nty, s)
    out, target, ntx, nty, s = _loss_tiles(cuda, 333, 250, 32, 16, 16)
    return out, target, 333, 250, ntx, nty, s


@pytest.mark.parametrize("frame", ["70x52", "333x250"])
@pytest.mark.parametrize("n_bands", (1,) + BAND_SPLITS)
def test_band_tile_loss_kernel_matches_plain(cuda, frame, n_bands):
    """The band form against its plain version, band by band (garbage
    halos at the frame's borders); the bands reassemble the full-frame
    kernel's dpix bit for bit, and tiles wholly below the frame (the
    padding of 3 bands) are zero."""
    from webdgs_tpu_torch.ops import tile_loss as ttl
    from webdgs_tpu_torch.ops.loss import LossConfig
    out, target, w, h, ntx, nty, s = _band_frames(cuda, frame)
    cfg = LossConfig()
    full_d, full_s = ttl.tile_loss_tiles(out, target, w, h, ntx, nty, cfg,
                                         s)
    parts, sums = [], []
    for row_base, rows, band, top, bot in split_bands(
            out.cpu().numpy(), ntx, nty, n_bands, s.tile_w, s.tile_h, 5):
        args = [torch.tensor(x).to(cuda) for x in (band, top, bot)] + [
            target, row_base, w, h, ntx, rows, cfg, s]
        launches = kernel_launches()["tile_loss_tiles"]
        dk, sk = ttl.band_tile_loss_gradient(*args)
        torch.cuda.synchronize()
        assert kernel_launches()["tile_loss_tiles"] == launches + 1
        dp, sp = ttl.band_tile_loss_gradient_plain(*args)
        assert float((dk - dp).abs().max()) <= 1e-5
        torch.testing.assert_close(sk.sum(0), sp.sum(0), rtol=1e-5, atol=0)
        below = torch.arange(rows, device=cuda).repeat_interleave(ntx) \
            + row_base >= -(-h // s.tile_h)
        assert not dk[below].any() and not sk[below].any()
        parts.append(dk)
        sums.append(sk)
    assert torch.equal(torch.cat(parts)[:ntx * nty], full_d)
    torch.testing.assert_close(torch.cat(sums).sum(0), full_s.sum(0),
                               rtol=1e-6, atol=0)


def test_band_tile_loss_kernel_one_band_is_full_frame(cuda):
    """row_base 0 with the frame's own boundary slices as halos (a ring of
    one band) is the full-frame kernel, bit for bit; so is a band built
    from a padded grid, whose extra rows are zero."""
    from webdgs_tpu_torch.ops import tile_loss as ttl
    from webdgs_tpu_torch.ops.loss import LossConfig
    out, target, w, h, ntx, nty, s = _band_frames(cuda, "333x250")
    cfg = LossConfig()
    full_d, full_s = ttl.tile_loss_tiles(out, target, w, h, ntx, nty, cfg,
                                         s)
    bot, top = ttl.halo_slices(out, ntx, s)
    dk, sk = ttl.band_tile_loss_gradient(out, bot, top, target, 0, w, h,
                                         ntx, nty, cfg, s)
    assert torch.equal(dk, full_d) and torch.equal(sk, full_s)
    padded = torch.cat([out, torch.rand_like(out[:2 * ntx])])
    dk, sk = ttl.band_tile_loss_gradient(padded, bot, top, target, 0, w, h,
                                         ntx, nty + 2, cfg, s)
    assert torch.equal(dk[:ntx * nty], full_d)
    assert not dk[ntx * nty:].any() and not sk[ntx * nty:].any()


@pytest.mark.parametrize("n,w,h,shift", [(3000, 320, 240, 0.0),
                                         (20_000, 96, 80, -3.0)])
def test_aligned_zero_rows_are_no_ops(cuda, n, w, h, shift):
    """The forward and backward kernels on the chunk-aligned layout of the
    Gaussian-sharded paths (each tile's entries followed by all-zero rows
    to a chunk boundary, spare chunks at the end): all 8 forward channels,
    n_contrib included, equal the sorted layout's; the real entries'
    cotangents equal theirs and the zero rows' are 0."""
    s, bins, a16, _, ntx, nty = _train_frame(cuda, n, w, h, seed=17,
                                             opacity_shift=shift)
    rows, offsets, src, valid = aligned_entries(a16, bins.tile_offsets,
                                                s.chunk, slack=2)
    out = tras.rasterize_tiles(a16, bins.tile_offsets, ntx, nty, s)
    out_a = tras.rasterize_tiles(rows, offsets, ntx, nty, s)
    assert torch.equal(out_a, out)
    gpix = torch.randn((ntx * nty, tras.NUM_GPIX, s.tile_px),
                       generator=torch.Generator(cuda).manual_seed(3),
                       device=cuda)
    d = tras.rasterize_tiles_backward(a16, bins.tile_offsets, gpix, ntx, nty,
                                      s)
    d_a = tras.rasterize_tiles_backward(rows, offsets, gpix, ntx, nty, s)
    assert torch.equal(d_a[:, valid], d[:, src[valid]])
    assert not d_a[:, ~valid].any()


@pytest.mark.parametrize("n,w,h,shift,case", [
    (300, 96, 80, 0.0, "plain"), (5000, 640, 480, 0.0, "plain"),
    (3000, 320, 240, 5.0, "plain"),
    # ranges of several chunks whose counts are multiples of neither the
    # butterfly batch nor the chunk (faint splats: few pixels saturate)
    (20_000, 96, 80, -3.0, "multichunk"),
    # every range starts 3 slots later: no tile is 16-byte aligned
    (5000, 320, 240, 0.0, "unaligned"),
    # nearly opaque and dense: whole warps saturate within a few entries
    (20_000, 96, 80, 6.0, "plain"),
    # offsets reaching past E (and one below 0): clamped, no fault
    (5000, 320, 240, 0.0, "past_end")])
def test_rasterize_backward_kernel_matches_plain(cuda, n, w, h, shift, case):
    s, bins, a16, out, ntx, nty = _train_frame(cuda, n, w, h, seed=13,
                                               opacity_shift=shift)
    off = bins.tile_offsets
    cnt = (off[1:] - off[:-1]).cpu()
    if case == "multichunk":
        assert int(cnt.max()) > 2 * s.chunk
        assert bool(((cnt > s.chunk) & (cnt % 8 != 0)).any())
    elif case == "unaligned":
        a16 = torch.cat([torch.zeros((16, 3), device=cuda), a16],
                        dim=1).contiguous()
        off = off + 3
    elif case == "past_end":
        e_len = a16.shape[1]
        off = off.clone()
        off[0] = -5
        off[-3:] = torch.tensor([e_len + 7, e_len + 100, 2 ** 30],
                                dtype=torch.int32, device=cuda)
    rng = np.random.default_rng(14)
    g = torch.tensor(rng.normal(0, 1, out.shape), dtype=torch.float32,
                     device=cuda)
    suffix = ((g[:, 0:4] * out[:, 0:4]).sum(1, keepdim=True)
              + g[:, 4:5] * out[:, 4:5])
    gpix5 = torch.cat([g[:, 0:4], suffix], dim=1).contiguous()
    launches = kernel_launches()["rasterize_tiles_backward"]
    dk = tras.rasterize_tiles_backward(a16, off, gpix5, ntx, nty, s)
    dk2 = tras.rasterize_tiles_backward(a16, off, gpix5, ntx, nty, s)
    torch.cuda.synchronize()
    assert kernel_launches()["rasterize_tiles_backward"] == launches + 2
    assert torch.equal(dk, dk2)  # bit-identical
    dp = tras.rasterize_tiles_backward_plain(a16, off, gpix5, ntx, nty, s)
    assert float(dp[0:9].abs().max()) > 0
    scale = max(float(dp.abs().max()), 1.0)
    assert float((dk - dp).abs().max()) / scale <= 1e-4
    assert not dk[9:].any()


@pytest.mark.parametrize("n,e_cap,cols,seed,long_seg,garbage", [
    (100, 512, 16, 0, 0, False), (50_000, 400_000, 16, 1, 0, False),
    (200_000, 1_000_000, 1, 2, 0, False),  # the importance counts' C = 1
    (3000, 20_000, 16, 3, 2500, False),  # one Gaussian of 2,500 entries
    (3000, 20_000, 1, 4, 700, True),
    (20_000, 100_000, 16, 5, 0, True),  # NaN rows and flags past the total
    (2000, 9000, 3, 6, 300, True)])  # C not a multiple of 4
def test_segsum_kernel_matches_plain(cuda, n, e_cap, cols, seed, long_seg,
                                     garbage):
    from webdgs_tpu_torch.ops import segsum as tseg
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 9, n).astype(np.int32)
    counts[n // 2] = long_seg or counts[n // 2]
    while counts.sum() > e_cap:
        counts[rng.integers(0, n)] = 0
    total = int(counts.sum())
    # the binning's layout: the first `total` sorted slots hold the
    # expansion indices [0, total), the rest the others
    perm = rng.permutation(e_cap).astype(np.int32)
    perm = perm[np.argsort(perm >= total, kind="stable")]
    rows = torch.tensor(rng.standard_normal((cols, e_cap)),
                        dtype=torch.float32, device=cuda)
    valid = torch.arange(e_cap, device=cuda) < total
    if garbage:
        rows[:, total:] = float("nan")
        valid[total:] = torch.tensor(rng.random(e_cap - total) < 0.5,
                                     device=cuda)
    args = (torch.tensor(counts, device=cuda),
            torch.tensor(perm, device=cuda), valid)
    launches = kernel_launches()["segment_sum_rows"]
    k1 = tseg.segment_sum_rows(rows, *args)
    k2 = tseg.segment_sum_rows(rows, *args)
    torch.cuda.synchronize()
    assert kernel_launches()["segment_sum_rows"] == launches + 2
    assert torch.equal(k1, k2)
    p = tseg.segment_sum_rows_plain(rows, *args)
    assert bool(torch.isfinite(k1).all())
    scale = max(float(p.abs().max()), 1.0)
    assert float((k1 - p).abs().max()) / scale <= 1e-5


@pytest.mark.parametrize("n,w,h,threshold", [(300, 96, 80, 0.3),
                                             (20_000, 640, 480, 0.5)])
def test_importance_kernel_matches_plain(cuda, n, w, h, threshold):
    """The importance kernel on one view's inputs: every slot equal to the
    plain version on the same card, and bit-identical on repeat."""
    from webdgs_tpu_torch.ops import importance as timp
    s = RenderSettings()
    ts = _scene(n, seed=17, spread=2.0).to(cuda)
    cam = default_camera(w, h, position=(0.0, 0.0, -6.0), device=cuda)
    attrs, aux = project_gaussians(ts.params(), ts.alive, cam, w, h, 0, s)
    bins = bin_splats(aux, w, h, s, attrs=attrs)
    a16 = tras.pack_entry_attrs(attrs, bins.entry_gauss, bins.entry_valid)
    ntx, nty = -(-w // s.tile_w), -(-h // s.tile_h)
    out = tras.rasterize_tiles(a16, bins.tile_offsets, ntx, nty, s)
    tiles = tras.tiles_to_image(out, ntx, nty, w, h, s)
    pred = tras.composite_background(tiles, s)
    noise = np.random.default_rng(18).normal(0.0, 0.1, (h, w, 3))
    flag = timp.metric_flag_map(pred, pred + torch.tensor(
        noise, dtype=torch.float32, device=cuda), threshold)
    pix = torch.stack([flag, tiles[..., tras.OUT_NCONTRIB]], dim=-1)
    pix_tiles = tras.image_to_tiles(pix, ntx, nty, s).contiguous()
    args = (a16, bins.tile_offsets, pix_tiles, ntx, nty, s)
    launches = kernel_launches()["entry_counts"]
    k1 = timp.entry_counts(*args)
    k2 = timp.entry_counts(*args)
    torch.cuda.synchronize()
    assert kernel_launches()["entry_counts"] == launches + 2
    assert torch.equal(k1, k2)
    p = timp.entry_counts_plain(*args)
    total = int(bins.total_entries)
    assert float(p.sum()) > 0
    assert torch.equal(k1, p)
    assert not k1[total:].any()



# crafted importance-count inputs (shared with tests/test_torch_importance.py,
# which holds them against JAX): name -> (tile ranges, pixel recipe)
IMPORTANCE_CASES = ("single_flag", "all_flagged", "nc_ties",
                    "nc_above_range", "nc_zero", "long_range")
# an alpha this close (relative) to alpha_min is a tie the crafting avoids
_ALPHA_BAND = 1e-3


def crafted_importance_case(case: str, seed: int, tile_w: int = 32,
                            tile_h: int = 16, alpha_min: float = 1 / 255,
                            alpha_max: float = 0.99, chunk: int = 128):
    """Numpy inputs of entry_counts for two tiles side by side: (attrs16
    (16, E) float32, tile_offsets (3,) int32, pix_tiles (2, P, 2) float32,
    ntx, nty).  Splat centres sit at a quarter pixel and extents end at a
    half pixel, so no pixel centre is near a box edge; each entry's
    opacity is redrawn until no pixel of its tile sees an alpha within
    _ALPHA_BAND of alpha_min.  E is a multiple of ``chunk`` with spare
    slots past the ranges, and the first range's end is not chunk-aligned
    (the JAX kernel's shared boundary chunk)."""
    rng = np.random.default_rng(seed)
    npx = tile_w * tile_h
    lens = {"long_range": (1500, 600), "single_flag": (300, 170),
            "over_8192": (9000, 300)}.get(case, (230, 170))
    e_len = -(-(sum(lens) + 5) // chunk) * chunk
    a16 = np.zeros((16, e_len), np.float32)
    off = np.array([0, lens[0], sum(lens)], np.int32)
    gx, gy = np.meshgrid(np.arange(tile_w) + 0.5, np.arange(tile_h) + 0.5)
    for t in range(2):
        for e in range(off[t], off[t + 1]):
            sx, sy = rng.uniform(0.8, 6.0, 2)
            ca, cc = 1.0 / sx ** 2, 1.0 / sy ** 2
            cb = rng.uniform(-0.4, 0.4) * np.sqrt(ca * cc)
            cx = t * tile_w + rng.integers(-6, tile_w + 6) + 0.25
            cy = rng.integers(-6, tile_h + 6) + 0.25
            ex, ey = np.ceil(3 * sx) + 0.5, np.ceil(3 * sy) + 0.5
            a16[[0, 1, 2, 3, 4, 9, 10], e] = (cx, cy, ca, cb, cc, ex, ey)
            # the float32 values the kernels see
            cx, cy, ca, cb, cc = a16[0:5, e].astype(np.float64)
            dx = t * tile_w + gx - cx
            dy = gy - cy
            inside = (np.abs(dx) <= ex) & (np.abs(dy) <= ey)
            g = np.exp(-0.5 * (ca * dx * dx + 2 * cb * dx * dy
                               + cc * dy * dy))
            while True:
                op = np.float32(rng.uniform(0.02, 1.0))
                alpha = np.minimum(float(op) * g, alpha_max)[inside]
                if not (np.abs(alpha / alpha_min - 1) < _ALPHA_BAND).any():
                    break
            a16[8, e] = op
            a16[5:8, e] = rng.uniform(0, 1, 3)
    pix = np.zeros((2, npx, 2), np.float32)
    for t in range(2):
        n = lens[t]
        nc = rng.integers(0, n + 1, npx)
        flag = rng.random(npx) < 0.4
        if case == "single_flag":
            flag[:] = False
            flag[rng.integers(npx)] = True
            nc[flag] = rng.integers(n // 2, n + 1)
        elif case in ("all_flagged", "long_range", "over_8192"):
            flag[:] = True
        elif case == "nc_ties":
            nc = rng.choice([1, 7, 7, 40, n // 2, n], npx)
        elif case == "nc_above_range":
            nc = n + rng.integers(1, 1000, npx)
        elif case == "nc_zero":
            nc[flag] = 0 if t == 0 else nc[flag] * (rng.random(
                int(flag.sum())) < 0.5)
        pix[t, :, 0] = flag
        pix[t, :, 1] = nc
    return a16, off, pix, 2, 1


@pytest.mark.parametrize("case", IMPORTANCE_CASES + ("over_8192",))
def test_importance_kernel_crafted_cases(cuda, case):
    """The crafted cases (a single flagged pixel, every pixel flagged,
    ties in n_contrib, n_contrib past the range, flagged pixels with
    n_contrib 0, a range of 1,500 entries, and one of 9,000, past the
    kernel's last n_contrib bucket): every slot of the kernel equal to the
    plain version, bit-identical on repeat."""
    from webdgs_tpu_torch.ops import importance as timp
    a16, off, pix, ntx, nty = crafted_importance_case(case, seed=21)
    args = [torch.tensor(x).to(cuda) for x in (a16, off, pix)]
    s = RenderSettings()
    launches = kernel_launches()["entry_counts"]
    k1 = timp.entry_counts(*args, ntx, nty, s)
    k2 = timp.entry_counts(*args, ntx, nty, s)
    torch.cuda.synchronize()
    assert kernel_launches()["entry_counts"] == launches + 2
    assert torch.equal(k1, k2)
    p = timp.entry_counts_plain(*args, ntx, nty, s)
    assert torch.equal(k1, p)
    assert float(p.sum()) > 0 or case == "nc_zero"


def test_importance_runs_without_host_sync(cuda):
    """entry_counts on CUDA tensors waits for the device nowhere: in sync
    debug mode "error" any synchronizing call raises."""
    from webdgs_tpu_torch.ops import importance as timp
    a16, off, pix, ntx, nty = crafted_importance_case("long_range", seed=22)
    args = [torch.tensor(x).to(cuda) for x in (a16, off, pix)]
    s = RenderSettings()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = timp.entry_counts(*args, ntx, nty, s)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, timp.entry_counts_plain(*args, ntx, nty, s))

@pytest.mark.parametrize("full_sh,sh_deg", [(False, 0), (True, 3)])
def test_train_step_on_cuda_matches_cpu(cuda, full_sh, sh_deg):
    """One training step on the card against the same step on the CPU:
    the metrics and the gradients' first moments agree (full SH: every
    coefficient trained through the SH stage's VJP)."""
    from webdgs_tpu_torch.ops.adam import AdamHyperparameters, init_adam_state
    from webdgs_tpu_torch.train.step import train_step
    w, h = 96, 80
    ts = _scene(400, seed=15, spread=1.5, sh_deg=sh_deg)
    rng = np.random.default_rng(16)
    target = torch.tensor(rng.random((h, w, 3)), dtype=torch.float32)
    hp = AdamHyperparameters(full_sh=full_sh)
    res = {}
    for dev in ("cpu", cuda):
        sc = ts.to(dev)
        cam = default_camera(w, h, position=(0.0, 0.0, -5.0), device=dev)
        res[str(dev)] = train_step(sc, init_adam_state(sc.params()), cam,
                                   target.to(dev), img_w=w, img_h=h, hp=hp)
    c, g = res["cpu"], res[str(cuda)]
    for k in ("l1", "l2", "dssim", "loss", "psnr"):
        assert abs(float(g.metrics[k]) - float(c.metrics[k])) <= \
            1e-4 * abs(float(c.metrics[k])), k
    m_c, m_g = c.opt_state.m, g.opt_state.m.cpu()
    scale = max(float(m_c.abs().max()), 0.1)
    assert float((m_g - m_c).abs().max()) / scale <= 1e-3
    # the SH rest lanes (14:59 of the packed rows) train only with full SH
    assert bool(m_g[:, 14:].any()) == full_sh


ADAM_OPTS = ({}, {"full_sh": True}, {"bias_correction": True},
             {"lr_pos_final": 1.6e-6, "lr_pos_decay_steps": 10})


def _adam_inputs(n, seed, device):
    """Parameters, gradients and tile counts (about a third 0) of ``n``
    rows, drawn with numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"means": (n, 3), "quats": (n, 4), "log_scales": (n, 3),
              "opacity_logits": (n,), "sh": (n, 16, 3)}
    params = {k: torch.tensor(rng.normal(0, 1, s), dtype=torch.float32,
                              device=device) for k, s in shapes.items()}
    grads = {k: torch.tensor(rng.normal(0, 1e-2, s), dtype=torch.float32,
                             device=device) for k, s in shapes.items()}
    counts = torch.tensor(rng.integers(0, 3, n).astype(np.int32),
                          device=device)
    return params, grads, counts


def _ulps(a, b):
    """Largest distance in float32 steps (same-sign values)."""
    return int((a.view(torch.int32).to(torch.int64)
                - b.view(torch.int32).to(torch.int64)).abs().max())


@pytest.mark.parametrize("n", [1, 7, 50, 100_003])
@pytest.mark.parametrize("opts", ADAM_OPTS)
def test_adam_kernel_matches_plain(cuda, opts, n):
    """The Adam kernel against the torch chain on the same CUDA tensors,
    three steps with the moments carried: every lane outside the quaternion
    equal, the quaternion within 2 ulp (its norm sums in another order),
    frozen rows their inputs bit for bit.  The first step runs in sync
    debug mode "error": every hyperparameter is a kernel argument, nothing
    is uploaded, so nothing waits for the device."""
    from webdgs_tpu_torch.ops import adam as tadam
    hp = tadam.AdamHyperparameters(**opts)
    params, grads, counts = _adam_inputs(n, seed=n + len(opts), device=cuda)
    state = tadam.init_adam_state(params)
    frozen = counts == 0
    for step in range(3):
        g = {k: v * (step + 1) for k, v in grads.items()}
        launches = kernel_launches()["adam_step"]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error" if step == 0 else "default")
        try:
            got_p, got_s = tadam.adam_step(params, g, state, hp, counts)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert kernel_launches()["adam_step"] == launches + 1
        want_p, want_s = tadam.adam_step_plain(params, g, state, hp, counts)
        assert got_s.iteration == want_s.iteration == step + 1
        assert torch.equal(got_s.m, want_s.m)
        assert torch.equal(got_s.v, want_s.v)
        for k in params:
            assert got_p[k].shape == want_p[k].shape, k
            assert got_p[k].is_contiguous(), k
            if k == "quats":
                assert _ulps(got_p[k], want_p[k]) <= 2
            else:
                assert torch.equal(got_p[k], want_p[k]), k
            assert torch.equal(got_p[k][frozen], params[k][frozen]), k
        assert torch.equal(got_s.m[frozen], state.m[frozen])
        assert torch.equal(got_s.v[frozen], state.v[frozen])
        params, state = want_p, want_s
    # with full SH the rest lanes train; with DC only they stay as they are
    assert bool(state.m[:, 14:].any()) == bool(opts.get("full_sh"))


def test_train_step_launches_adam_once(cuda):
    """One train_step on the card launches the Adam kernel exactly once."""
    from webdgs_tpu_torch.ops.adam import init_adam_state
    from webdgs_tpu_torch.train.step import train_step
    w, h = 96, 80
    sc = _scene(400, seed=41, spread=1.5).to(cuda)
    target = torch.rand((h, w, 3), generator=torch.Generator().manual_seed(42))
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0), device=cuda)
    launches = kernel_launches()["adam_step"]
    train_step(sc, init_adam_state(sc.params()), cam, target.to(cuda),
               img_w=w, img_h=h)
    torch.cuda.synchronize()
    assert kernel_launches()["adam_step"] == launches + 1
