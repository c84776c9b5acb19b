"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips (the kernels
have no interpret mode).  The file imports no jax (the card's machine need
not have it), so on a machine with an H100 it runs without the suite's
conftest:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from webdgs_tpu_torch.config import RenderSettings
from webdgs_tpu_torch.core.camera import default_camera
from webdgs_tpu_torch.core.scene import scene_from_arrays
from webdgs_tpu_torch.ops import rasterize as tras
from webdgs_tpu_torch.ops.binning import bin_splats
from webdgs_tpu_torch.ops.expand import (NWORDS, expand_fields,
                                         expand_fields_plain)
from webdgs_tpu_torch.ops.projection import project_gaussians
from webdgs_tpu_torch.render.renderer import render

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
    launches = expand_fields.kernel_launches
    got = expand_fields(words.to(cuda), counts.to(cuda), e_cap)
    torch.cuda.synchronize()
    assert expand_fields.kernel_launches == launches + 1
    want = expand_fields_plain(words, counts, e_cap)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n,w,h", [(300, 96, 80), (20_000, 640, 480)])
def test_rasterize_kernel_matches_plain(cuda, n, w, h):
    s = RenderSettings()
    ts = _scene(n, seed=7, spread=2.0).to(cuda)
    cam = default_camera(w, h, position=(0.0, 0.0, -6.0), device=cuda)
    attrs, aux = project_gaussians(ts.params(), ts.alive, cam, w, h, 0, s)
    bins = bin_splats(aux, w, h, s, attrs=attrs)
    a16 = tras.pack_entry_attrs(attrs, bins.entry_gauss, bins.entry_valid)
    ntx, nty = -(-w // s.tile_w), -(-h // s.tile_h)
    launches = tras.rasterize_tiles.kernel_launches
    got = tras.rasterize_tiles(a16, bins.tile_offsets, ntx, nty, s)
    torch.cuda.synchronize()
    assert tras.rasterize_tiles.kernel_launches == launches + 1
    want = tras.rasterize_tiles_plain(a16, bins.tile_offsets, ntx, nty, s)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.abs(got[:, 0:5] - want[:, 0:5]).max() <= 3e-4
    assert np.mean(got[:, 5] != want[:, 5]) <= 0.005


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
