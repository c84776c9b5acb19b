"""The raster and importance kernels' entries read through the binning's
index (``rasterize.EntryAttrs``) against the packed rows they stand for,
on the CPU: the forward tiles, the five fields' gradients and the
importance counts equal ``pack_entry_attrs`` + ``rasterize_tiles_plain`` /
``rasterize_tiles_backward_plain`` + the segment sum / ``entry_counts_plain``
exactly, with invalid slots (in and past the tiles' ranges) whose index is
out of range; and the render, the training step, the metric views and the
viewer never pack."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from webdgs_tpu_torch.config import RenderSettings
from webdgs_tpu_torch.core.camera import CameraData, default_camera
from webdgs_tpu_torch.core.scene import scene_from_arrays
from webdgs_tpu_torch.ops import importance as timp
from webdgs_tpu_torch.ops import rasterize as tras
from webdgs_tpu_torch.ops.binning import bin_splats, tile_grid
from webdgs_tpu_torch.ops.projection import SplatAttrs, project_gaussians
from webdgs_tpu_torch.ops.segsum import segment_reduce_entries

INT_MAX = 2 ** 31 - 1
# name -> (Gaussians, width, height, opacity shift)
FRAMES = {"sparse": (300, 96, 80, 0.0), "opaque": (900, 64, 96, 4.0),
          "faint": (1500, 96, 64, -3.0)}


def _frame(name, drop_in_range=False):
    """A projected frame with its binning's entries (every slot past the
    total holds index INT_MAX; with ``drop_in_range`` every 5th slot
    inside the ranges is invalid too), the packed rows they stand for,
    and the fields as leaves that require grad."""
    n, w, h, shift = FRAMES[name]
    s = RenderSettings()
    rng = np.random.default_rng(len(name) * 7 + n)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    scene = scene_from_arrays(
        rng.normal(0, 1.5, (n, 3)).astype(np.float32), quats=quats,
        log_scales=rng.uniform(-3.5, -1.5, (n, 3)).astype(np.float32),
        opacity_logits=rng.uniform(-1, 3, (n,)).astype(np.float32) + shift,
        device="cpu")
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0), device="cpu")
    attrs, aux = project_gaussians(scene.params(), scene.alive, cam, w, h,
                                   0, s)
    bins = bin_splats(aux, w, h, s, attrs=attrs, with_source=True)
    valid = bins.entry_valid.clone()
    assert not bool(valid.all())  # the capacity holds invalid slots
    if drop_in_range:
        total = int(bins.total_entries)
        valid[:total:5] = False
    gauss = torch.where(valid, bins.entry_gauss, INT_MAX)
    leaves = SplatAttrs(*(a.detach().requires_grad_(True) for a in attrs))
    entries = tras.EntryAttrs(leaves, gauss, valid, bins.entry_source,
                              bins.gauss_counts)
    a16 = tras.pack_entry_attrs(SplatAttrs(*(a.detach() for a in attrs)),
                                gauss, valid)
    ntx, nty = tile_grid(w, h, s)
    return s, w, h, ntx, nty, bins, entries, a16


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("name", sorted(FRAMES))
def test_indexed_forward_equals_pack(name, drop):
    s, _, _, ntx, nty, bins, entries, a16 = _frame(name, drop)
    assert torch.equal(tras.packed_rows(entries), a16)
    for track in (True, False):
        got = tras.rasterize_tiles(entries, bins.tile_offsets, ntx, nty, s,
                                   track_ncontrib=track)
        want = tras.rasterize_tiles_plain(a16, bins.tile_offsets, ntx, nty,
                                          s, track_ncontrib=track)
        assert torch.equal(got, want)
    assert float(got[:, tras.OUT_ACC_ALPHA].detach().max()) > 0.1


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("name", sorted(FRAMES))
def test_indexed_gradients_equal_pack_and_segment_sum(name, drop):
    """autograd through rasterize_tiles(EntryAttrs) gives each field the
    plain backward's per-entry cotangents summed per Gaussian and split,
    bit for bit; the per-entry cotangents equal the packed rows'."""
    s, _, _, ntx, nty, bins, entries, a16 = _frame(name, drop)
    out = tras.rasterize_tiles(entries, bins.tile_offsets, ntx, nty, s,
                               track_ncontrib=False)
    g = torch.tensor(np.random.default_rng(5).normal(0, 1, out.shape),
                     dtype=torch.float32)
    grads = torch.autograd.grad(out, list(entries.attrs), g)

    suffix = (torch.sum(g[:, 0:4] * out[:, 0:4], dim=1, keepdim=True)
              + g[:, tras.OUT_T:tras.OUT_T + 1]
              * out[:, tras.OUT_T:tras.OUT_T + 1]).detach()
    gpix5 = torch.cat([g[:, 0:4], suffix], dim=1).contiguous()
    d_plain = tras.rasterize_tiles_backward_plain(a16, bins.tile_offsets,
                                                  gpix5, ntx, nty, s)
    assert torch.equal(tras.rasterize_tiles_backward(
        entries, bins.tile_offsets, gpix5, ntx, nty, s), d_plain)
    d = segment_reduce_entries(d_plain.T, entries.entry_valid,
                               bins.entry_source, bins.gauss_counts)
    want = (d[:, 0:2], d[:, 2:5], d[:, 5:8], d[:, 8], d[:, 9:11])
    for field, got, w in zip(SplatAttrs._fields, grads, want):
        assert got.shape == w.shape, field
        assert torch.equal(got, w), field
    assert float(grads[0].abs().max()) > 0
    assert not grads[4].any()  # the extents take no gradient


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("name", sorted(FRAMES))
def test_indexed_importance_equals_pack(name, drop):
    s, w, h, ntx, nty, bins, entries, a16 = _frame(name, drop)
    with torch.no_grad():
        out = tras.rasterize_tiles(entries, bins.tile_offsets, ntx, nty, s)
    tiles = tras.tiles_to_image(out, ntx, nty, w, h, s)
    pred = tras.composite_background(tiles, s)
    noise = torch.tensor(np.random.default_rng(6).normal(0, 0.1, (h, w, 3)),
                         dtype=torch.float32)
    flag = timp.metric_flag_map(pred, pred + noise, 0.3)
    pix = torch.stack([flag, tiles[..., tras.OUT_NCONTRIB]], dim=-1)
    pix_tiles = tras.image_to_tiles(pix, ntx, nty, s).contiguous()
    got = timp.entry_counts(entries, bins.tile_offsets, pix_tiles, ntx, nty,
                            s)
    want = timp.entry_counts_plain(a16, bins.tile_offsets, pix_tiles, ntx,
                                   nty, s)
    assert float(want.sum()) > 0
    assert torch.equal(got, want)


def test_entry_checks():
    s, _, _, ntx, nty, bins, entries, _ = _frame("sparse")
    off = bins.tile_offsets
    with pytest.raises(TypeError):
        tras.rasterize_tiles(entries._replace(
            entry_gauss=entries.entry_gauss.long()), off, ntx, nty, s)
    with pytest.raises(TypeError):
        tras.rasterize_tiles(entries._replace(
            entry_valid=entries.entry_valid[:-1]), off, ntx, nty, s)
    with pytest.raises(ValueError):
        tras.rasterize_tiles(entries._replace(
            attrs=entries.attrs._replace(conic=entries.attrs.conic[:, :2])),
            off, ntx, nty, s)
    with pytest.raises(ValueError):
        tras.rasterize_tiles(entries._replace(
            attrs=entries.attrs._replace(
                opacity=entries.attrs.opacity.double())), off, ntx, nty, s)
    # a non-contiguous field is read as its contiguous copy
    strided = entries.attrs.color.detach().T.contiguous().T
    got = tras.rasterize_tiles(entries._replace(
        attrs=entries.attrs._replace(color=strided)), off, ntx, nty, s)
    assert torch.equal(got, tras.rasterize_tiles(entries, off, ntx, nty, s))
    # without the expansion payloads the fields are forward-only
    out = tras.rasterize_tiles(entries._replace(entry_source=None), off, ntx,
                               nty, s)
    with pytest.raises(ValueError, match="with_source"):
        out.sum().backward()


def test_render_step_views_and_viewer_never_pack(monkeypatch):
    """The render, a training step across a densify event (whose metric
    views render and count) and a viewer frame run without
    pack_entry_attrs."""
    from webdgs_tpu_torch.core.scene import scene_from_numpy
    from webdgs_tpu_torch.render.renderer import render
    from webdgs_tpu_torch.render.viewer import Viewer
    from webdgs_tpu_torch.train.config import TrainerConfig
    from webdgs_tpu_torch.train.trainer import Trainer

    def refuse(*args, **kwargs):
        raise AssertionError("pack_entry_attrs called")

    monkeypatch.setattr(tras, "pack_entry_attrs", refuse)
    w, h, n = 64, 48, 60
    rng = np.random.default_rng(3)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    sh = rng.normal(0, 0.3, (n, 16, 3)).astype(np.float32)
    sh[:, 0, :] += 0.8
    params = {"means": rng.normal(0, 1.2, (n, 3)).astype(np.float32),
              "quats": quats / np.linalg.norm(quats, axis=1, keepdims=True),
              "log_scales": rng.uniform(-3.5, -1.5, (n, 3)).astype(
                  np.float32),
              "opacity_logits": rng.uniform(-1, 3, (n,)).astype(np.float32),
              "sh": sh}
    scene = scene_from_numpy(params, np.ones(n, bool), 0, "cpu")
    res = render(scene, default_camera(w, h, position=(0, 0, -5.0),
                                       device="cpu"), w, h)
    assert float(res.accum[..., 3].max()) > 0.1
    cams, images = [], []
    for i in range(3):
        cams.append(CameraData(
            id=i, position=np.array([0.3 * i - 0.3, 0.1 * i, -5.0],
                                    np.float32),
            rotation=np.eye(3, dtype=np.float32), width=w, height=h,
            fy=40.0, fx=40.0, img_name=f"v{i}.png"))
        images.append({"width": w, "height": h,
                       "image": rng.random((h, w, 3)).astype(np.float32)})
    cfg = TrainerConfig(seed=6)
    cfg = dataclasses.replace(cfg, densify=dataclasses.replace(
        cfg.densify,
        schedule=dataclasses.replace(cfg.densify.schedule, enabled=True,
                                     warmup_iterations=2, interval=2,
                                     stop_iterations=6),
        metric_views=2, metric_downscale=2, metric_threshold=0.3))
    tr = Trainer(scene, cams, images, cfg, initial_capacity=64)
    tr.train(3, log_fn=None)
    assert tr.last_densify_event is not None
    Viewer(scene, w, h, device="cpu").render()
