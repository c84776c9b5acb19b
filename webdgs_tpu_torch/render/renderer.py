"""Full forward render: scene + camera -> image (counterpart of
webdgs_tpu/render/renderer.py:27-247); ``render_from_attrs(for_grad=True)``
is the training step's differentiable render.

project -> bin (expand kernel) -> rasterize (forward kernel, staging each
entry through the binning's index) -> image.  PyTorch runs eagerly, so there is no jit: ``render_compiled`` is
``render`` itself.  Frames whose tile grid reaches the 16-bit tile-key
limit render in serial bands (``render_banded``): one projection, then
per band the restrict, shift, bin and rasterize of ``_render_band``,
which the tile-sharded render of ``parallel/sharding.py`` shares.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from webdgs_tpu_torch import trace
from webdgs_tpu_torch.config import DEFAULT_SETTINGS, RenderSettings
from webdgs_tpu_torch.core.camera import Camera
from webdgs_tpu_torch.core.scene import GaussianScene
from webdgs_tpu_torch.ops import binning as binning_ops
from webdgs_tpu_torch.ops import rasterize as raster_ops
from webdgs_tpu_torch.ops.projection import (SplatAttrs, SplatAux,
                                             project_gaussians,
                                             restrict_aux_to_band)


class RenderResult(NamedTuple):
    image: torch.Tensor  # (H, W, 3) with background composited
    accum: torch.Tensor  # (H, W, 4) raw [r,g,b,accum_alpha] before bg
    t_final: torch.Tensor  # (H, W) final transmittance
    n_contrib: torch.Tensor  # (H, W) i32 last contributor per pixel
    aux: SplatAux
    binning: binning_ops.Binning


def render_from_attrs(attrs: SplatAttrs, aux: SplatAux, img_w: int,
                      img_h: int, settings: RenderSettings,
                      entry_capacity: int | None = None,
                      for_grad: bool = False):
    """Bin + rasterize from projected splat attributes; returns the
    (T, NUM_OUT, P) tile buffer and the Binning.  Differentiable with
    respect to ``attrs``.

    ``for_grad``: the gradient path -- the sort carries the expansion-slot
    payload (``with_source``) so the per-Gaussian gradient is a segment
    sum, and the n_contrib channel, which only the importance replay
    reads, is not tracked."""
    ntx, nty = binning_ops.tile_grid(img_w, img_h, settings)
    with trace.span("bin"):
        bins = binning_ops.bin_splats(aux, img_w, img_h, settings,
                                      capacity=entry_capacity,
                                      with_source=for_grad, attrs=attrs)
    with trace.span("raster"):
        out = raster_ops.rasterize_tiles(
            raster_ops.EntryAttrs.of(attrs, bins), bins.tile_offsets, ntx,
            nty, settings, track_ncontrib=not for_grad)
    return out, bins


def pointify_attrs(attrs: SplatAttrs, point_size_px: float,
                   settings: RenderSettings) -> SplatAttrs:
    """Splat attributes that make the standard compositor draw point-cloud
    debug dots: a steep isotropic conic whose alpha crosses 1/255 exactly
    at the dot radius, giving saturated yellow discs."""
    r = max(float(point_size_px), 0.5)
    if settings.max_splat_radius_px > 0:
        r = min(r, settings.max_splat_radius_px)
    # alpha(d) = 0.99 * exp(-0.5 k d^2) hits 1/255 at d = r
    k = 2.0 * math.log(0.99 * 255.0) / (r * r)
    # constants filled on the device (an upload would wait for it)
    ones = torch.ones_like(attrs.opacity)
    zeros = torch.zeros_like(attrs.opacity)
    return SplatAttrs(
        center_px=attrs.center_px,
        conic=torch.stack([ones * k, zeros, ones * k], dim=-1),
        color=torch.stack([ones, ones, zeros], dim=-1),
        opacity=ones * 0.99,
        # the dot is tested against the gaussian extent box
        extents=torch.clamp(attrs.extents, max=r),
    )


def render_points(scene: GaussianScene, camera: Camera, img_w: int,
                  img_h: int, settings: RenderSettings = DEFAULT_SETTINGS,
                  point_size_px: float = 3.0,
                  gaussian_scaling: float | None = None) -> torch.Tensor:
    """Point-cloud debug mode: yellow dots of ``point_size_px`` within each
    splat's extent box; returns the (H, W, 3) composited image."""
    with trace.span("project"):
        attrs, aux = project_gaussians(scene.params(), scene.alive, camera,
                                       img_w, img_h, scene.sh_deg, settings,
                                       gaussian_scaling=gaussian_scaling)
    point_attrs = pointify_attrs(attrs, point_size_px, settings)
    out, _ = render_from_attrs(point_attrs, aux, img_w, img_h, settings)
    ntx, nty = binning_ops.tile_grid(img_w, img_h, settings)
    tiles = raster_ops.tiles_to_image(out, ntx, nty, img_w, img_h, settings)
    return raster_ops.composite_background(tiles, settings)


def render(scene: GaussianScene, camera: Camera, img_w: int, img_h: int,
           settings: RenderSettings = DEFAULT_SETTINGS,
           entry_capacity: int | None = None,
           gaussian_scaling: float | None = None) -> RenderResult:
    with trace.span("project"):
        attrs, aux = project_gaussians(scene.params(), scene.alive, camera,
                                       img_w, img_h, scene.sh_deg, settings,
                                       gaussian_scaling=gaussian_scaling)
    out, bins = render_from_attrs(attrs, aux, img_w, img_h, settings,
                                  entry_capacity)
    ntx, nty = binning_ops.tile_grid(img_w, img_h, settings)
    img_tiles = raster_ops.tiles_to_image(out, ntx, nty, img_w, img_h,
                                          settings)
    return RenderResult(
        image=raster_ops.composite_background(img_tiles, settings),
        accum=img_tiles[..., 0:4],
        t_final=img_tiles[..., raster_ops.OUT_T],
        n_contrib=img_tiles[..., raster_ops.OUT_NCONTRIB].to(torch.int32),
        aux=aux,
        binning=bins,
    )


def _project_frame(scene: GaussianScene, camera: Camera, img_w: int,
                   img_h: int, settings: RenderSettings,
                   gaussian_scaling: float | None, point_size_px: float,
                   pointcloud: bool) -> tuple[SplatAttrs, SplatAux]:
    """The whole frame's projection, run once per banded frame (and
    pointified in pointcloud mode); the bands only restrict, shift, bin
    and rasterize."""
    with trace.span("project"):
        attrs, aux = project_gaussians(scene.params(), scene.alive, camera,
                                       img_w, img_h, scene.sh_deg, settings,
                                       gaussian_scaling=gaussian_scaling)
    if pointcloud:
        attrs = pointify_attrs(attrs, point_size_px, settings)
    return attrs, aux


def shift_to_band(attrs: SplatAttrs, row0: int | torch.Tensor,
                  settings: RenderSettings) -> SplatAttrs:
    """``attrs`` with the centers in the pixel coordinates of the band
    from tile row ``row0`` (a shift by a whole number of pixels), so the
    raster kernel's tile -> pixel mapping stays band-local."""
    cx, cy = attrs.center_px.unbind(-1)
    return attrs._replace(center_px=torch.stack(
        [cx, cy - row0 * settings.tile_h], dim=-1))


def _render_band(attrs: SplatAttrs, aux: SplatAux, row0: int | torch.Tensor,
                 img_w: int, rows: int, ntx: int, settings: RenderSettings,
                 entry_capacity: int | None):
    """One horizontal band of ``rows`` tile rows from tile row ``row0`` (a
    Python int or a 0-d device tensor).  Returns the band's pixels, the
    (rows * tile_h, img_w, NUM_OUT) channels of ``tiles_to_image`` before
    the background, and its pre-drop entry demand (a device scalar).
    ``entry_capacity=None`` bins at the full heuristic capacity: all of a
    frame's entries may land in one band."""
    band_h = rows * settings.tile_h
    out, bins = render_from_attrs(
        shift_to_band(attrs, row0, settings),
        restrict_aux_to_band(aux, row0, rows), img_w, band_h, settings,
        entry_capacity)
    return (raster_ops.tiles_to_image(out, ntx, rows, img_w, band_h,
                                      settings), bins.expansion_entries)


def render_banded(scene: GaussianScene, camera: Camera, img_w: int,
                  img_h: int, settings: RenderSettings = DEFAULT_SETTINGS,
                  entry_capacity: int | None = None,
                  gaussian_scaling: float | None = None,
                  bands: int | None = None, mode: str = "gaussian",
                  point_size_px: float = 3.0,
                  return_entries: bool = False):
    """Render a frame whose tile grid may exceed the 16-bit tile-key limit
    (``binning.check_tile_key_limit``) as serial horizontal bands of tile
    rows, each under the limit, concatenated and cropped to ``img_h``.

    ``bands=None`` picks the fewest bands (one below the limit, where the
    result is ``render(...).image``, or ``render_points(...)`` in
    ``mode="pointcloud"``).  Returns the (img_h, img_w, 3) image; with
    ``return_entries``, ``(image, entries)``: the largest per-band
    pre-drop entry demand as a device scalar (None for one pointcloud
    band).  Reads nothing back from the device."""
    ntx, nty = binning_ops.tile_grid(img_w, img_h, settings)
    if bands is None:
        rows_max = max((binning_ops.TILE_KEY_LIMIT - 1) // ntx, 1)
        bands = -(-nty // rows_max)
    if bands <= 1:
        if mode == "pointcloud":
            img = render_points(scene, camera, img_w, img_h, settings,
                                point_size_px=point_size_px,
                                gaussian_scaling=gaussian_scaling)
            return (img, None) if return_entries else img
        res = render(scene, camera, img_w, img_h, settings,
                     entry_capacity=entry_capacity,
                     gaussian_scaling=gaussian_scaling)
        if return_entries:
            return res.image, res.binning.expansion_entries
        return res.image
    rows = -(-nty // bands)
    binning_ops.check_tile_key_limit(ntx * rows)
    attrs, aux = _project_frame(scene, camera, img_w, img_h, settings,
                                gaussian_scaling, point_size_px,
                                pointcloud=(mode == "pointcloud"))
    parts, entries = [], []
    for b in range(bands):
        tiles_b, ent_b = _render_band(attrs, aux, b * rows, img_w, rows,
                                      ntx, settings, entry_capacity)
        parts.append(tiles_b)
        entries.append(ent_b)
    image = raster_ops.composite_background(
        torch.cat(parts, dim=0)[:img_h], settings)
    if return_entries:
        return image, torch.stack(entries).max()
    return image


# eager execution needs no compiled variant: the reference's name for its
# jitted entry point is the plain function here
render_compiled = render
