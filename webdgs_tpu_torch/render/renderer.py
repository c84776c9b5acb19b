"""Full forward render: scene + camera -> image (counterpart of
webdgs_tpu/render/renderer.py:27-135); ``render_from_attrs(for_grad=True)``
is the training step's differentiable render.

project -> bin (expand kernel) -> pack -> rasterize (forward kernel) ->
image.  PyTorch runs eagerly, so there is no jit: ``render_compiled`` is
``render`` itself.  Frames whose tile grid reaches the 16-bit tile-key
limit need the reference's serial-band renderer, which is not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from webdgs_tpu_torch.config import DEFAULT_SETTINGS, RenderSettings
from webdgs_tpu_torch.core.camera import Camera
from webdgs_tpu_torch.core.scene import GaussianScene
from webdgs_tpu_torch.ops import binning as binning_ops
from webdgs_tpu_torch.ops import rasterize as raster_ops
from webdgs_tpu_torch.ops.projection import (SplatAttrs, SplatAux,
                                             project_gaussians)


class RenderResult(NamedTuple):
    image: torch.Tensor  # (H, W, 3) with background composited
    accum: torch.Tensor  # (H, W, 4) raw [r,g,b,accum_alpha] before bg
    t_final: torch.Tensor  # (H, W) final transmittance
    n_contrib: torch.Tensor  # (H, W) i32 last contributor per pixel
    aux: SplatAux
    binning: binning_ops.Binning


def check_frame_supported(img_w: int, img_h: int,
                          settings: RenderSettings) -> None:
    """Raise NotImplementedError for frames at or above the tile-key limit
    (the reference renders those in serial bands, ``render_banded``)."""
    ntx, nty = binning_ops.tile_grid(img_w, img_h, settings)
    if ntx * nty >= binning_ops.TILE_KEY_LIMIT:
        raise NotImplementedError(
            f"a {img_w}x{img_h} frame has {ntx * nty} tiles, at or above "
            f"the 16-bit tile-key limit ({binning_ops.TILE_KEY_LIMIT}); the "
            "serial-band renderer (render_banded) is not yet ported")


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
    bins = binning_ops.bin_splats(aux, img_w, img_h, settings,
                                  capacity=entry_capacity,
                                  with_source=for_grad, attrs=attrs)
    attrs16 = raster_ops.pack_entry_attrs(
        attrs, bins.entry_gauss, bins.entry_valid,
        entry_source=bins.entry_source, gauss_counts=bins.gauss_counts)
    out = raster_ops.rasterize_tiles(attrs16, bins.tile_offsets, ntx, nty,
                                     settings, track_ncontrib=not for_grad)
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
    n = attrs.opacity.shape[0]
    dev = attrs.opacity.device
    return SplatAttrs(
        center_px=attrs.center_px,
        conic=torch.tensor([k, 0.0, k], dtype=torch.float32,
                           device=dev).expand(n, 3),
        color=torch.tensor([1.0, 1.0, 0.0], dtype=torch.float32,
                           device=dev).expand(n, 3),
        opacity=torch.full((n,), 0.99, dtype=torch.float32, device=dev),
        # the dot is tested against the gaussian extent box
        extents=torch.clamp(attrs.extents, max=r),
    )


def render_points(scene: GaussianScene, camera: Camera, img_w: int,
                  img_h: int, settings: RenderSettings = DEFAULT_SETTINGS,
                  point_size_px: float = 3.0,
                  gaussian_scaling: float | None = None) -> torch.Tensor:
    """Point-cloud debug mode: yellow dots of ``point_size_px`` within each
    splat's extent box; returns the (H, W, 3) composited image."""
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


# eager execution needs no compiled variant: the reference's name for its
# jitted entry point is the plain function here
render_compiled = render
