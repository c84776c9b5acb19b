"""The training step: forward render, loss cotangent, staged VJP, Adam
update (counterpart of webdgs_tpu/train/step.py:45-168).

The gradient flows in stages, as in the reference:
1. the render's VJP with respect to the projected ``SplatAttrs`` (made
   detached leaves that require grad), through the rasterizer's backward
   kernel and the per-Gaussian segment sum;
2. the SH colour's VJP (span ``sh_vjp``): with full SH, autograd of the
   colour stage, evaluated from the coefficients and from direction
   leaves of its own, gives the coefficients' gradient and the
   directions' cotangents; with DC only the colour has no path to the
   parameters, and the raw dL/dcolor is routed into the DC coefficient;
3. ``torch.autograd.grad`` of the geometric projection at the attribute
   and direction cotangents (span ``project_vjp``).
Stage 1 is needed for that routing.  Frames of at least 5x5 take the
tile-loss kernel; smaller ones the image-space loss.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from webdgs_tpu_torch import trace
from webdgs_tpu_torch.config import DEFAULT_SETTINGS, RenderSettings
from webdgs_tpu_torch.core.camera import Camera
from webdgs_tpu_torch.core.scene import GaussianScene
from webdgs_tpu_torch.ops import binning as binning_ops
from webdgs_tpu_torch.ops import rasterize as raster_ops
from webdgs_tpu_torch.ops.adam import AdamHyperparameters, AdamState, adam_step
from webdgs_tpu_torch.ops.loss import (LossConfig, loss_metrics,
                                       pixel_loss_gradient)
from webdgs_tpu_torch.ops.projection import (SplatAttrs, project_geometry,
                                             sh_color)
from webdgs_tpu_torch.ops.tile_loss import (supports_tile_loss,
                                            tile_loss_gradient)
from webdgs_tpu_torch.render.renderer import render_from_attrs


class TrainStepResult(NamedTuple):
    scene: GaussianScene
    opt_state: AdamState
    metrics: dict[str, torch.Tensor]


# the attributes the geometric projection produces; the colour is the SH
# stage's
_GEOMETRY = ("center_px", "conic", "opacity", "extents")


class ColorStage(NamedTuple):
    """The full-SH colour's inputs held apart from the geometry graph: the
    direction rows the geometry produced, and the leaves the colour was
    evaluated from (the coefficients are the ``sh`` parameter leaf)."""

    dirs: tuple[torch.Tensor, ...]
    dir_leaves: tuple[torch.Tensor, ...]


def _project(scene, camera, img_w, img_h, settings, parity_sh):
    """Stage-2 and stage-3 graphs: parameter leaves -> the geometric
    attributes and the view directions, and the colour from the SH leaf
    and direction leaves of its own (DC only: detached); plus the stage-1
    leaves (detached copies of the attributes that require grad) and the
    colour's :class:`ColorStage` (None with DC only)."""
    with trace.span("project"):
        params = {k: v.detach().requires_grad_(True)
                  for k, v in scene.params().items()}
        geo, aux, dirs = project_geometry(params, scene.alive, camera,
                                          img_w, img_h, settings)
        if parity_sh:
            stage = None
            color = sh_color(params["sh"].detach(),
                             tuple(d.detach() for d in dirs), scene.sh_deg)
        else:
            stage = ColorStage(dirs, tuple(d.detach().requires_grad_(True)
                                           for d in dirs))
            color = sh_color(params["sh"], stage.dir_leaves, scene.sh_deg)
        attrs = geo._replace(color=color)
        leaves = SplatAttrs(*(a.detach().requires_grad_(True)
                              for a in attrs))
    return params, attrs, leaves, aux, stage


def _vjp(outputs, inputs, cotangent):
    """Cotangents of ``inputs`` (zeros where unused) for one output: the
    backward raster kernel and the segment sum, run by autograd."""
    with trace.span("backward"):
        grads = torch.autograd.grad(outputs, inputs, grad_outputs=cotangent,
                                    allow_unused=True)
        return [torch.zeros_like(x) if g is None else g
                for x, g in zip(inputs, grads)]


def _sh_vjp(params, attrs, d_attrs, stage):
    """Stage 2: the coefficients' gradient and (direction row, cotangent)
    pairs for stage 3.  DC only: the raw dL/dcolor into the DC
    coefficient, and no pairs."""
    if stage is None:
        d_sh = torch.zeros_like(params["sh"])
        d_sh[:, 0, :] = d_attrs.color
        return d_sh, []
    d_sh, *d_dirs = torch.autograd.grad(
        attrs.color, [params["sh"], *stage.dir_leaves],
        grad_outputs=d_attrs.color, allow_unused=True)
    # the stack of the colour's planar rows is (N, 16, 3) transposed; Adam
    # packs rows.  sh_deg 0 reads no direction
    return d_sh.contiguous(), [(d, g) for d, g in zip(stage.dirs, d_dirs)
                               if g is not None]


def _param_grads(params, attrs, d_attrs, dir_pairs):
    """Stage 3: the geometric projection's VJP at the attribute cotangents
    and the directions' cotangents, for every parameter but the SH
    coefficients, which the geometry does not read."""
    pairs = [(getattr(attrs, k), getattr(d_attrs, k))
             for k in _GEOMETRY] + dir_pairs
    names = [k for k in params if k != "sh"]
    grads = torch.autograd.grad([a for a, _ in pairs], [params[k]
                                                        for k in names],
                                grad_outputs=[d for _, d in pairs],
                                allow_unused=True)
    return {k: torch.zeros_like(params[k]) if g is None else g
            for k, g in zip(names, grads)}


def _project_vjp(params, attrs, d_attrs, aux, stage):
    """Stages 2 and 3 and the screen-radius-cap guard, shared by both loss
    paths: the parameters' gradients."""
    with trace.span("sh_vjp"):
        d_sh, dir_pairs = _sh_vjp(params, attrs, d_attrs, stage)
    with trace.span("project_vjp"):
        d_params = _param_grads(params, attrs, d_attrs, dir_pairs)
        g_ls = d_params["log_scales"]
        d_params["log_scales"] = torch.where(
            aux.radius_capped[:, None], torch.clamp(g_ls, min=0.0), g_ls)
        d_params["sh"] = d_sh
        return d_params


def compute_param_grads(scene: GaussianScene, camera: Camera,
                        target: torch.Tensor, img_w: int, img_h: int,
                        loss_cfg: LossConfig, settings: RenderSettings,
                        parity_sh: bool, entry_capacity: int | None = None):
    """Image-space loss path.  Returns (image, param grads dict, aux,
    entry_demand) -- the last is the binning's pre-drop entry demand."""
    params, attrs, leaves, aux, stage = _project(scene, camera, img_w,
                                                 img_h, settings, parity_sh)
    ntx, nty = binning_ops.tile_grid(img_w, img_h, settings)
    out, bins = render_from_attrs(leaves, aux, img_w, img_h, settings,
                                  entry_capacity, for_grad=True)
    tiles = raster_ops.tiles_to_image(out, ntx, nty, img_w, img_h, settings)
    image = raster_ops.composite_background(tiles, settings)
    with trace.span("loss"):
        pgrad = pixel_loss_gradient(image.detach(), target, loss_cfg)
    d_attrs = SplatAttrs(*_vjp(image, list(leaves), pgrad))
    d_params = _project_vjp(params, attrs, d_attrs, aux, stage)
    return image.detach(), d_params, aux, bins.expansion_entries


def compute_param_grads_tiled(scene: GaussianScene, camera: Camera,
                              target: torch.Tensor, img_w: int, img_h: int,
                              loss_cfg: LossConfig,
                              settings: RenderSettings, parity_sh: bool,
                              entry_capacity: int | None = None):
    """Tile-loss path: the loss cotangent is computed on the rasterizer's
    tile buffer.  Returns (metrics, param grads dict, aux, entry_demand)."""
    params, attrs, leaves, aux, stage = _project(scene, camera, img_w,
                                                 img_h, settings, parity_sh)
    ntx, nty = binning_ops.tile_grid(img_w, img_h, settings)
    out, bins = render_from_attrs(leaves, aux, img_w, img_h, settings,
                                  entry_capacity, for_grad=True)
    with trace.span("loss"):
        dpix, metrics = tile_loss_gradient(out.detach(), target, img_w,
                                           img_h, ntx, nty, loss_cfg,
                                           settings)
    d_attrs = SplatAttrs(*_vjp(out, list(leaves), dpix))
    d_params = _project_vjp(params, attrs, d_attrs, aux, stage)
    return metrics, d_params, aux, bins.expansion_entries


def view_grads(scene: GaussianScene, camera: Camera, target: torch.Tensor,
               img_w: int, img_h: int, loss_cfg: LossConfig,
               settings: RenderSettings, hp: AdamHyperparameters,
               entry_capacity: int | None = None):
    """One view's (metrics, param grads dict, aux, entry_demand): the
    tile-loss path where the frame supports it, else the image-space loss;
    ``hp.full_sh`` decides whether the SH colour is trained."""
    if supports_tile_loss(img_w, img_h, settings):
        return compute_param_grads_tiled(
            scene, camera, target, img_w, img_h, loss_cfg, settings,
            parity_sh=not hp.full_sh, entry_capacity=entry_capacity)
    image, *grads = compute_param_grads(
        scene, camera, target, img_w, img_h, loss_cfg, settings,
        parity_sh=not hp.full_sh, entry_capacity=entry_capacity)
    with trace.span("loss"):
        return (loss_metrics(image, target, loss_cfg), *grads)


def train_step(scene: GaussianScene, opt_state: AdamState, camera: Camera,
               target: torch.Tensor, *, img_w: int, img_h: int,
               loss_cfg: LossConfig = LossConfig(),
               hp: AdamHyperparameters = AdamHyperparameters(),
               settings: RenderSettings = DEFAULT_SETTINGS,
               entry_capacity: int | None = None) -> TrainStepResult:
    """One iteration on ``target`` (H, W, 3) f32 seen from ``camera``.
    Metrics: l1 l2 dssim loss psnr visible tile_entries (device
    scalars)."""
    metrics, d_params, aux, entry_demand = view_grads(
        scene, camera, target, img_w, img_h, loss_cfg, settings, hp,
        entry_capacity)
    with torch.no_grad(), trace.span("adam"):
        new_params, new_opt = adam_step(scene.params(), d_params, opt_state,
                                        hp, aux.num_tiles)
    metrics["visible"] = aux.visible.sum(dtype=torch.int32)
    metrics["tile_entries"] = entry_demand
    return TrainStepResult(scene=scene.with_params(new_params),
                           opt_state=new_opt, metrics=metrics)
