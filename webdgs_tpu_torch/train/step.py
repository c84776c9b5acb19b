"""The training step: forward render, loss cotangent, two-stage VJP, Adam
update (counterpart of webdgs_tpu/train/step.py:45-168).

The gradient flows in two stages, as in the reference:
1. the render's VJP with respect to the projected ``SplatAttrs`` (made
   detached leaves that require grad), through the rasterizer's backward
   kernel and the per-Gaussian segment sum;
2. ``torch.autograd.grad`` of the projection at those cotangents.
Stage 1 is needed because, with ``detach_color`` (DC-only SH), the colour
has no path to the parameters, yet the raw dL/dcolor is routed into the SH
DC coefficient (``_apply_grad_parity``).  Frames of at least 5x5 take the
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
from webdgs_tpu_torch.ops.projection import SplatAttrs, project_gaussians
from webdgs_tpu_torch.ops.tile_loss import (supports_tile_loss,
                                            tile_loss_gradient)
from webdgs_tpu_torch.render.renderer import render_from_attrs


class TrainStepResult(NamedTuple):
    scene: GaussianScene
    opt_state: AdamState
    metrics: dict[str, torch.Tensor]


def _project(scene, camera, img_w, img_h, settings, parity_sh):
    """Stage-2 graph: parameter leaves -> SplatAttrs, plus stage-1 leaves
    (detached copies of the attributes that require grad)."""
    with trace.span("project"):
        params = {k: v.detach().requires_grad_(True)
                  for k, v in scene.params().items()}
        attrs, aux = project_gaussians(params, scene.alive, camera, img_w,
                                       img_h, scene.sh_deg, settings,
                                       detach_color=parity_sh)
        leaves = SplatAttrs(*(a.detach().requires_grad_(True)
                              for a in attrs))
    return params, attrs, leaves, aux


def _vjp(outputs, inputs, cotangent):
    """Cotangents of ``inputs`` (zeros where unused) for one output: the
    backward raster kernel and the segment sum, run by autograd."""
    with trace.span("backward"):
        grads = torch.autograd.grad(outputs, inputs, grad_outputs=cotangent,
                                    allow_unused=True)
        return [torch.zeros_like(x) if g is None else g
                for x, g in zip(inputs, grads)]


def _param_grads(params, attrs, d_attrs):
    """Stage 2: the projection's VJP at the attribute cotangents."""
    pairs = [(a, d) for a, d in zip(attrs, d_attrs) if a.requires_grad]
    names = list(params)
    grads = torch.autograd.grad([a for a, _ in pairs], [params[k]
                                                        for k in names],
                                grad_outputs=[d for _, d in pairs],
                                allow_unused=True)
    return {k: torch.zeros_like(params[k]) if g is None else g
            for k, g in zip(names, grads)}


def _apply_grad_parity(d_params, d_attrs, aux, params, parity_sh):
    """The SH routing and the screen-radius-cap guard, shared by both loss
    paths."""
    if parity_sh:
        # raw dL/dcolor straight into the DC coefficient
        d_sh = torch.zeros_like(params["sh"])
        d_sh[:, 0, :] = d_attrs.color
        d_params = {**d_params, "sh": d_sh}
    g_ls = d_params["log_scales"]
    return {**d_params, "log_scales": torch.where(
        aux.radius_capped[:, None], torch.clamp(g_ls, min=0.0), g_ls)}


def _project_vjp(params, attrs, d_attrs, aux, parity_sh):
    """Stage 2 and the gradient routing: the parameters' gradients."""
    with trace.span("project_vjp"):
        d_params = _param_grads(params, attrs, d_attrs)
        return _apply_grad_parity(d_params, d_attrs, aux, params, parity_sh)


def compute_param_grads(scene: GaussianScene, camera: Camera,
                        target: torch.Tensor, img_w: int, img_h: int,
                        loss_cfg: LossConfig, settings: RenderSettings,
                        parity_sh: bool, entry_capacity: int | None = None):
    """Image-space loss path.  Returns (image, param grads dict, aux,
    entry_demand) -- the last is the binning's pre-drop entry demand."""
    params, attrs, leaves, aux = _project(scene, camera, img_w, img_h,
                                          settings, parity_sh)
    ntx, nty = binning_ops.tile_grid(img_w, img_h, settings)
    out, bins = render_from_attrs(leaves, aux, img_w, img_h, settings,
                                  entry_capacity, for_grad=True)
    tiles = raster_ops.tiles_to_image(out, ntx, nty, img_w, img_h, settings)
    image = raster_ops.composite_background(tiles, settings)
    with trace.span("loss"):
        pgrad = pixel_loss_gradient(image.detach(), target, loss_cfg)
    d_attrs = SplatAttrs(*_vjp(image, list(leaves), pgrad))
    d_params = _project_vjp(params, attrs, d_attrs, aux, parity_sh)
    return image.detach(), d_params, aux, bins.expansion_entries


def compute_param_grads_tiled(scene: GaussianScene, camera: Camera,
                              target: torch.Tensor, img_w: int, img_h: int,
                              loss_cfg: LossConfig,
                              settings: RenderSettings, parity_sh: bool,
                              entry_capacity: int | None = None):
    """Tile-loss path: the loss cotangent is computed on the rasterizer's
    tile buffer.  Returns (metrics, param grads dict, aux, entry_demand)."""
    params, attrs, leaves, aux = _project(scene, camera, img_w, img_h,
                                          settings, parity_sh)
    ntx, nty = binning_ops.tile_grid(img_w, img_h, settings)
    out, bins = render_from_attrs(leaves, aux, img_w, img_h, settings,
                                  entry_capacity, for_grad=True)
    with trace.span("loss"):
        dpix, metrics = tile_loss_gradient(out.detach(), target, img_w,
                                           img_h, ntx, nty, loss_cfg,
                                           settings)
    d_attrs = SplatAttrs(*_vjp(out, list(leaves), dpix))
    d_params = _project_vjp(params, attrs, d_attrs, aux, parity_sh)
    return metrics, d_params, aux, bins.expansion_entries


def train_step(scene: GaussianScene, opt_state: AdamState, camera: Camera,
               target: torch.Tensor, *, img_w: int, img_h: int,
               loss_cfg: LossConfig = LossConfig(),
               hp: AdamHyperparameters = AdamHyperparameters(),
               settings: RenderSettings = DEFAULT_SETTINGS,
               entry_capacity: int | None = None) -> TrainStepResult:
    """One iteration on ``target`` (H, W, 3) f32 seen from ``camera``.
    Metrics: l1 l2 dssim loss psnr visible tile_entries (device
    scalars)."""
    if supports_tile_loss(img_w, img_h, settings):
        metrics, d_params, aux, entry_demand = compute_param_grads_tiled(
            scene, camera, target, img_w, img_h, loss_cfg, settings,
            parity_sh=not hp.full_sh, entry_capacity=entry_capacity)
    else:
        image, d_params, aux, entry_demand = compute_param_grads(
            scene, camera, target, img_w, img_h, loss_cfg, settings,
            parity_sh=not hp.full_sh, entry_capacity=entry_capacity)
        with trace.span("loss"):
            metrics = loss_metrics(image, target, loss_cfg)

    with torch.no_grad(), trace.span("adam"):
        new_params, new_opt = adam_step(scene.params(), d_params, opt_state,
                                        hp, aux.num_tiles)
    metrics["visible"] = aux.visible.sum(dtype=torch.int32)
    metrics["tile_entries"] = entry_demand
    return TrainStepResult(scene=scene.with_params(new_params),
                           opt_state=new_opt, metrics=metrics)
