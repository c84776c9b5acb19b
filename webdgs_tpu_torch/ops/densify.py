"""Densify / prune at fixed capacity (counterpart of
webdgs_tpu/ops/densify.py).

The scene is capacity-padded with an alive mask, so an event is a
vectorised decide, a cumsum, one ``repeat_interleave`` expansion and masked
gathers per parameter: no reallocation.

Decision rules, per alive Gaussian:
  * prune  (count 0) if sigmoid(opacity) < prune_opacity
  * split  (count 2) if importance >= clone_threshold_count and
           max 3D scale >= split_scale_threshold
  * clone  (count 2) if importance >= clone_threshold_count otherwise
  * keep   (count 1) else

Transform rules (the reference's, quirks included):
  * every surviving point clamps opacity to sigmoid <= 0.8 (raw logit
    ``OPACITY_MAX_RAW``);
  * clone slot 1 jitters its position by the quat-rotated
    0.25 * sigma * U(-1, 1)^3;
  * split emits two children at +- the quat-rotated 0.5 * sigma * N(0, 1)^3
    (the same draw for both; slot 0 gets +) and divides the scale by 1.6;
    sigma uses the log-scale clamped to [-10, 10];
  * Adam moments reset for new slots (clone slot 1, both split slots); the
    opacity moments reset for EVERY surviving point.

The output is capped at min(capacity, alive + max_new_points_per_step);
a clone or split clipped to one slot at the boundary degrades to keep.
Plain torch: no kernel backs this event.  The random rows come from an
explicit ``torch.Generator`` (:func:`densify_rng`); the tests inject numpy
noise instead, because ``jax.random`` cannot be reproduced in torch.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from webdgs_tpu_torch.core.scene import GaussianScene
from webdgs_tpu_torch.ops.adam import PACK_DIM, AdamState
from webdgs_tpu_torch.train.config import DensifyPruneConfig

OPACITY_MAX = 0.8
OPACITY_MAX_RAW = 1.38629436112  # logit(0.8)
LN_1P6 = 0.4700036292457356  # ln(1.6)

ACTION_KEEP, ACTION_CLONE, ACTION_SPLIT, ACTION_PRUNE = 0, 1, 2, 3

# lane of the opacity logit in the packed (N, 59) Adam rows
# (ops/adam.py:PACK_LAYOUT)
_OPACITY_LANE = 10


class DensifyResult(NamedTuple):
    scene: GaussianScene
    opt_state: AdamState
    out_total: torch.Tensor  # () points after the event
    in_alive: torch.Tensor  # () points before the event
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor


def decide(scene: GaussianScene, metric_counts: torch.Tensor,
           cfg: DensifyPruneConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(counts, actions) per slot, int32."""
    opacity = torch.sigmoid(scene.opacity_logits)
    max_scale = torch.exp(scene.log_scales).amax(dim=-1)

    prune = opacity < cfg.prune_opacity
    densify = metric_counts >= cfg.clone_threshold_count
    split = densify & (max_scale >= cfg.split_scale_threshold)

    def full(v):
        return torch.full_like(scene.alive, v, dtype=torch.int32)

    action = torch.where(prune, full(ACTION_PRUNE),
                         torch.where(split, full(ACTION_SPLIT),
                                     torch.where(densify, full(ACTION_CLONE),
                                                 full(ACTION_KEEP))))
    count = torch.where(prune, full(0), torch.where(densify, full(2),
                                                    full(1)))
    # dead slots contribute nothing
    action = torch.where(scene.alive, action, full(ACTION_PRUNE))
    count = torch.where(scene.alive, count, full(0))
    return count, action


def _quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate rows v by the normalised (w, x, y, z) quaternion rows q."""
    norm = torch.sqrt(torch.clamp(torch.sum(q * q, dim=-1, keepdim=True),
                                  min=1e-12))
    qn = q / norm
    s = qn[:, 0:1]
    u = qn[:, 1:4]
    udv = torch.sum(u * v, dim=-1, keepdim=True)
    uu = torch.sum(u * u, dim=-1, keepdim=True)
    return (2.0 * udv * u + (s * s - uu) * v
            + 2.0 * s * torch.linalg.cross(u, v, dim=-1))


def cap_counts(counts: torch.Tensor, actions: torch.Tensor, max_out,
               base_offset=0):
    """Clip counts so the outputs stay under ``max_out``, degrading boundary
    clones/splits to keep.  ``base_offset`` (an int or a 0-d tensor) shifts
    the output offsets: the Gaussian-sharded event passes each shard's
    global output base, so its caps are the single-device event's.
    Returns (counts, actions, total), total the local output count.  Output
    offsets must come from a fresh cumsum of the CLIPPED counts
    (:func:`compact_transform` recomputes them)."""
    offsets = torch.cumsum(counts, 0) - counts
    counts = torch.minimum(torch.clamp(max_out - (offsets + base_offset),
                                       min=0), counts).to(counts.dtype)
    total = counts.sum(dtype=torch.int32)
    degraded = (counts == 1) & ((actions == ACTION_CLONE)
                                | (actions == ACTION_SPLIT))
    actions = torch.where(degraded, torch.full_like(actions, ACTION_KEEP),
                          actions)
    return counts, actions, total


def compact_transform(params: dict[str, torch.Tensor], opt_state: AdamState,
                      counts: torch.Tensor, actions: torch.Tensor,
                      total: torch.Tensor, jitter_u: torch.Tensor,
                      split_d: torch.Tensor):
    """Compaction with expansion plus the transforms.  ``jitter_u`` /
    ``split_d``: (N, 3) random rows per SOURCE slot.  The output capacity
    equals the input's; slots >= ``total`` are dead.

    Returns (new_params, new_opt, valid_out)."""
    n = counts.shape[0]
    dev = counts.device
    counts64 = counts.to(torch.int64)
    offsets = torch.cumsum(counts64, 0) - counts64

    # out slot -> (source, variant); a last dummy source absorbs the
    # n - total dead slots, so the expansion has a known length and never
    # reads the total back to the host
    o_idx = torch.arange(n, dtype=torch.int64, device=dev)
    pad = (n - total.to(torch.int64)).reshape(1)
    src = torch.repeat_interleave(torch.arange(n + 1, device=dev),
                                  torch.cat([counts64, pad]), output_size=n)
    valid_out = o_idx < total
    src = torch.where(valid_out, src, 0)
    variant = o_idx - offsets[src]
    act = actions[src]

    p_src = {k: v[src] for k, v in params.items()}
    jitter_u = jitter_u[src]
    split_d = split_d[src]

    log_sigma = torch.clamp(p_src["log_scales"], -10.0, 10.0)
    sigma = torch.exp(log_sigma)
    quats = p_src["quats"]

    is_clone_child = (act == ACTION_CLONE) & (variant == 1)
    is_split = act == ACTION_SPLIT

    pos = p_src["means"]
    pos = torch.where(is_clone_child[:, None],
                      pos + _quat_rotate(quats, 0.25 * sigma * jitter_u), pos)
    split_sign = torch.where(variant == 1, -1.0, 1.0)[:, None]
    pos = torch.where(is_split[:, None],
                      p_src["means"] + split_sign
                      * _quat_rotate(quats, 0.5 * sigma * split_d), pos)

    log_scales = torch.where(is_split[:, None], log_sigma - LN_1P6,
                             p_src["log_scales"])

    op = p_src["opacity_logits"]
    op = torch.where(torch.sigmoid(op) > OPACITY_MAX,
                     torch.full_like(op, OPACITY_MAX_RAW), op)

    new_params = {
        "means": pos,
        "quats": quats,
        "log_scales": log_scales,
        "opacity_logits": op,
        "sh": p_src["sh"],
    }
    new_params = {k: torch.where(
        valid_out.reshape((-1,) + (1,) * (v.dim() - 1)), v, 0.0)
        for k, v in new_params.items()}

    # Adam moments: one (N, 59) gather, reset for new slots; the opacity
    # lane always resets
    reset = (is_clone_child | is_split | ~valid_out)[:, None]
    lane_keep = (torch.arange(PACK_DIM, device=dev)
                 != _OPACITY_LANE).to(torch.float32)[None, :]

    def move_state(arr):
        return torch.where(reset, 0.0, arr[src]) * lane_keep

    new_opt = AdamState(m=move_state(opt_state.m), v=move_state(opt_state.v),
                        iteration=opt_state.iteration)
    return new_params, new_opt, valid_out


def densify_rng(generator: torch.Generator, n: int):
    """The event's per-source random rows on the generator's device:
    U(-1, 1)^3 clone jitter and N(0, 1)^3 split direction."""
    dev = generator.device
    jitter_u = torch.rand((n, 3), generator=generator, device=dev) * 2.0 \
        - 1.0
    split_d = torch.randn((n, 3), generator=generator, device=dev)
    return jitter_u, split_d


def densify_prune(scene: GaussianScene, opt_state: AdamState,
                  metric_counts: torch.Tensor, cfg: DensifyPruneConfig,
                  generator: torch.Generator) -> DensifyResult:
    """One densify/prune event; reads nothing back to the host."""
    n = scene.capacity
    counts, actions = decide(scene, metric_counts, cfg)
    in_alive = scene.alive.sum(dtype=torch.int32)

    max_out = torch.clamp(in_alive + cfg.max_new_points_per_step, max=n)
    counts, actions, total = cap_counts(counts, actions, max_out)

    jitter_u, split_d = densify_rng(generator, n)
    new_params, new_opt, valid_out = compact_transform(
        scene.params(), opt_state, counts, actions, total, jitter_u, split_d)
    live_src = scene.alive
    return DensifyResult(
        scene=dataclasses.replace(scene.with_params(new_params),
                                  alive=valid_out),
        opt_state=new_opt,
        out_total=total,
        in_alive=in_alive,
        n_cloned=((actions == ACTION_CLONE) & live_src).sum(),
        n_split=((actions == ACTION_SPLIT) & live_src).sum(),
        n_pruned=((actions == ACTION_PRUNE) & live_src).sum(),
    )
