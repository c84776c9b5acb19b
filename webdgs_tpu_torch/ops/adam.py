"""Per-group Adam with visibility gating, the reference's optimizer
(counterpart of webdgs_tpu/ops/adam.py:38-181).

In its default mode:
* classic Adam WITHOUT bias correction, no learning-rate schedule;
* per-group learning rates, one per lane of the packed row;
* visibility gating: a Gaussian whose ``tile_counts`` is zero is skipped
  entirely -- parameters AND moments stay frozen;
* the quaternion is renormalised after its update;
* SH: only the DC coefficient is trained, with lr_color on the raw
  dL/dcolor; the other bands stay frozen.
Options: ``bias_correction``, ``full_sh`` (every band trained, the rest
bands at ``sh_rest_lr_scale``), and the exponential position-lr decay
``lr_pos_final``.

The moments are stored as packed (N, 59) rows in ``PACK_LAYOUT`` order,
which is also the checkpoint format (``io/checkpoint.py``).  Plain torch,
out of place: no kernel backs this step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamHyperparameters:
    """The reference's per-group learning rates and Adam constants."""

    lr_pos: float = 0.00016
    lr_color: float = 0.0025
    lr_opacity: float = 0.05
    lr_scale: float = 0.005
    lr_rot: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    bias_correction: bool = False
    full_sh: bool = False
    sh_rest_lr_scale: float = 0.05
    # optional exponential position-lr decay; 0 disables
    lr_pos_final: float = 0.0
    lr_pos_decay_steps: int = 30_000

    def group_lrs(self) -> dict[str, float]:
        return {
            "means": self.lr_pos,
            "quats": self.lr_rot,
            "log_scales": self.lr_scale,
            "opacity_logits": self.lr_opacity,
            "sh": self.lr_color,
        }


# name -> (lane_lo, lane_hi, per-point shape suffix)
PACK_LAYOUT = (
    ("means", 0, 3, (3,)),
    ("quats", 3, 7, (4,)),
    ("log_scales", 7, 10, (3,)),
    ("opacity_logits", 10, 11, ()),
    ("sh", 11, 59, (16, 3)),
)
PACK_DIM = 59
_QUAT_LANES = (3, 7)
_SH_LANES = (11, 59)
_SH_DC_LANES = (11, 14)


def pack_rows(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """Parameter dict -> one (N, 59) row-packed tensor."""
    n = tree["means"].shape[0]
    return torch.cat([tree[k].reshape(n, hi - lo)
                      for k, lo, hi, _ in PACK_LAYOUT], dim=1)


def unpack_rows(arr: torch.Tensor) -> dict[str, torch.Tensor]:
    """(N, 59) row-packed tensor -> parameter dict (contiguous copies)."""
    n = arr.shape[0]
    return {k: arr[:, lo:hi].reshape((n,) + suffix).contiguous()
            for k, lo, hi, suffix in PACK_LAYOUT}


@dataclasses.dataclass
class AdamState:
    m: torch.Tensor  # (N, 59) f32, rows in PACK_LAYOUT order
    v: torch.Tensor  # (N, 59) f32
    iteration: int = 0

    def to(self, device: str | torch.device) -> "AdamState":
        return AdamState(self.m.to(device), self.v.to(device),
                         self.iteration)

    def pad_to(self, capacity: int) -> "AdamState":
        """Grow the rows with zero moments."""
        pad = capacity - self.m.shape[0]
        if pad <= 0:
            return self
        z = torch.zeros((pad, PACK_DIM), dtype=torch.float32,
                        device=self.m.device)
        return AdamState(torch.cat([self.m, z]), torch.cat([self.v, z]),
                         self.iteration)


def init_adam_state(params: dict[str, torch.Tensor]) -> AdamState:
    n = params["means"].shape[0]
    dev = params["means"].device
    return AdamState(
        m=torch.zeros((n, PACK_DIM), dtype=torch.float32, device=dev),
        v=torch.zeros((n, PACK_DIM), dtype=torch.float32, device=dev),
        iteration=0)


def _lane_lrs(hp: AdamHyperparameters) -> np.ndarray:
    """Per-lane learning rates, float32."""
    lr = np.zeros((PACK_DIM,), np.float32)
    lrs = hp.group_lrs()
    for key, lo, hi, _ in PACK_LAYOUT:
        lr[lo:hi] = lrs[key]
    if hp.full_sh:
        lr[_SH_DC_LANES[1]:_SH_LANES[1]] *= hp.sh_rest_lr_scale
    else:
        lr[_SH_DC_LANES[1]:_SH_LANES[1]] = 0.0  # DC only; f_rest frozen
    return lr


def adam_step(params: dict[str, torch.Tensor],
              grads: dict[str, torch.Tensor], state: AdamState,
              hp: AdamHyperparameters, tile_counts: torch.Tensor
              ) -> tuple[dict[str, torch.Tensor], AdamState]:
    """One update; ``tile_counts`` (N,) i32, 0 = invisible this step."""
    dev = state.m.device
    visible = tile_counts > 0
    it = state.iteration + 1

    lane = np.arange(PACK_DIM)
    lr_np = _lane_lrs(hp)
    if hp.lr_pos_final > 0.0:
        frac = np.clip(np.float32(it) / np.float32(hp.lr_pos_decay_steps),
                       0.0, 1.0).astype(np.float32)
        ratio = np.float32(hp.lr_pos_final / hp.lr_pos)
        lr_pos = np.float32(hp.lr_pos) * ratio ** frac
        lr_np = np.where(lane < 3, lr_pos, lr_np).astype(np.float32)
    lr_vec = torch.tensor(lr_np, device=dev)[None, :]

    if hp.bias_correction:
        t = np.float32(it)
        corr1 = float(np.float32(1.0) - np.float32(hp.beta1) ** t)
        corr2 = float(np.float32(1.0) - np.float32(hp.beta2) ** t)
    else:
        corr1 = corr2 = 1.0

    p = pack_rows(params)
    g = pack_rows(grads)
    if not hp.full_sh:
        # non-DC SH gradients never touch the moments either
        keep = torch.tensor((lane < _SH_DC_LANES[1]) | (lane >= _SH_LANES[1]),
                            dtype=torch.float32, device=dev)
        g = g * keep[None, :]
    m, v = state.m, state.v

    mask = visible[:, None]
    m_new = hp.beta1 * m + (1.0 - hp.beta1) * g
    v_new = hp.beta2 * v + (1.0 - hp.beta2) * g * g
    step = -lr_vec * (m_new / corr1) / (torch.sqrt(v_new / corr2)
                                        + hp.epsilon)
    p_new = p + step

    # quaternion renorm, lanes 3:7 only
    q_lane = torch.tensor((lane >= _QUAT_LANES[0]) & (lane < _QUAT_LANES[1]),
                          device=dev)[None, :]
    qn = torch.sqrt(torch.clamp(
        torch.sum(torch.where(q_lane, p_new * p_new, 0.0), dim=1,
                  keepdim=True), min=1e-24))
    p_new = p_new * torch.where(q_lane, 1.0 / qn, 1.0)

    new_params = unpack_rows(torch.where(mask, p_new, p))
    return new_params, AdamState(m=torch.where(mask, m_new, m),
                                 v=torch.where(mask, v_new, v),
                                 iteration=it)
