"""The Gaussian scene (counterpart of webdgs_tpu/core/scene.py:35-137).

A dataclass of float32 tensors on one device, with the reference's fields
and parameterisation: ``quats`` (w, x, y, z), not necessarily normalised;
``log_scales`` in log space; ``opacity_logits`` in logit space; ``sh``
(N, 16, 3), DC first.  Dead capacity slots have ``alive == False`` and are
culled in projection.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

SH_C0 = 0.28209479177387814

PARAM_NAMES = ("means", "quats", "log_scales", "opacity_logits", "sh")


@dataclasses.dataclass
class GaussianScene:
    means: torch.Tensor  # (N, 3) f32
    quats: torch.Tensor  # (N, 4) f32, (w, x, y, z)
    log_scales: torch.Tensor  # (N, 3) f32
    opacity_logits: torch.Tensor  # (N,) f32
    sh: torch.Tensor  # (N, 16, 3) f32
    alive: torch.Tensor  # (N,) bool
    sh_deg: int = 0

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def device(self) -> torch.device:
        return self.means.device

    def num_alive(self) -> torch.Tensor:
        return self.alive.sum(dtype=torch.int32)

    def to(self, device: str | torch.device) -> "GaussianScene":
        return dataclasses.replace(
            self, alive=self.alive.to(device),
            **{k: v.to(device) for k, v in self.params().items()})

    def pad_to(self, capacity: int) -> "GaussianScene":
        """Grow the capacity, with dead padding slots."""
        n = self.capacity
        if capacity < n:
            raise ValueError(f"cannot shrink capacity {n} -> {capacity}")
        if capacity == n:
            return self

        def pad(x):
            z = torch.zeros((capacity - n,) + tuple(x.shape[1:]),
                            dtype=x.dtype, device=x.device)
            return torch.cat([x, z])

        return dataclasses.replace(
            self, alive=pad(self.alive),
            **{k: pad(v) for k, v in self.params().items()})

    def params(self) -> dict[str, torch.Tensor]:
        """The trainable-parameter subset."""
        return {k: getattr(self, k) for k in PARAM_NAMES}

    def with_params(self, params: dict[str, torch.Tensor]) -> "GaussianScene":
        return dataclasses.replace(self, **{k: params[k] for k in PARAM_NAMES})


def scene_from_numpy(params: dict[str, np.ndarray], alive: np.ndarray,
                     sh_deg: int, device: str | torch.device) -> GaussianScene:
    """Weight carry-over: a scene from numpy copies of the reference's
    parameter arrays (``{k: np.asarray(v) for k, v in
    jax_scene.params().items()}``), computing the same thing."""
    missing = set(PARAM_NAMES) - set(params)
    if missing:
        raise ValueError(f"missing scene parameters: {sorted(missing)}")

    def dev(a, dtype):
        return torch.tensor(a, dtype=dtype, device=device)  # copies

    return GaussianScene(
        alive=dev(np.asarray(alive, bool), torch.bool),
        sh_deg=int(sh_deg),
        **{k: dev(np.asarray(params[k], np.float32), torch.float32)
           for k in PARAM_NAMES})


def scene_from_arrays(
    means: np.ndarray,
    quats: np.ndarray | None = None,
    log_scales: np.ndarray | None = None,
    opacity_logits: np.ndarray | None = None,
    sh: np.ndarray | None = None,
    colors: np.ndarray | None = None,
    sh_deg: int = 0,
    capacity: int | None = None,
    *,
    device: str | torch.device,
) -> GaussianScene:
    """Build a scene, filling the point-cloud defaults of the reference:
    opacity_logit 1, quat (1,0,0,0), log_scale -5 and SH DC = (c-0.5)/C0."""
    means = np.asarray(means, dtype=np.float32)
    n = means.shape[0]
    if quats is None:
        quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    if log_scales is None:
        log_scales = np.full((n, 3), -5.0, dtype=np.float32)
    if opacity_logits is None:
        opacity_logits = np.full((n,), 1.0, dtype=np.float32)
    if sh is None:
        sh = np.zeros((n, 16, 3), dtype=np.float32)
        if colors is not None:
            sh[:, 0, :] = (np.asarray(colors, np.float32) - 0.5) / SH_C0
    params = {"means": means, "quats": quats, "log_scales": log_scales,
              "opacity_logits": opacity_logits, "sh": sh}
    scene = scene_from_numpy(params, np.ones((n,), bool), sh_deg, device)
    if capacity is not None and capacity > n:
        scene = scene.pad_to(capacity)
    return scene
