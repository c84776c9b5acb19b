"""Checkpoint / resume (counterpart of webdgs_tpu/io/checkpoint.py:24-77).

A checkpoint is one ``.npz`` with the scene parameters, the alive mask,
the packed (N, 59) Adam moments and the iteration counter, in the format
of the JAX package (version 2; version-1 files with per-leaf moments are
packed on load), so a checkpoint written by either package loads in the
other.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from webdgs_tpu_torch.core.scene import GaussianScene, scene_from_numpy
from webdgs_tpu_torch.ops.adam import PACK_LAYOUT, AdamState

FORMAT_VERSION = 2


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_checkpoint(path: str | os.PathLike, scene: GaussianScene,
                    opt_state: AdamState | None = None,
                    iteration: int | None = None,
                    extra: dict | None = None) -> None:
    arrays = {k: _np(v) for k, v in scene.params().items()}
    arrays["alive"] = _np(scene.alive)
    meta = {"version": FORMAT_VERSION, "sh_deg": scene.sh_deg,
            "iteration": iteration, "extra": extra or {}}
    if opt_state is not None:
        arrays["adam_m_packed"] = _np(opt_state.m)
        arrays["adam_v_packed"] = _np(opt_state.v)
        meta["adam_iteration"] = int(opt_state.iteration)
    arrays["_meta"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    np.savez(path, **arrays)


def _pack_np(z, prefix: str) -> np.ndarray:
    n = z["means"].shape[0]
    return np.concatenate([np.asarray(z[f"{prefix}{k}"], np.float32)
                           .reshape(n, hi - lo)
                           for k, lo, hi, _ in PACK_LAYOUT], axis=1)


def load_checkpoint(path: str | os.PathLike,
                    device: str | torch.device = "cpu"):
    """Returns (scene, opt_state | None, meta), on ``device``."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["_meta"]).decode("utf-8"))
        params = {k: z[k] for k, _, _, _ in PACK_LAYOUT}
        scene = scene_from_numpy(params, z["alive"], int(meta["sh_deg"]),
                                 device)
        opt_state = None
        if "adam_m_packed" in z:
            m, v = z["adam_m_packed"], z["adam_v_packed"]
        elif "adam_m_means" in z:
            # version-1 checkpoints stored per-leaf moments; pack on load
            m, v = _pack_np(z, "adam_m_"), _pack_np(z, "adam_v_")
        else:
            m = v = None
        if m is not None:
            opt_state = AdamState(
                m=torch.tensor(np.asarray(m, np.float32), device=device),
                v=torch.tensor(np.asarray(v, np.float32), device=device),
                iteration=int(meta.get("adam_iteration", 0)))
    return scene, opt_state, meta
