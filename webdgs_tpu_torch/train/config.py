"""Training configuration (counterpart of webdgs_tpu/train/config.py).

Names and defaults are the reference's three live config objects: the
loss weights (``LossConfig``), the optimizer (``AdamHyperparameters``) and
the densify/prune schedule (``DensifyPruneConfig``).
"""

from __future__ import annotations

import dataclasses
import json

from webdgs_tpu_torch.ops.adam import AdamHyperparameters
from webdgs_tpu_torch.ops.loss import LossConfig

__all__ = ["LossConfig", "AdamHyperparameters", "DensifySchedule",
           "DensifyPruneConfig", "TrainerConfig", "load_trainer_config"]


@dataclasses.dataclass(frozen=True)
class DensifySchedule:
    enabled: bool = True
    warmup_iterations: int = 500
    interval: int = 100
    stop_iterations: int = 15_000

    def should_densify(self, next_iteration: int) -> bool:
        """Fire at warmup and then every ``interval`` iterations until
        ``stop``."""
        if not self.enabled:
            return False
        w, s = self.warmup_iterations, self.stop_iterations
        i = max(1, self.interval)
        return (w <= next_iteration <= s
                and (next_iteration == w or (next_iteration - w) % i == 0))


@dataclasses.dataclass(frozen=True)
class DensifyPruneConfig:
    schedule: DensifySchedule = DensifySchedule()
    metric_views: int = 10
    metric_downscale: int = 2
    metric_threshold: float = 0.5
    max_new_points_per_step: int = 5000
    prune_opacity: float = 0.01
    clone_threshold_count: int = 500
    split_scale_threshold: float = 1.0
    # capacity budget in bytes over the core f32 parameter set
    max_buffer_bytes: int = 128 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    loss: LossConfig = LossConfig()
    adam: AdamHyperparameters = AdamHyperparameters()
    densify: DensifyPruneConfig = DensifyPruneConfig()
    max_iterations: int = 10_000
    seed: int = 0


def _merge_dataclass(obj, updates: dict):
    """Deep-partial update of nested frozen dataclasses."""
    kwargs = {}
    for f in dataclasses.fields(obj):
        if f.name not in updates:
            continue
        val = updates[f.name]
        cur = getattr(obj, f.name)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            val = _merge_dataclass(cur, val)
        kwargs[f.name] = val
    unknown = set(updates) - {f.name for f in dataclasses.fields(obj)}
    if unknown:
        raise ValueError(f"unknown config keys for "
                         f"{type(obj).__name__}: {sorted(unknown)}")
    return dataclasses.replace(obj, **kwargs)


def load_trainer_config(path_or_dict,
                        base: TrainerConfig | None = None) -> TrainerConfig:
    """A TrainerConfig from a JSON file or dict of deep-partial overrides
    over ``base`` (default: the defaults)."""
    if isinstance(path_or_dict, dict):
        updates = path_or_dict
    else:
        with open(path_or_dict) as f:
            updates = json.load(f)
    return _merge_dataclass(base or TrainerConfig(), updates)
