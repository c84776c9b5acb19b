"""View-data-parallel training and the tile-sharded render on
``torch.distributed`` (counterpart of webdgs_tpu/parallel/sharding.py:46-184).

One process per device, PyTorch's idiom for data parallelism: a ``Mesh``
is the default process group seen from one rank (NCCL on the card, gloo
where the caller asks for the CPU).

* ``dp_train_step``: the scene and the Adam state are replicated; each rank
  runs its share of the view batch, then the parameter gradients, the tile
  counts, the metric sums and the metric maxima are reduced in three
  collectives, and every rank takes the identical Adam update.
* ``render_tile_sharded``: rank b renders tile rows [b*rows, (b+1)*rows)
  of the padded tile grid with the serial-band renderer's band code
  (``render/renderer.py:_render_band``: restrict, shift, bin at the full
  capacity, rasterize); an ``all_gather`` assembles the frame.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import tempfile
from typing import Sequence

import torch
import torch.distributed as dist

from webdgs_tpu_torch.config import DEFAULT_SETTINGS, RenderSettings
from webdgs_tpu_torch.core.camera import Camera
from webdgs_tpu_torch.core.scene import GaussianScene
from webdgs_tpu_torch.ops import binning as binning_ops
from webdgs_tpu_torch.ops import rasterize as raster_ops
from webdgs_tpu_torch.ops.adam import AdamHyperparameters, AdamState, adam_step
from webdgs_tpu_torch.ops.loss import LossConfig, loss_metrics
from webdgs_tpu_torch.ops.projection import project_gaussians
from webdgs_tpu_torch.ops.tile_loss import supports_tile_loss
from webdgs_tpu_torch.render.renderer import _render_band
from webdgs_tpu_torch.train.step import (TrainStepResult, compute_param_grads,
                                         compute_param_grads_tiled)

# a rank that fails lets its peers' collectives raise after this long
DEFAULT_TIMEOUT_S = 600.0

# the scalar metrics summed over the views (then divided by their count)
# and those taken as the per-view maximum
SUM_METRICS = ("loss", "l1", "l2", "dssim", "psnr")
MAX_METRICS = ("visible", "tile_entries")


@dataclasses.dataclass
class Mesh:
    """The default process group as seen from this rank."""

    group: dist.ProcessGroup
    rank: int
    size: int
    device: torch.device
    axis_name: str = "dp"
    # the directory of the file store of a world of one that make_mesh
    # started; close() removes it
    store_dir: str | None = None

    def close(self) -> None:
        """Destroy the default process group (every rank calls this)."""
        if dist.is_initialized():
            dist.destroy_process_group()
        if self.store_dir is not None:
            shutil.rmtree(self.store_dir, ignore_errors=True)


def make_mesh(device: str | torch.device | None = None,
              axis_name: str = "dp", *, init_method: str | None = None,
              rank: int | None = None, world_size: int | None = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """The mesh of this process, initialising the default group unless it
    exists: from ``init_method``, ``rank`` and ``world_size`` when given
    (tests pass a ``file://`` path); else from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); else as a world of one through a ``file://`` store
    in a temporary directory.

    ``device`` is ``"cuda"`` (the default: NCCL, and this rank's card is
    ``LOCAL_RANK``) or ``"cpu"`` (gloo).  Nothing falls back: without a
    card, or when NCCL cannot start, this raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"a mesh runs on cuda or cpu, not {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: CUDA requested but not available; "
                           "pass device='cpu' for a gloo group")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    store_dir = None
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the default group runs {dist.get_backend()}"
                               f", a {dev.type} mesh needs {backend}")
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
    else:
        if init_method is not None:
            if rank is None or world_size is None:
                raise ValueError("init_method needs rank and world_size")
        elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            init_method = "env://"
            rank = int(os.environ["RANK"])
            world_size = int(os.environ["WORLD_SIZE"])
        else:
            store_dir = tempfile.mkdtemp(prefix="webdgs_dist_")
            init_method = "file://" + os.path.join(store_dir, "store")
            rank, world_size = 0, 1
        if dev.type == "cuda":
            dev = torch.device("cuda",
                               int(os.environ.get("LOCAL_RANK", rank)))
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s),
            device_id=dev if dev.type == "cuda" else None)
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(),
                size=dist.get_world_size(), device=dev, axis_name=axis_name,
                store_dir=store_dir)


# ---------------------------------------------------------------------------
# data-parallel training over views
# ---------------------------------------------------------------------------

def dp_train_step(scene: GaussianScene, opt_state: AdamState,
                  cameras: Sequence[Camera], targets, mesh: Mesh, *,
                  img_w: int, img_h: int,
                  loss_cfg: LossConfig = LossConfig(),
                  hp: AdamHyperparameters = AdamHyperparameters(),
                  settings: RenderSettings = DEFAULT_SETTINGS,
                  entry_capacity: int | None = None) -> TrainStepResult:
    """One training step over a batch of V views split across the mesh.

    ``cameras``: V cameras; ``targets``: V (H, W, 3) images (a sequence or
    a (V, H, W, 3) tensor), identical on every rank.  Rank b takes views
    [b*V/size, (b+1)*V/size), in order, and accumulates each view's
    parameter gradients, tile counts and metrics.  The reduced gradients
    are divided by V and every rank runs the same ``adam_step``.  Returns
    (scene, opt_state, metrics) with the single-device step's keys: the
    losses averaged over the V views, ``visible`` and ``tile_entries`` the
    per-view maximum.  Reads nothing back from the device."""
    n_views = len(cameras)
    if len(targets) != n_views or n_views % mesh.size:
        raise ValueError(f"{n_views} cameras and {len(targets)} targets: "
                         f"need one target per camera and a multiple of "
                         f"the mesh size {mesh.size}")
    per_rank = n_views // mesh.size
    params = scene.params()
    names = list(params)
    dev = scene.device
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    counts = torch.zeros((scene.capacity,), dtype=torch.int32, device=dev)
    sums = torch.zeros((len(SUM_METRICS),), dtype=torch.float32, device=dev)
    maxes = torch.zeros((len(MAX_METRICS),), dtype=torch.int64, device=dev)
    for i in range(mesh.rank * per_rank, (mesh.rank + 1) * per_rank):
        if supports_tile_loss(img_w, img_h, settings):
            m, d_params, aux, demand = compute_param_grads_tiled(
                scene, cameras[i], targets[i], img_w, img_h, loss_cfg,
                settings, parity_sh=not hp.full_sh,
                entry_capacity=entry_capacity)
        else:
            image, d_params, aux, demand = compute_param_grads(
                scene, cameras[i], targets[i], img_w, img_h, loss_cfg,
                settings, parity_sh=not hp.full_sh,
                entry_capacity=entry_capacity)
            m = loss_metrics(image, targets[i], loss_cfg)
        grads = {k: grads[k] + d_params[k] for k in names}
        counts = counts + aux.num_tiles
        sums = sums + torch.stack([m[k] for k in SUM_METRICS])
        maxes = torch.maximum(maxes, torch.stack([
            aux.visible.sum(dtype=torch.int64), demand.to(torch.int64)]))

    # three collectives: the gradients with the metric sums, the tile
    # counts, the maxima
    flat = torch.cat([grads[k].reshape(-1) for k in names] + [sums])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=mesh.group)
    dist.all_reduce(maxes, op=dist.ReduceOp.MAX, group=mesh.group)
    parts = flat.split([params[k].numel() for k in names] + [len(sums)])
    grads = {k: p.view_as(params[k]) / n_views
             for k, p in zip(names, parts)}
    metrics = {k: v / n_views for k, v in zip(SUM_METRICS, parts[-1])}
    metrics["visible"] = maxes[0].to(torch.int32)
    metrics["tile_entries"] = maxes[1]

    with torch.no_grad():
        new_params, new_opt = adam_step(params, grads, opt_state, hp,
                                        counts)
    return TrainStepResult(scene=scene.with_params(new_params),
                           opt_state=new_opt, metrics=metrics)


# ---------------------------------------------------------------------------
# tile-sharded rendering
# ---------------------------------------------------------------------------

@torch.no_grad()
def render_tile_sharded(scene: GaussianScene, camera: Camera, img_w: int,
                        img_h: int, mesh: Mesh,
                        settings: RenderSettings = DEFAULT_SETTINGS,
                        gather: bool = True) -> torch.Tensor:
    """Render with the tile rows split across the mesh.  The tile grid is
    padded to a multiple of the mesh size; a rank past the last real row
    renders an empty band.  Returns the (img_h, img_w, 3) frame on every
    rank, or with ``gather=False`` this rank's (rows * tile_h, img_w, 3)
    band."""
    ntx, nty = binning_ops.tile_grid(img_w, img_h, settings)
    rows = -(-nty // mesh.size)
    attrs, aux = project_gaussians(scene.params(), scene.alive, camera,
                                   img_w, img_h, scene.sh_deg, settings)
    # the full heuristic capacity per band: all of a concentrated scene's
    # entries may land in one band
    tiles, _ = _render_band(attrs, aux, mesh.rank * rows, img_w, rows,
                            ntx, settings, None)
    band = raster_ops.composite_background(tiles, settings)
    if not gather:
        return band
    parts = [torch.empty_like(band) for _ in range(mesh.size)]
    dist.all_gather(parts, band.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=0)[:img_h]
