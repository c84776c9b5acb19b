"""Multi-device execution on ``torch.distributed`` (counterpart of
webdgs_tpu/parallel/sharding.py): view-data-parallel training, the
tile-sharded render, and the Gaussian-sharded render and training step.

One process per device, PyTorch's idiom for data parallelism: a ``Mesh``
is the default process group seen from one rank (NCCL on the card, gloo
where the caller asks for the CPU).  A 2D mesh (``make_mesh(...,
shape=(V, B))``) also carries a band group per mesh row and a dp group
per mesh column; a 1D mesh's band group is the whole group.

* ``dp_train_step``: the scene and the Adam state are replicated; each rank
  runs its share of the view batch, then the parameter gradients, the tile
  counts, the metric sums and the metric maxima are reduced in three
  collectives, and every rank takes the identical Adam update.
* ``render_tile_sharded``: rank b renders tile rows [b*rows, (b+1)*rows)
  of the padded tile grid with the serial-band renderer's band code
  (``render/renderer.py:_render_band``: restrict, shift, bin at the full
  capacity, rasterize); an ``all_gather`` assembles the frame.
* ``render_gaussian_sharded`` and ``gs_train_step``: each rank of a band
  group holds 1/B of the Gaussians (``gaussian_shard``), projects and
  expands them, sorts its entries by tile and sends each band's block to
  the band's owner in one ``all_to_all_single``; the owner merges them into
  chunk-aligned tile ranges (``ops/binning.py:aligned_tile_layout``) and
  rasterizes its tile rows.  The step computes the band's loss cotangent
  with the band form of the tile-loss kernel, its 2-pixel halo from the
  neighbour bands over one ``batch_isend_irecv`` ring, and sends the entry
  cotangents back through the exact float32 transpose of the exchange;
  each Gaussian's are summed by the segment-sum kernel in expansion order,
  and the Adam update is local.  Unlike the reference, which takes the
  whole scene and shards it, these take this rank's shard: a rank never
  holds the others' Gaussians.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import tempfile
from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist

from webdgs_tpu_torch.config import DEFAULT_SETTINGS, RenderSettings
from webdgs_tpu_torch.core.camera import Camera
from webdgs_tpu_torch.core.scene import GaussianScene
from webdgs_tpu_torch.ops import binning as binning_ops
from webdgs_tpu_torch.ops import rasterize as raster_ops
from webdgs_tpu_torch.ops.adam import AdamHyperparameters, AdamState, adam_step
from webdgs_tpu_torch.ops.loss import LossConfig, loss_metrics, ssim_map
from webdgs_tpu_torch.ops.projection import SplatAttrs, project_gaussians
from webdgs_tpu_torch.ops.segsum import segment_reduce_entries
from webdgs_tpu_torch.ops.tile_loss import (band_tile_loss_gradient,
                                            halo_slices, metrics_from_sums,
                                            supports_tile_loss)
from webdgs_tpu_torch.render.renderer import _render_band
from webdgs_tpu_torch.train.step import (TrainStepResult, _apply_grad_parity,
                                         _param_grads, _project, _vjp,
                                         compute_param_grads,
                                         compute_param_grads_tiled)

# a rank that fails lets its peers' collectives raise after this long
DEFAULT_TIMEOUT_S = 600.0

# the scalar metrics summed over the views (then divided by their count)
# and those taken as the per-view maximum
SUM_METRICS = ("loss", "l1", "l2", "dssim", "psnr")
MAX_METRICS = ("visible", "tile_entries")


@dataclasses.dataclass
class Mesh:
    """The default process group as seen from this rank; with ``shape``
    (V, B) also a dp x band layout: rank r sits at mesh row r // B (its
    ``dp_rank``) and column r % B (its ``band_rank``)."""

    group: dist.ProcessGroup
    rank: int
    size: int
    device: torch.device
    axis_name: str = "dp"
    # the directory of the file store of a world of one that make_mesh
    # started; close() removes it
    store_dir: str | None = None
    shape: tuple[int, int] | None = None
    # this rank's mesh row (the ranks that share a view, one band each)
    # and column (the ranks that hold the same Gaussians); without a shape
    # the band group is ``group`` and there is no dp group
    band_group: dist.ProcessGroup | None = None
    dp_group: dist.ProcessGroup | None = None

    def __post_init__(self):
        if self.band_group is None:
            self.band_group = self.group

    @property
    def band_size(self) -> int:
        return self.shape[1] if self.shape else self.size

    @property
    def band_rank(self) -> int:
        return self.rank % self.band_size

    @property
    def dp_size(self) -> int:
        return self.shape[0] if self.shape else 1

    @property
    def dp_rank(self) -> int:
        return self.rank // self.band_size

    def band_peer(self, band: int) -> int:
        """The global rank of band ``band`` in this rank's mesh row."""
        return self.dp_rank * self.band_size + band % self.band_size

    def close(self) -> None:
        """Destroy the default process group (every rank calls this)."""
        if dist.is_initialized():
            dist.destroy_process_group()
        if self.store_dir is not None:
            shutil.rmtree(self.store_dir, ignore_errors=True)


def make_mesh(device: str | torch.device | None = None,
              axis_name: str = "dp", *, init_method: str | None = None,
              rank: int | None = None, world_size: int | None = None,
              timeout_s: float = DEFAULT_TIMEOUT_S,
              shape: tuple[int, int] | None = None) -> Mesh:
    """The mesh of this process, initialising the default group unless it
    exists: from ``init_method``, ``rank`` and ``world_size`` when given
    (tests pass a ``file://`` path); else from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); else as a world of one through a ``file://`` store
    in a temporary directory.

    ``device`` is ``"cuda"`` (the default: NCCL, and this rank's card is
    ``LOCAL_RANK``) or ``"cpu"`` (gloo).  Nothing falls back: without a
    card, or when NCCL cannot start, this raises.

    ``shape=(V, B)`` with V * B ranks also makes the dp x band layout's
    groups: a band group per mesh row, then a dp group per mesh column
    (every rank creates every group, in this order)."""
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
    mesh = Mesh(group=dist.group.WORLD, rank=dist.get_rank(),
                size=dist.get_world_size(), device=dev, axis_name=axis_name,
                store_dir=store_dir)
    if shape is None:
        return mesh
    n_rows, n_cols = shape
    if n_rows < 1 or n_cols < 1 or n_rows * n_cols != mesh.size:
        raise ValueError(f"a {n_rows}x{n_cols} mesh needs {n_rows * n_cols}"
                         f" ranks, the group has {mesh.size}")
    mesh.shape = (n_rows, n_cols)
    for v in range(n_rows):
        g = dist.new_group([v * n_cols + b for b in range(n_cols)])
        if v == mesh.dp_rank:
            mesh.band_group = g
    for b in range(n_cols):
        g = dist.new_group([v * n_cols + b for v in range(n_rows)])
        if b == mesh.band_rank:
            mesh.dp_group = g
    return mesh


# ---------------------------------------------------------------------------
# data-parallel training over views
# ---------------------------------------------------------------------------

def _mean_over_views(grads: dict, sums: torch.Tensor, group,
                     n_views: int):
    """The gradients and the metric sums summed over ``group`` in one
    collective, each divided by the view count."""
    names = list(grads)
    flat = torch.cat([grads[k].reshape(-1) for k in names] + [sums])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    parts = flat.split([grads[k].numel() for k in names] + [sums.numel()])
    return ({k: p.view_as(grads[k]) / n_views
             for k, p in zip(names, parts)}, parts[-1] / n_views)


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
        grads = {k: grads[k] + d_params[k] for k in grads}
        counts = counts + aux.num_tiles
        sums = sums + torch.stack([m[k] for k in SUM_METRICS])
        maxes = torch.maximum(maxes, torch.stack([
            aux.visible.sum(dtype=torch.int64), demand.to(torch.int64)]))

    # three collectives: the gradients with the metric sums, the tile
    # counts, the maxima
    grads, sums = _mean_over_views(grads, sums, mesh.group, n_views)
    dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=mesh.group)
    dist.all_reduce(maxes, op=dist.ReduceOp.MAX, group=mesh.group)
    metrics = dict(zip(SUM_METRICS, sums))
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


# ---------------------------------------------------------------------------
# Gaussian-sharded rendering and training: entries exchanged to band owners
# ---------------------------------------------------------------------------

def gaussian_shard(x, mesh: Mesh):
    """This rank's shard of a whole GaussianScene or AdamState: rows
    [b*n/B, (b+1)*n/B) for band rank b of B (the dp ranks of a column hold
    the same shard).  The capacity must divide by B: ``pad_to`` first."""
    n_bands, b = mesh.band_size, mesh.band_rank
    n = x.capacity if isinstance(x, GaussianScene) else x.m.shape[0]
    if n % n_bands:
        raise ValueError(f"capacity {n} not divisible by the {n_bands} "
                         "bands; pad_to a multiple first")
    lo, hi = b * (n // n_bands), (b + 1) * (n // n_bands)
    if isinstance(x, GaussianScene):
        return dataclasses.replace(
            x, alive=x.alive[lo:hi],
            **{k: v[lo:hi] for k, v in x.params().items()})
    return AdamState(x.m[lo:hi], x.v[lo:hi], x.iteration)


class _GsPlan(NamedTuple):
    """The static sizes of one Gaussian-sharded frame, the same on every
    rank of a band group (whose shards share one capacity)."""

    n_bands: int
    ntx: int
    rows: int  # tile rows per band (the grid padded to n_bands * rows)
    e_loc: int  # entry capacity of a shard's expansion
    s_cap: int  # entries a rank may send to one band
    a_cap: int  # slots of the band's chunk-aligned layout

    @property
    def band_tiles(self) -> int:
        return self.ntx * self.rows

    @property
    def recv(self) -> int:
        return self.n_bands * self.s_cap


def _gs_plan(n_loc: int, img_w: int, img_h: int, mesh: Mesh,
             settings: RenderSettings, send_capacity: int | None,
             entry_capacity: int | None) -> _GsPlan:
    d, chunk = mesh.band_size, settings.chunk
    ntx, nty = binning_ops.tile_grid(img_w, img_h, settings)
    rows = -(-nty // d)
    binning_ops.check_tile_key_limit(ntx * rows * d)
    e_loc = (entry_capacity if entry_capacity is not None
             else binning_ops.entry_capacity(n_loc, settings))
    e_loc = max(-(-e_loc // chunk) * chunk, chunk)
    if send_capacity is None:  # twice the uniform share, chunk-rounded
        send_capacity = min(-(-2 * (e_loc // d) // chunk) * chunk, e_loc)
    # chunk multiples: the aligned layout's capacity must be one
    s_cap = max(-(-send_capacity // chunk) * chunk, chunk)
    return _GsPlan(n_bands=d, ntx=ntx, rows=rows, e_loc=e_loc, s_cap=s_cap,
                   a_cap=d * s_cap + ntx * rows * chunk)


def _tile_origins(keys: torch.Tensor, ntx: int, settings: RenderSettings):
    """(x0, y0) f32 pixel origin of each entry's global tile, from the sort
    key's tile field (keys: int64 holding the u32 key)."""
    tile = keys >> 16
    tx0 = ((tile % ntx) * settings.tile_w).to(torch.float32)
    ty0 = ((tile // ntx) * settings.tile_h).to(torch.float32)
    return tx0, ty0


def _encode_exchange(rows: torch.Tensor, keys: torch.Tensor,
                     valid: torch.Tensor, ntx: int,
                     settings: RenderSettings) -> torch.Tensor:
    """The (M, 16) entry rows as they cross the wire: with
    ``settings.exchange_f16``, centers (rows 0/1) relative to the entry's
    tile origin and everything float16 (round to nearest even, as the
    reference's ``astype``); else the f32 rows unchanged."""
    if not settings.exchange_f16:
        return rows
    tx0, ty0 = _tile_origins(keys, ntx, settings)
    off = torch.stack([torch.where(valid, -tx0, 0.0),
                       torch.where(valid, -ty0, 0.0)], dim=1)
    return torch.cat([rows[:, :2] + off, rows[:, 2:]], dim=1).to(
        torch.float16)


def _decode_exchange(rows: torch.Tensor, keys: torch.Tensor,
                     valid: torch.Tensor, ntx: int, shift: float,
                     settings: RenderSettings) -> torch.Tensor:
    """Inverse of :func:`_encode_exchange` for gathered rows, with the
    band's pixel shift folded in (centers come out in band coordinates:
    global y minus ``shift``).  Invalid slots come out all-zero."""
    rows = torch.where(valid[:, None], rows.to(torch.float32), 0.0)
    cx, cy = rows[:, 0:1], rows[:, 1:2]
    if settings.exchange_f16:
        tx0, ty0 = _tile_origins(keys, ntx, settings)
        cx = cx + torch.where(valid, tx0, 0.0)[:, None]
        cy = cy + torch.where(valid, ty0 - shift, 0.0)[:, None]
    else:
        cy = cy + torch.where(valid, -shift, 0.0)[:, None]
    return torch.cat([cx, cy, rows[:, 2:]], dim=1)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block b of ``x`` (split evenly on dim 0) to band rank b; block b of
    the result from band rank b."""
    y = torch.empty_like(x)
    dist.all_to_all_single(y, x.contiguous(), group=group)
    return y


class _Exchange(NamedTuple):
    """The index plumbing of one Gaussian-sharded frame on this rank: its
    send blocks (one of ``s_cap`` slots per band) and its band's aligned
    layout of the received entries."""

    sg_src: torch.Tensor  # (B*s_cap,) i64 local Gaussian of each send slot
    s_valid: torch.Tensor  # (B*s_cap,) bool
    send_keys: torch.Tensor  # (B*s_cap,) i64 u32 keys, sentinel if invalid
    send_slot: torch.Tensor  # (B*s_cap,) i64 local sorted slot, e_loc if not
    band_cnt: torch.Tensor  # (B,) i64 local entries per band
    gather_idx: torch.Tensor  # (a_cap,) i64 received row of each slot
    slot_keys: torch.Tensor  # (a_cap,) i64 key of each slot
    valid2: torch.Tensor  # (a_cap,) bool
    tile_offsets: torch.Tensor  # (band_tiles+1,) i32 aligned ranges
    # the local stable sort, for the per-Gaussian segment sum
    entry_valid: torch.Tensor
    entry_source: torch.Tensor
    gauss_counts: torch.Tensor
    demand: torch.Tensor  # () local pre-drop entry demand
    shift: float  # the band's first pixel row


def _exchange_layout(attrs: SplatAttrs, aux, plan: _GsPlan, mesh: Mesh,
                     settings: RenderSettings) -> _Exchange:
    """Expand and sort this shard's entries, cut the sorted run into band
    blocks, exchange the keys and lay the band's received entries out in
    chunk-aligned tile ranges.  Data, not differentiated; no host read."""
    d, s_cap, e_loc = plan.n_bands, plan.s_cap, plan.e_loc
    band = mesh.band_rank
    dev = aux.num_tiles.device
    key, g, counts, total, _, demand = binning_ops.expand_entries(
        aux, plan.ntx, e_loc, attrs=attrs, settings=settings)
    # the stable sort of bin_splats: tile-sorted => grouped by band, and
    # equal keys keep expansion (= Gaussian) order
    skey, perm = torch.sort(key, stable=True)
    sg = g.to(torch.int64)[perm]
    bounds = torch.searchsorted(skey, (torch.arange(
        d + 1, dtype=torch.int64, device=dev) * plan.band_tiles) << 16)
    band_off, band_cnt = bounds[:-1], bounds[1:] - bounds[:-1]

    slot = torch.arange(d * s_cap, dtype=torch.int64, device=dev)
    sb, j = slot // s_cap, slot % s_cap
    src = torch.clamp(band_off[sb] + j, 0, e_loc - 1)
    s_valid = j < band_cnt[sb]
    send_keys = torch.where(s_valid, skey[src], binning_ops.SENTINEL_KEY)
    keys_r = _all_to_all(send_keys, mesh.band_group)

    # merge the B sorted runs (stable: rank order, then each run's order)
    mkey, mperm = torch.sort(keys_r, stable=True)
    tile0 = band * plan.band_tiles
    tbounds = torch.searchsorted(mkey, (tile0 + torch.arange(
        plan.band_tiles + 1, dtype=torch.int64, device=dev)) << 16)
    tile_counts = (tbounds[1:] - tbounds[:-1]).to(torch.int32)
    tile_offsets, aligned_off, unaligned_off = \
        binning_ops.aligned_tile_layout(tile_counts, settings.chunk)
    src2, valid2 = binning_ops.realign_sorted(
        tile_offsets, aligned_off, unaligned_off, tile_counts, plan.a_cap,
        settings.chunk, plan.band_tiles, plan.recv)
    src2 = src2.to(torch.int64)
    e_idx = torch.arange(e_loc, dtype=torch.int64, device=dev)
    return _Exchange(
        sg_src=sg[src], s_valid=s_valid, send_keys=send_keys,
        send_slot=torch.where(s_valid, src, e_loc), band_cnt=band_cnt,
        gather_idx=mperm[src2], slot_keys=mkey[src2], valid2=valid2,
        tile_offsets=tile_offsets, entry_valid=e_idx < total,
        entry_source=perm.to(torch.int32), gauss_counts=counts,
        demand=demand, shift=float(band * plan.rows * settings.tile_h))


class _SendGather(torch.autograd.Function):
    """(N_loc, 16) per-Gaussian rows -> (B*s_cap, 16) send rows.  The
    transpose puts each valid send slot's cotangent back at its local
    sorted slot (an injective map; dropped entries get zeros) and sums per
    Gaussian in expansion order with the segment-sum kernel, as the
    single-device gather does (ops/rasterize.py:_GatherPackSegsum)."""

    @staticmethod
    def forward(ctx, per_g, ex: _Exchange):
        ctx.ex = ex
        return torch.where(ex.s_valid[:, None], per_g[ex.sg_src], 0.0)

    @staticmethod
    def backward(ctx, g):
        ex = ctx.ex
        e_loc = ex.entry_source.shape[0]
        rows = g.new_zeros((e_loc + 1, g.shape[1]))
        rows[ex.send_slot] = torch.where(ex.s_valid[:, None], g, 0.0)
        return segment_reduce_entries(rows[:e_loc], ex.entry_valid,
                                      ex.entry_source, ex.gauss_counts), None


class _EntryExchange(torch.autograd.Function):
    """Send rows -> the band's (a_cap, 16) entry rows in the aligned layout:
    encode (float16 with ``exchange_f16``), ``all_to_all_single`` over the
    band group, gather, decode.  The backward is the exact float32
    transpose: mask, put each valid slot's row back at its received row
    (each appears once: an index copy, never an accumulation), the same
    all_to_all, mask.  Cotangents never round to float16."""

    @staticmethod
    def forward(ctx, send_rows, ex: _Exchange, plan: _GsPlan, group,
                settings):
        ctx.ex, ctx.plan, ctx.group = ex, plan, group
        enc = _encode_exchange(send_rows, ex.send_keys, ex.s_valid, plan.ntx,
                               settings)
        rows_r = _all_to_all(enc, group)
        return _decode_exchange(rows_r[ex.gather_idx], ex.slot_keys,
                                ex.valid2, plan.ntx, ex.shift, settings)

    @staticmethod
    def backward(ctx, g):
        ex, recv = ctx.ex, ctx.plan.recv
        back = g.new_zeros((recv + 1, g.shape[1]))
        back[torch.where(ex.valid2, ex.gather_idx, recv)] = torch.where(
            ex.valid2[:, None], g, 0.0)
        back = _all_to_all(back[:recv], ctx.group)
        return torch.where(ex.s_valid[:, None], back, 0.0), None, None, \
            None, None


def _band_tiles(attrs: SplatAttrs, ex: _Exchange, plan: _GsPlan,
                mesh: Mesh, settings: RenderSettings,
                track_ncontrib: bool) -> torch.Tensor:
    """The band's (rows*ntx, NUM_OUT, P) forward tiles from this shard's
    attributes (differentiable with respect to ``attrs``)."""
    per_g = raster_ops._pack_per_gauss(attrs)
    send_rows = _SendGather.apply(per_g, ex)
    entry_rows = _EntryExchange.apply(send_rows, ex, plan, mesh.band_group,
                                      settings)
    return raster_ops.rasterize_tiles(entry_rows.T.contiguous(),
                                      ex.tile_offsets, plan.ntx, plan.rows,
                                      settings, track_ncontrib)


def _ring(to_next: torch.Tensor, to_prev: torch.Tensor, mesh: Mesh):
    """One ring exchange over the band group: (what band b-1 sent to its
    next, what band b+1 sent to its previous), circular.  A ring of one
    band gets its own tensors back, no collective."""
    d = mesh.band_size
    if d == 1:
        return to_next, to_prev
    b = mesh.band_rank
    nxt, prv = mesh.band_peer(b + 1), mesh.band_peer(b - 1)
    from_prev, from_next = torch.empty_like(to_next), torch.empty_like(
        to_prev)
    # with two bands both messages go to the one peer: the tags (and, on
    # NCCL, the order) match them
    ops = [dist.P2POp(dist.isend, to_next.contiguous(), nxt,
                      mesh.band_group, 0),
           dist.P2POp(dist.isend, to_prev.contiguous(), prv,
                      mesh.band_group, 1),
           dist.P2POp(dist.irecv, from_prev, prv, mesh.band_group, 0),
           dist.P2POp(dist.irecv, from_next, nxt, mesh.band_group, 1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_prev, from_next


@torch.no_grad()
def render_gaussian_sharded(scene: GaussianScene, camera: Camera,
                            img_w: int, img_h: int, mesh: Mesh,
                            settings: RenderSettings = DEFAULT_SETTINGS,
                            send_capacity: int | None = None,
                            gather: bool = True):
    """Render with the Gaussians sharded over the band group: ``scene`` is
    this rank's shard (:func:`gaussian_shard`; every rank's of one
    capacity).  Each rank projects and expands its shard, one
    ``all_to_all_single`` delivers every band's entries to its owner, which
    rasterizes its tile rows.

    ``send_capacity``: the entries a rank may send to one band (default
    twice the uniform share); a band more concentrated drops the overflow,
    as the reference's maxTileEntries does, and ``dropped`` counts them.
    Returns (image, dropped): the (img_h, img_w, 3) frame on every rank,
    or with ``gather=False`` this rank's (rows * tile_h, img_w, 3) band;
    ``dropped`` is a device scalar, the band group's total.  Reads nothing
    back from the device."""
    plan = _gs_plan(scene.capacity, img_w, img_h, mesh, settings,
                    send_capacity, None)
    attrs, aux = project_gaussians(scene.params(), scene.alive, camera,
                                   img_w, img_h, scene.sh_deg, settings)
    ex = _exchange_layout(attrs, aux, plan, mesh, settings)
    out = _band_tiles(attrs, ex, plan, mesh, settings, track_ncontrib=True)
    band_h = plan.rows * settings.tile_h
    band = raster_ops.composite_background(raster_ops.tiles_to_image(
        out, plan.ntx, plan.rows, img_w, band_h, settings), settings)
    dropped = torch.clamp(ex.band_cnt - plan.s_cap, min=0).sum()
    dist.all_reduce(dropped, op=dist.ReduceOp.SUM, group=mesh.band_group)
    if not gather:
        return band, dropped
    parts = [torch.empty_like(band) for _ in range(plan.n_bands)]
    dist.all_gather(parts, band.contiguous(), group=mesh.band_group)
    return torch.cat(parts, dim=0)[:img_h], dropped


def gs_train_step(scene: GaussianScene, opt_state: AdamState, camera,
                  target: torch.Tensor, mesh: Mesh, *, img_w: int,
                  img_h: int, loss_cfg: LossConfig = LossConfig(),
                  hp: AdamHyperparameters = AdamHyperparameters(),
                  settings: RenderSettings = DEFAULT_SETTINGS,
                  send_capacity: int | None = None,
                  entry_capacity: int | None = None,
                  parity_sh: bool = True) -> TrainStepResult:
    """One training step with the scene and the Adam state sharded over the
    band group: ``scene`` and ``opt_state`` are this rank's shards
    (:func:`gaussian_shard`), and so are the returned ones.

    The forward is :func:`render_gaussian_sharded`'s, kept as the band's
    tiles; the band's loss cotangent comes from the band tile-loss kernel
    (frames under 5x5: the image-space loss on the band and 2 halo rows);
    the backward returns every entry cotangent to its Gaussian's rank
    through the exchange's float32 transpose, so gradients, moments and
    the update stay local.  ``entry_capacity``: this shard's expansion
    capacity (default the heuristic for its size); ``send_capacity`` as in
    the render.

    On a 2D mesh (``make_mesh(..., shape=(V, B))``) ``camera`` is a
    sequence of V cameras and ``target`` (V, H, W, 3): mesh row v trains
    view v band-sharded, and the gradients are summed over the dp group
    and divided by V.  Metrics: the single-device step's keys (losses
    summed over the bands; on a 2D mesh averaged over the views,
    ``visible``/``tile_entries`` the per-view maximum) and
    ``entries_dropped`` (all drops), ``entries_local_max`` (the largest
    shard demand) and ``send_max`` (the largest block one rank sent one
    band), which size the capacities.  Reads nothing back from the device:
    the only waits are ``adam_step``'s."""
    if mesh.shape is not None:
        n_views = mesh.dp_size
        if len(camera) != n_views or len(target) != n_views:
            raise ValueError(f"a {mesh.shape} mesh takes {n_views} views, "
                             f"got {len(camera)} cameras, {len(target)} "
                             "targets")
        camera, target = camera[mesh.dp_rank], target[mesh.dp_rank]
    else:
        n_views = 1
    plan = _gs_plan(scene.capacity, img_w, img_h, mesh, settings,
                    send_capacity, entry_capacity)
    th = settings.tile_h
    band_h = plan.rows * th

    params, attrs, leaves, aux = _project(scene, camera, img_w, img_h,
                                          settings, parity_sh)
    ex = _exchange_layout(leaves, aux, plan, mesh, settings)
    out = _band_tiles(leaves, ex, plan, mesh, settings, track_ncontrib=False)
    if supports_tile_loss(img_w, img_h, settings):
        bot, top = halo_slices(out.detach(), plan.ntx, settings)
        halo_top, halo_bot = _ring(bot, top, mesh)
        dpix, sums = band_tile_loss_gradient(
            out.detach(), halo_top, halo_bot, target,
            mesh.band_rank * plan.rows, img_w, img_h, plan.ntx, plan.rows,
            loss_cfg, settings)
        d_attrs = SplatAttrs(*_vjp(out, list(leaves), dpix))
        parts = sums.sum(dim=0)
    else:
        band_pred = raster_ops.composite_background(
            raster_ops.tiles_to_image(out, plan.ntx, plan.rows, img_w,
                                      band_h, settings), settings)
        pred = band_pred.detach()
        above, below = _ring(pred[-2:], pred[:2], mesh)
        ext = torch.cat([above, pred, below])
        # global row of ext row i is y0 - 2 + i: clamp into the frame and
        # index locally (the wrapped-around halo rows at the frame's
        # borders are clamped away before they are read)
        y0 = mesh.band_rank * band_h
        yy = torch.clamp(torch.arange(y0 - 2, y0 + band_h + 2,
                                      device=pred.device), 0, img_h - 1)
        pred_ext = ext[torch.clamp(yy - (y0 - 2), 0, band_h + 3)]
        tgt_ext = target[yy]
        sm_ext = ssim_map(pred_ext, tgt_ext, loss_cfg.c1, loss_cfg.c2)
        diff_ext = pred_ext - tgt_ext
        grad_ext = (loss_cfg.lambda_l1 * torch.sign(diff_ext)
                    + loss_cfg.lambda_l2 * diff_ext
                    + loss_cfg.lambda_dssim * (1.0 - sm_ext) * 0.5
                    * diff_ext)
        own = slice(2, 2 + band_h)
        row_valid = ((torch.arange(band_h, device=pred.device) + y0)
                     < img_h)[:, None, None]
        pgrad = torch.where(row_valid, grad_ext[own], 0.0)
        d_attrs = SplatAttrs(*_vjp(band_pred, list(leaves), pgrad))
        dv = torch.where(row_valid, diff_ext[own], 0.0)
        ds_own = torch.where(row_valid, (1.0 - sm_ext[own]) * 0.5, 0.0)
        parts = torch.stack([dv.abs().sum(), (dv * dv).sum(), ds_own.sum()])
    d_params = _param_grads(params, attrs, d_attrs)
    d_params = _apply_grad_parity(d_params, d_attrs, aux, params, parity_sh)

    # two collectives over the band group: the loss partials with the
    # counts (float64 holds both exactly), then the maxima
    n_parts = parts.shape[0]
    band_sums = torch.cat([parts.to(torch.float64), torch.stack([
        aux.visible.sum(), ex.demand,
        torch.clamp(ex.band_cnt - plan.s_cap, min=0).sum()]).to(
            torch.float64)])
    dist.all_reduce(band_sums, op=dist.ReduceOp.SUM, group=mesh.band_group)
    band_max = torch.stack([ex.demand.to(torch.int64), ex.band_cnt.max()])
    dist.all_reduce(band_max, op=dist.ReduceOp.MAX, group=mesh.band_group)
    tot = band_sums[:n_parts].to(torch.float32)
    if n_parts == 4:
        metrics = metrics_from_sums(tot, loss_cfg)
    else:
        n_el = float(img_h * img_w * 3)
        l1, l2, dssim = tot[0] / n_el, tot[1] / n_el, tot[2] / n_el
        metrics = {"l1": l1, "l2": l2, "dssim": dssim,
                   "loss": (loss_cfg.lambda_l1 * l1
                            + loss_cfg.lambda_l2 * l2
                            + loss_cfg.lambda_dssim * dssim),
                   "psnr": -10.0 * torch.log10(torch.clamp(l2, min=1e-12))}
    counts_i = band_sums[n_parts:].to(torch.int64)  # visible, demand, drops
    maxes = torch.cat([counts_i[:2], band_max])
    dropped = counts_i[2]
    counts = aux.num_tiles
    if mesh.dp_group is not None:
        # the view batch: three collectives over the dp group, as in
        # dp_train_step (gradients with the losses, the counts, the
        # per-view maxima)
        d_params, sums = _mean_over_views(
            d_params, torch.stack([metrics[k] for k in SUM_METRICS]),
            mesh.dp_group, n_views)
        metrics = dict(zip(SUM_METRICS, sums))
        ints = torch.cat([counts.to(torch.int64), dropped[None]])
        dist.all_reduce(ints, op=dist.ReduceOp.SUM, group=mesh.dp_group)
        dist.all_reduce(maxes, op=dist.ReduceOp.MAX, group=mesh.dp_group)
        counts, dropped = ints[:-1].to(torch.int32), ints[-1]

    with torch.no_grad():
        new_params, new_opt = adam_step(scene.params(), d_params, opt_state,
                                        hp, counts)
    metrics["visible"] = maxes[0].to(torch.int32)
    metrics["tile_entries"] = maxes[1]
    metrics["entries_dropped"] = dropped
    metrics["entries_local_max"] = maxes[2]
    metrics["send_max"] = maxes[3]
    return TrainStepResult(scene=scene.with_params(new_params),
                           opt_state=new_opt, metrics=metrics)
