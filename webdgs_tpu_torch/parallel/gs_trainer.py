"""The Gaussian-sharded trainer (counterpart of
webdgs_tpu/parallel/gs_trainer.py): the densify / prune event and the
training loop with the scene and the Adam state sharded over the band
group of a ``parallel/sharding.py:Mesh`` -- the reference's BASELINE
config 5 end to end.

Every rank holds only its shard (``gaussian_shard``: rows [b*n/B,
(b+1)*n/B) of band rank b of B).  On a dp x band mesh the ranks of a mesh
column hold the same shard; they run the same collectives on the same
data, so they stay bit-identical.

* ``rebalance_shards`` spreads the alive rows round-robin over the shards
  (alive row k -> shard k mod B at local slot k // B; dead rows fill the
  remaining slots in order), so that an event's local slot cap binds only
  when the global budget does.  Every rank computes the permutation from
  the band group's gathered alive mask (:func:`rebalance_permutation`) and
  one ``all_to_all_single`` of packed rows (parameters and both moments)
  moves each row to its new owner.  Its split sizes come from the host
  when the caller knows each shard's alive count (every shard's alive rows
  a prefix of it, as after an event or a rebalance), else from one read of
  the device.
* ``gs_densify_event`` gathers the parameters and the alive mask (the
  moments stay sharded), renders the metric views strided over the band
  ranks (view i*B + b) through ``view_importance_counts``, sums the counts
  in one ``all_reduce`` (whole numbers in float32: exact in any order) and
  decides locally.  One ``all_gather`` of the shards' alive and output
  counts gives each shard its global output offset, so ``cap_counts``
  clips exactly where the single-device event does; a second cap at the
  shard's slot count keeps its outputs local.  The random rows are the
  single-device event's global draw, sliced.  The output set is
  ``densify_prune``'s; only slot placement differs.
* ``GsTrainer`` drives ``gs_train_step`` with entry and send capacities
  adapted from the step's ``entries_local_max`` and ``send_max``, grows,
  rebalances and runs the event.  It takes the whole scene and keeps its
  shard; ``full_scene`` and ``full_opt_state`` gather the whole state for
  checkpoints and evaluation (collectives: every rank calls them).

Host reads: a step reads nothing (beyond ``adam_step``'s uploads), the
capacity adaptation once per interval, an event once (its counts, with
each shard's output count, which sizes the next rebalance's exchange).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from webdgs_tpu_torch.config import (DEFAULT_SETTINGS, RenderSettings,
                                     quantize_budget)
from webdgs_tpu_torch.core.camera import Camera
from webdgs_tpu_torch.core.scene import GaussianScene
from webdgs_tpu_torch.ops import densify as densify_ops
from webdgs_tpu_torch.ops.adam import (PACK_DIM, AdamState, pack_rows,
                                       unpack_rows)
from webdgs_tpu_torch.ops.densify import (ACTION_CLONE, ACTION_PRUNE,
                                          ACTION_SPLIT, cap_counts,
                                          compact_transform, decide)
from webdgs_tpu_torch.ops.importance import view_importance_counts
from webdgs_tpu_torch.parallel.sharding import (Mesh, gaussian_shard,
                                                gs_train_step)
from webdgs_tpu_torch.train.config import DensifyPruneConfig, TrainerConfig
from webdgs_tpu_torch.train.trainer import Trainer


def _gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows followed by the other shards', in band order (an
    ``all_gather`` over the band group; a group of one returns ``x``)."""
    if mesh.band_size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.band_size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.band_group)
    return torch.cat(parts)


def gather_scene(scene: GaussianScene, mesh: Mesh) -> GaussianScene:
    """The whole scene from every rank's shard (one ``all_gather`` of the
    packed parameter rows with the alive flag)."""
    if mesh.band_size == 1:
        return scene
    rows = _gather_rows(torch.cat([pack_rows(scene.params()),
                                   scene.alive[:, None].to(torch.float32)],
                                  dim=1), mesh)
    return dataclasses.replace(scene, alive=rows[:, PACK_DIM] > 0.5,
                               **unpack_rows(rows[:, :PACK_DIM]))


def gather_opt_state(opt_state: AdamState, mesh: Mesh) -> AdamState:
    """The whole optimizer state from every rank's shard."""
    if mesh.band_size == 1:
        return opt_state
    rows = _gather_rows(torch.cat([opt_state.m, opt_state.v], dim=1), mesh)
    return AdamState(rows[:, :PACK_DIM].contiguous(),
                     rows[:, PACK_DIM:].contiguous(), opt_state.iteration)


def rebalance_permutation(alive: torch.Tensor, d: int):
    """The rebalance of a whole alive mask over ``d`` shards, as
    (dest, src_of), int64: global row i moves to slot ``dest[i]``, and
    slot j receives row ``src_of[j]``.  Alive row k (in row order) goes to
    shard k mod d at local slot k // d; dead rows fill the remaining slots
    in row order.  No host read."""
    cap = alive.shape[0]
    if cap % d:
        raise ValueError(f"capacity {cap} not divisible by {d}")
    n_loc = cap // d
    alive = alive.to(torch.bool)
    dev = alive.device
    a_rank = torch.cumsum(alive, 0) - 1  # rank among alive rows
    d_rank = torch.cumsum(~alive, 0) - 1  # rank among dead rows
    dest_alive = (a_rank % d) * n_loc + a_rank // d
    slot_ids = torch.arange(cap, dtype=torch.int64, device=dev)
    # scatters into one extra slot that absorbs the masked-out writes
    used = torch.zeros((cap + 1,), dtype=torch.bool, device=dev).index_fill_(
        0, torch.where(alive, dest_alive, cap), True)[:cap]
    free_rank = torch.cumsum(~used, 0) - 1
    free_slot_of_rank = torch.zeros((cap + 1,), dtype=torch.int64,
                                    device=dev)
    free_slot_of_rank[torch.where(used, cap, free_rank)] = slot_ids
    dest = torch.where(alive, dest_alive,
                       free_slot_of_rank[torch.clamp(d_rank, min=0)])
    src_of = torch.empty_like(slot_ids)
    src_of[dest] = slot_ids
    return dest, src_of


def _pair_counts(dest: torch.Tensor, d: int) -> torch.Tensor:
    """(d, d) int64: rows moving from shard s (row) to shard r (column)."""
    n_loc = dest.shape[0] // d
    src = torch.arange(dest.shape[0], device=dest.device) // n_loc
    out = torch.zeros((d * d,), dtype=torch.int64, device=dest.device)
    out.index_add_(0, src * d + dest // n_loc, torch.ones_like(src))
    return out.reshape(d, d)


def balanced_counts(n_alive: int, d: int) -> list[int]:
    """Each shard's alive count after a rebalance of ``n_alive`` rows."""
    return [n_alive // d + (s < n_alive % d) for s in range(d)]


def prefix_pair_counts(shard_alive: Sequence[int],
                       n_loc: int) -> list[list[int]]:
    """:func:`_pair_counts` of the rebalance of a state whose shard s holds
    ``shard_alive[s]`` alive rows as the prefix of its ``n_loc`` slots, on
    the host in O(B^2): shard s's alive rows are the global alive ranks
    [P_s, P_s + c_s), and rank k goes to shard k mod B; its dead rows are
    the dead ranks [Q_s, Q_s + n_loc - c_s), and dead rank q takes the
    q-th free slot, shard r's free slots being the free ranks [F_r, F_r +
    n_loc - a_r) after its a_r alive ones."""
    d = len(shard_alive)
    n_alive = sum(shard_alive)

    def below(x: int, r: int) -> int:  # ranks k < x with k mod d == r
        return x // d + (r < x % d)

    placed = balanced_counts(n_alive, d)
    p_s = q_s = 0
    pairs = []
    for c in shard_alive:
        row, f_r = [], 0
        for r in range(d):
            dead = max(0, min(q_s + n_loc - c, f_r + n_loc - placed[r])
                       - max(q_s, f_r))
            row.append(below(p_s + c, r) - below(p_s, r) + dead)
            f_r += n_loc - placed[r]
        pairs.append(row)
        p_s += c
        q_s += n_loc - c
    return pairs


def rebalance_shards(scene: GaussianScene, opt_state: AdamState, mesh: Mesh,
                     shard_alive: Sequence[int] | None = None
                     ) -> tuple[GaussianScene, AdamState]:
    """This rank's shards after the rebalance of the whole state over the
    band group (:func:`rebalance_permutation`): every slot, moments
    included, equals the reference's ``rebalance_shards`` of the whole
    state, sharded.

    ``shard_alive``: each shard's alive count when every shard's alive
    rows are a prefix of it; the exchange's split sizes then come from the
    host.  Without it they are read from the device once."""
    d, b = mesh.band_size, mesh.band_rank
    n_loc = scene.capacity
    alive_full = _gather_rows(scene.alive.to(torch.uint8), mesh).to(
        torch.bool)
    dest, src_of = rebalance_permutation(alive_full, d)
    if shard_alive is None:
        pairs = _pair_counts(dest, d).tolist()
    elif len(shard_alive) != d:
        raise ValueError(f"{len(shard_alive)} shard counts for {d} shards")
    else:
        pairs = prefix_pair_counts(shard_alive, n_loc)
    lo = b * n_loc
    # send this shard's rows in destination order: each owner receives
    # every source's block in its slots' order
    order = torch.argsort(dest[lo:lo + n_loc])
    rows = torch.cat([pack_rows(scene.params()), opt_state.m, opt_state.v],
                     dim=1)[order]
    recv = torch.empty_like(rows)
    dist.all_to_all_single(recv, rows,
                           output_split_sizes=[pairs[s][b] for s in range(d)],
                           input_split_sizes=pairs[b], group=mesh.band_group)
    # slot j's row comes from shard src_of[lo + j] // n_loc, the blocks in
    # shard order
    src_l = src_of[lo:lo + n_loc]
    new = torch.empty_like(recv)
    new[torch.argsort(src_l // n_loc, stable=True)] = recv
    new_scene = dataclasses.replace(
        scene.with_params(unpack_rows(new[:, :PACK_DIM])),
        alive=alive_full[src_l])
    return new_scene, AdamState(new[:, PACK_DIM:2 * PACK_DIM].contiguous(),
                                new[:, 2 * PACK_DIM:].contiguous(),
                                opt_state.iteration)


@torch.no_grad()
def sharded_importance_counts(full: GaussianScene, cameras: Sequence[Camera],
                              targets, mesh: Mesh, *, mw: int, mh: int,
                              threshold: float,
                              settings: RenderSettings) -> torch.Tensor:
    """``multiview_importance_counts`` of the whole scene ``full`` with the
    views strided over the band group: band rank b renders views b, b + B,
    ... (each target resized to (mh, mw) as the single-device event does),
    one ``all_reduce`` sums the counts, then they are divided by the view
    count.  The counts are whole numbers in float32, so the sum is the
    single-device one in any order."""
    d, b = mesh.band_size, mesh.band_rank
    n_views = len(cameras)
    if len(targets) != n_views or n_views == 0:
        raise ValueError(f"{n_views} cameras and {len(targets)} targets")
    counts = torch.zeros((full.capacity,), dtype=torch.float32,
                         device=full.device)
    for v in range(b, n_views, d):
        # bilinear with antialiasing: jax.image.resize(..., "linear")
        t_small = F.interpolate(targets[v].permute(2, 0, 1)[None],
                                size=(mh, mw), mode="bilinear",
                                align_corners=False, antialias=True)
        counts = counts + view_importance_counts(
            full.params(), full.alive, full.sh_deg, cameras[v],
            t_small[0].permute(1, 2, 0), mw, mh, threshold, settings)
    if d > 1:
        dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=mesh.band_group)
    return counts / n_views


class GsDensifyResult(NamedTuple):
    """``ops/densify.py:DensifyResult``'s fields (this rank's shards, the
    event's global counts) and each shard's output count."""

    scene: GaussianScene
    opt_state: AdamState
    out_total: torch.Tensor
    in_alive: torch.Tensor
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    shard_totals: torch.Tensor  # (B,) int64, the shards' alive prefixes


@torch.no_grad()
def gs_densify_event(scene: GaussianScene, opt_state: AdamState,
                     cameras: Sequence[Camera], targets, mesh: Mesh,
                     generator: torch.Generator, *, mw: int, mh: int,
                     cfg: DensifyPruneConfig,
                     settings: RenderSettings) -> GsDensifyResult:
    """One densify / prune event on this rank's shards; returns them.

    ``cameras``: the event's V metric-viewport cameras; ``targets``: their
    V full-resolution (H, W, 3) images (a sequence or a (V, H, W, 3)
    tensor); the counts are :func:`sharded_importance_counts`'.
    ``generator``: the single-device event's noise generator,
    the same on every rank; each draws the global rows and slices its
    own.  Reads nothing back from the device."""
    d, b = mesh.band_size, mesh.band_rank
    n_loc = scene.capacity
    n_glob = n_loc * d
    lo = b * n_loc

    counts = sharded_importance_counts(
        gather_scene(scene, mesh), cameras, targets, mesh, mw=mw, mh=mh,
        threshold=cfg.metric_threshold, settings=settings)
    cnt, act = decide(scene, counts[lo:lo + n_loc], cfg)
    per_shard = _gather_rows(torch.stack([scene.alive.sum(),
                                          cnt.sum()])[None], mesh)
    in_alive = per_shard[:, 0].sum().to(torch.int32)
    totals = per_shard[:, 1]
    max_out = torch.clamp(in_alive + cfg.max_new_points_per_step, max=n_glob)
    cnt, act, _ = cap_counts(cnt, act, max_out,
                             base_offset=(torch.cumsum(totals, 0)
                                          - totals)[b])
    # the shard's slot cap: binds only when the shards are out of balance
    # near full capacity (the single-device event has no such cap)
    cnt, act, total_l = cap_counts(cnt, act, n_loc)

    # looked up at call time, so a caller can replace the noise
    jitter_u, split_d = densify_ops.densify_rng(generator, n_glob)
    new_params, new_opt, valid_out = compact_transform(
        scene.params(), opt_state, cnt, act, total_l,
        jitter_u[lo:lo + n_loc], split_d[lo:lo + n_loc])
    live = scene.alive
    per = _gather_rows(torch.stack([
        total_l.to(torch.int64), ((act == ACTION_CLONE) & live).sum(),
        ((act == ACTION_SPLIT) & live).sum(),
        ((act == ACTION_PRUNE) & live).sum()])[None], mesh)
    tot = per.sum(dim=0)
    return GsDensifyResult(
        scene=dataclasses.replace(scene.with_params(new_params),
                                  alive=valid_out),
        opt_state=new_opt, out_total=tot[0], in_alive=in_alive,
        n_cloned=tot[1], n_split=tot[2], n_pruned=tot[3],
        shard_totals=per[:, 0])


def _own_shard(x, mesh: Mesh):
    """This rank's shard of a whole scene or optimizer state, as tensors of
    its own (a view would keep the whole state's storage alive)."""
    shard = gaussian_shard(x, mesh)
    if mesh.band_size == 1:
        return shard
    if isinstance(shard, GaussianScene):
        return dataclasses.replace(
            shard, alive=shard.alive.clone(),
            **{k: v.clone() for k, v in shard.params().items()})
    return AdamState(shard.m.clone(), shard.v.clone(), shard.iteration)


class GsTrainer(Trainer):
    """The training loop with the scene and the Adam state sharded over
    the band group (``gs_train_step``) and the sharded densify event.

    ``mesh``: a 1D mesh (``make_mesh(axis_name="band")``: every rank one
    band) or a dp x band mesh (``make_mesh(shape=(V, B))``: each step
    trains V views, one per mesh row).  ``scene`` is the whole scene,
    identical on every rank; it is padded to a multiple of lcm(4096, B)
    and each rank keeps its shard.

    Entry and send capacities adapt from the step's ``entries_local_max``
    and ``send_max`` with the single-device entry capacity's headroom and
    decay, and grow with a densify swap.  With one band and a scene whose
    alive rows are a prefix (every loaded or compacted scene) it computes
    what ``Trainer`` computes, bit for bit."""

    def __init__(self, scene: GaussianScene, cameras, images,
                 config: TrainerConfig = TrainerConfig(),
                 settings: RenderSettings = DEFAULT_SETTINGS,
                 mesh: Mesh | None = None,
                 initial_capacity: int | None = None):
        if mesh is None:
            raise ValueError("GsTrainer requires a mesh")
        self.d_band = mesh.band_size
        self.n_step_views = mesh.dp_size
        if initial_capacity is not None:
            initial_capacity = -(-initial_capacity // self.d_band) \
                * self.d_band
        super().__init__(scene, cameras, images, config, settings,
                         initial_capacity=initial_capacity, mesh=mesh)
        self._gs_entry_cap: int | None = None
        self._gs_send_cap: int | None = None
        self._send_peak = 0.0
        self._shard_alive = self._keep_shard()

    def _keep_shard(self) -> list[int] | None:
        """Replace the whole state held now by this rank's shards.  Returns
        each shard's alive count if every shard's alive rows are a prefix
        of it, else None (host reads: construction and resume only)."""
        d = self.d_band
        blocks = self.scene.alive.reshape(d, -1)
        counts = blocks.sum(dim=1)
        lanes = torch.arange(blocks.shape[1], device=blocks.device)
        prefix = torch.equal(blocks, lanes[None, :] < counts[:, None])
        self.scene = _own_shard(self.scene, self.mesh)
        self.opt_state = _own_shard(self.opt_state, self.mesh)
        return counts.tolist() if prefix else None

    def _round(self, n: int) -> int:
        g = math.lcm(4096, self.d_band)
        return max(-(-n // g) * g, g)

    @property
    def capacity(self) -> int:
        return self.scene.capacity * self.d_band

    def _resize_state(self, capacity: int) -> None:
        """Pad each shard to its share of ``capacity`` (dead slots at its
        end, so every shard's alive rows stay where they are)."""
        super()._resize_state(capacity // self.d_band)

    def full_scene(self) -> GaussianScene:
        return gather_scene(self.scene, self.mesh)

    def full_opt_state(self) -> AdamState:
        return gather_opt_state(self.opt_state, self.mesh)

    def step(self) -> dict:
        """One training iteration: 1 view (a dp x band mesh: one per mesh
        row) drawn from the shared ``random.Random``."""
        t0 = time.perf_counter()
        (w, h), g = self._pick_group()
        if self.mesh.shape is not None:
            idxs = [self.rng.randrange(g["count"])
                    for _ in range(self.n_step_views)]
            cam = [g["cams"][i] for i in idxs]
            target = [g["imgs"][i] for i in idxs]
        else:
            i = self.rng.randrange(g["count"])
            cam, target = g["cams"][i], g["imgs"][i]
        self.scene, self.opt_state, metrics = gs_train_step(
            self.scene, self.opt_state, cam, target, self.mesh, img_w=w,
            img_h=h, loss_cfg=self.config.loss, hp=self.config.adam,
            settings=self.settings, send_capacity=self._gs_send_cap,
            entry_capacity=self._gs_entry_cap,
            parity_sh=not self.config.adam.full_sh)
        self.iteration += 1
        self._maybe_adapt_gs_caps(metrics)
        if self.config.densify.schedule.should_densify(self.iteration):
            self._run_densify(w, h)
        self._finish_step(t0, metrics)
        return metrics

    def _maybe_adapt_gs_caps(self, metrics) -> None:
        """The per-rank entry capacity and the per-band send budget from
        the observed loads: one read per ENTRY_CAP_INTERVAL, as the
        single-device entry capacity."""
        if self.iteration != 1 and self.iteration % self.ENTRY_CAP_INTERVAL:
            return
        chunk = self.settings.chunk
        e_obs, s_obs = torch.stack([metrics["entries_local_max"],
                                    metrics["send_max"]]).tolist()
        self._entry_cap_peak = max(float(e_obs), self.ENTRY_CAP_DECAY
                                   * self._entry_cap_peak)
        self._send_peak = max(float(s_obs),
                              self.ENTRY_CAP_DECAY * self._send_peak)
        want_e = quantize_budget(self._entry_cap_peak
                                 * self.ENTRY_CAP_HEADROOM, chunk, chunk * 8)
        cur = self._gs_entry_cap
        if cur is None or want_e > cur or want_e < cur // 2:
            self._gs_entry_cap = want_e
        want_s = quantize_budget(self._send_peak * self.ENTRY_CAP_HEADROOM,
                                 chunk, chunk)
        cur = self._gs_send_cap
        if cur is None or want_s > cur or want_s < cur // 2:
            self._gs_send_cap = want_s

    @torch.no_grad()
    def _run_densify(self, w: int, h: int) -> None:
        cfg = self.config.densify
        g = self.groups[(w, h)]
        downscale = max(1, int(cfg.metric_downscale))
        mw, mh = max(1, w // downscale), max(1, h // downscale)

        self._grow_capacity()
        self.scene, self.opt_state = rebalance_shards(
            self.scene, self.opt_state, self.mesh, self._shard_alive)
        self._shard_alive = balanced_counts(self.num_points, self.d_band)

        n_views = min(max(1, cfg.metric_views), g["count"])
        view_idx = self.rng.sample(range(g["count"]), k=n_views)
        result = gs_densify_event(
            self.scene, self.opt_state,
            [self._metric_camera(g["cams"][i], mw, mh) for i in view_idx],
            [g["imgs"][i] for i in view_idx], self.mesh, self.generator,
            mw=mw, mh=mh, cfg=cfg, settings=self.settings)

        # the event's one read: its counts and each shard's output count
        vals = torch.cat([torch.stack([
            result.out_total, result.in_alive, result.n_cloned,
            result.n_split, result.n_pruned]).to(torch.int64),
            result.shard_totals]).tolist()
        out_total, in_alive, cloned, split, pruned = vals[:5]
        self.last_densify_event = {
            "iteration": self.iteration, "in": in_alive, "out": out_total,
            "cloned": cloned, "split": split, "pruned": pruned}
        if out_total == 0 or out_total == in_alive:
            return  # the reference skips the swap; the rebalance stays
        self.scene = result.scene
        self.opt_state = result.opt_state
        self._shard_alive = vals[5:]
        self.num_points = out_total
        self.last_densify_iteration = self.iteration
        self._grow_entry_cap_for_swap(out_total, in_alive)

    def _grow_entry_cap_for_swap(self, out_total: int, in_alive: int) -> None:
        """A swap scales the per-rank entry load and the send load about
        linearly with the alive count: both budgets grow with it."""
        if not (out_total > in_alive > 0):
            return
        ratio = out_total / in_alive
        chunk = self.settings.chunk
        self._entry_cap_peak *= ratio
        self._send_peak *= ratio
        want_e = quantize_budget(self._entry_cap_peak
                                 * self.ENTRY_CAP_HEADROOM, chunk, chunk * 8)
        if self._gs_entry_cap is None or want_e > self._gs_entry_cap:
            self._gs_entry_cap = want_e
        want_s = quantize_budget(self._send_peak * self.ENTRY_CAP_HEADROOM,
                                 chunk, chunk)
        if self._gs_send_cap is None or want_s > self._gs_send_cap:
            self._gs_send_cap = want_s

    def resume_from(self, scene: GaussianScene,
                    opt_state: AdamState | None, iteration: int) -> None:
        """Restore from a whole checkpoint scene (every rank loads the same
        file) and keep this rank's shard."""
        super().resume_from(scene, opt_state, iteration)
        self._shard_alive = self._keep_shard()

    # snapshots hold references (steps build new tensors); every rank
    # rolls back together, since the loss is reduced over the mesh
    def _snapshot(self) -> None:
        super()._snapshot()
        self._last_good_shards = self._shard_alive

    def _rollback(self) -> None:
        super()._rollback()
        self._shard_alive = self._last_good_shards
