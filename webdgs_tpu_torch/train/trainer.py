"""The training orchestrator (counterpart of
webdgs_tpu/train/trainer.py:44-621).

Owns the scene and the optimizer state, draws a random (camera, image)
pair per step with ``random.Random(config.seed)`` -- the same view
sequence as the JAX trainer -- runs ``train_step``, fires the densify /
prune schedule, adapts the tile-entry capacity to the observed entry
demand, meters iterations per second, snapshots the state and rolls back
on a non-finite loss, evaluates PSNR / L1 / SSIM, and checkpoints.

A densify event renders ``metric_views`` views drawn with the same
``random.Random`` at the metric resolution (the importance kernel), runs
``densify_prune`` with noise from a ``torch.Generator`` seeded from
``config.seed``, and swaps the state in; capacity grows geometrically when
the headroom runs out.  An event reads its point counts and decisions back
in one transfer; it also waits on the device where the metric camera and
the view indices are uploaded (PERF.md section 5 lists the lines).

With ``mesh=`` (``parallel/sharding.py:make_mesh``) of more than one rank,
each step draws one view per rank from the shared ``random.Random`` (every
rank draws the same indices) and trains them view-data-parallel through
``dp_train_step``; densify events run replicated, every rank taking the
same decisions from the same state, since the kernels are deterministic.
Only rank 0 logs and writes checkpoints in ``train``.  A mesh of one rank
takes the single-device step.  ``parallel/gs_trainer.py:GsTrainer`` holds
shards of the scene instead; the hooks it overrides are ``_round``,
``capacity``, ``_resize_state``, ``full_scene`` and ``full_opt_state``.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time

import numpy as np
import torch
import torch.nn.functional as F

from webdgs_tpu_torch.config import (DEFAULT_SETTINGS, RenderSettings,
                                     quantize_budget)
from webdgs_tpu_torch.core.camera import Camera, CameraData, make_camera
from webdgs_tpu_torch.core.scene import GaussianScene
from webdgs_tpu_torch.ops.adam import AdamState, init_adam_state
from webdgs_tpu_torch.ops.densify import densify_prune
from webdgs_tpu_torch.ops.importance import multiview_importance_counts
from webdgs_tpu_torch.ops.loss import loss_metrics, pixel_loss_gradient, ssim
from webdgs_tpu_torch.parallel.sharding import dp_train_step
from webdgs_tpu_torch.render.renderer import render
from webdgs_tpu_torch.train.config import TrainerConfig, _merge_dataclass
from webdgs_tpu_torch.train.step import train_step

def _round_capacity(n: int, granule: int = 4096) -> int:
    return max(-(-n // granule) * granule, granule)


def _group_views(cameras: list[CameraData], images: list[dict],
                 device: torch.device) -> dict:
    """Group (camera, image) pairs by resolution; each group holds its
    device cameras and a stacked (V, H, W, 3) image tensor."""
    groups: dict[tuple[int, int], dict] = {}
    for cam_data, img in zip(cameras, images):
        res = (img["width"], img["height"])
        g = groups.setdefault(res, {"cams": [], "imgs": []})
        g["cams"].append(make_camera(cam_data, *res, device=device))
        g["imgs"].append(img["image"])
    for g in groups.values():
        g["imgs"] = torch.tensor(np.stack(g["imgs"], axis=0),
                                 dtype=torch.float32, device=device)
        g["count"] = len(g["cams"])
    return groups


class Trainer:
    def __init__(self, scene: GaussianScene, cameras: list[CameraData],
                 images: list[dict], config: TrainerConfig = TrainerConfig(),
                 settings: RenderSettings = DEFAULT_SETTINGS,
                 initial_capacity: int | None = None, mesh=None):
        """Trains on ``scene.device``; ``initial_capacity`` sets the
        scene's padded capacity (default: the alive count rounded up).
        ``mesh``: a ``parallel.sharding.Mesh`` whose device holds the
        scene; with more than one rank every step trains on one view per
        rank, data-parallel."""
        if mesh is not None and mesh.device != scene.device:
            raise ValueError(f"the scene is on {scene.device}, the mesh's "
                             f"rank on {mesh.device}")
        if len(cameras) != len(images):
            raise ValueError(
                f"cameras ({len(cameras)}) and images ({len(images)}) must "
                "pair by index")
        self.config = config
        self.settings = settings
        self.mesh = mesh
        self.device = scene.device
        lam = (config.loss.lambda_l1 + config.loss.lambda_l2
               + config.loss.lambda_dssim)
        if not 0.99 <= lam <= 1.01:
            import warnings
            warnings.warn(f"loss weights sum to {lam:.3f}, expected ~1.0",
                          stacklevel=2)
        self.rng = random.Random(config.seed)
        # the densify noise; replaces the reference's jax.random key
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)

        self.groups = _group_views(cameras, images, self.device)

        self.num_points = int(scene.num_alive())
        cap = initial_capacity or self._round(scene.capacity)
        self.scene = scene.pad_to(cap)
        self.opt_state = init_adam_state(self.scene.params())

        self.iteration = 0
        self._entry_cap_value: int | None = None
        self._entry_cap_peak = 0.0
        self.step_ms = 0.0
        self.iters_per_sec = 0.0
        self._rate_mark: tuple[int, float] | None = None
        self.last_densify_iteration: int | None = None
        # the last event's point counts and decisions, swapped in or not
        self.last_densify_event: dict | None = None
        self.last_metrics: dict = {}

    def set_config(self, updates) -> None:
        """Apply a deep-partial config update (a dict such as
        ``{"adam": {"lr_pos": 0.0}}``, or a full TrainerConfig)."""
        self.config = (updates if isinstance(updates, TrainerConfig)
                       else _merge_dataclass(self.config, updates))

    def set_settings(self, updates) -> None:
        """Apply a partial RenderSettings update (or a full one)."""
        self.settings = (updates if isinstance(updates, RenderSettings)
                         else dataclasses.replace(self.settings, **updates))

    # ------------------------------------------------------------------
    def _pick_group(self):
        total = sum(g["count"] for g in self.groups.values())
        r = self.rng.randrange(total)
        for res, g in self.groups.items():
            if r < g["count"]:
                return res, g
            r -= g["count"]
        raise AssertionError

    # adaptive tile-entry capacity: every O(entries) op is sized by it.  It
    # starts at the heuristic, then follows the observed per-frame entry
    # demand with headroom (one host read every ENTRY_CAP_INTERVAL steps).
    ENTRY_CAP_INTERVAL = 50
    ENTRY_CAP_HEADROOM = 1.2
    # the peak decays between observations so an early spike does not
    # oversize the buffers for good
    ENTRY_CAP_DECAY = 0.9

    def _entry_cap(self) -> int | None:
        return self._entry_cap_value

    def _maybe_adapt_entry_cap(self, metrics) -> None:
        if self.iteration != 1 and self.iteration % self.ENTRY_CAP_INTERVAL:
            return
        observed = float(metrics["tile_entries"])
        self._entry_cap_peak = max(observed,
                                   self.ENTRY_CAP_DECAY * self._entry_cap_peak)
        chunk = self.settings.chunk
        want = quantize_budget(self._entry_cap_peak * self.ENTRY_CAP_HEADROOM,
                               chunk, chunk * 8)
        cur = self._entry_cap_value
        # grow whenever short on headroom; shrink only when far oversized
        if cur is None or want > cur or want < cur // 2:
            self._entry_cap_value = want

    def step(self) -> dict:
        """One training iteration."""
        t0 = time.perf_counter()
        (w, h), g = self._pick_group()
        step_kw = dict(img_w=w, img_h=h, loss_cfg=self.config.loss,
                       hp=self.config.adam, settings=self.settings,
                       entry_capacity=self._entry_cap())
        if self.mesh is not None and self.mesh.size > 1:
            # every rank draws the same indices; rank b trains view b
            idxs = [self.rng.randrange(g["count"])
                    for _ in range(self.mesh.size)]
            self.scene, self.opt_state, metrics = dp_train_step(
                self.scene, self.opt_state, [g["cams"][i] for i in idxs],
                [g["imgs"][i] for i in idxs], self.mesh, **step_kw)
        else:
            idx = self.rng.randrange(g["count"])
            self.scene, self.opt_state, metrics = train_step(
                self.scene, self.opt_state, g["cams"][idx], g["imgs"][idx],
                **step_kw)
        self.iteration += 1
        self._maybe_adapt_entry_cap(metrics)
        if self.config.densify.schedule.should_densify(self.iteration):
            self._run_densify(w, h)
        self._finish_step(t0, metrics)
        return metrics

    RATE_SYNC_INTERVAL = 100

    def _finish_step(self, t0: float, metrics: dict) -> None:
        """Step time and the iterations/s meter.  A step returns before the
        device finishes, so the rate spans the wall time between real
        syncs: every RATE_SYNC_INTERVAL steps one loss scalar is read."""
        self.step_ms = (time.perf_counter() - t0) * 1e3
        if self.iteration % self.RATE_SYNC_INTERVAL == 0:
            _ = float(metrics["loss"])  # block until this step finished
            now = time.perf_counter()
            if self._rate_mark is not None:
                it0, tm = self._rate_mark
                if self.iteration > it0 and now > tm:
                    self.iters_per_sec = (self.iteration - it0) / (now - tm)
            self._rate_mark = (self.iteration, now)
        self.last_metrics = metrics

    # ------------------------------------------------------------------
    @staticmethod
    def _metric_camera(cam: Camera, mw: int, mh: int) -> Camera:
        """The camera re-derived at the metric viewport: fovY kept, focal
        from fovY and the metric height, so only the viewport-dependent
        projection entries p00 = 2f/w and p11 = -2f/h change (the same
        values as ``make_camera(data, mw, mh)``)."""
        f_m = cam.focal[1] * (mh / cam.viewport[1])  # = 0.5*mh/tan(fovY/2)
        proj = cam.proj.clone()
        proj[0, 0] = 2.0 * f_m / mw
        proj[1, 1] = -2.0 * f_m / mh
        return Camera(
            view=cam.view, proj=proj, cam_pos=cam.cam_pos,
            focal=torch.stack([f_m, f_m]),
            viewport=torch.tensor([mw, mh], dtype=torch.float32,
                                  device=cam.viewport.device))

    def _round(self, n: int) -> int:
        """The capacity rounding policy (the Gaussian-sharded trainer also
        makes it divisible by its band count)."""
        return _round_capacity(n)

    @property
    def capacity(self) -> int:
        """The whole scene's padded capacity."""
        return self.scene.capacity

    def _resize_state(self, capacity: int) -> None:
        """Pad the scene and the optimizer state to ``capacity`` slots."""
        self.scene = self.scene.pad_to(capacity)
        self.opt_state = self.opt_state.pad_to(capacity)

    def _grow_capacity(self) -> None:
        """Grow the scene and optimizer capacity when the densify headroom
        is short (the analogue of the reference's buffer swap)."""
        cfg = self.config.densify
        needed = self.num_points + cfg.max_new_points_per_step
        budget = cfg.max_buffer_bytes // 96  # sh-buffer stride analogue
        if needed > self.capacity and self.capacity < budget:
            new_cap = self._round(min(int(needed * 1.5), budget))
            if new_cap > self.capacity:
                self._resize_state(new_cap)

    @torch.no_grad()
    def _run_densify(self, w: int, h: int) -> None:
        cfg = self.config.densify
        g = self.groups[(w, h)]
        downscale = max(1, int(cfg.metric_downscale))
        mw, mh = max(1, w // downscale), max(1, h // downscale)

        self._grow_capacity()

        n_views = min(max(1, cfg.metric_views), g["count"])
        view_idx = self.rng.sample(range(g["count"]), k=n_views)
        cams = [self._metric_camera(g["cams"][i], mw, mh) for i in view_idx]
        targets = g["imgs"][view_idx].permute(0, 3, 1, 2)
        # bilinear with antialiasing: jax.image.resize(..., "linear")
        t_small = F.interpolate(targets, size=(mh, mw), mode="bilinear",
                                align_corners=False, antialias=True)
        counts = multiview_importance_counts(
            self.scene.params(), self.scene.alive, self.scene.sh_deg, cams,
            t_small.permute(0, 2, 3, 1), mw, mh, cfg.metric_threshold,
            self.settings)
        result = densify_prune(self.scene, self.opt_state, counts, cfg,
                               self.generator)

        # the event's one read of its counts and decisions
        out_total, in_alive, cloned, split, pruned = torch.stack([
            result.out_total, result.in_alive, result.n_cloned,
            result.n_split, result.n_pruned]).tolist()
        self.last_densify_event = {
            "iteration": self.iteration, "in": in_alive, "out": out_total,
            "cloned": cloned, "split": split, "pruned": pruned}
        if out_total == 0 or out_total == in_alive:
            return  # the reference skips the swap
        self.scene = result.scene
        self.opt_state = result.opt_state
        self.num_points = out_total
        self.last_densify_iteration = self.iteration
        self._grow_entry_cap_for_swap(out_total, in_alive)

    def _grow_entry_cap_for_swap(self, out_total: int, in_alive: int) -> None:
        """Entry demand scales about linearly with the alive points: grow
        the entry-cap peak with a densify swap instead of waiting for the
        next adaptation read."""
        if not (out_total > in_alive > 0):
            return
        self._entry_cap_peak *= out_total / in_alive
        chunk = self.settings.chunk
        want = quantize_budget(self._entry_cap_peak * self.ENTRY_CAP_HEADROOM,
                               chunk, chunk * 8)
        if self._entry_cap_value is None or want > self._entry_cap_value:
            self._entry_cap_value = want

    def next_densify_iteration(self) -> int | None:
        """The iteration of the next densify event, or None."""
        s = self.config.densify.schedule
        if not s.enabled:
            return None
        i = self.iteration
        if i >= s.stop_iterations:
            return None
        if i < s.warmup_iterations:
            return min(s.warmup_iterations, s.stop_iterations)
        interval = max(1, s.interval)
        k = -(-(i + 1 - s.warmup_iterations) // interval)
        nxt = s.warmup_iterations + k * interval
        return nxt if nxt <= s.stop_iterations else None

    # ------------------------------------------------------------------
    def full_scene(self) -> GaussianScene:
        """The whole scene (a sharded trainer gathers it: every rank must
        call this)."""
        return self.scene

    def full_opt_state(self) -> AdamState:
        """The whole optimizer state (gathered like :meth:`full_scene`)."""
        return self.opt_state

    @torch.no_grad()
    def evaluate(self, max_views: int | None = None,
                 views: tuple[list, list] | None = None,
                 groups: dict | None = None,
                 scene: GaussianScene | None = None) -> dict:
        """Mean PSNR / L1 / SSIM over the first ``max_views`` dataset views
        (all by default).  ``views``: optional (cameras, images) lists to
        evaluate instead of the training set (e.g. a held-out split);
        ``groups``: a ``_group_views`` result of such a split, for callers
        that evaluate it repeatedly (grouping uploads every image);
        ``scene``: a whole scene to evaluate instead of
        :meth:`full_scene` (one already gathered)."""
        if scene is None:
            scene = self.full_scene()
        if groups is None:
            groups = (self.groups if views is None
                      else _group_views(views[0], views[1], self.device))
        per_view = []
        remaining = max_views
        for (w, h), g in groups.items():
            if remaining is not None and remaining <= 0:
                break
            take = g["count"] if remaining is None else min(g["count"],
                                                            remaining)
            for i in range(take):
                pred = render(scene, g["cams"][i], w, h, self.settings,
                              entry_capacity=self._entry_cap()).image
                m = loss_metrics(pred, g["imgs"][i], self.config.loss)
                per_view.append(torch.stack(
                    [m["psnr"], m["l1"], ssim(pred, g["imgs"][i])]))
            if remaining is not None:
                remaining -= take
        if not per_view:
            return {"psnr": float("nan"), "l1": float("nan"),
                    "ssim": float("nan"), "views": 0}
        allv = torch.stack(per_view).cpu().numpy()
        return {"psnr": float(allv[:, 0].mean()),
                "l1": float(allv[:, 1].mean()),
                "ssim": float(allv[:, 2].mean()),
                "views": int(allv.shape[0])}

    def _view(self, index: int):
        flat = [(res, g, i) for res, g in self.groups.items()
                for i in range(g["count"])]
        return flat[index]

    @torch.no_grad()
    def render_view(self, index: int) -> torch.Tensor:
        """Render one dataset view at full resolution, (H, W, 3)."""
        (w, h), g, i = self._view(index)
        return render(self.full_scene(), g["cams"][i], w, h,
                      self.settings).image

    @torch.no_grad()
    def visualize_loss(self, index: int) -> torch.Tensor:
        """Per-pixel |dL/dpixel| map of a dataset view (the reference's
        show-loss debug view)."""
        (w, h), g, i = self._view(index)
        img = render(self.full_scene(), g["cams"][i], w, h, self.settings,
                     entry_capacity=self._entry_cap()).image
        return torch.abs(pixel_loss_gradient(img, g["imgs"][i],
                                             self.config.loss))

    def set_dataset(self, cameras: list[CameraData],
                    images: list[dict]) -> None:
        """Swap the training views mid-training; the scene, optimizer and
        iteration stay as they are."""
        if len(cameras) != len(images):
            raise ValueError(
                f"cameras ({len(cameras)}) and images ({len(images)}) must "
                "pair by index")
        if not cameras:
            raise ValueError("dataset must contain at least one view")
        self.groups = _group_views(cameras, images, self.device)
        self.dataset_cameras = cameras

    def resume_from(self, scene: GaussianScene,
                    opt_state: AdamState | None, iteration: int) -> None:
        """Restore training state (e.g. from ``load_checkpoint``)."""
        cap = self._round(scene.capacity)
        self.scene = scene.to(self.device).pad_to(cap)
        if opt_state is not None:
            self.opt_state = opt_state.to(self.device).pad_to(cap)
        else:
            self.opt_state = init_adam_state(self.scene.params())
        self.iteration = int(iteration)
        self.num_points = int(self.scene.num_alive())

    # failure recovery: snapshot the training state every interval; a
    # non-finite loss rolls back to the last good state and continues with
    # fresh view draws.  Steps build new tensors (nothing is updated in
    # place), so a snapshot holds references, not copies.
    SNAPSHOT_INTERVAL = 250
    MAX_ROLLBACKS = 5

    def _snapshot(self) -> None:
        self._last_good = (self.scene, self.opt_state, self.iteration,
                           self.num_points)

    def _rollback(self) -> None:
        scene, opt, it, npts = self._last_good
        self.scene, self.opt_state = scene, opt
        self.iteration, self.num_points = it, npts

    def train(self, num_iterations: int | None = None,
              log_every: int = 100, log_fn=print,
              checkpoint_every: int = 0,
              checkpoint_path: str | None = None,
              profile_dir: str | None = None) -> dict:
        """Run ``num_iterations`` steps (default: up to
        ``config.max_iterations``); returns the last step's metrics.  Under
        a mesh only rank 0 logs and writes checkpoints (every rank takes
        part in a checkpoint's gather).  ``profile_dir``: trace the run
        with ``torch.profiler`` (the card's kernels too, on CUDA) and write
        a Chrome trace there."""
        if not self.is_lead:
            log_fn = None
        prof = None
        if profile_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        try:
            self._train_loop(num_iterations, log_every, log_fn,
                             checkpoint_every, checkpoint_path)
        finally:
            if prof is not None:
                prof.stop()
                os.makedirs(profile_dir, exist_ok=True)
                rank = 0 if self.mesh is None else self.mesh.rank
                prof.export_chrome_trace(os.path.join(
                    profile_dir, f"trace_rank{rank}.json"))
        return {k: float(v) for k, v in self.last_metrics.items()}

    @property
    def is_lead(self) -> bool:
        """True on the rank that logs and writes (every process without a
        mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def write_checkpoint(self, path: str) -> None:
        """Save the whole state to ``path``.  Every rank calls this: the
        gather of a sharded trainer runs on all of them, and only the lead
        rank writes."""
        from webdgs_tpu_torch.io.checkpoint import save_checkpoint
        scene, opt_state = self.full_scene(), self.full_opt_state()
        if self.is_lead:
            save_checkpoint(path, scene, opt_state, iteration=self.iteration)

    def _train_loop(self, num_iterations, log_every, log_fn,
                    checkpoint_every, checkpoint_path) -> None:
        rollbacks = 0
        self._snapshot()
        check_every = min(log_every or self.SNAPSHOT_INTERVAL,
                          self.SNAPSHOT_INTERVAL)
        n = num_iterations or self.config.max_iterations
        for _ in range(n):
            metrics = self.step()
            it = self.iteration
            if (it % check_every == 0
                    or it % self.SNAPSHOT_INTERVAL == 0):
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    rollbacks += 1
                    if rollbacks > self.MAX_ROLLBACKS:
                        raise FloatingPointError(
                            f"loss non-finite after {rollbacks} "
                            "consecutive rollbacks; training diverged")
                    if log_fn:
                        log_fn(f"iter {self.iteration}: loss={loss} -- "
                               f"rolling back to iteration "
                               f"{self._last_good[2]}")
                    self._rollback()
                    continue
                if it % self.SNAPSHOT_INTERVAL == 0:
                    rollbacks = 0
                    self._snapshot()
            if log_every and self.iteration % log_every == 0 and log_fn:
                log_fn(f"iter {self.iteration}: "
                       f"loss={float(metrics['loss']):.4f} "
                       f"psnr={float(metrics['psnr']):.2f} "
                       f"points={self.num_points} "
                       f"({self.iters_per_sec:.1f} it/s)")
            if (checkpoint_every and checkpoint_path
                    and self.iteration % checkpoint_every == 0):
                self.write_checkpoint(checkpoint_path)
            if self.iteration >= self.config.max_iterations:
                break
