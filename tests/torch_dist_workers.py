"""Rank workers of tests/test_torch_sharding.py and tests/test_torch_gs_*.py:
each case runs on every rank of a gloo group started by
``torch.multiprocessing.spawn`` and saves its arrays to
``<out_dir>/<case>_r<rank>.npz`` for the parent to check.

This module imports torch and the port only, never jax: a spawned rank
imports it afresh, and the JAX side of a parity test runs in the parent.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from webdgs_tpu_torch.config import RenderSettings
from webdgs_tpu_torch.core.camera import CameraData, default_camera
from webdgs_tpu_torch.core.scene import scene_from_numpy
from webdgs_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from webdgs_tpu_torch.ops import densify as densify_ops
from webdgs_tpu_torch.ops.adam import (AdamHyperparameters, AdamState,
                                       adam_step, init_adam_state)
from webdgs_tpu_torch.ops.loss import LossConfig
from webdgs_tpu_torch.parallel.gs_trainer import (GsTrainer,
                                                  gs_densify_event,
                                                  rebalance_shards,
                                                  sharded_importance_counts)
from webdgs_tpu_torch.parallel.sharding import (dp_train_step,
                                                gaussian_shard, gs_train_step,
                                                make_mesh,
                                                render_gaussian_sharded,
                                                render_tile_sharded)
from webdgs_tpu_torch.render.renderer import render
from webdgs_tpu_torch.train.config import (DensifyPruneConfig,
                                           DensifySchedule, TrainerConfig)
from webdgs_tpu_torch.train.step import compute_param_grads, train_step
from webdgs_tpu_torch.train.trainer import Trainer

SETTINGS = RenderSettings(chunk=128)
GROUP_TIMEOUT_S = 60.0


def _scene(params):
    n = params["means"].shape[0]
    return scene_from_numpy(params, np.ones(n, bool), 0, "cpu")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _params(prefix: str, params: dict) -> dict:
    return {f"{prefix}{k}": _np(v) for k, v in params.items()}


def _views(inp):
    """CameraData and image records of the parent's views."""
    w, h = inp["w"], inp["h"]
    fy = 0.5 * h / np.tan(np.radians(45.0) / 2)
    cams, imgs = [], []
    for i, (pos, img) in enumerate(zip(inp["positions"], inp["images"])):
        cams.append(CameraData(id=i, position=np.asarray(pos, np.float32),
                               rotation=np.eye(3, dtype=np.float32),
                               fx=fy, fy=fy, width=w, height=h,
                               img_name=f"v{i}.png"))
        imgs.append({"name": f"v{i}.png", "image": img, "width": w,
                     "height": h})
    return cams, imgs


def case_tile_sharded(mesh, inp, out_dir):
    w, h = inp["w"], inp["h"]
    scene = _scene(inp["params"])
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0), device="cpu")
    with torch.no_grad():
        single = render(scene, cam, w, h, SETTINGS).image
    sharded = render_tile_sharded(scene, cam, w, h, mesh, SETTINGS)
    band = render_tile_sharded(scene, cam, w, h, mesh, SETTINGS,
                               gather=False)
    return {"single": _np(single), "sharded": _np(sharded),
            "band": _np(band)}


def case_dp_step(mesh, inp, out_dir):
    """dp_train_step over the parent's V views, and on every rank the
    single-device composition: the image-space gradients of each view
    summed, divided by V, then adam_step."""
    w, h = inp["w"], inp["h"]
    scene = _scene(inp["params"])
    cams = [default_camera(w, h, position=tuple(p), device="cpu")
            for p in inp["positions"]]
    targets = torch.tensor(inp["images"])
    hp, cfg = AdamHyperparameters(), LossConfig()
    opt = init_adam_state(scene.params())
    new_scene, new_opt, metrics = dp_train_step(
        scene, opt, cams, targets, mesh, img_w=w, img_h=h, loss_cfg=cfg,
        hp=hp, settings=SETTINGS)

    grads = {k: torch.zeros_like(v) for k, v in scene.params().items()}
    counts = torch.zeros((scene.capacity,), dtype=torch.int32)
    for cam, target in zip(cams, targets):
        _, g, aux, _ = compute_param_grads(scene, cam, target, w, h, cfg,
                                           SETTINGS, parity_sh=True)
        grads = {k: grads[k] + g[k] for k in grads}
        counts = counts + aux.num_tiles
    grads = {k: v / len(cams) for k, v in grads.items()}
    with torch.no_grad():
        ref_params, _ = adam_step(scene.params(), grads, opt, hp, counts)
    return {**_params("dp_", new_scene.params()),
            **_params("ref_", ref_params),
            "m": _np(new_opt.m), "v": _np(new_opt.v),
            "iteration": np.asarray(new_opt.iteration),
            **{f"metric_{k}": _np(v) for k, v in metrics.items()}}


def case_trainer(mesh, inp, out_dir):
    """Three dp steps through the Trainer, then ``train`` for two more
    (rank 0 alone logs and checkpoints), then every rank resumes from
    rank 0's checkpoint."""
    cams, imgs = _views(inp)
    cfg = TrainerConfig(
        densify=DensifyPruneConfig(schedule=DensifySchedule(enabled=False)))
    tr = Trainer(_scene(inp["params"]), cams, imgs, cfg, SETTINGS,
                 initial_capacity=16, mesh=mesh)
    losses = [float(tr.step()["loss"]) for _ in range(3)]
    after_steps = dict(iteration=tr.iteration,
                       entry_cap_peak=tr._entry_cap_peak,
                       psnr=float(tr.last_metrics["psnr"]))
    lines = []
    ck = os.path.join(out_dir, f"ck_r{mesh.rank}.npz")
    last = tr.train(num_iterations=2, log_every=1, log_fn=lines.append,
                    checkpoint_every=1, checkpoint_path=ck)
    before = _params("trained_", tr.scene.params())
    dist.barrier(group=mesh.group)
    scene, opt, meta = load_checkpoint(os.path.join(out_dir, "ck_r0.npz"),
                                       "cpu")
    tr.resume_from(scene, opt, meta.get("iteration") or 0)
    return {"losses": np.asarray(losses),
            **{k: np.asarray(v) for k, v in after_steps.items()},
            "last_loss": np.asarray(last["loss"]),
            "log_lines": np.asarray(len(lines)),
            "resumed_iteration": np.asarray(tr.iteration),
            **before, **_params("resumed_", tr.scene.params()),
            "resumed_m": _np(tr.opt_state.m)}


def case_trainer_densify(mesh, inp, out_dir):
    cams, imgs = _views(inp)
    cfg = TrainerConfig(densify=DensifyPruneConfig(
        schedule=DensifySchedule(enabled=True, warmup_iterations=2,
                                 interval=2, stop_iterations=10),
        metric_views=2, clone_threshold_count=1, prune_opacity=0.005))
    tr = Trainer(_scene(inp["params"]), cams, imgs, cfg, SETTINGS,
                 initial_capacity=64, mesh=mesh)
    losses = [float(tr.step()["loss"]) for _ in range(5)]
    event = tr.last_densify_event
    losses.append(float(tr.step()["loss"]))  # the step after the swap
    return {"losses": np.asarray(losses),
            "densified_at": np.asarray(tr.last_densify_iteration or -1),
            "event": np.asarray([event[k] for k in (
                "iteration", "in", "out", "cloned", "split", "pruned")]),
            "num_points": np.asarray(tr.num_points),
            "alive": _np(tr.scene.alive), "m": _np(tr.opt_state.m),
            **_params("p_", tr.scene.params())}


# the exact float32 entry exchange (the f16 default is the f16-class cases)
SETTINGS_EXACT = dataclasses.replace(SETTINGS, exchange_f16=False)


def _gs_renders(mesh, params, w, h, settings, send_capacity=None,
                prefix=""):
    """The Gaussian-sharded frame of a scene (this rank's shard of it),
    gathered and as this rank's band, and its drop count."""
    shard = gaussian_shard(_scene(params), mesh)
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0), device="cpu")
    img, dropped = render_gaussian_sharded(shard, cam, w, h, mesh, settings,
                                           send_capacity=send_capacity)
    band, _ = render_gaussian_sharded(shard, cam, w, h, mesh, settings,
                                      send_capacity=send_capacity,
                                      gather=False)
    return {f"{prefix}image": _np(img), f"{prefix}band": _np(band),
            f"{prefix}dropped": _np(dropped)}


def case_gs_render(mesh, inp, out_dir):
    """render_gaussian_sharded with the f32 and the f16 exchange, the
    port's single-device render of the same scene, and, given
    ``drop_params``, the concentrated scene at 16x16 tiles with a one-chunk
    send budget."""
    w, h = inp["w"], inp["h"]
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0), device="cpu")
    with torch.no_grad():
        single = render(_scene(inp["params"]), cam, w, h, SETTINGS).image
    out = {"single": _np(single),
           **_gs_renders(mesh, inp["params"], w, h, SETTINGS_EXACT, None,
                         "f32_"),
           **_gs_renders(mesh, inp["params"], w, h, SETTINGS, None, "f16_")}
    if "drop_params" in inp:
        s16 = dataclasses.replace(SETTINGS, tile_w=16, tile_h=16)
        out.update(_gs_renders(mesh, inp["drop_params"], w, h, s16,
                               s16.chunk, "drop_"))
    return out


def _gs_step(mesh, params, cams, targets, w, h, settings, prefix):
    """One gs_train_step from the scene's shard and fresh moments: this
    rank's updated shard, moments and metrics."""
    scene = _scene(params)
    new = gs_train_step(
        gaussian_shard(scene, mesh),
        gaussian_shard(init_adam_state(scene.params()), mesh), cams,
        targets, mesh, img_w=w, img_h=h, settings=settings)
    return {**_params(f"{prefix}p_", new.scene.params()),
            f"{prefix}m": _np(new.opt_state.m),
            f"{prefix}v": _np(new.opt_state.v),
            **{f"{prefix}metric_{k}": _np(v)
               for k, v in new.metrics.items()}}


def case_gs_step(mesh, inp, out_dir):
    """gs_train_step on a 1D band mesh: f32 exchange twice (the second a
    determinism check), the f16 exchange, and the image-space branch on a
    frame under 5 px tall; the port's single-device train_step of the
    f32 case beside them."""
    w, h = inp["w"], inp["h"]
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0), device="cpu")
    target = torch.tensor(inp["target"])
    out = {}
    for prefix, st in (("f32_", SETTINGS_EXACT), ("again_", SETTINGS_EXACT),
                       ("f16_", SETTINGS)):
        out.update(_gs_step(mesh, inp["params"], cam, target, w, h, st,
                            prefix))
    scene = _scene(inp["params"])
    ref = train_step(scene, init_adam_state(scene.params()), cam, target,
                     img_w=w, img_h=h, settings=SETTINGS_EXACT)
    out.update(_params("single_p_", ref.scene.params()))
    out["single_m"] = _np(ref.opt_state.m)
    sw, sh = inp["small_size"]
    cam_s = default_camera(sw, sh, position=(0.0, 0.0, -5.0), device="cpu")
    out.update(_gs_step(mesh, inp["params"], cam_s,
                        torch.tensor(inp["small_target"]), sw, sh,
                        SETTINGS_EXACT, "small_"))
    return out


def case_gs_mesh2d(mesh, inp, out_dir):
    """On a (V, B) dp x band mesh: one gs_train_step over V views; and over
    all the ranks as one band group (the 1D view of the same processes)
    the f32 Gaussian-sharded render of ``render_params`` and one
    gs_train_step at ``render_size`` beside the single-device step."""
    w, h = inp["w"], inp["h"]
    cams = [default_camera(w, h, position=tuple(p), device="cpu")
            for p in inp["positions"]]
    out = _gs_step(mesh, inp["params"], cams, torch.tensor(inp["images"]),
                   w, h, SETTINGS_EXACT, "")
    flat = dataclasses.replace(mesh, shape=None, band_group=mesh.group,
                               dp_group=None)
    rw, rh = inp["render_size"]
    cam = default_camera(rw, rh, position=(0.0, 0.0, -5.0), device="cpu")
    with torch.no_grad():
        single = render(_scene(inp["render_params"]), cam, rw, rh,
                        SETTINGS).image
    out.update(_gs_renders(flat, inp["render_params"], rw, rh,
                           SETTINGS_EXACT, None, "render_"))
    out["render_single"] = _np(single)
    # a step over the 4 bands (the last one padding): a ring of distinct
    # neighbours, against the port's single-device step
    target = torch.tensor(inp["images"][0][:rh])
    out.update(_gs_step(flat, inp["params"], cam, target, rw, rh,
                        SETTINGS_EXACT, "flat_"))
    scene = _scene(inp["params"])
    ref = train_step(scene, init_adam_state(scene.params()), cam, target,
                     img_w=rw, img_h=rh, settings=SETTINGS_EXACT)
    out.update(_params("flat_single_p_", ref.scene.params()))
    out["band_rank"] = np.asarray(mesh.band_rank)
    out["dp_rank"] = np.asarray(mesh.dp_rank)
    return out


def _state(inp):
    """The parent's whole scene (``params`` with its ``alive`` mask) and
    moments ``m`` / ``v``."""
    scene = scene_from_numpy(inp["params"], inp["alive"], 0, "cpu")
    return scene, AdamState(torch.tensor(inp["m"]), torch.tensor(inp["v"]),
                            7)


def _shard_arrays(prefix, scene, opt):
    return {**_params(prefix, scene.params()), f"{prefix}alive":
            _np(scene.alive), f"{prefix}m": _np(opt.m),
            f"{prefix}v": _np(opt.v)}


def case_gs_rebalance(mesh, inp, out_dir):
    """rebalance_shards of the parent's whole state, sharded: with the
    split sizes read from the device, and, for ``prefix_counts`` (every
    shard's alive rows a prefix of that length), also from the host."""
    scene, opt = _state(inp)
    new = rebalance_shards(gaussian_shard(scene, mesh),
                           gaussian_shard(opt, mesh), mesh)
    out = _shard_arrays("", *new)
    counts = inp["prefix_counts"]
    n_loc = scene.capacity // mesh.band_size
    lane = np.arange(n_loc)[None, :] < np.asarray(counts)[:, None]
    pre = scene_from_numpy(inp["params"], lane.reshape(-1), 0, "cpu")
    for prefix, known in (("dev_", None), ("host_", list(counts))):
        out.update(_shard_arrays(prefix, *rebalance_shards(
            gaussian_shard(pre, mesh), gaussian_shard(opt, mesh), mesh,
            shard_alive=known)))
    return out


def _event_cameras(inp):
    mw, mh = inp["metric_size"]
    return [default_camera(mw, mh, position=tuple(p), device="cpu")
            for p in inp["positions"]]


def case_gs_event(mesh, inp, out_dir):
    """gs_densify_event on this rank's shards of the parent's (rebalanced)
    state, the parent's clone/split noise injected, and the sharded
    importance counts alone."""
    densify_ops.densify_rng = lambda gen, n: (
        torch.tensor(inp["noise_u"][:n]), torch.tensor(inp["noise_d"][:n]))
    scene, opt = _state(inp)
    mw, mh = inp["metric_size"]
    cfg = DensifyPruneConfig(**inp["cfg"])
    cams, targets = _event_cameras(inp), torch.tensor(inp["targets"])
    counts = sharded_importance_counts(
        scene, cams, targets, mesh, mw=mw, mh=mh,
        threshold=cfg.metric_threshold, settings=SETTINGS)
    res = gs_densify_event(gaussian_shard(scene, mesh),
                           gaussian_shard(opt, mesh), cams, targets, mesh,
                           torch.Generator(), mw=mw, mh=mh, cfg=cfg,
                           settings=SETTINGS)
    return {**_shard_arrays("", res.scene, res.opt_state),
            "counts": _np(counts), "shard_totals": _np(res.shard_totals),
            **{k: np.asarray(int(getattr(res, k))) for k in (
                "out_total", "in_alive", "n_cloned", "n_split",
                "n_pruned")}}


def _gs_trainer_config(inp):
    sched = inp.get("schedule")
    return TrainerConfig(max_iterations=inp.get("max_iterations", 10_000),
                         densify=DensifyPruneConfig(
        schedule=DensifySchedule(enabled=False) if sched is None else
        DensifySchedule(enabled=True, warmup_iterations=sched[0],
                        interval=sched[1], stop_iterations=sched[2]),
        **inp.get("densify", {})))


def _gs_trainer(mesh, inp, settings=None):
    """A GsTrainer over the parent's views (the f32 exchange unless
    ``inp["f16"]``)."""
    if settings is None:
        settings = SETTINGS if inp.get("f16") else SETTINGS_EXACT
    cams, imgs = _views(inp)
    return GsTrainer(_scene(inp["params"]), cams, imgs,
                     _gs_trainer_config(inp), settings, mesh=mesh,
                     initial_capacity=inp.get("capacity"))


def _trainer_state(prefix, tr):
    scene, opt = tr.full_scene(), tr.full_opt_state()
    return {**_shard_arrays(prefix, scene, opt),
            f"{prefix}num_points": np.asarray(tr.num_points),
            f"{prefix}densified_at": np.asarray(
                tr.last_densify_iteration or -1)}


def case_gs_trainer(mesh, inp, out_dir):
    """``steps`` GsTrainer steps: losses, the event iteration, the whole
    state (gathered on every rank), this rank's shard, the capacities; on
    a world of one also the single-device Trainer of the same seeds."""
    tr = _gs_trainer(mesh, inp)
    losses = [float(tr.step()["loss"]) for _ in range(inp["steps"])]
    out = {"losses": np.asarray(losses), **_trainer_state("", tr),
           **_shard_arrays("shard_", tr.scene, tr.opt_state),
           "caps": np.asarray([tr._gs_entry_cap or -1,
                               tr._gs_send_cap or -1]),
           "capacity": np.asarray(tr.capacity),
           "band_rank": np.asarray(mesh.band_rank),
           "dp_rank": np.asarray(mesh.dp_rank)}
    if mesh.size == 1:
        cams, imgs = _views(inp)
        ref = Trainer(_scene(inp["params"]), cams, imgs,
                      _gs_trainer_config(inp), SETTINGS_EXACT,
                      initial_capacity=inp.get("capacity"))
        out["ref_losses"] = np.asarray(
            [float(ref.step()["loss"]) for _ in range(inp["steps"])])
        out.update(_trainer_state("ref_", ref))
    return out


def case_gs_adaptive(mesh, inp, out_dir):
    """A concentrated scene at 16x16 tiles that starts with a one-chunk
    send budget and a roomy entry capacity: the drops of each step."""
    s16 = dataclasses.replace(SETTINGS, tile_w=16, tile_h=16)
    tr = _gs_trainer(mesh, inp, s16)
    tr.ENTRY_CAP_INTERVAL = 2
    tr._gs_send_cap = s16.chunk  # deliberately too small
    tr._gs_entry_cap = 1024  # so that the send budget binds
    dropped = [int(tr.step()["entries_dropped"]) for _ in range(8)]
    return {"dropped": np.asarray(dropped),
            "send_cap": np.asarray(tr._gs_send_cap)}


def case_gs_rollback(mesh, inp, out_dir):
    """``train`` with the loss poisoned at iteration 4 on every rank."""
    tr = _gs_trainer(mesh, inp)
    tr.SNAPSHOT_INTERVAL = 2
    step, rollback = tr.step, tr._rollback
    events = {"poisoned": 0, "rollbacks": 0}

    def poisoned_step():
        m = step()
        if tr.iteration == 4 and not events["poisoned"]:
            events["poisoned"] = 1
            m = dict(m, loss=torch.tensor(float("nan")))
        return m

    def counted_rollback():
        events["rollbacks"] += 1
        rollback()

    tr.step, tr._rollback = poisoned_step, counted_rollback
    logs = []
    last = tr.train(num_iterations=8, log_every=0, log_fn=logs.append)
    return {"logs": np.asarray("\n".join(logs)),
            "events": np.asarray([events["poisoned"], events["rollbacks"]]),
            "last_loss": np.asarray(last["loss"]),
            "iteration": np.asarray(tr.iteration),
            "finite": np.asarray(all(bool(torch.isfinite(v).all())
                                     for v in tr.scene.params().values())),
            "shard_capacity": np.asarray(tr.scene.capacity),
            "capacity": np.asarray(tr.capacity)}


CASES = {"tile_sharded": case_tile_sharded, "dp_step": case_dp_step,
         "trainer": case_trainer, "trainer_densify": case_trainer_densify,
         "gs_render": case_gs_render, "gs_step": case_gs_step,
         "gs_mesh2d": case_gs_mesh2d, "gs_rebalance": case_gs_rebalance,
         "gs_event": case_gs_event, "gs_trainer": case_gs_trainer,
         "gs_adaptive": case_gs_adaptive, "gs_rollback": case_gs_rollback}


def rank_main(rank: int, world: int, store: str, case: str, out_dir: str,
              inp: dict) -> None:
    """One rank: join the gloo group through the ``file://`` store (as a
    dp x band mesh when ``inp`` has ``mesh_shape``), run ``case`` and save
    its arrays."""
    torch.set_num_threads(1)
    shape = inp.get("mesh_shape")
    mesh = make_mesh("cpu", init_method="file://" + store, rank=rank,
                     world_size=world, timeout_s=GROUP_TIMEOUT_S,
                     shape=None if shape is None else tuple(shape))
    try:
        out = CASES[case](mesh, inp, out_dir)
        np.savez(os.path.join(out_dir, f"{case}_r{rank}.npz"), **out)
    finally:
        mesh.close()
