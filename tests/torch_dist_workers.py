"""Rank workers of tests/test_torch_sharding.py: each case runs on every
rank of a gloo group started by ``torch.multiprocessing.spawn`` and saves
its arrays to ``<out_dir>/<case>_r<rank>.npz`` for the parent to check.

This module imports torch and the port only, never jax: a spawned rank
imports it afresh, and the JAX side of a parity test runs in the parent.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from webdgs_tpu_torch.config import RenderSettings
from webdgs_tpu_torch.core.camera import CameraData, default_camera
from webdgs_tpu_torch.core.scene import scene_from_numpy
from webdgs_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from webdgs_tpu_torch.ops.adam import (AdamHyperparameters, adam_step,
                                       init_adam_state)
from webdgs_tpu_torch.ops.loss import LossConfig
from webdgs_tpu_torch.parallel.sharding import (dp_train_step, make_mesh,
                                                render_tile_sharded)
from webdgs_tpu_torch.render.renderer import render
from webdgs_tpu_torch.train.config import (DensifyPruneConfig,
                                           DensifySchedule, TrainerConfig)
from webdgs_tpu_torch.train.step import compute_param_grads
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


CASES = {"tile_sharded": case_tile_sharded, "dp_step": case_dp_step,
         "trainer": case_trainer, "trainer_densify": case_trainer_densify}


def rank_main(rank: int, world: int, store: str, case: str, out_dir: str,
              inp: dict) -> None:
    """One rank: join the gloo group through the ``file://`` store, run
    ``case`` and save its arrays."""
    torch.set_num_threads(1)
    mesh = make_mesh("cpu", init_method="file://" + store, rank=rank,
                     world_size=world, timeout_s=GROUP_TIMEOUT_S)
    try:
        out = CASES[case](mesh, inp, out_dir)
        np.savez(os.path.join(out_dir, f"{case}_r{rank}.npz"), **out)
    finally:
        mesh.close()
