"""Command-line interface of the port (counterpart of webdgs_tpu/cli.py):

  python -m webdgs_tpu_torch train --points points3D.bin \
      --cameras images.bin cameras.bin --images images/ \
      --out ckpt.npz [--export-ply out.ply] [--no-densify] [--device cuda]
  torchrun --nproc_per_node=N -m webdgs_tpu_torch train --shard dp ...
                                         # view-data-parallel over N cards
  python -m webdgs_tpu_torch render scene.ply|ckpt.npz --out img.png
  python -m webdgs_tpu_torch view   scene.ply --out frames/ --orbit 24
  python -m webdgs_tpu_torch export ckpt.npz --out scene.ply
  python -m webdgs_tpu_torch serve  scene.ply --port 8000      # view mode
  python -m webdgs_tpu_torch serve --train --points ... --cameras ... \
      --images ...                       # live training in the browser

Every command runs on ``--device`` (default ``cuda``) and raises when that
device is unavailable.  ``train --shard dp`` trains view-data-parallel, one
process per card under ``torchrun`` (without a launcher, a world of one);
only rank 0 logs and writes the checkpoint, the PLY and the report.
``--shard gs`` (Gaussian-sharded) and the benchmark are later slices of
the port.
"""

from __future__ import annotations

import argparse
import sys


def _add_train_args(t, required: bool):
    """Dataset and training flags (those of webdgs_tpu/cli.py), shared by
    ``train`` and ``serve --train``."""
    t.add_argument("--points", required=required,
                   help="initial PLY or COLMAP points3D.bin")
    t.add_argument("--cameras", nargs="+", required=required,
                   help="images.bin + cameras.bin, or a cameras JSON")
    t.add_argument("--images", required=required,
                   help="image dir or files")
    t.add_argument("--iterations", type=int, default=10_000)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--config", default=None,
                   help="JSON file of deep-partial TrainerConfig overrides")
    t.add_argument("--resume", default=None,
                   help="checkpoint .npz to resume from")
    t.add_argument("--holdout-every", type=int, default=0,
                   help="hold out every k-th view for evaluation (3DGS "
                   "convention: 8); 0 trains on everything")
    t.add_argument("--shard", choices=("none", "dp", "gs"), default="none",
                   help="'dp': view-data-parallel across the ranks of "
                   "torchrun (one card each); 'gs' is not ported yet")
    # loss
    t.add_argument("--lambda-l1", type=float, default=0.8)
    t.add_argument("--lambda-l2", type=float, default=0.0)
    t.add_argument("--lambda-dssim", type=float, default=0.2)
    # adam
    t.add_argument("--lr-pos", type=float, default=0.00016)
    t.add_argument("--lr-color", type=float, default=0.0025)
    t.add_argument("--lr-opacity", type=float, default=0.05)
    t.add_argument("--lr-scale", type=float, default=0.005)
    t.add_argument("--lr-rot", type=float, default=0.001)
    t.add_argument("--full-sh", action="store_true",
                   help="train all SH bands (reference trains DC only)")
    t.add_argument("--lr-pos-final", type=float, default=0.0,
                   help="enable exponential position-lr decay to this value")
    t.add_argument("--bias-correction", action="store_true",
                   help="enable Adam bias correction (reference omits it)")
    # densify
    t.add_argument("--no-densify", action="store_true",
                   help="train without densification")
    t.add_argument("--densify-warmup", type=int, default=500)
    t.add_argument("--densify-interval", type=int, default=100)
    t.add_argument("--densify-stop", type=int, default=15_000)
    t.add_argument("--metric-views", type=int, default=10)
    t.add_argument("--metric-downscale", type=int, default=2)
    t.add_argument("--metric-threshold", type=float, default=0.5)
    t.add_argument("--max-new-points", type=int, default=5000)
    t.add_argument("--prune-opacity", type=float, default=0.01)
    t.add_argument("--clone-threshold", type=int, default=500)
    t.add_argument("--split-scale-threshold", type=float, default=1.0)


def _add_common_render_args(p):
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--max-splat-radius-px", type=float, default=128.0)
    p.add_argument("--background", type=float, nargs=3,
                   default=(0.0, 0.0, 0.0))
    p.add_argument("--gaussian-scaling", type=float, default=1.0,
                   help="splat-size multiplier")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; there is "
                   "no fallback when it is unavailable)")


def _settings(args):
    from webdgs_tpu_torch.config import RenderSettings
    return RenderSettings(max_splat_radius_px=args.max_splat_radius_px,
                          background=tuple(args.background),
                          gaussian_scaling=args.gaussian_scaling)


def _load_scene(args):
    """A PLY / points3D.bin scene or an ``.npz`` checkpoint's scene."""
    from webdgs_tpu_torch.io.checkpoint import load_checkpoint
    from webdgs_tpu_torch.io.ply import load_point_cloud
    from webdgs_tpu_torch.render.viewer import resolve_device

    device = resolve_device(args.device)
    if str(args.scene).endswith(".npz"):
        scene, _, _ = load_checkpoint(args.scene, device)
        return scene
    return load_point_cloud(args.scene, device)


def _build_trainer(args):
    """Load the dataset and construct a Trainer from the flags."""
    from webdgs_tpu_torch.io.colmap import load_cameras
    from webdgs_tpu_torch.io.images import load_images, numeric_key
    from webdgs_tpu_torch.io.ply import load_point_cloud
    from webdgs_tpu_torch.ops.adam import AdamHyperparameters
    from webdgs_tpu_torch.ops.loss import LossConfig
    from webdgs_tpu_torch.render.viewer import resolve_device
    from webdgs_tpu_torch.train.config import (DensifyPruneConfig,
                                               DensifySchedule,
                                               TrainerConfig,
                                               load_trainer_config)
    from webdgs_tpu_torch.train.trainer import Trainer

    mesh = None
    if args.shard == "gs":
        raise SystemExit("--shard gs (Gaussian-sharded training) is a later "
                         "slice of the port (ROADMAP Queue 1 item 5); use "
                         "--shard dp or none")
    if args.shard == "dp":
        from webdgs_tpu_torch.parallel.sharding import make_mesh
        mesh = make_mesh(args.device, axis_name="dp")
        device = mesh.device
        _lead_print(mesh, f"sharding 'dp' over {mesh.size} device(s)")
    else:
        device = resolve_device(args.device)
    scene = load_point_cloud(args.points, device)
    cameras = load_cameras(args.cameras)
    images = load_images(args.images)

    # pair cameras and images by index after name-sorting
    if all(c.img_name for c in cameras):
        cameras = sorted(cameras, key=lambda c: numeric_key(c.img_name))
    n = min(len(cameras), len(images))
    cameras, images = cameras[:n], images[:n]
    holdout = ([], [])
    k = args.holdout_every or 0
    if k > 1:
        holdout = ([c for i, c in enumerate(cameras) if i % k == 0],
                   [m for i, m in enumerate(images) if i % k == 0])
        cameras = [c for i, c in enumerate(cameras) if i % k != 0]
        images = [m for i, m in enumerate(images) if i % k != 0]
    _lead_print(mesh, f"dataset: {len(cameras)} train / {len(holdout[0])} "
                f"holdout views; {int(scene.num_alive())} initial points; "
                f"device {device}")

    cfg = TrainerConfig(
        loss=LossConfig(lambda_l1=args.lambda_l1, lambda_l2=args.lambda_l2,
                        lambda_dssim=args.lambda_dssim),
        adam=AdamHyperparameters(
            lr_pos=args.lr_pos, lr_color=args.lr_color,
            lr_opacity=args.lr_opacity, lr_scale=args.lr_scale,
            lr_rot=args.lr_rot, full_sh=args.full_sh,
            bias_correction=args.bias_correction,
            lr_pos_final=args.lr_pos_final,
            lr_pos_decay_steps=args.iterations),
        densify=DensifyPruneConfig(
            schedule=DensifySchedule(
                enabled=not args.no_densify,
                warmup_iterations=args.densify_warmup,
                interval=args.densify_interval,
                stop_iterations=args.densify_stop),
            metric_views=args.metric_views,
            metric_downscale=args.metric_downscale,
            metric_threshold=args.metric_threshold,
            max_new_points_per_step=args.max_new_points,
            prune_opacity=args.prune_opacity,
            clone_threshold_count=args.clone_threshold,
            split_scale_threshold=args.split_scale_threshold),
        max_iterations=args.iterations,
        seed=args.seed)
    if args.config:
        cfg = load_trainer_config(args.config, base=cfg)

    trainer = Trainer(scene, cameras, images, cfg, _settings(args),
                      mesh=mesh)
    if args.resume:
        from webdgs_tpu_torch.io.checkpoint import load_checkpoint
        # every rank loads the same file: identical state everywhere
        ck_scene, ck_opt, meta = load_checkpoint(args.resume, device)
        trainer.resume_from(ck_scene, ck_opt, meta.get("iteration") or 0)
        _lead_print(mesh, f"resumed from {args.resume} at iteration "
                    f"{trainer.iteration}")
    trainer.dataset_cameras = cameras
    return trainer, holdout


def _lead_print(mesh, line: str) -> None:
    """Print on rank 0 only (every process without a mesh)."""
    if mesh is None or mesh.rank == 0:
        print(line, flush=True)


def _kernel_launches() -> dict:
    """The launch count of every kernel wrapper in this process."""
    from webdgs_tpu_torch.ops import (expand, importance, rasterize, segsum,
                                      tile_loss)
    return {f.__name__: f.kernel_launches for f in (
        expand.expand_fields, rasterize.rasterize_tiles,
        tile_loss.tile_loss_tiles, rasterize.rasterize_tiles_backward,
        segsum.segment_sum_rows, importance.entry_counts)}


def cmd_train(args):
    trainer, holdout = _build_trainer(args)
    try:
        trainer.train(log_every=args.log_every,
                      checkpoint_every=args.checkpoint_every,
                      checkpoint_path=args.out)
        if trainer.mesh is None or trainer.mesh.rank == 0:
            _finish_training(args, trainer, holdout)
    finally:
        if trainer.mesh is not None:
            trainer.mesh.close()


def _finish_training(args, trainer, holdout) -> None:
    """The checkpoint, the PLY, the evaluation and the report."""
    import json
    from webdgs_tpu_torch.io.checkpoint import save_checkpoint
    from webdgs_tpu_torch.io.ply import save_ply

    # persist the model before the evaluation
    if args.out:
        save_checkpoint(args.out, trainer.scene, trainer.opt_state,
                        iteration=trainer.iteration)
        print(f"checkpoint -> {args.out}")
    if args.export_ply:
        n_out = save_ply(trainer.scene, args.export_ply)
        print(f"exported {n_out} splats -> {args.export_ply}")

    report = {"iterations": trainer.iteration,
              "points": trainer.num_points,
              "iters_per_sec": round(trainer.iters_per_sec, 2),
              "kernel_launches": _kernel_launches(),
              "train": trainer.evaluate()}
    if holdout[0]:
        report["holdout"] = trainer.evaluate(views=holdout)
    print("eval:", json.dumps(report))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
        print(f"report -> {args.report}")


def _viewer(args, scene=None):
    import numpy as np
    from webdgs_tpu_torch.render.viewer import Viewer

    viewer = Viewer(_load_scene(args) if scene is None else scene,
                    args.width, args.height, _settings(args),
                    device=args.device)
    if args.position:
        viewer.control.position = np.asarray(args.position, np.float32)
    else:
        viewer.frame_scene()
    return viewer


def cmd_render(args):
    from webdgs_tpu_torch.render.viewer import save_png

    img = _viewer(args).render()
    save_png(args.out, img)
    print(f"rendered {args.width}x{args.height} on {args.device} -> "
          f"{args.out}")


def cmd_view(args):
    from webdgs_tpu_torch.render.viewer import frames_to_video, render_orbit

    scene = _load_scene(args)
    print(f"loaded {int(scene.num_alive())} points, sh_deg={scene.sh_deg}")
    paths = render_orbit(scene, args.out, n_frames=args.orbit,
                         width=args.width, height=args.height,
                         settings=_settings(args), radius=args.radius)
    print(f"wrote {len(paths)} frames to {args.out}")
    if args.video:
        out = frames_to_video(paths, args.video, fps=args.fps)
        print(f"encoded {out}")


def cmd_export(args):
    from webdgs_tpu_torch.io.ply import save_ply

    n = save_ply(_load_scene(args), args.out)
    print(f"exported {n} splats -> {args.out}")


def cmd_serve(args):
    from webdgs_tpu_torch.render.server import ViewerServer

    trainer, holdout, scene = None, None, None
    if args.train:
        if not (args.points and args.cameras and args.images):
            raise SystemExit("serve --train requires --points, --cameras "
                             "and --images")
        if args.shard != "none":
            raise SystemExit("serve --train trains on one device "
                             "(--shard none)")
        trainer, holdout = _build_trainer(args)
        scene = trainer.scene
    elif not args.scene:
        raise SystemExit("serve needs a scene argument (view mode) or "
                         "--train with dataset flags")
    ViewerServer(_viewer(args, scene), trainer=trainer,
                 holdout=holdout).serve(port=args.port, host=args.host)


def build_parser():
    p = argparse.ArgumentParser(
        "webdgs_tpu_torch",
        description="3D Gaussian Splatting trainer and viewer, PyTorch + "
        "CUDA port")
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="train a scene from COLMAP data")
    _add_train_args(t, required=True)
    t.add_argument("--log-every", type=int, default=100)
    t.add_argument("--out", default="checkpoint.npz")
    t.add_argument("--export-ply", default=None)
    t.add_argument("--checkpoint-every", type=int, default=0,
                   help="save --out every N iterations")
    t.add_argument("--report", default=None,
                   help="write the end-of-training eval JSON to this file")
    _add_common_render_args(t)
    t.set_defaults(fn=cmd_train)

    r = sub.add_parser("render", help="render one frame of a PLY scene or "
                       "checkpoint")
    r.add_argument("scene")
    r.add_argument("--out", default="render.png")
    r.add_argument("--position", type=float, nargs=3, default=None)
    _add_common_render_args(r)
    r.set_defaults(fn=cmd_render)

    v = sub.add_parser("view", help="orbit-render a splat to PNG frames")
    v.add_argument("scene")
    v.add_argument("--out", default="frames")
    v.add_argument("--orbit", type=int, default=24)
    v.add_argument("--radius", type=float, default=None)
    v.add_argument("--video", default=None, metavar="PATH",
                   help="also encode the frames (.gif via PIL; other "
                        "extensions via ffmpeg when available)")
    v.add_argument("--fps", type=int, default=12)
    _add_common_render_args(v)
    v.set_defaults(fn=cmd_view)

    e = sub.add_parser("export", help="export a checkpoint or scene to PLY")
    e.add_argument("scene")
    e.add_argument("--out", required=True)
    e.add_argument("--device", default="cuda",
                   help="torch device the scene is loaded on (default cuda)")
    e.set_defaults(fn=cmd_export)

    sv = sub.add_parser("serve", help="interactive browser viewer (JPEG "
                        "stream + fly controls); --train runs live training "
                        "while you watch")
    sv.add_argument("scene", nargs="?", default=None,
                    help="PLY scene or checkpoint to view (omit with "
                    "--train)")
    sv.add_argument("--port", type=int, default=8000)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--position", type=float, nargs=3, default=None)
    sv.add_argument("--train", action="store_true",
                    help="train while viewing (requires the dataset flags)")
    _add_train_args(sv, required=False)
    _add_common_render_args(sv)
    sv.set_defaults(fn=cmd_serve)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
