"""Command-line interface of the port's viewer (counterpart of
webdgs_tpu/cli.py: the ``render``, ``view`` and ``serve`` view-mode
commands):

  python -m webdgs_tpu_torch render scene.ply --out img.png [--device cuda]
  python -m webdgs_tpu_torch view   scene.ply --out frames/ --orbit 24
  python -m webdgs_tpu_torch serve  scene.ply --port 8000

Every command renders on ``--device`` (default ``cuda``) and raises when
that device is unavailable.  Training, checkpoint export and the benchmark
are served by the JAX package until their slices are ported.
"""

from __future__ import annotations

import argparse
import sys


def _add_common_render_args(p):
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--max-splat-radius-px", type=float, default=128.0)
    p.add_argument("--background", type=float, nargs=3,
                   default=(0.0, 0.0, 0.0))
    p.add_argument("--gaussian-scaling", type=float, default=1.0,
                   help="splat-size multiplier")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; there is "
                   "no fallback when it is unavailable)")


def _settings(args):
    from webdgs_tpu_torch.config import RenderSettings
    return RenderSettings(max_splat_radius_px=args.max_splat_radius_px,
                          background=tuple(args.background),
                          gaussian_scaling=args.gaussian_scaling)


def _load_scene(args):
    from webdgs_tpu_torch.io.ply import load_point_cloud
    from webdgs_tpu_torch.render.viewer import resolve_device

    if str(args.scene).endswith(".npz"):
        raise SystemExit("checkpoint (.npz) loading is not yet ported; "
                         "export a PLY with the JAX package first")
    return load_point_cloud(args.scene, resolve_device(args.device))


def _viewer(args):
    import numpy as np
    from webdgs_tpu_torch.render.viewer import Viewer

    viewer = Viewer(_load_scene(args), args.width, args.height,
                    _settings(args), device=args.device)
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


def cmd_serve(args):
    from webdgs_tpu_torch.render.server import ViewerServer

    ViewerServer(_viewer(args)).serve(port=args.port, host=args.host)


def build_parser():
    p = argparse.ArgumentParser(
        "webdgs_tpu_torch",
        description="3D Gaussian Splatting viewer, PyTorch + CUDA port")
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("render", help="render one frame of a PLY scene")
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

    sv = sub.add_parser("serve", help="interactive browser viewer (JPEG "
                        "stream + fly controls), view mode")
    sv.add_argument("scene", help="PLY scene to view")
    sv.add_argument("--port", type=int, default=8000)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--position", type=float, nargs=3, default=None)
    _add_common_render_args(sv)
    sv.set_defaults(fn=cmd_serve)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
