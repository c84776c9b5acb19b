"""The port's entry points on the CPU: Viewer, CLI, and the server, in
view mode and with live training; plus the guards (no CPU fallback when CUDA is asked for, and no
jax import anywhere in webdgs_tpu_torch)."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from webdgs_tpu.render.viewer import Viewer as JViewer
from webdgs_tpu_torch.cli import main as cli_main
from webdgs_tpu_torch.io.ply import save_ply
from webdgs_tpu_torch.render.server import ViewerServer, make_http_server
from webdgs_tpu_torch.render.viewer import (Viewer, frames_to_video,
                                            render_orbit)

from tests.torch_parity import (CPU, IMG_ATOL, IMG_RTOL, both_scenes,
                                jax_settings, numpy_scene, torch_settings)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene(n=40, seed=30, sh_deg=0):
    return both_scenes(numpy_scene(n, seed=seed), sh_deg=sh_deg)


def test_viewer_render_matches_jax():
    js, ts = _scene(120, seed=31, sh_deg=3)
    jv = JViewer(js, 64, 48, jax_settings())
    tv = Viewer(ts, 64, 48, torch_settings(), device=CPU)
    for v in (jv, tv):
        v.frame_scene()
        v.set_gaussian_scaling(1.3)
    np.testing.assert_allclose(tv.control.position, jv.control.position,
                               rtol=1e-6)
    for downscale in (1, 2):
        got, want = tv.render(downscale), jv.render(downscale)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=IMG_RTOL, atol=IMG_ATOL)
    # adaptive entry capacity follows the reference's ladder
    assert tv._entry_budget.value == jv._entry_cap


def test_viewer_pointcloud_mode_and_orbit(tmp_path):
    _, ts = _scene(20)
    v = Viewer(ts, 32, 32, render_mode="pointcloud", point_size_px=2.0,
               device=CPU)
    v.control.position = np.array([0, 0, -5.0], np.float32)
    img = v.render()
    lit = img[..., 0] > 0.5
    assert lit.any()
    np.testing.assert_allclose(img[lit][:, 0], img[lit][:, 1], atol=1e-5)
    with pytest.raises(ValueError):
        v.set_render_mode("bogus")

    paths = render_orbit(ts, tmp_path / "frames", n_frames=2, width=32,
                         height=32)
    assert len(paths) == 2 and all(os.path.exists(p) for p in paths)
    gif = frames_to_video(paths, tmp_path / "orbit.gif", fps=4)
    assert os.path.getsize(gif) > 0


def test_viewer_refuses_cuda_without_a_card(monkeypatch):
    """No CPU fallback: asking for CUDA where there is none raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ts = _scene(5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Viewer(ts, 32, 32)  # device defaults to cuda
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Viewer(ts, 32, 32, device="cuda:0")


def test_cli_render_and_view_on_cpu(tmp_path, capsys):
    _, ts = _scene(15, seed=32)
    ply = tmp_path / "scene.ply"
    save_ply(ts, ply)
    cli_main(["render", str(ply), "--out", str(tmp_path / "r.png"),
              "--width", "32", "--height", "32", "--device", "cpu",
              "--position", "0", "0", "-5"])
    assert os.path.exists(tmp_path / "r.png")
    cli_main(["view", str(ply), "--out", str(tmp_path / "fr"), "--orbit",
              "1", "--width", "32", "--height", "32", "--device", "cpu"])
    assert os.path.exists(tmp_path / "fr" / "frame_0000.png")
    # checkpoints render too
    from webdgs_tpu_torch.io.checkpoint import save_checkpoint
    save_checkpoint(tmp_path / "ck.npz", ts, iteration=3)
    cli_main(["render", str(tmp_path / "ck.npz"), "--out",
              str(tmp_path / "ck.png"), "--width", "32", "--height", "32",
              "--device", "cpu", "--position", "0", "0", "-5"])
    assert os.path.exists(tmp_path / "ck.png")


def test_module_entry_point_writes_png(tmp_path):
    from PIL import Image
    _, ts = _scene(15, seed=33)
    ply = tmp_path / "scene.ply"
    save_ply(ts, ply)
    out = tmp_path / "m.png"
    subprocess.run([sys.executable, "-m", "webdgs_tpu_torch", "render",
                    str(ply), "--out", str(out), "--width", "48",
                    "--height", "32", "--device", "cpu"],
                   check=True, cwd=ROOT, timeout=120)
    assert Image.open(out).size == (48, 32)


def test_server_frame_stats_control():
    _, ts = _scene(8, seed=70)
    viewer = Viewer(ts, 32, 32, device=CPU)
    viewer.control.position = np.array([0, 0, -5.0], np.float32)
    vs = ViewerServer(viewer, motion_downscale=4)
    jpg = vs.frame_jpeg()
    assert jpg[:2] == b"\xff\xd8"
    stats = vs.stats()
    assert stats["points"] == 8 and stats["fps"] > 0
    assert stats["render_mode"] == "gaussian" and stats["width"] == 32
    pos0 = viewer.control.position.copy()
    assert vs.handle_control({"move": [True] + [False] * 5, "dt": 0.5,
                              "gaussian_scale_delta": 0.5,
                              "toggle_mode": 1, "bogus": 1}) == ["bogus"]
    assert not np.allclose(viewer.control.position, pos0)
    assert viewer.gaussian_scaling == 1.5
    assert viewer.render_mode == "pointcloud"
    vs.handle_control({"resize": [200, 100]})
    assert (viewer.width, viewer.height) == (192, 64)
    # progressive refine after motion: 4 -> 2 -> 1
    seen = []
    orig = viewer.render
    viewer.render = lambda downscale=1: (seen.append(downscale)
                                         or orig(downscale=downscale))
    vs.handle_control({"drag": [2, 0]})
    vs.frame_jpeg()
    vs._last_input = 0.0
    for _ in range(3):
        vs.frame_jpeg()
    assert seen == [4, 2, 1, 1]


def test_server_http_endpoints(tmp_path):
    """A live-training server over HTTP: the page, frames, /stats with its
    trainer block while steps run, /loss.jpg, control posts, and uploads
    of a COLMAP dataset (PNGs, images.bin, cameras.bin) that set the
    trainer's dataset."""
    from webdgs_tpu_torch.io.colmap import load_cameras
    from webdgs_tpu_torch.io.images import load_images
    from webdgs_tpu_torch.io.ply import load_point_cloud
    from webdgs_tpu_torch.train.config import load_trainer_config
    from webdgs_tpu_torch.train.trainer import Trainer
    from tests.test_torch_trainer import _synthetic_dataset

    data = _synthetic_dataset(tmp_path, views=3, w=48, h=32, points=100)
    sparse = data / "sparse" / "0"
    cams = load_cameras([str(sparse / "images.bin"),
                         str(sparse / "cameras.bin")])
    imgs = load_images(str(data / "images"))
    cfg = load_trainer_config({"densify": {"schedule": {
        "warmup_iterations": 2, "interval": 2}, "clone_threshold_count": 1}})
    trainer = Trainer(load_point_cloud(str(sparse / "points3D.bin"), CPU),
                      cams, imgs, cfg)
    trainer.dataset_cameras = cams
    viewer = Viewer(trainer.scene, 32, 32, device=CPU)
    viewer.frame_scene()
    vs = ViewerServer(viewer, trainer=trainer)
    server = make_http_server(vs, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()

    def get(path):
        return urllib.request.urlopen(url + path, timeout=60).read()

    def post(path, body):
        req = urllib.request.Request(url + path, data=body, method="POST")
        return json.loads(urllib.request.urlopen(req, timeout=60).read())

    try:
        page = get("/")
        assert b"webdgs_tpu_torch" in page and b"SLIDERS" in page
        assert get("/frame.jpg")[:2] == b"\xff\xd8"
        assert post("/control", b'{"gaussian_scale_delta": 0.5}') == {}
        assert viewer.gaussian_scaling == 1.5
        for _ in range(600):  # the train thread steps on its own
            stats = json.loads(get("/stats"))
            if stats["trainer"]["iteration"] >= 3:
                break
            time.sleep(0.1)
        tr = stats["trainer"]
        assert tr["iteration"] >= 3 and tr["training"] and not tr["error"]
        assert tr["next_densify"] is not None and tr["n_cameras"] == 3
        assert tr["config"]["densify.schedule.interval"] == 2
        assert get("/loss.jpg")[:2] == b"\xff\xd8"
        assert post("/control", b'{"toggle_train": 1}') == {}
        assert not vs.training
        post("/control", b'{"config": {"adam": {"lr_pos": 0.0}}}')
        assert trainer.config.adam.lr_pos == 0.0
        for png in sorted((data / "images").iterdir()):
            r = post(f"/upload?name={png.name}", png.read_bytes())
            assert r["staged"] == "image"
        for name in ("images.bin", "cameras.bin"):
            r = post(f"/upload?name={name}", (sparse / name).read_bytes())
            assert r["staged"].startswith("camera") and r["count"] >= 1
        assert post("/upload_done", b"") == {"dataset": "dataset set: 3 views"}
        with pytest.raises(urllib.error.HTTPError) as e:
            post("/upload?name=a.ply", b"not a ply")
        assert e.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        vs.shutdown()
        t.join(timeout=10)
    assert not t.is_alive() and not vs._train_thread.is_alive()
    assert trainer.iteration >= 3 and trainer.last_densify_iteration


def test_port_imports_no_jax():
    """Every module of webdgs_tpu_torch imports without jax or the JAX
    package (their __init__s pull in jax and flax)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import webdgs_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'webdgs_tpu_torch.') if m.name != 'webdgs_tpu_torch.__main__']\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'webdgs_tpu' or m.startswith('webdgs_tpu.')]\n"
        "need = {'webdgs_tpu_torch.ops.' + m for m in ('loss', 'tile_loss',"
        " 'segsum', 'adam', 'importance', 'densify')} | {'webdgs_tpu_torch.train.' + m for m in "
        "('config', 'step', 'trainer')} | {'webdgs_tpu_torch.io.' + m for m"
        " in ('checkpoint', 'colmap', 'images')}\n"
        "assert need <= set(names), sorted(need - set(names))\n"
        "assert len(names) >= 30, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 30


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing CUDA compiler is an error, never a silent fallback."""
    import shutil

    from webdgs_tpu_torch import _build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert [p.name for p in _build.sources()] == [
        "adam.cu", "expand.cu", "importance.cu", "rasterize_bwd.cu",
        "rasterize_fwd.cu", "segsum.cu", "tile_cull.cu", "tile_loss.cu"]
