"""PyTorch port vs the JAX reference: the Trainer with and without
densification, the ``train`` and ``export`` commands, COLMAP/image loading
and checkpoints across packages.

The Trainer runs beside the JAX Trainer (same seed, same synthetic views):
3 steps densify-off, with the same view sequence, metric keys and the loss
within rtol 1e-3; 6 steps densify-on with three events, one injected
noise, the same point counts, alive mask, capacity and schedule, and the
parameters within atol 1e-4.  The CLI trains on a tiny on-disk COLMAP
dataset from scripts/make_synthetic_colmap.py; its checkpoint loads in the
JAX package, and a JAX checkpoint renders through the port's CLI.
"""

import dataclasses
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webdgs_tpu.core.camera import CameraData as JaxCameraData
from webdgs_tpu.io import checkpoint as jck
from webdgs_tpu.io import colmap as jcolmap
from webdgs_tpu.ops.adam import init_adam_state as jinit_adam
from webdgs_tpu.train.config import TrainerConfig as JTrainerConfig
from webdgs_tpu.train.trainer import Trainer as JTrainer
from webdgs_tpu_torch.cli import main as cli_main
from webdgs_tpu_torch.core.camera import CameraData
from webdgs_tpu_torch.io import checkpoint as tck
from webdgs_tpu_torch.io import colmap as tcolmap
from webdgs_tpu_torch.io.images import load_images
from webdgs_tpu_torch.train import config as tconfig
from webdgs_tpu_torch.train.trainer import Trainer

from tests.torch_parity import (both_scenes, jax_settings, np_, numpy_scene,
                                torch_settings)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _views(n_views, w, h, seed):
    rng = np.random.default_rng(seed)
    cams_j, cams_t, images = [], [], []
    for i in range(n_views):
        pos = np.array([0.3 * i - 0.3, 0.1 * i, -5.0], np.float32)
        fields = dict(id=i, position=pos, rotation=np.eye(3, dtype=np.float32),
                      width=w, height=h, fy=40.0, fx=40.0,
                      img_name=f"v{i}.png")
        cams_j.append(JaxCameraData(**fields))
        cams_t.append(CameraData(**fields))
        images.append({"name": f"v{i}.png", "width": w, "height": h,
                       "image": rng.random((h, w, 3)).astype(np.float32)})
    return cams_j, cams_t, images


def _no_densify(cfg):
    return dataclasses.replace(cfg, densify=dataclasses.replace(
        cfg.densify, schedule=dataclasses.replace(cfg.densify.schedule,
                                                  enabled=False)))


def test_trainer_matches_jax_trainer():
    w, h = 48, 32
    params = numpy_scene(40, seed=61)
    js, ts = both_scenes(params)
    cams_j, cams_t, images = _views(3, w, h, seed=62)
    tj = JTrainer(js, cams_j, images, _no_densify(JTrainerConfig(seed=5)),
                  jax_settings())
    tt = Trainer(ts, cams_t, images,
                 _no_densify(tconfig.TrainerConfig(seed=5)), torch_settings())
    assert tt.scene.capacity == tj.scene.capacity
    for _ in range(3):
        mj = tj.step()
        mt = tt.step()
        assert set(mt) == set(mj)
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=1e-3)
        assert int(mt["tile_entries"]) == int(mj["tile_entries"])
    assert tt.iteration == tj.iteration == 3
    assert tt.rng.getstate() == tj.rng.getstate()  # same view draws
    assert tt._entry_cap() == tj._entry_cap()
    ev_t, ev_j = tt.evaluate(), tj.evaluate()
    for k in ("psnr", "l1", "ssim"):
        np.testing.assert_allclose(ev_t[k], ev_j[k], rtol=1e-3, err_msg=k)
    assert ev_t["views"] == 3
    assert tt.evaluate(max_views=2)["views"] == 2
    np.testing.assert_allclose(np_(tt.render_view(1)),
                               np.asarray(tj.render_view(1)), rtol=1e-4,
                               atol=3e-4)
    np.testing.assert_allclose(np_(tt.visualize_loss(2)),
                               np.asarray(tj.visualize_loss(2)), rtol=1e-4,
                               atol=3e-4)


def test_trainer_profile_dir_matches_jax(tmp_path):
    """``train(profile_dir=)``: both packages trace an iteration into the
    directory (the port with torch.profiler, a Chrome trace that names the
    step's ops) and train as they do untraced."""
    import json
    w, h = 48, 32
    params = numpy_scene(30, seed=63)
    js, ts = both_scenes(params)
    cams_j, cams_t, images = _views(2, w, h, seed=64)
    tj = JTrainer(js, cams_j, images, _no_densify(JTrainerConfig(seed=3)),
                  jax_settings())
    tt = Trainer(ts, cams_t, images,
                 _no_densify(tconfig.TrainerConfig(seed=3)), torch_settings())
    # two iterations untraced (JAX compiles at both: the first adapts the
    # entry capacity), the third traced
    for tr in (tj, tt):
        tr.train(2, log_every=0)
    lj = tj.train(1, log_every=0, profile_dir=str(tmp_path / "jax"))
    lt = tt.train(1, log_every=0, profile_dir=str(tmp_path / "torch"))
    np.testing.assert_allclose(lt["loss"], lj["loss"], rtol=1e-3)
    assert tt.iteration == tj.iteration == 3
    assert any(files for _, _, files in os.walk(tmp_path / "jax"))
    (trace,) = os.listdir(tmp_path / "torch")
    with open(tmp_path / "torch" / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any("sort" in str(n) for n in names)


def _densify_cfg(cfg, **kw):
    return dataclasses.replace(cfg, densify=dataclasses.replace(
        cfg.densify,
        schedule=dataclasses.replace(cfg.densify.schedule, enabled=True,
                                     warmup_iterations=2, interval=2,
                                     stop_iterations=6),
        metric_views=2, metric_downscale=2, metric_threshold=0.3,
        clone_threshold_count=3, split_scale_threshold=0.12,
        prune_opacity=0.45, max_new_points_per_step=24, **kw))


def test_trainer_with_densify_matches_jax_trainer(monkeypatch):
    """Densify on: 6 steps with events at 2, 4 and 6 (capacity growth at
    the first), the same seed, the same metric views and one injected
    noise in both packages."""
    from webdgs_tpu.ops import densify as jden
    from webdgs_tpu_torch.ops import densify as tden
    w, h = 64, 48
    params = numpy_scene(60, seed=63, spread=1.2)
    js, ts = both_scenes(params)
    cams_j, cams_t, images = _views(3, w, h, seed=64)
    rng = np.random.default_rng(65)
    u = rng.uniform(-1, 1, (8192, 3)).astype(np.float32)
    d = rng.normal(size=(8192, 3)).astype(np.float32)
    monkeypatch.setattr(jden, "densify_rng", lambda key, n: (
        jnp.asarray(u[:n]), jnp.asarray(d[:n])))
    monkeypatch.setattr(tden, "densify_rng", lambda gen, n: (
        torch.tensor(u[:n]), torch.tensor(d[:n])))
    tj = JTrainer(js, cams_j, images, _densify_cfg(JTrainerConfig(seed=6)),
                  jax_settings(), initial_capacity=64)
    tt = Trainer(ts, cams_t, images,
                 _densify_cfg(tconfig.TrainerConfig(seed=6)),
                 torch_settings(), initial_capacity=64)
    assert tt.scene.capacity == tj.scene.capacity == 64
    points = []
    for _ in range(6):
        mj, mt = tj.step(), tt.step()
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=1e-3)
        assert tt.num_points == tj.num_points
        assert tt.scene.capacity == tj.scene.capacity
        points.append(tt.num_points)
    assert len(set(points)) >= 3, points  # the events changed the scene
    assert tt.scene.capacity > 64  # grown at the first event
    assert tt.last_densify_iteration == tj.last_densify_iteration == 6
    assert tt.next_densify_iteration() == tj.next_densify_iteration()
    assert tt._entry_cap() == tj._entry_cap()
    assert tt.rng.getstate() == tj.rng.getstate()  # same view draws
    np.testing.assert_array_equal(np_(tt.scene.alive),
                                  np.asarray(tj.scene.alive))
    for k, v in tj.scene.params().items():
        np.testing.assert_allclose(np_(tt.scene.params()[k]), np.asarray(v),
                                   atol=1e-4, err_msg=k)


def test_trainer_refuses_densify_and_mesh(tmp_path, monkeypatch):
    """Nothing is refused now: densification is on by default, and a mesh
    of one rank (``make_mesh`` on a 1-rank gloo group) takes the
    single-device step, with the same result as no mesh; only a mesh on
    another device than the scene's is refused."""
    from webdgs_tpu_torch.parallel.sharding import make_mesh
    from webdgs_tpu_torch.train import trainer as ttrainer
    params = numpy_scene(10, seed=1)
    _, ts = both_scenes(params)
    _, cams, images = _views(1, 16, 16, seed=2)
    assert Trainer(ts, cams, images, tconfig.TrainerConfig()) \
        .config.densify.schedule.enabled
    cfg = _no_densify(tconfig.TrainerConfig())
    mesh = make_mesh("cpu", init_method=f"file://{tmp_path / 'store'}",
                     rank=0, world_size=1, timeout_s=60)
    try:
        assert (mesh.rank, mesh.size, mesh.device) == (0, 1,
                                                       torch.device("cpu"))
        dp_calls = []
        monkeypatch.setattr(ttrainer, "dp_train_step",
                            lambda *a, **k: dp_calls.append(1))
        with_mesh = Trainer(ts, cams, images, cfg, mesh=mesh)
        plain = Trainer(ts, cams, images, cfg)
        for tr in (with_mesh, plain):
            tr.step()
        assert not dp_calls and with_mesh.iteration == 1
        for k, v in plain.scene.params().items():
            torch.testing.assert_close(with_mesh.scene.params()[k], v,
                                       rtol=0, atol=0)
        other = dataclasses.replace(mesh, device=torch.device("meta"))
        with pytest.raises(ValueError, match="mesh"):
            Trainer(ts, cams, images, cfg, mesh=other)
    finally:
        mesh.close()
    tr = Trainer(ts, cams, images, cfg)
    assert tr.next_densify_iteration() is None
    tr.set_config({"densify": {"schedule": {"enabled": True}}})
    assert tr.config.densify.schedule.enabled
    assert tr.next_densify_iteration() == 500
    tr.set_config({"adam": {"lr_pos": 0.0}})
    assert tr.config.adam.lr_pos == 0.0
    with pytest.raises(ValueError, match="unknown config keys"):
        tconfig.load_trainer_config({"adam": {"nope": 1}})


def test_trainer_rolls_back_a_non_finite_loss():
    """A NaN target makes the loss NaN: training rolls back to the last
    snapshot, and gives up after MAX_ROLLBACKS in a row."""
    params = numpy_scene(12, seed=3)
    _, ts = both_scenes(params)
    cams_j, cams, images = _views(2, 16, 16, seed=4)
    tr = Trainer(ts, cams, images, _no_densify(tconfig.TrainerConfig()))
    tr.train(num_iterations=2, log_every=0, log_fn=None)
    good = tr.scene
    bad = [dict(m, image=np.full_like(m["image"], np.nan)) for m in images]
    tr.set_dataset(cams, bad)
    logs = []
    tr.train(num_iterations=1, log_every=1, log_fn=logs.append)
    assert any("rolling back to iteration 2" in s for s in logs), logs
    assert tr.iteration == 2 and tr.scene is good
    with pytest.raises(FloatingPointError, match="diverged"):
        tr.train(num_iterations=20, log_every=1, log_fn=None)


def _synthetic_dataset(tmp_path, views=3, w=48, h=32, points=200):
    out = tmp_path / "scene"
    subprocess.run([sys.executable,
                    os.path.join(ROOT, "scripts", "make_synthetic_colmap.py"),
                    str(out), "--views", str(views), "--width", str(w),
                    "--height", str(h), "--points", str(points)],
                   check=True, capture_output=True, timeout=300)
    return out


def test_colmap_and_images_match_jax(tmp_path):
    data = _synthetic_dataset(tmp_path, views=2, w=24, h=16, points=50)
    files = [str(data / "sparse" / "0" / f) for f in ("images.bin",
                                                      "cameras.bin")]
    ct, cj = tcolmap.load_cameras(files), jcolmap.load_cameras(files)
    assert len(ct) == len(cj) == 2
    for a, b in zip(ct, cj):
        assert isinstance(a, CameraData)
        for f in ("id", "camera_id", "img_name", "width", "height", "fx",
                  "fy", "cx", "cy"):
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_array_equal(a.rotation, b.rotation)
        np.testing.assert_array_equal(a.position, b.position)
    imgs = load_images(str(data / "images"))
    assert [m["name"] for m in imgs] == sorted(m["name"] for m in imgs)
    assert imgs[0]["image"].shape == (16, 24, 3)


def test_cli_train_writes_checkpoint_jax_can_load(tmp_path):
    data = _synthetic_dataset(tmp_path)
    sparse = data / "sparse" / "0"
    ck, ply = tmp_path / "ck.npz", tmp_path / "out.ply"
    args = ["train", "--points", str(sparse / "points3D.bin"),
            "--cameras", str(sparse / "images.bin"),
            str(sparse / "cameras.bin"), "--images", str(data / "images"),
            "--iterations", "3", "--log-every", "1", "--device", "cpu",
            "--out", str(ck), "--export-ply", str(ply)]
    proc = subprocess.run([sys.executable, "-m", "webdgs_tpu_torch", *args,
                           "--no-densify"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "iter 3: loss=" in proc.stdout and "eval:" in proc.stdout
    assert os.path.exists(ply)
    scene, opt, meta = jck.load_checkpoint(str(ck))
    assert meta["iteration"] == 3 and meta["version"] == 2
    assert int(opt.iteration) == 3
    from webdgs_tpu_torch.io.ply import load_point_cloud
    n_points = int(load_point_cloud(str(sparse / "points3D.bin"),
                                    "cpu").num_alive())
    assert int(scene.num_alive()) == n_points > 0
    assert opt.m.shape == (scene.capacity, 59)
    assert np.isfinite(np.asarray(scene.means)).all()

    # resume through the CLI from the same checkpoint
    cli_main(args[:args.index("--out")] + ["--no-densify", "--resume",
                                            str(ck), "--iterations", "4",
                                            "--out", str(ck)])
    assert jck.load_checkpoint(str(ck))[2]["iteration"] == 4


def test_cli_train_with_densify_and_export(tmp_path, capsys):
    """``train`` without --no-densify: events at 2, 4 and 6 change the
    logged point count; ``export`` turns its checkpoint into a PLY that
    loads in both packages."""
    from webdgs_tpu.io.ply import load_point_cloud as jload_point_cloud
    from webdgs_tpu_torch.io.ply import load_point_cloud
    data = _synthetic_dataset(tmp_path, views=3, w=64, h=48, points=300)
    sparse = data / "sparse" / "0"
    ck, ply = tmp_path / "d.npz", tmp_path / "d.ply"
    cli_main(["train", "--points", str(sparse / "points3D.bin"),
              "--cameras", str(sparse / "images.bin"),
              str(sparse / "cameras.bin"), "--images", str(data / "images"),
              "--iterations", "6", "--log-every", "1", "--device", "cpu",
              "--densify-warmup", "2", "--densify-interval", "2",
              "--densify-stop", "6", "--metric-views", "2",
              "--clone-threshold", "1", "--max-new-points", "40",
              "--out", str(ck)])
    out = capsys.readouterr().out
    points = [int(x) for x in re.findall(r"points=(\d+)", out)]
    assert len(points) == 6 and len(set(points)) > 1, points
    cli_main(["export", str(ck), "--out", str(ply), "--device", "cpu"])
    assert f"exported {points[-1]} splats" in capsys.readouterr().out
    scene, _, meta = tck.load_checkpoint(ck)
    assert meta["iteration"] == 6
    assert int(load_point_cloud(str(ply), "cpu").num_alive()) == \
        int(scene.num_alive()) == points[-1]
    assert int(jload_point_cloud(str(ply)).num_alive()) == points[-1]


def test_jax_checkpoint_loads_and_renders_in_port(tmp_path):
    params = numpy_scene(30, seed=71)
    js, _ = both_scenes(params, sh_deg=1)
    opt = jinit_adam(js.params())
    opt = opt.replace(m=opt.m + 0.5, iteration=jnp.int32(7))
    path = tmp_path / "jax.npz"
    jck.save_checkpoint(str(path), js, opt, iteration=7)
    scene, opt_t, meta = tck.load_checkpoint(path)
    assert meta["iteration"] == 7 and scene.sh_deg == 1
    assert opt_t.iteration == 7
    np.testing.assert_array_equal(np_(opt_t.m), np.asarray(opt.m))
    for k, v in js.params().items():
        np.testing.assert_array_equal(np_(scene.params()[k]), np.asarray(v))
    cli_main(["render", str(path), "--out", str(tmp_path / "r.png"),
              "--width", "32", "--height", "32", "--device", "cpu",
              "--position", "0", "0", "-5"])
    assert os.path.exists(tmp_path / "r.png")


def test_version1_checkpoint_packs_moments(tmp_path):
    params = numpy_scene(6, seed=72)
    rng = np.random.default_rng(0)
    arrays = dict(params, alive=np.ones(6, bool))
    for k, v in params.items():
        arrays[f"adam_m_{k}"] = rng.random(v.shape).astype(np.float32)
        arrays[f"adam_v_{k}"] = rng.random(v.shape).astype(np.float32)
    meta = {"version": 1, "sh_deg": 0, "iteration": 2, "adam_iteration": 2}
    arrays["_meta"] = np.frombuffer(__import__("json").dumps(meta).encode(),
                                    np.uint8)
    np.savez(tmp_path / "v1.npz", **arrays)
    _, opt_t, _ = tck.load_checkpoint(tmp_path / "v1.npz")
    _, opt_j, _ = jck.load_checkpoint(str(tmp_path / "v1.npz"))
    np.testing.assert_array_equal(np_(opt_t.m), np.asarray(opt_j.m))
    np.testing.assert_array_equal(np_(opt_t.v), np.asarray(opt_j.v))
    assert opt_t.iteration == 2
