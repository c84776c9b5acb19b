"""PyTorch port: view-data-parallel training and the tile-sharded render on
2-rank gloo groups, against the port's single-device path and the JAX
reference.

Each case spawns two CPU ranks with ``torch.multiprocessing.spawn``; they
meet through a ``file://`` store under ``tmp_path`` with a 60 s group
timeout, run a case of tests/torch_dist_workers.py (which imports no jax)
and save arrays that this process checks.  The cases mirror the dp cases
of tests/test_sharding.py (:39, :50, :100, :137, :176).  The JAX parity
case runs the JAX ``dp_train_step`` here, on a 2-device sub-mesh of
conftest's 8 virtual CPU devices, at tests/test_torch_step.py's
tolerances.
"""

import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from webdgs_tpu.ops import adam as jadam
from webdgs_tpu.ops.loss import LossConfig as JLossConfig
from webdgs_tpu.parallel import sharding as jsharding
from webdgs_tpu_torch.core.camera import default_camera
from webdgs_tpu_torch.render.renderer import render

from tests import torch_dist_workers as workers
from tests.test_torch_step import _assert_params_follow_rule
from tests.torch_parity import (both_cameras, both_scenes, jax_settings,
                                np_, numpy_scene, torch_settings)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
DP_TOL = dict(rtol=2e-4, atol=2e-6)  # tests/test_sharding.py:92-95
GROUPS = ("means", "quats", "log_scales", "opacity_logits", "sh")


def _spawn(case: str, out_dir, inp: dict) -> list[dict]:
    """Run ``case`` on WORLD ranks; their saved arrays, by rank."""
    out_dir = str(out_dir)
    mp.spawn(workers.rank_main,
             args=(WORLD, os.path.join(out_dir, "store"), case, out_dir,
                   inp), nprocs=WORLD, join=True)
    return [dict(np.load(os.path.join(out_dir, f"{case}_r{r}.npz")))
            for r in range(WORLD)]


def _assert_ranks_equal(res: list[dict], keys) -> None:
    for k in keys:
        for r in range(1, WORLD):
            np.testing.assert_array_equal(res[r][k], res[0][k], err_msg=k)


def _bright(params):
    return {**params, "opacity_logits": params["opacity_logits"] + 2.0}


def _renders(params, positions, w, h) -> np.ndarray:
    """The port's renders of a scene from each position, (V, H, W, 3)."""
    _, ts = both_scenes(params)
    with torch.no_grad():
        return np.stack([np_(render(ts, default_camera(
            w, h, position=tuple(p), device="cpu"), w, h,
            torch_settings()).image) for p in positions])


def test_tile_sharded_render_matches_single(tmp_path):
    """:39 -- 64x64, 4 tile rows split over the ranks."""
    inp = {"w": 64, "h": 64, "params": numpy_scene(80, seed=21)}
    res = _spawn("tile_sharded", tmp_path, inp)
    for r in res:
        assert r["sharded"].shape == (64, 64, 3)
        np.testing.assert_allclose(r["sharded"], r["single"], rtol=1e-5,
                                   atol=1e-5)
        assert r["band"].shape == (32, 64, 3)
    np.testing.assert_array_equal(
        np.concatenate([res[0]["band"], res[1]["band"]]), res[0]["sharded"])
    assert res[0]["single"].max() > 0.1


def test_tile_sharded_more_devices_than_rows(tmp_path):
    """:176 -- 48x16 is one tile row: rank 1 renders an empty band."""
    inp = {"w": 48, "h": 16, "params": numpy_scene(40, seed=24)}
    res = _spawn("tile_sharded", tmp_path, inp)
    for r in res:
        assert r["sharded"].shape == (16, 48, 3)
        np.testing.assert_allclose(r["sharded"], r["single"], rtol=1e-5,
                                   atol=1e-5)
    assert not res[1]["band"].any()  # padding: background only


@pytest.fixture(scope="module")
def dp_case(tmp_path_factory):
    """:50 -- one dp step over 2 views of 32x32 on 2 ranks (one view
    each), and its inputs."""
    w = h = 32
    positions = np.asarray([(0.1 * i, 0.0, -5.0) for i in range(WORLD)],
                           np.float32)
    params = numpy_scene(30, seed=22)
    inp = {"w": w, "h": h, "params": params, "positions": positions,
           "images": _renders(_bright(numpy_scene(30, seed=23)), positions,
                              w, h)}
    return inp, _spawn("dp_step", tmp_path_factory.mktemp("dp"), inp)


def test_dp_train_step_matches_single(dp_case):
    _, res = dp_case
    names = [k for k in res[0] if k.startswith("dp_")]
    # the replicated state stays bit-identical across the ranks
    _assert_ranks_equal(res, names + ["m", "v"])
    for k in GROUPS:
        np.testing.assert_allclose(res[0][f"dp_{k}"], res[0][f"ref_{k}"],
                                   **DP_TOL, err_msg=k)
    for k in ("loss", "l1", "l2", "dssim", "psnr", "visible",
              "tile_entries"):
        assert f"metric_{k}" in res[0], k
    assert np.isfinite(res[0]["metric_loss"])
    assert int(res[0]["iteration"]) == 1


def test_dp_train_step_matches_jax(dp_case):
    """The port's 2-rank step against the JAX dp_train_step on a 2-device
    sub-mesh, at tests/test_torch_step.py's tolerances: metrics rtol 1e-4
    (counts exact), moments within the gradient tolerance, new parameters
    by its significance rule."""
    inp, res = dp_case
    w, h = inp["w"], inp["h"]
    js, _ = both_scenes(inp["params"])
    cams = [both_cameras(w, h, position=tuple(p))[0]
            for p in inp["positions"]]
    cam_batch = jax.tree.map(lambda *xs: jnp.stack(xs), *cams)
    hp = jadam.AdamHyperparameters()
    mesh = jsharding.make_mesh(jax.devices()[:WORLD])
    new_j, opt_j, met_j = jsharding.dp_train_step(
        js, jadam.init_adam_state(js.params()), cam_batch,
        jnp.asarray(inp["images"]), mesh, img_w=w, img_h=h,
        loss_cfg=JLossConfig(), hp=hp, settings=jax_settings(chunk=128))
    got = res[0]
    for k in ("l1", "l2", "dssim", "loss", "psnr"):
        np.testing.assert_allclose(got[f"metric_{k}"], float(met_j[k]),
                                   rtol=1e-4, err_msg=k)
    for k in ("visible", "tile_entries"):
        assert int(got[f"metric_{k}"]) == int(met_j[k]), k
    m_j, v_j = np.asarray(opt_j.m), np.asarray(opt_j.v)
    m_scale = max(np.abs(m_j).max(), 0.1)
    np.testing.assert_allclose(got["m"] / m_scale, m_j / m_scale, rtol=1e-3,
                               atol=1e-4)
    v_scale = max(np.abs(v_j).max(), 1e-3)
    np.testing.assert_allclose(got["v"] / v_scale, v_j / v_scale, rtol=2e-3,
                               atol=2e-4)
    _assert_params_follow_rule(
        {k: torch.tensor(got[f"dp_{k}"]) for k in GROUPS},
        new_j.params(), m_j, hp)


def _trainer_inputs(gt_seed, scene_seed):
    """:100 / :137 -- four 32x32 views of a bright 12-Gaussian scene."""
    w = h = 32
    positions = np.asarray([(0.2 * i, 0.0, -5.0) for i in range(4)],
                           np.float32)
    return {"w": w, "h": h, "positions": positions,
            "images": _renders(_bright(numpy_scene(12, seed=gt_seed)),
                               positions, w, h),
            "params": numpy_scene(8, seed=scene_seed)}


def test_trainer_with_mesh(tmp_path):
    """:100 -- three steps, then ``train``: finite losses, the same metrics
    on both ranks, one iteration per step, the entry capacity adapted from
    the dp metrics, only rank 0 logging and checkpointing, and every rank
    resuming to the same state."""
    res = _spawn("trainer", tmp_path, _trainer_inputs(50, 51))
    _assert_ranks_equal(res, ["losses", "psnr", "entry_cap_peak",
                              "last_loss"])
    for r in res:
        assert np.isfinite(r["losses"]).all() and np.isfinite(r["psnr"])
        assert int(r["iteration"]) == 3
        assert float(r["entry_cap_peak"]) > 0
    assert [int(r["log_lines"]) for r in res] == [2, 0]
    assert os.path.isfile(tmp_path / "ck_r0.npz")
    assert not os.path.exists(tmp_path / "ck_r1.npz")
    trained = [k for k in res[0] if k.startswith("trained_")]
    resumed = [k for k in res[0] if k.startswith("resumed_")]
    _assert_ranks_equal(res, trained + resumed)
    for k in GROUPS:  # resume_from pads the capacity: compare its prefix
        n = len(res[0][f"trained_{k}"])
        np.testing.assert_array_equal(res[0][f"resumed_{k}"][:n],
                                      res[0][f"trained_{k}"], err_msg=k)
    assert [int(r["resumed_iteration"]) for r in res] == [5, 5]


def test_trainer_with_mesh_densify(tmp_path):
    """:137 -- a densify event while training on the mesh: it runs
    replicated, both ranks take the same decisions and hold bit-identical
    parameters after it, and the next dp step trains on the swapped
    state."""
    res = _spawn("trainer_densify", tmp_path, _trainer_inputs(60, 61))
    for r in res:
        assert np.isfinite(r["losses"]).all()
        assert int(r["densified_at"]) > 0
    ev = res[0]["event"]
    assert ev[2] != ev[1], "the event changed the scene"
    _assert_ranks_equal(res, ["event", "num_points", "alive", "m", "losses"]
                        + [f"p_{k}" for k in GROUPS])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_command_shard_dp_under_torchrun(tmp_path):
    """``torchrun --nproc_per_node=2 -m webdgs_tpu_torch train --shard dp
    --device cpu``: exit 0, one 'sharding' line and one log line per
    iteration (rank 0 alone logs), a checkpoint with the run's iteration;
    ``--shard gs`` is refused, naming the later slice."""
    from webdgs_tpu_torch.io.checkpoint import load_checkpoint
    data = tmp_path / "scene"
    subprocess.run([sys.executable, os.path.join(
        ROOT, "scripts", "make_synthetic_colmap.py"), str(data), "--views",
        "3", "--width", "48", "--height", "32", "--points", "200"],
        check=True, capture_output=True, timeout=120)
    sparse = data / "sparse" / "0"
    ck = tmp_path / "ck.npz"
    train = ["-m", "webdgs_tpu_torch", "train", "--points",
             str(sparse / "points3D.bin"), "--cameras",
             str(sparse / "images.bin"), str(sparse / "cameras.bin"),
             "--images", str(data / "images"), "--iterations", "6",
             "--densify-warmup", "2", "--densify-interval", "2",
             "--clone-threshold", "1", "--log-every", "1", "--device",
             "cpu", "--out", str(ck)]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run",
         f"--nproc_per_node={WORLD}", "--master_port", str(_free_port())]
        + train + ["--shard", "dp"], capture_output=True, text=True,
        timeout=300, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count(f"sharding 'dp' over {WORLD} device(s)") == 1
    iters = [int(i) for i in re.findall(r"iter (\d+):", proc.stdout)]
    assert iters == list(range(1, 7))
    losses = [float(x) for x in re.findall(r"loss=(\S+)", proc.stdout)]
    assert np.isfinite(losses).all()
    _, _, meta = load_checkpoint(str(ck), "cpu")
    assert meta["iteration"] == 6
    refused = subprocess.run([sys.executable] + train + ["--shard", "gs"],
                             capture_output=True, text=True, timeout=300,
                             cwd=ROOT, env=env)
    assert refused.returncode != 0 and "later" in refused.stderr
