"""PyTorch port: ``torchrun --nproc_per_node=2 -m webdgs_tpu_torch train
--shard gs --device cpu`` with densification on a tiny synthetic COLMAP
dataset (as tests/test_torch_sharding.py runs ``--shard dp``): exit 0,
one log line per iteration from rank 0 alone, finite losses, a changing
point count, and a whole-scene checkpoint and PLY, which the JAX package
loads with the logged point count."""

import json
import os
import re
import subprocess
import sys

import numpy as np

from webdgs_tpu.io.checkpoint import load_checkpoint as jax_load_checkpoint
from webdgs_tpu_torch.io.ply import load_point_cloud

from tests.test_torch_sharding import ROOT, _free_port


def test_train_command_shard_gs_under_torchrun(tmp_path):
    data = tmp_path / "scene"
    subprocess.run([sys.executable, os.path.join(
        ROOT, "scripts", "make_synthetic_colmap.py"), str(data), "--views",
        "3", "--width", "48", "--height", "32", "--points", "200"],
        check=True, capture_output=True, timeout=120)
    sparse = data / "sparse" / "0"
    ck, ply, report = (tmp_path / "ck.npz", tmp_path / "s.ply",
                       tmp_path / "report.json")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run",
         "--nproc_per_node=2", "--master_port", str(_free_port()), "-m",
         "webdgs_tpu_torch", "train", "--shard", "gs", "--points",
         str(sparse / "points3D.bin"), "--cameras",
         str(sparse / "images.bin"), str(sparse / "cameras.bin"),
         "--images", str(data / "images"), "--iterations", "6",
         "--densify-warmup", "2", "--densify-interval", "2",
         "--clone-threshold", "1", "--log-every", "1", "--device", "cpu",
         "--out", str(ck), "--export-ply", str(ply), "--report",
         str(report)], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("sharding 'gs' over 2 device(s)") == 1
    assert [int(i) for i in re.findall(r"iter (\d+):", proc.stdout)] == \
        list(range(1, 7))
    losses = [float(x) for x in re.findall(r"loss=(\S+)", proc.stdout)]
    points = [int(x) for x in re.findall(r"points=(\d+)", proc.stdout)]
    assert np.isfinite(losses).all() and len(set(points)) > 1, points
    scene, opt, meta = jax_load_checkpoint(str(ck))
    assert meta["iteration"] == 6
    assert int(scene.num_alive()) == points[-1]
    assert scene.capacity % 2 == 0 and opt.m.shape == (scene.capacity, 59)
    assert int(load_point_cloud(str(ply), "cpu").num_alive()) == points[-1]
    with open(report) as f:
        rep = json.load(f)
    assert rep["points"] == points[-1] and np.isfinite(rep["train"]["psnr"])
