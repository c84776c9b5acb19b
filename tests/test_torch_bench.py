"""PyTorch port vs the JAX reference: the headline benchmark
(``webdgs_tpu_torch/bench.py``, ``python -m webdgs_tpu_torch bench``)
against bench.py's recipe.

The command runs at ``WEBDGS_BENCH_SCALE=tiny`` on the CPU in a subprocess
that loads no jax, on bench.py's scene and on a checkpoint, and prints one
JSON line with bench.py's keys (no ``sol_fraction``) plus the card, the
capacity and the kernel launches (0 on the CPU: the wrappers take their
plain versions).  The recipe itself is held against the JAX recipe built
from the same numpy draws (bench.py:93-157): every scene array equal, the
target render within the forward's parity tolerance
(tests/test_render_forward.py), the probe step's ``tile_entries`` and the
derived capacity equal.
"""

import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from webdgs_tpu.core.scene import scene_from_arrays as jscene_from_arrays
from webdgs_tpu.ops.adam import init_adam_state as jinit_adam
from webdgs_tpu.render.renderer import render_compiled as jrender_compiled
from webdgs_tpu.train.step import train_step as jtrain_step
from webdgs_tpu_torch import bench
from webdgs_tpu_torch.io.checkpoint import save_checkpoint
from webdgs_tpu_torch.ops.adam import init_adam_state
from webdgs_tpu_torch.render.renderer import render
from webdgs_tpu_torch.train.step import train_step

from tests.torch_parity import (IMG_ATOL, IMG_RTOL, both_cameras,
                                jax_settings, np_, torch_settings)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = {"expand_fields", "rasterize_tiles", "tile_loss_tiles",
           "rasterize_tiles_backward", "segment_sum_rows", "entry_counts",
           "cull_words", "entry_keys", "adam_step"}
# bench.py's keys (:197-208) less sol_fraction, and the port's additions
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "vs_target_10x",
             "render_mpix_per_sec_per_chip", "baseline_note", "card",
             "splats", "observed_entries", "entry_capacity", "step_ms",
             "frame_ms", "kernel_launches"}


def _bench_command(env_extra: dict) -> dict:
    """``python -m webdgs_tpu_torch bench --device cpu`` at tiny scale in a
    subprocess; checks that it loaded no jax and nothing of webdgs_tpu, and
    returns its JSON line."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['webdgs_tpu_torch', 'bench', '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_module('webdgs_tpu_torch', run_name='__main__',\n"
        "                     alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "assert 'jax' not in sys.modules\n"
        "assert not any(m == 'webdgs_tpu' or m.startswith('webdgs_tpu.')\n"
        "               for m in sys.modules)\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("WEBDGS_BENCH_")}
    env.update(WEBDGS_BENCH_SCALE="tiny", **env_extra)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    assert "[bench] timing train steps" in out.stderr
    return json.loads(lines[0])


def _check_line(line: dict, metric: str, splats: int) -> None:
    assert set(line) == LINE_KEYS, sorted(line)
    assert line["metric"] == metric
    assert line["unit"] == "iters/s" and line["card"] == "cpu"
    assert line["splats"] == splats
    for k in ("value", "render_mpix_per_sec_per_chip", "step_ms",
              "frame_ms"):
        assert math.isfinite(line[k]) and line[k] > 0, (k, line[k])
    assert line["vs_baseline"] == round(line["value"] / 10.0, 2)
    assert line["entry_capacity"] == bench.entry_capacity(
        line["observed_entries"], 128)
    assert line["observed_entries"] > 0
    # the CPU takes every kernel's plain version
    assert line["kernel_launches"] == dict.fromkeys(KERNELS, 0)


def test_bench_command_tiny_on_cpu():
    line = _bench_command({})
    _check_line(line, "train_iters_per_sec_100k_splats_800x600_cpu"
                "_SMOKE_TINY", 500)


def test_bench_command_on_a_checkpoint(tmp_path):
    """``WEBDGS_BENCH_CHECKPOINT``: the metric names the alive count, not
    the padded capacity."""
    scene = bench.bench_scene("cpu", 300).pad_to(512)
    ck = tmp_path / "ck.npz"
    save_checkpoint(ck, scene, init_adam_state(scene.params()), iteration=7)
    line = _bench_command({"WEBDGS_BENCH_CHECKPOINT": str(ck)})
    _check_line(line, "train_iters_per_sec_trained_300_splats_800x600_cpu"
                "_SMOKE_TINY", 300)


@pytest.mark.parametrize("name, tag", [
    ("NVIDIA H100 80GB HBM3", "h100"), ("NVIDIA H100 PCIe", "h100"),
    ("NVIDIA A100-SXM4-80GB", "a100"), ("NVIDIA GeForce RTX 4090", "4090"),
    ("Tesla T4", "t4"), ("Some GPU", "some_gpu")])
def test_metric_names_the_card_it_ran_on(name, tag):
    """The metric's last word comes from the card's own name, so a run on
    another card never carries ``h100``."""
    assert bench.card_tag(name) == tag


def test_bench_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run_bench("cuda")


@pytest.mark.parametrize("observed", [0.0, 1.0, 628.0, 342_079.0,
                                      409_600.0])
@pytest.mark.parametrize("capx", [1.0, 1.2, 1.5])
def test_entry_capacity_matches_bench_py(observed, capx):
    chunk = 128
    # bench.py:155-156
    want = max(-int(-observed * capx // chunk) * chunk, chunk * 8)
    assert bench.entry_capacity(observed, chunk, capx) == want


def _jax_bench_scene(n: int):
    """bench.py:95,109-118 (the JAX recipe), from the same numpy draws."""
    rng = np.random.default_rng(0)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    return jscene_from_arrays(
        rng.normal(0, 1.5, (n, 3)).astype(np.float32),
        quats=quats,
        log_scales=rng.uniform(-4.5, -2.5, (n, 3)).astype(np.float32),
        opacity_logits=rng.uniform(-1, 3, (n,)).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
    )


def test_bench_recipe_matches_jax():
    """At the tiny scale (500 splats, 128x96): the scene, the target render,
    the probe step's entries and the capacity."""
    n, w, h = 500, 128, 96
    js = _jax_bench_scene(n)
    ts = bench.bench_scene("cpu", n)
    assert ts.sh_deg == js.sh_deg == 0
    for k, v in ts.params().items():
        np.testing.assert_array_equal(np_(v), np.asarray(getattr(js, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(np_(ts.alive), np.asarray(js.alive))

    jc, tc = both_cameras(w, h, position=(0.0, 0.0, -8.0))
    js_set, ts_set = jax_settings(chunk=128), torch_settings(chunk=128)
    target_j = jrender_compiled(js, jc, img_w=w, img_h=h,
                                settings=js_set).image
    with torch.no_grad():
        target_t = render(ts, tc, w, h, ts_set).image
    np.testing.assert_allclose(np_(target_t), np.asarray(target_j),
                               rtol=IMG_RTOL, atol=IMG_ATOL)
    assert float(target_t.max()) > 0.1, "the target should have content"

    probe_j = jax.jit(lambda s, o: jtrain_step(
        s, o, jc, target_j, img_w=w, img_h=h, settings=js_set))
    _, _, m_j = probe_j(js, jinit_adam(js.params()))
    _, _, m_t = train_step(ts, init_adam_state(ts.params()), tc, target_t,
                           img_w=w, img_h=h, settings=ts_set)
    obs_j, obs_t = float(m_j["tile_entries"]), float(m_t["tile_entries"])
    assert obs_t == obs_j > 0
    cap_j = max(-int(-obs_j * 1.2 // 128) * 128, 128 * 8)  # bench.py:155
    assert bench.entry_capacity(obs_t, 128) == cap_j
