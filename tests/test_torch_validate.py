"""PyTorch port vs the JAX reference: the training validation
(scripts/validate_training_torch.py against scripts/validate_training.py).

Both scripts run as subprocesses at a small size without densification:
the same iteration count and final point count, the held-out PSNR at the
start within 0.01 dB and at the end within 0.05 dB (the two trainers draw
the same views, tests/test_torch_trainer.py).  The port's script alone
runs long enough for one densify event (the schedule's warmup is 300
iterations) and its held-out PSNR rises.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--views", "3", "--size", "48", "32", "--gt-points", "300",
         "--init-points", "60"]
# the scripts print the PSNR rounded to 0.01 dB
ROUNDING = 1e-6


def _port_script(args: list[str]) -> tuple[dict, str]:
    """Run the port's script on the CPU in a subprocess that must load no
    jax; returns its JSON result and its output."""
    script = os.path.join(ROOT, "scripts", "validate_training_torch.py")
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{script!r}] + {args!r} + ['--device', 'cpu']\n"
        f"runpy.run_path({script!r}, run_name='__main__')\n"
        "assert 'jax' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stdout


def test_validate_training_matches_jax_script():
    args = ["--iters", "6", *SMALL, "--no-densify"]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "WEBDGS_COMP_CACHE": "0"}
    ref = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "validate_training.py"), *args,
         "--cpu"], capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=600)
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    got, _ = _port_script(args)
    assert set(got) == set(want)
    assert got["iters"] == want["iters"] == 6
    assert got["points_final"] == want["points_final"] == 60
    assert abs(got["psnr_holdout_init"] - want["psnr_holdout_init"]) <= \
        0.01 + ROUNDING, (got, want)
    assert abs(got["psnr_holdout_final"] - want["psnr_holdout_final"]) <= \
        0.05 + ROUNDING, (got, want)
    assert got["psnr_holdout_final"] > got["psnr_holdout_init"]


@pytest.mark.slow  # 400 CPU training steps: ~20 s wall, ~130 s of CPU time
def test_validate_training_densify_event_raises_holdout_psnr():
    got, log = _port_script(["--iters", "400", *SMALL])
    event = json.loads(log.split("last densify event:", 1)[1].splitlines()[0])
    assert event["iteration"] == 300  # warmup 300, stop 400 * 3 // 4
    assert event["in"] == 60
    assert got["iters"] == 400
    assert got["psnr_holdout_final"] > got["psnr_holdout_init"] + 1.0
