"""The SH colour's VJP as a stage of its own (``train/step.py``: span
``sh_vjp`` before ``project_vjp``), held against one autograd call over
the unsplit projection; the Gaussian-sharded step on the split; and the
benchmark's full-SH cell and the Mip-NeRF 360 configuration under the
densify phase's traffic at a tiny size on the CPU, through
``portbench/run.py:run_cell``.

Tolerances: with DC only the split gives the unsplit routing bit for bit.
With full SH every gradient but the means' comes from the same operations
and is bit-identical; the means' gradient sums the geometry's and the
view directions' contributions in another order, so it is held within
1e-6 of its largest magnitude (float32 summation order, a few ulps of
the largest term).  Torch runs 2 threads here, so that the suite's
workers do not oversubscribe the cores.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from webdgs_tpu_torch import trace
from webdgs_tpu_torch.core.camera import default_camera
from webdgs_tpu_torch.core.scene import scene_from_numpy
from webdgs_tpu_torch.ops.projection import SplatAttrs, project_gaussians
from webdgs_tpu_torch.train import step as tstep

from tests.test_torch_gs_render import spawn
from tests.torch_parity import numpy_scene, torch_settings

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEED = 4_000_000_007  # beyond 32 bits
W, H = 48, 32
MEANS_TOL = 1e-6


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _case(sh_deg: int, seed: int = 51):
    params = numpy_scene(60, seed=seed)
    scene = scene_from_numpy(params, np.ones(60, bool), sh_deg, CPU)
    cam = default_camera(W, H, position=(0.0, 0.0, -5.0), device=CPU)
    return scene, cam, torch_settings(max_splat_radius_px=3.0)


def _cotangents(attrs: SplatAttrs, seed: int) -> SplatAttrs:
    g = torch.Generator().manual_seed(seed)
    return SplatAttrs(*(torch.randn(a.shape, generator=g) for a in attrs))


def _unsplit(scene, cam, settings, full_sh: bool, d_attrs):
    """The projection in one graph and its VJP in one autograd call, with
    the DC routing and the radius-cap guard: the step before the split."""
    params = {k: v.detach().requires_grad_(True)
              for k, v in scene.params().items()}
    attrs, aux = project_gaussians(params, scene.alive, cam, W, H,
                                   scene.sh_deg, settings,
                                   detach_color=not full_sh)
    pairs = [(a, d) for a, d in zip(attrs, d_attrs) if a.requires_grad]
    grads = torch.autograd.grad([a for a, _ in pairs], list(params.values()),
                                grad_outputs=[d for _, d in pairs],
                                allow_unused=True)
    g = {k: torch.zeros_like(v) if d is None else d
         for (k, v), d in zip(params.items(), grads)}
    if not full_sh:
        g["sh"] = torch.zeros_like(params["sh"])
        g["sh"][:, 0, :] = d_attrs.color
    g["log_scales"] = torch.where(aux.radius_capped[:, None],
                                  torch.clamp(g["log_scales"], min=0.0),
                                  g["log_scales"])
    return attrs, aux, g


@pytest.mark.parametrize("full_sh,sh_deg", [(False, 3), (True, 3),
                                            (True, 1), (True, 0)])
def test_split_vjp_matches_one_autograd_call(full_sh, sh_deg):
    scene, cam, settings = _case(sh_deg)
    params, attrs, _, aux, stage = tstep._project(
        scene, cam, W, H, settings, parity_sh=not full_sh)
    assert (stage is not None) == full_sh
    d_attrs = _cotangents(attrs, seed=52)
    want_attrs, want_aux, want = _unsplit(scene, cam, settings, full_sh,
                                          d_attrs)
    assert bool(want_aux.radius_capped.any())
    for a, b in zip(attrs, want_attrs):
        assert torch.equal(a, b)
    got = tstep._project_vjp(params, attrs, d_attrs, aux, stage)
    assert list(got) == list(want)
    for k in want:
        if k == "means" and full_sh:
            scale = float(want[k].abs().max())
            assert float((got[k] - want[k]).abs().max()) <= MEANS_TOL * scale
        else:
            assert torch.equal(got[k], want[k]), k
    rest = got["sh"][:, 1:]
    if full_sh and sh_deg > 0:
        assert bool(rest.any())
    else:
        assert not bool(rest.any())


def test_sh_vjp_span_opens_before_project_vjp():
    """In a step, ``sh_vjp`` and then ``project_vjp`` open under the
    step's span, in both SH modes; tracing off records nothing."""
    from webdgs_tpu_torch.ops.adam import (AdamHyperparameters,
                                           init_adam_state)
    scene, cam, settings = _case(3)
    target = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(
        53))
    trace.disable()
    trace.take()
    try:
        for full_sh in (False, True):
            hp = AdamHyperparameters(full_sh=full_sh)
            trace.enable()
            with trace.span("train.step"):
                tstep.train_step(scene, init_adam_state(scene.params()), cam,
                                 target, img_w=W, img_h=H, hp=hp,
                                 settings=settings)
            trace.disable()
            spans = trace.take().spans
            names = [s.name for s in spans if s.parent is not None
                     and spans[s.parent].name == "train.step"]
            assert names.index("sh_vjp") + 1 == names.index("project_vjp")
            assert names.index("backward") < names.index("sh_vjp")
        tstep.train_step(scene, init_adam_state(scene.params()), cam,
                         target, img_w=W, img_h=H, settings=settings)
        assert not trace.take().spans
    finally:
        trace.disable()
        trace.take()


def test_gs_train_step_on_the_split(tmp_path):
    """Two gloo ranks, each with half the Gaussians, train every SH
    coefficient at sh_deg 3: their shards and moments are the
    single-device step's bit for bit, and the rest bands move."""
    w = h = 64
    rng = np.random.default_rng(54)
    inp = {"w": w, "h": h, "sh_deg": 3, "params": numpy_scene(64, seed=55),
           "target": rng.random((h, w, 3)).astype(np.float32)}
    res = spawn("gs_step_full_sh", tmp_path, inp, 2)
    for key in ("m", "v") + tuple(f"p_{k}" for k in inp["params"]):
        got = np.concatenate([r[f"gs_{key}"] for r in res])
        np.testing.assert_array_equal(got, res[0][f"single_{key}"],
                                      err_msg=key)
    m = res[0]["single_m"]
    assert np.abs(m[:, 14:59]).max() > 0  # the rest bands' lanes
    moved = res[0]["single_p_sh"][:, 1:] - inp["params"]["sh"][:, 1:]
    assert np.abs(moved).max() > 0


# ----------------------------------------------------------------------
# the benchmark's cells, tiny


def _run():
    sys.path.insert(0, str(ROOT / "portbench"))
    import run
    return run


# pairs no cell runs, as (the cell whose entry and limits they take, the
# configuration): Mip-NeRF 360 in the densify phase, whose window's rate
# spreads across runs on an H100 by more than half its 1 % bound
OFF_BENCH = {"mip360-densify": ("tandt-densify", "mip360-2.96m-sh3")}


def tiny(cell: str) -> dict:
    """portbench/tests/test_portbench.py's tiny sizes."""
    run = _run()
    base, config = OFF_BENCH.get(cell, (cell, None))
    lc = run.load_cell(base, ROOT)
    if config is not None:
        lc["config"] = run.load_json(ROOT / "portbench" / "configs"
                                     / f"{config}.json")
    c = lc["config"]
    c.update(gaussians=3000, width=96, height=64, views=12)
    c["trainer"]["densify"].update(metric_views=4, clone_threshold_count=20)
    return lc


@pytest.mark.parametrize("cell", ["mip360-fullsh-refine", "mip360-densify"])
def test_cell_agrees_with_the_reference(cell):
    run = _run()
    out = run.run_cell(tiny(cell), SEED, 1.0, False, CPU)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    for name, c in out["checks"].items():
        assert c["value"] < 1e-5, name
    assert tiny(cell)["config"]["trainer"]["adam"]["full_sh"] == (
        cell == "mip360-fullsh-refine")


def test_dc_only_program_fails_the_full_sh_limits():
    """The program trained DC-only against the full-SH reference breaks
    the full-SH cell's limits: the check tells the two apart."""
    run = _run()
    from reference import gs as ref
    lc = tiny("mip360-fullsh-refine")
    dc = copy.deepcopy(lc)
    dc["config"]["trainer"]["adam"]["full_sh"] = False
    st = run.setup_train(dc, SEED, CPU)
    refo = run.reference_train(lc, SEED, st, CPU, ref.Prec("fp32"))
    numbers = run.compare_train(st["prog"], refo)
    ok, checks = run.judge(numbers, lc["limits"])
    assert not ok, checks
    assert numbers["grad_gap"] > lc["limits"]["grad_gap"], checks
