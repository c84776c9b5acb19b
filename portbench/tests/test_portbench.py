"""CPU tests of the port's benchmark, at tiny sizes.

    python -m pytest portbench/tests -q

They hold the harness's data files to BENCHMARK.json, the operation and
byte counts to a hand-worked tile, the plain reference to the port's plain
path (a step, an event and a frame, through ``run.run_cell`` with the
chip's check skipped), the trainer to what the harness takes from it, the
output check's control and planted faults to its limits, and the harness
to importing neither JAX nor the JAX package.
"""

from __future__ import annotations

import copy
import json
import math
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path.insert(0, str(HERE))

import counts  # noqa: E402
import run  # noqa: E402
from reference import gs as ref  # noqa: E402

CPU = torch.device("cpu")
SEED = 4_000_000_007  # beyond 32 bits


def tiny(cell: str, root: Path = ROOT) -> dict:
    lc = run.load_cell(cell, root)
    c = lc["config"]
    c.update(gaussians=3000, width=96, height=64, views=12)
    c["trainer"]["densify"].update(metric_views=4, clone_threshold_count=20)
    return lc


def test_every_name_resolves():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert set(cfg["reduced"]) == set(c["reduced"])
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    for w in bench["workloads"]:
        lc = run.load_cell(w["name"])
        assert lc["limits"], w["name"]
        got = {m["name"] for m in lc["e2e"]}
        assert "setup_s" in got and len(got) >= 2
        assert lc["per_layer"], w["name"]
        for m in lc["per_layer"]:
            assert m["moves"] in got
            assert lc["readers"][m["name"]].is_file()
        # every reader returns nothing when it finds nothing to read
        for path in lc["readers"].values():
            assert run.read_metric(path, {"kind": "none"}) is None
    assert names >= {"train_it_per_s", "train_it_per_s.densify", "view_fps",
                     "setup_s"}


def test_a_cell_is_added_by_files_and_one_entry(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = tmp_path / "portbench"
    traffic = json.loads((base / "traffic" / "densify-phase.json")
                         .read_text())
    (base / "traffic" / "late-densify.json").write_text(json.dumps(
        {**traffic, "resume_iteration": 14897}))
    (base / "limits" / "mip360-late-densify.json").write_text(
        (base / "limits" / "tandt-densify.json").read_text())
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "mip360-late-densify",
                               "config": "mip360-2.96m-sh3",
                               "traffic": "late-densify", "chips": 1,
                               "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    lc = run.load_cell("mip360-late-densify", tmp_path)
    assert lc["traffic"]["resume_iteration"] == 14897
    assert lc["config"]["name"] == "mip360-2.96m-sh3"
    assert {m["name"] for m in lc["e2e"]} == {"setup_s"}


def test_counts_of_a_crafted_tile():
    """One 32x16 tile: entry 0 reaches only pixel (4, 4) (a tight box),
    entry 1 every pixel, entry 2 none.  Pairs up to each pixel's last
    contributor inside the box: 511 x 1 + 2 = 513; entries that reach a
    pixel: 2."""
    rs = {**run.load_cell("mip360-view")["config"]["render"], **ref.TILE}
    attrs = {
        "center": torch.tensor([[4.5, 4.5], [16.0, 8.0], [0.5, 0.5]]),
        "conic": torch.tensor([[100.0, 0.0, 100.0], [1e-6, 0.0, 1e-6],
                               [1.0, 0.0, 1.0]]),
        "color": torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                               [0.0, 0.0, 1.0]]),
        "opacity": torch.tensor([0.5, 0.5, 0.9]),
        "ext": torch.tensor([[0.5, 0.5], [1e3, 1e3], [-1.0, -1.0]])}
    lists = {"gauss": torch.tensor([0, 1, 2]), "starts": torch.tensor([0, 3]),
             "ntx": 1, "nty": 1, "entries": 3}
    out = ref.composite(attrs, lists, 32, 16, rs, pairs=True)
    assert out["pairs"] == 513.0
    assert out["needed_entries"] == 2
    img = out["image"]
    assert torch.allclose(img[4, 4], torch.tensor([0.5, 0.25, 0.0]),
                          atol=1e-4)
    assert torch.allclose(img[0, 0], torch.tensor([0.0, 0.5, 0.0]),
                          atol=1e-4)
    flops, nbytes = counts.raster_fwd(513, 2, 512, 1)
    assert flops == 28 * 513
    assert nbytes == 4 * (11 * 2 + 4 * 512 + 2)
    flops, nbytes = counts.raster_bwd(513, 2, 512, 1)
    assert flops == 54 * 513
    assert nbytes == 4 * (20 * 2 + 8 * 512 + 2)
    s, bound = counts.least_time(28 * 513, 4 * (22 + 2048 + 2))
    assert bound == "bytes" and s == pytest.approx(8288 / 3.35e12)


def _printed(err: str, key: str) -> str:
    (line,) = [x for x in err.splitlines() if x.startswith(key)]
    return line[len(key):]


@pytest.mark.parametrize("cell", ["tandt-densify", "mip360-refine",
                                  "mip360-view"])
def test_reference_agrees_with_the_port(cell, capsys):
    lc = tiny(cell)
    out = run.run_cell(lc, SEED, 1.0, False, CPU)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {m["name"] for m in lc["e2e"]}
    for name, c in out["checks"].items():
        assert c["value"] < 1e-5, name
    # the chunk times printed add up to the window
    err = capsys.readouterr().err
    window = float(_printed(err, "window: ").split(" s,")[0])
    chunks = json.loads(_printed(err, "chunks_ms: "))
    assert len(chunks) >= 1
    assert sum(chunks) * 1e-3 == pytest.approx(window, rel=0.01)
    assert "stalls: " in err
    assert _printed(err, "gc collections in the window by generation: ")


def test_each_cell_resolves_to_gs():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        lc = run.load_cell(w["name"])
        assert "reference" not in lc["config"], w["name"]
        assert run.reference(lc) is ref, w["name"]


def _stub(calls: list):
    """A reference module that is ``gs`` with a ``prepare`` that records
    its calls."""
    stub = types.ModuleType("reference.stub")
    stub.__dict__.update({k: v for k, v in vars(ref).items()
                          if not k.startswith("__")})

    def prepare(p, cams, cfg):
        calls.append((p["means"].shape[0], len(cams), cfg["name"]))
        return p

    stub.prepare = prepare
    return stub


def test_a_named_reference_is_loaded_and_prepared(monkeypatch):
    calls = []
    stub = _stub(calls)
    monkeypatch.setitem(sys.modules, "reference.stub", stub)
    lc = tiny("tandt-densify")
    lc["config"]["reference"] = "stub"
    assert run.reference(lc) is stub
    st = run.setup_train(lc, SEED, CPU)
    got = run.reference_train(lc, SEED, st, CPU, stub.Prec("fp32"))
    # prepare saw every view before the compared steps, and the rows the
    # event left after it
    views = lc["config"]["views"]
    name = lc["config"]["name"]
    assert calls == [(st["n"], views, name),
                     (got["event"]["out"], views, name)]
    base = copy.deepcopy(lc)
    del base["config"]["reference"]
    want = run.reference_train(base, SEED, st, CPU, ref.Prec("fp32"))
    assert run.compare_train(got, want) == run.compare_train(want, want)


def test_an_unknown_reference_names_its_file(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = tmp_path / "portbench" / "configs" / "mip360-2.96m-sh3.json"
    path.write_text(json.dumps({**json.loads(path.read_text()),
                                "reference": "no-such-ref"}))
    with pytest.raises(FileNotFoundError, match="reference/no-such-ref.py"):
        run.load_cell("mip360-view", tmp_path)
    for bad in ("../gs", "", 3):
        with pytest.raises(FileNotFoundError, match="mip360-2.96m-sh3"):
            run.load_reference({"name": "mip360-2.96m-sh3",
                                "reference": bad})


def test_jax_in_the_process_is_found():
    """By whole top-level names: the port's own name begins with the JAX
    package's and is not one of them."""
    code = ("import sys; sys.path.insert(0, 'portbench'); import run; "
            "import webdgs_tpu_torch.train.trainer; "
            "assert run.banned_modules() == [], run.banned_modules(); "
            "sys.modules['jax.numpy'] = sys; "
            "sys.modules['webdgs_tpu.ops'] = sys; "
            "sys.modules['webdgs_tpu_torch_extra'] = sys; "
            "assert run.banned_modules() == ['jax', 'webdgs_tpu']")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)


def test_the_event_is_compared():
    lc = tiny("tandt-densify")
    st = run.setup_train(lc, SEED, CPU)
    prog = st["prog"]
    refo = run.reference_train(lc, SEED, st, CPU, ref.Prec("fp32"))
    assert refo["event"] == prog["event"]
    assert refo["capacity"] == prog["capacity"] > st["capacity"]
    ev = prog["event"]
    assert ev["cloned"] > 0 and ev["split"] > 0 and ev["pruned"] > 0
    assert set(refo["event_state"]) == set(prog["event_state"])
    assert set(refo["event_moments"]) == set(prog["event_moments"])
    assert len(prog["losses"]) == lc["traffic"]["compare_steps"]
    assert set(prog["post_change"]) == set(run.LEAVES)


def test_the_trainer_contract(monkeypatch):
    """What the harness takes from the trainer beyond its public calls:
    the steps' views and an event's metric views drawn from
    ``random.Random(config.seed)`` as ``run.trainer_draws`` has them; the
    event's noise, uniform then normal rows over the grown capacity from
    a generator seeded ``config.seed``; the Adam moments packed by
    ``run.LEAVES``.  A change to any of these fails here first."""
    import webdgs_tpu_torch.ops.densify as densify_mod
    import webdgs_tpu_torch.train.trainer as trainer_mod
    from webdgs_tpu_torch.ops.adam import PACK_LAYOUT

    assert {k: (lo, hi) for k, lo, hi, _ in PACK_LAYOUT} == run.LEAVES
    seen = {"cams": [], "metric": [], "noise": []}
    real_step = trainer_mod.train_step
    real_counts = trainer_mod.multiview_importance_counts
    real_noise = densify_mod.densify_rng

    def step(scene, opt_state, cam, *a, **kw):
        seen["cams"].append(cam)
        return real_step(scene, opt_state, cam, *a, **kw)

    def counts_(params, alive, sh_deg, cams, *a, **kw):
        seen["metric"].append(cams)
        return real_counts(params, alive, sh_deg, cams, *a, **kw)

    def noise(generator, n):
        out = real_noise(generator, n)
        seen["noise"].append((n, out))
        return out

    monkeypatch.setattr(trainer_mod, "train_step", step)
    monkeypatch.setattr(trainer_mod, "multiview_importance_counts", counts_)
    monkeypatch.setattr(densify_mod, "densify_rng", noise)
    lc = tiny("tandt-densify")
    st = run.setup_train(lc, SEED, CPU)
    (group,) = st["trainer"].groups.values()
    cams = group["cams"]

    def index(view):
        return next(i for i, c in enumerate(cams) if c.view is view)

    assert [index(c.view) for c in seen["cams"]] == st["views"]
    (event,) = st["events"]
    assert [[index(c.view) for c in v] for v in seen["metric"]] == [
        st["events"][event]]
    (n, (u, d)), = seen["noise"]
    dcfg = lc["config"]["trainer"]["densify"]
    assert n == ref.grown_capacity(st["n"], st["capacity"], dcfg)
    gen = torch.Generator(device=CPU)
    gen.manual_seed(st["noise_seed"])
    assert torch.equal(u, torch.rand((n, 3), generator=gen) * 2.0 - 1.0)
    assert torch.equal(d, torch.randn((n, 3), generator=gen))


@pytest.mark.parametrize("cell", ["tandt-densify", "mip360-view"])
def test_the_control_fails_the_limits(cell):
    lc = tiny(cell)
    if lc["traffic"]["kind"] == "train":
        st = run.setup_train(lc, SEED, CPU)
        base = run.reference_train(lc, SEED, st, CPU, ref.Prec("fp32"))
        low = run.reference_train(lc, SEED, st, CPU, ref.Prec("tf32"))
        numbers = run.compare_train(low, base)
    else:
        import calibrate
        rows = calibrate.view_readings(lc, SEED, CPU, True, 0.5)
        numbers = {k: v for k, v in rows[1].items() if k != "kind"}
    ok, checks = run.judge(numbers, lc["limits"])
    assert not ok, checks


def _faulty(monkeypatch, fault: str):
    """Break the timed path underneath the harness."""
    import webdgs_tpu_torch.train.step as step_mod
    import webdgs_tpu_torch.train.trainer as trainer_mod
    from webdgs_tpu_torch.render.viewer import Viewer

    if fault == "unchanged":
        real = trainer_mod.train_step

        def same(scene, opt_state, *a, **kw):
            return real(scene, opt_state, *a, **kw)._replace(
                scene=scene, opt_state=opt_state)

        monkeypatch.setattr(trainer_mod, "train_step", same)
    elif fault == "half":
        real = step_mod.tile_loss_gradient

        def half(*a, **kw):
            dpix, metrics = real(*a, **kw)
            keep = torch.ones(dpix.shape[0], 1, 1)
            keep[dpix.shape[0] // 2:] = 0.0
            return dpix * keep * 2.0, metrics

        monkeypatch.setattr(step_mod, "tile_loss_gradient", half)
    elif fault == "loss":
        real = step_mod.tile_loss_gradient

        def altered(*a, **kw):
            dpix, metrics = real(*a, **kw)
            return dpix, {**metrics, "loss": metrics["loss"] * 1.01}

        monkeypatch.setattr(step_mod, "tile_loss_gradient", altered)
    elif fault == "counts":
        real = trainer_mod.multiview_importance_counts
        monkeypatch.setattr(trainer_mod, "multiview_importance_counts",
                            lambda *a, **kw: 2.0 * real(*a, **kw))
    elif fault == "clone_pick":
        real = trainer_mod.densify_prune

        def shifted(scene, opt_state, counts, *a, **kw):
            return real(scene, opt_state, torch.roll(counts, 1), *a, **kw)

        monkeypatch.setattr(trainer_mod, "densify_prune", shifted)
    elif fault == "growth":
        monkeypatch.setattr(trainer_mod.Trainer, "_grow_capacity",
                            lambda self: None)
    elif fault == "split_scale":
        import webdgs_tpu_torch.ops.densify as densify_mod
        monkeypatch.setattr(densify_mod, "LN_1P6", 0.0)
    elif fault == "frame":
        real = Viewer.render

        def frame(self, *a, **kw):
            img = real(self, *a, **kw)
            img[:16] = 0.0
            return img

        monkeypatch.setattr(Viewer, "render", frame)


@pytest.mark.parametrize("cell,fault", [
    ("mip360-refine", "unchanged"), ("mip360-refine", "half"),
    ("mip360-refine", "loss"), ("tandt-densify", "counts"),
    ("tandt-densify", "clone_pick"), ("tandt-densify", "split_scale"),
    ("tandt-densify", "growth"),
    ("mip360-view", "frame")])
def test_a_broken_path_is_not_correct(monkeypatch, cell, fault):
    _faulty(monkeypatch, fault)
    out = run.run_cell(tiny(cell), SEED, 0.5, False, CPU)
    assert not out["correct"], out["checks"]


def test_no_jax_in_the_harness():
    code = ("import sys; sys.path.insert(0, 'portbench'); import run, "
            "calibrate; import webdgs_tpu_torch.train.trainer, "
            "webdgs_tpu_torch.render.viewer; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'webdgs_tpu' or "
            "m.startswith('webdgs_tpu.')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)


def test_no_result_without_cuda(tmp_path):
    """Without a card, and in a directory of the benchmark's files alone,
    the run exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, tmp_path):
        p = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload",
             "mip360-view", "--seed", str(SEED), "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert p.returncode != 0
        assert p.stdout.strip() == ""


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -12, 1.0 + 2.0 ** -10, -3.14159])
    r = ref.tf32_round(x)
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == 1.0 + 2.0 ** -10
    assert math.isclose(float(r[3]), -3.140625)
