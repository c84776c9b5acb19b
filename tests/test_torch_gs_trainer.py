"""PyTorch port: the Gaussian-sharded trainer's state moves
(``parallel/gs_trainer.py``: ``rebalance_shards`` and ``gs_densify_event``)
on 2 and 4 gloo ranks, against the JAX reference (mirroring
tests/test_sharding.py:352), and the port's last small modules.

Ranks are spawned as in tests/test_torch_gs_render.py and run the
jax-free cases of tests/torch_dist_workers.py; the parent concatenates
their shards in band order.  Tolerances:
* the rebalance: exact on every slot, moments included, against the JAX
  ``rebalance_shards`` of the same whole state;
* the event, its clone/split noise injected into both packages (as
  tests/test_torch_densify.py does): the counts and the event's totals
  exact; the canonical (placement-free) rows within
  tests/test_torch_densify.py's rtol 1e-6 / atol 1e-6 of the JAX
  single-device composition, moments exact; bit for bit the port's own
  ``densify_prune``, set-wise; each shard as the JAX ``decide`` /
  ``cap_counts(base_offset)`` / ``compact_transform`` of its slice;
* ``sh_basis`` / ``eval_sh_color`` within 1e-6 of JAX, ``tree_size_bytes``
  equal.
The port's event against the JAX ``gs_densify_event`` itself on a
2-device sub-mesh is marked ``slow``."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from webdgs_tpu.core import scene as jscene
from webdgs_tpu.ops import densify as jden
from webdgs_tpu.ops import importance as jimp
from webdgs_tpu.ops import sh as jsh
from webdgs_tpu.ops.adam import AdamState as JAdamState
from webdgs_tpu.parallel import gs_trainer as jgs
from webdgs_tpu.render.renderer import render as jrender
from webdgs_tpu.train.config import DensifyPruneConfig as JCfg
from webdgs_tpu_torch.config import RenderSettings
from webdgs_tpu_torch.core import scene as tscene
from webdgs_tpu_torch.ops import densify as tden
from webdgs_tpu_torch.ops import importance as timp
from webdgs_tpu_torch.ops import sh as tsh
from webdgs_tpu_torch.ops.adam import AdamState
from webdgs_tpu_torch.parallel.gs_trainer import (_pair_counts,
                                                  balanced_counts,
                                                  prefix_pair_counts,
                                                  rebalance_permutation)
from webdgs_tpu_torch.train.config import DensifyPruneConfig

from tests.test_torch_gs_render import spawn
from tests.torch_parity import (both_cameras, both_scenes, jax_settings, np_,
                                numpy_scene, t_)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = ("means", "quats", "log_scales", "opacity_logits", "sh")
JS = jax_settings(chunk=128)
TS = RenderSettings(chunk=128)
PARAM_TOL = dict(rtol=1e-6, atol=1e-6)  # tests/test_torch_densify.py


def _jax_state(params, alive, m, v):
    js, _ = both_scenes(params)
    js = js.replace(alive=jnp.asarray(alive))
    return js, JAdamState(m=jnp.asarray(m), v=jnp.asarray(v),
                          iteration=jnp.int32(7))


def _concat(res, key):
    return np.concatenate([r[key] for r in res])


def _random_state(cap, seed, alive_frac=0.5):
    rng = np.random.default_rng(seed)
    return {"params": numpy_scene(cap, seed=seed),
            "alive": rng.random(cap) < alive_frac,
            "m": rng.normal(size=(cap, 59)).astype(np.float32),
            "v": rng.random((cap, 59)).astype(np.float32)}


@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("alive_frac", [0.0, 0.3, 1.0])
def test_rebalance_permutation_matches_jax(d, alive_frac):
    """The permutation alone, on one process: slot j of the JAX
    rebalance holds row src_of[j] (read off a state whose rows carry
    their index)."""
    cap = 24
    st = _random_state(cap, 40 + d, alive_frac)
    st["m"][:, 0] = np.arange(cap)
    js, jopt = _jax_state(**st)
    _, jnew = jgs.rebalance_shards(js, jopt, d)
    dest, src_of = rebalance_permutation(torch.tensor(st["alive"]), d)
    np.testing.assert_array_equal(np_(src_of), np.asarray(jnew.m[:, 0]))
    np.testing.assert_array_equal(np_(dest)[np_(src_of)], np.arange(cap))
    per = st["alive"][np_(src_of)].reshape(d, -1).sum(axis=1)
    assert per.tolist() == balanced_counts(int(st["alive"].sum()), d)


@pytest.mark.parametrize("d,n_loc", [(1, 16), (2, 7), (3, 5), (4, 9)])
def test_prefix_pair_counts_match_the_permutation(d, n_loc):
    """The host's split sizes of a prefix state equal those counted from
    the permutation, for every per-shard count."""
    import itertools
    for counts in itertools.product(range(n_loc + 1), repeat=d):
        alive = (torch.arange(n_loc)[None, :]
                 < torch.tensor(counts)[:, None]).reshape(-1)
        dest, _ = rebalance_permutation(alive, d)
        assert prefix_pair_counts(counts, n_loc) == \
            _pair_counts(dest, d).tolist(), counts


@pytest.fixture(scope="module", params=[2, 4])
def rebalanced(request, tmp_path_factory):
    d = request.param
    cap = 96  # 48 or 24 slots per shard
    inp = _random_state(cap, 30 + d)
    # a state whose shards' alive rows are prefixes, for the host split
    # sizes (one shard empty, one full)
    inp["prefix_counts"] = [0, cap // d] + [cap // d // (i + 2)
                                            for i in range(d - 2)]
    return d, inp, spawn("gs_rebalance", tmp_path_factory.mktemp(
        f"rebal{d}"), inp, d)


def test_rebalance_shards_matches_jax(rebalanced):
    """:352's rebalance on 2 and 4 ranks: every slot of the JAX rebalance
    of the same whole state, and at most one alive row between the
    fullest and the emptiest shard."""
    d, inp, res = rebalanced
    js, jopt = _jax_state(**{k: inp[k] for k in ("params", "alive", "m",
                                                  "v")})
    js_new, jopt_new = jgs.rebalance_shards(js, jopt, d)
    for k in GROUPS:
        np.testing.assert_array_equal(_concat(res, k),
                                      np.asarray(js_new.params()[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(_concat(res, "alive"),
                                  np.asarray(js_new.alive))
    np.testing.assert_array_equal(_concat(res, "m"), np.asarray(jopt_new.m))
    np.testing.assert_array_equal(_concat(res, "v"), np.asarray(jopt_new.v))
    per = [int(r["alive"].sum()) for r in res]
    assert max(per) - min(per) <= 1 and sum(per) == inp["alive"].sum()


def test_rebalance_split_sizes_from_host(rebalanced):
    """Split sizes from known per-shard prefix counts give the device
    path's result, and both the JAX rebalance's."""
    d, inp, res = rebalanced
    n_loc = len(inp["alive"]) // d
    alive = (np.arange(n_loc)[None, :]
             < np.asarray(inp["prefix_counts"])[:, None]).reshape(-1)
    js, jopt = _jax_state(inp["params"], alive, inp["m"], inp["v"])
    js_new, jopt_new = jgs.rebalance_shards(js, jopt, d)
    for k in GROUPS + ("alive", "m", "v"):
        np.testing.assert_array_equal(_concat(res, f"host_{k}"),
                                      _concat(res, f"dev_{k}"), err_msg=k)
    for k in GROUPS:
        np.testing.assert_array_equal(_concat(res, f"host_{k}"),
                                      np.asarray(js_new.params()[k]))
    np.testing.assert_array_equal(_concat(res, "host_m"),
                                  np.asarray(jopt_new.m))
    np.testing.assert_array_equal(_concat(res, "host_alive"),
                                  np.asarray(js_new.alive))


# the event of tests/test_sharding.py:352: 64 Gaussians at capacity 128,
# three 64x64 targets of a brighter 30-Gaussian scene, metric 32x32
EVENT_CFG = dict(metric_views=3, clone_threshold_count=2, prune_opacity=0.01,
                 split_scale_threshold=0.2, max_new_points_per_step=20)
W = H = 64
MW = MH = 32


def _event_inputs(d):
    params = numpy_scene(64, seed=70)
    params["opacity_logits"] = params["opacity_logits"] + 1.0
    cap = 128
    pad = {k: np.concatenate([v, np.zeros((cap - 64,) + v.shape[1:],
                                          np.float32)])
           for k, v in params.items()}
    alive = np.arange(cap) < 64
    m = np.full((cap, 59), 0.25, np.float32)
    v = np.full((cap, 59), 0.5, np.float32)
    # the state the GsTrainer keeps: rebalanced before the event
    js, jopt = _jax_state(pad, alive, m, v)
    js, jopt = jgs.rebalance_shards(js, jopt, d)
    gt = numpy_scene(30, seed=71)
    gt["opacity_logits"] = gt["opacity_logits"] + 2.0
    jgt, _ = both_scenes(gt)
    positions = np.asarray([(0.2 * i, 0.0, -5.0) for i in range(3)],
                           np.float32)
    targets = np.stack([np.asarray(jrender(
        jgt, both_cameras(W, H, position=tuple(p))[0], W, H, JS).image)
        for p in positions])
    rng = np.random.default_rng(72)
    return {"params": {k: np.asarray(x) for k, x in js.params().items()},
            "alive": np.asarray(js.alive), "m": np.asarray(jopt.m),
            "v": np.asarray(jopt.v), "positions": positions,
            "targets": targets, "metric_size": (MW, MH), "cfg": EVENT_CFG,
            "noise_u": rng.uniform(-1, 1, (cap, 3)).astype(np.float32),
            "noise_d": rng.normal(size=(cap, 3)).astype(np.float32)}


def _canonical(params, alive, m, v):
    """Alive rows (parameters and moments), sorted by a lexicographic key:
    placement-free (tests/test_sharding.py:333)."""
    feats = [np.asarray(params["means"])[alive],
             np.asarray(params["quats"])[alive],
             np.asarray(params["log_scales"])[alive],
             np.asarray(params["opacity_logits"])[alive][:, None],
             np.asarray(params["sh"])[alive].reshape(alive.sum(), -1),
             np.asarray(m)[alive], np.asarray(v)[alive]]
    mat = np.concatenate(feats, axis=1)
    return mat[np.lexsort(mat.T[::-1])]


def _inject(monkeypatch, inp):
    u, dn = inp["noise_u"], inp["noise_d"]
    monkeypatch.setattr(jden, "densify_rng", lambda key, n: (
        jnp.asarray(u[:n]), jnp.asarray(dn[:n])))
    monkeypatch.setattr(tden, "densify_rng", lambda gen, n: (
        t_(u[:n]), t_(dn[:n])))


@pytest.fixture(scope="module", params=[2, 4])
def event(request, tmp_path_factory):
    d = request.param
    inp = _event_inputs(d)
    return d, inp, spawn("gs_event", tmp_path_factory.mktemp(f"event{d}"),
                         inp, d)


def _jax_single(inp):
    js, jopt = _jax_state(inp["params"], inp["alive"], inp["m"], inp["v"])
    cams = [both_cameras(MW, MH, position=tuple(p))[0]
            for p in inp["positions"]]
    cam_batch = jax.tree.map(lambda *xs: jnp.stack(xs), *cams)
    t_small = jax.image.resize(jnp.asarray(inp["targets"]), (3, MH, MW, 3),
                               "linear")
    cfg = JCfg(**EVENT_CFG)
    counts = jimp.multiview_importance_counts(
        js.params(), js.alive, js.sh_deg, cam_batch, t_small, MW, MH,
        cfg.metric_threshold, JS)
    return js, jopt, counts, cfg


def test_gs_densify_event_matches_jax(event, monkeypatch):
    """:352 on 2 and 4 ranks against the JAX single-device composition
    (multiview_importance_counts + densify_prune) on the same rebalanced
    state."""
    d, inp, res = event
    _inject(monkeypatch, inp)
    js, jopt, counts, cfg = _jax_single(inp)
    ref = jden.densify_prune(js, jopt, counts, cfg, jax.random.PRNGKey(7))
    for r in res:
        np.testing.assert_array_equal(r["counts"], np.asarray(counts))
        for k in ("out_total", "in_alive", "n_cloned", "n_split",
                  "n_pruned"):
            assert int(r[k]) == int(getattr(ref, k)), k
    assert int(ref.n_cloned) + int(ref.n_split) + int(ref.n_pruned) > 0
    got = _canonical({k: _concat(res, k) for k in GROUPS},
                     _concat(res, "alive"), _concat(res, "m"),
                     _concat(res, "v"))
    want = _canonical({k: np.asarray(x) for k, x in ref.scene.params()
                       .items()}, np.asarray(ref.scene.alive),
                      ref.opt_state.m, ref.opt_state.v)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:, :59], want[:, :59], **PARAM_TOL)
    np.testing.assert_array_equal(got[:, 59:], want[:, 59:])
    # each shard's alive rows are the prefix its reported total says
    for r in res:
        n = int(r["alive"].sum())
        assert r["alive"][:n].all()
    assert [int(x) for x in res[0]["shard_totals"]] == [
        int(r["alive"].sum()) for r in res]


def test_gs_densify_event_matches_port_single(event, monkeypatch):
    """Set-wise bit for bit the port's own single-device densify_prune on
    the same counts, which equal the port's multiview counts."""
    d, inp, res = event
    _inject(monkeypatch, inp)
    _, ts = both_scenes(inp["params"])
    ts = dataclasses.replace(ts, alive=torch.tensor(inp["alive"]))
    topt = AdamState(t_(inp["m"]), t_(inp["v"]), 7)
    t_small = F.interpolate(t_(inp["targets"]).permute(0, 3, 1, 2),
                            size=(MH, MW), mode="bilinear",
                            align_corners=False, antialias=True)
    cams = [both_cameras(MW, MH, position=tuple(p))[1]
            for p in inp["positions"]]
    cfg = DensifyPruneConfig(**EVENT_CFG)
    counts = timp.multiview_importance_counts(
        ts.params(), ts.alive, 0, cams, t_small.permute(0, 2, 3, 1), MW, MH,
        cfg.metric_threshold, TS)
    np.testing.assert_array_equal(res[0]["counts"], np_(counts))
    ref = tden.densify_prune(ts, topt, counts, cfg, torch.Generator())
    got = _canonical({k: _concat(res, k) for k in GROUPS},
                     _concat(res, "alive"), _concat(res, "m"),
                     _concat(res, "v"))
    want = _canonical({k: np_(x) for k, x in ref.scene.params().items()},
                      np_(ref.scene.alive), np_(ref.opt_state.m),
                      np_(ref.opt_state.v))
    np.testing.assert_array_equal(got, want)


def test_gs_densify_event_placement_matches_jax(event, monkeypatch):
    """Each shard equals the JAX decide / cap_counts(base_offset) /
    second cap / compact_transform of its slice, with the single-device
    noise rows sliced."""
    d, inp, res = event
    _inject(monkeypatch, inp)
    js, jopt, counts, cfg = _jax_single(inp)
    n = js.capacity
    n_loc = n // d
    slices = [slice(b * n_loc, (b + 1) * n_loc) for b in range(d)]
    shards = [js.replace(alive=js.alive[s],
                         **{k: x[s] for k, x in js.params().items()})
              for s in slices]
    dec = [jden.decide(sh, counts[s], cfg) for sh, s in zip(shards, slices)]
    totals = np.asarray([int(c.sum()) for c, _ in dec])
    base = np.cumsum(totals) - totals
    max_out = min(n, int(js.alive.sum()) + cfg.max_new_points_per_step)
    for b, ((c, a), sh, s) in enumerate(zip(dec, shards, slices)):
        c, a, _ = jden.cap_counts(c, a, jnp.int32(max_out),
                                  base_offset=int(base[b]))
        c, a, tot = jden.cap_counts(c, a, jnp.int32(n_loc))
        p, o, valid = jden.compact_transform(
            sh.params(), JAdamState(m=jopt.m[s], v=jopt.v[s],
                                    iteration=jopt.iteration),
            c, a, tot, jnp.asarray(inp["noise_u"][s]),
            jnp.asarray(inp["noise_d"][s]))
        np.testing.assert_array_equal(res[b]["alive"], np.asarray(valid))
        for k in GROUPS:
            np.testing.assert_allclose(res[b][k], np.asarray(p[k]),
                                       **PARAM_TOL, err_msg=k)
        np.testing.assert_array_equal(res[b]["m"], np.asarray(o.m))
        np.testing.assert_array_equal(res[b]["v"], np.asarray(o.v))
        assert int(res[b]["shard_totals"][b]) == int(tot)


def test_cap_counts_base_offset_matches_jax():
    """cap_counts with a shard's base offset, int and 0-d tensor."""
    rng = np.random.default_rng(3)
    counts = rng.choice([0, 1, 2], size=40).astype(np.int32)
    actions = rng.choice([0, 1, 2, 3], size=40).astype(np.int32)
    for base in (0, 7, 30, 60):
        want = jden.cap_counts(jnp.asarray(counts), jnp.asarray(actions),
                               jnp.int32(45), base_offset=base)
        for b in (base, torch.tensor(base)):
            got = tden.cap_counts(t_(counts), t_(actions),
                                  torch.tensor(45, dtype=torch.int32),
                                  base_offset=b)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(np_(g), np.asarray(w))


@pytest.mark.slow
def test_gs_densify_event_matches_jax_gs_event(tmp_path, monkeypatch):
    """The port's event on 2 ranks against the JAX gs_densify_event
    itself on a 2-device sub-mesh of conftest's virtual CPU devices:
    every shard's slots (parameters within rtol 1e-6 / atol 1e-6, alive
    and moments exact)."""
    from jax.sharding import Mesh
    inp = _event_inputs(2)
    res = spawn("gs_event", tmp_path, inp, 2)
    u, dn = inp["noise_u"], inp["noise_d"]
    monkeypatch.setattr(jgs, "densify_rng", lambda key, n: (
        jnp.asarray(u[:n]), jnp.asarray(dn[:n])))
    js, jopt = _jax_state(inp["params"], inp["alive"], inp["m"], inp["v"])
    cams = [both_cameras(MW, MH, position=tuple(p))[0]
            for p in inp["positions"]]
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("band",))
    got = jgs.gs_densify_event(
        js, jopt, jax.tree.map(lambda *xs: jnp.stack(xs), *cams),
        jnp.asarray(inp["targets"]), jnp.arange(3, dtype=jnp.int32),
        jax.random.PRNGKey(7), mesh, mw=MW, mh=MH, cfg=JCfg(**EVENT_CFG),
        settings=JS)
    assert int(got.out_total) == int(res[0]["out_total"])
    np.testing.assert_array_equal(_concat(res, "alive"),
                                  np.asarray(got.scene.alive))
    for k in GROUPS:
        np.testing.assert_allclose(_concat(res, k),
                                   np.asarray(got.scene.params()[k]),
                                   **PARAM_TOL, err_msg=k)
    np.testing.assert_array_equal(_concat(res, "m"),
                                  np.asarray(got.opt_state.m))


# ---------------------------------------------------------------------------
# the last small modules
# ---------------------------------------------------------------------------

def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def test_sh_basis_matches_jax():
    dirs = _dirs(500, 1)
    got = np_(tsh.sh_basis(t_(dirs)))
    assert got.shape == (500, 16)
    np.testing.assert_allclose(got, np.asarray(jsh.sh_basis(
        jnp.asarray(dirs))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_color_matches_jax(deg):
    """Within 1e-6 of the JAX einsum form; bit for bit the port's row
    form (the same k-ascending sum)."""
    dirs = _dirs(400, 2 + deg)
    sh = np.random.default_rng(deg).normal(0, 0.5, (400, 16, 3)).astype(
        np.float32)
    got = np_(tsh.eval_sh_color(t_(sh), t_(dirs), deg))
    want = np.asarray(jsh.eval_sh_color(jnp.asarray(sh), jnp.asarray(dirs),
                                        deg))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    planar = t_(sh.reshape(400, 48).T.copy())
    rows = tsh.eval_sh_color_rows(planar, *t_(dirs).unbind(1), deg)
    np.testing.assert_array_equal(got, np_(torch.stack(rows, dim=1)))
    with pytest.raises(ValueError):
        tsh.eval_sh_color(t_(sh), t_(dirs), 4)


def test_tree_size_bytes_matches_jax():
    params = numpy_scene(37, seed=5)
    js, ts = both_scenes(params, sh_deg=2)
    assert tscene.tree_size_bytes(ts) == jscene.tree_size_bytes(js)
    assert tscene.tree_size_bytes(ts.params()) == jscene.tree_size_bytes(
        js.params())
    assert tscene.tree_size_bytes(ts) == 37 * (3 + 4 + 3 + 1 + 48) * 4 + 37
    assert tscene.tree_size_bytes([params, (ts.alive, 3)]) == (
        jscene.tree_size_bytes([params, js.alive]))


def test_lazy_top_level_api():
    """``import webdgs_tpu_torch`` loads no jax and none of its modules;
    each name of the reference's top-level API resolves to the port's
    object."""
    code = (
        "import sys, webdgs_tpu_torch as w\n"
        "assert 'jax' not in sys.modules\n"
        "mods = [m for m in sys.modules if m.startswith('webdgs_tpu')]\n"
        "assert mods == ['webdgs_tpu_torch'], mods\n"
        "from webdgs_tpu_torch.render.renderer import render\n"
        "from webdgs_tpu_torch.train.trainer import Trainer\n"
        "assert w.__getattr__('render') is render\n"
        "assert w.Trainer is Trainer\n"
        "for n in w.__all__: getattr(w, n)\n"
        "assert 'jax' not in sys.modules\n"
        "assert not any(m.startswith('webdgs_tpu.') or m == 'webdgs_tpu'"
        " for m in sys.modules)\n"
        "print(sorted(w.__all__))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    import webdgs_tpu
    assert out.stdout.strip() == str(sorted(webdgs_tpu.__all__))
