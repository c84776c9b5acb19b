"""PyTorch port: the Gaussian-sharded training loop (``GsTrainer``) on gloo
ranks, against the port's single-device ``Trainer`` of the same seeds
(mirroring tests/test_sharding.py:419, :492, :543 and :586).

Ranks are spawned as in tests/test_torch_gs_render.py and run
tests/torch_dist_workers.py's jax-free ``gs_*`` cases; the whole state is
gathered on every rank (``full_scene``).  Bounds, those of :419: the event
at the same iteration with the same point count, both capacities adapted,
over 95 % of the canonical elements within 2e-2*|x| + 2e-4, and renders of
the two final scenes within max 1e-1 / mean 2e-3.  With one band the
GsTrainer is bit-identical to the Trainer across steps, two densify
events and a capacity growth."""

import numpy as np
import torch

from webdgs_tpu_torch.core.camera import default_camera
from webdgs_tpu_torch.core.scene import scene_from_numpy
from webdgs_tpu_torch.render.renderer import render
from webdgs_tpu_torch.train.trainer import Trainer

from tests import torch_dist_workers as workers
from tests.test_torch_gs_render import spawn
from tests.test_torch_gs_trainer import _canonical
from tests.torch_parity import numpy_scene, torch_settings

GROUPS = ("means", "quats", "log_scales", "opacity_logits", "sh")
STATE = GROUPS + ("alive", "m", "v")


def _bright(n, seed, shift=2.0):
    p = numpy_scene(n, seed=seed)
    p["opacity_logits"] = p["opacity_logits"] + shift
    return p


def _views_of(gt, positions, w, h):
    """The port's renders of ``gt`` (the targets), (V, H, W, 3)."""
    scene = scene_from_numpy(gt, np.ones(len(gt["means"]), bool), 0, "cpu")
    with torch.no_grad():
        return np.stack([render(scene, default_camera(
            w, h, position=tuple(p), device="cpu"), w, h,
            torch_settings()).image.numpy() for p in positions])


def _loop_inputs(gt_seed, scene_seed, **kw):
    """:419 -- four 32x32 views of a bright 12-Gaussian scene, 8 Gaussians
    to train, 2 metric views, clone threshold 1."""
    w = h = 32
    positions = np.asarray([(0.2 * i, 0.0, -5.0) for i in range(4)],
                           np.float32)
    inp = {"w": w, "h": h, "positions": positions,
           "images": _views_of(_bright(12, gt_seed), positions, w, h),
           "params": numpy_scene(8, seed=scene_seed), "steps": 5,
           "capacity": 64, "schedule": (3, 3, 10),
           "densify": dict(metric_views=2, clone_threshold_count=1,
                           prune_opacity=0.005, max_new_points_per_step=8)}
    inp.update(kw)
    return inp


def test_gs_trainer_loop_matches_single(tmp_path):
    """:419 on 2 ranks: 5 steps crossing the event at iteration 3."""
    inp = _loop_inputs(80, 81)
    res = spawn("gs_trainer", tmp_path, inp, 2)
    cams, imgs = workers._views(inp)
    ref = Trainer(workers._scene(inp["params"]), cams, imgs,
                  workers._gs_trainer_config(inp), workers.SETTINGS_EXACT,
                  initial_capacity=64)
    ref_losses = [float(ref.step()["loss"]) for _ in range(5)]
    for k in ["losses", "num_points", "densified_at"] + list(STATE):
        np.testing.assert_array_equal(res[1][k], res[0][k], err_msg=k)
    got = res[0]
    np.testing.assert_allclose(got["losses"], ref_losses, rtol=5e-3)
    assert int(got["densified_at"]) == ref.last_densify_iteration == 3
    assert int(got["num_points"]) == ref.num_points != 8  # the event swapped
    assert int(got["alive"].sum()) == ref.num_points
    assert (got["caps"] > 0).all(), got["caps"]
    assert int(got["capacity"]) == 64
    for r in res:  # each rank holds half the capacity
        assert len(r["shard_alive"]) == 32
    want = _canonical({k: v.numpy() for k, v in ref.scene.params().items()},
                      ref.scene.alive.numpy(), ref.opt_state.m.numpy(),
                      ref.opt_state.v.numpy())[:, :59]
    have = _canonical({k: got[k] for k in GROUPS}, got["alive"], got["m"],
                      got["v"])[:, :59]
    assert have.shape == want.shape
    tight = np.abs(have - want) <= 2e-2 * np.abs(want) + 2e-4
    assert np.mean(tight) > 0.95, np.mean(tight)
    cam = default_camera(32, 32, position=(0.0, 0.0, -5.0), device="cpu")
    final = scene_from_numpy({k: got[k] for k in GROUPS}, got["alive"], 0,
                             "cpu")
    with torch.no_grad():
        f_gs = render(final, cam, 32, 32, workers.SETTINGS_EXACT).image
        f_ref = render(ref.scene, cam, 32, 32, workers.SETTINGS_EXACT).image
    err = (f_gs - f_ref).abs()
    assert float(err.max()) < 1e-1 and float(err.mean()) < 2e-3


def test_gs_trainer_one_band_bit_identical(tmp_path):
    """One band: 5 steps with events at iterations 2 and 4 and the
    capacity grown from 4096 to 8192 at the first, bit for bit the
    single-device Trainer (parameters, moments, alive mask, losses)."""
    inp = _loop_inputs(82, 83, capacity=None, schedule=(2, 2, 10),
                       densify=dict(metric_views=2, clone_threshold_count=1,
                                    prune_opacity=0.005,
                                    max_new_points_per_step=5000))
    r = spawn("gs_trainer", tmp_path, inp, 1)[0]
    assert int(r["densified_at"]) == 4 and int(r["capacity"]) == 8192
    assert int(r["num_points"]) > 8
    np.testing.assert_array_equal(r["losses"], r["ref_losses"])
    for k in STATE + ("num_points", "densified_at"):
        np.testing.assert_array_equal(r[k], r["ref_" + k], err_msg=k)


def test_gs_trainer_2d_mesh_loop(tmp_path):
    """:543 -- a 2x2 dp x band mesh, f16 exchange: finite losses, an
    event, ``num_points`` = the alive count, and the dp replicas of each
    band bit-identical."""
    inp = _loop_inputs(84, 85, steps=4, schedule=(2, 2, 10), f16=True,
                       mesh_shape=(2, 2))
    res = spawn("gs_trainer", tmp_path, inp, 4)
    for r in res:
        assert np.isfinite(r["losses"]).all()
        assert int(r["densified_at"]) > 0
        assert int(r["num_points"]) == int(r["alive"].sum()) > 0
    for a, b in ((0, 2), (1, 3)):  # one column = one band's shard
        assert int(res[a]["band_rank"]) == int(res[b]["band_rank"])
        for k in STATE:
            np.testing.assert_array_equal(res[a]["shard_" + k],
                                          res[b]["shard_" + k], err_msg=k)
    for k in list(STATE) + ["losses"]:
        for r in res[1:]:
            np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)


def test_gs_adaptive_send_capacity(tmp_path):
    """:492 -- a concentrated scene at 16x16 tiles with a one-chunk send
    budget drops entries at the first step and none at the last."""
    w, h = 128, 64
    params = numpy_scene(256, seed=90)
    params["means"] = params["means"] * 0.3
    params["log_scales"] = np.full_like(params["log_scales"], -0.2)
    params["opacity_logits"] = params["opacity_logits"] + 2.0
    positions = np.asarray([(0.0, 0.0, -5.0)], np.float32)
    inp = {"w": w, "h": h, "positions": positions,
           "images": _views_of(params, positions, w, h), "params": params,
           "capacity": 256, "f16": True}
    res = spawn("gs_adaptive", tmp_path, inp, 2)
    dropped = res[0]["dropped"]
    assert dropped[0] > 0, f"the test does not exercise drops: {dropped}"
    assert dropped[-1] == 0, f"the budget never adapted: {dropped}"
    assert int(res[0]["send_cap"]) > workers.SETTINGS.chunk
    np.testing.assert_array_equal(res[1]["dropped"], dropped)


def test_gs_trainer_nan_rollback(tmp_path):
    """:586 -- a non-finite loss at iteration 4 rolls every rank back
    (rank 0 logs it), and training goes on with a finite state still
    sharded at capacity / B."""
    w = h = 32
    positions = np.asarray([(0.0, 0.0, -5.0)], np.float32)
    inp = {"w": w, "h": h, "positions": positions,
           "images": _views_of(_bright(10, 95), positions, w, h),
           "params": numpy_scene(8, seed=96), "capacity": 64,
           "max_iterations": 100}
    res = spawn("gs_rollback", tmp_path, inp, 2)
    for r in res:
        assert r["events"].tolist() == [1, 1]  # poisoned once, rolled back
        assert np.isfinite(float(r["last_loss"])) and bool(r["finite"])
        assert int(r["shard_capacity"]) == int(r["capacity"]) // 2 == 32
        assert int(r["iteration"]) == int(res[0]["iteration"])
    assert "rolling back" in str(res[0]["logs"])
    assert str(res[1]["logs"]) == ""  # rank 0 alone logs
