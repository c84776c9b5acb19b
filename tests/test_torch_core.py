"""PyTorch port vs the JAX reference: camera, scene, SH, projection and
PLY I/O (rtol/atol 1e-5 on floats, exact on integers and masks)."""

import math

import numpy as np
import pytest
import torch

from webdgs_tpu.core import camera as jcam
from webdgs_tpu.io import ply as jply
from webdgs_tpu.ops import sh as jsh
from webdgs_tpu.ops import projection as jprojection
from webdgs_tpu.ops.projection import project_gaussians as jproject
from webdgs_tpu_torch.core import camera as tcam
from webdgs_tpu_torch.core.scene import scene_from_arrays, scene_from_numpy
from webdgs_tpu_torch.io import ply as tply
from webdgs_tpu_torch.ops import sh as tsh
from webdgs_tpu_torch.ops import projection as tprojection
from webdgs_tpu_torch.ops.projection import project_gaussians

from tests.torch_parity import (CPU, both_cameras, both_scenes,
                                jax_settings, np_, numpy_scene,
                                torch_settings)

TOL = dict(rtol=1e-5, atol=1e-5)


def _rotation(seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


@pytest.mark.parametrize("w,h,fy", [(96, 80, None), (64, 48, 70.0),
                                    (1920, 1080, 1100.0)])
def test_make_camera_matches_jax(w, h, fy):
    data = dict(position=np.array([0.3, -0.2, -4.0], np.float32),
                rotation=_rotation(w), fy=fy, height=h if fy else None)
    jc = jcam.make_camera(jcam.CameraData(**data), w, h)
    tc = tcam.make_camera(tcam.CameraData(**data), w, h, device=CPU)
    for name in jc._fields:
        got = np_(getattr(tc, name))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(getattr(jc, name)),
                                   **TOL, err_msg=name)
    assert tcam.fov2focal(0.7, 640) == jcam.fov2focal(0.7, 640)
    assert tcam.focal2fov(500.0, 640) == jcam.focal2fov(500.0, 640)
    with pytest.raises(ValueError):
        tcam.make_camera(tcam.CameraData(), device=CPU)


def test_default_camera_matches_jax():
    jc, tc = both_cameras(96, 80, position=(0.1, 0.2, -6.0))
    for name in jc._fields:
        np.testing.assert_allclose(np_(getattr(tc, name)),
                                   np.asarray(getattr(jc, name)), **TOL)


def test_weight_carry_over_and_scene_methods():
    params = numpy_scene(37, seed=3)
    js, ts = both_scenes(params, sh_deg=2)
    # the carry-over recipe: numpy copies of the reference's params
    carried = scene_from_numpy({k: np.asarray(v)
                                for k, v in js.params().items()},
                               np.asarray(js.alive), js.sh_deg, CPU)
    for k, v in js.params().items():
        np.testing.assert_array_equal(np_(carried.params()[k]),
                                      np.asarray(v), err_msg=k)
        np.testing.assert_array_equal(np_(ts.params()[k]), np.asarray(v))
    assert carried.sh_deg == 2 and carried.sh.shape == (37, 16, 3)
    assert carried.means.dtype == torch.float32

    padded, jpadded = ts.pad_to(50), js.pad_to(50)
    assert padded.capacity == 50
    assert int(padded.num_alive()) == int(jpadded.num_alive()) == 37
    np.testing.assert_array_equal(np_(padded.alive),
                                  np.asarray(jpadded.alive))
    np.testing.assert_array_equal(np_(padded.sh), np.asarray(jpadded.sh))
    with pytest.raises(ValueError):
        ts.pad_to(10)
    moved = ts.with_params({k: v + 1.0 for k, v in ts.params().items()})
    np.testing.assert_array_equal(np_(moved.means), params["means"] + 1.0)
    assert moved.alive is ts.alive
    with pytest.raises(ValueError):
        scene_from_numpy({"means": params["means"]}, np.ones(37, bool), 0,
                         CPU)


def test_scene_from_arrays_point_cloud_defaults():
    from webdgs_tpu.core.scene import scene_from_arrays as jfrom
    rng = np.random.default_rng(4)
    xyz = rng.normal(size=(20, 3)).astype(np.float32)
    rgb = rng.uniform(size=(20, 3)).astype(np.float32)
    js = jfrom(xyz, colors=rgb, capacity=24)
    ts = scene_from_arrays(xyz, colors=rgb, capacity=24, device=CPU)
    for k, v in js.params().items():
        np.testing.assert_array_equal(np_(ts.params()[k]), np.asarray(v))
    np.testing.assert_array_equal(np_(ts.alive), np.asarray(js.alive))


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_rows_match_jax(deg):
    import jax.numpy as jnp
    rng = np.random.default_rng(78 + deg)
    n = 64
    sh = rng.normal(0, 0.5, (n, 16, 3)).astype(np.float32)
    dirs = rng.normal(0, 1, (n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    planar = sh.reshape(n, 48).T
    want = jsh.eval_sh_color_rows(jnp.asarray(planar),
                                  *(jnp.asarray(dirs[:, i])
                                    for i in range(3)), deg)
    got = tsh.eval_sh_color_rows(torch.tensor(planar),
                                 *(torch.tensor(dirs[:, i])
                                   for i in range(3)), deg)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(np_(g), np.asarray(wnt), **TOL)
    with pytest.raises(ValueError):
        tsh.eval_sh_color_rows(torch.tensor(planar), *got, 4)


@pytest.mark.parametrize("sh_deg,pos,scaling", [
    (0, (0.0, 0.0, -5.0), None),
    (3, (0.4, -0.3, -4.0), None),
    (3, (0.0, 0.0, -5.0), 1.7),
])
def test_projection_matches_jax(sh_deg, pos, scaling):
    params = numpy_scene(300, seed=11 + sh_deg)
    js, ts = both_scenes(params, sh_deg=sh_deg)
    w, h = 96, 80
    jc, tc = both_cameras(w, h, position=pos)
    ja, jx = jproject(js.params(), js.alive, jc, w, h, sh_deg,
                      jax_settings(), gaussian_scaling=scaling)
    ta, tx = project_gaussians(ts.params(), ts.alive, tc, w, h, sh_deg,
                               torch_settings(), gaussian_scaling=scaling)
    vis = np.asarray(jx.visible)
    assert vis.sum() > 20, "test scene should be visible"
    np.testing.assert_array_equal(np_(tx.visible), vis)
    for name in ja._fields:
        np.testing.assert_allclose(np_(getattr(ta, name))[vis],
                                   np.asarray(getattr(ja, name))[vis],
                                   **TOL, err_msg=name)
    np.testing.assert_allclose(np_(tx.depth), np.asarray(jx.depth), **TOL)
    np.testing.assert_array_equal(np_(tx.num_tiles), np.asarray(jx.num_tiles))
    for name in ("tile_min", "tile_dims"):
        np.testing.assert_array_equal(np_(getattr(tx, name))[vis],
                                      np.asarray(getattr(jx, name))[vis])
    np.testing.assert_array_equal(np_(tx.radius_capped),
                                  np.asarray(jx.radius_capped))
    assert tx.num_tiles.dtype == torch.int32


def test_quat_to_rotmat_matches_jax():
    """Unnormalised quaternions: no normalisation on either side."""
    q = np.random.default_rng(8).normal(0, 1, (64, 4)).astype(np.float32)
    want = np.asarray(jprojection.quat_to_rotmat(q))
    got = tprojection.quat_to_rotmat(torch.tensor(q))
    assert got.shape == (64, 3, 3)
    np.testing.assert_allclose(np_(got), want, **TOL)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    r = np_(tprojection.quat_to_rotmat(torch.tensor(qn)))
    np.testing.assert_allclose(r @ r.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), r.shape),
                               atol=1e-5)


def test_covariance3d_matches_jax():
    rng = np.random.default_rng(9)
    q = rng.normal(0, 1, (64, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-3, 0, (64, 3))).astype(np.float32)
    want = np.asarray(jprojection.covariance3d(q, scales))
    got = np_(tprojection.covariance3d(torch.tensor(q), torch.tensor(scales)))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, got.transpose(0, 2, 1), rtol=1e-6,
                               atol=1e-6)


def test_projection_detaches_like_jax():
    """Gradients stop where the reference's stop_gradients are: depth and
    the tile-range inputs always; the SH colour under detach_color."""
    params = numpy_scene(40, seed=5)
    _, ts = both_scenes(params, sh_deg=1)
    _, tc = both_cameras(64, 48)
    p = {k: v.clone().requires_grad_(True) for k, v in ts.params().items()}
    attrs, aux = project_gaussians(p, ts.alive, tc, 64, 48, 1,
                                   torch_settings())
    assert not aux.depth.requires_grad
    assert attrs.center_px.requires_grad and attrs.color.requires_grad
    attrs.color.sum().backward()
    assert p["sh"].grad is not None and p["sh"].grad.abs().sum() > 0

    p = {k: v.clone().requires_grad_(True) for k, v in ts.params().items()}
    attrs, _ = project_gaussians(p, ts.alive, tc, 64, 48, 1,
                                 torch_settings(), detach_color=True)
    assert not attrs.color.requires_grad


def test_dead_slots_are_culled():
    params = numpy_scene(30, seed=6)
    _, ts = both_scenes(params)
    ts = ts.pad_to(40)
    _, tc = both_cameras(64, 48)
    _, aux = project_gaussians(ts.params(), ts.alive, tc, 64, 48, 0,
                               torch_settings())
    assert not aux.visible[30:].any() and not aux.num_tiles[30:].any()


def test_ply_roundtrip_with_jax(tmp_path):
    """JAX save_ply -> port load_ply gives identical arrays (full 3DGS
    PLY, sh_deg 3), and port save_ply -> JAX load_ply back."""
    params = numpy_scene(25, seed=7)
    js, _ = both_scenes(params, sh_deg=3)
    path = tmp_path / "scene.ply"
    assert jply.save_ply(js, path) == 25
    ts = tply.load_point_cloud(path, CPU)
    assert ts.sh_deg == 3
    for k, v in js.params().items():
        np.testing.assert_array_equal(np_(ts.params()[k]), np.asarray(v),
                                      err_msg=k)
    back = tmp_path / "back.ply"
    assert tply.save_ply(ts, back) == 25
    js2 = jply.load_point_cloud(str(back))
    for k, v in js.params().items():
        np.testing.assert_array_equal(np.asarray(js2.params()[k]),
                                      np.asarray(v), err_msg=k)


def test_ply_point_cloud_and_points3d_match_jax(tmp_path):
    rng = np.random.default_rng(8)
    n = 12
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    # 'normal' PLY with uchar colours
    dtype = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                      ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    verts = np.zeros(n, dtype)
    verts["x"], verts["y"], verts["z"] = xyz.T
    verts["red"], verts["green"], verts["blue"] = rgb.T
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n"
              + "".join(f"property {t} {p}\n" for p, t in (
                  ("x", "float"), ("y", "float"), ("z", "float"),
                  ("red", "uchar"), ("green", "uchar"), ("blue", "uchar")))
              + "end_header\n").encode()
    data = header + verts.tobytes()
    # COLMAP points3D.bin with variable-length tracks
    import struct
    blob = struct.pack("<Q", n)
    for i in range(n):
        blob += struct.pack("<Q3d3Bd", i, *map(float, xyz[i]), *rgb[i], 0.5)
        blob += struct.pack("<Q", i % 3) + b"\0" * (8 * (i % 3))
    for raw in (data, blob):
        js = jply.load_point_cloud(raw)
        ts = tply.load_point_cloud(raw, CPU)
        for k, v in js.params().items():
            np.testing.assert_allclose(np_(ts.params()[k]), np.asarray(v),
                                       rtol=0, atol=0, err_msg=k)
    with pytest.raises(ValueError):
        tply.load_ply(b"ply\nformat ascii 1.0\nend_header\n", CPU)


def test_fly_camera_copy_matches_jax():
    from webdgs_tpu.render.camera_control import FlyCamera as JFly
    from webdgs_tpu_torch.render.camera_control import FlyCamera as TFly
    a, b = JFly(position=(0, 0, 0)), TFly(position=(0, 0, 0))
    for cam in (a, b):
        cam.move(0.5, forward=True, left=True)
        cam.drag(math.pi / 2 / 0.003, 40.0)
        cam.roll(0.3, right=True)
        cam.wheel(-200.0)
    np.testing.assert_array_equal(a.position, b.position)
    np.testing.assert_array_equal(a.rotation, b.rotation)
