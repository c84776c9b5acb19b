"""Camera metadata loaders: COLMAP images.bin / cameras.bin and the
3DGS-style cameras JSON (counterpart of webdgs_tpu/io/colmap.py, building
the port's ``CameraData``).

Byte-level and merge semantics follow src/utils/load-camera.ts:
  * images.bin (load-camera.ts:170-238): per image u32 id, f64 quaternion
    (w,x,y,z) and translation, u32 camera_id, a null-terminated name, and a
    skipped points2D block; the stored rotation is the world-to-camera
    matrix of the quaternion, and position = -R^T t (the camera center).
  * cameras.bin (load-camera.ts:241-288): models 0 (SIMPLE_PINHOLE) and
    1 (PINHOLE) only; anything else raises.
  * JSON (load-camera.ts:136-167): the rotation matrix is used as-is as the
    world-to-camera rotation.
  * merge: extrinsics records joined with intrinsics by camera_id
    (load-camera.ts:44-77).
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

from webdgs_tpu_torch.core.camera import CameraData


def quat_to_rotmat_wxyz(w: float, x: float, y: float, z: float) -> np.ndarray:
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0.0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ], dtype=np.float32)


def load_images_bin(data: bytes) -> list[CameraData]:
    view = memoryview(data)
    if len(data) < 8:
        return []
    (num,) = struct.unpack_from("<Q", view, 0)
    offset = 8
    out: list[CameraData] = []
    for _ in range(num):
        image_id, = struct.unpack_from("<I", view, offset)
        qw, qx, qy, qz, tx, ty, tz = struct.unpack_from(
            "<7d", view, offset + 4)
        camera_id, = struct.unpack_from("<I", view, offset + 60)
        offset += 64
        name_end = data.index(b"\x00", offset)
        name = data[offset:name_end].decode("utf-8", errors="replace")
        offset = name_end + 1
        (npts,) = struct.unpack_from("<Q", view, offset)
        offset += 8 + npts * 24

        r = quat_to_rotmat_wxyz(qw, qx, qy, qz)  # world -> camera
        t = np.array([tx, ty, tz], dtype=np.float32)
        center = -(r.T @ t)
        out.append(CameraData(id=image_id, camera_id=camera_id,
                              img_name=name, rotation=r, position=center))
    return out


def load_cameras_bin(data: bytes) -> list[CameraData]:
    view = memoryview(data)
    (num,) = struct.unpack_from("<Q", view, 0)
    offset = 8
    out: list[CameraData] = []
    for _ in range(num):
        camera_id, model_id = struct.unpack_from("<Ii", view, offset)
        w, h = struct.unpack_from("<2Q", view, offset + 8)
        offset += 24
        if model_id == 0:  # SIMPLE_PINHOLE
            f, cx, cy = struct.unpack_from("<3d", view, offset)
            offset += 24
            fx = fy = f
        elif model_id == 1:  # PINHOLE
            fx, fy, cx, cy = struct.unpack_from("<4d", view, offset)
            offset += 32
        else:
            raise ValueError(
                f"Unsupported COLMAP camera model ID: {model_id}")
        out.append(CameraData(id=camera_id, camera_id=camera_id,
                              width=int(w), height=int(h), fx=fx, fy=fy,
                              cx=cx, cy=cy))
    return out


def load_cameras_json(data: bytes) -> list[CameraData]:
    entries = json.loads(data.decode("utf-8"))
    if not isinstance(entries, list):
        entries = [entries]
    out = []
    for j in entries:
        r = np.asarray(j["rotation"], dtype=np.float32)
        out.append(CameraData(
            id=j.get("id", 0), img_name=j.get("img_name"),
            width=j.get("width"), height=j.get("height"),
            fx=j.get("fx"), fy=j.get("fy"),
            position=np.asarray(j["position"], dtype=np.float32),
            rotation=r,
        ))
    return out


def merge_extrinsics_intrinsics(images: list[CameraData],
                                cameras: list[CameraData]) -> list[CameraData]:
    """Join on camera_id (load-camera.ts:52-77)."""
    by_id = {c.id: c for c in cameras}
    merged = []
    for img in images:
        intr = by_id.get(img.camera_id)
        if intr is not None:
            merged.append(CameraData(
                id=img.id, camera_id=img.camera_id, img_name=img.img_name,
                position=img.position, rotation=img.rotation,
                width=intr.width, height=intr.height,
                fx=intr.fx, fy=intr.fy, cx=intr.cx, cy=intr.cy))
        else:
            merged.append(img)
    return merged


def load_cameras(paths) -> list[CameraData]:
    """File-set dispatch like the reference (load-camera.ts:25-111):
    a JSON wins; images.bin + cameras.bin are merged; a single .bin loads
    partially with a warning-equivalent (missing fields stay None)."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    paths = [str(p) for p in paths]

    def read(p):
        with open(p, "rb") as f:
            return f.read()

    json_p = next((p for p in paths if p.lower().endswith(".json")), None)
    images_p = next((p for p in paths if p.lower().endswith("images.bin")),
                    None)
    cameras_p = next((p for p in paths if p.lower().endswith("cameras.bin")),
                     None)

    if json_p:
        return load_cameras_json(read(json_p))
    if images_p and cameras_p:
        return merge_extrinsics_intrinsics(
            load_images_bin(read(images_p)), load_cameras_bin(read(cameras_p)))
    if images_p:
        return load_images_bin(read(images_p))
    if cameras_p:
        return load_cameras_bin(read(cameras_p))
    if paths:
        data = read(paths[0])
        head = data[:10].lstrip()
        if head[:1] in (b"{", b"["):
            return load_cameras_json(data)
        raise ValueError(f"Unsupported camera file format: {paths[0]}")
    return []
