"""Point-cloud loading and export: 3DGS PLY (binary little-endian) and
COLMAP points3D.bin (counterpart of webdgs_tpu/io/ply.py:48-215).

numpy parsing, the same semantics as the reference loaders:
  * 'full' PLY (has rot_0 and scale_0): sh_deg = sqrt(n_rest/3 + 1) - 1;
    SH order f_dc_{rgb} then f_rest_{channel * n_per_channel + i};
    opacity, scales and rotations kept raw (logit, log, wxyz quaternion);
  * 'normal' PLY: colour (red/green/blue or diffuse_*) -> SH DC via
    (c - 0.5)/C0, with the point-cloud defaults of ``scene_from_arrays``;
  * uchar properties are divided by 255 on read;
  * COLMAP points3D.bin: xyz f64 + rgb u8 with variable-length tracks.
Loaders build the port's scene on an explicit device.
"""

from __future__ import annotations

import io
import os
import struct

import numpy as np
import torch

from webdgs_tpu_torch.core.scene import GaussianScene, scene_from_arrays

_PLY_TYPES = {
    "float": "<f4", "float32": "<f4",
    "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1",
    "char": "i1", "int8": "i1",
    "ushort": "<u2", "uint16": "<u2",
    "short": "<i2", "int16": "<i2",
    "uint": "<u4", "uint32": "<u4",
    "int": "<i4", "int32": "<i4",
}


def _decode_header(data: bytes):
    """Vertex count, ordered (name, type) property list and data offset."""
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError("not a PLY file: no end_header")
    header = data[:end].decode("ascii", errors="replace")
    offset = end + len("end_header") + 1  # consume the newline

    vertex_count = 0
    props: list[tuple[str, str]] = []
    in_vertex = False
    for line in header.splitlines():
        line = line.strip()
        if line.startswith("format") and "binary_little_endian" not in line:
            raise ValueError(f"unsupported PLY format: {line}")
        if line.startswith("element"):
            parts = line.split()
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                vertex_count = int(parts[2])
        elif line.startswith("property") and in_vertex:
            _, ptype, pname = line.split()[:3]
            props.append((pname, ptype))
    return vertex_count, props, offset


def nsh_coeffs(sh_deg: int) -> int:
    return (sh_deg + 1) ** 2


def load_ply(data: bytes, device: str | torch.device) -> GaussianScene:
    count, props, offset = _decode_header(data)
    dtype = np.dtype([(name, _PLY_TYPES[t]) for name, t in props])
    verts = np.frombuffer(data, dtype=dtype, count=count, offset=offset)
    names = {name for name, _ in props}

    def col(name):
        v = verts[name].astype(np.float32)
        if verts.dtype[name] == np.uint8:
            v = v / 255.0
        return v

    means = np.stack([col("x"), col("y"), col("z")], axis=1)
    if "rot_0" in names and "scale_0" in names:
        n_rest = sum(1 for n in names if n.startswith("f_rest_"))
        n_per = n_rest // 3
        sh_deg = int(round(np.sqrt(n_per + 1))) - 1
        sh = np.zeros((count, 16, 3), dtype=np.float32)
        for j in range(3):
            sh[:, 0, j] = col(f"f_dc_{j}")
        for i in range(nsh_coeffs(sh_deg) - 1):
            for j in range(3):
                sh[:, i + 1, j] = col(f"f_rest_{j * n_per + i}")
        return scene_from_arrays(
            means,
            quats=np.stack([col(f"rot_{i}") for i in range(4)], axis=1),
            log_scales=np.stack([col(f"scale_{i}") for i in range(3)],
                                axis=1),
            opacity_logits=col("opacity"),
            sh=sh, sh_deg=sh_deg, device=device)

    if "red" in names:
        colors = np.stack([col("red"), col("green"), col("blue")], axis=1)
    elif "diffuse_red" in names:
        colors = np.stack([col("diffuse_red"), col("diffuse_green"),
                           col("diffuse_blue")], axis=1)
    else:
        colors = np.full((count, 3), 0.5, dtype=np.float32)
    return scene_from_arrays(means, colors=colors, sh_deg=0, device=device)


def load_points3d_bin(data: bytes,
                      device: str | torch.device) -> GaussianScene:
    """COLMAP points3D.bin: per point, id u64, xyz 3 x f64, rgb 3 x u8,
    error f64, track length u64 and 8 bytes per track element."""
    view = memoryview(data)
    (num_points,) = struct.unpack_from("<Q", view, 0)
    offset = 8
    xyz = np.empty((num_points, 3), dtype=np.float32)
    rgb = np.empty((num_points, 3), dtype=np.float32)
    for i in range(num_points):
        xyz[i] = struct.unpack_from("<3d", view, offset + 8)
        r, g, b = struct.unpack_from("<3B", view, offset + 32)
        (track_len,) = struct.unpack_from("<Q", view, offset + 43)
        rgb[i] = (r / 255.0, g / 255.0, b / 255.0)
        offset += 51 + track_len * 8
    return scene_from_arrays(xyz, colors=rgb, sh_deg=0, device=device)


def load_point_cloud(path_or_bytes,
                     device: str | torch.device) -> GaussianScene:
    """Dispatch on the 'ply' magic: PLY, else COLMAP points3D.bin."""
    if isinstance(path_or_bytes, (str, os.PathLike)):
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    else:
        data = bytes(path_or_bytes)
    if data[:3] == b"ply":
        return load_ply(data, device)
    return load_points3d_bin(data, device)


def save_ply(scene: GaussianScene, path: str | os.PathLike,
             only_alive: bool = True) -> int:
    """Export to the standard 3DGS PLY layout (round-trips with
    :func:`load_ply`).  Returns the number of points written."""

    def host(t):
        return t.detach().cpu().numpy()

    means, quats = host(scene.means), host(scene.quats)
    log_scales, op = host(scene.log_scales), host(scene.opacity_logits)
    sh, alive = host(scene.sh), host(scene.alive)
    if only_alive:
        means, quats, log_scales = means[alive], quats[alive], \
            log_scales[alive]
        op, sh = op[alive], sh[alive]
    n = means.shape[0]
    n_per = nsh_coeffs(scene.sh_deg) - 1

    fields = (["x", "y", "z", "nx", "ny", "nz"]
              + [f"f_dc_{j}" for j in range(3)]
              + [f"f_rest_{i}" for i in range(3 * n_per)]
              + ["opacity"]
              + [f"scale_{i}" for i in range(3)]
              + [f"rot_{i}" for i in range(4)])
    out = np.zeros(n, dtype=np.dtype([(f, "<f4") for f in fields]))
    out["x"], out["y"], out["z"] = means.T
    for j in range(3):
        out[f"f_dc_{j}"] = sh[:, 0, j]
    for i in range(n_per):
        for j in range(3):
            out[f"f_rest_{j * n_per + i}"] = sh[:, i + 1, j]
    out["opacity"] = op
    for i in range(3):
        out[f"scale_{i}"] = log_scales[:, i]
    for i in range(4):
        out[f"rot_{i}"] = quats[:, i]

    buf = io.BytesIO()
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {f}" for f in fields]
    header += ["end_header", ""]
    buf.write("\n".join(header).encode("ascii"))
    buf.write(out.tobytes())
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    return n
