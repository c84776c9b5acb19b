"""Scenes, views and targets made from the seed, on the device.

A scene is a trained-looking splat cloud: positions uniform in a ball of
``scene.radius``, scales log-uniform with a small share of large splats,
random rotations, opacities from a logit range, SH colour with small
higher bands.  Views sit on a ring around the ball, at the distance where
the ball fills the vertical field of view, with seeded azimuths and
elevations; each target is a smooth random colour field.  Every
distribution is stated under ``assumed`` in the configuration file.  The
same seed gives the same scene, views and targets; two seeds give the same
sizes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SH_C0 = 0.28209479177387814


def _gen(seed: int, salt: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + salt) % (1 << 63))
    return g


def make_scene(cfg: dict, seed: int, device) -> dict:
    """The scene's parameters, (N, ...) float32 on ``device``, in a few
    large calls of one generator."""
    sc = cfg["scene"]
    n, radius = int(cfg["gaussians"]), float(sc["radius"])
    g = _gen(seed, 1, device)
    f32 = dict(dtype=torch.float32, device=device, generator=g)
    dirs = torch.randn((n, 3), **f32)
    dirs = dirs / dirs.norm(dim=1, keepdim=True).clamp(min=1e-12)
    means = dirs * (radius * torch.rand((n, 1), **f32) ** (1.0 / 3.0))
    quats = torch.randn((n, 4), **f32)
    quats = quats / quats.norm(dim=1, keepdim=True).clamp(min=1e-12)
    lo, hi = (math.log(radius * x) for x in sc["scale_range"])
    big_lo, big_hi = (math.log(radius * x) for x in sc["large_scale_range"])
    big = torch.rand((n, 1), **f32) < sc["large_share"]
    u = torch.rand((n, 3), **f32)
    log_scales = torch.where(big, big_lo + (big_hi - big_lo) * u,
                             lo + (hi - lo) * u)
    olo, ohi = sc["opacity_logit_range"]
    opacity_logits = olo + (ohi - olo) * torch.rand((n,), **f32)
    sh = torch.randn((n, 16, 3), **f32) * sc["sh_rest_std"]
    sh[:, 0, :] = (torch.rand((n, 3), **f32) - 0.5) / SH_C0
    return {"means": means, "quats": quats, "log_scales": log_scales,
            "opacity_logits": opacity_logits, "sh": sh}


def look_at(position: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World-to-camera rotation, +z forward, rows (right, up, forward)."""
    fwd = target - position
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
    right = right / np.linalg.norm(right)
    return np.stack([right, np.cross(fwd, right), fwd])


def view_distance(cfg: dict) -> float:
    """The ring's radius: the ball fills the vertical field of view."""
    return (float(cfg["scene"]["radius"]) * cfg["scene"]["distance_factor"]
            / math.sin(math.radians(cfg["fov_y_deg"]) / 2.0))


def ring_poses(cfg: dict, seed: int, count: int, salt: int = 2,
               ordered: bool = False) -> list[tuple[np.ndarray, np.ndarray]]:
    """``count`` camera poses (position, rotation) on the ring: seeded
    azimuths (or, ``ordered``, evenly spaced from a seeded start) and
    elevations in +-``elevation_deg``."""
    rng = np.random.default_rng([int(seed), salt])
    dist = view_distance(cfg)
    el_max = math.radians(cfg["scene"]["elevation_deg"])
    if ordered:
        az = rng.uniform(0, 2 * math.pi) + np.arange(count) * (
            2 * math.pi / count)
    else:
        az = rng.uniform(0, 2 * math.pi, count)
    el = rng.uniform(-el_max, el_max, count)
    poses = []
    for a, e in zip(az, el):
        pos = dist * np.array([math.cos(e) * math.sin(a), math.sin(e),
                               math.cos(e) * math.cos(a)])
        poses.append((pos, look_at(pos, np.zeros(3))))
    return poses


def make_targets(cfg: dict, seed: int, count: int, device,
                 index=None) -> torch.Tensor:
    """(len(index), H, W, 3) float32 smooth random colour fields in
    [0, 1]: the targets ``index`` (default all) of ``count`` views.  The
    coarse grids of all views are drawn in one call, so a target does not
    depend on which others are made."""
    w, h = cfg["width"], cfg["height"]
    gy, gx = cfg["scene"]["target_grid"]
    g = _gen(seed, 3, device)
    coarse = torch.rand((count, 3, gy, gx), dtype=torch.float32,
                        device=device, generator=g)
    index = list(range(count)) if index is None else list(index)
    out = torch.empty((len(index), h, w, 3), dtype=torch.float32,
                      device=device)
    for i in range(0, len(index), 16):
        sel = index[i:i + 16]
        fine = torch.nn.functional.interpolate(
            coarse[sel], size=(h, w), mode="bilinear", align_corners=True)
        out[i:i + len(sel)] = fine.permute(0, 2, 3, 1)
    return out
