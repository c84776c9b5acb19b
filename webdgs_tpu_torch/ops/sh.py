"""Spherical-harmonics colour (counterpart of webdgs_tpu/ops/sh.py): the
same basis, Condon-Shortley phases and k-ascending float32 sum order as the
reference's ``eval_sh_color_rows``.  The projection takes the row form;
``sh_basis`` / ``eval_sh_color`` are the dense forms on (N, 3) directions
and (N, 16, 3) coefficients."""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

# number of coefficients for degrees 0..3
NUM_COEFFS = (1, 4, 9, 16)


def sh_basis(dirs: torch.Tensor) -> torch.Tensor:
    """The 16 real SH basis functions at unit directions (..., 3), stacked
    on a last axis of 16."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    return torch.stack(sh_basis_rows(x, y, z, 16), dim=-1)


def eval_sh_color(sh: torch.Tensor, dirs: torch.Tensor,
                  sh_deg: int) -> torch.Tensor:
    """SH -> RGB, (N, 3), degree-gated: ``sh`` (N, 16, 3), ``dirs`` (N, 3)
    unit vectors; adds 0.5 and clamps at 0 from below.  Sums over the
    coefficients in ascending order, as :func:`eval_sh_color_rows`."""
    if not 0 <= sh_deg <= 3:
        raise ValueError(f"unsupported sh_deg {sh_deg}")
    k = NUM_COEFFS[sh_deg]
    basis = sh_basis_rows(dirs[:, 0], dirs[:, 1], dirs[:, 2], k)
    acc = basis[0][:, None] * sh[:, 0, :]
    for kk in range(1, k):
        acc = acc + basis[kk][:, None] * sh[:, kk, :]
    return torch.clamp(acc + 0.5, min=0.0)


def sh_basis_rows(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                  k: int) -> tuple[torch.Tensor, ...]:
    """The first ``k`` SH basis functions as a tuple of (N,) rows."""
    out = [SH_C0 * torch.ones_like(x)]
    if k > 1:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if k > 4:
        xx, yy, zz = x * x, y * y, z * z
        out += [
            SH_C2[0] * (x * y),
            SH_C2[1] * (y * z),
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * (x * z),
            SH_C2[4] * (xx - yy),
        ]
    if k > 9:
        out += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * (x * y) * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return tuple(out[:k])


def eval_sh_color_rows(sh_planar: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor, z: torch.Tensor, sh_deg: int):
    """Three (N,) colour rows from planar (48, N) coefficients (row
    ``3*k + c`` is coefficient ``k``, channel ``c``, i.e.
    ``sh.reshape(N, 48).T``) and unit-direction rows; adds 0.5 and clamps
    at 0 from below."""
    if not 0 <= sh_deg <= 3:
        raise ValueError(f"unsupported sh_deg {sh_deg}")
    k = NUM_COEFFS[sh_deg]
    basis = sh_basis_rows(x, y, z, k)
    colors = []
    for c in range(3):
        acc = basis[0] * sh_planar[c]
        for kk in range(1, k):
            acc = acc + basis[kk] * sh_planar[3 * kk + c]
        colors.append(torch.clamp(acc + 0.5, min=0.0))
    return colors[0], colors[1], colors[2]
