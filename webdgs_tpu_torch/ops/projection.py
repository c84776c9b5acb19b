"""EWA projection: 3D Gaussians -> screen-space splats (counterpart of
webdgs_tpu/ops/projection.py:50-362).

Plain torch over (N,) rows, in the reference's operation order, and
differentiable by autograd.  Gradients are cut (``detach``) exactly where
the reference stops them: the tile-range inputs (projection.py:269-272),
the SH colour inputs under ``detach_color`` (:313-316) and the depth
(:329).  Semantics: NDC cull at +-1.2 in xy and [0, 1] in z; covariance
R S^2 R^T from an unnormalised quaternion; EWA 2D covariance with the
1.3*fov frustum clamp and +0.3 dilation; opacity-aware SnugBox extents
capped at ``max_splat_radius_px``; 2 px tile margin; at most
``max_tiles_per_gaussian`` tiles; SH colour clamped to [0, 1].  The
colour is a stage of its own (:func:`project_geometry`, then
:func:`sh_color`), so that the training step can take its VJP apart.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from webdgs_tpu_torch.config import RenderSettings
from webdgs_tpu_torch.core.camera import Camera
from webdgs_tpu_torch.ops.sh import eval_sh_color_rows

OPACITY_THRESHOLD = 128.0
TILE_MARGIN_PX = 2.0
NDC_CULL = 1.2
# pixel bounds are clamped into this range before the integer cast, so a
# far off-screen (already culled) splat never overflows int32
_PX_CLAMP = float(2 ** 30)


class SplatAttrs(NamedTuple):
    """Differentiable per-Gaussian screen-space attributes."""

    center_px: torch.Tensor  # (N, 2)
    conic: torch.Tensor  # (N, 3) (a, b, c) of the inverse 2D covariance
    color: torch.Tensor  # (N, 3) in [0, 1]
    opacity: torch.Tensor  # (N,) sigmoid-space
    extents: torch.Tensor  # (N, 2) capped SnugBox half-extents in px


class SplatAux(NamedTuple):
    """Non-differentiable binning metadata."""

    depth: torch.Tensor  # (N,) view-space z
    visible: torch.Tensor  # (N,) bool
    tile_min: torch.Tensor  # (N, 2) i32 (tx_min, ty_min)
    tile_dims: torch.Tensor  # (N, 2) i32 (tiles_x, tiles_y)
    num_tiles: torch.Tensor  # (N,) i32, 0 when culled
    radius_capped: torch.Tensor  # (N,) bool


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(N, 4) (w, x, y, z) -> (N, 3, 3); the standard form, no
    normalisation."""
    rows = _rotmat_rows(q.unbind(-1))
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _rotmat_rows(q):
    """Rotation matrix entries as nine (N,) rows from unnormalised quat
    rows."""
    r, x, y, z = q
    return (
        (1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)),
        (2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)),
        (2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)),
    )


def _cov3d_rows(q, s2):
    """Unique entries of Sigma = R diag(s^2) R^T as six (N,) rows."""
    m = _rotmat_rows(q)
    s0, s1, s2_ = s2

    def sig(i, j):
        return (m[i][0] * m[j][0] * s0 + m[i][1] * m[j][1] * s1
                + m[i][2] * m[j][2] * s2_)

    return sig(0, 0), sig(0, 1), sig(0, 2), sig(1, 1), sig(1, 2), sig(2, 2)


def covariance3d(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Sigma = R diag(s^2) R^T, (N, 3, 3)."""
    rot = quat_to_rotmat(quats)
    return torch.einsum("nij,nj,nkj->nik", rot, scales * scales, rot)


def project_gaussians(
    params: dict[str, torch.Tensor],
    alive: torch.Tensor,
    camera: Camera,
    img_w: int,
    img_h: int,
    sh_deg: int,
    settings: RenderSettings,
    detach_color: bool = False,
    gaussian_scaling: float | None = None,
) -> tuple[SplatAttrs, SplatAux]:
    """Project every Gaussian; runs on the device of ``params``.

    ``gaussian_scaling`` overrides ``settings.gaussian_scaling`` (the
    viewer's live scale knob); ``detach_color`` stops gradients through
    the SH colour evaluation, into the coefficients and the view
    direction."""
    attrs, aux, dirs = project_geometry(params, alive, camera, img_w, img_h,
                                        settings, gaussian_scaling)
    sh = params["sh"]
    if detach_color:
        sh = sh.detach()
        dirs = tuple(d.detach() for d in dirs)
    return attrs._replace(color=sh_color(sh, dirs, sh_deg)), aux


def sh_color(sh: torch.Tensor, dirs, sh_deg: int) -> torch.Tensor:
    """The SH colour stage: (N, 3) in [0, 1] from the (N, 16, 3)
    coefficients and the three (N,) unit-direction rows.  The 48 planar
    rows are taken by ``unbind`` of the (48, N) view, whose backward is
    one stack of whole rows (a transposed (N, 16, 3) gradient); a row read
    by indexing would have a backward that writes a whole (48, N) tensor
    per row, and a stack into (N, 48) columns writes at a stride of 48."""
    rows = sh.reshape(sh.shape[0], 48).T.unbind(0)
    col0, col1, col2 = eval_sh_color_rows(rows, *dirs, sh_deg)
    return torch.stack([torch.clamp(col0, 0.0, 1.0),
                        torch.clamp(col1, 0.0, 1.0),
                        torch.clamp(col2, 0.0, 1.0)], dim=-1)


def project_geometry(
    params: dict[str, torch.Tensor],
    alive: torch.Tensor,
    camera: Camera,
    img_w: int,
    img_h: int,
    settings: RenderSettings,
    gaussian_scaling: float | None = None,
) -> tuple[SplatAttrs, SplatAux, tuple]:
    """Everything of :func:`project_gaussians` but the colour: the
    attributes with ``color`` None, the aux, and the unit view-direction
    rows (dx, dy, dz) from the camera to each mean, which
    :func:`sh_color` takes.  The SH coefficients are not read."""
    means = params["means"]
    quats = params["quats"]
    log_scales = params["log_scales"]
    opacity_logits = params["opacity_logits"]
    dev = means.device

    view, proj = camera.view, camera.proj
    # (img_w, img_h) as float32, built on the device: an upload of host
    # values would wait for it
    viewport = (torch.arange(2, dtype=torch.float32, device=dev)
                * float(img_h - img_w) + float(img_w))
    focal_x, focal_y = camera.focal[0], camera.focal[1]

    m0, m1, m2 = means[:, 0], means[:, 1], means[:, 2]

    # --- view / clip transform ---
    def vdot(row):
        return row[0] * m0 + row[1] * m1 + row[2] * m2 + row[3] * 1.0

    t0 = vdot(view[0])
    t1 = vdot(view[1])
    tz = vdot(view[2])

    def pdot(row):
        return row[0] * t0 + row[1] * t1 + row[2] * tz + row[3]

    clip0, clip1, clip2, w = pdot(proj[0]), pdot(proj[1]), pdot(proj[2]), \
        pdot(proj[3])
    w_ok = w != 0.0
    w_safe = torch.where(w_ok, w, 1.0)
    ndc0 = clip0 / w_safe
    ndc1 = clip1 / w_safe
    ndc2 = clip2 / w_safe

    in_frustum = (
        (ndc0 >= -NDC_CULL) & (ndc0 <= NDC_CULL)
        & (ndc1 >= -NDC_CULL) & (ndc1 <= NDC_CULL)
        & (ndc2 >= 0.0) & (ndc2 <= 1.0)
        & w_ok & alive
    )

    # --- 3D covariance rows ---
    gsc = (settings.gaussian_scaling if gaussian_scaling is None
           else float(gaussian_scaling))
    gs2 = gsc * gsc
    s2 = (gs2 * torch.exp(2.0 * log_scales[:, 0]),
          gs2 * torch.exp(2.0 * log_scales[:, 1]),
          gs2 * torch.exp(2.0 * log_scales[:, 2]))
    c00, c01, c02, c11, c12, c22 = _cov3d_rows(
        (quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3]), s2)

    # --- EWA 2D covariance ---
    tz_safe = torch.where(in_frustum, tz, 1.0)
    lim_x = 1.3 * (viewport[0] * 0.5) / focal_x
    lim_y = 1.3 * (viewport[1] * 0.5) / focal_y
    tx = torch.clamp(t0 / tz_safe, -lim_x, lim_x) * tz_safe
    ty = torch.clamp(t1 / tz_safe, -lim_y, lim_y) * tz_safe

    inv_z = 1.0 / tz_safe
    # J (2x3 perspective Jacobian at the clamped point) composed with
    # W = view[:3, :3]: A = J @ W, two (N,) rows per column
    j00 = focal_x * inv_z
    j02 = -focal_x * tx * inv_z * inv_z
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * inv_z * inv_z
    a0 = (j00 * view[0, 0] + j02 * view[2, 0],
          j00 * view[0, 1] + j02 * view[2, 1],
          j00 * view[0, 2] + j02 * view[2, 2])
    a1 = (j11 * view[1, 0] + j12 * view[2, 0],
          j11 * view[1, 1] + j12 * view[2, 1],
          j11 * view[1, 2] + j12 * view[2, 2])

    def quad(u, v):
        """u^T Sigma v for symmetric Sigma rows."""
        return (c00 * u[0] * v[0] + c11 * u[1] * v[1] + c22 * u[2] * v[2]
                + c01 * (u[0] * v[1] + u[1] * v[0])
                + c02 * (u[0] * v[2] + u[2] * v[0])
                + c12 * (u[1] * v[2] + u[2] * v[1]))

    cov_a = quad(a0, a0) + 0.3
    cov_b = quad(a0, a1)
    cov_c = quad(a1, a1) + 0.3

    det = cov_a * cov_c - cov_b * cov_b
    det_ok = det > 0.0
    det_safe = torch.where(det_ok, det, 1.0)
    conic_a = cov_c / det_safe
    conic_b = -cov_b / det_safe
    conic_c = cov_a / det_safe
    disc = conic_b * conic_b - conic_a * conic_c
    ellipse_ok = (conic_a > 0.0) & (conic_c > 0.0) & (disc < 0.0)

    # --- opacity-aware extent ---
    opacity = torch.sigmoid(opacity_logits)
    t_pow = 2.0 * torch.log(torch.clamp(opacity * OPACITY_THRESHOLD,
                                        min=1e-12))
    opacity_ok = t_pow > 0.0

    valid_so_far = in_frustum & det_ok & ellipse_ok & opacity_ok
    neg_disc = torch.where(valid_so_far, -disc, 1.0)
    t_pos = torch.where(valid_so_far, t_pow, 1.0)
    x_extent = torch.sqrt(t_pos * torch.where(valid_so_far, conic_c, 1.0)
                          / neg_disc)
    y_extent = torch.sqrt(t_pos * torch.where(valid_so_far, conic_a, 1.0)
                          / neg_disc)

    cap = (settings.max_splat_radius_px if settings.max_splat_radius_px > 0
           else 1e9)
    radius_capped = torch.maximum(x_extent, y_extent) >= cap
    x_extent_cap = torch.clamp(x_extent, max=cap)
    y_extent_cap = torch.clamp(y_extent, max=cap)

    # --- pixel center and tile range ---
    cx = (ndc0 * 0.5 + 0.5) * viewport[0]
    cy = (ndc1 * -0.5 + 0.5) * viewport[1]

    ex_sg = x_extent_cap.detach()
    ey_sg = y_extent_cap.detach()
    cx_sg = cx.detach()
    cy_sg = cy.detach()
    bminx_raw = cx_sg - ex_sg - TILE_MARGIN_PX
    bminy_raw = cy_sg - ey_sg - TILE_MARGIN_PX
    bmaxx_raw = cx_sg + ex_sg + TILE_MARGIN_PX
    bmaxy_raw = cy_sg + ey_sg + TILE_MARGIN_PX
    on_screen = (
        (bmaxx_raw >= 0.0) & (bmaxy_raw >= 0.0)
        & (bminx_raw < viewport[0]) & (bminy_raw < viewport[1])
    )
    bminx = torch.clamp(bminx_raw, min=0.0)
    bminy = torch.clamp(bminy_raw, min=0.0)
    bmaxx = torch.minimum(bmaxx_raw, viewport[0] - 1.0)
    bmaxy = torch.minimum(bmaxy_raw, viewport[1] - 1.0)
    bbox_ok = (bmaxx >= bminx) & (bmaxy >= bminy)

    def to_i32(v):
        return torch.clamp(v, -_PX_CLAMP, _PX_CLAMP).to(torch.int32)

    num_tiles_x = -(-img_w // settings.tile_w)
    num_tiles_y = -(-img_h // settings.tile_h)
    tile_min_x = to_i32(bminx) // settings.tile_w
    tile_min_y = to_i32(bminy) // settings.tile_h
    tile_max_x = torch.clamp(to_i32(bmaxx) // settings.tile_w,
                             max=num_tiles_x - 1)
    tile_max_y = torch.clamp(to_i32(bmaxy) // settings.tile_h,
                             max=num_tiles_y - 1)
    tiles_x = tile_max_x - tile_min_x + 1
    tiles_y = tile_max_y - tile_min_y + 1
    num_tiles = tiles_x * tiles_y
    tiles_ok = num_tiles <= settings.max_tiles_per_gaussian

    visible = valid_so_far & on_screen & bbox_ok & tiles_ok
    num_tiles = torch.where(visible, num_tiles, 0).to(torch.int32)

    # --- the SH colour's view directions ---
    cam_pos = camera.cam_pos
    r0, r1, r2 = m0 - cam_pos[0], m1 - cam_pos[1], m2 - cam_pos[2]
    norm = torch.sqrt(torch.clamp(r0 * r0 + r1 * r1 + r2 * r2, min=1e-24))
    dirs = (r0 / norm, r1 / norm, r2 / norm)

    attrs = SplatAttrs(
        center_px=torch.stack([cx, cy], dim=-1),
        conic=torch.stack([conic_a, conic_b, conic_c], dim=-1),
        color=None,
        opacity=opacity,
        extents=torch.stack([x_extent_cap, y_extent_cap], dim=-1),
    )
    aux = SplatAux(
        depth=tz.detach(),
        visible=visible,
        tile_min=torch.stack([tile_min_x, tile_min_y], dim=-1),
        tile_dims=torch.stack([tiles_x, tiles_y], dim=-1),
        num_tiles=num_tiles,
        radius_capped=radius_capped & visible,
    )
    return attrs, aux, dirs


def restrict_aux_to_band(aux: SplatAux, row0: int | torch.Tensor,
                         rows: int) -> SplatAux:
    """Clip each Gaussian's tile rect to the tile rows [row0, row0 + rows)
    and rebase its tile ids to the band.

    Shared by the serial-band renderer and the tile-sharded render.
    ``row0`` is a Python int or a 0-d integer tensor on the device of
    ``aux``; either way nothing is read back or uploaded (max and min are
    written as clamps of differences, which take both)."""
    ty0 = aux.tile_min[:, 1]
    ty1 = ty0 + aux.tile_dims[:, 1] - 1
    rel0 = torch.clamp(ty0 - row0, min=0)  # max(ty0, row0) - row0
    rel1 = torch.clamp(ty1 - row0, max=rows - 1)  # min(ty1, last) - row0
    tiles_y = rel1 - rel0 + 1
    visible = aux.visible & (tiles_y > 0)
    tiles_y = torch.where(visible, tiles_y, 0)
    tiles_x = aux.tile_dims[:, 0]
    return SplatAux(
        depth=aux.depth, visible=visible,
        tile_min=torch.stack([aux.tile_min[:, 0], rel0], dim=-1),
        tile_dims=torch.stack([tiles_x, tiles_y], dim=-1),
        num_tiles=torch.where(visible, tiles_x * tiles_y, 0),
        radius_capped=aux.radius_capped)
