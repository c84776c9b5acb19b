"""Plain reference of 3D Gaussian splatting as the benchmarked system
defines it: projection, depth-sorted tile lists, alpha compositing, the
loss and its pixel cotangent, the rasterizer's gradient, Adam, and the
densify event's importance counts and decisions.

Plain ``torch`` in float32, computed in blocks of tiles so that it fits
beside nothing else on the card.  It imports nothing of the benchmarked
package: every constant it needs comes from the configuration file
(``render``, ``trainer``), and its inputs are the scene, cameras and
targets that the benchmark made from the seed.

Semantics held here (the system's, written out independently):
  * view transform x_v = R (x - C); a Y-flipped projection with z in
    [0, 1]; NDC cull at +-1.2 in x and y;
  * Sigma = R diag(s^2) R^T from an unnormalised quaternion; EWA 2D
    covariance with the 1.3 * half-fov clamp and +0.3 dilation;
  * opacity-aware extents sqrt(2 ln(128 op) * conic / -disc), capped at
    ``max_splat_radius_px``; a 2 px tile margin; at most
    ``max_tiles_per_gaussian`` tiles;
  * entries ordered per tile by the top 16 bits of the order-preserving
    image of the float depth, ties by Gaussian index;
  * alpha = min(alpha_max, op exp(-q/2)) inside the extent box, dropped
    under alpha_min; an entry counts while the exclusive transmittance is
    at least ``t_threshold``;
  * dL/dpixel = l1 sign(d) + l2 d + dssim (1 - ssim)/2 d (5x5 box SSIM,
    edge-replicated), not a derivative of the loss;
  * with DC-only SH, dL/dcolor is routed raw into the DC coefficient, and
    a capped splat's log-scale gradient is clamped at 0 from below;
  * Adam without bias correction, per-group rates, frozen where a
    Gaussian touches no tile, the quaternion renormalised;
  * the densify event's decisions, compaction and transforms
    (:func:`densify`), at the capacity of :func:`grown_capacity`.

``Prec("tf32")`` is the control: every product of the projection and of
the SH colour takes its inputs rounded to TF32 (10 mantissa bits), as a
tensor core would, and accumulates in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
PARAMS = ("means", "quats", "log_scales", "opacity_logits", "sh")

# (tiles x pixels x entries) elements of one temporary, without and with
# the autograd graph
_BLOCK = 1 << 25
_GRAD_BLOCK = 1 << 23
# entries per chunk of a tile's list
_K = 256
# the tile the reference blocks its work in; the image does not depend on
# it (the extent box, not the tile rect, decides which pixels a splat
# reaches)
TILE = {"tile_w": 32, "tile_h": 16}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest TF32 value (10 mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class Prec:
    """How the reference multiplies: ``fp32`` or the ``tf32`` control."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "tf32"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def r(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp32":
            return x
        # the rounding passes the gradient through unchanged
        return x + (tf32_round(x.detach()) - x.detach())

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.r(a), self.r(b))


def _float32_matmul() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ----------------------------------------------------------------------
# cameras

def camera(position, rotation, width: int, height: int, fov_y: float,
           device) -> dict:
    """A camera from its centre, world-to-camera rotation (3, 3) and
    vertical field of view (radians), at a viewport of width x height."""
    import numpy as np
    focal = 0.5 * height / math.tan(0.5 * fov_y)
    fov_x = 2.0 * math.atan(width / (2.0 * focal))
    znear, zfar = 0.01, 100.0
    proj = np.zeros((4, 4))
    proj[0, 0] = 1.0 / math.tan(0.5 * fov_x)
    proj[1, 1] = -1.0 / math.tan(0.5 * fov_y)
    proj[2, 2] = zfar / (zfar - znear)
    proj[2, 3] = -(zfar * znear) / (zfar - znear)
    proj[3, 2] = 1.0
    # the pose in float32, as a camera record holds it
    rot = np.asarray(rotation, np.float32)
    pos = np.asarray(position, np.float32)
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = rot
    view[:3, 3] = -rot @ pos
    f32 = dict(dtype=torch.float32, device=device)
    return {"view": torch.tensor(view, **f32),
            "proj": torch.tensor(proj, **f32),
            "pos": torch.tensor(pos, **f32), "focal": focal,
            "width": int(width), "height": int(height)}


# ----------------------------------------------------------------------
# projection

def _rotmat(q: torch.Tensor) -> torch.Tensor:
    r, x, y, z = q.unbind(-1)
    rows = ((1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
             2 * (x * z + r * y)),
            (2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - r * x)),
            (2 * (x * z - r * y), 2 * (y * z + r * x),
             1 - 2 * (x * x + y * y)))
    return torch.stack([torch.stack(row, -1) for row in rows], -2)


def sh_basis(d: torch.Tensor, k: int) -> torch.Tensor:
    """The first ``k`` real SH basis functions at unit directions (N, 3)."""
    x, y, z = d.unbind(-1)
    out = [torch.full_like(x, SH_C0)]
    if k > 1:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if k > 4:
        xx, yy, zz = x * x, y * y, z * z
        out += [SH_C2[0] * x * y, SH_C2[1] * y * z,
                SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * x * z,
                SH_C2[4] * (xx - yy)]
    if k > 9:
        out += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
                SH_C3[2] * y * (4 * zz - xx - yy),
                SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                SH_C3[6] * x * (xx - 3 * yy)]
    return torch.stack(out[:k], -1)


def project(p: dict, alive: torch.Tensor, cam: dict, sh_deg: int, rs: dict,
            prec: Prec, color_grad: bool) -> tuple[dict, dict]:
    """Per-Gaussian screen-space splats: (attrs, aux).  ``attrs`` (center,
    conic, color, opacity, extent) carry the autograd graph; ``aux``
    (depth, tile rect, visible, capped) does not."""
    means, quats = p["means"], p["quats"]
    w_img, h_img = cam["width"], cam["height"]
    fx = fy = cam["focal"]
    view, proj = cam["view"], cam["proj"]
    tw, th = rs["tile_w"], rs["tile_h"]

    # view coordinates as sums of products in the order x, y, z, then the
    # translation: the depth key keeps 16 bits of z, so a one-ulp change
    # from another summation order would move a splat across a bucket and
    # reorder it against its neighbours
    r = prec.r
    pv = torch.stack([r(view[i, 0]) * r(means[:, 0])
                      + r(view[i, 1]) * r(means[:, 1])
                      + r(view[i, 2]) * r(means[:, 2]) + view[i, 3] * 1.0
                      for i in range(3)] + [torch.ones_like(means[:, 0])],
                     -1)
    clip = prec.mm(pv, proj.T)
    w = clip[:, 3]
    w_ok = w != 0.0
    ndc = clip[:, :3] / torch.where(w_ok, w, 1.0)[:, None]
    in_frustum = ((ndc[:, 0].abs() <= 1.2) & (ndc[:, 1].abs() <= 1.2)
                  & (ndc[:, 2] >= 0.0) & (ndc[:, 2] <= 1.0) & w_ok & alive)

    gs2 = float(rs["gaussian_scaling"]) ** 2
    s2 = gs2 * torch.exp(2.0 * p["log_scales"])
    rot = _rotmat(quats)
    sigma = prec.mm(rot * s2[:, None, :], rot.transpose(1, 2))

    tz = torch.where(in_frustum, pv[:, 2], 1.0)
    lim_x = 1.3 * (0.5 * w_img) / fx
    lim_y = 1.3 * (0.5 * h_img) / fy
    tx = torch.clamp(pv[:, 0] / tz, -lim_x, lim_x) * tz
    ty = torch.clamp(pv[:, 1] / tz, -lim_y, lim_y) * tz
    zero = torch.zeros_like(tz)
    jac = torch.stack([
        torch.stack([fx / tz, zero, -fx * tx / (tz * tz)], -1),
        torch.stack([zero, fy / tz, -fy * ty / (tz * tz)], -1)], -2)
    a = prec.mm(jac, view[:3, :3])
    cov = prec.mm(prec.mm(a, sigma), a.transpose(1, 2))
    ca_, cb_, cc_ = cov[:, 0, 0] + 0.3, cov[:, 0, 1], cov[:, 1, 1] + 0.3

    det = ca_ * cc_ - cb_ * cb_
    det_ok = det > 0.0
    det = torch.where(det_ok, det, 1.0)
    conic = torch.stack([cc_ / det, -cb_ / det, ca_ / det], -1)
    disc = conic[:, 1] ** 2 - conic[:, 0] * conic[:, 2]
    ellipse_ok = (conic[:, 0] > 0) & (conic[:, 2] > 0) & (disc < 0)

    opacity = torch.sigmoid(p["opacity_logits"])
    t_pow = 2.0 * torch.log(torch.clamp(opacity * 128.0, min=1e-12))
    valid = in_frustum & det_ok & ellipse_ok & (t_pow > 0)
    nd = torch.where(valid, -disc, 1.0)
    tp = torch.where(valid, t_pow, 1.0)
    ext = torch.stack([
        torch.sqrt(tp * torch.where(valid, conic[:, 2], 1.0) / nd),
        torch.sqrt(tp * torch.where(valid, conic[:, 0], 1.0) / nd)], -1)
    cap = rs["max_splat_radius_px"] if rs["max_splat_radius_px"] > 0 else 1e9
    capped = ext.amax(-1) >= cap
    ext = torch.clamp(ext, max=cap)

    center = torch.stack([(ndc[:, 0] * 0.5 + 0.5) * w_img,
                          (ndc[:, 1] * -0.5 + 0.5) * h_img], -1)

    with torch.no_grad():
        c, e = center.detach(), ext.detach()
        lo_raw, hi_raw = c - e - 2.0, c + e + 2.0
        vp = torch.tensor([w_img, h_img], dtype=torch.float32,
                          device=c.device)
        on_screen = (hi_raw >= 0).all(-1) & (lo_raw < vp).all(-1)
        lo = torch.clamp(lo_raw, min=0.0)
        hi = torch.minimum(hi_raw, vp - 1.0)
        box_ok = (hi >= lo).all(-1)

        def tile_of(v, size):
            return torch.clamp(v, -2.0 ** 30, 2.0 ** 30).to(torch.int64) // size

        ntx, nty = -(-w_img // tw), -(-h_img // th)
        t0 = torch.stack([tile_of(lo[:, 0], tw), tile_of(lo[:, 1], th)], -1)
        t1 = torch.stack([torch.clamp(tile_of(hi[:, 0], tw), max=ntx - 1),
                          torch.clamp(tile_of(hi[:, 1], th), max=nty - 1)],
                         -1)
        dims = t1 - t0 + 1
        n_tiles = dims[:, 0] * dims[:, 1]
        visible = (valid & on_screen & box_ok
                   & (n_tiles <= rs["max_tiles_per_gaussian"]))

    k = (1, 4, 9, 16)[sh_deg]
    rel = means - cam["pos"]
    dirs = rel / torch.sqrt(torch.clamp((rel * rel).sum(-1, keepdim=True),
                                        min=1e-24))
    sh = p["sh"][:, :k, :]
    if not color_grad:
        dirs, sh = dirs.detach(), sh.detach()
    col = prec.mm(sh_basis(dirs, k)[:, None, :], sh)[:, 0, :]
    color = torch.clamp(torch.clamp(col + 0.5, min=0.0), 0.0, 1.0)

    attrs = {"center": center, "conic": conic, "color": color,
             "opacity": opacity, "ext": ext}
    aux = {"depth": pv[:, 2].detach(), "visible": visible,
           "t0": t0, "dims": dims,
           "n_tiles": torch.where(visible, n_tiles, 0),
           "capped": capped.detach() & visible}
    return attrs, aux


# ----------------------------------------------------------------------
# tile lists

def _depth16(depth: torch.Tensor) -> torch.Tensor:
    bits = depth.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ordered = torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF,
                          bits ^ 0x80000000)
    return torch.clamp(ordered >> 16, max=0xFFFE)


def tile_lists(aux: dict, w_img: int, h_img: int, rs: dict) -> dict:
    """Every (Gaussian, tile) pair of the visible rects, ordered by tile,
    then by the 16-bit depth key, then by Gaussian index."""
    tw, th = rs["tile_w"], rs["tile_h"]
    ntx, nty = -(-w_img // tw), -(-h_img // th)
    dev = aux["depth"].device
    gid = torch.nonzero(aux["visible"]).squeeze(1)
    counts = aux["n_tiles"][gid]
    total = int(counts.sum())
    g = torch.repeat_interleave(gid, counts, output_size=total)
    first = torch.cumsum(counts, 0) - counts
    local = (torch.arange(total, device=dev)
             - torch.repeat_interleave(first, counts, output_size=total))
    dx = aux["dims"][g, 0]
    tile = ((aux["t0"][g, 1] + local // dx) * ntx
            + aux["t0"][g, 0] + local % dx)
    key = (tile << 16) | _depth16(aux["depth"])[g]
    key, order = torch.sort(key, stable=True)
    tile = key >> 16
    starts = torch.searchsorted(tile, torch.arange(ntx * nty + 1,
                                                   device=dev))
    return {"gauss": g[order], "starts": starts, "ntx": ntx, "nty": nty,
            "entries": total}


# ----------------------------------------------------------------------
# compositing

def _pixels(tiles: torch.Tensor, ntx: int, rs: dict):
    tw, th = rs["tile_w"], rs["tile_h"]
    pix = torch.arange(tw * th, device=tiles.device)
    px = ((tiles[:, None] % ntx) * tw + pix % tw).float() + 0.5
    py = ((tiles[:, None] // ntx) * th + pix // tw).float() + 0.5
    return px[..., None], py[..., None]  # (t, P, 1)


def _chunk(attrs: dict, lists: dict, tiles: torch.Tensor, c: int, k: int,
           px, py, rs: dict):
    """The chunk ``c`` of ``k`` entries of each tile: (alpha, in_box,
    color rows (t, K, 3), in_range (t, 1, K), gaussian ids (t, K))."""
    starts = lists["starts"]
    lane = torch.arange(k, device=tiles.device)
    slot = starts[tiles, None] + c * k + lane
    in_range = slot < starts[tiles + 1, None]
    g = lists["gauss"][torch.clamp(slot, max=max(lists["entries"] - 1, 0))]
    cen, con = attrs["center"][g], attrs["conic"][g]  # (t, K, 2|3)
    dx = px - cen[..., 0][:, None, :]
    dy = py - cen[..., 1][:, None, :]
    power = (con[..., 0][:, None, :] * dx * dx
             + 2.0 * con[..., 1][:, None, :] * dx * dy
             + con[..., 2][:, None, :] * dy * dy)
    alpha = torch.clamp(attrs["opacity"][g][:, None, :]
                        * torch.exp(-0.5 * power), max=rs["alpha_max"])
    ext = attrs["ext"][g]
    in_box = ((dx.abs() <= ext[..., 0][:, None, :])
              & (dy.abs() <= ext[..., 1][:, None, :])
              & in_range[:, None, :])
    return alpha, in_box, attrs["color"][g], g


def _walk(attrs, lists, tiles, rs, k, *, flags=None, pairs=False,
          chunks=None):
    """Composite the tiles ``tiles`` front to back; returns a dict with
    ``rgb`` (t, P, 3) and, on request, the pair counts, the importance
    votes or the chunks each tile needed."""
    px, py = _pixels(tiles, lists["ntx"], rs)
    t, p = px.shape[0], px.shape[1]
    dev = px.device
    cnt = lists["starts"][tiles + 1] - lists["starts"][tiles]
    n_chunks = (cnt + k - 1) // k
    if chunks is not None:
        n_chunks = torch.minimum(n_chunks, chunks)
    trans = torch.ones((t, p, 1), device=dev)
    rgb = torch.zeros((t, p, 3), device=dev)
    out = {}
    if pairs:
        run = torch.zeros((t, p, 1), device=dev)
        at_last = torch.zeros((t, p), device=dev)
        needed = torch.zeros((), dtype=torch.int64, device=dev)
    if flags is not None:
        votes = torch.zeros(attrs["opacity"].shape, device=dev)
    used = torch.zeros((t,), dtype=torch.int64, device=dev)
    thr = rs["t_threshold"]
    for c in range(int(n_chunks.max()) if t else 0):
        live = (c < n_chunks) & (trans.detach().amax((1, 2)) >= thr)
        if not bool(live.any()):
            break
        used = torch.where(live, c + 1, used)
        alpha, in_box, col, g = _chunk(attrs, lists, tiles, c, k, px, py, rs)
        keep = in_box & (alpha >= rs["alpha_min"]) & live[:, None, None]
        a = torch.where(keep, alpha, 0.0)
        incl = torch.cumprod(1.0 - a, 2)
        excl = trans * incl / (1.0 - a)
        on = keep & (excl.detach() >= thr)
        wgt = torch.where(on, a * excl, 0.0)
        rgb = rgb + torch.einsum("tpk,tkc->tpc", wgt, col)
        trans = trans * incl[..., -1:]
        if pairs:
            box = (in_box & live[:, None, None]).float()
            cum = torch.cumsum(box, 2) + run
            at_last = torch.maximum(
                at_last, torch.where(on, cum, 0.0).amax(2))
            run = cum[..., -1:]
            needed += on.any(1).sum()
        if flags is not None:
            hit = (on & (flags[:, :, None] > 0)).sum(1).float()  # (t, K)
            sel = torch.nonzero(hit > 0, as_tuple=True)
            votes.index_add_(0, g[sel], hit[sel])
    out["rgb"] = rgb
    out["chunks"] = used
    if pairs:
        out["pairs"] = at_last.sum()
        out["needed_entries"] = needed
    if flags is not None:
        out["votes"] = votes
    return out


def _to_image(tiles_rgb: torch.Tensor, lists: dict, w_img: int, h_img: int,
              rs: dict) -> torch.Tensor:
    tw, th = rs["tile_w"], rs["tile_h"]
    ntx, nty = lists["ntx"], lists["nty"]
    img = tiles_rgb.reshape(nty, ntx, th, tw, -1).permute(0, 2, 1, 3, 4)
    return img.reshape(nty * th, ntx * tw, -1)[:h_img, :w_img]


def _to_tiles(img: torch.Tensor, lists: dict, rs: dict) -> torch.Tensor:
    tw, th = rs["tile_w"], rs["tile_h"]
    ntx, nty = lists["ntx"], lists["nty"]
    h, w = img.shape[0], img.shape[1]
    img = F.pad(img.permute(2, 0, 1), (0, ntx * tw - w, 0, nty * th - h))
    img = img.reshape(-1, nty, th, ntx, tw).permute(1, 3, 2, 4, 0)
    return img.reshape(ntx * nty, th * tw, -1)


@torch.no_grad()
def composite(attrs: dict, lists: dict, w_img: int, h_img: int, rs: dict,
              *, pairs: bool = False, flags: torch.Tensor | None = None):
    """The image (H, W, 3), in blocks of tiles; ``pairs`` adds the (pixel,
    entry) pairs up to each pixel's last contributor that fall in the
    entry's extent box, and the entries that reach any pixel; ``flags``
    (H, W) adds each Gaussian's count of flagged pixels it reaches."""
    if any(rs["background"]):
        raise ValueError("the reference composites on a black background")
    attrs = {k: v.detach() for k, v in attrs.items()}
    n_t = lists["ntx"] * lists["nty"]
    dev = lists["starts"].device
    k = _K
    group = max(1, _BLOCK // (rs["tile_w"] * rs["tile_h"] * k))
    rgb = torch.zeros((n_t, rs["tile_w"] * rs["tile_h"], 3), device=dev)
    chunks = torch.zeros((n_t,), dtype=torch.int64, device=dev)
    tot = {"pairs": 0.0, "needed_entries": 0}
    votes = torch.zeros(attrs["opacity"].shape, device=dev)
    ftiles = None if flags is None else _to_tiles(flags[..., None], lists,
                                                  rs)[..., 0]
    for tiles in torch.arange(n_t, device=dev).split(group):
        r = _walk(attrs, lists, tiles, rs, k, pairs=pairs,
                  flags=None if ftiles is None else ftiles[tiles])
        rgb[tiles] = r["rgb"]
        chunks[tiles] = r["chunks"]
        if pairs:
            tot["pairs"] += float(r["pairs"])
            tot["needed_entries"] += int(r["needed_entries"])
        if flags is not None:
            votes += r["votes"]
    out = {"image": _to_image(rgb, lists, w_img, h_img, rs), "chunks": chunks}
    if pairs:
        out.update(tot)
    if flags is not None:
        out["votes"] = votes
    return out


def composite_vjp(attrs: dict, lists: dict, dpix: torch.Tensor,
                  chunks: torch.Tensor, rs: dict) -> dict:
    """d(sum(image * dpix))/d(attrs) by autograd, one block of tiles at a
    time; tiles are grouped by the chunks they needed in the forward
    pass."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in attrs.items()}
    n_t = lists["ntx"] * lists["nty"]
    dev = lists["starts"].device
    k = _K
    group = max(1, _GRAD_BLOCK // (rs["tile_w"] * rs["tile_h"] * k))
    dtiles = _to_tiles(dpix, lists, rs)
    order = torch.argsort(chunks, descending=True)
    order = order[chunks[order] > 0]
    for tiles in order.split(group):
        r = _walk(leaves, lists, tiles, rs, k, chunks=chunks[tiles])
        (r["rgb"] * dtiles[tiles]).sum().backward()
    return {k: (v.grad if v.grad is not None else torch.zeros_like(v))
            for k, v in leaves.items()}


def render(p: dict, alive: torch.Tensor, cam: dict, sh_deg: int, rs: dict,
           prec: Prec, *, pairs: bool = False) -> dict:
    """A forward frame: the image and, with ``pairs``, the work counts."""
    _float32_matmul()
    with torch.no_grad():
        attrs, aux = project(p, alive, cam, sh_deg, rs, prec, False)
        lists = tile_lists(aux, cam["width"], cam["height"], rs)
        out = composite(attrs, lists, cam["width"], cam["height"], rs,
                        pairs=pairs)
    out["alive"] = int(alive.sum())
    out["pixels"] = cam["width"] * cam["height"]
    out["tiles"] = lists["ntx"] * lists["nty"]
    return out


# ----------------------------------------------------------------------
# loss, gradient, Adam

def _box5(x: torch.Tensor) -> torch.Tensor:
    """5x5 mean with edge-replicated samples, (H, W, C)."""
    xp = F.pad(x.permute(2, 0, 1)[None], (2, 2, 2, 2), mode="replicate")
    return F.avg_pool2d(xp, 5, stride=1)[0].permute(1, 2, 0)


def loss_and_cotangent(pred: torch.Tensor, target: torch.Tensor,
                       loss_cfg: dict):
    """(loss, dL/dpixel) with the system's formulas."""
    d = pred - target
    mx, my = _box5(pred), _box5(target)
    sxx = _box5(pred * pred) - mx * mx
    syy = _box5(target * target) - my * my
    sxy = _box5(pred * target) - mx * my
    c1, c2 = loss_cfg["c1"], loss_cfg["c2"]
    ssim = ((2 * mx * my + c1) * (2 * sxy + c2)
            / ((mx * mx + my * my + c1) * (sxx + syy + c2)))
    dssim = (1.0 - ssim) * 0.5
    l1w, l2w, dw = (loss_cfg["lambda_l1"], loss_cfg["lambda_l2"],
                    loss_cfg["lambda_dssim"])
    loss = (l1w * d.abs().mean() + l2w * (d * d).mean()
            + dw * dssim.mean())
    dpix = l1w * torch.sign(d) + l2w * d + dw * dssim * d
    return float(loss), dpix


def gradients(p: dict, alive: torch.Tensor, cam: dict, target: torch.Tensor,
              sh_deg: int, cfg: dict, prec: Prec, fault: str | None = None):
    """(loss, per-parameter gradients, visible mask) of one step.
    ``fault`` plants a fault for the output check's calibration: ``half``
    leaves out the lower half of the frame (its cotangent zero, the loss
    the mean over the rest); ``alter`` doubles the opacity cotangent
    where the compositing's gradient produces it."""
    _float32_matmul()
    rs, adam = {**cfg["render"], **TILE}, cfg["trainer"]["adam"]
    full_sh = bool(adam["full_sh"])
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    attrs, aux = project(leaves, alive, cam, sh_deg, rs, prec, full_sh)
    lists = tile_lists(aux, cam["width"], cam["height"], rs)
    fwd = composite(attrs, lists, cam["width"], cam["height"], rs)
    loss, dpix = loss_and_cotangent(fwd["image"], target,
                                    cfg["trainer"]["loss"])
    if fault == "half":
        rows = cam["height"] // 2
        loss = loss_and_cotangent(fwd["image"][:rows], target[:rows],
                                  cfg["trainer"]["loss"])[0]
        dpix[rows:] = 0.0
    d_attrs = composite_vjp(attrs, lists, dpix, fwd["chunks"], rs)
    if fault == "alter":
        d_attrs["opacity"] = 2.0 * d_attrs["opacity"]
    names = [k for k in attrs if attrs[k].requires_grad]
    grads = torch.autograd.grad([attrs[k] for k in names],
                                [leaves[k] for k in PARAMS],
                                grad_outputs=[d_attrs[k] for k in names],
                                allow_unused=True)
    g = {k: torch.zeros_like(p[k]) if v is None else v
         for k, v in zip(PARAMS, grads)}
    if not full_sh:
        g["sh"] = torch.zeros_like(p["sh"])
        g["sh"][:, 0, :] = d_attrs["color"]
    g["log_scales"] = torch.where(aux["capped"][:, None],
                                  torch.clamp(g["log_scales"], min=0.0),
                                  g["log_scales"])
    return loss, g, aux["visible"]


def adam(p: dict, g: dict, state: dict, visible: torch.Tensor,
         hp: dict) -> tuple[dict, dict, dict]:
    """One Adam update; returns (params, state, the gradient as the
    optimizer takes it)."""
    lrs = {"means": hp["lr_pos"], "quats": hp["lr_rot"],
           "log_scales": hp["lr_scale"], "opacity_logits": hp["lr_opacity"],
           "sh": hp["lr_color"]}
    if hp["bias_correction"] or hp["lr_pos_final"] > 0:
        raise ValueError("the reference follows Adam without bias "
                         "correction or position-rate decay")
    b1, b2, eps = hp["beta1"], hp["beta2"], hp["epsilon"]
    new_p, new_s, taken = {}, {}, {}
    for k in PARAMS:
        gk = g[k]
        lr = torch.full_like(p[k][:1], lrs[k])
        if k == "sh":
            rest = 0.0 if not hp["full_sh"] else hp["sh_rest_lr_scale"]
            lr[:, 1:, :] *= rest
            if not hp["full_sh"]:
                gk = torch.cat([gk[:, :1], torch.zeros_like(gk[:, 1:])], 1)
        m, v = state[k]
        vis = visible.reshape((-1,) + (1,) * (gk.dim() - 1))
        m1 = b1 * m + (1 - b1) * gk
        v1 = b2 * v + (1 - b2) * gk * gk
        pk = p[k] - lr * m1 / (torch.sqrt(v1) + eps)
        if k == "quats":
            pk = pk / torch.sqrt(torch.clamp((pk * pk).sum(-1, keepdim=True),
                                             min=1e-24))
        new_p[k] = torch.where(vis, pk, p[k])
        new_s[k] = (torch.where(vis, m1, m), torch.where(vis, v1, v))
        taken[k] = torch.where(vis, gk, 0.0)
    return new_p, new_s, taken


def zero_state(p: dict) -> dict:
    return {k: (torch.zeros_like(v), torch.zeros_like(v))
            for k, v in p.items()}


# ----------------------------------------------------------------------
# densify event

def resize_targets(targets: torch.Tensor, mw: int, mh: int) -> torch.Tensor:
    """(V, H, W, 3) -> (V, mh, mw, 3), bilinear with antialiasing."""
    t = F.interpolate(targets.permute(0, 3, 1, 2), size=(mh, mw),
                      mode="bilinear", align_corners=False, antialias=True)
    return t.permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def importance(p: dict, alive: torch.Tensor, cams: list, targets,
               sh_deg: int, cfg: dict, prec: Prec,
               fault: str | None = None) -> torch.Tensor:
    """Per Gaussian, the flagged pixels it reaches, averaged over views;
    ``fault="alter"`` doubles the counts where they are produced."""
    _float32_matmul()
    rs, dcfg = {**cfg["render"], **TILE}, cfg["trainer"]["densify"]
    total = torch.zeros(alive.shape, device=alive.device)
    for cam, target in zip(cams, targets):
        attrs, aux = project(p, alive, cam, sh_deg, rs, prec, False)
        lists = tile_lists(aux, cam["width"], cam["height"], rs)
        pred = composite(attrs, lists, cam["width"], cam["height"],
                         rs)["image"]
        err = (pred - target).abs().mean(-1)
        lo, hi = err.min(), err.max()
        norm = torch.where(hi > lo, (err - lo) / torch.clamp(hi - lo,
                                                             min=1e-12), 0.0)
        flags = (norm > dcfg["metric_threshold"]).float()
        total += composite(attrs, lists, cam["width"], cam["height"], rs,
                           flags=flags)["votes"]
    if fault == "alter":
        total = 2.0 * total
    return total / len(cams)


KEEP, CLONE, SPLIT, PRUNE = 0, 1, 2, 3
OPACITY_MAX = 0.8
# the capacity grows in granules of this many slots, at most to
# ``max_buffer_bytes`` over this many bytes a slot
_GRANULE, _SLOT_BYTES = 4096, 96


def grown_capacity(alive: int, capacity: int, dcfg: dict) -> int:
    """The capacity an event runs at: 1.5x the alive points plus an event's
    growth, in granules, when that growth would not fit, up to the buffer
    budget."""
    needed = alive + dcfg["max_new_points_per_step"]
    budget = dcfg["max_buffer_bytes"] // _SLOT_BYTES
    if needed > capacity and capacity < budget:
        want = min(int(needed * 1.5), budget)
        new = max(-(-want // _GRANULE) * _GRANULE, _GRANULE)
        if new > capacity:
            return new
    return capacity


def _rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rows v rotated by the normalised quaternion rows q."""
    qn = q / torch.sqrt(torch.clamp((q * q).sum(-1, keepdim=True),
                                    min=1e-12))
    return (_rotmat(qn) @ v[..., None])[..., 0]


@torch.no_grad()
def densify(p: dict, state: dict, counts: torch.Tensor, dcfg: dict,
            capacity: int, noise_seed: int,
            fault: str | None = None) -> dict:
    """The event on ``n`` alive rows: each row is pruned (dropped, opacity
    under ``prune_opacity``), cloned or split (two rows, at least
    ``clone_threshold_count`` flagged pixels; split where the largest
    scale reaches ``split_scale_threshold``) or kept, in row order, the
    output capped at min(capacity, n + ``max_new_points_per_step``) rows
    (a clone or split cut to one row is kept).  A clone's second row moves
    by the rotated 0.25 sigma u, u ~ U(-1, 1)^3; a split's rows by -+ the
    rotated 0.5 sigma d, d ~ N(0, 1)^3, and divide the scale by 1.6, sigma
    from the log-scale clamped to [-10, 10]; every kept opacity is clamped
    to 0.8.  The noise is one row per slot of the capacity, u then d, from
    a generator on the device seeded ``noise_seed``.  Adam moments follow
    their row, zero for new rows, and the opacity's are zero everywhere.
    No output at all, or as many rows as before, leaves the state as it
    was.  ``fault`` plants one for the output check's calibration:
    ``clone_pick`` moves every densify decision to the next row,
    ``split_scale`` leaves a split's scale undivided.
    Returns the params, state, decisions (counts) and the output rows."""
    n = p["means"].shape[0]
    dev = p["means"].device
    prune = torch.sigmoid(p["opacity_logits"]) < dcfg["prune_opacity"]
    dens = counts >= dcfg["clone_threshold_count"]
    if fault == "clone_pick":
        dens = torch.roll(dens, 1)
    big = (torch.exp(p["log_scales"]).amax(-1)
           >= dcfg["split_scale_threshold"])
    action = torch.where(prune, PRUNE, torch.where(
        dens & big, SPLIT, torch.where(dens, CLONE, KEEP)))
    rows = torch.where(prune, 0, torch.where(dens, 2, 1))
    max_out = min(n + dcfg["max_new_points_per_step"], capacity)
    start = torch.cumsum(rows, 0) - rows
    rows = torch.minimum(torch.clamp(max_out - start, min=0), rows)
    action = torch.where((rows == 1) & ((action == CLONE)
                                        | (action == SPLIT)), KEEP, action)
    total = int(rows.sum())
    decided = {"cloned": int((action == CLONE).sum()),
               "split": int((action == SPLIT).sum()),
               "pruned": int((action == PRUNE).sum()), "out": total}
    if total in (0, n):
        return {"params": p, "state": state, "event": decided, "rows": n}

    gen = torch.Generator(device=dev)
    gen.manual_seed(noise_seed)
    u = torch.rand((capacity, 3), generator=gen, device=dev)[:n] * 2.0 - 1.0
    d = torch.randn((capacity, 3), generator=gen, device=dev)[:n]

    src = torch.repeat_interleave(torch.arange(n, device=dev), rows,
                                  output_size=total)
    first = torch.cumsum(rows, 0) - rows
    second = torch.arange(total, device=dev) - first[src] == 1
    act = action[src]
    child = (act == CLONE) & second
    split = act == SPLIT
    q = p["quats"][src]
    log_sigma = torch.clamp(p["log_scales"][src], -10.0, 10.0)
    sigma = torch.exp(log_sigma)
    means = p["means"][src]
    means = torch.where(child[:, None],
                        means + _rotate(q, 0.25 * sigma * u[src]), means)
    sign = torch.where(second, -1.0, 1.0)[:, None]
    means = torch.where(split[:, None], p["means"][src] + sign * _rotate(
        q, 0.5 * sigma * d[src]), means)
    div = 0.0 if fault == "split_scale" else math.log(1.6)
    log_scales = torch.where(split[:, None], log_sigma - div,
                             p["log_scales"][src])
    op = p["opacity_logits"][src]
    op_max = math.log(OPACITY_MAX / (1.0 - OPACITY_MAX))
    op = torch.where(torch.sigmoid(op) > OPACITY_MAX, op_max, op)
    out = {"means": means, "quats": q, "log_scales": log_scales,
           "opacity_logits": op, "sh": p["sh"][src]}
    new = child | split
    moved = {}
    for k, (m, v) in state.items():
        reset = new.reshape((-1,) + (1,) * (m.dim() - 1))
        if k == "opacity_logits":
            moved[k] = (torch.zeros_like(m[src]), torch.zeros_like(v[src]))
        else:
            moved[k] = (torch.where(reset, 0.0, m[src]),
                        torch.where(reset, 0.0, v[src]))
    return {"params": out, "state": moved, "event": decided, "rows": total}
