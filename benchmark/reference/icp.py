"""Reference multiscale projective RGB-D ICP (``src/icp/image_icp.rs``,
``multiscale.rs``, ``gaussnewton.rs``): point-to-plane plus photometric
Gauss-Newton over 3 levels, coarse to fine, returning each pair's
best-residual pose.

Two associations, as the configurations state them:

* ``"xla"``, exact: each source pixel meets the target at its projected
  pixel ``trunc(u + 0.5)``;
* ``"pallas_v4"``, banded: a source pixel finds its target only inside the
  band predicted from the current pose (one projected source centroid per
  16-row chunk and 128-column group), target normals and the reduction's
  stack rounded to bf16; the TPU engine's function, after the port's
  plain twin ``ops/icp_pallas_v3.py::plain_step`` and
  ``ops/icp_pallas_v4.py``.

The step runs on B pairs at once in plain tensor code; every reduction is
a float32 ``bmm`` or ``sum`` (TF32 off), the 6x6 solve is a Cholesky in
:attr:`Precision.solve`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import Precision
from benchmark.reference import se3

GRAD_H = 0.005
CHUNK = 16
HALO = 8
BAND = CHUNK + 2 * HALO
XLA_WINDOW = 32


def f32(x: float) -> float:
    return float(np.float32(x))


# -- the Gauss-Newton loop ---------------------------------------------------


def _solve(h, g, count, prec: Precision):
    low, _ = torch.linalg.cholesky_ex(h.to(prec.solve))
    update = torch.cholesky_solve(g.to(prec.solve).unsqueeze(-1), low).squeeze(-1)
    return torch.where((count > 0)[..., None], update, 0.0).to(torch.float32)


def gn_loop(step, rot, trans, level: dict, prec: Precision):
    """``step(rot, trans)`` -> ((H, g, sum w r^2, sum w) geometric, colour),
    batched over pairs. Per iteration: merge with weights w^2 / w, solve,
    update by the exponential; keep the pose after the update whose
    pre-update mean squared residual is the least so far (strict <)."""
    w1, w2 = f32(level["weight"]), f32(level["color_weight"])
    best_res = torch.full(rot.shape[:1], torch.inf, dtype=torch.float32, device=rot.device)
    best_rot, best_trans = rot, trans
    for _ in range(level["iterations"]):
        (hg, gg, sg, cg), (hc, gc, sc, cc) = step(rot, trans)
        h = hg * (w1 * w1) + hc * (w2 * w2)
        g = gg * w1 + gc * w2
        sq = sg * w1 + sc * w2
        count = cg + cc
        residual = sq / count
        new_rot, new_trans = se3.compose(se3.exp(_solve(h, g, count, prec)), (rot, trans))
        new_rot, new_trans = prec.round(new_rot), prec.round(new_trans)
        better = residual < best_res
        best_res = torch.where(better, residual, best_res)
        best_rot = torch.where(better[:, None, None], new_rot, best_rot)
        best_trans = torch.where(better[:, None], new_trans, best_trans)
        rot, trans = new_rot, new_trans
    return best_rot, best_trans


def _system(jac, residual, weight, prec: Precision):
    """(H, g, sum w r^2, sum w) from per-pixel Jacobians (B, N, 6)."""
    jac, residual = prec.round(jac), prec.round(residual)
    jw = jac * weight[..., None]
    return (torch.bmm(jw.transpose(1, 2), jac), torch.bmm(jw.transpose(1, 2), residual[..., None])[..., 0],
            torch.sum(weight * residual * residual, dim=-1), torch.sum(weight, dim=-1))


# -- the exact association ----------------------------------------------------


def _taps(intensity_map: torch.Tensor) -> list[torch.Tensor]:
    """The 3x3 neighbourhood of each pixel of (B, H+2, W+2) maps, (B, H*W) each."""
    b, h2, w2 = intensity_map.shape
    h, w = h2 - 2, w2 - 2
    return [intensity_map[:, dv : dv + h, du : du + w].reshape(b, h * w) for dv in range(3) for du in range(3)]


def _lerp2(t00, t01, t10, t11, fu, fv):
    a = t00 * (1.0 - fu) + t01 * fu
    b = t10 * (1.0 - fu) + t11 * fu
    return a * (1.0 - fv) + b * fv


def _bilinear_grad(t, u, v):
    """Bilinear value and the +0.005 numeric gradients from the 3x3 taps
    ``t`` (intensity_map.rs:150-210); the +h sample re-truncates."""
    u0, v0 = torch.trunc(u), torch.trunc(v)
    fu, fv = u - u0, v - v0
    value = _lerp2(t[0], t[1], t[3], t[4], fu, fv)
    uh_c = u + GRAD_H
    u0h = torch.trunc(uh_c)
    cu = u0h > u0
    uh = _lerp2(torch.where(cu, t[1], t[0]), torch.where(cu, t[2], t[1]), torch.where(cu, t[4], t[3]),
                torch.where(cu, t[5], t[4]), uh_c - u0h, fv)
    vh_c = v + GRAD_H
    v0h = torch.trunc(vh_c)
    cv = v0h > v0
    vh = _lerp2(torch.where(cv, t[3], t[0]), torch.where(cv, t[4], t[1]), torch.where(cv, t[6], t[3]),
                torch.where(cv, t[7], t[4]), fu, vh_c - v0h)
    return value, (uh - value) * (1.0 / GRAD_H), (vh - value) * (1.0 / GRAD_H)


def exact_step(rot, trans, src: dict, tgt: dict, level: dict, prec: Precision):
    """The exact GN accumulation of B pairs (image_icp.rs): ``src`` and
    ``tgt`` hold (B, N, ...) flattened level tensors and the target's
    (B, H+2, W+2) intensity map."""
    fx, fy, cx, cy = tgt["camera"]
    h, w = tgt["hw"]
    p = torch.bmm(src["points"], rot.transpose(1, 2)) + trans[:, None, :]
    z = p[..., 2]
    safe_z = torch.where(z == 0.0, 1e-12, z)
    u = p[..., 0] * fx / safe_z + cx
    v = p[..., 1] * fy / safe_z + cy
    u_int, v_int = torch.trunc(u + 0.5), torch.trunc(v + 0.5)
    inb = (u_int >= 0) & (u_int < w) & (v_int >= 0) & (v_int < h)
    ui = torch.nan_to_num(u_int, nan=0.0).clamp(0, w - 1).to(torch.int64)
    vi = torch.nan_to_num(v_int, nan=0.0).clamp(0, h - 1).to(torch.int64)
    idx = (vi * w + ui)[..., None]
    tp = torch.gather(tgt["points"], 1, idx.expand(-1, -1, 3))
    tn = torch.gather(tgt["normals"], 1, idx.expand(-1, -1, 3))
    tvalid = torch.gather(tgt["mask"], 1, idx[..., 0])
    valid = src["mask"] & inb & tvalid
    diff = tp - p
    dist_ok = torch.sum(diff * diff, dim=-1) <= f32(level["max_distance"] * level["max_distance"])
    angle = torch.abs(torch.arccos(torch.sum(p * tn, dim=-1)))
    rejected = angle >= f32(level["max_normal_angle"])  # a NaN angle passes
    w_geom = (valid & dist_ok & ~rejected).to(torch.float32)
    r_geom = torch.sum(diff * tn, dim=-1)
    geom = _system(torch.cat([tn, torch.cross(p, tn, dim=-1)], dim=-1), r_geom, w_geom, prec)

    u_s = torch.nan_to_num(torch.clamp(u, 0.0, float(w - 1)), nan=0.0)
    v_s = torch.nan_to_num(torch.clamp(v, 0.0, float(h - 1)), nan=0.0)
    base = torch.trunc(v_s).to(torch.int64) * w + torch.trunc(u_s).to(torch.int64)
    taps = [torch.gather(t, 1, base) for t in tgt["taps"]]
    value, du, dv = _bilinear_grad(taps, u_s, v_s)
    source_color = src["intensities"].to(torch.float32) * 0.003921569
    zz = safe_z * safe_z
    dfx = torch.full_like(safe_z, fx) / safe_z
    dcx = -p[..., 0] * fx / zz
    dfy = torch.full_like(safe_z, fy) / safe_z
    dcy = -p[..., 1] * fy / zz
    grad = torch.stack([du * dfx, dv * dfy, du * dcx + dv * dcy], dim=-1)
    r_color = source_color - value
    ok = r_color * r_color <= f32(level["max_color_distance"] * level["max_color_distance"])
    w_color = w_geom * ok.to(torch.float32)
    color = _system(torch.cat([grad, torch.cross(p, grad, dim=-1)], dim=-1), r_color, w_color, prec)
    return geom, color


def _flat(level: list[dict]) -> dict:
    """A level of B frames -> (B, N, ...) tensors."""
    b = len(level)
    h, w = level[0]["mask"].shape
    out = {k: torch.stack([lv[k] for lv in level]).reshape(b, h * w, -1)
           for k in ("points", "normals")}
    out["mask"] = torch.stack([lv["mask"] for lv in level]).reshape(b, h * w)
    out["intensities"] = torch.stack([lv["intensities"] for lv in level]).reshape(b, h * w)
    out["intensity_map"] = torch.stack([lv["intensity_map"] for lv in level])
    out["camera"], out["hw"] = level[0]["camera"], (h, w)
    return out


def _align_exact(rot, trans, sources, targets, level: dict, prec: Precision):
    src, tgt = _flat(sources), _flat(targets)
    tgt["taps"] = _taps(tgt["intensity_map"])
    return gn_loop(lambda r, t: exact_step(r, t, src, tgt, level, prec), rot, trans, level, prec)


# -- the banded association (pallas_v4) ---------------------------------------


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _band(hp: int) -> int:
    return min(BAND, hp)


def _masked_z(points, mask):
    return torch.where(mask, points[..., 2], 0.0)


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32, saturating, NaN to 0 (the card's conversion)."""
    return torch.nan_to_num(x.to(torch.float64), nan=0.0).clamp(-2.0**31, 2.0**31 - 1).to(torch.int32)


def _tile(channels: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, Hp, G*128) zero padded planes."""
    g, hp = _cdiv(w, 128), _cdiv(h, CHUNK) * CHUNK
    return torch.nn.functional.pad(channels, (0, g * 128 - w, 0, hp - h))


def _taps_u8(intensity_map: torch.Tensor, h: int, w: int) -> list[torch.Tensor]:
    """round(map * 255) at offsets (dv - 1, du - 1), the bordered map's first
    row and column repeated once more."""
    m = torch.cat([intensity_map[..., :1, :], intensity_map], dim=-2)
    m = torch.cat([m[..., :, :1], m], dim=-1)
    return [torch.round(m[..., dv : dv + h, du : du + w] * 255.0) for dv in range(3) for du in range(3)]


def _source_planes(points, mask, intensities, h, w) -> torch.Tensor:
    """(B, 2, Hp, G*128) [masked z, luma]."""
    return _tile(torch.stack([_masked_z(points, mask), intensities.to(torch.float32)], dim=1), h, w)


def _target_planes(points, normals, mask, intensity_map, h, w) -> torch.Tensor:
    """(B, 13, Hp, G*128) float32: z, bf16 normals, 9 u8 taps / 255."""
    bf = [normals[..., c].to(torch.bfloat16).to(torch.float32) for c in range(3)]
    taps = [t * f32(1.0 / 255.0) for t in _taps_u8(intensity_map, h, w)]
    return _tile(torch.stack([_masked_z(points, mask), *bf, *taps], dim=1), h, w)


def _pixel_grid(hp: int, wp: int, device):
    row = torch.arange(hp, device=device, dtype=torch.float32)[:, None]
    col = torch.arange(wp, device=device, dtype=torch.float32)[None, :]
    return row, col


def _rays(row, col, camera):
    fx, fy, cx, cy = camera
    return (col - f32(cx)) * f32(1.0 / fx), (row - f32(cy)) * f32(1.0 / fy)


def _rigid(rot, trans, x, y, z, lead: int):
    shape = (rot.shape[0],) + (1,) * lead
    r = rot.reshape(-1, 9)
    return [r[:, 3 * i].reshape(shape) * x + r[:, 3 * i + 1].reshape(shape) * y + r[:, 3 * i + 2].reshape(shape) * z
            + trans[:, i].reshape(shape) for i in range(3)]


def _group_sums(a: torch.Tensor) -> torch.Tensor:
    """(..., Hp, G*128) -> (..., nchunks, G): each (16, 128) block's sum in
    XLA's CPU order (16 x 32 windows added element by element in row-major
    order from 0, then the four window sums): the order the TPU engine's
    band prediction adds in, whose rounding its bases follow."""
    *lead, hp, wp = a.shape
    nchunks, g = hp // CHUNK, wp // 128
    nwin = 128 // XLA_WINDOW
    win = a.reshape(*lead, nchunks, CHUNK, g, nwin, XLA_WINDOW).movedim(-4, -2)
    win = win.reshape(*lead, nchunks, g, nwin, CHUNK * XLA_WINDOW)
    part = torch.zeros(win.shape[:-1], dtype=a.dtype, device=a.device)
    for e in range(win.shape[-1]):
        part = part + win[..., e]
    total = torch.zeros(part.shape[:-1], dtype=a.dtype, device=a.device)
    for e in range(nwin):
        total = total + part[..., e]
    return total


def _centroids(src_planes: torch.Tensor, camera):
    """Per (chunk, group): the masked mean source point, mean row and column, count."""
    z = src_planes[:, 0]
    row, col = _pixel_grid(z.shape[1], z.shape[2], z.device)
    dirx, diry = _rays(row, col, camera)
    m = (z > 0).to(torch.float32)
    sums = _group_sums(torch.stack([m, dirx * z, diry * z, z, row * m, col * m]))
    cnt = sums[0]
    safe = torch.clamp(cnt, min=1.0)
    return torch.stack([sums[1], sums[2], sums[3]], dim=-1) / safe[..., None], sums[4] / safe, sums[5] / safe, cnt


def _chunk_base(chunk_mean, hp):
    chunk0 = torch.arange(chunk_mean.shape[-1], dtype=torch.int32, device=chunk_mean.device) * CHUNK
    return torch.clamp(chunk0 + _to_int32(torch.round(chunk_mean)) - HALO, 0, max(hp - _band(hp), 0))


def _bases(rot, trans, centroids, camera, hp):
    """Band start per chunk, row and column displacement per (chunk, group),
    from the centroids projected under the current pose."""
    fx, fy, cx, cy = camera
    pbar, rowbar, colbar, cnt = centroids
    px, py, pz = _rigid(rot, trans, pbar[..., 0], pbar[..., 1], pbar[..., 2], 2)
    safe_z = torch.where(pz == 0.0, f32(1e-12), pz)
    u = px * f32(fx) / safe_z + f32(cx)
    v = py * f32(fy) / safe_z + f32(cy)
    dyf, dxf = v - rowbar, u - colbar
    have = cnt > 0
    dy_base = _to_int32(torch.where(have, torch.round(dyf), 0.0))
    dx_base = _to_int32(torch.where(have, torch.round(dxf), 0.0))
    chunk_mean = (torch.where(have, dyf, 0.0) * cnt).sum(dim=-1) / torch.clamp(cnt.sum(dim=-1), min=1.0)
    return _chunk_base(chunk_mean, hp), dy_base, dx_base


def banded_step(rot, trans, src_planes, tgt_planes, centroids, camera, hw, level: dict, prec: Precision):
    """The banded GN accumulation of B pairs on (B, C, Hp, G*128) planes."""
    fx, fy, cx, cy = camera
    h, w = hw
    radius = int(level["band_radius"])
    b, _, hp, wp = src_planes.shape
    g, nchunks = wp // 128, hp // CHUNK
    dev = src_planes.device
    cb, dyb, dxb = _bases(rot, trans, centroids, camera, hp)

    z, s_int = src_planes[:, 0], src_planes[:, 1]
    row, col = _pixel_grid(hp, wp, dev)
    dirx, diry = _rays(row, col, camera)
    px, py, pz = _rigid(rot, trans, dirx * z, diry * z, z, 2)
    safe_z = torch.where(pz == 0.0, f32(1e-12), pz)
    inv_z = torch.reciprocal(safe_z)
    u = px * f32(fx) * inv_z + f32(cx)
    v = py * f32(fy) * inv_z + f32(cy)
    u_int, v_int = torch.trunc(u + 0.5), torch.trunc(v + 0.5)
    inb = (u_int >= 0) & (u_int < w) & (v_int >= 0) & (v_int < h)
    ui = torch.nan_to_num(u_int, nan=0.0).clamp(0, w - 1).to(torch.int64)
    vi = torch.nan_to_num(v_int, nan=0.0).clamp(0, h - 1).to(torch.int64)

    # Band membership of each source pixel (row r = chunk * 16 + s, column in group j).
    rows = torch.arange(hp, device=dev)
    chunk, s_in = rows // CHUNK, rows % CHUNK
    jj = torch.arange(wp, device=dev) // 128
    cb_r = cb.to(torch.int64)[:, chunk]  # (B, Hp)
    rb0s = torch.clamp((torch.arange(nchunks, device=dev) * CHUNK)[None, :, None] + dyb.to(torch.int64) - radius
                       - cb.to(torch.int64)[:, :, None], 0, _band(hp) - (CHUNK + 2 * radius))  # (B, nchunks, G)
    n_dg = 2 if g > 1 else 1
    if g > 1:
        ga = torch.clamp(torch.div(dxb.to(torch.int64) + (torch.arange(g, device=dev) * 128)[None, None, :] - 64,
                                   128, rounding_mode="floor"), 0, g - n_dg)
    else:
        ga = torch.zeros_like(dyb, dtype=torch.int64)
    rel = vi - s_in[None, :, None] - cb_r[:, :, None] - rb0s[:, chunk][:, :, jj]
    lo = ga[:, chunk][:, :, jj] * 128
    matched = (rel >= 0) & (rel <= 2 * radius) & (ui >= lo) & (ui < lo + 128 * n_dg)
    flat = tgt_planes.reshape(b, tgt_planes.shape[1], -1)
    got = torch.gather(flat, 2, (vi * wp + ui).reshape(b, 1, -1).expand(-1, flat.shape[1], -1))
    got = torch.where(matched.reshape(b, 1, -1), got, 0.0).reshape(b, -1, hp, wp)
    tz, nx, ny, nz, taps = got[:, 0], got[:, 1], got[:, 2], got[:, 3], list(got[:, 4:13].unbind(1))

    uif, vif = ui.to(torch.float32), vi.to(torch.float32)
    tpx = (uif - f32(cx)) * tz * f32(1.0 / fx)
    tpy = (vif - f32(cy)) * tz * f32(1.0 / fy)
    dx_, dy_, dz_ = tpx - px, tpy - py, tz - pz
    dist_ok = dx_ * dx_ + dy_ * dy_ + dz_ * dz_ <= f32(level["max_distance"] * level["max_distance"])
    dot = px * nx + py * ny + pz * nz
    rejected = (dot <= f32(math.cos(f32(level["max_normal_angle"])))) & (dot >= -1.0)
    w_geom = ((z > 0) & inb & (tz > 0.0) & dist_ok & ~rejected).to(torch.float32)
    r_geom = dx_ * nx + dy_ * ny + dz_ * nz
    jg = (py * nz - pz * ny, pz * nx - px * nz, px * ny - py * nx)

    u_s, v_s = torch.clamp(u, 0.0, float(w - 1)), torch.clamp(v, 0.0, float(h - 1))
    u0, v0 = torch.trunc(u_s), torch.trunc(v_s)
    fu, fv = u_s - u0, v_s - v0
    # The taps sit around the associated pixel; the bilinear base is one left / up of it or on it.
    cu1 = torch.nan_to_num(u0, nan=-1.0).to(torch.int64) == ui
    cv1 = torch.nan_to_num(v0, nan=-1.0).to(torch.int64) == vi

    def rowsel(c):
        return torch.where(cv1, taps[3 + c], taps[c]), torch.where(cv1, taps[6 + c], taps[3 + c])

    r0c0, r1c0 = rowsel(0)
    r0c1, r1c1 = rowsel(1)
    r0c2, r1c2 = rowsel(2)
    t00, t01 = torch.where(cu1, r0c1, r0c0), torch.where(cu1, r0c2, r0c1)
    t10, t11 = torch.where(cu1, r1c1, r1c0), torch.where(cu1, r1c2, r1c1)
    value = _lerp2(t00, t01, t10, t11, fu, fv)
    uh_c = u_s + f32(GRAD_H)
    u0h = torch.trunc(uh_c)
    cross_u = u0h > u0
    uh = _lerp2(torch.where(cross_u, t01, t00), torch.where(cross_u, r0c2, t01),
                torch.where(cross_u, t11, t10), torch.where(cross_u, r1c2, t11), uh_c - u0h, fv)
    vh_c = v_s + f32(GRAD_H)
    v0h = torch.trunc(vh_c)
    cross_v = v0h > v0
    t20, t21 = torch.where(cu1, taps[7], taps[6]), torch.where(cu1, taps[8], taps[7])
    vh = _lerp2(torch.where(cross_v, t10, t00), torch.where(cross_v, t11, t01),
                torch.where(cross_v, t20, t10), torch.where(cross_v, t21, t11), fu, vh_c - v0h)
    du_g = (uh - value) * f32(1.0 / GRAD_H)
    dv_g = (vh - value) * f32(1.0 / GRAD_H)
    r_color = s_int * f32(0.003921569) - value
    w_color = w_geom * (r_color * r_color <= f32(level["max_color_distance"] * level["max_color_distance"])).to(torch.float32)
    gx = du_g * f32(fx) * inv_z
    gy = dv_g * f32(fy) * inv_z
    gz = -(du_g * px * f32(fx) + dv_g * py * f32(fy)) * inv_z * inv_z
    jc = (py * gz - pz * gy, pz * gx - px * gz, px * gy - py * gx)

    ones = torch.ones_like(w_geom)
    out = []
    for chans, wt in (((nx, ny, nz, *jg, r_geom, ones), w_geom), ((gx, gy, gz, *jc, r_color, ones), w_color)):
        a = prec.round(torch.stack(chans, dim=1).reshape(b, 8, -1))
        a = a.to(torch.bfloat16).to(torch.float32)
        aw = (a * wt.reshape(b, 1, -1).to(torch.bfloat16).to(torch.float32)).to(torch.bfloat16).to(torch.float32)
        blk = torch.bmm(aw, a.transpose(1, 2))
        out.append((blk[:, :6, :6], blk[:, :6, 6], blk[:, 6, 6], blk[:, 7, 7]))
    return out[0], out[1]


def _align_banded(rot, trans, sources, targets, level: dict, prec: Precision):
    h, w = sources[0]["mask"].shape
    camera = targets[0]["camera"]
    stack = lambda key, lvs: torch.stack([lv[key] for lv in lvs])  # noqa: E731
    src = _source_planes(stack("points", sources), stack("mask", sources), stack("intensities", sources), h, w)
    tgt = _target_planes(stack("points", targets), stack("normals", targets), stack("mask", targets),
                         stack("intensity_map", targets), h, w)
    cents = _centroids(src, camera)
    return gn_loop(lambda r, t: banded_step(r, t, src, tgt, cents, camera, (h, w), level, prec), rot, trans,
                   level, prec)


def multiscale_align(sources: list[list[dict]], targets: list[list[dict]], levels: list[dict],
                     prec: Precision) -> tuple[torch.Tensor, torch.Tensor]:
    """Relative poses (source in target's frame) of B pairs: ``sources[i]``
    and ``targets[i]`` are pair i's pyramids (fine -> coarse); ``levels``
    the per-level parameters, fine -> coarse. Coarse to fine, each level's
    pose seeding the next (multiscale.rs:51-63)."""
    b = len(sources)
    rot, trans = se3.identity((b,), sources[0][0]["points"].device)
    for k in reversed(range(len(levels))):
        level = levels[k]
        align = {"xla": _align_exact, "pallas_v4": _align_banded}[level["engine"]]
        rot, trans = align(rot, trans, [p[k] for p in sources], [p[k] for p in targets], level, prec)
    return rot, trans
