"""Reference preprocessing: the bilateral-grid depth filter and the 3-level
range-image pyramid (points, normals, luma, bordered intensity map).

Semantics of the Rust ``align3d`` (``src/bilateral/``, ``src/range_image/``,
``src/image/``, ``src/intensity_map.rs``), in the arithmetic of the port's
plain twins. The splat is a scatter-add of whole depth values and counts,
exact in float32 in any order (a cell gathers at most 25 pixels of at most
65535), where the port's kernel K2 and its twin add window taps in order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import Precision

SPACE_PAD = 2
COLOR_PAD = 2
GRID_QUANTUM = 16  # the grid's depth axis is padded up to a multiple of this


def grid_dims(h: int, w: int, sigma_space: float) -> tuple[int, int]:
    return int((h - 1) / sigma_space) + 1 + 2 * SPACE_PAD, int((w - 1) / sigma_space) + 1 + 2 * COLOR_PAD


def true_depth(color_min: float, color_max: float, sigma_color: float) -> int:
    """The grid depth of a depth span (grid.rs:51-54)."""
    return int((float(color_max) - float(color_min)) / sigma_color) + 1 + 2 * COLOR_PAD


def _cells(n: int, inv_ss: float, pad: int) -> np.ndarray:
    """Grid index of each pixel along one axis: trunc(i * f32(1/ss) + 0.5) + pad."""
    return (np.arange(n, dtype=np.float32) * np.float32(inv_ss) + np.float32(0.5)).astype(np.int32) + pad


def splat(depth: torch.Tensor, cmin: int, gd: int, sigma_space: float, sigma_color: float) -> torch.Tensor:
    """One (H, W) int32 frame -> its (2, gh, gw, gd) [value, count] grid."""
    h, w = depth.shape
    gh, gw = grid_dims(h, w, sigma_space)
    dev = depth.device
    inv_ss = 1.0 / sigma_space
    ry = torch.from_numpy(_cells(h, inv_ss, SPACE_PAD)).to(dev).long()
    rx = torch.from_numpy(_cells(w, inv_ss, SPACE_PAD)).to(dev).long()
    vals = depth.to(torch.float32)
    chan = ((vals - float(cmin)) * (1.0 / sigma_color) + 0.5).to(torch.int32).long() + COLOR_PAD
    keep = (depth > 0) & (chan >= 0) & (chan < gd) & (ry[:, None] < gh) & (rx[None, :] < gw)
    cell = ((ry[:, None] * gw + rx[None, :]) * gd + chan)[keep]
    grid = torch.zeros((2, gh * gw * gd), dtype=torch.float32, device=dev)
    grid[0].index_add_(0, cell, vals[keep])
    grid[1].index_add_(0, cell, torch.ones_like(vals[keep]))
    return grid.reshape(2, gh, gw, gd)


def _pass_121(x: torch.Tensor, dim: int) -> torch.Tensor:
    """One 1-2-1/4 pass with zeros outside: (0.5 x[i] + 0.25 x[i-1]) + 0.25 x[i+1]."""
    n = x.shape[dim]
    out = x * 0.5
    out.narrow(dim, 1, n - 1).add_(x.narrow(dim, 0, n - 1) * 0.25)
    out.narrow(dim, 0, n - 1).add_(x.narrow(dim, 1, n - 1) * 0.25)
    return out


def blur(grid: torch.Tensor, depth_limit: int) -> torch.Tensor:
    """Per axis (rows, columns, depth) mask, pass, mask, pass, mask: the
    reference writes interior cells only (edge_aware_filter.rs:57-115); the
    depth axis's interior ends at the frame's true depth."""
    dev = grid.device
    out = grid
    for dim in (-3, -2, -1):
        n = grid.shape[dim]
        idx = torch.arange(n, device=dev)
        inner = (idx < depth_limit - 1) if dim == -1 else ((idx > 0) & (idx < n - 1))
        mask = inner.to(torch.float32).reshape((n,) + (1,) * (-1 - dim))
        out = out * mask
        out = _pass_121(out, dim).mul_(mask)
        out = _pass_121(out, dim).mul_(mask)
    return out


def slice_normalized(grid: torch.Tensor, depth: torch.Tensor, cmin: int, sigma_space: float,
                     sigma_color: float) -> torch.Tensor:
    """value / count per cell, then the trilinear sample at every pixel,
    truncated to the depth type (grid.rs:90-162)."""
    val, cnt = grid[0], grid[1]
    has = cnt > 0
    val = torch.where(has, val / torch.where(has, cnt, 1.0), val)
    gh, gw, gd = val.shape
    h, w = depth.shape
    dev = depth.device
    inv_ss = np.float32(1.0 / sigma_space)

    def axis(n, n_grid, upper_from_coord):
        coord = np.arange(n, dtype=np.float32) * inv_ss + np.float32(SPACE_PAD)
        i0 = np.clip(coord.astype(np.int32), 0, n_grid - 1)
        # The columns' upper corner is trunc(coord + 1), the rows' i0 + 1.
        i1 = np.clip((coord + np.float32(1.0)).astype(np.int32) if upper_from_coord else i0 + 1, 0, n_grid - 1)
        return (torch.from_numpy(i0).to(dev).long(), torch.from_numpy(i1).to(dev).long(),
                torch.from_numpy((coord - i0).astype(np.float32)).to(dev))

    y0, y1, ya = axis(h, gh, False)
    x0, x1, xa = axis(w, gw, True)
    ya, xa = ya[:, None], xa[None, :]
    chan = (depth.to(torch.float32) - float(cmin)) * (1.0 / sigma_color) + COLOR_PAD
    z0 = torch.clamp(chan.to(torch.int32), 0, gd - 1)
    z1 = torch.clamp((chan + 1.0).to(torch.int32), 0, gd - 1)
    za = chan - z0.to(torch.float32)

    def sample(z):
        z = z.long()
        p0 = val[y0[:, None], x0[None, :], z] * (1.0 - xa) + val[y0[:, None], x1[None, :], z] * xa
        p1 = val[y1[:, None], x0[None, :], z] * (1.0 - xa) + val[y1[:, None], x1[None, :], z] * xa
        return p0 * (1.0 - ya) + p1 * ya

    m0, m1 = sample(z0), sample(z1)
    out = torch.where(z0 == z1, ((1.0 - za) + za) * m0, (1.0 - za) * m0 + za * m1)
    return out.to(torch.int32)


def bilateral_filter(depth: torch.Tensor, sigma_space: float, sigma_color: float, holes_in_min: bool,
                     prec: Precision) -> torch.Tensor:
    """Filter one (H, W) int32 depth frame on a grid sized from its own depth
    span. ``holes_in_min``: the span starts at the minimum counting zero
    holes (the filter of one frame, ``RangeImageBuilder``'s); else at the
    nonzero minimum (the depth buckets of the batched path)."""
    if holes_in_min:
        cmin = int(depth.min())
    else:
        nz = depth[depth > 0]
        cmin = int(nz.min()) if nz.numel() else 65535
    cmax = int(depth.max())
    limit = true_depth(cmin, cmax, sigma_color)
    gd = -(-limit // GRID_QUANTUM) * GRID_QUANTUM
    grid = prec.round(splat(depth, cmin, gd, sigma_space, sigma_color))
    grid = prec.round(blur(grid, limit))
    return slice_normalized(grid, depth, cmin, sigma_space, sigma_color)


# -- the pyramid -------------------------------------------------------------


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as a true division by the float32 c (not a product with 1/c)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def backproject(depth: torch.Tensor, scale: float, camera: tuple, prec: Precision) -> tuple[torch.Tensor, torch.Tensor]:
    """(H, W) int32 depth -> ((H, W, 3) points, (H, W) mask); holes stay (0, 0, 0)."""
    fx, fy, cx, cy = camera
    mask = depth > 0
    z = depth.to(torch.float32) * torch.tensor(scale, dtype=torch.float32, device=depth.device)
    h, w = depth.shape
    vs = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    us = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    points = torch.stack([_div((us - cx) * z, fx), _div((vs - cy) * z, fy), z], dim=-1)
    return prec.round(torch.where(mask[..., None], points, 0.0)), mask


def _axis_difference(center, backward, forward):
    b_dist = sum((backward[c] - center[c]) ** 2 for c in range(3))
    f_dist = sum((forward[c] - center[c]) ** 2 for c in range(3))
    ratio = b_dist / f_dist
    central = (ratio < 4.0) & (ratio > 0.25)
    back_closer = b_dist < f_dist
    return [torch.where(central, forward[c] - backward[c],
                        torch.where(back_closer, center[c] - backward[c], forward[c] - center[c])) for c in range(3)]


def normals(points: torch.Tensor, mask: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Unit normals of an (H, W, 3) grid (structure.rs:184-262): masked
    neighbours read as the zero point; central, backward or forward
    differences by the distance ratio; zero where the cross product is <= 1e-6."""
    h, w = mask.shape
    mask_f = mask.to(torch.float32)
    center = [points[..., c] for c in range(3)]
    padded = [torch.nn.functional.pad(c * mask_f, (1, 1, 1, 1)) for c in center]

    def at(dv, du):
        return [p[1 + dv : 1 + dv + h, 1 + du : 1 + du + w] for p in padded]

    lr = _axis_difference(center, at(0, -1), at(0, 1))
    bt = _axis_difference(center, at(1, 0), at(-1, 0))
    nx = lr[1] * bt[2] - lr[2] * bt[1]
    ny = lr[2] * bt[0] - lr[0] * bt[2]
    nz = lr[0] * bt[1] - lr[1] * bt[0]
    mag = torch.sqrt((nx * nx + ny * ny + nz * nz).double()).to(torch.float32)
    ok = mag > 1e-6
    safe = torch.where(ok, mag, 1.0)
    zero = torch.zeros_like(mag)
    out = torch.stack([torch.where(ok, n / safe, zero) for n in (nx, ny, nz)], dim=-1)
    return prec.round(out)


def downsample(values: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Half size by the masked 2x2 nearest-to-mean pick (resize.rs): the
    window's masked mean, then its valid value nearest to it (the first on
    ties)."""
    taps = [(dv, du) for dv in (0, 1) for du in (0, 1)]
    h2, w2 = mask.shape[0] // 2, mask.shape[1] // 2
    vals = [[values[dv : 2 * h2 : 2, du : 2 * w2 : 2, c] for c in range(values.shape[-1])] for dv, du in taps]
    masks = [mask[dv : 2 * h2 : 2, du : 2 * w2 : 2].to(torch.float32) for dv, du in taps]
    count = masks[0] + masks[1] + masks[2] + masks[3]
    any_valid = count > 0
    safe = torch.where(any_valid, count, 1.0)
    chans = values.shape[-1]
    means = [sum(v[c] * m for v, m in zip(vals, masks)) / safe for c in range(chans)]
    best, best_dist = None, None
    for v, m in zip(vals, masks):
        dist = torch.where(m > 0, sum((v[c] - means[c]) ** 2 for c in range(chans)), torch.inf)
        if best is None:
            best, best_dist = list(v), dist
        else:
            better = dist < best_dist
            best_dist = torch.where(better, dist, best_dist)
            best = [torch.where(better, v[c], best[c]) for c in range(chans)]
    return torch.stack([torch.where(any_valid, b, 0.0) for b in best], dim=-1), any_valid


def blur_decimate(color: torch.Tensor, sigma: float) -> torch.Tensor:
    """(H, W, 3) u8 -> (H/2, W/2, 3) u8: a separable Gaussian (support 2
    sigma, replicated borders; ``image::imageops`` windowing) evaluated at
    the even positions, clamped and truncated (rgb.rs:74-84)."""
    support = 2.0 * sigma
    lo, hi = int(math.floor(0.5 - support)), int(math.ceil(0.5 + support))
    offs = np.arange(lo, hi)
    wts = np.exp(-(offs.astype(np.float64) ** 2) / (2.0 * sigma * sigma))
    wts = (wts / wts.sum()).astype(np.float32)
    x = color.to(torch.float32)

    def axis_pass(x, axis):
        n = x.shape[axis]
        pos = torch.arange(0, n, 2, device=x.device)
        acc = None
        for k, wt in enumerate(wts):
            term = float(wt) * torch.index_select(x, axis, torch.clamp(pos + (lo + k), 0, n - 1))
            acc = term if acc is None else acc + term
        return acc

    h2, w2 = color.shape[0] // 2, color.shape[1] // 2
    out = axis_pass(axis_pass(x, 0), 1)
    return torch.clamp(out[:h2, :w2], 0.0, 255.0).to(torch.uint8)


def luma(color: torch.Tensor) -> torch.Tensor:
    """0.3 R + 0.59 G + 0.11 B, truncated to u8 (luma.rs:75-83)."""
    c = color.to(torch.float32)
    return (c[..., 0] * 0.3 + c[..., 1] * 0.59 + c[..., 2] * 0.11).to(torch.uint8)


def intensity_map(lum: torch.Tensor, prec: Precision) -> torch.Tensor:
    """(H, W) u8 -> (H+2, W+2) float32 luma / 255 with the reference's border
    fill (intensity_map.rs:37-79)."""
    h, w = lum.shape
    core = _div(lum.to(torch.float32), 255.0)
    m = torch.zeros((h + 2, w + 2), dtype=torch.float32, device=lum.device)
    m[:h, :w] = core
    m[h : h + 2, : w - 1] = core[h - 1 : h, : w - 1]
    m[: h - 1, w : w + 2] = core[: h - 1, w - 1 : w]
    m[h, w] = core[h - 1, w - 1]
    m[h + 1, w + 1] = core[h - 1, w - 1]
    return prec.round(m)


def pyramid(color: torch.Tensor, depth: torch.Tensor, scale: float, camera: tuple, levels: int, sigma: float,
            prec: Precision) -> list[dict]:
    """One frame's pyramid, fine -> coarse (builder.rs:74-91): backproject,
    normals at full size, then each level half the last (points and
    normals by the nearest-to-mean pick, colour blurred and decimated,
    intrinsics halved), and each level's luma and intensity map."""
    points, mask = backproject(depth, scale, camera, prec)
    level = {"points": points, "mask": mask, "normals": normals(points, mask, prec), "colors": color,
             "camera": tuple(camera)}
    out = [level]
    for _ in range(levels - 1):
        last = out[-1]
        pts, m = downsample(last["points"], last["mask"])
        nrm, _ = downsample(last["normals"], last["mask"])
        out.append({"points": pts, "mask": m, "normals": nrm, "colors": blur_decimate(last["colors"], sigma),
                    "camera": tuple(c * 0.5 for c in last["camera"])})
    for lv in out:
        lv["intensities"] = luma(lv["colors"])
        lv["intensity_map"] = intensity_map(lv["intensities"], prec)
    return out
