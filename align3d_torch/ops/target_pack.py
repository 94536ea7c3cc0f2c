"""Packed per-pixel target tables for projective ICP (port of ``align3d_tpu/ops/target_pack.py``).

* ``pack_geometry`` -> (H*W, 8): [px py pz nx ny nz valid 0], read at the
  nearest projected pixel.
* ``pack_intensity_taps`` -> (H*W, 12): the 3x3 neighbourhood of the
  bordered intensity map (+3 zero lanes), read at the bilinear base pixel.
  The 9 taps give the reference's bilinear value and both numeric-gradient
  samples exactly, including the case where ``u + 0.005`` crosses into the
  next cell (``src/intensity_map.rs:150-210``).

Both the plain ICP step and the CUDA GN-step kernel read these tables.
"""

from __future__ import annotations

import torch

from align3d_torch.ops.intensity import GRAD_H, GRAD_H_INV

GEO_CHANNELS = 8
TAP_CHANNELS = 12


def pack_geometry(points: torch.Tensor, normals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3), (..., H, W, 3), (..., H, W) -> (..., H*W, 8) f32 row
    table."""
    *lead, h, w = mask.shape
    n = h * w
    return torch.cat(
        [
            points.reshape(*lead, n, 3),
            normals.reshape(*lead, n, 3),
            mask.reshape(*lead, n, 1).to(torch.float32),
            torch.zeros((*lead, n, 1), dtype=torch.float32, device=mask.device),
        ],
        dim=-1,
    ).contiguous()


def pack_intensity_taps(intensity_map: torch.Tensor) -> torch.Tensor:
    """(..., H+2, W+2) bordered maps -> (..., H*W, 12) f32; row ``v * W + u``
    holds ``I[v+dv, u+du]`` for (dv, du) in row-major {0,1,2}^2."""
    *lead, h2, w2 = intensity_map.shape
    h, w = h2 - 2, w2 - 2
    taps = [intensity_map[..., dv : dv + h, du : du + w].reshape(*lead, h * w) for dv in range(3) for du in range(3)]
    zeros = torch.zeros((*lead, h * w), dtype=torch.float32, device=intensity_map.device)
    return torch.stack(taps + [zeros, zeros, zeros], dim=-1).contiguous()


def _lerp2(t00, t01, t10, t11, fu, fv):
    a = t00 * (1.0 - fu) + t01 * fu
    b = t10 * (1.0 - fu) + t11 * fu
    return a * (1.0 - fv) + b * fv


def taps_bilinear_grad(taps: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Bilinear value and numeric (du, dv) gradient from gathered taps.

    ``u``/``v`` are the clamped (>= 0) sample coordinates. The +H sample
    re-truncates: its fraction is ``(u + H) - trunc(u + H)``, not
    ``frac(u) + H``, which rounds differently and would perturb the
    x200-amplified gradient.
    """
    t = taps.movedim(-1, 0)
    u0 = torch.trunc(u)
    v0 = torch.trunc(v)
    fu = u - u0
    fv = v - v0
    value = _lerp2(t[0], t[1], t[3], t[4], fu, fv)

    uh_c = u + GRAD_H
    u0h = torch.trunc(uh_c)
    cross_u = u0h > u0
    fuh = uh_c - u0h
    uh = _lerp2(
        torch.where(cross_u, t[1], t[0]),
        torch.where(cross_u, t[2], t[1]),
        torch.where(cross_u, t[4], t[3]),
        torch.where(cross_u, t[5], t[4]),
        fuh,
        fv,
    )

    vh_c = v + GRAD_H
    v0h = torch.trunc(vh_c)
    cross_v = v0h > v0
    fvh = vh_c - v0h
    vh = _lerp2(
        torch.where(cross_v, t[3], t[0]),
        torch.where(cross_v, t[4], t[1]),
        torch.where(cross_v, t[6], t[3]),
        torch.where(cross_v, t[7], t[4]),
        fu,
        fvh,
    )
    return value, (uh - value) * GRAD_H_INV, (vh - value) * GRAD_H_INV
