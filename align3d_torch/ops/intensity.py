"""Bordered intensity map and its samplers (port of ``align3d_tpu/ops/intensity.py``).

The map is ``(H+2, W+2)`` float32 whose border replicates edge values in the
exact pattern of the reference ``fill`` (``src/intensity_map.rs:37-79``).
:func:`bilinear` and :func:`bilinear_grad` sample one map at tensors of
(u, v); the GN step (K1 and its twin) samples the map itself.
"""

from __future__ import annotations

import torch

from align3d_torch.extra_math import div_scalar

# Numeric gradient step (src/intensity_map.rs:12-14).
GRAD_H = 0.005
GRAD_H_INV = 1.0 / GRAD_H
BORDER = 2


def build_intensity_map(image_u8: torch.Tensor) -> torch.Tensor:
    """(..., H, W) u8 luma -> (..., H+2, W+2) f32 map with the reference
    border fill."""
    *lead, h, w = image_u8.shape
    core = div_scalar(image_u8.to(torch.float32), 255.0)
    m = torch.zeros((*lead, h + BORDER, w + BORDER), dtype=torch.float32, device=image_u8.device)
    m[..., :h, :w] = core
    # Rows h, h+1 copy row h-1 for columns 0..w-2 only (:61-66).
    m[..., h : h + 2, : w - 1] = core[..., h - 1 : h, : w - 1]
    # Columns w, w+1 copy column w-1 for rows 0..h-2 only (:68-73).
    m[..., : h - 1, w : w + 2] = core[..., : h - 1, w - 1 : w]
    # The diagonal corner cells get the last pixel (:75-78).
    m[..., h, w] = core[..., h - 1, w - 1]
    m[..., h + 1, w + 1] = core[..., h - 1, w - 1]
    return m


def _trunc_index(x: torch.Tensor) -> torch.Tensor:
    """Rust ``as usize`` for in-range floats: toward zero, saturating at 0."""
    return torch.clamp(torch.trunc(x), min=0.0).to(torch.int64)


def bilinear(map_padded: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an (H+2, W+2) map at float (u, v) of any one shape
    (src/intensity_map.rs:150-169). Callers keep trunc(u) <= W-1 and
    trunc(v) <= H-1, as the reference's unchecked indexing assumes."""
    w2 = map_padded.shape[1]
    flat = map_padded.reshape(-1)
    ui, vi = _trunc_index(u), _trunc_index(v)
    u_frac = u - ui.to(u.dtype)
    v_frac = v - vi.to(v.dtype)
    base = vi * w2 + ui
    val00 = torch.take(flat, base)
    val10 = torch.take(flat, base + 1)
    val01 = torch.take(flat, base + w2)
    val11 = torch.take(flat, base + w2 + 1)
    u0 = val00 * (1.0 - u_frac) + val10 * u_frac
    u1 = val01 * (1.0 - u_frac) + val11 * u_frac
    return u0 * (1.0 - v_frac) + u1 * v_frac


def bilinear_grad(map_padded: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Value and forward-difference (du, dv) gradients with the reference's
    step ``GRAD_H`` (src/intensity_map.rs:184-210)."""
    value = bilinear(map_padded, u, v)
    uh = bilinear(map_padded, u + GRAD_H, v)
    vh = bilinear(map_padded, u, v + GRAD_H)
    return value, (uh - value) * GRAD_H_INV, (vh - value) * GRAD_H_INV
