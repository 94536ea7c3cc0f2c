"""Bordered intensity map (port of ``align3d_tpu/ops/intensity.py``).

The map is ``(H+2, W+2)`` float32 whose border replicates edge values in the
exact pattern of the reference ``fill`` (``src/intensity_map.rs:37-79``).
"""

from __future__ import annotations

import torch

# Numeric gradient step (src/intensity_map.rs:12-14).
GRAD_H = 0.005
GRAD_H_INV = 1.0 / GRAD_H
BORDER = 2


def build_intensity_map(image_u8: torch.Tensor) -> torch.Tensor:
    """(..., H, W) u8 luma -> (..., H+2, W+2) f32 map with the reference
    border fill."""
    *lead, h, w = image_u8.shape
    core = image_u8.to(torch.float32) / 255.0
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
