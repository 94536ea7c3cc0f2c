"""Masked nearest-to-mean pyramid downsampling (port of ``align3d_tpu/ops/resize.py``).

Each destination pixel looks at the 2x2 source window at
``(floor(v * ratio), floor(u * ratio))``, takes the masked mean and picks the
source value nearest to it (``src/range_image/resize.rs``). The JAX package
extracts the window's columns with 0/1 selection matmuls to avoid a TPU
lane relayout; strided slices pick the same values exactly.
"""

from __future__ import annotations

import torch


def _window_taps(src: torch.Tensor, dst_h: int, dst_w: int) -> list[torch.Tensor]:
    """The 2x2 window of (..., H, W) planes as 4 (..., dst_h, dst_w) tensors
    in ((0,0), (0,1), (1,0), (1,1)) order."""
    h, w = src.shape[-2:]
    if h == 2 * dst_h and w == 2 * dst_w:
        return [src[..., dv::2, du::2] for dv in (0, 1) for du in (0, 1)]
    dev = src.device
    src_v = (torch.arange(dst_h, dtype=torch.float32, device=dev) * (h / dst_h)).to(torch.int64)
    src_u = (torch.arange(dst_w, dtype=torch.float32, device=dev) * (w / dst_w)).to(torch.int64)
    taps = []
    for dv in (0, 1):
        for du in (0, 1):
            vv = torch.clamp(src_v + dv, 0, h - 1)
            uu = torch.clamp(src_u + du, 0, w - 1)
            taps.append(src[..., vv[:, None], uu[None, :]])
    return taps


def resize_nearest_to_mean(
    src_values: torch.Tensor, src_mask: torch.Tensor, dst_height: int, dst_width: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., H, W, C) values + (..., H, W) mask -> ((..., dst_h, dst_w, C),
    (..., dst_h, dst_w) mask)."""
    chans = src_values.shape[-1]
    planes = [_window_taps(src_values[..., c].to(torch.float32), dst_height, dst_width) for c in range(chans)]
    masks = _window_taps(src_mask.to(torch.float32), dst_height, dst_width)
    vals = [[planes[c][t] for c in range(chans)] for t in range(4)]

    count = masks[0] + masks[1] + masks[2] + masks[3]
    any_valid = count > 0
    safe_count = torch.where(any_valid, count, 1.0)
    means = [sum(v[c] * m for v, m in zip(vals, masks)) / safe_count for c in range(chans)]

    # Strict < keeps the first tap on ties, like the reference's scan.
    best_val, best_dist = None, None
    for v, m in zip(vals, masks):
        dist = sum((v[c] - means[c]) ** 2 for c in range(chans))
        dist = torch.where(m > 0, dist, torch.inf)
        if best_val is None:
            best_val, best_dist = list(v), dist
        else:
            better = dist < best_dist
            best_dist = torch.where(better, dist, best_dist)
            best_val = [torch.where(better, v[c], best_val[c]) for c in range(chans)]

    out_vals = torch.stack([torch.where(any_valid, b, 0.0) for b in best_val], dim=-1)
    return out_vals, any_valid
