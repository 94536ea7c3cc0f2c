"""Range-image normals as one elementwise stencil (port of ``align3d_tpu/ops/normals.py``).

Reference semantics (``src/range_image/structure.rs:184-262``), quirks
included: out-of-bounds or masked neighbours read as the zero point; the
distance-ratio test (threshold 2, squared 4) picks central, backward or
forward differences per axis; a 0/0 ratio is NaN and fails both ratio
comparisons; normals of magnitude <= 1e-6 stay zero.

Leading batch axes pass through: points (..., H, W, 3), mask (..., H, W).
The magnitude's root is taken in float64 and rounded once to float32, the
correctly rounded float32 root: PyTorch's float32 ``sqrt`` on the CPU
misrounds about 0.6% of inputs by 1 ulp, while the card's is correctly
rounded, so the two devices agree bitwise only through the float64 root.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_RATIO_THRESHOLD_SQ = 4.0


def _axis_difference(center, backward, forward):
    """Per-axis difference selection on per-channel (H, W) planes."""
    b_dist = sum((backward[c] - center[c]) ** 2 for c in range(3))
    f_dist = sum((forward[c] - center[c]) ** 2 for c in range(3))
    ratio = b_dist / f_dist
    central = (ratio < _RATIO_THRESHOLD_SQ) & (ratio > 1.0 / _RATIO_THRESHOLD_SQ)
    back_closer = b_dist < f_dist
    return [
        torch.where(
            central,
            forward[c] - backward[c],
            torch.where(back_closer, center[c] - backward[c], forward[c] - center[c]),
        )
        for c in range(3)
    ]


def compute_normals(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) points + (..., H, W) mask -> (..., H, W, 3) unit
    normals (zero where degenerate)."""
    h, w = mask.shape[-2:]
    mask_f = mask.to(torch.float32)
    center = [points[..., c].to(torch.float32) for c in range(3)]
    padded = [F.pad(c * mask_f, (1, 1, 1, 1)) for c in center]

    def at(dv, du):
        return [p[..., 1 + dv : 1 + dv + h, 1 + du : 1 + du + w] for p in padded]

    lr = _axis_difference(center, at(0, -1), at(0, 1))
    # Vertical: ratio of bottom (row + 1) to top distances; central = top - bottom.
    bt = _axis_difference(center, at(1, 0), at(-1, 0))

    nx = lr[1] * bt[2] - lr[2] * bt[1]
    ny = lr[2] * bt[0] - lr[0] * bt[2]
    nz = lr[0] * bt[1] - lr[1] * bt[0]
    mag = torch.sqrt((nx * nx + ny * ny + nz * nz).double()).to(torch.float32)
    ok = mag > 1e-6
    safe = torch.where(ok, mag, 1.0)
    zero = torch.zeros_like(mag)
    return torch.stack(
        [torch.where(ok, nx / safe, zero), torch.where(ok, ny / safe, zero), torch.where(ok, nz / safe, zero)],
        dim=-1,
    )
