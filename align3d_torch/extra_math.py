"""Small math helpers (port of ``align3d_tpu/extra_math.py``; reference
``src/extra_math.rs``)."""

from __future__ import annotations

import torch


def angle_between_normals(lfs: torch.Tensor, rfs: torch.Tensor) -> torch.Tensor:
    """Angle in radians between two (batches of) unit normals, batched over
    leading axes. Like the reference (``src/extra_math.rs:13``) the dot
    product is not clamped, so a dot outside [-1, 1] gives NaN."""
    return torch.abs(torch.arccos(torch.sum(lfs * rfs, dim=-1)))
