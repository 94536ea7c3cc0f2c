"""Small math helpers (port of ``align3d_tpu/extra_math.py``; reference
``src/extra_math.rs``)."""

from __future__ import annotations

import torch


def angle_between_normals(lfs: torch.Tensor, rfs: torch.Tensor) -> torch.Tensor:
    """Angle in radians between two (batches of) unit normals, batched over
    leading axes. Like the reference (``src/extra_math.rs:13``) the dot
    product is not clamped, so a dot outside [-1, 1] gives NaN."""
    return torch.abs(torch.arccos(torch.sum(lfs * rfs, dim=-1)))


def div_scalar(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` divided as the CPU divides, on every device: by a 0-dim
    tensor of ``x``'s dtype on ``x``'s device. PyTorch's CUDA kernel turns
    a division by a Python number (a CPU scalar) into a product with its
    float32 reciprocal, which can differ from the quotient in the last bit;
    a 0-dim CUDA tensor is divided by. ``c`` rounds to ``x``'s dtype as the
    Python number would."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)
