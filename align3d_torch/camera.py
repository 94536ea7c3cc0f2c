"""Pinhole camera model (port of ``align3d_tpu/camera.py``).

Intrinsics are a frozen dataclass of Python floats; every projection rounds
them to float32 where they meet a tensor, as the JAX package does.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole intrinsics (reference ``src/camera.rs:7-20``)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def backproject_grid(self, depth: torch.Tensor) -> torch.Tensor:
        """Backproject a full (H, W) depth image -> (H, W, 3) points."""
        h, w = depth.shape[-2:]
        vs = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
        us = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
        x = (us - self.cx) * depth / self.fx
        y = (vs - self.cy) * depth / self.fy
        return torch.stack([x, y, depth], dim=-1)

    def scale(self, factor: float) -> "CameraIntrinsics":
        """Pyramid rescale: scales focal/center, keeps size (src/camera.rs:119)."""
        return dataclasses.replace(
            self,
            fx=self.fx * factor,
            fy=self.fy * factor,
            cx=self.cx * factor,
            cy=self.cy * factor,
        )
