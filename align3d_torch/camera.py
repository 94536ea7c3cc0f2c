"""Pinhole camera model (port of ``align3d_tpu/camera.py``).

Intrinsics are a frozen dataclass of Python floats; every projection rounds
them to float32 where they meet a tensor, as the JAX package does.
"""

from __future__ import annotations

import dataclasses

import torch

from align3d_torch.extra_math import div_scalar
from align3d_torch.se3 import Transform


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole intrinsics (reference ``src/camera.rs:7-20``)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def project(self, points: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """3D points (..., 3) -> pixel (u, v), each (...,) (src/camera.rs:64)."""
        z = points[..., 2]
        u = points[..., 0] * self.fx / z + self.cx
        v = points[..., 1] * self.fy / z + self.cy
        return u, v

    def project_grad(self, points: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Projection Jacobian terms ``(du/dx, du/dz, dv/dy, dv/dz)``, each
        (...,); the reference names them (dfx, dcx, dfy, dcy)
        (src/camera.rs:82)."""
        z = points[..., 2]
        zz = z * z
        dfx = torch.full_like(z, self.fx) / z
        dcx = -points[..., 0] * self.fx / zz
        dfy = torch.full_like(z, self.fy) / z
        dcy = -points[..., 1] * self.fy / zz
        return dfx, dcx, dfy, dcy

    def backproject(self, u: torch.Tensor, v: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """Pixel (u, v) and depth z -> 3D point (..., 3) (src/camera.rs:102)."""
        x = div_scalar((u - self.cx) * z, self.fx)
        y = div_scalar((v - self.cy) * z, self.fy)
        return torch.stack([x, y, torch.broadcast_to(z, x.shape)], dim=-1)

    def backproject_grid(self, depth: torch.Tensor) -> torch.Tensor:
        """Backproject a full (H, W) depth image -> (H, W, 3) points."""
        h, w = depth.shape[-2:]
        vs = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
        us = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
        x = div_scalar((us - self.cx) * depth, self.fx)
        y = div_scalar((vs - self.cy) * depth, self.fy)
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

    def with_size(self, width: int, height: int) -> "CameraIntrinsics":
        return dataclasses.replace(self, width=width, height=height)


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """Intrinsics and a world pose (src/camera.rs:137-202)."""

    intrinsics: CameraIntrinsics
    camera_to_world: Transform

    @property
    def world_to_camera(self) -> Transform:
        return self.camera_to_world.inverse()

    def project(self, points: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """World points -> (u, v, z in the camera frame)."""
        cam_pts = self.world_to_camera.apply(points)
        u, v = self.intrinsics.project(cam_pts)
        return u, v, cam_pts[..., 2]

    def project_to_image(self, points: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """``project`` rounded to pixels, with a visibility mask where the
        reference returns an Option (src/camera.rs:192-202)."""
        u, v, z = self.project(points)
        ur, vr = torch.round(u), torch.round(v)
        visible = (ur >= 0.0) & (ur < self.intrinsics.width) & (vr >= 0.0) & (vr < self.intrinsics.height)
        return ur, vr, z, visible
