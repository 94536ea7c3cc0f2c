"""PointCloud container (port of ``align3d_tpu/pointcloud.py``; reference
``src/pointcloud.rs``).

The reference stores only the valid points (pointcloud.rs:8-38). The port
keeps the JAX package's static-shape form: ``points`` is (N, 3) with a
boolean ``mask`` marking live rows, and every op treats masked-out rows as
absent. :meth:`PointCloud.compacted` drops them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from align3d_torch.io.geometry import Geometry
from align3d_torch.se3 import Transform


@dataclasses.dataclass
class PointCloud:
    points: torch.Tensor  # (N, 3) f32
    mask: torch.Tensor  # (N,) bool
    normals: Optional[torch.Tensor] = None  # (N, 3) f32
    colors: Optional[torch.Tensor] = None  # (N, 3) u8

    def __len__(self) -> int:
        return self.points.shape[0]

    def len_valid(self) -> torch.Tensor:
        return torch.sum(self.mask.to(torch.int32))

    @classmethod
    def from_geometry(cls, geometry: Geometry, device="cpu") -> "PointCloud":
        """From an io.Geometry (host arrays; all points valid)."""

        def opt(array, dtype):
            return None if array is None else torch.from_numpy(np.array(array, dtype=dtype)).to(device)

        pts = opt(geometry.points, np.float32)
        return cls(
            points=pts,
            mask=torch.ones(pts.shape[0], dtype=torch.bool, device=device),
            normals=opt(geometry.normals, np.float32),
            colors=opt(geometry.colors, np.uint8),
        )

    @classmethod
    def from_range_image(cls, ri) -> "PointCloud":
        """Flatten a RangeImage (reference From<&RangeImage>,
        structure.rs:375-405), keeping the static shape and the mask."""
        n = ri.height * ri.width
        return cls(
            points=ri.points.reshape(n, 3),
            mask=ri.mask.reshape(n),
            normals=None if ri.normals is None else ri.normals.reshape(n, 3),
            colors=None if ri.colors is None else ri.colors.reshape(n, 3),
        )

    def transformed(self, transform: Transform) -> "PointCloud":
        """``&Transform * &PointCloud`` (pointcloud.rs:40-56): points map
        through the full transform, normals through the rotation."""
        return dataclasses.replace(
            self,
            points=transform.apply(self.points),
            normals=None if self.normals is None else transform.apply_normals(self.normals),
        )

    def compacted(self) -> "PointCloud":
        """Drop masked-out rows (the reference's filtered storage); the
        shapes become data-dependent, so this syncs with the device."""
        m = self.mask
        return PointCloud(
            points=self.points[m],
            mask=torch.ones(int(m.sum()), dtype=torch.bool, device=m.device),
            normals=None if self.normals is None else self.normals[m],
            colors=None if self.colors is None else self.colors[m],
        )

    def to_geometry(self) -> Geometry:
        """Compacted host-side io.Geometry for PLY/OFF export."""
        c = self.compacted()

        def host(t):
            return None if t is None else t.cpu().numpy()

        return Geometry(points=host(c.points), normals=host(c.normals), colors=host(c.colors))
