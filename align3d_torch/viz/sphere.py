"""Bounding spheres (port of ``align3d_tpu/viz/sphere.py``; reference
``src/viz/sphere3d.rs``).

The sphere itself is host camera math (a numpy float32 centre and a float
radius). :meth:`Sphere3D.from_points` fits a numpy array with the JAX
package's numpy code, and a tensor on the tensor's device: the centre is
the float64 sum over the points rounded to float32 (numpy sums float32
rows one after another, which no parallel reduction reproduces; the
float64 sum gives the same bits on the CPU and on the card), the radius
the largest float32 distance to it, as numpy computes each one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Sphere3D:
    center: np.ndarray  # (3,) f32
    radius: float

    @classmethod
    def empty(cls) -> "Sphere3D":
        return cls(np.zeros(3, np.float32), -1.0)

    @property
    def is_empty(self) -> bool:
        return self.radius < 0.0

    @classmethod
    def from_points(cls, points) -> "Sphere3D":
        """Fit center = mean, radius = max distance (sphere3d.rs:14-40)."""
        if isinstance(points, torch.Tensor):
            return cls._from_tensor(points)
        pts = np.asarray(points, np.float32).reshape(-1, 3)
        if pts.shape[0] == 0:
            return cls.empty()
        center = pts.mean(axis=0)
        radius = float(np.linalg.norm(pts - center, axis=1).max())
        return cls(center, radius)

    @classmethod
    def _from_tensor(cls, points: torch.Tensor) -> "Sphere3D":
        pts = points.reshape(-1, 3).to(torch.float32)
        if pts.shape[0] == 0:
            return cls.empty()
        center = (pts.to(torch.float64).sum(dim=0) / pts.shape[0]).to(torch.float32)
        d = pts - center
        squared = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
        # float32 sqrt of the largest square, correctly rounded (taken in float64).
        radius = squared.max().to(torch.float64).sqrt().to(torch.float32)
        both = torch.cat([center, radius.reshape(1)]).cpu().numpy()
        return cls(both[:3].copy(), float(both[3]))

    def union(self, other: "Sphere3D") -> "Sphere3D":
        """Minimal sphere containing both (sphere3d.rs:52-93)."""
        if self.is_empty:
            return other
        if other.is_empty:
            return self
        d = float(np.linalg.norm(other.center - self.center))
        if d + other.radius <= self.radius:
            return self
        if d + self.radius <= other.radius:
            return other
        radius = (d + self.radius + other.radius) / 2.0
        direction = (other.center - self.center) / d if d > 0 else np.zeros(3)
        center = self.center + direction * (radius - self.radius)
        return Sphere3D(center.astype(np.float32), radius)

    def transformed(self, matrix: np.ndarray) -> "Sphere3D":
        """Rigid-transform the sphere (rotation preserves the radius)."""
        if self.is_empty:
            return self
        c = matrix[:3, :3] @ self.center + matrix[:3, 3]
        return Sphere3D(c.astype(np.float32), self.radius)
