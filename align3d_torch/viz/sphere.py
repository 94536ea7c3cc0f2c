"""Bounding spheres (port of ``align3d_tpu/viz/sphere.py``; reference
``src/viz/sphere3d.rs``).

The sphere itself is host camera math (a numpy float32 centre and a float
radius). :meth:`Sphere3D.from_points` fits with the JAX package's numpy
code, and gives a tensor numpy's bits on every device: a CPU tensor goes
through numpy itself; on the card :func:`numpy_means` (``csrc/sphere.cu``,
K6) adds each column's rows one after another in float32, as numpy does and
no parallel reduction can, and the radius is numpy's float32 distance, the
largest square's root. :meth:`Sphere3D.fit_many` fits many point sets on
the card in one K6 launch and one copy back; a scene fits every node that
has no kept sphere so (``viz/scene.py::Scene.bounding_sphere``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from align3d_torch import _kernels


def numpy_means_plain(points: torch.Tensor, counts: list[int]) -> torch.Tensor:
    """K6's plain twin: numpy's ``mean(axis=0)`` (the JAX package's own
    arithmetic) of each of the consecutive (``counts[i]``, 3) blocks of an
    (N, 3) float32 CPU tensor, as an (M, 3) tensor."""
    blocks = np.split(points.numpy(), np.cumsum(counts)[:-1])
    return torch.from_numpy(np.stack([np.asarray(b.mean(axis=0), np.float32).reshape(3) for b in blocks]))


def numpy_means(points: torch.Tensor, counts: list[int]) -> torch.Tensor:
    """numpy's float32 ``mean(axis=0)`` of each of the consecutive
    (``counts[i]``, 3) blocks of (N, 3) float32 points, every count >= 1,
    bit for bit, on the points' device: one K6 launch on the card."""
    if points.device.type == "cpu":
        return numpy_means_plain(points, counts)
    n = points.shape[0]
    _kernels.check_tensor(points, "points", (n, 3), torch.float32, points.device)
    if not counts or min(counts) < 1 or sum(counts) != n:
        raise ValueError(f"numpy_means takes counts >= 1 that add up to the {n} points, got {counts}")
    offsets = torch.tensor([0, *np.cumsum(counts).tolist()], dtype=torch.int64).to(points.device)
    out = torch.empty((len(counts), 3), dtype=torch.float32, device=points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    _kernels.launch("K6", points.data_ptr(), offsets.data_ptr(), len(counts), out.data_ptr(), stream)
    return out


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
            pts = points.detach().reshape(-1, 3).to(torch.float32)
            if pts.device.type != "cpu" and pts.shape[0] > 0:
                return cls.fit_many([pts])[0]
            points = pts.cpu().numpy()
        pts = np.asarray(points, np.float32).reshape(-1, 3)
        if pts.shape[0] == 0:
            return cls.empty()
        center = pts.mean(axis=0)
        radius = float(np.linalg.norm(pts - center, axis=1).max())
        return cls(center, radius)

    @classmethod
    def fit_many(cls, points: list) -> list["Sphere3D"]:
        """:meth:`from_points` of each of ``points``. The non-empty tensors
        on a card are fitted together: numpy's means (one K6 launch), numpy's
        float32 distances, (d0^2 + d1^2) + d2^2 as its row sums take them,
        and each set's largest one's root (float32 sqrt is monotonic, so it
        is the largest distance), correctly rounded; one copy back."""
        fits = {}
        on_card = {}
        for i, p in enumerate(points):
            if isinstance(p, torch.Tensor) and p.device.type != "cpu" and p.numel() > 0:
                on_card.setdefault(p.device, []).append(i)
            else:
                fits[i] = cls.from_points(p)
        for device, idx in on_card.items():
            sets = [points[i].detach().reshape(-1, 3).to(torch.float32) for i in idx]
            counts = [s.shape[0] for s in sets]
            pts = torch.cat(sets).contiguous()
            centers = numpy_means(pts, counts)
            node = torch.repeat_interleave(torch.arange(len(idx), device=device),
                                           torch.tensor(counts, device=device), output_size=pts.shape[0])
            d = pts - centers[node]
            squared = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
            largest = torch.zeros(len(idx), dtype=torch.float32, device=device).scatter_reduce_(0, node, squared, "amax")
            radii = largest.to(torch.float64).sqrt().to(torch.float32)
            both = torch.cat([centers, radii[:, None]], dim=1).cpu().numpy()
            for i, row in zip(idx, both):
                fits[i] = cls(row[:3].copy(), float(row[3]))
        return [fits[i] for i in range(len(points))]

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
