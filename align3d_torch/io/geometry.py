"""Geometry interchange container (port of ``align3d_tpu/io/geometry.py``;
reference ``src/io/geometry.rs``)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Geometry:
    """Host-side container for points/normals/colors/faces/texcoords.

    Arrays are numpy (host) — geometry I/O is a host concern; device arrays
    enter at the op boundary.
    """

    points: np.ndarray  # (N, 3) f32
    normals: np.ndarray | None = None  # (N, 3) f32
    colors: np.ndarray | None = None  # (N, 3) u8
    faces: np.ndarray | None = None  # (F, 3) int (triangles)
    texcoords: np.ndarray | None = None  # (N, 2) f32

    def len_vertices(self) -> int:
        return self.points.shape[0]

    def len_faces(self) -> int:
        return 0 if self.faces is None else self.faces.shape[0]
