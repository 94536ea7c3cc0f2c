"""Virtual camera math (port of ``align3d_tpu/viz/virtual_camera.py``;
reference ``src/viz/virtual_camera.rs`` and ``src/viz/virtual_projection.rs``).

Host numpy float32, the JAX package's arithmetic line for line, so the
framing of every render is bitwise the reference's for the same sphere."""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from align3d_torch.viz.sphere import Sphere3D


@dataclasses.dataclass
class PerspectiveProjection:
    """Symmetric perspective frustum (virtual_projection.rs:17-64)."""

    fov_y: float = math.pi / 2.0
    aspect_ratio: float = 4.0 / 3.0
    near_plane: float = 0.1
    far_plane: float = 100.0

    def matrix(self) -> np.ndarray:
        top = math.tan(self.fov_y / 2.0) * self.near_plane
        bottom = -top
        right = top * self.aspect_ratio
        left = -right
        near, far = self.near_plane, self.far_plane
        m = np.zeros((4, 4), np.float32)
        m[0, 0] = 2.0 * near / (right - left)
        m[0, 2] = (right + left) / (right - left)
        m[1, 1] = 2.0 * near / (top - bottom)
        m[1, 2] = (top + bottom) / (top - bottom)
        m[2, 2] = -(far + near) / (far - near)
        m[2, 3] = -(2.0 * far * near) / (far - near)
        m[3, 2] = -1.0
        return m


@dataclasses.dataclass
class VirtualCamera:
    """Eye/view/up camera (virtual_camera.rs:11-69)."""

    eye: np.ndarray  # (3,)
    view: np.ndarray  # (3,) unit, toward the scene
    up: np.ndarray  # (3,) unit
    projection: PerspectiveProjection = dataclasses.field(
        default_factory=PerspectiveProjection
    )

    def view_matrix(self) -> np.ndarray:
        """World -> camera (right-handed look-at, -Z forward)."""
        f = self.view / np.linalg.norm(self.view)
        r = np.cross(f, self.up)
        r = r / np.linalg.norm(r)
        u = np.cross(r, f)
        m = np.eye(4, dtype=np.float32)
        m[0, :3] = r
        m[1, :3] = u
        m[2, :3] = -f
        m[:3, 3] = -(m[:3, :3] @ self.eye)
        return m

    def view_projection(self) -> np.ndarray:
        return self.projection.matrix() @ self.view_matrix()

    # -- movement (virtual_camera.rs:30-69; drives interactive controls) --
    def translate_eye(self, amount: float) -> None:
        self.eye = self.eye + self.view * amount

    def translate_right(self, amount: float) -> None:
        right = np.cross(self.view, self.up)
        self.eye = self.eye + right / np.linalg.norm(right) * amount

    def rotate_right_axis(self, rad: float) -> None:
        right = np.cross(self.view, self.up)
        right /= np.linalg.norm(right)
        c, s = math.cos(rad), math.sin(rad)
        k = right
        v = self.view
        self.view = (
            v * c + np.cross(k, v) * s + k * float(k @ v) * (1.0 - c)
        )

    def rotate_up_axis(self, rad: float) -> None:
        """Rotate the view direction about ``up`` (virtual_camera.rs:50-56),
        renormalized as the reference does."""
        c, s = math.cos(rad), math.sin(rad)
        k = self.up / np.linalg.norm(self.up)
        v = self.view
        v = v * c + np.cross(k, v) * s + k * float(k @ v) * (1.0 - c)
        self.view = v / np.linalg.norm(v)


@dataclasses.dataclass
class VirtualCameraSphericalBuilder:
    """Spherical-coordinate camera builder (virtual_camera.rs:71-183)."""

    sphere: Sphere3D = dataclasses.field(default_factory=Sphere3D.empty)
    azimuth: float = 0.0
    elevation: float = 0.0
    distance: float = 1.0
    fov_y: float = math.pi / 2.0
    aspect_ratio: float = 4.0 / 3.0
    near_plane_distance: float = 0.1
    far_plane_distance: float = 100.0

    @classmethod
    def fit(cls, sphere: Sphere3D, fov_y: float = math.pi / 2.0) -> "VirtualCameraSphericalBuilder":
        """Distance so the bounding sphere exactly fills fov_y
        (virtual_camera.rs:100-121)."""
        if sphere.is_empty:
            raise ValueError("Cannot fit empty sphere.")
        half = fov_y / 2.0
        alpha = half
        theta = math.pi / 2.0 - half
        distance = math.cos(alpha) * (
            (math.sin(theta) * sphere.radius) / math.sin(alpha)
        ) + math.cos(theta) * sphere.radius
        near = distance - sphere.radius
        return cls(
            sphere=sphere,
            distance=distance,
            fov_y=half,
            near_plane_distance=near,
        )

    def build(self) -> VirtualCamera:
        """virtual_camera.rs:158-183 (including the 1.5*pi azimuth offset)."""
        theta = self.elevation
        phi = self.azimuth + math.pi * 1.5
        position = (
            np.array(
                [
                    math.cos(phi) * self.distance * math.cos(theta),
                    math.sin(theta) * self.distance,
                    math.sin(phi) * self.distance * math.cos(theta),
                ],
                np.float32,
            )
            + self.sphere.center
        )
        view = self.sphere.center - position
        view = view / np.linalg.norm(view)
        right = np.cross(view, np.array([0.0, -1.0, 0.0], np.float32))
        right = right / np.linalg.norm(right)
        up = np.cross(right, view)
        up = up / np.linalg.norm(up)
        return VirtualCamera(
            eye=position,
            view=view,
            up=up,
            projection=PerspectiveProjection(
                fov_y=self.fov_y,
                aspect_ratio=self.aspect_ratio,
                near_plane=self.near_plane_distance,
                far_plane=self.far_plane_distance,
            ),
        )
