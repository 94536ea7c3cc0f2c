"""SE(3) rigid transforms as batched tensors (port of ``align3d_tpu/se3.py``).

A ``Transform`` stores a rotation matrix ``(..., 3, 3)`` and a translation
``(..., 3)``; leading axes broadcast through every op, so a trajectory is one
``Transform`` with a leading frame axis. The se(3) exponential keeps the
reference's Taylor switch points (quaternion factors at
``theta_sq < EPSILON**2``, the left Jacobian at ``theta_sq < EPSILON``) so
small-angle updates match the JAX package and the Rust reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_EPSILON = 1e-8
_F32 = torch.float32


def _skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix of ``v``: (..., 3) -> (..., 3, 3)."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def _mv(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product ``...ij,...j->...i``."""
    return (mat @ vec.unsqueeze(-1)).squeeze(-1)


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for (..., 3, 3) by (..., 3, k) as one elementwise product and
    one sum over its 3 terms, which each output adds up alone, in order. A
    batched GEMM picks its kernel, and so its rounding, by the batch size;
    this form gives a pose the same bits in any batch."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def quat_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) quaternion (..., 4) -> rotation (..., 3, 3), normalizing."""
    w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    norm_sq = w * w + x * x + y * y + z * z
    s = torch.full_like(norm_sq, 2.0) / torch.clamp(norm_sq, min=torch.finfo(quat.dtype).tiny)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack(
        [
            torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
            torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
            torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> (w, x, y, z) quaternion with w >= 0.

    Branchless Shepperd extraction: all four candidates, the best-conditioned
    one selected by its pivot (the JAX package's form, kept for parity).
    """
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]

    def build(t, a, b, c, d):
        s = torch.sqrt(torch.clamp(t, min=1e-24))
        return torch.stack([a / s, b / s, c / s, d / s], dim=-1) * 0.5, t

    qw, tw = build(1.0 + m00 + m11 + m22, 1.0 + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01)
    qx, tx = build(1.0 + m00 - m11 - m22, m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20)
    qy, ty = build(1.0 - m00 + m11 - m22, m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21)
    qz, tz = build(1.0 - m00 - m11 + m22, m10 - m01, m20 + m02, m12 + m21, 1.0 - m00 - m11 + m22)

    cand = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4, 4)
    pivots = torch.stack([tw, tx, ty, tz], dim=-1)
    idx = torch.argmax(pivots, dim=-1)
    quat = torch.gather(cand, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    return torch.where(quat[..., :1] < 0, -quat, quat)


@dataclasses.dataclass(frozen=True)
class Transform:
    """A (batch of) rigid transform(s): ``x -> rotation @ x + translation``."""

    rotation: torch.Tensor
    translation: torch.Tensor

    # -- constructors ----------------------------------------------------
    @classmethod
    def identity(cls, batch_shape: tuple = (), device=None, dtype=_F32) -> "Transform":
        rot = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3).clone()
        return cls(rot, torch.zeros(*batch_shape, 3, dtype=dtype, device=device))

    @classmethod
    def from_quat(cls, translation, quat_wxyz) -> "Transform":
        translation = torch.as_tensor(translation, dtype=_F32)
        quat_wxyz = torch.as_tensor(quat_wxyz, dtype=_F32)
        return cls(quat_to_matrix(quat_wxyz), translation)

    @classmethod
    def from_matrix4(cls, matrix) -> "Transform":
        """From a homogeneous (..., 4, 4) matrix, re-orthonormalized through
        a quaternion round trip like the reference's ``Rotation3::from_matrix``."""
        if not isinstance(matrix, torch.Tensor):
            matrix = torch.from_numpy(np.array(matrix, dtype=np.float32))
        matrix = matrix.to(_F32)
        rot = quat_to_matrix(matrix_to_quat(matrix[..., :3, :3]))
        return cls(rot, matrix[..., :3, 3].clone())

    @classmethod
    def exp(cls, twist: torch.Tensor) -> "Transform":
        """se(3) exponential of ``[vx, vy, vz, wx, wy, wz]`` (..., 6)."""
        twist = twist.to(_F32)
        v, omega = twist[..., :3], twist[..., 3:]
        theta_sq = torch.sum(omega * omega, dim=-1)

        small_q = theta_sq < _EPSILON * _EPSILON
        theta = torch.sqrt(torch.where(small_q, 1.0, theta_sq))
        theta_po4 = theta_sq * theta_sq
        imag = torch.where(
            small_q,
            0.5 - (1.0 / 48.0) * theta_sq + (1.0 / 3840.0) * theta_po4,
            torch.sin(0.5 * theta) / theta,
        )
        real = torch.where(
            small_q,
            1.0 - (1.0 / 8.0) * theta_sq + (1.0 / 384.0) * theta_po4,
            torch.cos(0.5 * theta),
        )
        rot = quat_to_matrix(torch.cat([real[..., None], imag[..., None] * omega], dim=-1))

        big_omega = _skew(omega)
        big_omega_sq = big_omega @ big_omega
        small_j = (theta_sq < _EPSILON)[..., None, None]
        eye = torch.eye(3, dtype=twist.dtype, device=twist.device).expand(big_omega.shape)
        safe_theta_sq = torch.where(theta_sq < _EPSILON, 1.0, theta_sq)[..., None, None]
        safe_theta = torch.where(theta_sq < _EPSILON, 1.0, theta)[..., None, None]
        v_jac_large = (
            eye
            + (1.0 - torch.cos(safe_theta)) / safe_theta_sq * big_omega
            + (safe_theta - torch.sin(safe_theta)) / (safe_theta_sq * safe_theta) * big_omega_sq
        )
        v_jac_small = eye + 0.5 * big_omega
        v_jac = torch.where(small_j, v_jac_small, v_jac_large)
        return cls(rot, _mv(v_jac, v))

    def log(self) -> torch.Tensor:
        """se(3) logarithm ``[v, omega]`` with ``exp(T.log()) == T``."""
        rot = self.rotation
        trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
        cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
        small = cos_theta > 1.0 - 1e-6
        safe_cos = torch.where(small, 0.0, cos_theta)
        theta = torch.where(small, 0.0, torch.arccos(safe_cos))
        one_m_cos = 1.0 - cos_theta
        theta_sq = torch.where(small, 2.0 * one_m_cos * (1.0 + one_m_cos / 6.0), theta * theta)
        sin_theta = torch.sin(torch.where(small, 1.0, theta))
        factor = torch.where(small, 0.5 + theta_sq / 12.0, theta / (2.0 * sin_theta))
        skew = rot - rot.transpose(-1, -2)
        omega = factor[..., None] * torch.stack(
            [skew[..., 2, 1], skew[..., 0, 2], skew[..., 1, 0]], dim=-1
        )
        big_omega = _skew(omega)
        big_omega_sq = big_omega @ big_omega
        eye = torch.eye(3, dtype=rot.dtype, device=rot.device).expand(rot.shape)
        safe_theta = torch.where(small, 1.0, theta)
        safe_theta_sq = torch.where(small, 1.0, theta_sq)
        coef = torch.where(
            small,
            1.0 / 12.0 + theta_sq / 720.0,
            (1.0 - 0.5 * safe_theta * torch.cos(0.5 * safe_theta) / torch.sin(0.5 * safe_theta))
            / safe_theta_sq,
        )
        v_inv = eye - 0.5 * big_omega + coef[..., None, None] * big_omega_sq
        return torch.cat([_mv(v_inv, self.translation), omega], dim=-1)

    # -- core ops --------------------------------------------------------
    def compose(self, other: "Transform") -> "Transform":
        """``self @ other`` — ``other`` is applied first. Batch-invariant: a
        pose composed in a batch has the bits it has composed alone."""
        return Transform(
            _matmul3(self.rotation, other.rotation),
            _matmul3(self.rotation, other.translation[..., None])[..., 0] + self.translation,
        )

    def __matmul__(self, other: "Transform") -> "Transform":
        return self.compose(other)

    def inverse(self) -> "Transform":
        rot_t = self.rotation.transpose(-1, -2)
        return Transform(rot_t, -_mv(rot_t, self.translation))

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """Transform points ``(..., N, 3)`` or ``(..., 3)``."""
        if points.ndim >= 2 and self.rotation.ndim == 2:
            return points @ self.rotation.T + self.translation
        return _mv(self.rotation, points) + self.translation

    def apply_normals(self, normals: torch.Tensor) -> torch.Tensor:
        """Rotate-only transform for normals (src/transform.rs:151)."""
        if normals.ndim >= 2 and self.rotation.ndim == 2:
            return normals @ self.rotation.T
        return _mv(self.rotation, normals)

    # -- conversions / metrics ------------------------------------------
    def to_matrix4(self) -> torch.Tensor:
        batch = self.rotation.shape[:-2]
        mat = torch.zeros(*batch, 4, 4, dtype=self.rotation.dtype, device=self.rotation.device)
        mat[..., :3, :3] = self.rotation
        mat[..., :3, 3] = self.translation
        mat[..., 3, 3] = 1.0
        return mat

    def to_quat(self) -> torch.Tensor:
        return matrix_to_quat(self.rotation)

    def angle(self) -> torch.Tensor:
        """Rotation angle in radians."""
        quat = self.to_quat()
        return 2.0 * torch.atan2(torch.linalg.norm(quat[..., 1:], dim=-1), torch.abs(quat[..., 0]))

    def to(self, device) -> "Transform":
        return Transform(self.rotation.to(device), self.translation.to(device))

    @property
    def device(self) -> torch.device:
        return self.rotation.device

    def __getitem__(self, idx) -> "Transform":
        return Transform(self.rotation[idx], self.translation[idx])


def stack(transforms: list[Transform]) -> Transform:
    """Stack scalar transforms along a new axis 0."""
    return Transform(
        torch.stack([t.rotation for t in transforms], dim=0),
        torch.stack([t.translation for t in transforms], dim=0),
    )
