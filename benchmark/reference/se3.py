"""Reference rigid transforms as (rotation (..., 3, 3), translation (..., 3))
float32 pairs: the se(3) exponential with the Rust reference's Taylor
switch points, and composition as elementwise products summed in order
(the same bits in any batch)."""

from __future__ import annotations

import torch

EPSILON = 1e-8


def _skew(v: torch.Tensor) -> torch.Tensor:
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
                        torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
                        torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1)], dim=-2)


def _mv(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    return (mat @ vec.unsqueeze(-1)).squeeze(-1)


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def quat_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    norm_sq = w * w + x * x + y * y + z * z
    s = torch.full_like(norm_sq, 2.0) / torch.clamp(norm_sq, min=torch.finfo(quat.dtype).tiny)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack([torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
                        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
                        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1)], dim=-2)


def exp(twist: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """se(3) exponential of [v, omega] (..., 6) -> (R, t)."""
    twist = twist.to(torch.float32)
    v, omega = twist[..., :3], twist[..., 3:]
    theta_sq = torch.sum(omega * omega, dim=-1)
    small_q = theta_sq < EPSILON * EPSILON
    theta = torch.sqrt(torch.where(small_q, 1.0, theta_sq))
    theta_po4 = theta_sq * theta_sq
    imag = torch.where(small_q, 0.5 - (1.0 / 48.0) * theta_sq + (1.0 / 3840.0) * theta_po4,
                       torch.sin(0.5 * theta) / theta)
    real = torch.where(small_q, 1.0 - (1.0 / 8.0) * theta_sq + (1.0 / 384.0) * theta_po4, torch.cos(0.5 * theta))
    rot = quat_to_matrix(torch.cat([real[..., None], imag[..., None] * omega], dim=-1))
    big = _skew(omega)
    big_sq = big @ big
    small_j = (theta_sq < EPSILON)[..., None, None]
    eye = torch.eye(3, dtype=twist.dtype, device=twist.device).expand(big.shape)
    safe_sq = torch.where(theta_sq < EPSILON, 1.0, theta_sq)[..., None, None]
    safe = torch.where(theta_sq < EPSILON, 1.0, theta)[..., None, None]
    jac = torch.where(small_j, eye + 0.5 * big,
                      eye + (1.0 - torch.cos(safe)) / safe_sq * big + (safe - torch.sin(safe)) / (safe_sq * safe) * big_sq)
    return rot, _mv(jac, v)


def compose(a: tuple, b: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """a @ b: b applied first."""
    return _matmul3(a[0], b[0]), _matmul3(a[0], b[1][..., None])[..., 0] + a[1]


def identity(batch: tuple, device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.eye(3, dtype=torch.float32, device=device).expand(*batch, 3, 3).clone(),
            torch.zeros(*batch, 3, dtype=torch.float32, device=device))
