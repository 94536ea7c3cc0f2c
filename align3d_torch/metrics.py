"""Trajectory error metrics (port of ``align3d_tpu/metrics.py``).

The reference's mean trajectory error (elementwise mean of the angle and
translation of ``lhs^-1 @ rhs``, ``src/metrics.rs``), plus ATE-RMSE and RPE.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from align3d_torch.se3 import Transform
from align3d_torch.trajectory import Trajectory


@dataclasses.dataclass
class TransformMetrics:
    """Angle (radians) + translation-norm difference of two transforms."""

    angle: torch.Tensor
    translation: torch.Tensor

    @classmethod
    def new(cls, lhs: Transform, rhs: Transform) -> "TransformMetrics":
        """Metrics of ``lhs^-1 @ rhs`` (src/metrics.rs:23-31)."""
        diff = lhs.inverse() @ rhs
        return cls(angle=diff.angle(), translation=torch.linalg.norm(diff.translation, dim=-1))

    @classmethod
    def mean_trajectory_error(cls, pred: Trajectory, gt: Trajectory) -> "TransformMetrics":
        """Elementwise mean over aligned trajectories (src/metrics.rs:33-52)."""
        if len(pred) != len(gt):
            raise ValueError("Pred and GT trajectories have different lengths.")
        m = cls.new(pred.camera_to_world, gt.camera_to_world)
        return cls(angle=torch.mean(m.angle), translation=torch.mean(m.translation))

    def total(self) -> torch.Tensor:
        return self.angle + self.translation

    def __str__(self) -> str:
        return f"angle: {math.degrees(float(self.angle)):.2f}°, translation: {float(self.translation):.5f}"


def _rmse(diff: Transform) -> tuple[torch.Tensor, torch.Tensor]:
    rot_err = diff.angle()
    t_err = torch.linalg.norm(diff.translation, dim=-1)
    return torch.sqrt(torch.mean(rot_err**2)), torch.sqrt(torch.mean(t_err**2))


def ate_rmse(pred: Trajectory, gt: Trajectory) -> tuple[torch.Tensor, torch.Tensor]:
    """Absolute trajectory error RMSE (rotation rad, translation), no alignment."""
    return _rmse(pred.camera_to_world.inverse() @ gt.camera_to_world)


def rpe(pred: Trajectory, gt: Trajectory, delta: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Relative pose error over frame offset ``delta`` (RMSE rot/trans)."""
    n = len(pred)
    if n <= delta:
        raise ValueError("trajectory too short for requested delta")
    p, g = pred.camera_to_world, gt.camera_to_world
    p_rel = p[: n - delta].inverse() @ p[delta:]
    g_rel = g[: n - delta].inverse() @ g[delta:]
    return _rmse(p_rel.inverse() @ g_rel)
