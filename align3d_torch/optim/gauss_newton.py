"""Gauss-Newton normal equations (port of ``align3d_tpu/optim/gauss_newton.py``).

Residual blocks reduce at once: ``H = J^T W J`` and ``g = J^T W r``. The
6x6 solve runs in float64 as the reference does (``gaussnewton.rs:84-93``):
the JAX package replaces it with a preconditioned float32 Cholesky because a
TPU has no fast f64, but the card has, and the batched
``torch.linalg.cholesky_ex`` stays on the device without a host sync.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class GNSystem:
    """Accumulated normal equations: H (..., D, D), g (..., D) + residual stats."""

    hessian: torch.Tensor
    gradient: torch.Tensor
    squared_residual_sum: torch.Tensor
    count: torch.Tensor

    @classmethod
    def from_residuals(
        cls, jacobians: torch.Tensor, residuals: torch.Tensor, weights: torch.Tensor
    ) -> "GNSystem":
        """jacobians (..., N, D), residuals (..., N), weights (..., N)."""
        jw = jacobians * weights[..., None]
        hessian = torch.einsum("...nd,...ne->...de", jw, jacobians)
        gradient = torch.einsum("...nd,...n->...d", jw, residuals)
        sq = torch.sum(weights * residuals * residuals, dim=-1)
        count = torch.sum(weights, dim=-1)
        return cls(hessian, gradient, sq, count)

    def add(self, other: "GNSystem") -> "GNSystem":
        """Merge sub-accumulators (gaussnewton.rs:101-106)."""
        return GNSystem(
            self.hessian + other.hessian,
            self.gradient + other.gradient,
            self.squared_residual_sum + other.squared_residual_sum,
            self.count + other.count,
        )

    def weight(self, w: float) -> "GNSystem":
        """Scale (gaussnewton.rs:124-128): H by w^2, g and the residual sum
        by w; the count stays unscaled."""
        return GNSystem(self.hessian * (w * w), self.gradient * w, self.squared_residual_sum * w, self.count)

    def add_weighted(self, other: "GNSystem", w1: float, w2: float) -> "GNSystem":
        """Weighted merge (gaussnewton.rs:115-121): hessians by w^2, gradients
        and residual sums by w, counts unweighted."""
        return GNSystem(
            self.hessian * (w1 * w1) + other.hessian * (w2 * w2),
            self.gradient * w1 + other.gradient * w2,
            self.squared_residual_sum * w1 + other.squared_residual_sum * w2,
            self.count + other.count,
        )

    def mean_squared_residual(self) -> torch.Tensor:
        return self.squared_residual_sum / self.count

    def solve(self) -> torch.Tensor:
        """GN update in float64, returned as float32; zero for an empty system
        (the reference returns ``None`` there, gaussnewton.rs:85-87)."""
        low, _ = torch.linalg.cholesky_ex(self.hessian.double())
        update = torch.cholesky_solve(self.gradient.double().unsqueeze(-1), low).squeeze(-1)
        ok = (self.count > 0)[..., None]
        return torch.where(ok, update, 0.0).to(self.hessian.dtype)


def huber_weight(residuals: torch.Tensor, delta: float) -> torch.Tensor:
    """Huber IRLS weights (reference ``robust_estimator.rs``).

    ``scalar / tensor`` in PyTorch multiplies by the reciprocal, which rounds
    differently from a division; ``full_like`` keeps it a true division.
    """
    abs_r = torch.abs(residuals)
    return torch.where(abs_r <= delta, 1.0, torch.full_like(abs_r, delta) / torch.clamp(abs_r, min=1e-30))
