"""Gauss-Newton normal equations (port of ``align3d_tpu/optim/gauss_newton.py``).

Residual blocks reduce at once: ``H = J^T W J`` and ``g = J^T W r``. The
6x6 solve runs in float64 as the reference does (``gaussnewton.rs:84-93``):
the JAX package replaces it with a preconditioned float32 Cholesky because a
TPU has no fast f64, but the card has, and the batched
``torch.linalg.cholesky_ex`` stays on the device without a host sync.

:func:`gn_update` is what the image ICP loop does with a GN iteration's two
systems: merge, solve, SE(3) update and best-pose select. On a CUDA tensor it
is one launch of K11 (``csrc/gn_update.cu``); on a CPU tensor its plain twin
:func:`gn_update_plain`.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from align3d_torch import _kernels
from align3d_torch.se3 import Transform


@dataclasses.dataclass
class GNSystem:
    """Accumulated normal equations: H (..., D, D), g (..., D) + residual stats."""

    hessian: torch.Tensor
    gradient: torch.Tensor
    squared_residual_sum: torch.Tensor
    count: torch.Tensor

    @classmethod
    def from_aug(cls, aug: torch.Tensor) -> "GNSystem":
        """From the 8x8 augmented block ``[[H, g], [g^T, sum w r^2]]`` with
        the count at [7, 7] (leading batch dims pass through)."""
        return cls(aug[..., 0:6, 0:6], aug[..., 0:6, 6], aug[..., 6, 6], aug[..., 7, 7])

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


@dataclasses.dataclass
class GNState:
    """The image ICP loop's state for B pairs, float32 and contiguous: the
    pose the next step reads, (B, 3, 3) and (B, 3), and the best pose so far
    with its mean squared residual (B,). :func:`gn_update` writes it in place.
    Checked once, here, since K11 addresses it without a further check."""

    rot: torch.Tensor
    trans: torch.Tensor
    best_res: torch.Tensor
    best_rot: torch.Tensor
    best_trans: torch.Tensor

    def __post_init__(self):
        bsz, dev = self.rot.shape[0], self.rot.device
        for name, shape in (("rot", (bsz, 3, 3)), ("trans", (bsz, 3)), ("best_res", (bsz,)),
                            ("best_rot", (bsz, 3, 3)), ("best_trans", (bsz, 3))):
            _kernels.check_tensor(getattr(self, name), name, shape, torch.float32, dev)

    @classmethod
    def start(cls, rot: torch.Tensor, trans: torch.Tensor) -> "GNState":
        """From the initial poses (copied); no best residual yet (inf)."""
        rot, trans = (t.to(torch.float32).clone(memory_format=torch.contiguous_format) for t in (rot, trans))
        best_res = torch.full(rot.shape[:1], torch.inf, dtype=torch.float32, device=rot.device)
        return cls(rot, trans, best_res, rot.clone(), trans.clone())


def gn_update_plain(geom_aug: torch.Tensor, color_aug: torch.Tensor, w1: float, w2: float, state: GNState) -> None:
    """K11's plain twin: merge the (B, 8, 8) geometric and colour blocks
    (:meth:`GNSystem.add_weighted`), read the mean squared residual, solve in
    float64, apply ``exp(update) @ pose`` and keep the pose if its residual is
    strictly below the best (a tie keeps the earlier pose, NaN never wins)."""
    merged = GNSystem.from_aug(geom_aug).add_weighted(GNSystem.from_aug(color_aug), w1, w2)
    residual = merged.mean_squared_residual()
    new = Transform.exp(merged.solve()) @ Transform(state.rot, state.trans)
    better = residual < state.best_res
    state.best_res.copy_(torch.where(better, residual, state.best_res))
    state.best_rot.copy_(torch.where(better[:, None, None], new.rotation, state.best_rot))
    state.best_trans.copy_(torch.where(better[:, None], new.translation, state.best_trans))
    state.rot.copy_(new.rotation)
    state.trans.copy_(new.translation)


def _check_blocks(geom_aug: torch.Tensor, color_aug: torch.Tensor, bsz: int, device: torch.device) -> int:
    """The pair stride (in floats) the two blocks share; raises unless each
    is a (B, 8, 8) float32 view on ``device`` with rows of 8 contiguous floats."""
    for name, t in (("geom_aug", geom_aug), ("color_aug", color_aug)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} has dtype {t.dtype}, expected torch.float32")
        if tuple(t.shape) != (bsz, 8, 8):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(bsz, 8, 8)}")
        if t.stride(1) != 8 or t.stride(2) != 1:
            raise ValueError(f"{name} must have rows of 8 contiguous floats, got strides {t.stride()}")
    if bsz > 1 and (geom_aug.stride(0) != color_aug.stride(0) or geom_aug.stride(0) < 64):
        raise ValueError(f"the blocks need one pair stride of at least 64, got {geom_aug.stride(0)} and "
                         f"{color_aug.stride(0)}")
    return geom_aug.stride(0)


def gn_update(geom_aug: torch.Tensor, color_aug: torch.Tensor, w1: float, w2: float, state: GNState) -> None:
    """One GN iteration after its step, for B pairs, ``state`` updated in
    place: on a CUDA tensor one launch of K11 (no host sync), on a CPU tensor
    :func:`gn_update_plain`. ``w1``, ``w2``: the float32 weights of the
    geometric and colour systems."""
    dev = state.rot.device
    if dev.type == "cpu":
        gn_update_plain(geom_aug, color_aug, w1, w2, state)
        return
    if dev.type != "cuda":
        raise ValueError(f"gn_update runs on cuda or cpu tensors, got {dev}")
    bsz = state.rot.shape[0]
    stride = _check_blocks(geom_aug, color_aug, bsz, dev)
    _kernels.launch(
        "K11", geom_aug.data_ptr(), color_aug.data_ptr(), stride, bsz,
        float(np.float32(w1 * w1)), float(np.float32(w2 * w2)), w1, w2,
        state.rot.data_ptr(), state.trans.data_ptr(), state.best_res.data_ptr(), state.best_rot.data_ptr(),
        state.best_trans.data_ptr(), ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )


def huber_weight(residuals: torch.Tensor, delta: float) -> torch.Tensor:
    """Huber IRLS weights (reference ``robust_estimator.rs``).

    ``scalar / tensor`` in PyTorch multiplies by the reciprocal, which rounds
    differently from a division; ``full_like`` keeps it a true division.
    """
    abs_r = torch.abs(residuals)
    return torch.where(abs_r <= delta, 1.0, torch.full_like(abs_r, delta) / torch.clamp(abs_r, min=1e-30))
