"""Preconditioned conjugate gradient with a fixed trip count (port of
``align3d_tpu/optim/pcg.py``).

Shared by the pose-graph and bundle-adjustment solvers
(:mod:`align3d_torch.parallel.pose_graph`, :mod:`.bundle_adjustment`). The
loop runs exactly ``iters`` trips, the counterpart of JAX's ``fori_loop``;
once the preconditioned residual norm falls to ``tol`` (or the curvature
``p.Hp`` is no longer positive) the trips freeze through masking. Nothing in
the loop reads a value back to the host: no ``.item()``, no Python branch on
a tensor, no early exit, so on the card the trips only enqueue work.
"""

from __future__ import annotations

import torch


def pcg(matvec, precond, b: torch.Tensor, iters: int, tol: float = 1e-10) -> torch.Tensor:
    """Solve ``matvec(x) = b``; returns x after ``iters`` masked CG trips."""
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(iters):
        hp = matvec(p)
        denom = torch.sum(p * hp)
        live = (rz > tol) & (denom > 0.0)
        alpha = torch.where(live, rz / torch.where(denom == 0.0, 1.0, denom), 0.0)
        x = x + alpha * p
        r = r - alpha * hp
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(live, rz_new / torch.where(rz == 0.0, 1.0, rz), 0.0)
        p = torch.where(live, z + beta * p, p)
        rz = torch.where(live, rz_new, rz)
    return x
