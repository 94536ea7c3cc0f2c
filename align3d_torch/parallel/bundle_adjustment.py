"""Bundle adjustment with Schur-complement reduction (port of
``align3d_tpu/parallel/bundle_adjustment.py``).

Poses ``T_i`` (camera-to-world), landmarks ``X_j`` (world points) and
observations ``o = (i, j, uv)`` are refined jointly by Gauss-Newton on

    sum_o w_o || project(K, T_i^{-1} X_j) - uv_o ||^2

(plus a depth residual where observations carry a measured depth, the
RGB-D case). Every observation touches one pose and one landmark, so the
normal equations have the classic structure

    [ Hpp  W  ] [dp]   [gp]        Hpp: (N, 6, 6) block-diagonal
    [ W^T  Hll] [dl] = [gl]        Hll: (M, 3, 3) block-diagonal
                                   W:   per-observation 6x3 fill-in

and the landmark block inverts per 3x3 block. The reduced (Schur) system
over the poses is

    S  = Hpp - W Hll^{-1} W^T          (6N, 6N)
    rhs = gp - W Hll^{-1} gl
    dl  = Hll^{-1} (gl - W^T dp)       (back-substitution)

Per-observation residuals and Jacobians come from forward-mode
differentiation (:func:`torch.func.jvp`) through the exact SE(3)
right-perturbation; ``Hpp``, ``Hll``, ``gp`` and ``gl`` are summed with
``index_add_``. ``"coo"`` keeps the fill-in per observation and solves the
reduced system with block-Jacobi PCG (O(O) work and memory); ``"dense"``
builds the (N, M, 6, 3) fill-in and the dense Schur complement and solves
it directly. Pose 0 is the gauge (fixed before the elimination), with
Levenberg damping on both diagonals.

Everything runs in float32 as in the JAX package but the dense Schur
solve, which runs in float64 (``torch.linalg.solve_ex``, no host sync) and
casts the pose update back to float32: the port's rule for dense
Gauss-Newton systems (:mod:`align3d_torch.optim.gauss_newton`); the JAX
package solves in float32 only because a TPU has no fast float64. The
``mesh=`` (sharded) form is not ported yet: ROADMAP Queue 1 item 4.
"""

from __future__ import annotations

import dataclasses

import torch

from align3d_torch.camera import CameraIntrinsics
from align3d_torch.optim.pcg import pcg
from align3d_torch.parallel.pose_graph import SHARDING_NOT_PORTED, _bmv, _segment_sum
from align3d_torch.se3 import Transform


@dataclasses.dataclass
class BAProblem:
    """Poses (batched Transform, camera-to-world), landmarks (M, 3) world
    points, and observations: ``obs_pose`` / ``obs_landmark`` (O,) int64
    ids, ``obs_uv`` (O, 2) pixel measurements, ``weights`` (O,); all on one
    device.

    ``obs_z`` (O,) adds each observation's measured camera-frame depth, the
    RGB-D case. Without it (reprojection only) the problem has a global
    scale freedom besides the pose-0 gauge whenever pose 0 sits at the
    origin; depth pins it. ``depth_weight`` converts the metric depth
    residual into pixel-comparable units.
    """

    poses: Transform
    landmarks: torch.Tensor
    obs_pose: torch.Tensor
    obs_landmark: torch.Tensor
    obs_uv: torch.Tensor
    weights: torch.Tensor
    intrinsics: CameraIntrinsics
    obs_z: torch.Tensor | None = None
    depth_weight: float = 100.0

    @property
    def n_poses(self) -> int:
        return int(self.poses.rotation.shape[0])

    @property
    def n_landmarks(self) -> int:
        return int(self.landmarks.shape[0])


def _obs_residual(twist, dx, t_cw: Transform, x, uvz, intrinsics: CameraIntrinsics, with_depth: bool,
                  depth_weight: float) -> torch.Tensor:
    """Per-observation residual (..., D): (u, v) reprojection, and with
    ``with_depth`` the weighted depth; ``twist`` (..., 6) and ``dx`` (..., 3)
    perturb the pose and the landmark, evaluated at 0."""
    t = t_cw @ Transform.exp(twist)
    p_cam = t.inverse().apply(x + dx)
    z = p_cam[..., 2]
    safe_z = torch.where(z == 0.0, 1e-12, z)
    u = p_cam[..., 0] * intrinsics.fx / safe_z + intrinsics.cx
    v = p_cam[..., 1] * intrinsics.fy / safe_z + intrinsics.cy
    if with_depth:
        return torch.stack([u - uvz[..., 0], v - uvz[..., 1], depth_weight * (z - uvz[..., 2])], dim=-1)
    return torch.stack([u - uvz[..., 0], v - uvz[..., 1]], dim=-1)


def _partials(poses: Transform, landmarks, obs_pose, obs_landmark, obs_uvz, weights, intrinsics, n: int, m: int,
              with_depth: bool = False, depth_weight: float = 100.0):
    """Normal-equation pieces: (hpp (N, 6, 6), hll (M, 3, 3), w_obs (O, 6, 3)
    per-observation fill-in blocks, gp (N, 6), gl (M, 3), sq (the weighted
    sum of squared residuals), cnt (observations of positive weight)).

    One forward-mode pass over 9 copies of the observations, copy k
    carrying the k-th basis tangent of (pose twist, landmark offset): its
    output tangent is column k of [jp | jl]."""
    t_cw = poses[obs_pose]
    x = landmarks[obs_landmark]
    o, device = obs_pose.shape[0], obs_pose.device
    eye = torch.eye(9, dtype=torch.float32, device=device)[:, None, :].expand(9, o, 9)
    zero6 = torch.zeros((9, o, 6), dtype=torch.float32, device=device)
    zero3 = torch.zeros((9, o, 3), dtype=torch.float32, device=device)

    def residual(twist, dx):
        return _obs_residual(twist, dx, t_cw, x, obs_uvz, intrinsics, with_depth, depth_weight)

    res, tangents = torch.func.jvp(residual, (zero6, zero3), (eye[..., :6], eye[..., 6:]))
    res = res[0]
    jac = tangents.permute(1, 2, 0)  # (O, D, 9)
    jp, jl = jac[..., :6], jac[..., 6:]
    w = weights[:, None, None]
    jpw, jlw = jp * w, jl * w
    hpp = _segment_sum(torch.einsum("odu,odw->ouw", jpw, jp), obs_pose, n)
    hll = _segment_sum(torch.einsum("odu,odw->ouw", jlw, jl), obs_landmark, m)
    w_obs = torch.einsum("odu,odw->ouw", jpw, jl)
    gp = _segment_sum(torch.einsum("odu,od->ou", jpw, res), obs_pose, n)
    gl = _segment_sum(torch.einsum("odu,od->ou", jlw, res), obs_landmark, m)
    sq = torch.sum(weights * torch.sum(res * res, dim=-1))
    cnt = torch.sum(weights > 0.0)
    return hpp, hll, w_obs, gp, gl, sq, cnt


def _densify_w(w_obs, obs_pose, obs_landmark, n: int, m: int) -> torch.Tensor:
    """Per-observation fill-in -> dense (N, M, 6, 3); repeated (pose,
    landmark) pairs add."""
    w_blk = torch.zeros((n, m, 6, 3), dtype=w_obs.dtype, device=w_obs.device)
    return w_blk.index_put_((obs_pose, obs_landmark), w_obs, accumulate=True)


def _gauge(hpp, gp):
    """Pose 0 fixed: identity Hessian block, zero gradient (copies)."""
    hpp, gp = hpp.clone(), gp.clone()
    hpp[0] = torch.eye(6, dtype=hpp.dtype, device=hpp.device)
    gp[0] = 0.0
    return hpp, gp


def _schur_solve_coo(hpp, hll, w_obs, obs_pose, obs_landmark, gp, gl, damping: float, cg_iters: int):
    """Schur-reduced solve with the fill-in kept per observation: every
    product with W or W^T is a gather, a batched product and an
    ``index_add_`` over the observations. The reduced pose system
    (matvec: S v = (Hpp + damping) v - W Hll^{-1} W^T v) is solved with
    block-Jacobi PCG. Returns (dp (N, 6), dl (M, 3))."""
    n, m = hpp.shape[0], hll.shape[0]
    eye3 = torch.eye(3, dtype=torch.float32, device=hll.device)
    hll_inv, _ = torch.linalg.inv_ex(hll + damping * eye3)
    # Gauge fix pose 0 before the elimination (as the dense path does).
    w_obs = torch.where((obs_pose == 0)[:, None, None], 0.0, w_obs)
    hpp, gp = _gauge(hpp, gp)
    w_obs_t = w_obs.transpose(-1, -2)

    def wt_v(v):  # W^T v: (N, 6) -> (M, 3)
        return _segment_sum(_bmv(w_obs_t, v.index_select(0, obs_pose)), obs_landmark, m)

    def w_z(z):  # W z: (M, 3) -> (N, 6)
        return _segment_sum(_bmv(w_obs, z.index_select(0, obs_landmark)), obs_pose, n)

    rhs = gp - w_z(_bmv(hll_inv, gl))
    hpp_damped = hpp + damping * torch.eye(6, dtype=torch.float32, device=hpp.device)
    minv, _ = torch.linalg.inv_ex(hpp_damped)

    def matvec(v):
        return _bmv(hpp_damped, v) - w_z(_bmv(hll_inv, wt_v(v)))

    dp = -pcg(matvec, lambda r: _bmv(minv, r), rhs, cg_iters)
    dl = -_bmv(hll_inv, gl + wt_v(dp))
    return dp, dl


def _schur_solve(hpp, hll, w_blk, gp, gl, damping: float):
    """Dense reduced-system solve: (dp (N, 6), dl (M, 3)) minimizing the
    damped GN quadratic (update = -H^{-1} g, pose 0 fixed); the (6N, 6N)
    Schur system is solved in float64."""
    n = hpp.shape[0]
    eye3 = torch.eye(3, dtype=torch.float32, device=hll.device)
    hll_inv, _ = torch.linalg.inv_ex(hll + damping * eye3)
    # Gauge fix pose 0 before the elimination: its coupling to the
    # landmarks must not flow through the Schur reduction.
    w_blk = w_blk.clone()
    w_blk[0] = 0.0
    hpp, gp = _gauge(hpp, gp)

    y = torch.einsum("nLuw,Lwx->nLux", w_blk, hll_inv)  # W Hll^{-1}
    s = -torch.einsum("nLux,mLvx->numv", y, w_blk)
    ar = torch.arange(n, device=hpp.device)
    # Two advanced indices split by a slice: their axis goes first, so
    # s[ar, :, ar, :] is (N, 6, 6), block k being s[k, :, k, :].
    s[ar, :, ar, :] += hpp
    rhs = gp - torch.einsum("nLux,Lx->nu", y, gl)
    s = s.reshape(n * 6, n * 6) + damping * torch.eye(n * 6, dtype=torch.float32, device=hpp.device)
    sol, _ = torch.linalg.solve_ex(s.double(), rhs.reshape(n * 6).double())
    dp = -sol.to(torch.float32).reshape(n, 6)
    wt_dp = torch.einsum("nLuw,nu->Lw", w_blk, dp)
    dl = -_bmv(hll_inv, gl) - _bmv(hll_inv, wt_dp)
    return dp, dl


def _obs_uvz(problem: BAProblem, with_depth: bool) -> torch.Tensor:
    z = problem.obs_z[:, None] if with_depth else torch.zeros_like(problem.obs_uv[:, :1])
    return torch.cat([problem.obs_uv, z], dim=1)


def optimize(
    problem: BAProblem,
    iterations: int = 10,
    damping: float = 1e-4,
    mesh=None,
    solver: str = "auto",
    cg_iters: int = 64,
) -> tuple[Transform, torch.Tensor]:
    """Gauss-Newton BA; returns (refined poses, refined landmarks).

    ``solver``: ``"dense"`` builds the (N, M, 6, 3) fill-in and the exact
    dense Schur complement (small problems); ``"coo"`` keeps per-observation
    blocks and solves the reduced pose system with ``cg_iters`` trips of
    PCG, O(O) memory; ``"auto"`` is dense when N * M <= 1,000,000. ``mesh``
    must be None: the sharded solve is not ported yet (ROADMAP Queue 1
    item 4).
    """
    if mesh is not None:
        raise NotImplementedError(SHARDING_NOT_PORTED)
    n, m = problem.n_poses, problem.n_landmarks
    if solver == "auto":
        solver = "dense" if n * m <= 1_000_000 else "coo"
    if solver not in ("dense", "coo"):
        raise ValueError(f"solver must be 'auto', 'dense' or 'coo', got {solver!r}")
    with_depth = problem.obs_z is not None
    obs_uvz = _obs_uvz(problem, with_depth)
    op, ol = problem.obs_pose, problem.obs_landmark
    poses, landmarks = problem.poses, problem.landmarks
    for _ in range(iterations):
        hpp, hll, w_obs, gp, gl, _, _ = _partials(poses, landmarks, op, ol, obs_uvz, problem.weights,
                                                  problem.intrinsics, n, m, with_depth, problem.depth_weight)
        if solver == "dense":
            dp, dl = _schur_solve(hpp, hll, _densify_w(w_obs, op, ol, n, m), gp, gl, damping)
        else:
            dp, dl = _schur_solve_coo(hpp, hll, w_obs, op, ol, gp, gl, damping, cg_iters)
        poses, landmarks = poses @ Transform.exp(dp), landmarks + dl
    return poses, landmarks


def mean_reprojection_error(problem: BAProblem) -> torch.Tensor:
    """Weighted RMS pixel reprojection error of the current estimate (the
    uv residual only: depth residuals are left out, so the number stays in
    pixels whatever ``depth_weight`` is)."""
    o = problem.obs_pose.shape[0]
    zero6 = torch.zeros((o, 6), dtype=torch.float32, device=problem.obs_pose.device)
    res = _obs_residual(zero6, zero6[:, :3], problem.poses[problem.obs_pose], problem.landmarks[problem.obs_landmark],
                        _obs_uvz(problem, False), problem.intrinsics, False, problem.depth_weight)
    sq = torch.sum(problem.weights * torch.sum(res * res, dim=-1))
    cnt = torch.sum(problem.weights > 0.0)
    return torch.sqrt(sq / torch.clamp(cnt, min=1))
