"""Pose-graph optimization (port of ``align3d_tpu/parallel/pose_graph.py``).

A pose graph has N keyframe poses and E relative-pose constraints (odometry
edges i -> i+1 plus loop closures). Gauss-Newton minimizes

    sum_e w_e || log( Z_e^{-1} * T_i^{-1} * T_j ) ||^2

over all poses, with pose 0 gauge-fixed. Each edge contributes a 6x6 block
pair (d r / d xi_i, d r / d xi_j) of the right-perturbation residual, taken
by forward-mode differentiation (:func:`torch.func.jvp`) through the exact
SE(3) exponential and logarithm of :mod:`align3d_torch.se3`.

Both solvers start from one block-sparse assembly (per-pose diagonal blocks
summed with ``index_add_``, per-edge off-diagonal blocks): ``"cg"`` runs
block-Jacobi preconditioned CG on it (O(E) per matvec, the long-sequence
path); ``"dense"`` scatters it into the (6N, 6N) system and solves it
directly. Residuals, Jacobians, the assembly, the block inverses and PCG
run in float32 as in the JAX package; the dense solve runs in float64
(``torch.linalg.solve_ex``, no host sync) and its update is cast back to
float32, the port's rule for dense Gauss-Newton systems
(:mod:`align3d_torch.optim.gauss_newton`). The JAX package solves in
float32 only because a TPU has no fast float64.

Loop-closure candidates (:func:`propose_loop_closures`) follow the
pose-distance heuristic on the host; measuring them is the caller's job
(:func:`align3d_torch.odometry.refine_with_loop_closures`).

Sharding (``mesh=``, a 1-D mesh of W ranks): every rank holds the whole
graph; the edges are padded to a multiple of W with zero-weight copies of
the last edge (the JAX package's padding, which adds nothing to any sum)
and rank r takes the r-th contiguous block. Each Gauss-Newton iteration
builds the block system of the rank's edges and all-reduces the diagonal
blocks and the gradient (one packed ``all_reduce``); damping and the
gauge are applied once, after it (applied per shard they would count W
times). The CG solver keeps the off-diagonal blocks on their shard: each
PCG trip all-reduces the shard's off-diagonal products, one collective a
trip and still no host sync. The dense solver all-reduces the assembled
off-diagonal part of the (6N, 6N) system. The solve runs replicated, so
every rank returns the same poses.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from align3d_torch.optim.pcg import pcg
from align3d_torch.parallel import collectives as col
from align3d_torch.se3 import Transform
from align3d_torch.trajectory import Trajectory


@dataclasses.dataclass
class PoseGraph:
    """Nodes (batched Transform), edges (E, 2) int64, measurements (batched
    Transform, one per edge: the expected T_i^{-1} T_j), weights (E,); all
    on one device."""

    nodes: Transform
    edges: torch.Tensor
    measurements: Transform
    weights: torch.Tensor

    @classmethod
    def from_trajectory(cls, traj: Trajectory) -> "PoseGraph":
        """Odometry chain: consecutive relative-pose edges."""
        poses = traj.camera_to_world
        n = len(traj)
        idx = torch.arange(n - 1, device=poses.device)
        edges = torch.stack([idx, idx + 1], dim=1)
        meas = poses[:-1].inverse() @ poses[1:]
        return cls(poses, edges, meas, torch.ones(n - 1, dtype=torch.float32, device=poses.device))

    def with_edge(self, i: int, j: int, measurement: Transform, weight: float = 1.0) -> "PoseGraph":
        device = self.edges.device
        edges = torch.cat([self.edges, torch.tensor([[i, j]], dtype=self.edges.dtype, device=device)])
        meas = Transform(
            torch.cat([self.measurements.rotation, measurement.rotation.to(device)[None]]),
            torch.cat([self.measurements.translation, measurement.translation.to(device)[None]]),
        )
        weights = torch.cat([self.weights, torch.tensor([weight], dtype=torch.float32, device=device)])
        return PoseGraph(self.nodes, edges, meas, weights)


def propose_loop_closures(
    traj: Trajectory,
    min_separation: int = 10,
    max_translation: float = 0.5,
    max_candidates: int = 32,
    row_chunk: int = 256,
) -> np.ndarray:
    """Pose-distance loop-closure candidates: frame pairs far in time but
    near in space, ranked by spatial distance (closest first), so that
    truncation to ``max_candidates`` keeps the most promising pairs.
    Returns a (K, 2) int64 host array.

    Rows are scanned in chunks of ``row_chunk`` and each chunk is cut to its
    own stable top-K before the global stable sort: memory stays
    O(row_chunk * N) and the output is bit for bit the dense (N, N) scan's,
    ties resolving in row-major order either way.
    """
    t = traj.camera_to_world.translation.cpu().numpy()
    n = t.shape[0]
    keep_i, keep_j, keep_d = [], [], []
    for r0 in range(0, n, row_chunk):
        r1 = min(r0 + row_chunk, n)
        d = np.linalg.norm(t[r0:r1, None, :] - t[None, :, :], axis=-1)
        ii, jj = np.meshgrid(np.arange(r0, r1), np.arange(n), indexing="ij")
        ok = (jj > ii + min_separation) & (d < max_translation)
        ci, cj = np.nonzero(ok)  # row-major within the chunk
        dv = d[ci, cj]
        if ci.size > max_candidates:
            # Stable top-K, back in row-major order so that the global
            # stable sort breaks ties as the dense scan does.
            sel = np.sort(np.argsort(dv, kind="stable")[:max_candidates])
            ci, cj, dv = ci[sel], cj[sel], dv[sel]
        keep_i.append(ci + r0)
        keep_j.append(cj)
        keep_d.append(dv)
    cand_i = np.concatenate(keep_i) if keep_i else np.zeros(0, np.int64)
    cand_j = np.concatenate(keep_j) if keep_j else np.zeros(0, np.int64)
    dist = np.concatenate(keep_d) if keep_d else np.zeros(0, np.float64)
    order = np.argsort(dist, kind="stable")[:max_candidates]
    return np.stack([cand_i[order], cand_j[order]], axis=1).astype(np.int64).reshape(-1, 2)


def _edge_residual(twist_i, twist_j, t_i: Transform, t_j: Transform, z_inv: Transform) -> torch.Tensor:
    """r = log(Z^{-1} (T_i exp(xi_i))^{-1} (T_j exp(xi_j))), evaluated at
    xi = 0; the twists exist to differentiate through."""
    ti = t_i @ Transform.exp(twist_i)
    tj = t_j @ Transform.exp(twist_j)
    return (z_inv @ (ti.inverse() @ tj)).log()


def _edge_jacobians(nodes: Transform, edges: torch.Tensor, meas: Transform):
    """Per-edge residuals and 6x6 Jacobian blocks: (res (E, 6), j_i, j_j
    (E, 6, 6)).

    One forward-mode pass over a batch of 12 copies of the edges, copy k
    carrying the k-th basis tangent of (xi_i, xi_j): its output tangent is
    column k of [j_i | j_j]. ``vmap(jacfwd)`` would differentiate 0-d
    tensors, where forward AD promotes a float32 tangent meeting a Python
    scalar to float64; the batched form keeps float32 throughout.
    """
    t_i, t_j = nodes[edges[:, 0]], nodes[edges[:, 1]]
    z_inv = meas.inverse()
    e = edges.shape[0]
    zero = torch.zeros((12, e, 6), dtype=torch.float32, device=edges.device)
    basis = torch.eye(6, dtype=torch.float32, device=edges.device)[:, None, :].expand(6, e, 6)
    tan_i, tan_j = torch.cat([basis, zero[6:]]), torch.cat([zero[:6], basis])
    res, tangents = torch.func.jvp(lambda a, b: _edge_residual(a, b, t_i, t_j, z_inv), (zero, zero), (tan_i, tan_j))
    jac = tangents.permute(1, 2, 0)  # (E, 6 residual, 12 twist)
    return res[0], jac[..., :6], jac[..., 6:]


def _segment_sum(values: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` over the leading axis."""
    return torch.zeros((n, *values.shape[1:]), dtype=values.dtype, device=values.device).index_add_(0, ids, values)


def _block_system(nodes: Transform, edges: torch.Tensor, meas: Transform, weights: torch.Tensor, n: int):
    """Block-sparse normal equations: (hdiag (N, 6, 6), hij (E, 6, 6) the
    off-diagonal block (i, j) of each edge, g (N, 6)). Pose 0 is gauge-fixed
    at the residual level: its Jacobians are zeroed, which deletes its rows
    and columns from every product below."""
    res, j_i, j_j = _edge_jacobians(nodes, edges, meas)
    ei, ej = edges[:, 0], edges[:, 1]
    j_i = torch.where((ei == 0)[:, None, None], 0.0, j_i)
    j_j = torch.where((ej == 0)[:, None, None], 0.0, j_j)
    w = weights[:, None, None]
    h_ii = torch.einsum("edu,edw->euw", j_i * w, j_i)
    h_jj = torch.einsum("edu,edw->euw", j_j * w, j_j)
    hij = torch.einsum("edu,edw->euw", j_i * w, j_j)
    hdiag = _segment_sum(h_ii, ei, n) + _segment_sum(h_jj, ej, n)
    g = _segment_sum(torch.einsum("edu,ed->eu", j_i * w, res), ei, n) + _segment_sum(
        torch.einsum("edu,ed->eu", j_j * w, res), ej, n
    )
    return hdiag, hij, g


def _finalize_diag(hdiag: torch.Tensor, damping: float) -> torch.Tensor:
    """Damping on every diagonal block, and the identity as pose 0's."""
    eye = torch.eye(6, dtype=torch.float32, device=hdiag.device)
    hdiag = hdiag + damping * eye
    hdiag[0] = eye
    return hdiag


def _bmv(mats: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product ``nuw,nw->nu``."""
    return (mats @ vecs[..., None])[..., 0]


def _cg_operators(hdiag, hij, edges, mesh=None):
    """(matvec, block-Jacobi preconditioner) of the block system, for
    :func:`pcg`; with ``mesh``, ``hij`` and ``edges`` are the rank's shard
    and the off-diagonal products are all-reduced."""
    ei, ej = edges[:, 0], edges[:, 1]
    minv, _ = torch.linalg.inv_ex(hdiag)  # inv_ex checks nothing on the host
    hji = hij.transpose(-1, -2)

    def matvec(v):
        out = _bmv(hdiag, v) if mesh is None else torch.zeros_like(v)
        out.index_add_(0, ei, _bmv(hij, v.index_select(0, ej))).index_add_(0, ej, _bmv(hji, v.index_select(0, ei)))
        return out if mesh is None else _bmv(hdiag, v) + col.all_reduce(mesh, out)

    return matvec, lambda r: _bmv(minv, r)


def _cg_step_update(nodes: Transform, hdiag, hij, g, edges, cg_iters: int, mesh=None) -> Transform:
    """One GN update from the block system by block-Jacobi PCG."""
    update = -pcg(*_cg_operators(hdiag, hij, edges, mesh), g, cg_iters)
    return nodes @ Transform.exp(update)


def _dense_system(hdiag, hij, edges, mesh=None) -> torch.Tensor:
    """The block system scattered into the dense (6N, 6N) matrix, the
    off-diagonal part all-reduced over ``mesh``. Pose 0's rows and columns
    are zero but for its identity block, as the JAX package's dense gauge
    leaves them (there the block is (1 + damping) I: pose 0's update is 0
    either way, the other poses' are the same)."""
    n = hdiag.shape[0]
    ei, ej = edges[:, 0], edges[:, 1]
    ar = torch.arange(n, device=hdiag.device)
    h = torch.zeros((n, n, 6, 6), dtype=torch.float32, device=hdiag.device)
    h.index_put_((ei, ej), hij, accumulate=True)
    h.index_put_((ej, ei), hij.transpose(-1, -2), accumulate=True)
    if mesh is not None:
        h = col.all_reduce(mesh, h)
    h[ar, ar] += hdiag
    return h.permute(0, 2, 1, 3).reshape(n * 6, n * 6)


def _dense_step_update(nodes: Transform, hdiag, hij, g, edges, mesh=None) -> Transform:
    """One GN update from the dense system, solved in float64."""
    n = hdiag.shape[0]
    update, _ = torch.linalg.solve_ex(_dense_system(hdiag, hij, edges, mesh).double(), g.reshape(n * 6).double())
    return nodes @ Transform.exp(-update.to(torch.float32).reshape(n, 6))


def _edge_shard(graph: "PoseGraph", mesh):
    """This rank's block of the edges, measurements and weights, the edges
    padded to a multiple of the mesh size with zero-weight copies of the
    last edge."""
    if mesh is None:
        return graph.edges, graph.measurements, graph.weights
    col.check_device(mesh, graph.edges, graph.weights, graph.nodes.rotation)
    w = col.world(mesh)
    pad = (-graph.edges.shape[0]) % w
    edges = col.pad_rows(graph.edges, pad)
    meas = Transform(col.pad_rows(graph.measurements.rotation, pad), col.pad_rows(graph.measurements.translation, pad))
    weights = col.pad_rows(graph.weights, pad, torch.zeros((), dtype=graph.weights.dtype, device=graph.weights.device))
    lo, hi, _ = col.share(edges.shape[0], mesh)
    return edges[lo:hi], meas[lo:hi], weights[lo:hi]


def optimize(
    graph: PoseGraph,
    iterations: int = 10,
    damping: float = 1e-6,
    mesh=None,
    solver: str = "auto",
    cg_iters: int = 64,
) -> Transform:
    """Gauss-Newton over the pose graph, pose 0 gauge-fixed; returns the
    refined batched Transform.

    ``solver``: ``"dense"`` solves the (6N, 6N) system directly (float64);
    ``"cg"`` runs ``cg_iters`` trips of block-Jacobi PCG on the block
    system; ``"auto"`` picks CG above 64 poses. With ``mesh``, the edges
    are sharded over its ranks (module docstring) and every rank returns
    the same poses.
    """
    n = graph.nodes.rotation.shape[0]
    if solver == "auto":
        solver = "cg" if n > 64 else "dense"
    if solver not in ("cg", "dense"):
        raise ValueError(f"solver must be 'auto', 'cg' or 'dense', got {solver!r}")
    edges, meas, weights = _edge_shard(graph, mesh)
    nodes = graph.nodes
    for _ in range(iterations):
        hdiag, hij, g = _block_system(nodes, edges, meas, weights, n)
        if mesh is not None:
            hdiag, g = col.all_reduce(mesh, hdiag, g)
        hdiag = _finalize_diag(hdiag, damping)
        if solver == "cg":
            nodes = _cg_step_update(nodes, hdiag, hij, g, edges, cg_iters, mesh)
        else:
            nodes = _dense_step_update(nodes, hdiag, hij, g, edges, mesh)
    return nodes


def refine_trajectory(
    traj: Trajectory,
    loop_edges: list[tuple[int, int, Transform, float]] | None = None,
    iterations: int = 10,
    mesh=None,
) -> Trajectory:
    """Trajectory -> pose graph (+ loop closures ``(i, j, Z, weight)``) ->
    :func:`optimize` (edges sharded over ``mesh``) -> trajectory with the
    same timestamps."""
    graph = PoseGraph.from_trajectory(traj)
    for i, j, z, w in loop_edges or []:
        graph = graph.with_edge(i, j, z, w)
    return Trajectory(optimize(graph, iterations=iterations, mesh=mesh), traj.times)
