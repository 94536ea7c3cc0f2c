"""Unordered point-cloud ICP, point to plane (port of ``align3d_tpu/icp/pcl_icp.py``;
reference ``src/icp/pcl_icp.rs``).

Association is a grid NN instead of the reference's descent-only kd-tree;
both are approximate, and the grid is exact within one cell ring up to its
capacity (SURVEY.md §2.3). Two engines:

* ``"banded"``: :func:`align3d_torch.ops.nn_banded.associate_p2p`, i.e. the
  banded sorted-grid search (CUDA kernel K4 on the card), which returns the
  winner's normal and ``p.n`` directly, so the loop needs no gather and no
  un-sort. The default on a CUDA device.
* ``"hash"``: :func:`align3d_torch.ops.voxel_hash.nearest`, plain PyTorch,
  then a gather of the target points and normals. The default on the CPU.

Per iteration (pcl_icp.rs:49-98): transform points and normals, associate,
gate on distance (strict >, so +inf is rejected) and on the angle between
the transformed source normal and the target normal (strict >; a NaN angle
passes), one point-to-plane Gauss-Newton step. The mean squared residual is
read before ``weight()`` scales the system, and the returned pose is the
one that followed the smallest residual, tracked from +inf.
"""

from __future__ import annotations

import math

import torch

from align3d_torch.icp.params import IcpParams
from align3d_torch.ops import nn_banded, voxel_hash
from align3d_torch.ops.icp_fused import _f32
from align3d_torch.optim.gauss_newton import GNSystem
from align3d_torch.se3 import Transform


def _sort_by_cells(grid: nn_banded.SortedGrid, transform: Transform, pts, nrm, mask_f):
    """Sort the source cloud by the cell ids of its transformed points.

    Rigid motion keeps the order coherent while the pose stays near the one
    it was sorted under; the align loop re-sorts when it drifts further.
    The JAX package's sort is unstable and this one is stable, so points of
    one cell may sit in another order and blocks may differ at the edges.
    """
    order = torch.argsort(grid.cell_ids(transform.apply(pts)), stable=True)
    return pts[order], nrm[order], mask_f[order]


class Icp:
    """Point-cloud ICP against a fixed target (reference pcl_icp.rs:15-47).

    The grid is built once, at construction, on the target's device (the
    reference builds its kd-tree in ``new``). ``cell_size`` defaults to
    ``max_distance / 10``.

    Stale-sort guard (banded engine): the source is sorted by the cell ids
    of its points under the initial pose, and every iteration derives the
    cell ids again from the moved points. ``associate_p2p`` anchors each
    128-query block on its minimum cell id, which tolerates a little drift;
    more would push a query's neighbourhood out of its bands. So the loop
    keeps the pose of the last sort and re-sorts under the current pose
    whenever the bound on any point's motion since then,
    ``2 sin(theta/2) (r_src + |t_sort|) + |dt|``, exceeds one cell.
    ``last_resorts`` counts the iterations that did. The test is a Python
    ``if`` on a device value, so each iteration synchronises with the
    device once.
    """

    def __init__(
        self,
        params: IcpParams,
        target_points,
        target_normals,
        cell_size: float | None = None,
        max_per_cell: int = 32,
        nn_engine: str | None = None,
    ):
        if target_normals is None:
            raise ValueError("the target point cloud should have normals")
        self.params = params
        self.target_points = torch.as_tensor(target_points, dtype=torch.float32)
        self.target_normals = torch.as_tensor(target_normals, dtype=torch.float32).to(self.target_points.device)
        self.device = self.target_points.device
        self.initial_transform = Transform.identity(device=self.device)
        self.cell_size = float(cell_size if cell_size is not None else params.max_distance / 10.0)
        self.max_per_cell = max_per_cell
        if nn_engine is None:
            nn_engine = "banded" if self.device.type == "cuda" else "hash"
        if nn_engine == "banded":
            self.grid = nn_banded.SortedGrid.build(self.target_points, self.cell_size, normals=self.target_normals)
        elif nn_engine == "hash":
            self.grid = voxel_hash.VoxelHashGrid.build(self.target_points, self.cell_size)
        else:
            raise ValueError(f"unknown nn_engine {nn_engine!r}: 'banded' or 'hash'")
        self.nn_engine = nn_engine
        self.last_resorts = 0

    def _associate(self, p: torch.Tensor):
        """-> (sq_distance, target normal, residual (tp - p).tn) per point."""
        if self.nn_engine == "banded":
            sq, tnx, tny, tnz, pndot = nn_banded.associate_p2p(
                self.grid, self.grid.cell_ids(p), p[:, 0], p[:, 1], p[:, 2]
            )
            tn = torch.stack([tnx, tny, tnz], dim=1)
            return sq, tn, pndot - (p[:, 0] * tnx + p[:, 1] * tny + p[:, 2] * tnz)
        idx, sq = voxel_hash.nearest(self.grid, p, max_per_cell=self.max_per_cell)
        tp, tn = self.target_points[idx], self.target_normals[idx]
        return sq, tn, torch.sum((tp - p) * tn, dim=-1)

    def align(self, source_points, source_normals, source_mask=None) -> Transform:
        params = self.params
        sp = torch.as_tensor(source_points, dtype=torch.float32).to(self.device)
        sn = torch.as_tensor(source_normals, dtype=torch.float32).to(self.device)
        if source_mask is None:
            mask_f = torch.ones(sp.shape[0], dtype=torch.float32, device=self.device)
        else:
            mask_f = torch.as_tensor(source_mask).to(self.device).to(torch.float32)
        max_distance_sqr = _f32(params.max_distance * params.max_distance)
        max_angle = _f32(params.max_normal_angle)

        transform = self.initial_transform
        best_res = torch.full((), torch.inf, dtype=torch.float32, device=self.device)
        best = transform
        anchor = transform
        resorts = 0
        if self.nn_engine == "banded":
            sp, sn, mask_f = _sort_by_cells(self.grid, anchor, sp, sn, mask_f)
            # A bound on |p| over the valid source points (the sort keeps it).
            r_src = torch.max(torch.linalg.norm(sp, dim=-1) * mask_f)

        for _ in range(params.max_iterations):
            if self.nn_engine == "banded":
                d = transform @ anchor.inverse()
                disp = (
                    2.0 * torch.sin(torch.clamp(d.angle() * 0.5, max=_f32(math.pi / 2)))
                    * (r_src + torch.linalg.norm(anchor.translation))
                    + torch.linalg.norm(d.translation)
                )
                if bool(disp > _f32(self.cell_size)):  # the one host sync per iteration
                    sp, sn, mask_f = _sort_by_cells(self.grid, transform, sp, sn, mask_f)
                    anchor = transform
                    resorts += 1

            p = transform.apply(sp)
            n = transform.apply_normals(sn)
            sq_dist, tn, residual = self._associate(p)
            n_dot_tn = torch.sum(n * tn, dim=-1)
            dist_ok = ~(sq_dist > max_distance_sqr)  # inf -> rejected
            angle_rejected = torch.abs(torch.arccos(n_dot_tn)) > max_angle  # NaN -> kept
            w = mask_f * dist_ok.to(torch.float32) * (~angle_rejected).to(torch.float32)

            jac = torch.cat([tn, torch.cross(p, tn, dim=-1)], dim=-1)
            system = GNSystem.from_residuals(jac, residual, w)
            res_now = system.mean_squared_residual()  # before weight() (pcl_icp.rs:91-93)
            update = system.weight(params.weight).solve()
            new_t = Transform.exp(update) @ transform

            better = res_now < best_res
            best_res = torch.where(better, res_now, best_res)
            best = Transform(torch.where(better, new_t.rotation, best.rotation),
                             torch.where(better, new_t.translation, best.translation))
            transform = new_t

        self.last_resorts = resorts
        return best
