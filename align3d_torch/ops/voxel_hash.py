"""Voxel-hash grid nearest-neighbour search (port of ``align3d_tpu/ops/voxel_hash.py``).

The reference's kd-tree (``src/kdtree.rs``) descends without backtracking,
so it is an approximate NN already. Here points are bucketed into hashed
voxel cells by a sort, and each query scans the 27 neighbouring cells' runs
of the sorted order and takes the minimum. Plain PyTorch, no kernel: the JAX
package runs it as XLA, and it is the point-cloud ICP's CPU engine.

With cell size >= the search radius of interest, the 27-cell scan finds the
exact nearest neighbour within that radius up to the per-cell candidate cap
(``max_per_cell``); hash collisions only add losing candidates.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from align3d_torch.extra_math import div_scalar

# Large primes for the 3D cell hash (standard spatial-hash constants).
_P1, _P2, _P3 = 73856093, 19349663, 83492791


def scaled_by_inverse(x: torch.Tensor, cell_size: float) -> torch.Tensor:
    """``x / cell_size`` as the JAX package computes it inside ``jit``: XLA
    turns a division by a constant into a multiply by its float32
    reciprocal, which rounds differently at cell boundaries."""
    return x * float(np.float32(1.0) / np.float32(cell_size))


def _cell_hash(cell_ids: torch.Tensor) -> torch.Tensor:
    """(..., 3) int32 cell coords -> int32 hash; the products wrap around in
    int32 as in the JAX package (collisions are benign)."""
    return cell_ids[..., 0] * _P1 ^ cell_ids[..., 1] * _P2 ^ cell_ids[..., 2] * _P3


@dataclasses.dataclass
class VoxelHashGrid:
    """Sorted-bucket voxel hash over a fixed point set."""

    sorted_hash: torch.Tensor  # (M,) int32, ascending
    sorted_points: torch.Tensor  # (M, 3) f32
    sorted_indices: torch.Tensor  # (M,) int32, original indices
    cell_size: float

    @classmethod
    def build(cls, points: torch.Tensor, cell_size: float) -> "VoxelHashGrid":
        points = points.to(torch.float32)
        # The JAX build runs eagerly, where the division is a true one.
        h = _cell_hash(torch.floor(div_scalar(points, cell_size)).to(torch.int32))
        order = torch.argsort(h, stable=True)
        return cls(h[order], points[order], order.to(torch.int32), cell_size)


def _nearest_chunk(grid: VoxelHashGrid, q_blk: torch.Tensor, offsets: torch.Tensor, max_per_cell: int):
    c = q_blk.shape[0]
    m = grid.sorted_points.shape[0]
    q_cells = torch.floor(scaled_by_inverse(q_blk, grid.cell_size)).to(torch.int32)
    neighbor_hash = _cell_hash(q_cells[:, None, :] + offsets[None, :, :])  # (C, 27)
    starts = torch.searchsorted(grid.sorted_hash, neighbor_hash.reshape(-1)).reshape(c, 27)

    lanes = torch.arange(max_per_cell, dtype=starts.dtype, device=starts.device)
    cand = (starts[..., None] + lanes).reshape(c, -1)  # (C, 27K)
    cand_clipped = torch.clamp(cand, max=m - 1)
    cand_valid = (cand < m) & (grid.sorted_hash[cand_clipped] == neighbor_hash.repeat_interleave(max_per_cell, dim=1))

    pts = grid.sorted_points
    dx = pts[:, 0][cand_clipped] - q_blk[:, 0:1]
    dy = pts[:, 1][cand_clipped] - q_blk[:, 1:2]
    dz = pts[:, 2][cand_clipped] - q_blk[:, 2:3]
    sq = torch.where(cand_valid, dx * dx + dy * dy + dz * dz, torch.inf)

    best = torch.argmin(sq, dim=-1, keepdim=True)
    best_sq = torch.gather(sq, -1, best)[:, 0]
    best_sorted = torch.gather(cand_clipped, -1, best)[:, 0]
    return grid.sorted_indices[best_sorted], best_sq


def nearest(
    grid: VoxelHashGrid, queries: torch.Tensor, max_per_cell: int = 16, query_chunk: int = 8192
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest DB point per query: (indices (Q,) int32, sq_distances (Q,) f32).

    Scans the 27 cells around each query, up to ``max_per_cell`` candidates
    per cell (a cell is a contiguous run of the sorted order). A query with
    no candidate gets +inf distance; callers gate by distance as the ICP
    does. Queries run in ``query_chunk`` blocks (the JAX package's
    ``lax.map``), so peak memory is O(chunk * 27 * K), independent of Q.
    """
    queries = queries.to(torch.float32)
    ax = torch.arange(-1, 2, dtype=torch.int32, device=queries.device)
    offsets = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), dim=-1).reshape(27, 3)
    parts = [_nearest_chunk(grid, queries[i:i + query_chunk], offsets, max_per_cell)
             for i in range(0, queries.shape[0], query_chunk)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def nearest_brute_force(db: torch.Tensor, queries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact NN by one matmul: ||q - p||^2 = |q|^2 - 2 q.p + |p|^2. The
    test oracle, and the answer for small clouds."""
    db = db.to(torch.float32)
    queries = queries.to(torch.float32)
    sq = (
        torch.sum(queries * queries, dim=-1, keepdim=True)
        - 2.0 * (queries @ db.T)
        + torch.sum(db * db, dim=-1)[None, :]
    )
    idx = torch.argmin(sq, dim=-1, keepdim=True)
    return idx[:, 0].to(torch.int32), torch.clamp(torch.gather(sq, -1, idx)[:, 0], min=0.0)
