"""Banded sorted-grid nearest-neighbour search: CUDA kernel K4 and its twin
(port of ``align3d_tpu/ops/nn_banded.py``).

The DB is sorted by z-major linear cell id, so the three dz cells of a
fixed (dx, dy) neighbour offset are one contiguous run of the sorted order.
Queries are sorted the same way and taken 128 at a time; for each block the
search scans 9 contiguous bands of ``band_width`` sorted DB points, one per
(dx, dy), anchored on a cell id of the block. A candidate c scores
``|c|^2 - 2 q.c``, which orders candidates as the squared distance does.

Search contract (the JAX package's, kept so that the two stay comparable):
the same ``SortedGrid`` layout, the same 9 band starts per block (rounded
down to a multiple of 128 and clamped into the DB), and the same band width,
clamped to the DB. Candidates are what the bands cover, at least the
one-cell ring up to the band's capacity; a query far from the DB gets a
genuine but distant point, which the ICP's distance gate rejects.

:func:`band_search` launches ``csrc/nn_banded.cu`` (K4) on a CUDA tensor
and runs :func:`band_search_plain` on a CPU tensor. Both score in one fixed
order, ``c3 + ((qx*c0 + qy*c1) + qz*c2)`` with c0..c2 = -2c and c3 = |c|^2,
and take the smallest score, the smallest sorted position among equal
scores, so that kernel and twin agree bitwise.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from align3d_torch import _kernels
from align3d_torch.ops.voxel_hash import scaled_by_inverse

QB = 128  # queries per block
NPLANES = 8  # -2x, -2y, -2z, |c|^2, then the payload [nx, ny, nz, p.n] or zeros
NBANDS = 9  # one band per (dx, dy) offset; the dz cells are contiguous
_NO_WINNER = 2**31 - 1  # position of a query whose scores were all NaN
_PLAIN_BLOCKS = 8  # query blocks per chunk of the plain twin (peak memory, not results)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _fma_dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum(a * b, axis=-1)`` over 3 components as XLA computes it on the
    CPU: ``fma(a2, b2, fma(a1, b1, a0 * b0))``. Each fused step is emulated
    in float64, where the product is exact; the sum's one extra rounding
    could differ from a true fma only on an exact float32 tie."""
    acc = a[:, 0] * b[:, 0]
    for k in (1, 2):
        acc = (a[:, k].double() * b[:, k].double() + acc.double()).float()
    return acc


@dataclasses.dataclass
class SortedGrid:
    """DB sorted by z-major linear cell id + dense per-cell start offsets."""

    planes: torch.Tensor  # (Mp/128, NPLANES, 128) f32 position-major tiles
    orig_idx: torch.Tensor  # (Mp,) int32: sorted position -> original DB index
    starts: torch.Tensor  # (NCELLS + 1,) int32 cumulative cell counts
    cell_size: float
    origin: tuple  # (3,) int cell-space origin
    dims: tuple  # (NX, NY, NZ) grid dims
    n: int  # true point count

    @classmethod
    def build(cls, points: torch.Tensor, cell_size: float, normals: torch.Tensor | None = None) -> "SortedGrid":
        """Size the grid on the host from the bounding box (one sync), sort
        on the points' device. With ``normals`` the four payload planes
        carry [nx, ny, nz, p.n] for :func:`associate_p2p`."""
        pts = points.to(torch.float32)
        n = pts.shape[0]
        lo = np.floor(pts.min(dim=0).values.cpu().numpy() / cell_size).astype(np.int64) - 1
        hi = np.floor(pts.max(dim=0).values.cpu().numpy() / cell_size).astype(np.int64) + 1
        dims = tuple(int(d) for d in (hi - lo + 1))
        ncells = dims[0] * dims[1] * dims[2]
        if ncells > 64_000_000:
            raise ValueError(f"grid too fine: {dims} = {ncells} cells; raise cell_size")
        origin = tuple(int(v) for v in lo)

        dev = pts.device
        cells = torch.floor(scaled_by_inverse(pts, cell_size)).to(torch.int32)
        cx, cy, cz = (cells[:, k] - origin[k] for k in range(3))
        lin = (cx * dims[1] + cy) * dims[2] + cz
        order = torch.argsort(lin, stable=True)
        pts_sorted = pts[order]
        counts = torch.bincount(lin[order], minlength=ncells)
        starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(counts, 0)])

        if normals is None:
            payload = [torch.zeros(n, dtype=torch.float32, device=dev)] * 4
        else:
            nrm_sorted = normals.to(torch.float32)[order]
            payload = [nrm_sorted[:, 0], nrm_sorted[:, 1], nrm_sorted[:, 2], _fma_dot3(pts_sorted, nrm_sorted)]
        mp = _ceil_div(n, 128) * 128
        planes = torch.zeros((NPLANES, mp), dtype=torch.float32, device=dev)
        planes[:, :n] = torch.stack(
            [-2.0 * pts_sorted[:, 0], -2.0 * pts_sorted[:, 1], -2.0 * pts_sorted[:, 2],
             _fma_dot3(pts_sorted, pts_sorted)] + payload
        )
        planes[3, n:] = 1e30  # padding columns: an |c|^2 that never wins
        planes = planes.reshape(NPLANES, mp // 128, 128).permute(1, 0, 2).contiguous()
        orig_idx = torch.zeros(mp, dtype=torch.int32, device=dev)
        orig_idx[:n] = order.to(torch.int32)
        return cls(planes, orig_idx, starts.to(torch.int32), float(cell_size), origin, dims, n)

    def cell_ids(self, points: torch.Tensor) -> torch.Tensor:
        """Linear cell id of each point, clamped into the grid (an
        out-of-grid point searches the nearest boundary cells). Python ints
        only: a small tensor made from a list would be a synchronous copy
        to the card."""
        cells = torch.floor(scaled_by_inverse(points, self.cell_size)).to(torch.int32)
        cx, cy, cz = (torch.clamp(cells[:, k] - self.origin[k], 0, self.dims[k] - 1) for k in range(3))
        return (cx * self.dims[1] + cy) * self.dims[2] + cz


def search_inputs(
    grid: SortedGrid,
    lin_s: torch.Tensor,  # (Q,) int32 query cell ids, sorted ascending (or nearly)
    qx_s: torch.Tensor,  # (Q,) f32 query coordinates in the same order
    qy_s: torch.Tensor,
    qz_s: torch.Tensor,
    band_width: int,
    anchor_on_min: bool,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """K4's inputs for queries in the given order: the (3, Qp) f32 query
    planes, zero-padded to whole blocks; the (nblocks * 9,) int32 band
    starts; the band width clamped to the padded DB (a smaller DB would be
    read past its end otherwise).

    Each block of 128 queries is anchored on its first cell id
    (:func:`nearest_banded`) or on its minimum (:func:`associate_p2p`, which
    tolerates a slightly stale order). The band of offset (dx, dy) starts at
    the sorted position of cell ``anchor + (dx * NY + dy) * NZ - 1``,
    rounded down to a multiple of 128 and clamped so the band fits.
    """
    if band_width <= 0 or band_width % 128:
        raise ValueError(f"band_width must be a positive multiple of 128, got {band_width}")
    mp = grid.planes.shape[0] * 128
    band_width = min(band_width, mp)
    q = lin_s.shape[0]
    qp = _ceil_div(q, QB) * QB
    nx, ny, nz = grid.dims
    ncells = nx * ny * nz
    blocks = torch.nn.functional.pad(lin_s, (0, qp - q), value=ncells - 1).reshape(-1, QB)
    anchors = torch.amin(blocks, dim=1) if anchor_on_min else blocks[:, 0]
    step = torch.arange(-1, 2, dtype=torch.int32, device=lin_s.device)
    offs = ((step[:, None] * ny + step[None, :]) * nz).reshape(-1)  # dx-major, as the JAX package
    lo_ids = torch.clamp(anchors[:, None] + offs[None, :] - 1, 0, ncells)
    starts = (grid.starts[lo_ids.long()] // 128) * 128
    bstarts = torch.clamp(starts, 0, max(mp - band_width, 0)).reshape(-1).to(torch.int32)
    queries = torch.zeros((3, qp), dtype=torch.float32, device=lin_s.device)
    queries[0, :q], queries[1, :q], queries[2, :q] = qx_s, qy_s, qz_s
    return queries, bstarts, band_width


def band_search_plain(
    planes: torch.Tensor, queries: torch.Tensor, bstarts: torch.Tensor, band_width: int, payload: bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The plain-PyTorch twin of K4: the same candidates, score order and
    tie rule, a fixed number of query blocks at a time."""
    nblocks = queries.shape[1] // QB
    mp = planes.shape[0] * 128
    rows = planes.transpose(0, 1).reshape(NPLANES, mp)  # plane-major, one column per sorted position
    lanes = torch.arange(band_width, dtype=torch.int32, device=planes.device)
    band_starts = bstarts.reshape(nblocks, NBANDS)
    scores, positions = [], []
    for b0 in range(0, nblocks, _PLAIN_BLOCKS):
        st = band_starts[b0:b0 + _PLAIN_BLOCKS]
        k = st.shape[0]
        pos = (st[:, :, None] + lanes).reshape(k, 1, -1)  # (k, 1, L) candidate positions
        c0, c1, c2, c3 = (rows[r][pos.long()] for r in range(4))
        q = queries[:, b0 * QB:(b0 + k) * QB].reshape(3, k, QB, 1)
        s = q[0] * c0  # (k, QB, L), then in place: c3 + ((q0 c0 + q1 c1) + q2 c2)
        s += q[1] * c1
        s += q[2] * c2
        s += c3
        best = torch.amin(s, dim=-1, keepdim=True)  # NaN where a row holds a NaN
        win = torch.amin(torch.where(s == best, pos, _NO_WINNER), dim=-1)  # (k, QB)
        nan_rows = torch.isnan(best[..., 0]).nonzero(as_tuple=True)
        if nan_rows[0].numel():  # a NaN never wins: redo those rows without them
            sr = s[nan_rows]
            ok = ~torch.isnan(sr)
            best_r = torch.amin(torch.where(ok, sr, torch.inf), dim=-1, keepdim=True)
            best[nan_rows] = best_r
            win[nan_rows] = torch.amin(torch.where(ok & (sr == best_r), pos[nan_rows[0], 0], _NO_WINNER), dim=-1)
        scores.append(best.reshape(-1))
        positions.append(win.reshape(-1))
    score, position = torch.cat(scores), torch.cat(positions)
    pay = None
    if payload:
        found = position != _NO_WINNER
        pay = torch.where(found, rows[4:][:, torch.where(found, position, 0).long()], 0.0)
    return score, position, pay


def band_search(
    planes: torch.Tensor,  # (Mp/128, 8, 128) f32 SortedGrid.planes
    queries: torch.Tensor,  # (3, nblocks * 128) f32 sorted query coordinates
    bstarts: torch.Tensor,  # (nblocks * 9,) int32 band starts, multiples of 128
    band_width: int,  # a multiple of 128, at most Mp
    payload: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Best candidate per query: (score (Qp,) f32, sorted position (Qp,)
    int32, and with ``payload`` the winner's planes 4..7 as (4, Qp) f32).
    A query whose every score is NaN gets score +inf, position 2**31 - 1
    and a zero payload."""
    if planes.device.type == "cpu":
        return band_search_plain(planes, queries, bstarts, band_width, payload)
    if planes.device.type != "cuda":
        raise ValueError(f"band_search runs on cuda or cpu tensors, got {planes.device}")

    dev = planes.device
    tiles = planes.shape[0]
    qp = queries.shape[1]
    if qp % QB:
        raise ValueError(f"queries must be padded to a multiple of {QB}, got {qp}")
    if band_width <= 0 or band_width % 128 or band_width > tiles * 128:
        raise ValueError(f"band_width {band_width} must be a multiple of 128 within the DB's {tiles * 128}")
    nblocks = qp // QB
    _kernels.check_tensor(planes, "planes", (tiles, NPLANES, 128), torch.float32, dev)
    _kernels.check_tensor(queries, "queries", (3, qp), torch.float32, dev)
    _kernels.check_tensor(bstarts, "bstarts", (nblocks * NBANDS,), torch.int32, dev)
    if planes.data_ptr() % 16:
        raise ValueError("planes must start on a 16-byte boundary (the kernel stages tiles with 16-byte copies)")

    score = torch.empty(qp, dtype=torch.float32, device=dev)
    pos = torch.empty(qp, dtype=torch.int32, device=dev)
    pay = torch.empty((4, qp), dtype=torch.float32, device=dev) if payload else None
    _kernels.launch(
        "K4", planes.data_ptr(), queries.data_ptr(), bstarts.data_ptr(),
        nblocks, tiles, band_width // 128, int(payload),
        score.data_ptr(), pos.data_ptr(), None if pay is None else pay.data_ptr(),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    return score, pos, pay


def nearest_banded(
    grid: SortedGrid, queries: torch.Tensor, band_width: int = 512
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest DB point per query: (indices (Q,) int32, sq_distances (Q,) f32),
    in the caller's order.

    Each block of 128 sorted queries is anchored on its first query's cell.
    Squared distances are recovered as score + |q|^2, clamped at 0: good to
    ~1e-6 of the operands' magnitude (f32 cancellation), below every ICP gate.
    """
    queries = queries.to(torch.float32)
    q = queries.shape[0]
    lin = grid.cell_ids(queries)
    order = torch.argsort(lin, stable=True)  # the JAX package's sort is unstable
    q_s = queries[order]
    qx, qy, qz = q_s[:, 0], q_s[:, 1], q_s[:, 2]
    qplanes, bstarts, band_width = search_inputs(grid, lin[order], qx, qy, qz, band_width, anchor_on_min=False)
    score, pos, _ = band_search(grid.planes, qplanes, bstarts, band_width, False)
    best_sq = torch.clamp(score[:q] + (qx * qx + qy * qy + qz * qz), min=0.0)
    best_idx = grid.orig_idx[torch.clamp(pos[:q], 0, grid.planes.shape[0] * 128 - 1).long()]
    out_idx = torch.empty_like(best_idx)
    out_sq = torch.empty_like(best_sq)
    out_idx[order] = best_idx
    out_sq[order] = best_sq
    return out_idx, out_sq


def associate_p2p(
    grid: SortedGrid,
    lin_s: torch.Tensor,  # (Q,) int32 query cell ids, sorted ascending (or nearly)
    qx_s: torch.Tensor,  # (Q,) f32 query coordinates in the same order
    qy_s: torch.Tensor,
    qz_s: torch.Tensor,
    band_width: int = 512,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Point-to-plane association: per query, in the given order, the
    nearest DB point's (sq_distance, nx, ny, nz, p.n) in one search with no
    index gather and no un-sort (the GN reduction is order-independent).

    Needs a grid built with normals. Each block is anchored on its minimum
    cell id, so a slightly stale sort order stays covered.
    """
    q = lin_s.shape[0]
    qplanes, bstarts, band_width = search_inputs(grid, lin_s, qx_s, qy_s, qz_s, band_width, anchor_on_min=True)
    score, _, pay = band_search(grid.planes, qplanes, bstarts, band_width, True)
    sq = torch.clamp(score[:q] + (qx_s * qx_s + qy_s * qy_s + qz_s * qz_s), min=0.0)
    return sq, pay[0, :q], pay[1, :q], pay[2, :q], pay[3, :q]
