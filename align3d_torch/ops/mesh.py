"""Mesh vertex normals: CUDA kernel K5 and its twin (port of ``align3d_tpu/ops/mesh.py``).

Counterpart of the reference ``src/mesh.rs:4-52``: per-face cross-product
normals (unit unless degenerate), averaged into vertex normals by the number
of incident faces, not renormalised; an isolated vertex gets NaN (0/0).

* :func:`compute_vertex_normals` is the one-shot form, a scatter-add
  (``index_add_``) in corner order.
* :class:`MeshNormals` precomputes the incidence of a fixed topology on the
  host, once, as an (N, D) table of face ids in face order (padded with the
  face count, which points at a zero row); every evaluation is then
  :func:`vertex_normals`: K5 (``csrc/mesh.cu``) on a CUDA tensor, the plain
  twin on a CPU tensor. The TPU kernel's band analysis, its limits
  (``max_band_rows``, ``max_degree``) and the ``method=`` switch have no
  counterpart: the card gathers directly and takes any topology.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from align3d_torch import _kernels

#: Launches of the CUDA kernel since the last reset (set it to 0 to reset).
LAUNCHES = 0


def face_normals(points: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(N, 3) points, (F, 3) int faces -> (F, 3) unit face normals.

    Degenerate faces keep their zero normal (the reference's ``if mag > 0``,
    mesh.rs:22-25). The cross product and the norm are written out as K5
    computes them, so the two agree bitwise. The square root is taken in
    float64 and rounded once, which is the correctly rounded float32 root:
    PyTorch's float32 ``sqrt`` on the CPU is 1 ulp off for ~0.6% of inputs.
    """
    faces = faces.long()
    p0, p1, p2 = points[faces[:, 0]], points[faces[:, 1]], points[faces[:, 2]]
    a, b = p1 - p0, p2 - p0
    nx = a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1]
    ny = a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2]
    nz = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]
    n = torch.stack([nx, ny, nz], dim=-1)
    mag = torch.sqrt(((nx * nx + ny * ny) + nz * nz).double()).float()[:, None]
    return torch.where(mag > 0.0, n / torch.where(mag == 0.0, 1.0, mag), n)


def compute_vertex_normals(points: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(N, 3) points, (F, 3) faces -> (N, 3) vertex normals: the sum of the
    incident unit face normals over the incident-face count (mesh.rs:30-49)."""
    n_vertices = points.shape[0]
    fn = face_normals(points, faces)
    idx = faces.reshape(-1).long()  # (3F,) corner-major, matching the repeat
    sums = torch.zeros((n_vertices, 3), dtype=fn.dtype, device=fn.device)
    sums.index_add_(0, idx, fn.repeat_interleave(3, dim=0))
    counts = torch.bincount(idx, minlength=n_vertices).to(fn.dtype)
    return sums / counts[:, None]


def vertex_normals_plain(
    points: torch.Tensor, faces: torch.Tensor, table: torch.Tensor, counts: torch.Tensor
) -> torch.Tensor:
    """The plain-PyTorch twin of K5: face normals, a left fold over the
    table's slots in face order, division by the count."""
    fn = face_normals(points, faces)
    fn_pad = torch.cat([fn, torch.zeros((1, 3), dtype=fn.dtype, device=fn.device)])
    table = table.long()
    acc = fn_pad[table[:, 0]]
    for d in range(1, table.shape[1]):
        acc = acc + fn_pad[table[:, d]]
    return acc / counts[:, None]


def vertex_normals(
    points: torch.Tensor,  # (N, 3) f32
    faces: torch.Tensor,  # (F, 3) int32, ids in [0, N)
    table: torch.Tensor,  # (N, D) int32 incident face ids in face order, F = empty slot
    counts: torch.Tensor,  # (N,) f32 incident-face counts
) -> torch.Tensor:
    """(N, 3) f32 vertex normals through a precomputed incidence table."""
    if points.device.type == "cpu":
        return vertex_normals_plain(points, faces, table, counts)
    if points.device.type != "cuda":
        raise ValueError(f"vertex_normals runs on cuda or cpu tensors, got {points.device}")

    global LAUNCHES
    dev = points.device
    n, f, d = points.shape[0], faces.shape[0], table.shape[1]
    _kernels.check_tensor(points, "points", (n, 3), torch.float32, dev)
    _kernels.check_tensor(faces, "faces", (f, 3), torch.int32, dev)
    _kernels.check_tensor(table, "table", (n, d), torch.int32, dev)
    _kernels.check_tensor(counts, "counts", (n,), torch.float32, dev)
    if d < 1:
        raise ValueError("the incidence table needs at least one slot")

    face_buf = torch.empty((f + 1, 3), dtype=torch.float32, device=dev)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    status = _kernels.lib().a3d_mesh_normals(
        points.data_ptr(), faces.data_ptr(), f, table.data_ptr(), counts.data_ptr(), n, d,
        face_buf.data_ptr(), out.data_ptr(), ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _kernels.check(status, "a3d_mesh_normals")
    LAUNCHES += 1
    return out


class MeshNormals:
    """Vertex-normal evaluator for a fixed topology (see the module
    docstring). Same semantics as :func:`compute_vertex_normals`; sums run
    in face order. The incidence table is built on the host and copied to
    ``device`` once; call it with points on that device."""

    def __init__(self, faces, n_vertices: int, device="cpu"):
        faces_np = np.asarray(faces.cpu() if isinstance(faces, torch.Tensor) else faces, dtype=np.int64)
        faces_np = faces_np.reshape(-1, 3)
        if faces_np.size and (faces_np.min() < 0 or faces_np.max() >= n_vertices):
            raise ValueError(f"face ids must lie in [0, {n_vertices})")
        f = faces_np.reshape(-1)  # corners, face-major
        n_faces = faces_np.shape[0]
        corner_face = np.arange(f.size, dtype=np.int64) // 3
        order = np.argsort(f, kind="stable")  # per-vertex groups, in face order
        fs = f[order]
        counts = np.bincount(f, minlength=n_vertices)
        degree = int(counts.max()) if counts.size else 1
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(f.size, dtype=np.int64) - starts[fs]
        table = np.full((n_vertices, max(degree, 1)), n_faces, dtype=np.int32)
        table[fs, rank] = corner_face[order]
        self.n_vertices = n_vertices
        self.degree = degree
        self.faces = torch.from_numpy(faces_np.astype(np.int32)).to(device)
        self.table = torch.from_numpy(table).to(device)  # (N, D), padded with n_faces
        self.counts = torch.from_numpy(counts.astype(np.float32)).to(device)
        self.device = self.table.device

    def __call__(self, points: torch.Tensor) -> torch.Tensor:
        if points.device != self.device:
            raise ValueError(f"points are on {points.device}, the topology on {self.device}")
        return vertex_normals(points, self.faces, self.table, self.counts)
