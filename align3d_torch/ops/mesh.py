"""Mesh vertex normals: CUDA kernel K5 and its twin (port of ``align3d_tpu/ops/mesh.py``).

Counterpart of the reference ``src/mesh.rs:4-52``: per-face cross-product
normals (unit unless degenerate), averaged into vertex normals by the number
of incident faces, not renormalised; an isolated vertex gets NaN (0/0).

* :func:`compute_vertex_normals` is the one-shot form, a scatter-add
  (``index_add_``) in corner order.
* :class:`MeshNormals` precomputes the incidence of a fixed topology on the
  host, once, as a slot-major (D, N, 2) corner table (:func:`corner_table`:
  per vertex and incident face, in face order, the face's two other corners
  and the vertex's place in it; padding slots stand for a zero normal);
  every evaluation is then K5 (``csrc/mesh.cu``, one launch) on a CUDA
  tensor, the plain twin on a CPU tensor. Its topology is checked once, at
  construction; a call checks only the points. :func:`vertex_normals` is
  the same evaluation for tensors the caller built, checked in full on
  every call. The TPU kernel's band analysis, its limits (``max_band_rows``,
  ``max_degree``) and the ``method=`` switch have no counterpart: the card
  gathers directly and takes any topology.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from align3d_torch import _kernels


def _normal(p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """(..., 3) corners -> (..., 3) unit normals of cross(p1 - p0, p2 - p0),
    zero where degenerate, in K5's order of operations."""
    a, b = p1 - p0, p2 - p0
    nx = a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1]
    ny = a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2]
    nz = a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    n = torch.stack([nx, ny, nz], dim=-1)
    mag = torch.sqrt(((nx * nx + ny * ny) + nz * nz).double()).float()[..., None]
    return torch.where(mag > 0.0, n / torch.where(mag == 0.0, 1.0, mag), n)


def face_normals(points: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(N, 3) points, (F, 3) int faces -> (F, 3) unit face normals.

    Degenerate faces keep their zero normal (the reference's ``if mag > 0``,
    mesh.rs:22-25). The cross product and the norm are written out as K5
    computes them, so the two agree bitwise. The square root is taken in
    float64 and rounded once, which is the correctly rounded float32 root:
    PyTorch's float32 ``sqrt`` on the CPU is 1 ulp off for ~0.6% of inputs.
    """
    faces = faces.long()
    return _normal(points[faces[:, 0]], points[faces[:, 1]], points[faces[:, 2]])


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


#: A corner-table entry's first word keeps the vertex's place in its face
#: (0, 1, 2) in its top two bits; all ones marks a padding slot.
_PLACE_SHIFT = 30
_ID_MASK = (1 << _PLACE_SHIFT) - 1
PAD = 3


def incidence(faces: np.ndarray, n_vertices: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The incident faces of each vertex, in face order: slot-major (D, N)
    face ids padded with F, the vertex's place in each face (0, 1, 2; PAD
    in a padding slot), and the (N,) incident-face counts. A face with a
    repeated corner is incident once per corner."""
    faces = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
    if faces.size and (faces.min() < 0 or faces.max() >= n_vertices):
        raise ValueError(f"face ids must lie in [0, {n_vertices})")
    if n_vertices >= 1 << _PLACE_SHIFT:
        raise ValueError(f"at most 2^{_PLACE_SHIFT} - 1 vertices")
    f = faces.reshape(-1)  # corners, face-major
    order = np.argsort(f, kind="stable")  # per-vertex groups, in face order
    fs = f[order]
    counts = np.bincount(f, minlength=n_vertices)
    degree = max(int(counts.max()) if counts.size else 1, 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(f.size, dtype=np.int64) - starts[fs]
    ids = np.full((degree, n_vertices), faces.shape[0], dtype=np.int64)
    place = np.full((degree, n_vertices), PAD, dtype=np.int64)
    ids[rank, fs] = order // 3
    place[rank, fs] = order % 3
    return ids, place, counts


def corner_table(faces: np.ndarray, n_vertices: int) -> tuple[np.ndarray, np.ndarray]:
    """K5's topology: a slot-major (D, N, 2) int32 table whose slot d of
    vertex v holds the two other corners of v's d-th incident face, in the
    face's cyclic order after v, with v's place in the face in the top two
    bits of the first word (all ones in a padding slot); and the (N,)
    float32 incident-face counts."""
    faces = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
    ids, place, counts = incidence(faces, n_vertices)
    pad = place == PAD
    corners = faces[np.where(pad, 0, ids)] if faces.size else np.zeros((*ids.shape, 3), np.int64)
    k = np.where(pad, 0, place)[..., None]
    a = np.take_along_axis(corners, (k + 1) % 3, axis=-1)[..., 0]
    b = np.take_along_axis(corners, (k + 2) % 3, axis=-1)[..., 0]
    first = np.where(pad, 0xFFFFFFFF, a | (place << _PLACE_SHIFT))
    table = np.stack([first, np.where(pad, 0xFFFFFFFF, b)], axis=-1).astype(np.uint32).view(np.int32)
    return table, counts.astype(np.float32)


def vertex_normals_plain(points: torch.Tensor, table: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The plain-PyTorch twin of K5: each slot's face normal from the corner
    table, its corners put back in the face's own order; a left fold over
    the slots in face order; division by the count. A padding slot adds
    +0.0, which turns a -0.0 sum into +0.0; K5 adds the same zero."""
    words = table.long() & 0xFFFFFFFF
    place = words[..., 0] >> _PLACE_SHIFT
    pad = place == PAD
    v = torch.arange(table.shape[1], device=table.device).expand(place.shape)
    a = torch.where(pad, v, words[..., 0] & _ID_MASK)
    b = torch.where(pad, v, words[..., 1])
    c0 = torch.where(place == 0, v, torch.where(place == 1, b, a))
    c1 = torch.where(place == 0, a, torch.where(place == 1, v, b))
    c2 = torch.where(place == 0, b, torch.where(place == 1, a, v))
    fn = torch.where(pad[..., None], 0.0, _normal(points[c0], points[c1], points[c2]))
    acc = fn[0]
    for d in range(1, fn.shape[0]):
        acc = acc + fn[d]
    return acc / counts[:, None]


def _topology(table: torch.Tensor, counts: torch.Tensor) -> tuple:
    """K5's arguments after the points: table, counts, N, D."""
    return table.data_ptr(), counts.data_ptr(), table.shape[1], table.shape[0]


def _launch(points: torch.Tensor, topology: tuple) -> torch.Tensor:
    """One launch of K5 on checked tensors; returns the (N, 3) output."""
    out = torch.empty((points.shape[0], 3), dtype=torch.float32, device=points.device)
    _kernels.launch("K5", points.data_ptr(), *topology, out.data_ptr(),
                    ctypes.c_void_p(torch.cuda.current_stream(points.device).cuda_stream))
    return out


def _check_topology(table: torch.Tensor, counts: torch.Tensor, n: int, device) -> None:
    d = table.shape[0]
    _kernels.check_tensor(table, "table", (d, n, 2), torch.int32, device)
    _kernels.check_tensor(counts, "counts", (n,), torch.float32, device)
    if d < 1:
        raise ValueError("the corner table needs at least one slot")


def vertex_normals(
    points: torch.Tensor,  # (N, 3) f32
    table: torch.Tensor,  # (D, N, 2) int32 corner table (corner_table)
    counts: torch.Tensor,  # (N,) f32 incident-face counts
) -> torch.Tensor:
    """(N, 3) f32 vertex normals through a precomputed corner table."""
    if points.device.type == "cpu":
        return vertex_normals_plain(points, table, counts)
    if points.device.type != "cuda":
        raise ValueError(f"vertex_normals runs on cuda or cpu tensors, got {points.device}")
    n = points.shape[0]
    _kernels.check_tensor(points, "points", (n, 3), torch.float32, points.device)
    _check_topology(table, counts, n, points.device)
    return _launch(points, _topology(table, counts))


class MeshNormals:
    """Vertex-normal evaluator for a fixed topology (see the module
    docstring). Same semantics as :func:`compute_vertex_normals`; sums run
    in face order. The corner table is built on the host and copied to
    ``device`` (the card unless the caller asks for the CPU) once; call it
    with points on that device."""

    def __init__(self, faces, n_vertices: int, device="cuda"):
        faces_np = np.asarray(faces.cpu() if isinstance(faces, torch.Tensor) else faces, dtype=np.int64)
        table, counts = corner_table(faces_np, n_vertices)
        self.n_vertices = n_vertices
        self.degree = table.shape[0]
        self.table = torch.from_numpy(table).to(device)  # (D, N, 2)
        self.counts = torch.from_numpy(counts).to(device)
        self.device = self.table.device
        if self.device.type == "cuda":
            _check_topology(self.table, self.counts, n_vertices, self.device)
            self._topology = _topology(self.table, self.counts)

    def __call__(self, points: torch.Tensor) -> torch.Tensor:
        if points.device != self.device:
            raise ValueError(f"points are on {points.device}, the topology on {self.device}")
        if self.device.type != "cuda":
            return vertex_normals(points, self.table, self.counts)
        _kernels.check_tensor(points, "points", (self.n_vertices, 3), torch.float32, self.device)
        return _launch(points, self._topology)
