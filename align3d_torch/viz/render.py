"""Z-buffered rasterizer on tensors: point splats and triangles (port of
``align3d_tpu/viz/render.py``).

The software analog of the reference's two Vulkan pipelines: point clouds
render as camera-facing discs (``viz/geometry/vkpointcloud.rs``), meshes as
diffuse-shaded triangles (``viz/geometry/vkmesh.rs``). The targets and all
geometry are tensors on the renderer's device (the card unless the caller
asks for the CPU); the only host copy is the finished colour, for a PNG.

The arithmetic is the JAX package's numpy, op for op, in the same types,
and each z-test keeps numpy's rule, decided by one ``scatter_reduce`` of
int64 keys instead of numpy's sorted overwrite. Min is order-independent,
so a render is deterministic on the card and bitwise the CPU's:

* numpy's float32 matrix products round like fused multiply-adds over the
  three coordinates in order (OpenBLAS's sgemm); :func:`_fma_rows`
  reproduces that in float64, where a product of two float32 is exact;
* points: in each (dx, dy) pass of the disc footprint, the winner at a
  pixel is the smallest z, ties to the largest point index (numpy sorts -z
  stably and the last write wins), written where its z <= the depth
  before the pass. Key: the orderable bits of z (-0.0 counted as +0.0, as
  numpy compares), then ``0xFFFFFFFF - index``;
* triangles: numpy walks the faces in order, testing each pixel of a
  face's bounding box with float64 barycentrics (``int64 grid - float32``
  promotes to float64) against the float32 depth so far. Its result is
  fixed by the float32-rounded depths: the smallest one, v, wins; among
  the faces that round to v, the last whose float64 depth is <= v, or
  else the first of them. The key is v's orderable bits, then that order.
  The winner is written where its float64 depth is <= the depth before
  the mesh, and its colour truncated to uint8 as numpy casts it.
"""

from __future__ import annotations

import numpy as np
import torch

from align3d_torch.io import png
from align3d_torch.viz.virtual_camera import VirtualCamera

_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.uint8): torch.uint8, np.dtype(np.int64): torch.int64}
_EMPTY = torch.iinfo(torch.int64).max
_LOW = 0xFFFFFFFF
_HALF = 0x80000000
# (face, pixel) pairs a mesh render enumerates at once: ~200 B of
# temporaries each, so ~0.4 GB a chunk.
PAIR_CHUNK = 1 << 21


def _resolve_device(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def on_device(value, dtype: np.dtype, device: torch.device) -> torch.Tensor:
    """A tensor on ``device`` of ``value``: host data is converted as numpy
    converts it and uploaded; a tensor must already be on ``device`` (the
    renderer never copies geometry between devices behind the caller)."""
    if isinstance(value, torch.Tensor):
        if value.device != device:
            raise ValueError(f"a tensor on {value.device} given to a renderer on {device}")
        return value.to(_DTYPES[np.dtype(dtype)])
    return torch.from_numpy(np.array(value, dtype, order="C")).to(device)


def _fma_rows(rows: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(R, 3) float64 (float32 values) x (N, 3) float32 -> (R, N) float32
    ``fma(r2, p2, fma(r1, p1, r0 * p0))`` per row, each step rounded to
    float32: numpy's ``rows @ points.T`` for these shapes."""
    p = points.to(torch.float64)
    acc = (rows[:, 0:1] * p[:, 0]).to(torch.float32)
    acc = (rows[:, 1:2] * p[:, 1] + acc.to(torch.float64)).to(torch.float32)
    return (rows[:, 2:3] * p[:, 2] + acc.to(torch.float64)).to(torch.float32)


def _orderable(z: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 ordered as the floats, -0.0 equal to +0.0."""
    bits = torch.where(z == 0, 0.0, z).view(torch.int32).to(torch.int64)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


class RenderImage:
    """Color + depth target (reference ``offscreen_render.rs`` RenderImage):
    ``color`` (H, W, 4) uint8 and ``depth`` (H, W) float32 on ``device``."""

    def __init__(self, width: int, height: int, background=(0, 0, 0, 255), device="cuda"):
        self.width = width
        self.height = height
        self.color = torch.empty((height, width, 4), dtype=torch.uint8, device=device)
        self.color[:] = torch.from_numpy(np.asarray(background, np.uint8)).to(device)
        self.depth = torch.full((height, width), float("inf"), dtype=torch.float32, device=device)

    def save_png(self, path) -> None:
        png.write(path, self.color.cpu().numpy())


def _project(camera: VirtualCamera, points: torch.Tensor, width: int, height: int):
    """World points -> (x_px, y_px, z_ndc, in_front) via the camera VP."""
    vp = camera.view_projection()
    rows = _fma_rows(torch.from_numpy(vp[:, :3].astype(np.float64)).to(points.device), points)
    bias = torch.from_numpy(vp[:, 3].copy()).to(points.device)
    hom = rows[:3] + bias[:3, None]  # (3, N) of x', y', z'
    w = rows[3] + bias[3]  # (N,)
    in_front = w > 1e-9
    w_safe = torch.where(in_front, w, 1.0)
    ndc = hom / w_safe
    x = (ndc[0] * 0.5 + 0.5) * (width - 1)
    # NDC +y is up; pixel +y is down (the Y flip the reference bakes into its
    # node graph, viz/node.rs:32-40).
    y = (0.5 - ndc[1] * 0.5) * (height - 1)
    return x, y, ndc[2], in_front & (ndc[2].abs() <= 1.0)


class OffscreenRenderer:
    """Render geometry into a ``RenderImage`` (reference
    ``viz/offscreen_render.rs:29-209``) on ``device``."""

    def __init__(self, width: int = 640, height: int = 480, background=(0, 0, 0, 255), device="cuda"):
        self.width = width
        self.height = height
        self.background = background
        self.device = _resolve_device(device)

    def new_target(self) -> RenderImage:
        return RenderImage(self.width, self.height, self.background, self.device)

    def render_points(
        self,
        target: RenderImage,
        camera: VirtualCamera,
        points,  # (N, 3) world
        colors=None,  # (N, 3) u8
        radius_px: int = 1,
    ) -> None:
        """Splat points as z-tested discs of ``radius_px``."""
        points = on_device(points, np.float32, self.device).reshape(-1, 3)
        x, y, z, ok = _project(camera, points, self.width, self.height)
        n = x.shape[0]
        if colors is None:
            colors = torch.full((n, 3), 200, dtype=torch.uint8, device=self.device)
        colors = on_device(colors, np.uint8, self.device).reshape(-1, 3)

        xi = torch.round(x).to(torch.int64)
        yi = torch.round(y).to(torch.int64)
        keys = _orderable(z) * (1 << 32) + (_LOW - torch.arange(n, device=self.device))
        pixels = self.width * self.height
        depth = target.depth.view(-1)
        color = target.color.view(-1, 4)
        for dy in range(-radius_px + 1, radius_px):
            for dx in range(-radius_px + 1, radius_px):
                if dx * dx + dy * dy >= radius_px * radius_px and radius_px > 1:
                    continue  # disc footprint, not square
                xs = xi + dx
                ys = yi + dy
                sel = ok & (xs >= 0) & (xs < self.width) & (ys >= 0) & (ys < self.height)
                flat = torch.where(sel, ys * self.width + xs, pixels)  # the rest to a spare slot
                best = torch.full((pixels + 1,), _EMPTY, dtype=torch.int64, device=self.device)
                best.scatter_reduce_(0, flat, keys, "amin")
                best = best[:pixels]
                hit = best != _EMPTY
                winner = torch.where(hit, _LOW - (best & _LOW), 0)
                zw = z[winner]
                write = hit & (zw <= depth)
                depth.copy_(torch.where(write, zw, depth))
                color[:, :3] = torch.where(write[:, None], colors[winner], color[:, :3])
                color[:, 3] = torch.where(write, 255, color[:, 3])

    def render_mesh(
        self,
        target: RenderImage,
        camera: VirtualCamera,
        points,  # (N, 3)
        faces,  # (F, 3) int
        normals=None,
        base_color=(180, 180, 190),
    ) -> None:
        """Diffuse-shaded triangle raster (vkmesh.rs pipeline equivalent).
        Without ``normals``, the vertex normals come from
        :class:`align3d_torch.ops.mesh.MeshNormals` (one K5 launch on the
        card, after a host build of its corner table; a
        :class:`align3d_torch.viz.scene.Node` keeps that table between
        renders)."""
        points = on_device(points, np.float32, self.device).reshape(-1, 3)
        faces = on_device(faces, np.int64, self.device).reshape(-1, 3)
        x, y, z, ok = _project(camera, points, self.width, self.height)
        if normals is None:
            from align3d_torch.ops.mesh import MeshNormals

            normals = MeshNormals(faces, points.shape[0], device=self.device)(points.contiguous())
        normals = torch.nan_to_num(on_device(normals, np.float32, self.device).reshape(-1, 3))
        light = torch.from_numpy(-np.asarray(camera.view, np.float32)).to(self.device, torch.float64)
        shade = _fma_rows(light[None], normals)[0].clamp(0.15, 1.0)  # headlight diffuse
        base = torch.from_numpy(np.asarray(base_color, np.float32)).to(self.device)
        vcol = (shade[:, None] * base[None, :]).clamp(0, 255)

        mesh = _FaceRaster(x, y, z, ok, faces, self.width, self.height)
        pixels = self.width * self.height
        best = torch.full((pixels + 1,), _EMPTY, dtype=torch.int64, device=self.device)
        for first, last, pairs in mesh.chunks(PAIR_CHUNK):
            face, gx, gy = mesh.pairs(first, last, pairs)
            l0, l1, l2, zpix = mesh.barycentric(face, gx, gy)
            inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
            rounded = zpix.to(torch.float32)
            order = torch.where(zpix <= rounded.to(torch.float64), _HALF - 1 - face, _HALF + face)
            key = _orderable(rounded) * (1 << 32) + order
            best.scatter_reduce_(0, torch.where(inside, gy * self.width + gx, pixels), key, "amin")

        best = best[:pixels]
        hit = best != _EMPTY
        order = best & _LOW
        face = torch.where(hit, torch.where(order >= _HALF, order - _HALF, _HALF - 1 - order), 0)
        pix = torch.arange(pixels, device=self.device)
        l0, l1, l2, zpix = mesh.barycentric(face, pix % self.width, pix // self.width)
        depth = target.depth.view(-1)
        write = hit & (zpix <= depth.to(torch.float64))
        depth.copy_(torch.where(write, zpix.to(torch.float32), depth))
        corners = vcol.to(torch.float64)[faces[face]]  # (pixels, 3 corners, 3 channels)
        cpix = l0[:, None] * corners[:, 0] + l1[:, None] * corners[:, 1] + l2[:, None] * corners[:, 2]
        color = target.color.view(-1, 4)
        color[:, :3] = torch.where(write[:, None], cpix.to(torch.uint8), color[:, :3])
        color[:, 3] = torch.where(write, 255, color[:, 3])


class _FaceRaster:
    """Per-face bounding boxes and float64 barycentric coefficients of one
    mesh render; numpy's skipped faces (a corner outside the clip range, an
    empty box, ``|d| < 1e-12``) cover no pixel."""

    def __init__(self, x, y, z, ok, faces, width: int, height: int):
        face_ok = ok[faces].all(dim=1)
        xs = torch.where(face_ok[:, None], x[faces], 0.0)
        ys = torch.where(face_ok[:, None], y[faces], 0.0)
        zs = z[faces]
        # numpy's max(int(floor(min)), 0) .. min(int(ceil(max)), W - 1),
        # clamped in float first so that no float meets an int64 overflow.
        self.minx = torch.floor(xs.min(dim=1).values).clamp(0, width).to(torch.int64)
        maxx = torch.ceil(xs.max(dim=1).values).clamp(-1, width - 1).to(torch.int64)
        self.miny = torch.floor(ys.min(dim=1).values).clamp(0, height).to(torch.int64)
        maxy = torch.ceil(ys.max(dim=1).values).clamp(-1, height - 1).to(torch.int64)
        x0, x1, x2 = xs.unbind(dim=1)
        y0, y1, y2 = ys.unbind(dim=1)
        d = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
        valid = face_ok & (self.minx <= maxx) & (self.miny <= maxy) & ~(d.abs() < 1e-12)
        self.nx = maxx - self.minx + 1
        self.counts = torch.where(valid, self.nx * (maxy - self.miny + 1), 0)
        # float32 differences, then float64: numpy's float32 scalars times
        # the float64 grid offsets.
        self.coef = torch.stack([y1 - y2, x2 - x1, y2 - y0, x0 - x2, x2, y2, d, *zs.unbind(dim=1)],
                                dim=1).to(torch.float64)

    def chunks(self, budget: int):
        """(first face, end face, pairs) runs of whole faces, each of at most
        ``budget`` pairs unless one face alone has more."""
        ends = torch.cumsum(self.counts, dim=0)
        if ends.numel() == 0 or int(ends[-1]) == 0:
            return
        total = int(ends[-1])
        cuts = torch.searchsorted(ends, torch.tensor(range(budget, total, budget), dtype=ends.dtype,
                                                     device=ends.device), right=True)
        bounds = [0] + sorted(set(cuts.tolist()) - {0}) + [len(ends)]
        at = torch.cat([torch.zeros(1, dtype=ends.dtype, device=ends.device), ends])[bounds].tolist()
        for k in range(len(bounds) - 1):
            if at[k + 1] > at[k]:
                yield bounds[k], bounds[k + 1], at[k + 1] - at[k]

    def pairs(self, first: int, last: int, pairs: int):
        """Each (face, pixel) pair of faces ``first..last - 1``'s boxes."""
        counts = self.counts[first:last]
        local = torch.repeat_interleave(torch.arange(counts.numel(), device=counts.device), counts,
                                        output_size=pairs)
        offset = torch.arange(pairs, device=counts.device) - (torch.cumsum(counts, dim=0) - counts)[local]
        face = local + first
        nx = self.nx[face]
        return face, self.minx[face] + offset % nx, self.miny[face] + offset // nx

    def barycentric(self, face, gx, gy):
        """numpy's float64 (l0, l1, l2, zpix) of each face at pixel (gx, gy)."""
        a0, b0, a1, b1, x2, y2, d, z0, z1, z2 = self.coef[face].unbind(dim=1)
        ox = gx.to(torch.float64) - x2
        oy = gy.to(torch.float64) - y2
        l0 = (a0 * ox + b0 * oy) / d
        l1 = (a1 * ox + b1 * oy) / d
        l2 = 1.0 - l0 - l1
        return l0, l1, l2, l0 * z0 + l1 * z1 + l2 * z2
