"""Bilateral-grid depth filter (port of ``align3d_tpu/ops/bilateral.py``).

Chen/Paris/Durand real-time bilateral grid, as the reference
(``src/bilateral/``): splat the depth image into a (gh, gw, gd) value/count
grid, blur it along each axis with two masked 1-2-1/4 passes, normalize,
and slice it back trilinearly at every pixel (holes included, so the filter
fills holes next to valid depth).

The grid is channel-major, (2, gh, gw, gd) = [value, count], the JAX
package's layout. Every stage takes a leading frame axis: images are
(..., H, W), grids (..., 2, gh, gw, gd), and ``color_min`` /
``depth_limit`` are a Python int or a tensor with the images' leading shape.
One frame is the batch of one; the batch runs through one splat launch and
one slice launch (``csrc/bilateral.cu``) on a CUDA tensor, and through their
plain twins on a CPU tensor. The filter's slice is the kernel's form (b),
:func:`_normalize_slice`: it normalizes each grid corner as it reads it and
writes the depth type, so the filter writes no normalized grid and runs no
separate cast; :meth:`BilateralGrid.normalize` and :meth:`BilateralGrid.slice`
(form (a), :func:`_slice`) stay for callers who want the normalized grid or
the float sample. The blur and the normalization are elementwise, so a
frame's output is the same bits in any batch. The spatial
grid<->image maps depend only on pixel positions, so they are numpy tables
copied to the device once per shape and device; only the range coordinate
depends on the data.

Conventions kept from the JAX package:

* ``gh``, ``gw`` and ``gd`` come from the same Python-float expressions, so
  ``sigma_space = 4.50000000225`` gives gw = 146 at width 640, not 147;
* :meth:`BilateralGrid.from_image` (and so :meth:`BilateralFilter.filter`)
  takes ``color_min`` as the minimum of the image *including* zero holes;
  :func:`plan_depth_buckets` and its callers take the *nonzero* minimum;
* the depth axis may be padded (``pad_depth_to``, or a bucket's depth) and
  the blur's exclusion sits at the true depth (``depth_limit``), so padding
  changes no output; the depth axis has no exclusion at channel 0, which
  only holes read, and only under the nonzero-minimum convention;
* the sliced value goes back to the depth type by truncation.
"""

from __future__ import annotations

import ctypes
import dataclasses
from functools import lru_cache

import numpy as np
import torch

from align3d_torch import _kernels

_SPACE_PAD = 2
_COLOR_PAD = 2

# Read by benchmark/trace.py; goes when a benchmark change reads _kernels.launches() instead.
__getattr__ = _kernels.legacy_counts(
    __name__, {"SPLAT_LAUNCHES": "K2", "SLICE_LAUNCHES": "K3a", "NORMALIZE_SLICE_LAUNCHES": "K3b"})
#: Calls of :func:`_normalize`, each a pass over whole grids (set to 0 to reset).
NORMALIZE_PASSES = 0


def _splat_window(n_src: int, n_dst: int, inv_ss: float, pad: int) -> tuple[np.ndarray, np.ndarray]:
    """Per grid index, its contributing source indices (ascending) as an
    (n_dst, width) table with 0/1 weights for used slots. Each source index
    lands at ``trunc(src * inv_ss + 0.5) + pad`` (grid.rs:59-66)."""
    dst = (np.arange(n_src, dtype=np.float32) * np.float32(inv_ss) + 0.5).astype(np.int32) + pad
    groups: list[list[int]] = [[] for _ in range(n_dst)]
    for s, d in enumerate(dst):
        if 0 <= d < n_dst:
            groups[d].append(s)
    width = max((len(v) for v in groups), default=1) or 1
    idx = np.zeros((n_dst, width), np.int32)
    wt = np.zeros((n_dst, width), np.float32)
    for d, v in enumerate(groups):
        for t, s in enumerate(v):
            idx[d, t] = s
            wt[d, t] = 1.0
    return idx, wt


def _axis_indices(n: int, inv_ss: float, n_grid: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static trilinear corners along one spatial axis: (i0, i1, alpha)."""
    coord = np.arange(n, dtype=np.float32) * np.float32(inv_ss) + _SPACE_PAD
    i0 = np.clip(coord.astype(np.int32), 0, n_grid - 1)
    i1 = np.clip((coord + 1.0).astype(np.int32), 0, n_grid - 1)
    return i0, i1, (coord - i0).astype(np.float32)


def _grid_dims(h: int, w: int, sigma_space: float) -> tuple[int, int]:
    gh = int((h - 1) / sigma_space) + 1 + 2 * _SPACE_PAD
    gw = int((w - 1) / sigma_space) + 1 + 2 * _COLOR_PAD
    return gh, gw


def true_depth(color_min: float, color_max: float, sigma_color: float) -> int:
    """The reference's grid depth for a depth span (grid.rs:51-54)."""
    return int((float(color_max) - float(color_min)) / sigma_color) + 1 + 2 * _COLOR_PAD


def grid_geometry(
    image: torch.Tensor, sigma_space: float, sigma_color: float, pad_depth_to: int = 1
) -> tuple[torch.Tensor, tuple[int, int, int], int]:
    """``(color_min, (gh, gw, gd), true_gd)`` of an image's grid, with
    ``color_min`` the minimum including holes, a 0-d tensor on the image's
    device (so the kernels read it without a copy per call): ``gd`` is the
    true depth ``true_gd`` padded up to a multiple of ``pad_depth_to``."""
    gh, gw = _grid_dims(*image.shape[-2:], sigma_space)
    lo, hi = torch.aminmax(image)
    true_gd = true_depth(int(lo), int(hi), sigma_color)  # sizes the grid
    return lo, (gh, gw, -(-true_gd // pad_depth_to) * pad_depth_to), true_gd


def nonzero_min_max(images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-frame nonzero minimum and maximum of (..., H, W) depth images, on
    their device (a frame without valid depth gets 65535 as its minimum)."""
    flat = images.flatten(-2)
    cmin = torch.where(flat > 0, flat, 65535).amin(dim=-1)
    return cmin.to(torch.int32), flat.amax(dim=-1).to(torch.int32)


def _to_device(arrays, device: torch.device) -> tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


@lru_cache(maxsize=None)
def _splat_tables(h: int, w: int, gh: int, gw: int, sigma_space: float, device: torch.device):
    """(row index, row weight, column index, column weight) windows on ``device``."""
    inv_ss = 1.0 / sigma_space
    return _to_device(_splat_window(h, gh, inv_ss, _SPACE_PAD) + _splat_window(w, gw, inv_ss, _SPACE_PAD), device)


def _frames(image: torch.Tensor, color_min) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., H, W) images and their color_min (an int, or a tensor of the
    leading shape) -> (B, H, W) frames and a (B,) int32 color_min."""
    frames = image.reshape(-1, *image.shape[-2:])
    cmin = torch.as_tensor(color_min, device=image.device).to(torch.int32).reshape(-1)
    if cmin.numel() != frames.shape[0]:
        cmin = cmin.expand(frames.shape[0])
    return frames, cmin.contiguous()


# -- splat (K2) ------------------------------------------------------------


def _splat_plain(image, color_min, grid_shape, sigma_space: float, sigma_color: float) -> torch.Tensor:
    """The XLA one-hot form of the JAX ``_splat``: per window tap in order
    t = a * B + b, ``acc += onehot * w`` (bitwise equal to it)."""
    frames, cmin = _frames(image, color_min)
    gh, gw, gd = grid_shape
    h, w = frames.shape[1:]
    ridx, rwt, cidx, cwt = _splat_tables(h, w, gh, gw, sigma_space, image.device)
    vals = frames.to(torch.float32)
    valid = (frames > 0).to(torch.float32)
    chan = ((vals - cmin.to(torch.float32)[:, None, None]) * (1.0 / sigma_color) + 0.5).to(torch.int32) + _COLOR_PAD

    def window(x):
        return x[:, ridx.long()][..., cidx.long()]  # (B, gh, A, gw, Bt)

    zed = window(chan)
    val_t = window(vals)
    w_t = window(valid) * (rwt[:, :, None, None] * cwt[None, None, :, :])
    kk = torch.arange(gd, dtype=torch.int32, device=image.device)
    acc_v = torch.zeros((frames.shape[0], gh, gw, gd), dtype=torch.float32, device=image.device)
    acc_c = torch.zeros_like(acc_v)
    for a in range(zed.shape[2]):
        for b in range(zed.shape[4]):
            oh = (kk == zed[:, :, a, :, b, None]).to(torch.float32)
            acc_c = acc_c + oh * w_t[:, :, a, :, b, None]
            acc_v = acc_v + oh * (w_t[:, :, a, :, b] * val_t[:, :, a, :, b])[..., None]
    return torch.stack([acc_v, acc_c], dim=1).reshape(*image.shape[:-2], 2, gh, gw, gd)


def _splat(image, color_min, grid_shape, sigma_space: float, sigma_color: float) -> torch.Tensor:
    """Depth values and counts of (..., H, W) int32 images into channel-major
    (..., 2, gh, gw, gd) grids: one kernel launch for all frames."""
    if image.device.type == "cpu":
        return _splat_plain(image, color_min, grid_shape, sigma_space, sigma_color)
    if image.device.type != "cuda":
        raise ValueError(f"_splat runs on cuda or cpu tensors, got {image.device}")
    if image.dtype != torch.int32 or image.ndim < 2 or not image.is_contiguous():
        raise ValueError("_splat takes contiguous (..., H, W) int32 depth images")

    frames, cmin = _frames(image, color_min)
    out = torch.empty((*image.shape[:-2], 2, *grid_shape), dtype=torch.float32, device=image.device)
    _splat_launch(frames, cmin, grid_shape, sigma_space, sigma_color, out)
    return out


def _splat_launch(frames, cmin, grid_shape, sigma_space: float, sigma_color: float, out, library=None) -> None:
    """Launch K2 on (B, H, W) int32 frames with their (B,) int32
    color_min, into the contiguous grids ``out``. ``library``: another build
    of ``csrc/bilateral.cu`` (the ablation tool's); the library's by
    default."""
    gh, gw, gd = grid_shape
    bsz, h, w = frames.shape
    ridx, rwt, cidx, cwt = _splat_tables(h, w, gh, gw, sigma_space, frames.device)
    _kernels.launch(
        "K2", frames.data_ptr(), cmin.data_ptr(), bsz, h, w, float(np.float32(1.0 / sigma_color)),
        ridx.data_ptr(), rwt.data_ptr(), ridx.shape[1],
        cidx.data_ptr(), cwt.data_ptr(), cidx.shape[1],
        gh, gw, gd, out.data_ptr(),
        ctypes.c_void_p(torch.cuda.current_stream(frames.device).cuda_stream), library=library,
    )


# -- blur and normalize ----------------------------------------------------


def _pass_121(x: torch.Tensor, dim: int) -> torch.Tensor:
    """One 1-2-1/4 pass along ``dim`` with zeros outside:
    ``(0.5 x[i] + 0.25 x[i-1]) + 0.25 x[i+1]``."""
    n = x.shape[dim]
    out = x * 0.5
    out.narrow(dim, 1, n - 1).add_(x.narrow(dim, 0, n - 1) * 0.25)
    out.narrow(dim, 0, n - 1).add_(x.narrow(dim, 1, n - 1) * 0.25)
    return out


def _interior(n: int, dim: int, device: torch.device) -> torch.Tensor:
    """The 0/1 interior mask ``0 < i < n - 1`` shaped to broadcast along ``dim``."""
    idx = torch.arange(n, device=device)
    return ((idx > 0) & (idx < n - 1)).to(torch.float32).reshape((n,) + (1,) * (-1 - dim))


def _blur(grid: torch.Tensor, depth_limit) -> torch.Tensor:
    """3-axis x 2-pass blur of channel-major (..., 2, gh, gw, gd) grids.

    Per axis ``M T M T M`` with T the 1-2-1/4 stencil and M the axis's mask
    (edge_aware_filter.rs:57-115 writes interior cells only), the matrix the
    JAX package contracts on the MXU, applied here as elementwise passes so
    that a frame's result does not depend on the batch around it. The depth
    axis's mask is ``z < depth_limit - 1`` per frame, at its true depth.
    """
    gd = grid.shape[-1]
    limit = torch.as_tensor(depth_limit, device=grid.device)
    limit = limit.reshape(limit.shape + (1, 1, 1, 1))  # one limit, or one per frame
    masks = (
        (-3, _interior(grid.shape[-3], -3, grid.device)),
        (-2, _interior(grid.shape[-2], -2, grid.device)),
        (-1, (torch.arange(gd, device=grid.device) < limit - 1).to(torch.float32)),
    )
    out = grid
    for dim, mask in masks:
        out = out * mask
        out = _pass_121(out, dim).mul_(mask)
        out = _pass_121(out, dim).mul_(mask)
    return out


def _normalize(grid: torch.Tensor) -> torch.Tensor:
    """value /= count and count -> 1 where count > 0 (grid.rs:90-104)."""
    global NORMALIZE_PASSES
    NORMALIZE_PASSES += 1
    val, cnt = grid[..., 0, :, :, :], grid[..., 1, :, :, :]
    has = cnt > 0
    val = torch.where(has, val / torch.where(has, cnt, 1.0), val)
    cnt = torch.where(has, 1.0, cnt)
    return torch.stack([val, cnt], dim=-4)


# -- slice (K3) ------------------------------------------------------------


@lru_cache(maxsize=None)
def _slice_tables(h: int, w: int, gh: int, gw: int, sigma_space: float, device: torch.device):
    """(y0, y1, ya, x0, x1, xa) on ``device``."""
    inv_ss = 1.0 / sigma_space
    y0, _, ya = _axis_indices(h, inv_ss, gh)
    y1 = np.clip(y0 + 1, 0, gh - 1).astype(np.int32)  # the JAX _slice's row-group y1
    x0, x1, xa = _axis_indices(w, inv_ss, gw)
    return _to_device((y0, y1, ya, x0, x1, xa), device)


def _slice_plain(grid, image, color_min, sigma_space: float, sigma_color: float) -> torch.Tensor:
    """Per-pixel trilinear sample of the value channel (grid.rs:106-162).

    The JAX ``_slice`` reduces a one-hot z weight against every channel;
    gathering the z0 and z1 channels gives the same two non-zero terms with
    the same arithmetic, without the (H, W, gd) intermediates.
    """
    frames, cmin = _frames(image, color_min)
    gh, gw, gd = grid.shape[-3:]
    h, w = frames.shape[1:]
    y0, y1, ya, x0, x1, xa = _slice_tables(h, w, gh, gw, sigma_space, image.device)
    y0, y1, x0, x1 = (t.long()[None] for t in (y0, y1, x0, x1))
    ya, xa = ya[:, None], xa[None, :]
    val = grid.reshape(-1, 2, gh, gw, gd)[:, 0]
    fb = torch.arange(frames.shape[0], device=image.device)[:, None, None]

    chan = (frames.to(torch.float32) - cmin.to(torch.float32)[:, None, None]) * (1.0 / sigma_color) + _COLOR_PAD
    z0 = torch.clamp(chan.to(torch.int32), 0, gd - 1)
    z1 = torch.clamp((chan + 1.0).to(torch.int32), 0, gd - 1)
    za = chan - z0.to(torch.float32)

    def pmix(z):
        z = z.long()
        p0 = val[fb, y0[..., None], x0[:, None, :], z] * (1.0 - xa) + val[fb, y0[..., None], x1[:, None, :], z] * xa
        p1 = val[fb, y1[..., None], x0[:, None, :], z] * (1.0 - xa) + val[fb, y1[..., None], x1[:, None, :], z] * xa
        return p0 * (1.0 - ya) + p1 * ya

    m0 = pmix(z0)
    m1 = pmix(z1)
    out = torch.where(z0 == z1, ((1.0 - za) + za) * m0, (1.0 - za) * m0 + za * m1)
    return out.reshape(image.shape)


def _normalize_slice_plain(grid, image, color_min, sigma_space: float, sigma_color: float) -> torch.Tensor:
    """The plain twin of the slice kernel's form (b): ``_normalize``, the
    float sample of :func:`_slice_plain`, then the cast to the image's type."""
    return _slice_plain(_normalize(grid), image, color_min, sigma_space, sigma_color).to(image.dtype)


def _slice(grid, image, color_min, sigma_space: float, sigma_color: float) -> torch.Tensor:
    """Sample normalized (..., 2, gh, gw, gd) grids back at every pixel of
    their (..., H, W) images -> (..., H, W) float32: one launch of the slice
    kernel's form (a)."""
    if image.device.type == "cpu":
        return _slice_plain(grid, image, color_min, sigma_space, sigma_color)
    return _slice_launch(grid, image, color_min, sigma_space, sigma_color, fused=False)


def _normalize_slice(grid, image, color_min, sigma_space: float, sigma_color: float) -> torch.Tensor:
    """``_slice(_normalize(grid), ...).to(image.dtype)`` bit for bit, from the
    blurred, un-normalized (..., 2, gh, gw, gd) grids: one launch of the
    slice kernel's form (b), which normalizes each corner it reads and
    writes the (..., H, W) int32 output directly."""
    if image.device.type == "cpu":
        return _normalize_slice_plain(grid, image, color_min, sigma_space, sigma_color)
    return _slice_launch(grid, image, color_min, sigma_space, sigma_color, fused=True)


def _slice_launch(grid, image, color_min, sigma_space: float, sigma_color: float, fused: bool,
                  library=None) -> torch.Tensor:
    """One launch of the slice kernel on CUDA tensors: form (b) (K3b, int32
    out) with ``fused``, else form (a) (K3a, float32 out). ``library``:
    another build of ``csrc/bilateral.cu`` (the ablation tool's); the
    library's by default."""
    if image.device.type != "cuda":
        raise ValueError(f"the slice runs on cuda or cpu tensors, got {image.device}")
    if image.dtype != torch.int32 or image.ndim < 2 or not image.is_contiguous():
        raise ValueError("the slice takes contiguous (..., H, W) int32 depth images")
    if (grid.dtype != torch.float32 or grid.shape[:-4] != image.shape[:-2] or grid.ndim != image.ndim + 2
            or grid.shape[-4] != 2 or not grid.is_contiguous()):
        raise ValueError("the slice takes contiguous (..., 2, gh, gw, gd) float32 grids, one per image")
    if grid.device != image.device:
        raise ValueError(f"grid on {grid.device}, image on {image.device}")
    gh, gw, gd = grid.shape[-3:]
    if 2 * gh * gw * gd >= 2**31:
        raise ValueError(f"a grid of 2 x {gh} x {gw} x {gd} cells is too large for the slice's 32-bit indices")

    frames, cmin = _frames(image, color_min)
    bsz, h, w = frames.shape
    tables = _slice_tables(h, w, gh, gw, sigma_space, image.device)
    out = torch.empty(image.shape, dtype=torch.int32 if fused else torch.float32, device=image.device)
    _kernels.launch(
        "K3b" if fused else "K3a", grid.data_ptr(), frames.data_ptr(), cmin.data_ptr(), bsz, h, w, gh, gw, gd,
        float(np.float32(1.0 / sigma_color)),
        *(t.data_ptr() for t in tables),
        int(fused), out.data_ptr(),
        ctypes.c_void_p(torch.cuda.current_stream(image.device).cuda_stream), library=library,
    )
    return out


# -- bucket plan -----------------------------------------------------------


def plan_depth_buckets(color_min, color_max, sigma_color: float, quantum: int = 16):
    """Host-side grid-depth bucket plan for frames whose depth spans differ
    (copy of the JAX package's numpy function).

    ``color_min``/``color_max`` are per-frame host values: the *nonzero*
    minimum and the maximum. Each frame's true grid depth is the reference's
    per-frame sizing (grid.rs:51-54); frames are grouped by that depth
    rounded up to ``quantum``. Returns ``[(grid_depth, frame_indices,
    true_depths), ...]`` sorted by depth, for
    :meth:`BilateralFilter.filter_static_buckets`.
    """
    cmin = np.asarray(color_min, np.float64).reshape(-1)
    cmax = np.asarray(color_max, np.float64).reshape(-1)
    true_gd = np.array([true_depth(lo, hi, sigma_color) for lo, hi in zip(cmin, cmax)], np.int32)
    bucket_gd = -(-true_gd // quantum) * quantum
    plan = []
    for g in np.unique(bucket_gd):
        idx = np.nonzero(bucket_gd == g)[0].astype(np.int32)
        plan.append((int(g), idx, true_gd[idx]))
    return plan


def check_plan_coverage(plan, n_frames: int) -> None:
    """Raise unless the plan's buckets hold every frame index in
    ``[0, n_frames)`` exactly once (the JAX package leaves it unchecked)."""
    order = np.concatenate([np.asarray(idx).reshape(-1) for _, idx, _ in plan]) if plan else np.zeros(0, np.int64)
    counts = np.bincount(order[(order >= 0) & (order < n_frames)], minlength=n_frames)
    if order.size != n_frames or not (counts == 1).all():
        raise ValueError(f"the bucket plan does not cover each of the {n_frames} frames exactly once")


# -- front end ---------------------------------------------------------------


@dataclasses.dataclass
class BilateralGrid:
    """Built grids: channel-major (..., 2, gh, gw, gd) [value, count] + metadata
    (``color_min`` and ``depth_limit`` per frame: ints or 0-d tensors for one
    frame, tensors of the leading shape for a batch)."""

    data_cm: torch.Tensor
    sigma_space: float
    sigma_color: float
    color_min: int | torch.Tensor  # from_image: a 0-d tensor on the image's device
    depth_limit: int | torch.Tensor  # the true (reference-sized) grid depth, grid.rs:51-54

    @property
    def data(self) -> torch.Tensor:
        """The reference's (..., gh, gw, gd, 2) layout (grid.rs ``Array4``), a view."""
        return torch.movedim(self.data_cm, -4, -1)

    @property
    def dim(self) -> tuple[int, int, int, int]:
        c, gh, gw, gd = self.data_cm.shape[-4:]
        return (gh, gw, gd, c)

    @classmethod
    def from_image(cls, image: torch.Tensor, sigma_space: float, sigma_color: float, pad_depth_to: int = 1):
        """One frame's grid sized from its own span; ``color_min`` counts holes."""
        color_min, shape, true_gd = grid_geometry(image, sigma_space, sigma_color, pad_depth_to)
        data = _splat(image, color_min, shape, sigma_space, sigma_color)
        return cls(data, sigma_space, sigma_color, color_min, true_gd)

    @classmethod
    def from_image_static(
        cls, image: torch.Tensor, color_min, grid_depth: int, sigma_space: float, sigma_color: float,
        depth_limit=None,
    ) -> "BilateralGrid":
        """Grids of (..., H, W) images at a caller-fixed depth ``grid_depth``
        (at least each frame's true depth), with the caller's ``color_min``.
        Pass each frame's true depth as ``depth_limit`` for the output of a
        grid sized to the frame; without it the blur's exclusion sits at
        ``grid_depth``."""
        gh, gw = _grid_dims(*image.shape[-2:], sigma_space)
        data = _splat(image, color_min, (gh, gw, int(grid_depth)), sigma_space, sigma_color)
        limit = int(grid_depth) if depth_limit is None else depth_limit
        return cls(data, sigma_space, sigma_color, color_min, limit)

    def convolve(self) -> "BilateralGrid":
        return dataclasses.replace(self, data_cm=_blur(self.data_cm, self.depth_limit))

    def normalize(self) -> "BilateralGrid":
        return dataclasses.replace(self, data_cm=_normalize(self.data_cm))

    def slice(self, image: torch.Tensor) -> torch.Tensor:
        """Sample a normalized grid back to image space; truncates to the
        image's integer type like the reference's ``num::cast``."""
        value = _slice(self.data_cm, image, self.color_min, self.sigma_space, self.sigma_color)
        return value.to(image.dtype)

    def normalize_slice(self, image: torch.Tensor) -> torch.Tensor:
        """``normalize().slice(image)``, the same bits, in one pass that
        writes no normalized grid (the slice kernel's form (b))."""
        return _normalize_slice(self.data_cm, image, self.color_min, self.sigma_space, self.sigma_color)


@dataclasses.dataclass(frozen=True)
class BilateralFilter:
    """Depth filter front end (reference edge_aware_filter.rs:12-56 defaults)."""

    sigma_space: float = 4.50000000225
    sigma_color: float = 29.9999880000072
    pad_depth_to: int = 16

    def filter(self, image: torch.Tensor) -> torch.Tensor:
        """Filter an (H, W) int32 depth image on its device, its grid sized
        from its own span (``color_min`` counts holes)."""
        grid = BilateralGrid.from_image(image, self.sigma_space, self.sigma_color, self.pad_depth_to)
        return grid.convolve().normalize_slice(image)

    def scale_down(self, image: torch.Tensor) -> torch.Tensor:
        """:meth:`filter`, then keep every other row and column
        (edge_aware_filter.rs:137-147)."""
        filtered = self.filter(image)
        h, w = filtered.shape
        return filtered[: h // 2 * 2 : 2, : w // 2 * 2 : 2]

    def filter_static(self, image: torch.Tensor, color_min, grid_depth: int, depth_limit=None) -> torch.Tensor:
        """:meth:`filter` of one (H, W) frame at a caller-fixed grid depth and
        ``color_min`` (see :meth:`BilateralGrid.from_image_static`)."""
        limit = None if depth_limit is None else torch.as_tensor(depth_limit).reshape(1)
        cmin = torch.as_tensor(color_min, device=image.device).reshape(1)
        return self.filter_static_batched(image[None], cmin, grid_depth, limit)[0]

    def filter_static_batched(self, images: torch.Tensor, color_min, grid_depth: int, depth_limit=None) -> torch.Tensor:
        """(B, H, W) frames at one grid depth: one splat and one slice launch.
        ``color_min`` and ``depth_limit`` are (B,) (``depth_limit`` None: the
        exclusion at ``grid_depth``)."""
        if images.ndim != 3:
            raise ValueError(f"filter_static_batched takes (B, H, W) frames, got {tuple(images.shape)}")
        grid = BilateralGrid.from_image_static(
            images, color_min, grid_depth, self.sigma_space, self.sigma_color, depth_limit
        )
        return grid.convolve().normalize_slice(images)

    def filter_static_buckets(self, images: torch.Tensor, color_min: torch.Tensor, plan) -> torch.Tensor:
        """(B, H, W) frames whose depth spans differ, through the grid-depth
        buckets of :func:`plan_depth_buckets`: one :meth:`filter_static_batched`
        per bucket, each frame's blur exclusion at its own true depth, so each
        frame's output is bitwise its own ``filter_static`` at its true depth.
        A bucket is not cut: the deepest series here, the mixed one's 29
        sample2 frames at gd 752-768, peaks at 11.6 GB on an H100 80GB.
        ``color_min``: (B,), the nonzero minima."""
        check_plan_coverage(plan, images.shape[0])
        out = torch.empty_like(images)
        for grid_depth, idx, limits in plan:
            sub = torch.from_numpy(np.asarray(idx, np.int64)).to(images.device)
            limit = torch.from_numpy(np.asarray(limits, np.int32)).to(images.device)
            out[sub] = self.filter_static_batched(images[sub], color_min[sub], grid_depth, limit)
        return out
