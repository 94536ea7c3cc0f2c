"""Bilateral-grid depth filter (port of ``align3d_tpu/ops/bilateral.py``, the ``filter`` path).

Chen/Paris/Durand real-time bilateral grid, as the reference
(``src/bilateral/``): splat the depth image into a (gh, gw, gd) value/count
grid, blur it along each axis with two masked 1-2-1/4 passes, normalize,
and slice it back trilinearly at every pixel (holes included, so the filter
fills holes next to valid depth).

The grid is channel-major, (2, gh, gw, gd) = [value, count], the JAX
package's layout. The spatial grid<->image maps depend only on pixel
positions, so they are numpy tables copied to the device once per shape and
device; only the range coordinate depends on the data. The splat and the slice are CUDA kernels
(``csrc/bilateral.cu``) on a CUDA tensor and their plain twins on a CPU
tensor. The blur is three banded-matrix contractions, as in the JAX package.

Conventions kept from the JAX package:

* ``gh``, ``gw`` and ``gd`` come from the same Python-float expressions, so
  ``sigma_space = 4.50000000225`` gives gw = 146 at width 640, not 147;
* ``color_min`` is the minimum of the image *including* zero holes;
* the depth axis is padded to a multiple of ``pad_depth_to`` and the blur's
  interior exclusion sits at the true depth (``depth_limit``), so padding
  changes no output;
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

#: Launches of the CUDA splat and slice kernels (set to 0 to reset).
SPLAT_LAUNCHES = 0
SLICE_LAUNCHES = 0


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


def grid_geometry(
    image: torch.Tensor, sigma_space: float, sigma_color: float, pad_depth_to: int = 1
) -> tuple[int, tuple[int, int, int], int]:
    """``(color_min, (gh, gw, gd), true_gd)`` of an image's grid: ``gd`` is the
    true depth ``true_gd`` padded up to a multiple of ``pad_depth_to``."""
    gh, gw = _grid_dims(*image.shape, sigma_space)
    color_min, color_max = (int(v) for v in torch.aminmax(image))  # sizes the grid
    true_gd = int((float(color_max) - float(color_min)) / sigma_color) + 1 + 2 * _COLOR_PAD
    return color_min, (gh, gw, -(-true_gd // pad_depth_to) * pad_depth_to), true_gd


def _to_device(arrays, device: torch.device) -> tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


@lru_cache(maxsize=None)
def _splat_tables(h: int, w: int, gh: int, gw: int, sigma_space: float, device: torch.device):
    """(row index, row weight, column index, column weight) windows on ``device``."""
    inv_ss = 1.0 / sigma_space
    return _to_device(_splat_window(h, gh, inv_ss, _SPACE_PAD) + _splat_window(w, gw, inv_ss, _SPACE_PAD), device)


# -- splat (K2) ------------------------------------------------------------


def _splat_plain(image, color_min: int, grid_shape, sigma_space: float, sigma_color: float) -> torch.Tensor:
    """The XLA one-hot form of the JAX ``_splat``: per window tap in order
    t = a * B + b, ``acc += onehot * w`` (bitwise equal to it)."""
    gh, gw, gd = grid_shape
    ridx, rwt, cidx, cwt = _splat_tables(*image.shape, gh, gw, sigma_space, image.device)
    vals = image.to(torch.float32)
    valid = (image > 0).to(torch.float32)
    chan = ((vals - color_min) * (1.0 / sigma_color) + 0.5).to(torch.int32) + _COLOR_PAD

    def window(x):
        return x[ridx.long()][:, :, cidx.long()]  # (gh, A, gw, B)

    zed = window(chan)
    val_t = window(vals)
    w_t = window(valid) * (rwt[:, :, None, None] * cwt[None, None, :, :])
    kk = torch.arange(gd, dtype=torch.int32, device=image.device).expand(gh, gw, gd)
    acc_v = torch.zeros((gh, gw, gd), dtype=torch.float32, device=image.device)
    acc_c = torch.zeros_like(acc_v)
    for a in range(zed.shape[1]):
        for b in range(zed.shape[3]):
            oh = (kk == zed[:, a, :, b, None]).to(torch.float32)
            acc_c = acc_c + oh * w_t[:, a, :, b, None]
            acc_v = acc_v + oh * (w_t[:, a, :, b] * val_t[:, a, :, b])[..., None]
    return torch.stack([acc_v, acc_c], dim=0)


def _splat(image, color_min: int, grid_shape, sigma_space: float, sigma_color: float) -> torch.Tensor:
    """Depth values and counts into the channel-major (2, gh, gw, gd) grid."""
    if image.device.type == "cpu":
        return _splat_plain(image, color_min, grid_shape, sigma_space, sigma_color)
    if image.device.type != "cuda":
        raise ValueError(f"_splat runs on cuda or cpu tensors, got {image.device}")
    if image.dtype != torch.int32 or image.ndim != 2 or not image.is_contiguous():
        raise ValueError("_splat takes a contiguous (H, W) int32 depth image")

    global SPLAT_LAUNCHES
    gh, gw, gd = grid_shape
    h, w = image.shape
    ridx, rwt, cidx, cwt = _splat_tables(h, w, gh, gw, sigma_space, image.device)
    out = torch.empty((2, gh, gw, gd), dtype=torch.float32, device=image.device)
    status = _kernels.lib().a3d_bilateral_splat(
        image.data_ptr(), w, float(color_min), float(np.float32(1.0 / sigma_color)),
        ridx.data_ptr(), rwt.data_ptr(), ridx.shape[1],
        cidx.data_ptr(), cwt.data_ptr(), cidx.shape[1],
        gh, gw, gd, out.data_ptr(),
        ctypes.c_void_p(torch.cuda.current_stream(image.device).cuda_stream),
    )
    _kernels.check(status, "a3d_bilateral_splat")
    SPLAT_LAUNCHES += 1
    return out


# -- blur and normalize ----------------------------------------------------


def _tridiag_121(n: int) -> np.ndarray:
    t = np.zeros((n, n), np.float32)
    idx = np.arange(n)
    t[idx, idx] = 0.5
    t[idx[1:], idx[:-1]] = 0.25
    t[idx[:-1], idx[1:]] = 0.25
    return t


def _axis_blur_matrix(n: int, limit: int) -> np.ndarray:
    """One axis's two masked 1-2-1/4 passes as one (n, n) matrix with the
    interior mask (``0 < i < limit - 1``) folded into its rows and columns
    (edge_aware_filter.rs:57-115 writes interior cells only). Entries are
    multiples of 1/16, exact in float32."""
    m = ((np.arange(n) > 0) & (np.arange(n) < limit - 1)).astype(np.float32)
    t = _tridiag_121(n)
    return (m[:, None] * (t @ (m[:, None] * t))) * m[None, :]


@lru_cache(maxsize=None)
def _blur_tables(gh: int, gw: int, gd: int, depth_limit: int, device: torch.device):
    return _to_device(
        (_axis_blur_matrix(gh, gh), _axis_blur_matrix(gw, gw), _axis_blur_matrix(gd, depth_limit)), device
    )


def _blur(grid: torch.Tensor, depth_limit: int) -> torch.Tensor:
    """3-axis x 2-pass blur of a channel-major grid; the depth axis's
    interior exclusion sits at the true depth ``depth_limit``."""
    a_h, a_w, a_d = _blur_tables(*grid.shape[1:], depth_limit, grid.device)
    out = torch.einsum("ah,chwd->cawd", a_h, grid)
    out = torch.einsum("bw,chwd->chbd", a_w, out)
    return torch.einsum("kd,chwd->chwk", a_d, out)


def _normalize(grid: torch.Tensor) -> torch.Tensor:
    """value /= count and count -> 1 where count > 0 (grid.rs:90-104)."""
    val, cnt = grid[0], grid[1]
    has = cnt > 0
    val = torch.where(has, val / torch.where(has, cnt, 1.0), val)
    cnt = torch.where(has, 1.0, cnt)
    return torch.stack([val, cnt], dim=0)


# -- slice (K3) ------------------------------------------------------------


@lru_cache(maxsize=None)
def _slice_tables(h: int, w: int, gh: int, gw: int, sigma_space: float, device: torch.device):
    """(y0, y1, ya, x0, x1, xa) on ``device``."""
    inv_ss = 1.0 / sigma_space
    y0, _, ya = _axis_indices(h, inv_ss, gh)
    y1 = np.clip(y0 + 1, 0, gh - 1).astype(np.int32)  # the JAX _slice's row-group y1
    x0, x1, xa = _axis_indices(w, inv_ss, gw)
    return _to_device((y0, y1, ya, x0, x1, xa), device)


def _slice_plain(grid, image, color_min: int, sigma_space: float, sigma_color: float) -> torch.Tensor:
    """Per-pixel trilinear sample of the value channel (grid.rs:106-162).

    The JAX ``_slice`` reduces a one-hot z weight against every channel;
    gathering the z0 and z1 channels gives the same two non-zero terms with
    the same arithmetic, without the (H, W, gd) intermediates.
    """
    gh, gw, gd = grid.shape[1:]
    h, w = image.shape
    y0, y1, ya, x0, x1, xa = _slice_tables(h, w, gh, gw, sigma_space, image.device)
    y0, y1, x0, x1 = (t.long() for t in (y0, y1, x0, x1))
    ya, xa = ya[:, None], xa[None, :]
    val = grid[0]

    chan = (image.to(torch.float32) - color_min) * (1.0 / sigma_color) + _COLOR_PAD
    z0 = torch.clamp(chan.to(torch.int32), 0, gd - 1)
    z1 = torch.clamp((chan + 1.0).to(torch.int32), 0, gd - 1)
    za = chan - z0.to(torch.float32)

    def pmix(z):
        z = z.long()
        p0 = val[y0[:, None], x0[None, :], z] * (1.0 - xa) + val[y0[:, None], x1[None, :], z] * xa
        p1 = val[y1[:, None], x0[None, :], z] * (1.0 - xa) + val[y1[:, None], x1[None, :], z] * xa
        return p0 * (1.0 - ya) + p1 * ya

    m0 = pmix(z0)
    m1 = pmix(z1)
    return torch.where(z0 == z1, ((1.0 - za) + za) * m0, (1.0 - za) * m0 + za * m1)


def _slice(grid, image, color_min: int, sigma_space: float, sigma_color: float) -> torch.Tensor:
    """Sample the normalized grid back at every pixel -> (H, W) float32."""
    if image.device.type == "cpu":
        return _slice_plain(grid, image, color_min, sigma_space, sigma_color)
    if image.device.type != "cuda":
        raise ValueError(f"_slice runs on cuda or cpu tensors, got {image.device}")
    if image.dtype != torch.int32 or image.ndim != 2 or not image.is_contiguous():
        raise ValueError("_slice takes a contiguous (H, W) int32 depth image")
    if grid.dtype != torch.float32 or grid.ndim != 4 or grid.shape[0] != 2 or not grid.is_contiguous():
        raise ValueError("_slice takes a contiguous (2, gh, gw, gd) float32 grid")
    if grid.device != image.device:
        raise ValueError(f"grid on {grid.device}, image on {image.device}")

    global SLICE_LAUNCHES
    gh, gw, gd = grid.shape[1:]
    h, w = image.shape
    tables = _slice_tables(h, w, gh, gw, sigma_space, image.device)
    out = torch.empty((h, w), dtype=torch.float32, device=image.device)
    status = _kernels.lib().a3d_bilateral_slice(
        grid.data_ptr(), image.data_ptr(), h, w, gw, gd,
        float(color_min), float(np.float32(1.0 / sigma_color)),
        *(t.data_ptr() for t in tables),
        out.data_ptr(),
        ctypes.c_void_p(torch.cuda.current_stream(image.device).cuda_stream),
    )
    _kernels.check(status, "a3d_bilateral_slice")
    SLICE_LAUNCHES += 1
    return out


# -- front end ---------------------------------------------------------------


@dataclasses.dataclass
class BilateralGrid:
    """A built grid: channel-major (2, gh, gw, gd) [value, count] + metadata."""

    data_cm: torch.Tensor
    sigma_space: float
    sigma_color: float
    color_min: int
    depth_limit: int  # the true (reference-sized) grid depth, grid.rs:51-54

    @classmethod
    def from_image(cls, image: torch.Tensor, sigma_space: float, sigma_color: float, pad_depth_to: int = 1):
        color_min, shape, true_gd = grid_geometry(image, sigma_space, sigma_color, pad_depth_to)
        data = _splat(image, color_min, shape, sigma_space, sigma_color)
        return cls(data, sigma_space, sigma_color, color_min, true_gd)

    def convolve(self) -> "BilateralGrid":
        return dataclasses.replace(self, data_cm=_blur(self.data_cm, self.depth_limit))

    def normalize(self) -> "BilateralGrid":
        return dataclasses.replace(self, data_cm=_normalize(self.data_cm))

    def slice(self, image: torch.Tensor) -> torch.Tensor:
        """Sample back to image space; truncates to the image's integer type
        like the reference's ``num::cast``."""
        value = _slice(self.data_cm, image, self.color_min, self.sigma_space, self.sigma_color)
        return value.to(image.dtype)


@dataclasses.dataclass(frozen=True)
class BilateralFilter:
    """Depth filter front end (reference edge_aware_filter.rs:12-56 defaults)."""

    sigma_space: float = 4.50000000225
    sigma_color: float = 29.9999880000072
    pad_depth_to: int = 16

    def filter(self, image: torch.Tensor) -> torch.Tensor:
        """Filter an (H, W) int32 depth image on its device."""
        grid = BilateralGrid.from_image(image, self.sigma_space, self.sigma_color, self.pad_depth_to)
        return grid.convolve().normalize().slice(image)
