"""The range-image pyramid of B frames: one kernel launch a level on the card.

Level 0 is the frames' backprojection (a point a pixel, (0, 0, 0) at
holes), its normals (:func:`align3d_torch.ops.normals.compute_normals`), the
colour as it came, its luma and bordered intensity map. Each coarser level
halves the last: points and normals by the masked 2x2 nearest-to-mean pick
(:func:`align3d_torch.ops.resize.resize_nearest_to_mean`), the colour by
:func:`align3d_torch.image.py_scale_down`, then luma and map again
(``src/range_image/builder.rs:74-91``).

On CUDA tensors :func:`build` launches K12 (``csrc/pyramid.cu``,
``pyramid_base_kernel``) for level 0 and K13 (``pyramid_down_kernel``) for
each coarser one, and counts them in ``BASE_LAUNCHES`` and
``DOWN_LAUNCHES``; on CPU tensors it runs :func:`pyramid_plain`, the
composition of those functions, which the kernels repeat bitwise. Leading
frame axes pass through: depth (..., H, W), colour (..., H, W, 3), the
depth scale a number or a tensor of the leading shape.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from align3d_torch import _kernels
from align3d_torch.camera import CameraIntrinsics
from align3d_torch.image import _blur_offsets_weights, py_scale_down, rgb_to_luma_u8
from align3d_torch.ops.intensity import BORDER, build_intensity_map
from align3d_torch.ops.normals import compute_normals
from align3d_torch.ops.resize import resize_nearest_to_mean

BASE_LAUNCHES = 0  # K12 launches
DOWN_LAUNCHES = 0  # K13 launches
MAX_TAPS = 32  # K13's blur taps (sigma 1: 5)


class Level(NamedTuple):
    """One pyramid level's tensors, with the leading frame axes; normals,
    intensities and intensity_map may be None."""

    points: torch.Tensor  # (..., H, W, 3) f32
    mask: torch.Tensor  # (..., H, W) bool
    normals: Optional[torch.Tensor]  # (..., H, W, 3) f32
    colors: torch.Tensor  # (..., H, W, 3) u8
    intensities: Optional[torch.Tensor]  # (..., H, W) u8
    intensity_map: Optional[torch.Tensor]  # (..., H+2, W+2) f32


def backproject(intrinsics: CameraIntrinsics, depth: torch.Tensor,
                depth_scale: float | torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., H, W) int depth -> ((..., H, W, 3) points, mask); zero depth
    marks holes, whose points stay (0, 0, 0)."""
    mask = depth > 0
    if isinstance(depth_scale, torch.Tensor):
        depth_scale = depth_scale.to(device=depth.device, dtype=torch.float32)[..., None, None]
    z = depth.to(torch.float32) * depth_scale
    points = intrinsics.backproject_grid(z)
    return torch.where(mask[..., None], points, 0.0), mask


def scale_down(points: torch.Tensor, mask: torch.Tensor, normals: Optional[torch.Tensor],
               colors: Optional[torch.Tensor], sigma: float) -> tuple:
    """The next level's (points, mask, normals, colors): points and normals
    by the masked nearest-to-mean pick, colours blurred and decimated."""
    dst_h, dst_w = mask.shape[-2] // 2, mask.shape[-1] // 2
    points_d, mask_d = resize_nearest_to_mean(points, mask, dst_h, dst_w)
    normals_d = None if normals is None else resize_nearest_to_mean(normals, mask, dst_h, dst_w)[0]
    colors_d = None if colors is None else py_scale_down(colors, sigma)
    return points_d, mask_d, normals_d, colors_d


def pyramid_plain(with_normals: bool, with_intensity: bool, pyramid_levels: int, blur_sigma: float,
                  intrinsics: CameraIntrinsics, depth_scale: float | torch.Tensor, color: torch.Tensor,
                  depth: torch.Tensor) -> list[Level]:
    """K12's and K13's plain twin: the levels, fine to coarse, as plain
    PyTorch ops."""
    points, mask = backproject(intrinsics, depth, depth_scale)
    normals = compute_normals(points, mask) if with_normals else None
    levels = [(points, mask, normals, color)]
    for _ in range(pyramid_levels - 1):
        levels.append(scale_down(*levels[-1], blur_sigma))
    out = []
    for points, mask, normals, colors in levels:
        intensities = rgb_to_luma_u8(colors) if with_intensity else None
        imap = build_intensity_map(intensities) if with_intensity else None
        out.append(Level(points, mask, normals, colors, intensities, imap))
    return out


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _frames(lead: tuple) -> int:
    bsz = math.prod(lead)
    if not 0 < bsz <= 65535:
        raise ValueError(f"the kernels take 1 to 65535 frames, got {bsz}")
    return bsz


def _outputs(lead: tuple, h: int, w: int, with_normals: bool, with_intensity: bool, device) -> dict:
    f32 = {"dtype": torch.float32, "device": device}
    return {
        "points": torch.empty((*lead, h, w, 3), **f32),
        "mask": torch.empty((*lead, h, w), dtype=torch.bool, device=device),
        "normals": torch.empty((*lead, h, w, 3), **f32) if with_normals else None,
        "intensities": torch.empty((*lead, h, w), dtype=torch.uint8, device=device) if with_intensity else None,
        "intensity_map": torch.empty((*lead, h + BORDER, w + BORDER), **f32) if with_intensity else None,
    }


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def pyramid_base(depth: torch.Tensor, color: torch.Tensor, depth_scale: float | torch.Tensor,
                 intrinsics: CameraIntrinsics, with_normals: bool, with_intensity: bool) -> Level:
    """Level 0 of B frames in one K12 launch: int32 depth (..., H, W) and u8
    colour (..., H, W, 3), contiguous, on one CUDA device; the colour is
    the level's own."""
    dev = depth.device
    if dev.type != "cuda":
        raise ValueError(f"pyramid_base runs on cuda tensors, got {dev}")
    *lead, h, w = depth.shape
    lead = tuple(lead)
    bsz = _frames(lead)
    _kernels.check_tensor(depth, "depth", (*lead, h, w), torch.int32, dev)
    _kernels.check_tensor(color, "color", (*lead, h, w, 3), torch.uint8, dev)
    scales, scale = None, 0.0
    if isinstance(depth_scale, torch.Tensor):
        # As the twin: rounded to float32 on the depth's device, one a frame.
        scales = torch.broadcast_to(depth_scale.to(device=dev, dtype=torch.float32), lead).contiguous()
    else:
        scale = float(depth_scale)
    out = _outputs(lead, h, w, with_normals, with_intensity, dev)
    status = _kernels.lib().a3d_pyramid_base(
        depth.data_ptr(), color.data_ptr(), _ptr(scales), scale, bsz, h, w,
        intrinsics.fx, intrinsics.fy, intrinsics.cx, intrinsics.cy,
        out["points"].data_ptr(), out["mask"].data_ptr(), _ptr(out["normals"]), _ptr(out["intensities"]),
        _ptr(out["intensity_map"]), _stream(dev),
    )
    _kernels.check(status, "a3d_pyramid_base")
    global BASE_LAUNCHES
    BASE_LAUNCHES += 1
    return Level(colors=color, **out)


@functools.lru_cache(maxsize=8)
def _taps(sigma: float) -> tuple[int, int, ctypes.Array]:
    """(first offset, taps, float32 weights) of py_scale_down's blur."""
    lo, hi, weights = _blur_offsets_weights(sigma)
    if hi - lo > MAX_TAPS:
        raise ValueError(f"blur sigma {sigma} needs {hi - lo} taps; K13 takes at most {MAX_TAPS}")
    return lo, hi - lo, (ctypes.c_float * (hi - lo))(*weights.tolist())


def pyramid_down(fine: Level, blur_sigma: float, with_intensity: bool) -> Level:
    """The level below ``fine`` (as K12 or K13 wrote it: contiguous, on one
    CUDA device) in one K13 launch; normals where ``fine`` has them."""
    points, mask, normals, colors = fine.points, fine.mask, fine.normals, fine.colors
    dev = points.device
    if dev.type != "cuda":
        raise ValueError(f"pyramid_down runs on cuda tensors, got {dev}")
    *lead, h, w, _ = points.shape
    lead = tuple(lead)
    bsz = _frames(lead)
    _kernels.check_tensor(points, "points", (*lead, h, w, 3), torch.float32, dev)
    _kernels.check_tensor(mask, "mask", (*lead, h, w), torch.bool, dev)
    if normals is not None:
        _kernels.check_tensor(normals, "normals", (*lead, h, w, 3), torch.float32, dev)
    _kernels.check_tensor(colors, "colors", (*lead, h, w, 3), torch.uint8, dev)
    dh, dw = h // 2, w // 2
    if dh == 0 or dw == 0:
        raise ValueError(f"a {h}x{w} level has no level below it")
    lo, ntaps, weights = _taps(blur_sigma)
    out = _outputs(lead, dh, dw, normals is not None, with_intensity, dev)
    colors_d = torch.empty((*lead, dh, dw, 3), dtype=torch.uint8, device=dev)
    status = _kernels.lib().a3d_pyramid_down(
        points.data_ptr(), _ptr(normals), mask.data_ptr(), colors.data_ptr(), bsz, h, w, dh, dw,
        float(np.float32(h / dh)), float(np.float32(w / dw)), lo, ntaps, weights,
        out["points"].data_ptr(), _ptr(out["normals"]), out["mask"].data_ptr(), colors_d.data_ptr(),
        _ptr(out["intensities"]), _ptr(out["intensity_map"]), _stream(dev),
    )
    _kernels.check(status, "a3d_pyramid_down")
    global DOWN_LAUNCHES
    DOWN_LAUNCHES += 1
    return Level(colors=colors_d, **out)


def build(with_normals: bool, with_intensity: bool, pyramid_levels: int, blur_sigma: float,
          intrinsics: CameraIntrinsics, depth_scale: float | torch.Tensor, color: torch.Tensor,
          depth: torch.Tensor) -> list[Level]:
    """The pyramid's levels, fine to coarse: on CUDA tensors one K12 launch
    and a K13 launch a coarser level, on CPU tensors :func:`pyramid_plain`."""
    if depth.device.type == "cpu":
        return pyramid_plain(with_normals, with_intensity, pyramid_levels, blur_sigma, intrinsics, depth_scale,
                             color, depth)
    levels = [pyramid_base(depth, color, depth_scale, intrinsics, with_normals, with_intensity)]
    for _ in range(pyramid_levels - 1):
        levels.append(pyramid_down(levels[-1], blur_sigma, with_intensity))
    return levels
