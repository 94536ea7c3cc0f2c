"""RGB-D image containers and colour conversions (port of ``align3d_tpu/image.py``).

``rgb_to_luma_u8`` keeps the reference's 0.3/0.59/0.11 weights with
truncation (``src/image/luma.rs:75-83``). ``py_scale_down`` blurs in float32
with edge-replicated borders and samples at (2i, 2j)
(``src/image/rgb.rs:74-84``). The JAX package does the horizontal pass and
the decimation as one 0/1-banded matmul, a TPU relayout workaround; here
strided indexing does the same job, so the horizontal sum runs in another
order and a pixel can truncate to a value one lower or higher.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from align3d_torch.camera import CameraIntrinsics
from align3d_torch.se3 import Transform


@dataclasses.dataclass
class RgbdImage:
    """Colour (H, W, 3) u8 + depth (H, W) u16, as numpy arrays, + depth scale."""

    color: np.ndarray
    depth: np.ndarray
    depth_scale: float | None = None


@dataclasses.dataclass
class RgbdFrame:
    """Camera intrinsics + optional ground-truth pose + RGB-D image."""

    camera: CameraIntrinsics
    image: RgbdImage
    camera_to_world: Transform | None = None


def rgb_to_luma_u8(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 RGB -> (...,) u8 luma, truncating like Rust ``as u8``."""
    rgb = rgb.to(torch.float32)
    luma = rgb[..., 0] * 0.3 + rgb[..., 1] * 0.59 + rgb[..., 2] * 0.11
    return luma.to(torch.uint8)


def _blur_offsets_weights(sigma: float) -> tuple[int, int, np.ndarray]:
    """Tap offsets ``lo ..< hi`` and normalized Gaussian weights, windowed as
    ``image::imageops::sample`` does for ratio-1 resampling."""
    sigma = 1.0 if sigma <= 0.0 else sigma
    support = 2.0 * sigma
    lo = int(math.floor(0.5 - support))
    hi = int(math.ceil(0.5 + support))
    offs = np.arange(lo, hi)
    w = np.exp(-(offs.astype(np.float64) ** 2) / (2.0 * sigma * sigma))
    w /= w.sum()
    return lo, hi, w.astype(np.float32)


def _blur_axis(x: torch.Tensor, axis: int, lo: int, weights: np.ndarray, stride: int) -> torch.Tensor:
    """One separable pass along ``axis`` with replicated borders, evaluated at
    every ``stride``-th output position."""
    n = x.shape[axis]
    out_pos = torch.arange(0, n, stride, device=x.device)
    acc = None
    for k, wt in enumerate(weights):
        idx = torch.clamp(out_pos + (lo + k), 0, n - 1)
        term = float(wt) * torch.index_select(x, axis, idx)
        acc = term if acc is None else acc + term
    return acc


def gaussian_blur(image: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur, vertical then horizontal; f32 out.
    ``image`` is (H, W) or (H, W, C)."""
    lo, _, weights = _blur_offsets_weights(sigma)
    img = image.to(torch.float32)
    return _blur_axis(_blur_axis(img, 0, lo, weights, 1), 1, lo, weights, 1)


def py_scale_down(color: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian blur then stride-2 decimation of (..., H, W, 3) u8 images."""
    h2, w2 = color.shape[-3] // 2, color.shape[-2] // 2
    lo, _, weights = _blur_offsets_weights(sigma)
    x = color.to(torch.float32)
    # Both passes are evaluated only at the even positions they feed.
    sampled = _blur_axis(_blur_axis(x, -3, lo, weights, 2), -2, lo, weights, 2)
    return torch.clamp(sampled[..., :h2, :w2, :], 0.0, 255.0).to(torch.uint8)
