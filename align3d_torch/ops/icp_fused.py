"""The Gauss-Newton step of image ICP: the plain step, CUDA kernel K1 and its twin.

:func:`icp_step` is the plain GN accumulation over all source pixels of one
pair (port of ``align3d_tpu/icp/image_icp.py::icp_step``), with the
reference's quirks (see :mod:`align3d_torch.icp.image_icp`).
:func:`icp_step_fused` computes the same for B frame pairs at once: the
geometric and the colour normal equations, as two 8x8 augmented blocks
``[[H, g], [g^T, sum w r^2]]`` with the weight sum at [7, 7]. It reads the
target's intensity taps from the bordered intensity map itself. On a CUDA
tensor it launches ``csrc/icp_step.cu``, one launch per call; on a CPU
tensor it runs the plain twin, ``pack_intensity_taps`` then ``icp_step``
plus ``GNSystem.from_residuals``. Nothing else selects between the two.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from align3d_torch import _kernels
from align3d_torch.camera import CameraIntrinsics
from align3d_torch.icp.params import IcpParams
from align3d_torch.ops.target_pack import GEO_CHANNELS, pack_intensity_taps, taps_bilinear_grad
from align3d_torch.optim.gauss_newton import GNSystem, huber_weight
from align3d_torch.se3 import Transform

#: Launches of the CUDA kernel since the last reset (set it to 0 to reset).
LAUNCHES = 0

_THREADS = 256
_PIXELS_PER_THREAD = 8
_PARTIALS = 58  # 2 systems x (21 H + 6 g + sum w r^2 + sum w)

# Per (device, stream), the kernel's int32 arrival counter of each pair:
# zeros, allocated once and re-armed to zero by every launch. Launches on one
# stream run in order, so they can share their stream's counters; each stream
# has its own, so launches on two streams never mix their counts.
_ARRIVALS: dict[tuple[torch.device, int], torch.Tensor] = {}


def _arrivals(device: torch.device, stream: int, pairs: int) -> torch.Tensor:
    counters = _ARRIVALS.get((device, stream))
    if counters is None or counters.numel() < pairs:
        counters = torch.zeros(max(pairs, 64), dtype=torch.int32, device=device)
        _ARRIVALS[(device, stream)] = counters
    return counters


def _f32(x: float) -> float:
    """A Python float rounded to float32, as the JAX package's ``jnp.float32(x)``."""
    return float(np.float32(x))


def _se3_jacobian(points: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """J = [n, p x n] per residual (reference cost_function.rs:5-15)."""
    return torch.cat([normals, torch.cross(points, normals, dim=-1)], dim=-1)


def icp_step(
    transform: Transform,
    source_points: torch.Tensor,  # (N, 3)
    source_mask: torch.Tensor,  # (N,) bool
    source_intensity: torch.Tensor,  # (N,) u8
    target_geo: torch.Tensor,  # (N, 8) from pack_geometry
    target_taps: torch.Tensor,  # (N, 12) from pack_intensity_taps
    h: int,  # the target level's array dims (the reference bound-checks
    w: int,  # against them; intrinsics.scale keeps the full size)
    intrinsics: CameraIntrinsics,
    params: IcpParams,
) -> tuple[GNSystem, GNSystem]:
    """One GN accumulation pass; returns the (geometric, colour) systems."""
    p = transform.apply(source_points)
    z = p[..., 2]
    safe_z = torch.where(z == 0.0, 1e-12, z)
    u = p[..., 0] * intrinsics.fx / safe_z + intrinsics.cx
    v = p[..., 1] * intrinsics.fy / safe_z + intrinsics.cy

    u_int = torch.trunc(u + 0.5)
    v_int = torch.trunc(v + 0.5)
    inbounds = (u_int >= 0) & (u_int < w) & (v_int >= 0) & (v_int < h)
    # NaN coordinates fail the bounds test above; zero them so the gather
    # index stays in range (the JAX gather clamps instead).
    ui = torch.nan_to_num(u_int, nan=0.0).clamp(0, w - 1).to(torch.int64)
    vi = torch.nan_to_num(v_int, nan=0.0).clamp(0, h - 1).to(torch.int64)
    geo = target_geo[vi * w + ui]
    tp = geo[:, 0:3]
    tn = geo[:, 3:6]
    tvalid = geo[:, 6] > 0.0

    valid = source_mask & inbounds & tvalid
    diff = tp - p
    dist_ok = torch.sum(diff * diff, dim=-1) <= _f32(params.max_distance * params.max_distance)
    angle = torch.abs(torch.arccos(torch.sum(p * tn, dim=-1)))
    angle_rejected = angle >= _f32(params.max_normal_angle)  # NaN -> False

    w_geom = (valid & dist_ok & ~angle_rejected).to(torch.float32)
    residual_geom = torch.sum(diff * tn, dim=-1)
    jac_geom = _se3_jacobian(p, tn)
    if params.huber_delta is not None:
        w_geom = w_geom * huber_weight(residual_geom, params.huber_delta)
    geom = GNSystem.from_residuals(jac_geom, residual_geom, w_geom)

    u_s = torch.nan_to_num(torch.clamp(u, 0.0, float(w - 1)), nan=0.0)
    v_s = torch.nan_to_num(torch.clamp(v, 0.0, float(h - 1)), nan=0.0)
    base = torch.trunc(v_s).to(torch.int64) * w + torch.trunc(u_s).to(torch.int64)
    taps = target_taps[base]
    target_color, du, dv = taps_bilinear_grad(taps, u_s, v_s)
    source_color = source_intensity.to(torch.float32) * 0.003921569  # 1/255

    zz = safe_z * safe_z
    # full_like: a true division (``scalar / tensor`` multiplies by a reciprocal).
    dfx = torch.full_like(safe_z, intrinsics.fx) / safe_z
    dcx = -p[..., 0] * intrinsics.fx / zz
    dfy = torch.full_like(safe_z, intrinsics.fy) / safe_z
    dcy = -p[..., 1] * intrinsics.fy / zz
    color_gradient = torch.stack([du * dfx, dv * dfy, du * dcx + dv * dcy], dim=-1)
    residual_color = source_color - target_color
    color_ok = residual_color * residual_color <= _f32(
        params.max_color_distance * params.max_color_distance
    )
    w_color = w_geom * color_ok.to(torch.float32)
    color = GNSystem.from_residuals(_se3_jacobian(p, color_gradient), residual_color, w_color)
    return geom, color



def _aug(geom, color) -> torch.Tensor:
    """(B,) GNSystems -> (B, 2, 8, 8) augmented blocks."""
    blocks = []
    for sys in (geom, color):
        a = torch.zeros(sys.hessian.shape[:-2] + (8, 8), dtype=torch.float32, device=sys.hessian.device)
        a[..., :6, :6] = sys.hessian
        a[..., :6, 6] = sys.gradient
        a[..., 6, :6] = sys.gradient
        a[..., 6, 6] = sys.squared_residual_sum
        a[..., 7, 7] = sys.count
        blocks.append(a)
    return torch.stack(blocks, dim=-3)


def icp_step_plain(rot, trans, points, mask, intensity, geo, intensity_map, h, w, intrinsics, params) -> torch.Tensor:
    """The plain-PyTorch twin of the kernel, one pair at a time, on the tap
    pack of each pair's intensity map."""
    taps = pack_intensity_taps(intensity_map)
    out = []
    for b in range(rot.shape[0]):
        geom, color = icp_step(
            Transform(rot[b], trans[b]), points[b], mask[b].bool(), intensity[b], geo[b], taps[b],
            h, w, intrinsics, params,
        )
        out.append(_aug(geom, color))
    return torch.stack(out)


def icp_step_fused(
    rot: torch.Tensor,  # (B, 3, 3) f32
    trans: torch.Tensor,  # (B, 3) f32
    points: torch.Tensor,  # (B, N, 3) f32 source points
    mask: torch.Tensor,  # (B, N) u8 source validity
    intensity: torch.Tensor,  # (B, N) u8 source luma
    geo: torch.Tensor,  # (B, N, 8) f32 target pack_geometry
    intensity_map: torch.Tensor,  # (B, H+2, W+2) f32 bordered target intensity maps
    h: int,
    w: int,
    intrinsics: CameraIntrinsics,
    params: IcpParams,
) -> torch.Tensor:
    """One GN accumulation for B pairs -> (B, 2, 8, 8) f32 [geometric, colour]."""
    if rot.device.type == "cpu":
        return icp_step_plain(rot, trans, points, mask, intensity, geo, intensity_map, h, w, intrinsics, params)
    if rot.device.type != "cuda":
        raise ValueError(f"icp_step_fused runs on cuda or cpu tensors, got {rot.device}")

    global LAUNCHES
    dev = rot.device
    bsz, n = points.shape[0], h * w
    f32, u8 = torch.float32, torch.uint8
    _kernels.check_tensor(rot, "rot", (bsz, 3, 3), f32, dev)
    _kernels.check_tensor(trans, "trans", (bsz, 3), f32, dev)
    _kernels.check_tensor(points, "points", (bsz, n, 3), f32, dev)
    _kernels.check_tensor(mask, "mask", (bsz, n), u8, dev)
    _kernels.check_tensor(intensity, "intensity", (bsz, n), u8, dev)
    _kernels.check_tensor(geo, "geo", (bsz, n, GEO_CHANNELS), f32, dev)
    _kernels.check_tensor(intensity_map, "intensity_map", (bsz, h + 2, w + 2), f32, dev)
    if geo.data_ptr() % 16:
        raise ValueError("geo must start on a 16-byte boundary (the kernel reads its rows as float4)")

    if params.huber_delta is not None and params.huber_delta <= 0.0:
        raise ValueError(f"huber_delta must be positive or None, got {params.huber_delta}")

    nblk = -(-n // (_THREADS * _PIXELS_PER_THREAD))
    stream = torch.cuda.current_stream(dev).cuda_stream
    partials = torch.empty((bsz, nblk, _PARTIALS), dtype=f32, device=dev)
    arrivals = _arrivals(dev, stream, bsz)
    out = torch.empty((bsz, 2, 8, 8), dtype=f32, device=dev)
    huber = 0.0 if params.huber_delta is None else params.huber_delta
    lib = _kernels.lib()
    status = lib.a3d_icp_step(
        rot.data_ptr(), trans.data_ptr(), points.data_ptr(), mask.data_ptr(), intensity.data_ptr(),
        geo.data_ptr(), intensity_map.data_ptr(),
        bsz, n, h, w,
        intrinsics.fx, intrinsics.fy, intrinsics.cx, intrinsics.cy,
        _f32(params.max_distance * params.max_distance),
        params.max_normal_angle,
        _f32(params.max_color_distance * params.max_color_distance),
        huber,
        partials.data_ptr(), nblk, arrivals.data_ptr(), out.data_ptr(),
        ctypes.c_void_p(stream),
    )
    _kernels.check(status, "a3d_icp_step")
    LAUNCHES += 1
    return out
