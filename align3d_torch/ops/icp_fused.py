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

Every quantity a gate reads (the projection, u and v, the distance, the
normal-angle dot, the bilinear value and the colour residual) is written
here as single elementwise operations in one order, which the kernel,
built with ``-fmad=false``, repeats: so a pixel at a gate's boundary falls
the same way in both, on the card and against the twin run there. A
library reduction or GEMM would pick its own order and FMA contraction.
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from align3d_torch import _kernels
from align3d_torch.camera import CameraIntrinsics
from align3d_torch.icp.params import IcpParams
from align3d_torch.ops.target_pack import GEO_CHANNELS, pack_intensity_taps, taps_bilinear_grad
from align3d_torch.optim.gauss_newton import GNSystem, huber_weight
from align3d_torch.se3 import Transform

# Read by benchmark/trace.py; goes when a benchmark change reads _kernels.launches() instead.
__getattr__ = _kernels.legacy_counts(__name__, {"LAUNCHES": "K1"})

_THREADS = 256
_PIXELS_PER_THREAD = 8
_PARTIALS = 58  # 2 systems x (21 H + 6 g + sum w r^2 + sum w)

# Per (device, stream), the kernel's int32 arrival counter of each pair:
# zeros, allocated once and re-armed to zero by every launch. Launches on one
# stream run in order, so they can share their stream's counters; each stream
# has its own, so launches on two streams never mix their counts. A CUDA
# graph's captured launches have their own too (:func:`own_arrivals`).
_ARRIVALS: dict[tuple[torch.device, int], torch.Tensor] = {}


def _arrivals(device: torch.device, stream: int, pairs: int) -> torch.Tensor:
    counters = _ARRIVALS.get((device, stream))
    if counters is None or counters.numel() < pairs:
        counters = torch.zeros(max(pairs, 64), dtype=torch.int32, device=device)
        _ARRIVALS[(device, stream)] = counters
    return counters


@contextlib.contextmanager
def own_arrivals(device: torch.device, stream: int, counters: torch.Tensor):
    """Launches on ``stream`` inside the block take ``counters`` (zeros,
    one a pair at least): a CUDA graph captured there keeps counters of its
    own, which no launch outside it shares."""
    key = (device, stream)
    kept = _ARRIVALS.get(key)
    _ARRIVALS[key] = counters
    try:
        yield
    finally:
        if kept is None:
            del _ARRIVALS[key]
        else:
            _ARRIVALS[key] = kept


def _f32(x: float) -> float:
    """A Python float rounded to float32, as the JAX package's ``jnp.float32(x)``."""
    return float(np.float32(x))


def _se3_jacobian(px, py, pz, nx, ny, nz) -> torch.Tensor:
    """J = [n, p x n] per residual (reference cost_function.rs:5-15), the
    cross product as the kernel forms it."""
    return torch.stack([nx, ny, nz, py * nz - pz * ny, pz * nx - px * nz, px * ny - py * nx], dim=-1)


def _dot3(ax, ay, az, bx, by, bz) -> torch.Tensor:
    """``(ax bx + ay by) + az bz``, the kernel's order."""
    return ax * bx + ay * by + az * bz


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
    # R p + t, each output ((r0 x + r1 y) + r2 z) + t.
    x, y, z = source_points.unbind(-1)
    r, t = transform.rotation, transform.translation
    px, py, pz = (r[i, 0] * x + r[i, 1] * y + r[i, 2] * z + t[i] for i in range(3))
    safe_z = torch.where(pz == 0.0, 1e-12, pz)
    u = px * intrinsics.fx / safe_z + intrinsics.cx
    v = py * intrinsics.fy / safe_z + intrinsics.cy

    u_int = torch.trunc(u + 0.5)
    v_int = torch.trunc(v + 0.5)
    inbounds = (u_int >= 0) & (u_int < w) & (v_int >= 0) & (v_int < h)
    # NaN coordinates fail the bounds test above; zero them so the gather
    # index stays in range (the JAX gather clamps instead).
    ui = torch.nan_to_num(u_int, nan=0.0).clamp(0, w - 1).to(torch.int64)
    vi = torch.nan_to_num(v_int, nan=0.0).clamp(0, h - 1).to(torch.int64)
    geo = target_geo[vi * w + ui]
    tnx, tny, tnz = geo[:, 3], geo[:, 4], geo[:, 5]
    tvalid = geo[:, 6] > 0.0

    valid = source_mask & inbounds & tvalid
    dx, dy, dz = geo[:, 0] - px, geo[:, 1] - py, geo[:, 2] - pz
    dist_ok = _dot3(dx, dy, dz, dx, dy, dz) <= _f32(params.max_distance * params.max_distance)
    angle = torch.abs(torch.arccos(_dot3(px, py, pz, tnx, tny, tnz)))
    angle_rejected = angle >= _f32(params.max_normal_angle)  # NaN -> False

    w_geom = (valid & dist_ok & ~angle_rejected).to(torch.float32)
    residual_geom = _dot3(dx, dy, dz, tnx, tny, tnz)
    jac_geom = _se3_jacobian(px, py, pz, tnx, tny, tnz)
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
    dcx = -px * intrinsics.fx / zz
    dfy = torch.full_like(safe_z, intrinsics.fy) / safe_z
    dcy = -py * intrinsics.fy / zz
    cgx, cgy, cgz = du * dfx, dv * dfy, du * dcx + dv * dcy
    residual_color = source_color - target_color
    color_ok = residual_color * residual_color <= _f32(
        params.max_color_distance * params.max_color_distance
    )
    w_color = w_geom * color_ok.to(torch.float32)
    color = GNSystem.from_residuals(_se3_jacobian(px, py, pz, cgx, cgy, cgz), residual_color, w_color)
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
    _kernels.launch(
        "K1", rot.data_ptr(), trans.data_ptr(), points.data_ptr(), mask.data_ptr(), intensity.data_ptr(),
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
    return out
