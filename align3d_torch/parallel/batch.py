"""Frame-pair batching: the throughput configuration (port of
``align3d_tpu/parallel/batch.py`` on one device).

Every per-frame stage takes a leading frame axis, written out where the JAX
package ``vmap``s: the bilateral filter runs one splat and one slice launch
per depth bucket, the pyramids are built for all frames at once, and each
Gauss-Newton iteration of the multiscale align is one launch of the fused
step (K1) over all pairs, followed by the batched solve and update on the
device. :func:`odometry_step` is the whole pipeline for N consecutive
frames: N - 1 adjacent pairs aligned at once, their relative poses composed
by a parallel prefix scan. It waits for the device once, to plan the
bilateral filter's depth buckets, and otherwise not until the caller reads
the trajectory.

The JAX package's ``mesh=`` argument (the pair axis sharded over devices)
and ``make_mesh`` are not ported yet (ROADMAP, distribution).
"""

from __future__ import annotations

import numpy as np
import torch

from align3d_torch.camera import CameraIntrinsics
from align3d_torch.icp.image_icp import align_batched
from align3d_torch.icp.params import MsIcpParams
from align3d_torch.ops.bilateral import BilateralFilter, nonzero_min_max, plan_depth_buckets
from align3d_torch.range_image import RangeImage, build_pyramid_impl
from align3d_torch.se3 import Transform
from align3d_torch.trajectory import Trajectory, accumulate_scan


def build_pyramids_batched(
    intrinsics: CameraIntrinsics,
    depth_scale,
    colors: torch.Tensor,  # (B, H, W, 3) u8
    depths: torch.Tensor,  # (B, H, W) int32 (bilateral filter applied if wanted)
    with_normals: bool = True,
    with_intensity: bool = True,
    pyramid_levels: int = 3,
    blur_sigma: float = 1.0,
) -> list[RangeImage]:
    """Pyramids of B frames: a list (fine -> coarse) of batched RangeImages.
    ``depth_scale`` is a float or a (B,) tensor."""
    return build_pyramid_impl(
        with_normals, with_intensity, pyramid_levels, blur_sigma, intrinsics, depth_scale, colors, depths
    )


def _flatten_level(ri: RangeImage) -> tuple:
    """Batched RangeImage -> flattened per-pair tensors for the ICP step."""
    b, n = ri.points.shape[0], ri.height * ri.width
    return (
        ri.points.reshape(b, n, 3),
        ri.mask.reshape(b, n),
        ri.intensities.reshape(b, n),
        ri.normals.reshape(b, n, 3),
        ri.intensity_map,
    )


def multiscale_align_batched(
    target_pyramid: list[RangeImage],
    source_pyramid: list[RangeImage],
    params: MsIcpParams,
    initial: Transform | None = None,
) -> Transform:
    """Coarse-to-fine multiscale ICP of B pairs at once; the pyramids are
    lists (fine -> coarse) of batched RangeImages with a shared leading pair
    axis. Returns the relative poses, a batched Transform (B,)."""
    b = target_pyramid[0].points.shape[0]
    pose = initial if initial is not None else Transform.identity((b,), device=target_pyramid[0].device)
    for level_params, target, source in reversed(list(zip(params, target_pyramid, source_pyramid))):
        sp, sm, si, _, _ = _flatten_level(source)
        tp, tm, _, tn, tim = _flatten_level(target)
        pose, _ = align_batched(pose, sp, sm, si, tp, tm, tn, tim, target.intrinsics, level_params)
    return pose


def filter_buckets(filt: BilateralFilter, depths: torch.Tensor, quantum: int = 16) -> tuple[torch.Tensor, list]:
    """The bilateral filter over (N, H, W) frames whose depth spans differ:
    each frame's grid at its own true depth (grid.rs:51-54), frames grouped
    into depth buckets planned from their nonzero minimum and maximum (one
    wait for the device). Returns the filtered depths and the plan."""
    cmin, cmax = nonzero_min_max(depths)
    plan = plan_depth_buckets(cmin.cpu().numpy(), cmax.cpu().numpy(), filt.sigma_color, quantum)
    return filt.filter_static_buckets(depths, cmin, plan), plan


def odometry_step(
    intrinsics: CameraIntrinsics,
    depth_scale,
    colors,  # (N, H, W, 3) u8, numpy or tensor: N consecutive frames
    depths,  # (N, H, W) u16 numpy or int tensor
    params: MsIcpParams | None = None,
    pyramid_levels: int = 3,
    bilateral_filter: BilateralFilter | None = None,
    device="cuda",
) -> Trajectory:
    """Whole-sequence odometry as one batched computation on ``device``.

    With ``bilateral_filter``, filters the depths through depth buckets
    first (as ``benches/bench_odometry.py`` does); builds the pyramids of
    all N frames; aligns the N - 1 adjacent pairs (source frame i, target
    frame i - 1, as the sequential `run_odometry`); composes the relative poses with
    a parallel prefix scan. ``depth_scale`` is a float or one per frame.
    """
    params = params or MsIcpParams.default()
    device = torch.device(device)
    colors = torch.as_tensor(colors).to(device)
    if isinstance(depths, np.ndarray):
        depths = torch.from_numpy(depths.astype(np.int32))
    depths = depths.to(device=device, dtype=torch.int32).contiguous()
    if isinstance(depth_scale, (list, tuple, np.ndarray)):
        depth_scale = torch.as_tensor(np.asarray(depth_scale, np.float32), device=device)
    if bilateral_filter is not None:
        depths, _ = filter_buckets(bilateral_filter, depths)
    pyramid = build_pyramids_batched(intrinsics, depth_scale, colors, depths, pyramid_levels=pyramid_levels)
    sources = [level.frames(slice(1, None)) for level in pyramid]
    targets = [level.frames(slice(None, -1)) for level in pyramid]
    relative = multiscale_align_batched(targets, sources, params)
    return accumulate_scan(relative)
