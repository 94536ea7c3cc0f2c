"""Frame-pair batching: the throughput configuration (port of
``align3d_tpu/parallel/batch.py`` on one device).

Every per-frame stage takes a leading frame axis, written out where the JAX
package ``vmap``s: the bilateral filter runs one splat and one slice launch
per depth bucket, the pyramids are built for all frames at once, and each
Gauss-Newton iteration of the multiscale align is one launch of the fused
step over all pairs (the level's engine: K1 exact, K7 ``"pallas"`` or K8
``"pallas_v4"`` banded, as the JAX package routes each level), followed by
the batched solve and update on the device. :func:`odometry_step` is the whole pipeline for N consecutive
frames: N - 1 adjacent pairs aligned at once, their relative poses composed
by a parallel prefix scan. It waits for the device once, to plan the
bilateral filter's depth buckets, and otherwise not until the caller reads
the trajectory.

Sharding (:func:`make_mesh`, ``odometry_step(mesh=)``): the N - 1 pairs
are split into W contiguous shares, one a rank of the 1-D mesh. Each rank
moves only the frames of its share (``[lo, hi + 1]``) to its device and
runs the filter, the pyramids and the align on them alone: no collective
until the relative poses, which one all-gather (W broadcasts of the (per,
3, 4) poses, :mod:`align3d_torch.parallel.collectives`) gives every rank;
the prefix scan then runs replicated. Each pair is the same computation
as unsharded (K1 over B pairs is bitwise K1 over one, and each frame's
bucketed filter is bitwise its own), so the trajectory is bitwise the
unsharded one. A batch sharded on the frame axis (a DTensor from
:func:`align3d_torch.parallel.multihost.host_local_batch`) goes to the
sequence-parallel form, :mod:`align3d_torch.parallel.sequence`.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from align3d_torch.camera import CameraIntrinsics
from align3d_torch.icp.image_icp import align_batched
from align3d_torch.icp.params import MsIcpParams
from align3d_torch.ops.bilateral import BilateralFilter, nonzero_min_max, plan_depth_buckets
from align3d_torch.parallel import collectives as col
from align3d_torch.range_image import RangeImage, build_pyramid_impl
from align3d_torch.se3 import Transform
from align3d_torch.trajectory import Trajectory, accumulate_scan
from align3d_torch.utils import profiling

BATCH_AXIS = "pairs"


def make_mesh(n_devices: int | None = None, devices="cuda"):
    """1-D device mesh over the batch (``"pairs"``) axis: one rank of the
    process group per mesh entry, on ``devices`` (a device type, ``"cuda"``
    or ``"cpu"``). In a process with no group it first makes a one-rank
    group (NCCL for CUDA, gloo for the CPU), as the JAX package's
    single-process mesh spans this process's devices; several processes
    join one group first (:func:`align3d_torch.parallel.multihost.initialize`).
    ``n_devices``, when given, must be the group's size."""
    mesh = col.one_dim_mesh(devices, BATCH_AXIS)
    if n_devices is not None and n_devices != mesh.size():
        raise ValueError(f"n_devices={n_devices}, but the process group has {mesh.size()} ranks")
    return mesh


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
    """Coarse-to-fine multiscale ICP of B pairs at once, each level on its
    own engine (``align_batched``); the pyramids are lists (fine -> coarse)
    of batched RangeImages with a shared leading pair axis. Returns the
    relative poses, a batched Transform (B,)."""
    b = target_pyramid[0].points.shape[0]
    pose = initial if initial is not None else Transform.identity((b,), device=target_pyramid[0].device)
    levels = list(zip(params, target_pyramid, source_pyramid))
    with profiling.span("icp.align", pairs=b):
        for level in reversed(range(len(levels))):
            level_params, target, source = levels[level]
            with profiling.span("icp.level", level=level, pairs=b):
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
    with profiling.span("batch.plan_wait"):
        lo, hi = cmin.cpu().numpy(), cmax.cpu().numpy()
    plan = plan_depth_buckets(lo, hi, filt.sigma_color, quantum)
    return filt.filter_static_buckets(depths, cmin, plan), plan


def stage(timer, name: str, force=None):
    """``timer.stage(name, force)`` of a
    :class:`align3d_torch.utils.profiling.StageTimer` (which, ``force``
    being on the card, ends the stage with a synchronise), or nothing
    without one."""
    return contextlib.nullcontext() if timer is None else timer.stage(name, force)


def frame_inputs(colors, depths, index, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Frames ``index`` (a slice or an index array) of the inputs (numpy,
    tensors or DTensors, whose local part is taken) on ``device``: colours
    u8, depths int32."""
    colors = torch.as_tensor(col.local(colors))[index].to(device)
    depths = col.local(depths)
    if isinstance(depths, np.ndarray):
        depths = torch.from_numpy(depths[index].astype(np.int32))
    else:
        depths = depths[index]
    return colors, depths.to(device=device, dtype=torch.int32).contiguous()


def frame_scales(depth_scale, index, device):
    """``depth_scale`` as it is if it is one number, else (one per frame)
    a tensor of frames ``index``'s on ``device``."""
    if isinstance(depth_scale, (list, tuple, np.ndarray)):
        depth_scale = torch.as_tensor(np.asarray(depth_scale, np.float32))
    if isinstance(depth_scale, torch.Tensor) and depth_scale.ndim:
        return depth_scale[index].to(device)
    return depth_scale


def align_frames(intrinsics, depth_scale, colors, depths, params, pyramid_levels, bilateral_filter,
                 timer=None) -> Transform:
    """The relative poses of the F - 1 adjacent pairs of F frames on one
    device (source frame i, target frame i - 1): filter, pyramids, align."""
    if bilateral_filter is not None:
        with stage(timer, "filter", depths):
            depths, _ = filter_buckets(bilateral_filter, depths)
    if depths.shape[0] < 2:
        return Transform.identity((0,), device=depths.device)
    with stage(timer, "pyramids", depths):
        pyramid = build_pyramids_batched(intrinsics, depth_scale, colors, depths, pyramid_levels=pyramid_levels)
    sources = [level.frames(slice(1, None)) for level in pyramid]
    targets = [level.frames(slice(None, -1)) for level in pyramid]
    with stage(timer, "align", depths):
        return multiscale_align_batched(targets, sources, params)


def odometry_step(
    intrinsics: CameraIntrinsics,
    depth_scale,
    colors,  # (N, H, W, 3) u8, numpy or tensor: N consecutive frames
    depths,  # (N, H, W) u16 numpy or int tensor
    params: MsIcpParams | None = None,
    pyramid_levels: int = 3,
    bilateral_filter: BilateralFilter | None = None,
    device=None,
    mesh=None,
    timer=None,
) -> Trajectory:
    """Whole-sequence odometry as one batched computation on ``device``
    (default ``"cuda"``).

    With ``bilateral_filter``, filters the depths through depth buckets
    first (as ``benches/bench_odometry.py`` does); builds the pyramids of
    all N frames; aligns the N - 1 adjacent pairs (source frame i, target
    frame i - 1, as the sequential `run_odometry`); composes the relative poses with
    a parallel prefix scan. ``depth_scale`` is a float or one per frame.

    With ``mesh`` (:func:`make_mesh`), every rank passes the whole
    sequence (or a replicated DTensor), runs on the mesh's device (which
    ``device``, if given, must name) and aligns its share of the pairs; the
    module docstring says what is exchanged. Every rank returns the whole
    trajectory. ``timer`` (a StageTimer) times the stages, each ended by a
    synchronise.
    """
    params = params or MsIcpParams.default()
    if mesh is not None and col.is_sharded(colors):
        from align3d_torch.parallel.sequence import odometry_sequence_parallel

        return odometry_sequence_parallel(intrinsics, depth_scale, colors, depths, mesh, params, pyramid_levels,
                                          bilateral_filter=bilateral_filter, timer=timer)
    device = col.resolve_device(mesh, device)
    n = col.local(colors).shape[0]
    if mesh is None:
        lo, hi, per = 0, n - 1, n - 1
    else:
        lo, hi, per = col.share(n - 1, mesh)
    frames = slice(lo, hi + 1)
    with profiling.span("batch.step", pairs=hi - lo):
        with profiling.span("batch.upload"):
            scales = frame_scales(depth_scale, frames, device)
            colors, depths = frame_inputs(colors, depths, frames, device)
        relative = align_frames(intrinsics, scales, colors, depths, params, pyramid_levels, bilateral_filter, timer)
        if mesh is not None:
            with stage(timer, "gather", relative.rotation):
                relative = col.gather_poses(mesh, relative, per)[: n - 1]
        with stage(timer, "scan", relative.rotation):
            return accumulate_scan(relative)
