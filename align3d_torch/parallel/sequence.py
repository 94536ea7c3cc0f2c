"""Sequence parallelism over the frame axis with a one-frame halo (port of
``align3d_tpu/parallel/sequence.py``).

The frame sequence is sharded over the 1-D mesh:

* N frames are padded to a multiple of W by repeating the last frame (as
  the JAX package pads), and rank r holds the contiguous block of
  F = N_pad / W frames starting at r F;
* the pair at a block boundary needs the last frame of the previous block:
  that frame is the halo. Every rank's last frame is all-gathered (W
  broadcasts of one frame, :mod:`align3d_torch.parallel.collectives`; the
  JAX package's single ``ppermute`` hop has no counterpart that both NCCL
  and gloo carry for CUDA tensors) and rank r > 0 puts rank r - 1's in
  front of its block;
* the filter (when given), the pyramids and the align run rank-local;
  rank 0 has no halo and aligns F - 1 pairs: the JAX package's dummy pair
  against a zero frame is never computed, its slot holds the identity;
* the (F,) relative poses are all-gathered, the dummy slot and the padded
  pairs are dropped, and the prefix scan runs replicated over the N - 1
  true pairs (the JAX package scans the padded pairs too and trims the
  poses after; trimming first keeps the scan the unsharded step's, so
  the trajectory is bitwise :func:`align3d_torch.parallel.batch.
  odometry_step`'s).

Per rank, the work is O(N / W) frames; the traffic is one frame a rank and
the poses.
"""

from __future__ import annotations

import numpy as np
import torch

from align3d_torch.camera import CameraIntrinsics
from align3d_torch.icp.params import MsIcpParams
from align3d_torch.parallel import collectives as col
from align3d_torch.parallel.batch import align_frames, frame_inputs, frame_scales, stage
from align3d_torch.trajectory import Trajectory, accumulate_scan
from align3d_torch.utils import profiling


def odometry_sequence_parallel(
    intrinsics: CameraIntrinsics,
    depth_scale,
    colors,  # (N, H, W, 3) u8 — N consecutive frames, or this rank's block as a DTensor
    depths,  # (N, H, W) u16
    mesh,
    params: MsIcpParams | None = None,
    pyramid_levels: int = 3,
    bilateral_filter=None,
    timer=None,
) -> Trajectory:
    """Whole-sequence odometry, frame axis sharded over ``mesh``.

    Every rank passes the whole sequence, or its block of a frame-sharded
    DTensor (:func:`align3d_torch.parallel.multihost.host_local_batch`,
    whose global length is then N); ``depth_scale`` is a float or one per
    frame of the whole sequence. Returns the whole trajectory (N poses,
    frame 0 at the origin) on every rank. ``bilateral_filter`` filters
    each rank's frames first, as in ``odometry_step``; ``timer`` (a
    StageTimer) times the stages. Records the spans ``odometry_step``
    records (``batch.step`` with this rank's pairs, ``batch.upload``), and
    ``dist.halo`` and ``dist.gather`` around the two all-gathers.
    """
    params = params or MsIcpParams.default()
    device = col.device(mesh)
    w, r = col.world(mesh), col.rank(mesh)
    if col.is_sharded(colors):
        f = col.local(colors).shape[0]
        n, block = f * w, slice(None)
    else:
        n = col.local(colors).shape[0]
        f = -(-n // w)
        # JAX's padding repeats the last frame; each rank reads its block only.
        block = np.minimum(np.arange(r * f, (r + 1) * f), n - 1)
    pairs = f - 1 if r == 0 else f
    with profiling.span("batch.step", pairs=pairs):
        with profiling.span("batch.upload"):
            colors_b, depths_b = frame_inputs(colors, depths, block, device)
            # The global frames this rank aligns: the halo (r > 0), then its block.
            scales = frame_scales(depth_scale, np.minimum(np.arange(max(r * f - 1, 0), (r + 1) * f), n - 1), device)
        with stage(timer, "halo", depths_b):
            with profiling.span("dist.halo"):
                last_c, last_d = col.all_gather(mesh, colors_b[-1], depths_b[-1])
            if r > 0:
                colors_b = torch.cat([last_c[r - 1 : r], colors_b])
                depths_b = torch.cat([last_d[r - 1 : r], depths_b])
        relative = align_frames(intrinsics, scales, colors_b, depths_b, params, pyramid_levels, bilateral_filter,
                                timer)
        with stage(timer, "gather", relative.rotation):
            with profiling.span("dist.gather"):
                # Slot 0 is rank 0's dummy pair (source frame 0); slots past n - 1 are padding.
                relative = col.gather_poses(mesh, relative, f, front=1 if r == 0 else 0)[1:n]
        with stage(timer, "scan", relative.rotation):
            return accumulate_scan(relative)
