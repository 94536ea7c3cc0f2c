"""Frame-to-frame odometry (port of ``align3d_tpu/odometry.py::run_odometry``).

Per frame: build the range-image pyramid on the device, run multiscale ICP
against the previous frame and accumulate the relative pose
(``examples/src/bin/odometry.rs:28-62``), with the JAX package's checkpoint
and resume (:mod:`align3d_torch.checkpoint`). Loop closure is not ported
yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import torch

from align3d_torch import checkpoint
from align3d_torch.icp.multiscale import MultiscaleAlign
from align3d_torch.icp.params import MsIcpParams
from align3d_torch.metrics import TransformMetrics
from align3d_torch.range_image import RangeImageBuilder
from align3d_torch.se3 import Transform
from align3d_torch.trajectory import Trajectory, TrajectoryBuilder


@dataclasses.dataclass
class OdometryResult:
    trajectory: Trajectory
    metrics: Optional[TransformMetrics]  # against the dataset's ground truth, if any
    seconds_per_frame: float
    residuals: Optional[list] = None  # per-frame best mean-squared residual


def run_odometry(
    dataset,
    device="cuda",
    range_builder: RangeImageBuilder | None = None,
    icp_params: MsIcpParams | None = None,
    max_frames: int | None = None,
    progress: Callable[[int, int], None] | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 10,
) -> OdometryResult:
    """Sequential frame-to-frame odometry on ``device``.

    ``checkpoint_path``: snapshot the trajectory every ``checkpoint_every``
    frames and at the end; when the file exists the run resumes from its
    frame cursor, so an aborted run invoked again with the same arguments
    gives the trajectory of an uninterrupted one. ``residuals`` then covers
    the resumed frames only. ``seconds_per_frame`` is host time over the
    frames aligned in this call and includes their decode and upload; it
    ends in a device synchronisation.
    """
    device = torch.device(device)
    range_builder = range_builder or RangeImageBuilder()
    icp_params = icp_params or MsIcpParams.default()
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
    n = len(dataset) if max_frames is None else min(len(dataset), max_frames)

    # The run's identity: the dataset (wrappers unwrapped, so a resume with
    # another max_frames keeps it), its length and the ICP configuration.
    base = dataset
    while not hasattr(base, "base_dir") and hasattr(base, "dataset"):
        base = base.dataset
    fingerprint = f"{getattr(base, 'base_dir', type(base).__name__)}|len={len(base)}|{icp_params!r}"

    start_frame = 1
    traj_builder = TrajectoryBuilder.with_start(Transform.identity(device=device), 0.0)
    if checkpoint_path and os.path.exists(checkpoint_path):
        saved, next_frame = checkpoint.load_odometry(checkpoint_path, fingerprint=fingerprint)
        if next_frame > 1:
            # A checkpoint past the requested length is cut to it.
            saved = saved.slice(0, min(len(saved), n)).to(device)
            traj_builder = TrajectoryBuilder.from_trajectory(saved)
            start_frame = min(next_frame, n)

    last_pyramid = range_builder.build(dataset.get(start_frame - 1), device)
    residuals: list = []
    start = time.perf_counter()
    for i in range(start_frame, n):
        current = range_builder.build(dataset.get(i), device)
        align = MultiscaleAlign(icp_params, last_pyramid)
        transform = align.align(current)
        residuals.append(align.last_residual)
        traj_builder.accumulate(transform, float(i))
        last_pyramid = current
        if checkpoint_path and (i % checkpoint_every == 0 or i == n - 1):
            checkpoint.save_odometry(checkpoint_path, traj_builder.build(), i + 1, fingerprint=fingerprint)
        if progress is not None:
            progress(i, n - 1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - start

    pred = traj_builder.build()
    metrics = None
    gt = dataset.trajectory()
    if gt is not None:
        gt = gt.slice(0, n).first_frame_at_origin().to(device)
        metrics = TransformMetrics.mean_trajectory_error(pred, gt)
    return OdometryResult(
        trajectory=pred,
        metrics=metrics,
        seconds_per_frame=elapsed / max(n - start_frame, 1),
        residuals=residuals,
    )
