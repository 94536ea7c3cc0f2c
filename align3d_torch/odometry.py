"""Frame-to-frame odometry (port of ``align3d_tpu/odometry.py::run_odometry``).

Per frame: build the range-image pyramid on the device, run multiscale ICP
against the previous frame and accumulate the relative pose
(``examples/src/bin/odometry.rs:28-62``). Checkpointing and loop closure are
not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

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
    device,
    range_builder: RangeImageBuilder | None = None,
    icp_params: MsIcpParams | None = None,
    max_frames: int | None = None,
    progress: Callable[[int, int], None] | None = None,
) -> OdometryResult:
    """Sequential frame-to-frame odometry on ``device``.

    ``seconds_per_frame`` is host time over frames 1..n-1 and includes the
    frames' decode and upload; it ends in a device synchronisation.
    """
    device = torch.device(device)
    range_builder = range_builder or RangeImageBuilder()
    icp_params = icp_params or MsIcpParams.default()
    n = len(dataset) if max_frames is None else min(len(dataset), max_frames)

    traj_builder = TrajectoryBuilder(Transform.identity(device=device), 0.0)
    last_pyramid = range_builder.build(dataset.get(0), device)
    residuals: list = []
    start = time.perf_counter()
    for i in range(1, n):
        current = range_builder.build(dataset.get(i), device)
        align = MultiscaleAlign(icp_params, last_pyramid)
        transform = align.align(current)
        residuals.append(align.last_residual)
        traj_builder.accumulate(transform, float(i))
        last_pyramid = current
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
        seconds_per_frame=elapsed / max(n - 1, 1),
        residuals=residuals,
    )
