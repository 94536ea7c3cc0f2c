"""Frame-to-frame odometry (port of ``align3d_tpu/odometry.py``).

:func:`run_odometry`, per frame: build the range-image pyramid on the
device, run multiscale ICP against the previous frame and accumulate the
relative pose (``examples/src/bin/odometry.rs:28-62``), with the JAX
package's checkpoint and resume (:mod:`align3d_torch.checkpoint`).
:func:`refine_with_loop_closures` then refines the trajectory globally:
loop-closure candidates measured by multiscale ICP, and a pose graph
(:mod:`align3d_torch.parallel.pose_graph`).
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
from align3d_torch.parallel import pose_graph as pg
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


def refine_with_loop_closures(
    dataset,
    result: OdometryResult,
    device="cuda",
    range_builder: RangeImageBuilder | None = None,
    icp_params: MsIcpParams | None = None,
    min_separation: int = 10,
    max_translation: float = 0.5,
    max_candidates: int = 16,
    closure_weight: float = 5.0,
    iterations: int = 10,
    mesh=None,
) -> OdometryResult:
    """Global trajectory refinement on ``device``: propose loop-closure
    candidates from the odometry trajectory (pose distance), measure each
    candidate's relative pose with multiscale ICP seeded from the odometry
    estimate, and optimize the pose graph (odometry chain + closure edges
    of weight ``closure_weight``) by Gauss-Newton. ``mesh`` must be None:
    the sharded solve is not ported yet (ROADMAP Queue 1 item 4)."""
    if mesh is not None:
        raise NotImplementedError(pg.SHARDING_NOT_PORTED)
    device = torch.device(device)
    range_builder = range_builder or RangeImageBuilder()
    icp_params = icp_params or MsIcpParams.default()
    traj = result.trajectory.to(device)

    candidates = pg.propose_loop_closures(
        traj, min_separation=min_separation, max_translation=max_translation, max_candidates=max_candidates
    )
    edges = []
    for i, j in candidates.tolist():
        target = range_builder.build(dataset.get(i), device)
        source = range_builder.build(dataset.get(j), device)
        z = MultiscaleAlign(icp_params, target).align(source, initial_transform=traj.get_relative_transform(j, i))
        edges.append((i, j, z, closure_weight))

    refined = pg.refine_trajectory(traj, loop_edges=edges, iterations=iterations)
    metrics = None
    gt = dataset.trajectory()
    if gt is not None:
        gt = gt.slice(0, len(refined)).first_frame_at_origin().to(device)
        metrics = TransformMetrics.mean_trajectory_error(refined, gt)
    return OdometryResult(trajectory=refined, metrics=metrics, seconds_per_frame=result.seconds_per_frame)
