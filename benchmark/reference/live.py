"""The reference of the live tracking server: ``run_odometry`` over the
frames the server tracked, stream by stream. Each tracked pair (the
stream's last tracked frame as target, the new one as source) is worked
out again from the raw frames by :func:`pipeline.outputs`, and each
stream's poses are chained from the identity as ``TrajectoryBuilder``
accumulates them (``P_k = rel_k @ P_(k-1)``)."""

from __future__ import annotations

import torch

from benchmark.reference import Precision, pipeline, se3


def pair_outputs(config: dict, fixtures: dict, keys: list, prec: Precision, device) -> dict:
    """The filtered depths, pyramids and relative pose of one tracked pair
    ``keys`` = [target frame, source frame]."""
    return pipeline.outputs(config, fixtures, keys, prec, device)


def chain(relative: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """(R (N + 1, 3, 3), t (N + 1, 3)): the identity, then each relative pose
    (R (N, 3, 3), t (N, 3)) composed onto the pose before it."""
    rot, trans = relative
    poses = [se3.identity((), rot.device)]
    for k in range(rot.shape[0]):
        poses.append(se3.compose((rot[k], trans[k]), poses[-1]))
    return torch.stack([p[0] for p in poses]), torch.stack([p[1] for p in poses])


def trajectory(config: dict, fixtures: dict, keys: list, prec: Precision, device) -> tuple[torch.Tensor, torch.Tensor]:
    """One stream's camera-to-world poses over its tracked frames ``keys``
    (the first at the origin): every adjacent pair aligned, then chained."""
    return chain(pipeline.outputs(config, fixtures, keys, prec, device)["rel"])
