"""Camera trajectories (port of ``align3d_tpu/trajectory.py``).

A trajectory is one batched :class:`Transform` (leading frame axis) plus a
timestamp vector. :class:`TrajectoryBuilder` accumulates odometry with the
reference's left fold ``last = now_to_previous @ last``
(``src/trajectory.rs:164-168``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from align3d_torch import se3
from align3d_torch.se3 import Transform


@dataclasses.dataclass
class Trajectory:
    """Pose list: ``camera_to_world`` batched Transform + ``times`` (N,)."""

    camera_to_world: Transform
    times: torch.Tensor

    def __len__(self) -> int:
        return int(self.times.shape[0])

    def __getitem__(self, idx: int) -> Transform:
        return self.camera_to_world[idx]

    @classmethod
    def empty(cls) -> "Trajectory":
        return cls(Transform(torch.zeros((0, 3, 3)), torch.zeros((0, 3))), torch.zeros((0,)))

    @classmethod
    def from_list(cls, poses: list[Transform], times=None) -> "Trajectory":
        device = poses[0].device
        if times is None:
            times = torch.arange(len(poses), dtype=torch.float32)
        return cls(se3.stack(poses), torch.as_tensor(times, dtype=torch.float32).to(device))

    def to(self, device) -> "Trajectory":
        return Trajectory(self.camera_to_world.to(device), self.times.to(device))

    def get_relative_transform(self, from_index: int, dest_index: int) -> Transform:
        """``dest^-1 @ from`` (reference src/trajectory.rs:47-53)."""
        return self.camera_to_world[dest_index].inverse() @ self.camera_to_world[from_index]

    def first_frame_at_origin(self) -> "Trajectory":
        """Re-base so pose 0 is the identity (src/trajectory.rs:64-78)."""
        if len(self) == 0:
            return self
        first_inv = self.camera_to_world[0].inverse()
        rebased = Transform(
            torch.einsum("ij,njk->nik", first_inv.rotation, self.camera_to_world.rotation),
            torch.einsum("ij,nj->ni", first_inv.rotation, self.camera_to_world.translation)
            + first_inv.translation,
        )
        return Trajectory(rebased, self.times)

    def slice(self, start: int, end: int) -> "Trajectory":
        return Trajectory(self.camera_to_world[start:end], self.times[start:end])

    def last(self) -> tuple[Transform, float] | None:
        if len(self) == 0:
            return None
        return self.camera_to_world[-1], float(self.times[-1])

    def to_tum(self) -> str:
        """TUM trajectory text: ``t tx ty tz qx qy qz qw`` per line."""
        quats = self.camera_to_world.to_quat().cpu().numpy()  # (N, 4) wxyz
        trans = self.camera_to_world.translation.cpu().numpy()
        times = self.times.cpu().numpy()
        lines = []
        for i in range(len(self)):
            w, x, y, z = quats[i]
            tx, ty, tz = trans[i]
            lines.append(f"{times[i]:.6f} {tx:.7f} {ty:.7f} {tz:.7f} {x:.7f} {y:.7f} {z:.7f} {w:.7f}")
        return "\n".join(lines) + "\n"

    @classmethod
    def from_tum(cls, text: str) -> "Trajectory":
        """Parse TUM text; blank lines and ``#`` comments are skipped."""
        times, poses = [], []
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, tx, ty, tz, qx, qy, qz, qw = (float(tok) for tok in line.split()[:8])
            times.append(t)
            poses.append(Transform.from_quat([tx, ty, tz], [qw, qx, qy, qz]))
        return cls.from_list(poses, np.asarray(times, np.float32))


def _combine(a: tuple, b: tuple) -> tuple:
    """``b @ a`` for (rotation, translation) pairs: ``b`` is the later pose."""
    return b[0] @ a[0], se3._mv(b[0], a[1]) + b[1]


def _scan(elems: tuple) -> tuple:
    """Inclusive prefix composition along axis 0 with the recursion of
    ``jax.lax.associative_scan``: combine adjacent pairs, scan the pairs,
    then fill in the even positions, so every product is formed from the
    same operands in the same order as there."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    odd = _scan(_combine(tuple(e[0:-1:2] for e in elems), tuple(e[1::2] for e in elems)))
    left = odd if n % 2 else tuple(e[:-1] for e in odd)
    even = _combine(left, tuple(e[2::2] for e in elems))
    even = tuple(torch.cat([e[:1], r]) for e, r in zip(elems, even))
    out = []
    for e, o in zip(even, odd):
        both = torch.empty((n, *e.shape[1:]), dtype=e.dtype, device=e.device)
        both[0::2], both[1::2] = e, o
        out.append(both)
    return tuple(out)


def accumulate_scan(relative: Transform, start: Transform | None = None, times=None) -> Trajectory:
    """Parallel-prefix odometry accumulation (port of the JAX package's
    ``accumulate_scan``): from relative poses ``T_1..T_N`` (leading axis N),
    the absolute poses ``P_i = T_i @ ... @ T_1 @ start``, the left fold of
    :meth:`TrajectoryBuilder.accumulate` in ~2 log2(N) rounds of batched
    3x3 products. The trajectory includes the start pose: N + 1 entries."""
    n = relative.rotation.shape[0]
    device = relative.rotation.device
    start = start if start is not None else Transform.identity(device=device)
    rots, trans = _scan((relative.rotation, relative.translation))
    abs_rot = rots @ start.rotation
    abs_t = se3._mv(rots, start.translation) + trans
    camera_to_world = Transform(
        torch.cat([start.rotation[None], abs_rot]), torch.cat([start.translation[None], abs_t])
    )
    if times is None:
        times = torch.arange(n + 1, dtype=torch.float32, device=device)
    return Trajectory(camera_to_world, torch.as_tensor(times, dtype=torch.float32).to(device))


class TrajectoryBuilder:
    """Odometry accumulator (reference src/trajectory.rs:131-184). Without a
    start pose the fold starts from the identity, made on the device of the
    first accumulated transform."""

    def __init__(self, start: Transform | None = None, start_time: float = 0.0):
        self._poses: list[Transform] = []
        self._times: list[float] = []
        if start is not None:
            self._poses.append(start)
            self._times.append(start_time)
        self._last = start
        self._last_time = start_time

    @classmethod
    def with_start(cls, start: Transform, start_time: float) -> "TrajectoryBuilder":
        return cls(start=start, start_time=start_time)

    @classmethod
    def from_trajectory(cls, traj: Trajectory) -> "TrajectoryBuilder":
        """Resume accumulation from an existing trajectory, on its device
        (checkpoint restore): the fold continues from its last pose."""
        builder = cls()
        builder._poses = [traj.camera_to_world[k] for k in range(len(traj))]
        builder._times = [float(t) for t in traj.times]
        if builder._poses:
            builder._last = builder._poses[-1]
            builder._last_time = builder._times[-1]
        return builder

    def accumulate(self, now_to_previous: Transform, timestamp: float | None = None) -> None:
        last = self._last if self._last is not None else Transform.identity(device=now_to_previous.device)
        self._last = now_to_previous @ last
        self._last_time = timestamp if timestamp is not None else self._last_time + 1.0
        self._poses.append(self._last)
        self._times.append(self._last_time)

    def current_camera_to_world(self) -> Transform | None:
        return self._poses[-1] if self._poses else None

    def build(self) -> Trajectory:
        if not self._poses:
            return Trajectory.empty()
        return Trajectory.from_list(self._poses, np.asarray(self._times, np.float32))
