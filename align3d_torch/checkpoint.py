"""Checkpoint and resume of long odometry runs (port of
``align3d_tpu/checkpoint.py``).

* :func:`save_state` / :func:`load_state` — an atomic npz snapshot of a flat
  dict of arrays, tensors or scalars;
* :func:`save_odometry` / :func:`load_odometry` — an in-progress
  trajectory and its frame cursor, with the run's fingerprint.

The npz keys are the JAX package's (``rotation``, ``translation``,
``times``, ``next_frame``, ``fingerprint``), so each package reads the
other's files; the fingerprints differ (each holds its package's
``repr`` of the ICP parameters), so only a load without one crosses over.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from align3d_torch.se3 import Transform
from align3d_torch.trajectory import Trajectory


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def save_state(path: str, state: dict) -> None:
    """Persist a flat dict of arrays, tensors or scalars to ``path`` (npz):
    written to a temporary file beside it, then renamed over it, so a crash
    leaves the old snapshot or the new one, never a torn file."""
    arrays = {k: _host(v) for k, v in state.items()}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(path: str) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def save_odometry(path: str, trajectory: Trajectory, next_frame: int, fingerprint: str | None = None) -> None:
    """Snapshot an in-progress odometry run. ``fingerprint`` names the run's
    configuration; :func:`load_odometry` refuses a checkpoint whose stored
    fingerprint differs from the one it is given, so two unrelated runs are
    never spliced into one trajectory."""
    state = {
        "rotation": trajectory.camera_to_world.rotation,
        "translation": trajectory.camera_to_world.translation,
        "times": trajectory.times,
        "next_frame": np.int64(next_frame),
    }
    if fingerprint is not None:
        state["fingerprint"] = np.array(fingerprint)
    save_state(path, state)


def load_odometry(path: str, fingerprint: str | None = None) -> tuple[Trajectory, int]:
    """The saved trajectory, as CPU tensors, and the next frame to align."""
    s = load_state(path)
    if fingerprint is not None and "fingerprint" in s:
        stored = str(s["fingerprint"])
        if stored != fingerprint:
            raise ValueError(
                f"checkpoint {path!r} was written by a different run "
                f"(stored fingerprint {stored!r} != current {fingerprint!r}); "
                "refusing to resume — delete the checkpoint or point "
                "--checkpoint elsewhere"
            )
    traj = Trajectory(
        Transform(torch.from_numpy(s["rotation"]), torch.from_numpy(s["translation"])),
        torch.from_numpy(s["times"]),
    )
    return traj, int(s["next_frame"])
