"""TUM RGB-D dataset loader (port of ``align3d_tpu/io/datasets/tum.py``;
reference ``src/io/dataset/tum.rs``).

Reads ``rgb.txt``, ``depth.txt`` and ``groundtruth.txt``, pairs them by
timestamp with the reference's two-pointer merge and its +-0.02 s window
(tum.rs:41-68); depth scale 1/5000, the hardcoded Freiburg intrinsics
(tum.rs:166-173).
"""

from __future__ import annotations

import os

import numpy as np

from align3d_torch.camera import CameraIntrinsics
from align3d_torch.image import RgbdFrame, RgbdImage
from align3d_torch.io.datasets.core import DatasetError, load_depth_u16, load_rgb
from align3d_torch.se3 import Transform
from align3d_torch.trajectory import Trajectory

_FR_INTRINSICS = CameraIntrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)
_DEPTH_SCALE = 1.0 / 5000.0


def _read_file_list(path) -> list[tuple[float, str]]:
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                toks = line.replace(",", " ").replace("\t", " ").split()
                out.append((float(toks[0]), toks[1]))
    except OSError as e:
        raise DatasetError(str(e)) from e
    return out


def _associate(first: list, second: list) -> list[tuple[float, object, float, object]]:
    """Two-pointer timestamp association, |dt| < 0.02 s (tum.rs:41-68)."""
    result = []
    i = j = 0
    while i < len(first) and j < len(second):
        t1, v1 = first[i]
        t2, v2 = second[j]
        if abs(t1 - t2) < 0.02:
            result.append((t1, v1, t2, v2))
            i += 1
            j += 1
        elif t1 < t2:
            i += 1
        else:
            j += 1
    return result


def _load_trajectory(path) -> list[tuple[float, Transform]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, tx, ty, tz, qx, qy, qz, qw = (float(tok) for tok in line.split()[:8])
            pose = Transform.from_quat(np.asarray([tx, ty, tz], np.float32), np.asarray([qw, qx, qy, qz], np.float32))
            out.append((t, pose))
    return out


class TumRgbdDataset:
    def __init__(self, base_dir, rgb_images, depth_images, trajectory):
        self.base_dir = base_dir
        self.rgb_images = rgb_images
        self.depth_images = depth_images
        self._trajectory = trajectory

    @classmethod
    def load(cls, base_dir: str) -> "TumRgbdDataset":
        rgb_files = _read_file_list(os.path.join(base_dir, "rgb.txt"))
        depth_files = _read_file_list(os.path.join(base_dir, "depth.txt"))
        depth_rgb = _associate(depth_files, rgb_files)
        rgb_images = [e[3] for e in depth_rgb]
        depth_images = [e[1] for e in depth_rgb]

        depth_traj = _associate(depth_files, _load_trajectory(os.path.join(base_dir, "groundtruth.txt")))
        poses = [e[3] for e in depth_traj]
        times = [e[2] for e in depth_traj]
        trajectory = Trajectory.from_list(poses, np.asarray(times, np.float32))
        return cls(base_dir, rgb_images, depth_images, trajectory)

    def frame_paths(self) -> tuple[list, list]:
        """Absolute (colour, depth) file paths, for :class:`PrefetchingDataset`."""
        return (
            [os.path.join(self.base_dir, f) for f in self.rgb_images],
            [os.path.join(self.base_dir, f) for f in self.depth_images],
        )

    def __len__(self) -> int:
        return len(self.rgb_images)

    def get(self, index: int) -> RgbdFrame:
        rgb = load_rgb(os.path.join(self.base_dir, self.rgb_images[index]))
        depth = load_depth_u16(os.path.join(self.base_dir, self.depth_images[index]))
        cam, pose = self.camera(index)
        return RgbdFrame(camera=cam, image=RgbdImage(rgb, depth, _DEPTH_SCALE), camera_to_world=pose)

    def get_meta(self, index: int):
        """(camera, pose, depth scale) of a frame, without decoding it."""
        cam, pose = self.camera(index)
        return cam, pose, _DEPTH_SCALE

    def trajectory(self) -> Trajectory:
        return self._trajectory

    def camera(self, index: int):
        return _FR_INTRINSICS, self._trajectory.camera_to_world[index]
