"""IndoorLidar (Redwood) dataset loader (port of
``align3d_tpu/io/datasets/indoor_lidar.py``; reference
``src/io/dataset/indoor_lidar.rs``).

``image/*.jpg``, ``depth/*.png`` and a ``<name>.log`` of 5-line pose
blocks (a header line, then a 4x4 matrix); depth scale 0.001, the
hardcoded Freiburg-style intrinsics. JPEG decodes through the native
library's libjpeg, or Pillow where it imports.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from align3d_torch.camera import CameraIntrinsics
from align3d_torch.image import RgbdFrame, RgbdImage
from align3d_torch.io.datasets.core import DatasetError, load_depth_u16, load_rgb
from align3d_torch.se3 import Transform
from align3d_torch.trajectory import Trajectory

_INTRINSICS = CameraIntrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)
_DEPTH_SCALE = 0.001


class IndoorLidarDataset:
    def __init__(self, rgb_images, depth_images, trajectory):
        self.rgb_images = rgb_images
        self.depth_images = depth_images
        self._trajectory = trajectory

    @classmethod
    def load(cls, base_dir: str) -> "IndoorLidarDataset":
        rgb_images = sorted(glob.glob(os.path.join(base_dir, "image", "*.jpg")))
        depth_images = sorted(glob.glob(os.path.join(base_dir, "depth", "*.png")))
        if len(rgb_images) != len(depth_images):
            raise DatasetError("Number of RGB and depth images do not match")

        log_name = os.path.basename(os.path.normpath(base_dir))
        try:
            with open(os.path.join(base_dir, f"{log_name}.log")) as f:
                lines = [ln.strip() for ln in f if ln.strip()]
        except OSError as e:
            raise DatasetError(str(e)) from e

        poses = []
        for block_start in range(0, len(lines) - 4, 5):
            mat = np.zeros((4, 4), np.float32)
            for i in range(4):
                mat[i] = [float(t) for t in lines[block_start + 1 + i].split()]
            poses.append(Transform.from_matrix4(mat))
        trajectory = Trajectory.from_list(poses, np.arange(len(poses), dtype=np.float32))
        return cls(rgb_images, depth_images, trajectory)

    def __len__(self) -> int:
        return len(self.rgb_images)

    def frame_paths(self) -> tuple[list, list]:
        """Absolute (colour, depth) file paths, for :class:`PrefetchingDataset`."""
        return list(self.rgb_images), list(self.depth_images)

    def get(self, index: int) -> RgbdFrame:
        rgb = load_rgb(self.rgb_images[index])
        depth = load_depth_u16(self.depth_images[index])
        cam, pose = self.camera(index)
        return RgbdFrame(camera=cam, image=RgbdImage(rgb, depth, _DEPTH_SCALE), camera_to_world=pose)

    def get_meta(self, index: int):
        """(camera, pose, depth scale) of a frame, without decoding it."""
        cam, pose = self.camera(index)
        return cam, pose, _DEPTH_SCALE

    def trajectory(self) -> Trajectory:
        return self._trajectory

    def camera(self, index: int):
        return _INTRINSICS, self._trajectory.camera_to_world[index]
