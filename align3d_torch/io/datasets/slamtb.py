"""SlamTb ``frames.json`` dataset loader (port of ``align3d_tpu/io/datasets/slamtb.py``;
reference ``src/io/dataset/slamtb.rs``): per-frame K matrix, depth scale and
4x4 camera-to-world pose. This is the format of the repository's fixtures
(``tests/data/rgbd/sample1|2``)."""

from __future__ import annotations

import json
import os

import numpy as np

from align3d_torch.camera import CameraIntrinsics
from align3d_torch.image import RgbdFrame, RgbdImage
from align3d_torch.io.datasets.core import DatasetError, load_depth_u16, load_rgb
from align3d_torch.se3 import Transform
from align3d_torch.trajectory import Trajectory


class SlamTbDataset:
    def __init__(self, base_dir, cameras, poses, rgb_images, depth_images, depth_scales):
        self.base_dir = base_dir
        self.cameras = cameras
        self.poses = poses  # list[Transform], CPU tensors
        self.rgb_images = rgb_images
        self.depth_images = depth_images
        self.depth_scales = depth_scales

    @classmethod
    def load(cls, base_dir: str) -> "SlamTbDataset":
        path = os.path.join(base_dir, "frames.json")
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise DatasetError(str(e)) from e

        cameras, poses, rgbs, depths, scales = [], [], [], [], []
        for frame in doc["root"]:
            info = frame["info"]
            k = info["kcam"]["matrix"]
            w, h = info["kcam"]["image_size"]
            cameras.append(CameraIntrinsics(fx=k[0][0], fy=k[1][1], cx=k[0][2], cy=k[1][2], width=w, height=h))
            rt = np.asarray(info["rt_cam"]["matrix"], np.float32)
            poses.append(Transform.from_matrix4(rt) if rt.shape == (4, 4) else Transform.identity())
            rgbs.append(frame["rgb_image"])
            depths.append(frame["depth_image"])
            scales.append(float(info["depth_scale"]))
        return cls(base_dir, cameras, poses, rgbs, depths, scales)

    def frame_paths(self) -> tuple[list, list]:
        """Absolute (colour, depth) file paths, for :class:`PrefetchingDataset`."""
        return (
            [os.path.join(self.base_dir, f) for f in self.rgb_images],
            [os.path.join(self.base_dir, f) for f in self.depth_images],
        )

    def __len__(self) -> int:
        return min(len(self.rgb_images), len(self.depth_images))

    def get(self, index: int) -> RgbdFrame:
        rgb = load_rgb(os.path.join(self.base_dir, self.rgb_images[index]))
        depth = load_depth_u16(os.path.join(self.base_dir, self.depth_images[index]))
        return RgbdFrame(
            camera=self.cameras[index],
            image=RgbdImage(rgb, depth, self.depth_scales[index]),
            camera_to_world=self.poses[index],
        )

    def get_meta(self, index: int):
        """(camera, pose, depth scale) of a frame, without decoding it."""
        return self.cameras[index], self.poses[index], self.depth_scales[index]

    def trajectory(self) -> Trajectory:
        return Trajectory.from_list(self.poses, np.arange(len(self.poses), dtype=np.float32))

    def camera(self, index: int):
        return self.cameras[index], self.poses[index]
