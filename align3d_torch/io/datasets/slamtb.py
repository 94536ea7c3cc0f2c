"""SlamTb ``frames.json`` dataset loader (port of ``align3d_tpu/io/datasets/slamtb.py``;
reference ``src/io/dataset/slamtb.rs``): per-frame K matrix, depth scale and
4x4 camera-to-world pose. Frames decode with :mod:`align3d_torch.io.png`."""

from __future__ import annotations

import json
import os

import numpy as np

from align3d_torch.camera import CameraIntrinsics
from align3d_torch.image import RgbdFrame, RgbdImage
from align3d_torch.io import png
from align3d_torch.io.datasets.core import DatasetError
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

    def __len__(self) -> int:
        return min(len(self.rgb_images), len(self.depth_images))

    def get(self, index: int) -> RgbdFrame:
        rgb = png.read(os.path.join(self.base_dir, self.rgb_images[index]))
        depth = png.read(os.path.join(self.base_dir, self.depth_images[index]))
        if rgb.ndim != 3 or depth.ndim != 2:
            raise DatasetError(f"frame {index}: expected an RGB colour and a 16-bit depth PNG")
        return RgbdFrame(
            camera=self.cameras[index],
            image=RgbdImage(rgb, depth, self.depth_scales[index]),
            camera_to_world=self.poses[index],
        )

    def trajectory(self) -> Trajectory:
        return Trajectory.from_list(self.poses, np.arange(len(self.poses), dtype=np.float32))
