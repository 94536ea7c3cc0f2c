"""align3d_torch — the PyTorch/CUDA port of :mod:`align3d_tpu`.

The module tree mirrors ``align3d_tpu/`` (every module's counterpart sits at
the same relative path) and the JAX package stays the reference the port is
tested against. Plain tensor code is PyTorch; the data-dependent hot stages
of the odometry main path, the banded NN search of point-cloud ICP and the
mesh vertex normals are CUDA C++ kernels written for Hopper (``csrc/``),
each with a plain-PyTorch twin that runs on the CPU.

Conventions:

* functions take tensors and an explicit ``device`` where they create data;
  containers (``Transform``, ``RangeImage``, ``GNSystem``) are dataclasses
  of tensors;
* depth images are int32 tensors holding the u16 sensor values (PyTorch's
  uint16 has too few operators);
* float32 everywhere except the 6x6 Gauss-Newton solve, which runs in
  float64 as the reference does. TF32 is switched off here, once, so a
  float32 matmul or convolution on the card stays full float32 — the port's
  counterpart of the f32-exact policy of ``align3d_tpu/config.py``.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from align3d_torch.se3 import Transform  # noqa: E402
from align3d_torch.camera import CameraIntrinsics  # noqa: E402
from align3d_torch.pointcloud import PointCloud  # noqa: E402
from align3d_torch.range_image import RangeImage, RangeImageBuilder  # noqa: E402
from align3d_torch.trajectory import Trajectory, TrajectoryBuilder  # noqa: E402
from align3d_torch.metrics import TransformMetrics  # noqa: E402
from align3d_torch.icp.params import IcpParams, MsIcpParams  # noqa: E402
from align3d_torch.icp.image_icp import ImageIcp  # noqa: E402
from align3d_torch.icp.multiscale import MultiscaleAlign  # noqa: E402
from align3d_torch.icp.pcl_icp import Icp  # noqa: E402
from align3d_torch.live import LiveOdometry  # noqa: E402

__all__ = [
    "Transform",
    "CameraIntrinsics",
    "PointCloud",
    "RangeImage",
    "RangeImageBuilder",
    "Trajectory",
    "TrajectoryBuilder",
    "TransformMetrics",
    "IcpParams",
    "MsIcpParams",
    "ImageIcp",
    "MultiscaleAlign",
    "Icp",
    "LiveOdometry",
]
