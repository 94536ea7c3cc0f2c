"""Coarse-to-fine multiscale ICP (port of ``align3d_tpu/icp/multiscale.py``)."""

from __future__ import annotations

from align3d_torch.icp.image_icp import ImageIcp
from align3d_torch.icp.params import MsIcpParams
from align3d_torch.range_image import RangeImage
from align3d_torch.se3 import Transform


class MultiscaleAlign:
    def __init__(self, params: MsIcpParams, target_pyramid: list[RangeImage]):
        if len(params) != len(target_pyramid):
            raise ValueError("The number of range images pyramid levels and ICP parameters must be equal.")
        self.params = params
        self.target_pyramid = target_pyramid
        self.last_residual: float | None = None  # finest level's best residual

    def align(self, source_pyramid: list[RangeImage], initial_transform: Transform | None = None) -> Transform:
        """Iterate levels coarse -> fine (multiscale.rs:51-63); each level's
        result seeds the next."""
        optim_transform = (
            initial_transform
            if initial_transform is not None
            else Transform.identity(device=self.target_pyramid[0].device)
        )
        for params, target, source in reversed(list(zip(self.params, self.target_pyramid, source_pyramid))):
            icp = ImageIcp(params, target)
            icp.initial_transform = optim_transform
            optim_transform = icp.align(source)
            self.last_residual = icp.last_residual
        return optim_transform
