"""RGB-D and point-cloud ICP (port of ``align3d_tpu/icp``)."""

from align3d_torch.icp.params import IcpParams, MsIcpParams
from align3d_torch.icp.image_icp import ImageIcp
from align3d_torch.icp.multiscale import MultiscaleAlign
from align3d_torch.icp.pcl_icp import Icp

__all__ = ["IcpParams", "MsIcpParams", "ImageIcp", "MultiscaleAlign", "Icp"]
