"""Carry state over from the JAX package, handed over as numpy arrays and
plain dicts, into the port's types (the parity tests use it to feed the same
pyramids and parameters to both packages)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from align3d_torch.camera import CameraIntrinsics
from align3d_torch.icp.params import IcpParams, MsIcpParams
from align3d_torch.range_image import RangeImage
from align3d_torch.se3 import Transform


def _tensor(array, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(array, dtype=dtype, order="C")).to(device)


def transform_from_numpy(rot, trans, device="cpu") -> Transform:
    """(…, 3, 3) rotation and (…, 3) translation -> Transform."""
    return Transform(_tensor(rot, np.float32, device), _tensor(trans, np.float32, device))


def range_image_from_numpy(
    points, mask, normals, colors, intensities, intensity_map, intrinsics_dict: dict, device="cpu"
) -> RangeImage:
    """Arrays of a JAX ``RangeImage`` + ``dataclasses.asdict(intrinsics)``.
    ``normals``, ``colors``, ``intensities`` and ``intensity_map`` may be None."""

    def opt(array, dtype):
        return None if array is None else _tensor(array, dtype, device)

    return RangeImage(
        points=_tensor(points, np.float32, device),
        mask=_tensor(mask, np.bool_, device),
        intrinsics=CameraIntrinsics(**intrinsics_dict),
        normals=opt(normals, np.float32),
        colors=opt(colors, np.uint8),
        intensities=opt(intensities, np.uint8),
        intensity_map=opt(intensity_map, np.float32),
    )


def icp_params_from_dict(params: dict) -> IcpParams:
    """``dataclasses.asdict(jax_params)`` -> IcpParams. Keys the port has no
    field for (the TPU engines' ``band_radius``) are dropped: they select
    nothing on the port."""
    names = {f.name for f in dataclasses.fields(IcpParams)}
    return IcpParams(**{k: v for k, v in params.items() if k in names})


def ms_icp_params_from_dicts(levels: list[dict]) -> MsIcpParams:
    """``[dataclasses.asdict(p) for p in jax_ms_params]`` -> MsIcpParams."""
    return MsIcpParams(tuple(icp_params_from_dict(d) for d in levels))
