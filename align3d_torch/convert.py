"""Carry state over from the JAX package, handed over as numpy arrays and
plain dicts, into the port's types (the parity tests use it to feed the same
pyramids, grids and parameters to both packages). Tensors go to ``device``,
the card unless the caller passes ``device="cpu"``."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from align3d_torch.camera import CameraIntrinsics
from align3d_torch.icp.params import IcpParams, MsIcpParams
from align3d_torch.io.geometry import Geometry
from align3d_torch.ops.nn_banded import SortedGrid
from align3d_torch.ops.voxel_hash import VoxelHashGrid
from align3d_torch.parallel.bundle_adjustment import BAProblem
from align3d_torch.parallel.pose_graph import PoseGraph
from align3d_torch.range_image import RangeImage
from align3d_torch.se3 import Transform


def _tensor(array, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(array, dtype=dtype, order="C")).to(device)


def transform_from_numpy(rot, trans, device="cuda") -> Transform:
    """(…, 3, 3) rotation and (…, 3) translation -> Transform."""
    return Transform(_tensor(rot, np.float32, device), _tensor(trans, np.float32, device))


def pose_graph_from_numpy(rot, trans, edges, meas_rot, meas_trans, weights, device="cuda") -> PoseGraph:
    """The arrays of a JAX ``pose_graph.PoseGraph``: node rotations and
    translations, (E, 2) edges, the measurements' rotations and
    translations, (E,) weights."""
    return PoseGraph(
        nodes=transform_from_numpy(rot, trans, device),
        edges=_tensor(edges, np.int64, device),
        measurements=transform_from_numpy(meas_rot, meas_trans, device),
        weights=_tensor(weights, np.float32, device),
    )


def ba_problem_from_numpy(
    rot, trans, landmarks, obs_pose, obs_landmark, obs_uv, weights, intrinsics: dict, obs_z=None,
    depth_weight: float = 100.0, device="cuda",
) -> BAProblem:
    """The arrays of a JAX ``bundle_adjustment.BAProblem`` +
    ``dataclasses.asdict(intrinsics)``; ``obs_z`` may be None."""
    return BAProblem(
        poses=transform_from_numpy(rot, trans, device),
        landmarks=_tensor(landmarks, np.float32, device),
        obs_pose=_tensor(obs_pose, np.int64, device),
        obs_landmark=_tensor(obs_landmark, np.int64, device),
        obs_uv=_tensor(obs_uv, np.float32, device),
        weights=_tensor(weights, np.float32, device),
        intrinsics=CameraIntrinsics(**intrinsics),
        obs_z=None if obs_z is None else _tensor(obs_z, np.float32, device),
        depth_weight=float(depth_weight),
    )


def range_image_from_numpy(
    points, mask, normals, colors, intensities, intensity_map, intrinsics_dict: dict, device="cuda"
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


def sorted_grid_from_numpy(planes, orig_idx, starts, cell_size, origin, dims, n, device="cuda") -> SortedGrid:
    """The arrays and static fields of a JAX ``nn_banded.SortedGrid``."""
    return SortedGrid(
        planes=_tensor(planes, np.float32, device),
        orig_idx=_tensor(orig_idx, np.int32, device),
        starts=_tensor(starts, np.int32, device),
        cell_size=float(cell_size),
        origin=tuple(int(v) for v in origin),
        dims=tuple(int(v) for v in dims),
        n=int(n),
    )


def voxel_hash_grid_from_numpy(sorted_hash, sorted_points, sorted_indices, cell_size, device="cuda") -> VoxelHashGrid:
    """The arrays and cell size of a JAX ``voxel_hash.VoxelHashGrid``."""
    return VoxelHashGrid(
        sorted_hash=_tensor(sorted_hash, np.int32, device),
        sorted_points=_tensor(sorted_points, np.float32, device),
        sorted_indices=_tensor(sorted_indices, np.int32, device),
        cell_size=float(cell_size),
    )


def geometry_from_numpy(points, normals=None, colors=None, faces=None, texcoords=None) -> Geometry:
    """The arrays of a JAX ``io.Geometry`` (host arrays on both sides)."""

    def opt(array, dtype):
        return None if array is None else np.array(array, dtype=dtype)

    return Geometry(
        points=np.array(points, dtype=np.float32),
        normals=opt(normals, np.float32),
        colors=opt(colors, np.uint8),
        faces=opt(faces, np.int64),
        texcoords=opt(texcoords, np.float32),
    )
