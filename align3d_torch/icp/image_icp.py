"""Projective RGB-D ICP, point-to-plane + photometric (port of ``align3d_tpu/icp/image_icp.py``).

:func:`icp_step`, the plain GN accumulation over all source pixels, lives
beside its fused CUDA kernel in :mod:`align3d_torch.ops.icp_fused` and is
re-exported here. :func:`align_impl_batched` runs the GN loop of B frame
pairs at once: per iteration one fused step over all B pairs (one launch of
K1 on the card), then the batched float64 6x6 solve, the SE(3) update and
the best-residual select, all on the device, with no wait for it.
:func:`align_impl` is its batch of one, and :func:`align_batched` its
counterpart of the JAX package's ``align_batched``. The TPU engine's band
prediction (``predict_bases_centroid_batched``) has no counterpart: K1
gathers the target at the exact projected pixel.

Reference semantics kept exactly (``src/icp/image_icp.rs``), as in the JAX
package:

* the target lookup at ``trunc(u + 0.5)`` with bounds and target-mask gates;
* the distance gate ``||q - p||^2 > max_distance^2`` rejects;
* the normal-angle gate compares the transformed source *point* with the
  target normal, ``|acos(p . n)|``, and a NaN angle passes;
* the photometric term samples at clamped coordinates, with ``0.003921569``
  for 1/255 and the re-truncated +0.005 numeric gradient;
* the returned pose is the best-mean-squared-residual one, where the
  residual is read *before* an iteration's update but paired with the
  *updated* transform, and a tie keeps the earlier pose (strict ``<``).
"""

from __future__ import annotations

import torch

from align3d_torch.camera import CameraIntrinsics
from align3d_torch.icp.params import IcpParams
from align3d_torch.ops import icp_fused
from align3d_torch.ops.icp_fused import _f32, icp_step  # noqa: F401  (icp_step is re-exported)
from align3d_torch.ops.target_pack import pack_geometry, pack_intensity_taps
from align3d_torch.optim.gauss_newton import GNSystem
from align3d_torch.range_image import RangeImage
from align3d_torch.se3 import Transform


def _gn_from_aug16(geo_aug: torch.Tensor, col_aug: torch.Tensor) -> tuple[GNSystem, GNSystem]:
    """GNSystems from the two 8x8 augmented blocks [[H, g], [g^T, sum w r^2]]
    with the count at [7, 7] (leading batch dims pass through)."""

    def system(aug):
        return GNSystem(aug[..., 0:6, 0:6], aug[..., 0:6, 6], aug[..., 6, 6], aug[..., 7, 7])

    return system(geo_aug), system(col_aug)


def prepack_batched(
    source_points: torch.Tensor,  # (B, N, 3)
    source_mask: torch.Tensor,  # (B, N)
    source_intensity: torch.Tensor,  # (B, N) u8
    target_points: torch.Tensor,  # (B, N, 3)
    target_mask: torch.Tensor,  # (B, N)
    target_normals: torch.Tensor,  # (B, N, 3)
    target_intensity_map: torch.Tensor,  # (B, H+2, W+2)
) -> tuple:
    """The pose-independent inputs of the fused step for B pairs (the
    counterpart of ``prepack_v4_batched``): the sources as K1 reads them,
    with their ``uint8`` masks, and the targets' geometry and intensity-tap
    packs. Returns ``(points, mask, intensity, geo, taps, h, w)``."""
    bsz = target_intensity_map.shape[0]
    h, w = target_intensity_map.shape[-2] - 2, target_intensity_map.shape[-1] - 2
    geo = pack_geometry(
        target_points.reshape(bsz, h, w, 3), target_normals.reshape(bsz, h, w, 3), target_mask.reshape(bsz, h, w)
    )
    return (
        source_points.reshape(bsz, h * w, 3).contiguous(),
        source_mask.reshape(bsz, h * w).to(torch.uint8),
        source_intensity.reshape(bsz, h * w).contiguous(),
        geo,
        pack_intensity_taps(target_intensity_map),
        h,
        w,
    )


def align_impl_batched(
    initial_rotation: torch.Tensor,  # (B, 3, 3)
    initial_translation: torch.Tensor,  # (B, 3)
    packed: tuple,  # from prepack_batched
    intrinsics: CameraIntrinsics,
    params: IcpParams,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GN loop of B pairs on prepacked inputs (the counterpart of
    ``align_impl_pallas_v4_batched_packed``); returns (best_R, best_t,
    best_residual), (B, 3, 3), (B, 3), (B,), on the inputs' device."""
    points, mask, intensity, geo, taps, h, w = packed
    weight, color_weight = _f32(params.weight), _f32(params.color_weight)
    rot, trans = initial_rotation, initial_translation
    best_res = torch.full(rot.shape[:1], torch.inf, dtype=torch.float32, device=rot.device)
    best_rot, best_trans = rot, trans
    for _ in range(params.max_iterations):
        aug = icp_fused.icp_step_fused(rot, trans, points, mask, intensity, geo, taps, h, w, intrinsics, params)
        geom, color = _gn_from_aug16(aug[:, 0], aug[:, 1])
        merged = geom.add_weighted(color, weight, color_weight)
        residual = merged.mean_squared_residual()
        new_transform = Transform.exp(merged.solve()) @ Transform(rot, trans)

        better = residual < best_res
        best_res = torch.where(better, residual, best_res)
        best_rot = torch.where(better[:, None, None], new_transform.rotation, best_rot)
        best_trans = torch.where(better[:, None], new_transform.translation, best_trans)
        rot, trans = new_transform.rotation, new_transform.translation
    return best_rot, best_trans, best_res


def align_impl(
    initial_rotation: torch.Tensor,
    initial_translation: torch.Tensor,
    source_points: torch.Tensor,
    source_mask: torch.Tensor,
    source_intensity: torch.Tensor,
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
    target_normals: torch.Tensor,
    target_intensity_map: torch.Tensor,
    intrinsics: CameraIntrinsics,
    params: IcpParams,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full ICP align of one pair: :func:`align_impl_batched` with B = 1."""
    packed = prepack_batched(
        source_points[None], source_mask[None], source_intensity[None],
        target_points[None], target_mask[None], target_normals[None], target_intensity_map[None],
    )
    rot, trans, res = align_impl_batched(initial_rotation[None], initial_translation[None], packed, intrinsics, params)
    return rot[0], trans[0], res[0]


def align_batched(
    initial: Transform,  # (B,)
    source_points: torch.Tensor,  # (B, N, 3)
    source_mask: torch.Tensor,
    source_intensity: torch.Tensor,
    target_points: torch.Tensor,  # (B, N, 3)
    target_mask: torch.Tensor,
    target_normals: torch.Tensor,
    target_intensity_map: torch.Tensor,  # (B, H+2, W+2)
    intrinsics: CameraIntrinsics,
    params: IcpParams,
) -> tuple[Transform, torch.Tensor]:
    """Align B frame pairs at once (the throughput configuration); returns
    the best poses (B,) and their mean squared residuals (B,)."""
    packed = prepack_batched(
        source_points, source_mask, source_intensity, target_points, target_mask, target_normals, target_intensity_map
    )
    rot, trans, res = align_impl_batched(initial.rotation, initial.translation, packed, intrinsics, params)
    return Transform(rot, trans), res


class ImageIcp:
    """Aligns a source RangeImage onto a target (reference image_icp.rs:19-43)."""

    def __init__(self, params: IcpParams, target: RangeImage):
        if target.intensity_map is None:
            raise ValueError("the target image should have an intensity map")
        if target.normals is None:
            raise ValueError("the target image should have normals")
        self.params = params
        self.target = target
        self.initial_transform = Transform.identity(device=target.device)
        self.last_residual: float | None = None  # best mean-squared residual

    def align(self, source: RangeImage) -> Transform:
        if source.intensities is None:
            raise ValueError("the source image should have intensity colors")
        t = self.target
        n = t.height * t.width
        best_rot, best_trans, best_res = align_impl(
            self.initial_transform.rotation,
            self.initial_transform.translation,
            source.points.reshape(-1, 3),
            source.mask.reshape(-1),
            source.intensities.reshape(-1),
            t.points.reshape(n, 3),
            t.mask.reshape(n),
            t.normals.reshape(n, 3),
            t.intensity_map,
            t.intrinsics,
            self.params,
        )
        self.last_residual = float(best_res)  # the one host sync per level
        return Transform(best_rot, best_trans)
