"""Range images: backprojected RGB-D frames on a grid (port of ``align3d_tpu/range_image.py``).

:class:`RangeImageBuilder` runs the per-frame pipeline of the reference
(``src/range_image/builder.rs:74-91`` order): optional bilateral depth
filter -> backprojection -> normals at full resolution -> pyramid (points
and normals downsampled together, colours blurred) -> per-level intensity
and intensity map.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from align3d_torch.camera import CameraIntrinsics
from align3d_torch.image import RgbdFrame, py_scale_down, rgb_to_luma_u8
from align3d_torch.ops import normals as normals_ops
from align3d_torch.ops import resize as resize_ops
from align3d_torch.ops.intensity import build_intensity_map


@dataclasses.dataclass
class RangeImage:
    """Grid-structured point cloud; all tensors are (..., H, W, ...) on one
    device, with the same leading batch axes (none for one frame)."""

    points: torch.Tensor  # (..., H, W, 3) f32, camera frame
    mask: torch.Tensor  # (..., H, W) bool
    intrinsics: CameraIntrinsics
    normals: Optional[torch.Tensor] = None  # (..., H, W, 3) f32
    colors: Optional[torch.Tensor] = None  # (..., H, W, 3) u8
    intensities: Optional[torch.Tensor] = None  # (..., H, W) u8
    intensity_map: Optional[torch.Tensor] = None  # (..., H+2, W+2) f32

    @property
    def height(self) -> int:
        return self.points.shape[-3]

    @property
    def width(self) -> int:
        return self.points.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.points.device

    @classmethod
    def from_rgbd(
        cls,
        intrinsics: CameraIntrinsics,
        color: torch.Tensor,
        depth: torch.Tensor,
        depth_scale: float | torch.Tensor,
    ) -> "RangeImage":
        """Backproject int depth images; zero depth marks invalid pixels,
        whose points stay (0, 0, 0). ``depth_scale`` is a float or a tensor
        of the images' leading shape (one scale per frame)."""
        mask = depth > 0
        if isinstance(depth_scale, torch.Tensor):
            depth_scale = depth_scale.to(device=depth.device, dtype=torch.float32)[..., None, None]
        z = depth.to(torch.float32) * depth_scale
        points = intrinsics.backproject_grid(z)
        points = torch.where(mask[..., None], points, 0.0)
        return cls(points=points, mask=mask, intrinsics=intrinsics, colors=color)

    def with_normals(self) -> "RangeImage":
        return dataclasses.replace(self, normals=normals_ops.compute_normals(self.points, self.mask))

    def with_intensity(self) -> "RangeImage":
        return dataclasses.replace(self, intensities=rgb_to_luma_u8(self.colors))

    def with_intensity_map(self) -> "RangeImage":
        ri = self if self.intensities is not None else self.with_intensity()
        return dataclasses.replace(ri, intensity_map=build_intensity_map(ri.intensities))

    def scale_down(self, sigma: float) -> "RangeImage":
        """Half-resolution level: points/normals by masked nearest-to-mean,
        colours by blur + stride 2, intrinsics scaled by 0.5."""
        dst_h, dst_w = self.height // 2, self.width // 2
        points, mask = resize_ops.resize_nearest_to_mean(self.points, self.mask, dst_h, dst_w)
        normals = None
        if self.normals is not None:
            normals, _ = resize_ops.resize_nearest_to_mean(self.normals, self.mask, dst_h, dst_w)
        colors = py_scale_down(self.colors, sigma) if self.colors is not None else None
        return RangeImage(
            points=points,
            mask=mask,
            intrinsics=self.intrinsics.scale(0.5),
            normals=normals,
            colors=colors,
        )

    def pyramid(self, levels: int, sigma: float) -> list["RangeImage"]:
        """Fine-to-coarse pyramid."""
        out = [self]
        for _ in range(levels - 1):
            out.append(out[-1].scale_down(sigma))
        return out

    def frames(self, index) -> "RangeImage":
        """The frames ``index`` (an int, a slice or an index tensor) of a
        batched RangeImage."""
        fields = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        return RangeImage(**{k: v if k == "intrinsics" or v is None else v[index] for k, v in fields.items()})


@dataclasses.dataclass(frozen=True)
class RangeImageBuilder:
    """Frame-processing pipeline config (reference src/range_image/builder.rs)."""

    with_normals: bool = True
    with_intensity: bool = True
    bilateral_filter: Optional[Any] = None  # ops.bilateral.BilateralFilter
    pyramid_levels: int = 3
    blur_sigma: float = 1.0

    def build(self, frame: RgbdFrame, device) -> list[RangeImage]:
        """Upload one frame to ``device`` and build its pyramid there."""
        depth = torch.from_numpy(frame.image.depth.astype("int32")).to(device)
        if self.bilateral_filter is not None:
            depth = self.bilateral_filter.filter(depth)
        return build_pyramid_impl(
            self.with_normals,
            self.with_intensity,
            self.pyramid_levels,
            self.blur_sigma,
            frame.camera,
            float(frame.image.depth_scale),
            torch.from_numpy(frame.image.color).to(device),
            depth,
        )


def build_pyramid_impl(
    with_normals: bool,
    with_intensity: bool,
    pyramid_levels: int,
    blur_sigma: float,
    intrinsics: CameraIntrinsics,
    depth_scale: float | torch.Tensor,
    color: torch.Tensor,
    depth: torch.Tensor,
) -> list[RangeImage]:
    """Pyramid construction in the order of ``builder.rs:74-91``. ``color``
    (..., H, W, 3) and ``depth`` (..., H, W) may carry leading frame axes;
    every level then carries them too (the JAX package's ``vmap``)."""
    first = RangeImage.from_rgbd(intrinsics, color, depth, depth_scale)
    if with_normals:
        first = first.with_normals()
    levels = first.pyramid(pyramid_levels, blur_sigma)
    if with_intensity:
        levels = [ri.with_intensity().with_intensity_map() for ri in levels]
    return levels


def range_image_to_pointcloud(ri: RangeImage) -> dict:
    """Flatten a RangeImage into padded point-cloud arrays + mask.

    The reference filters to valid points (structure.rs:375-405); the static
    shape is kept and the mask returned alongside.
    """
    n = ri.height * ri.width
    out = {"points": ri.points.reshape(n, 3), "mask": ri.mask.reshape(n)}
    if ri.normals is not None:
        out["normals"] = ri.normals.reshape(n, 3)
    if ri.colors is not None:
        out["colors"] = ri.colors.reshape(n, 3)
    return out
