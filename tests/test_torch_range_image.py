"""Frame preprocessing of the PyTorch port against the JAX package: the
3-level pyramid of sample1 frame 0 (``build_pyramid_impl``), level by level.

Where the two differ, and why:

* ``py_scale_down`` sums its horizontal blur taps in another order than the
  JAX package's banded matmul, so a blurred colour that lands within an ulp
  of an integer can truncate one lower or higher: colours and intensities of
  levels 1-2 may differ by 1 at a small stated share of pixels, and the
  intensity map by 1/255 there.
* Normals are bitwise equal at every level. They were not while the port
  took the magnitude's root with PyTorch's float32 ``sqrt``, which on the
  CPU misrounds about 0.6% of inputs by 1 ulp: level-0 normals then
  differed in the last bit (1.2e-7) and the coarse levels' nearest-to-mean
  pick flipped on those near-ties at 0.05% / 0.08% of pixels. The root is
  now taken in float64 and rounded once, which is what XLA's float32 root
  gives.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from align3d_tpu.range_image import RangeImage as JaxRangeImage
from align3d_tpu.range_image import build_pyramid_impl as jax_build

from align3d_torch.camera import CameraIntrinsics
from align3d_torch.image import rgb_to_luma_u8
from align3d_torch.ops.intensity import build_intensity_map
from align3d_torch.range_image import RangeImage, build_pyramid_impl

# Share of pixels whose intensity may differ by 1, per level (measured 0 /
# 1.3e-5 / 5.2e-5).
INTENSITY_SHARE = 1e-4


@pytest.fixture(scope="module")
def pyramids(sample1_dataset):
    frame = sample1_dataset.get(0)
    ref = jax_build(
        True, True, 3, 1.0, frame.camera, 0.001, jnp.asarray(frame.image.color), jnp.asarray(frame.image.depth)
    )
    ours = build_pyramid_impl(
        True, True, 3, 1.0, CameraIntrinsics(**dataclasses.asdict(frame.camera)), 0.001,
        torch.from_numpy(frame.image.color), torch.from_numpy(frame.image.depth.astype(np.int32)),
    )
    return ref, ours


@pytest.mark.parametrize("level", [0, 1, 2])
def test_pyramid_level_matches_jax(pyramids, level):
    ref, ours = pyramids[0][level], pyramids[1][level]
    assert dataclasses.asdict(ours.intrinsics) == dataclasses.asdict(ref.intrinsics)
    # Points: atol 1e-6 (measured bitwise at every level).
    np.testing.assert_allclose(ours.points.numpy(), np.asarray(ref.points), atol=1e-6)
    np.testing.assert_array_equal(ours.mask.numpy(), np.asarray(ref.mask))

    d_int = np.abs(ours.intensities.numpy().astype(int) - np.asarray(ref.intensities).astype(int))
    assert d_int.max() <= 1
    assert (d_int > 0).mean() <= INTENSITY_SHARE
    if level == 0:
        np.testing.assert_array_equal(ours.intensities.numpy(), np.asarray(ref.intensities))
        np.testing.assert_array_equal(ours.colors.numpy(), np.asarray(ref.colors))

    # Intensity map: atol 1e-6 (measured bitwise at level 0) except 1/255
    # where an intensity differs by 1.
    d_map = np.abs(ours.intensity_map.numpy() - np.asarray(ref.intensity_map))
    assert d_map.max() <= 1.0 / 255.0 + 1e-6
    assert (d_map > 1e-6).mean() <= INTENSITY_SHARE

    # Normals: bitwise at every level (the float64 root, ops/normals.py).
    np.testing.assert_array_equal(ours.normals.numpy(), np.asarray(ref.normals))


@pytest.mark.parametrize("level", [0, 1])
def test_scale_down_bitwise_on_identical_input(pyramids, level):
    """The JAX level fed to the port's scale_down gives the JAX next level's
    points, mask and normals bitwise (strided slices pick exactly what the
    0/1 selection matmuls pick)."""
    src, nxt = pyramids[0][level], pyramids[0][level + 1]
    ours = RangeImage(
        points=torch.from_numpy(np.array(src.points)),
        mask=torch.from_numpy(np.array(src.mask)),
        intrinsics=CameraIntrinsics(**dataclasses.asdict(src.intrinsics)),
        normals=torch.from_numpy(np.array(src.normals)),
        colors=torch.from_numpy(np.array(src.colors)),
    ).scale_down(1.0)
    np.testing.assert_array_equal(ours.points.numpy(), np.asarray(nxt.points))
    np.testing.assert_array_equal(ours.mask.numpy(), np.asarray(nxt.mask))
    np.testing.assert_array_equal(ours.normals.numpy(), np.asarray(nxt.normals))
    d_col = np.abs(ours.colors.numpy().astype(int) - np.asarray(nxt.colors).astype(int))
    assert d_col.max() <= 1 and (d_col > 0).mean() <= INTENSITY_SHARE


def test_luma_and_intensity_map_bitwise():
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, size=(30, 40, 3), dtype=np.uint8)
    jri = JaxRangeImage(points=None, mask=None, intrinsics=None, colors=jnp.asarray(rgb)).with_intensity_map()
    luma = rgb_to_luma_u8(torch.from_numpy(rgb))
    np.testing.assert_array_equal(luma.numpy(), np.asarray(jri.intensities))
    np.testing.assert_array_equal(build_intensity_map(luma).numpy(), np.asarray(jri.intensity_map))


@pytest.mark.parametrize("shape", [(30, 40, 3), (31, 45, 3), (17, 22)])
def test_blur_and_scale_down_against_jax(shape):
    """gaussian_blur and py_scale_down (even and odd sizes) against the JAX
    package: float blur within atol 1e-4 on 0..255 values, the u8 scale-down
    within ±1 (both measured bitwise at these sizes; the same taps in the
    same order, but XLA may fuse them into FMAs)."""
    from align3d_tpu.image import gaussian_blur as jax_blur
    from align3d_tpu.image import py_scale_down as jax_scale_down

    from align3d_torch.image import gaussian_blur, py_scale_down

    img = np.random.default_rng(8).integers(0, 256, size=shape, dtype=np.uint8)
    np.testing.assert_allclose(
        gaussian_blur(torch.from_numpy(img), 1.0).numpy(), np.asarray(jax_blur(jnp.asarray(img), 1.0)), atol=1e-4
    )
    if len(shape) == 3:
        ours = py_scale_down(torch.from_numpy(img), 1.0).numpy().astype(int)
        ref = np.asarray(jax_scale_down(jnp.asarray(img), 1.0)).astype(int)
        assert ours.shape == ref.shape
        assert np.abs(ours - ref).max() <= 1
