"""Public names of modules already ported, against the JAX package's
functions on the same inputs (made with numpy from a seed): extra_math,
camera, se3, trajectory, metrics, image, the bilateral filter's
``scale_down`` and grid views, the intensity samplers and range images.
Each test states its tolerance."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_tpu import camera as jcam
from align3d_tpu import extra_math as jmath
from align3d_tpu import image as jimage
from align3d_tpu import trajectory as jtraj
from align3d_tpu.metrics import TransformMetrics as JaxMetrics
from align3d_tpu.ops import bilateral as jbil
from align3d_tpu.ops import intensity as jint
from align3d_tpu.range_image import RangeImage as JaxRangeImage
from align3d_tpu.se3 import Transform as JaxTransform

from align3d_torch import camera, extra_math, image, trajectory
from align3d_torch.convert import transform_from_numpy
from align3d_torch.metrics import TransformMetrics
from align3d_torch.ops import bilateral, intensity
from align3d_torch.range_image import RangeImage
from align3d_torch.se3 import Transform

FIELDS = dict(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)


def _t(x):
    return torch.from_numpy(np.array(x))


def _ours(jt: JaxTransform) -> Transform:
    return transform_from_numpy(np.asarray(jt.rotation), np.asarray(jt.translation), device="cpu")


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    return JaxTransform.exp(jnp.asarray((rng.normal(size=(n, 6)) * 0.2).astype(np.float32)))


def test_angle_between_normals_against_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(50, 3)).astype(np.float32)
    b = rng.normal(size=(50, 3)).astype(np.float32)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    # Row 0: a dot of 1.0000001 (scaled unit vectors) is out of range: NaN
    # in both, as the unclamped reference gives.
    a[0], b[0] = [1.0000001, 0.0, 0.0], [1.0, 0.0, 0.0]
    ours = extra_math.angle_between_normals(_t(a), _t(b)).numpy()
    ref = np.asarray(jmath.angle_between_normals(jnp.asarray(a), jnp.asarray(b)))
    assert np.isnan(ours[0]) and np.isnan(ref[0])
    # NaN at the same rows; elsewhere within 1e-6 rad (measured 2.4e-7: the
    # float32 arccos of PyTorch and of XLA round differently).
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_camera_projection_against_jax():
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.uniform(-1, 1, (64, 2)), rng.uniform(0.5, 3, (64, 1))], axis=1).astype(np.float32)
    ours, ref = camera.CameraIntrinsics(**FIELDS), jcam.CameraIntrinsics(**FIELDS)
    # project, project_grad and backproject: the same f32 expressions, bitwise.
    for got, want in zip(ours.project(_t(pts)), ref.project(jnp.asarray(pts))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(ours.project_grad(_t(pts)), ref.project_grad(jnp.asarray(pts))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    u, v = ref.project(jnp.asarray(pts))
    back = ours.backproject(_t(u), _t(v), _t(pts[:, 2]))
    np.testing.assert_array_equal(back.numpy(), np.asarray(ref.backproject(u, v, jnp.asarray(pts[:, 2]))))
    # The reference's round trip, atol 1e-5 (tests/test_camera.py).
    np.testing.assert_allclose(back.numpy(), pts, atol=1e-5)
    assert dataclasses.asdict(ours.with_size(320, 240)) == dataclasses.asdict(ref.with_size(320, 240))


def test_pinhole_camera_against_jax():
    rng = np.random.default_rng(3)
    pose = JaxTransform.exp(jnp.asarray([0.05, -0.02, 0.1, 0.02, -0.03, 0.01], jnp.float32))
    pts = np.concatenate([rng.uniform(-2, 2, (200, 2)), rng.uniform(0.5, 3, (200, 1))], axis=1).astype(np.float32)
    ref = jcam.PinholeCamera(jcam.CameraIntrinsics(**FIELDS), pose)
    ours = camera.PinholeCamera(camera.CameraIntrinsics(**FIELDS), _ours(pose))
    # world_to_camera and the projections within 1e-5 (pixels, metres): a
    # matrix product may sum in another order.
    np.testing.assert_allclose(ours.world_to_camera.rotation.numpy(), np.asarray(ref.world_to_camera.rotation),
                               atol=1e-7)
    for got, want in zip(ours.project(_t(pts)), ref.project(jnp.asarray(pts))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    u, v, z, vis = ours.project_to_image(_t(pts))
    ju, jv, jz, jvis = ref.project_to_image(jnp.asarray(pts))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    assert 0 < int(vis.sum()) < len(pts)  # both sides of the image's edge
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    # The reference's golden values (tests/test_camera.py).
    unit = camera.PinholeCamera(camera.CameraIntrinsics(50.0, 50.0, 0.0, 0.0, 100, 100), Transform.identity())
    u, v, _, vis = unit.project_to_image(_t(np.float32([[1.0, 1.5, 1.0], [4.0, 1.0, 1.0]])))
    assert u.tolist() == [50.0, 200.0] and v.tolist() == [75.0, 50.0] and vis.tolist() == [True, False]


def test_transform_batch_names_against_jax():
    batch = _poses(5, 4)
    pts = np.random.default_rng(5).normal(size=(5, 7, 3)).astype(np.float32)
    ours = _ours(batch)
    assert ours.batch_shape == tuple(batch.batch_shape) == (5,)
    assert Transform.identity().batch_shape == ()
    # einsum sums of three products: atol 1e-6 (tests/test_se3.py).
    np.testing.assert_allclose(ours.apply_batch(_t(pts)).numpy(), np.asarray(batch.apply_batch(jnp.asarray(pts))),
                               atol=1e-6)
    np.testing.assert_allclose(ours.apply_normals_batch(_t(pts)).numpy(),
                               np.asarray(batch.apply_normals_batch(jnp.asarray(pts))), atol=1e-6)
    np.testing.assert_allclose(ours.apply_batch(_t(pts))[3].numpy(), ours[3].apply(_t(pts[3])).numpy(), atol=1e-6)
    m4 = ours.numpy_matrix4()
    assert isinstance(m4, np.ndarray)
    np.testing.assert_array_equal(m4, batch.numpy_matrix4())  # copies of the same floats: bitwise


def test_trajectory_and_builder_against_jax():
    rel = _poses(4, 6)
    start = _poses(1, 7)[0]
    jb = jtraj.TrajectoryBuilder.with_start(start, 0.5)
    tb = trajectory.TrajectoryBuilder.with_start(_ours(start), 0.5)
    for i in range(4):
        jb.accumulate(rel[i], 1.0 + i)
        tb.accumulate(_ours(rel[i]), 1.0 + i)
    jt, tt = jb.build(), tb.build()
    # The compose is bitwise the JAX package's only up to XLA's FMA
    # contraction: atol 1e-6.
    np.testing.assert_allclose(tt.camera_to_world.rotation.numpy(), np.asarray(jt.camera_to_world.rotation), atol=1e-6)
    np.testing.assert_array_equal(tt.times.numpy(), np.asarray(jt.times))
    last, t_last = tt.last()
    assert t_last == jt.last()[1] == 4.0
    assert torch.equal(last.rotation, tt.camera_to_world.rotation[-1])
    assert torch.equal(tb.current_camera_to_world().translation, last.translation)

    # Resumed from the built trajectory, the fold goes on with the same bits.
    resumed = trajectory.TrajectoryBuilder.from_trajectory(tt.slice(0, 4))
    resumed.accumulate(_ours(rel[3]), 4.0)
    built = resumed.build()
    assert torch.equal(built.camera_to_world.rotation, tt.camera_to_world.rotation)
    assert torch.equal(built.camera_to_world.translation, tt.camera_to_world.translation)
    assert torch.equal(built.times, tt.times)

    # Without a start: the fold starts at the identity, which is not a pose.
    jb, tb = jtraj.TrajectoryBuilder(), trajectory.TrajectoryBuilder()
    assert tb.current_camera_to_world() is None and jb.current_camera_to_world() is None
    assert len(tb.build()) == len(jb.build()) == 0
    assert tb.build().last() is None and jb.build().last() is None
    assert tuple(trajectory.Trajectory.empty().camera_to_world.rotation.shape) == (0, 3, 3)
    jb.accumulate(rel[0], 1.0)
    tb.accumulate(_ours(rel[0]), 1.0)
    np.testing.assert_allclose(tb.build().camera_to_world.rotation.numpy(),
                               np.asarray(jb.build().camera_to_world.rotation), atol=1e-6)
    assert len(tb.build()) == 1


def test_metrics_total_against_jax():
    a, b = _poses(6, 8), _poses(6, 9)
    ours = TransformMetrics.new(_ours(a), _ours(b)).total().numpy()
    # The metrics' tolerance of tests/test_torch_core.py: atol 1e-6.
    np.testing.assert_allclose(ours, np.asarray(JaxMetrics.new(a, b).total()), atol=1e-6)


def test_luma_helpers_against_jax():
    rng = np.random.default_rng(10)
    rgb = rng.integers(0, 256, size=(3, 40), dtype=np.uint8).astype(np.float32)
    # Same f32 expressions: bitwise.
    np.testing.assert_array_equal(image.rgb_to_luma(*_t(rgb)).numpy(), np.asarray(jimage.rgb_to_luma(*jnp.asarray(rgb))))
    assert image.rgb_to_luma(255.0, 255.0, 255.0) == jimage.rgb_to_luma(255.0, 255.0, 255.0)
    img = rng.uniform(-3, 7, size=(30, 40)).astype(np.float32)
    np.testing.assert_array_equal(image.normalize_to_luma_u8(_t(img)).numpy(),
                                  np.asarray(jimage.normalize_to_luma_u8(jnp.asarray(img))))


@pytest.fixture(scope="module")
def frame0(sample1_dataset):
    """Sample1 frame 0 from the JAX package's loader and from the port's."""
    from align3d_torch import config
    from align3d_torch.io.datasets import SlamTbDataset

    return sample1_dataset.get(0), SlamTbDataset.load(config.ref_data_path("rgbd", "sample1")).get(0)


def test_rgbd_downsample_against_jax(frame0):
    """``RgbdFrame.downsample`` on sample1 frame 0, device cpu. The depth
    half is the bilateral filter decimated: within 1 at <= 1e-3 of pixels
    (tests/test_torch_bilateral.py::test_filter_against_jax; measured 5 of
    76,800). The colour half is ``py_scale_down``: within 1 at <= 1e-4 of
    pixels (tests/test_torch_range_image.py; measured 4 of 230,400)."""
    jframe, frame = frame0
    ours, ref = frame.downsample(1.0, "cpu"), jframe.downsample(1.0)
    assert dataclasses.asdict(ours.camera) == dataclasses.asdict(ref.camera)
    assert (ours.image.width, ours.image.height) == (ref.image.width, ref.image.height) == (320, 240)
    assert ours.image.depth.dtype == ref.image.depth.dtype == np.uint16
    assert ours.image.color.dtype == np.uint8 and ours.image.depth_scale == ref.image.depth_scale
    depth = np.abs(ours.image.depth.astype(int) - ref.image.depth.astype(int))
    assert depth.max() <= 1 and (depth > 0).mean() <= 1e-3
    color = np.abs(ours.image.color.astype(int) - ref.image.color.astype(int))
    assert color.max() <= 1 and (color > 0).mean() <= 1e-4
    pin = ours.get_pinhole_camera()
    assert pin.intrinsics == ours.camera and pin.camera_to_world is frame.camera_to_world
    assert dataclasses.replace(ours, camera_to_world=None).get_pinhole_camera() is None


def test_bilateral_scale_down_and_grid_views_against_jax():
    rng = np.random.default_rng(11)
    depth = (1000 + rng.integers(0, 500, size=(45, 61))).astype(np.uint16)
    depth[:5, :7] = 0
    filt, jfilt = bilateral.BilateralFilter(), jbil.BilateralFilter()
    ours = filt.scale_down(_t(depth.astype(np.int32))).numpy()
    ref = np.asarray(jfilt.scale_down(jnp.asarray(depth))).astype(int)
    assert ours.shape == ref.shape == (22, 30)
    # The filter's tolerance (test_filter_against_jax): within 1 at <= 1e-3
    # (measured bitwise here).
    diff = np.abs(ours - ref)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_array_equal(ours, filt.filter(_t(depth.astype(np.int32))).numpy()[0:44:2, 0:60:2])

    grid = bilateral.BilateralGrid.from_image(_t(depth.astype(np.int32)), filt.sigma_space, filt.sigma_color)
    jgrid = jbil.BilateralGrid.from_image(jnp.asarray(depth), jfilt.sigma_space, jfilt.sigma_color)
    assert grid.dim == jgrid.dim
    # The splat is bitwise the JAX package's (tests/test_torch_bilateral.py).
    np.testing.assert_array_equal(grid.data.numpy(), np.asarray(jgrid.data))
    batched = bilateral.BilateralGrid(grid.data_cm[None].expand(3, -1, -1, -1, -1), *dataclasses.astuple(grid)[1:])
    assert batched.dim == grid.dim and tuple(batched.data.shape) == (3, *grid.dim)


def test_intensity_samplers_against_jax(bloei_luma8):
    m = intensity.build_intensity_map(_t(bloei_luma8))
    jm = jint.build_intensity_map(jnp.asarray(bloei_luma8))
    h, w = bloei_luma8.shape
    rng = np.random.default_rng(12)
    u = rng.uniform(0, w - 1, 500).astype(np.float32)
    v = rng.uniform(0, h - 1, 500).astype(np.float32)
    u[:3], v[:3] = [0.0, w - 1 + 0.25, 5.0], [h - 1 + 0.25, 0.0, 7.0]  # the border cases of test_intensity_map.py
    # Same gathers and f32 expressions: bitwise.
    np.testing.assert_array_equal(intensity.bilinear(m, _t(u), _t(v)).numpy(),
                                  np.asarray(jint.bilinear(jm, jnp.asarray(u), jnp.asarray(v))))
    for got, want in zip(intensity.bilinear_grad(m, _t(u), _t(v)), jint.bilinear_grad(jm, jnp.asarray(u), jnp.asarray(v))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(intensity.bilinear(m, _t(np.float32(20.0)), _t(np.float32(33.0)))) == np.float32(
        bloei_luma8[33, 20]) / np.float32(255.0)


def test_range_image_from_frame_golden_count(frame0):
    ours = RangeImage.from_frame(frame0[1], device="cpu")
    ref = JaxRangeImage.from_frame(frame0[0])
    assert int(ours.valid_points_count()) == int(ref.valid_points_count()) == 270213  # tests/test_range_image.py
    # The same f32 backprojection: bitwise.
    np.testing.assert_array_equal(ours.points.numpy(), np.asarray(ref.points))
    np.testing.assert_array_equal(ours.colors.numpy(), np.asarray(ref.colors))
