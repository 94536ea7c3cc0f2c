"""The port's dataset loaders against the JAX package's: TUM and
IndoorLidar on the synthetic fixture trees of ``tests/_dataset_fixtures.py``
(association, frames, depth scale, camera, poses, the error cases), frame
decode, the subset and prefetch wrappers, and odometry through the port's
command line on both trees against ``align3d_tpu.odometry.run_odometry``."""

import dataclasses
import os

import numpy as np
import pytest
import torch
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_tpu.io import datasets as jds
from align3d_tpu.io.datasets import core as jcore
from align3d_tpu.io.datasets import tum as jtum
from align3d_tpu.odometry import run_odometry as jax_run_odometry

from _dataset_fixtures import make_indoor_lidar_tree, make_tum_tree
from align3d_torch import cli, config
from align3d_torch.io import datasets as tds
from align3d_torch.io import native_loader
from align3d_torch.io.datasets import core
from align3d_torch.io.datasets import tum
from align3d_torch.metrics import TransformMetrics
from align3d_torch.trajectory import Trajectory

FORMATS = ("tum", "ilrgbd")
SAMPLE1 = config.ref_data_path("rgbd", "sample1")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return {
        "tum": make_tum_tree(str(tmp_path_factory.mktemp("tum_fix"))),
        "ilrgbd": make_indoor_lidar_tree(str(tmp_path_factory.mktemp("il_fix"))),
    }


@pytest.fixture
def native():
    """Skip unless the port's native loader builds here."""
    if not native_loader.available():
        pytest.skip(f"the native loader did not build: {native_loader.unavailable_reason()}")


def _assert_same_poses(ours, ref):
    # The same quaternion or matrix round trip in f32: rotation within 1e-6
    # (tests/test_torch_io.py), translation and times bitwise.
    np.testing.assert_allclose(ours.camera_to_world.rotation.numpy(), np.asarray(ref.camera_to_world.rotation),
                               atol=1e-6)
    np.testing.assert_array_equal(ours.camera_to_world.translation.numpy(),
                                  np.asarray(ref.camera_to_world.translation))
    np.testing.assert_array_equal(ours.times.numpy(), np.asarray(ref.times))


@pytest.mark.parametrize("fmt", FORMATS)
def test_loader_matches_jax(trees, fmt):
    ours, ref = tds.load_dataset(fmt, trees[fmt]), jds.load_dataset(fmt, trees[fmt])
    assert type(ours).__name__ == type(ref).__name__
    assert len(ours) == len(ref) == 4
    assert ours.rgb_images == ref.rgb_images and ours.depth_images == ref.depth_images
    assert ours.frame_paths() == ref.frame_paths()
    _assert_same_poses(ours.trajectory(), ref.trajectory())
    for i in range(len(ref)):
        frame, jframe = ours.get(i), ref.get(i)
        np.testing.assert_array_equal(frame.image.color, jframe.image.color)  # decoded by one library: bitwise
        np.testing.assert_array_equal(frame.image.depth, jframe.image.depth)
        assert frame.image.depth.dtype == np.uint16 and frame.image.color.dtype == np.uint8
        assert frame.image.depth_scale == jframe.image.depth_scale == (1 / 5000 if fmt == "tum" else 0.001)
        assert dataclasses.asdict(frame.camera) == dataclasses.asdict(jframe.camera)
        assert (frame.camera.fx, frame.camera.cx, frame.camera.cy) == (525.0, 319.5, 239.5)
        cam, pose = ours.camera(i)
        assert cam == frame.camera and torch.equal(pose.translation, frame.camera_to_world.translation)
        meta_cam, meta_pose, scale = ours.get_meta(i)
        assert meta_cam == cam and meta_pose.translation.equal(pose.translation) and scale == frame.image.depth_scale


def test_tum_association_against_jax():
    """The two-pointer merge, |dt| < 0.02 s strictly (tum.rs:52), on the
    boundary cases and on random staggered streams."""
    assert tum._associate([(1.0, "a")], [(1.02, "x")]) == jtum._associate([(1.0, "a")], [(1.02, "x")]) == []
    assert tum._associate([(1.0, "a")], [(1.019, "x")]) == [(1.0, "a", 1.019, "x")]
    rng = np.random.default_rng(13)
    for _ in range(20):
        first = sorted((float(t), f"d{i}") for i, t in enumerate(rng.uniform(0, 2, 40)))
        second = sorted((float(t), f"r{i}") for i, t in enumerate(rng.uniform(0, 2, 35)))
        assert tum._associate(first, second) == jtum._associate(first, second)


def test_tum_association_drops_unmatched(trees):
    ds = tds.TumRgbdDataset.load(trees["tum"])
    assert all("stray" not in f for f in ds.rgb_images + ds.depth_images)
    for k, (rgb, depth) in enumerate(zip(ds.rgb_images, ds.depth_images)):
        assert f"{10.0 + 0.1 * k + 0.015:.6f}" in rgb and f"{10.0 + 0.1 * k:.6f}" in depth


def _no_tum(tmp_path):
    return tds.TumRgbdDataset.load(str(tmp_path / "nope"))


def _il_count_mismatch(tmp_path):
    base = tmp_path / "bad"
    os.makedirs(base / "image")
    os.makedirs(base / "depth")
    (base / "image" / "0.jpg").write_bytes(b"")
    return tds.IndoorLidarDataset.load(str(base))


def _il_no_log(tmp_path):
    base = tmp_path / "nolog"
    os.makedirs(base / "image")
    os.makedirs(base / "depth")
    return tds.IndoorLidarDataset.load(str(base))


@pytest.mark.parametrize("case", [_no_tum, _il_count_mismatch, _il_no_log], ids=lambda f: f.__name__.strip("_"))
def test_loader_errors_raise_dataset_error(tmp_path, case):
    with pytest.raises(tds.DatasetError):
        case(tmp_path)


def test_subset_camera_and_trajectory(trees):
    base = tds.TumRgbdDataset.load(trees["tum"])
    sub, jsub = tds.SubsetDataset(base, [1, 3]), jds.SubsetDataset(jds.TumRgbdDataset.load(trees["tum"]), [1, 3])
    cam, pose = sub.camera(1)
    assert cam == base.camera(3)[0] and torch.equal(pose.rotation, base.camera(3)[1].rotation)
    assert dataclasses.asdict(cam) == dataclasses.asdict(jsub.camera(1)[0])
    assert isinstance(sub, tds.RgbdDataset) and isinstance(base, tds.RgbdDataset)
    _assert_same_poses(sub.trajectory(), jsub.trajectory())


def _frame_files(trees):
    tum_ds = tds.TumRgbdDataset.load(trees["tum"])
    il_ds = tds.IndoorLidarDataset.load(trees["ilrgbd"])
    return {
        "sample1_png": (os.path.join(SAMPLE1, "frame_00000_rgb.png"), os.path.join(SAMPLE1, "frame_00000_depth.png")),
        "tum_png": (tum_ds.frame_paths()[0][1], tum_ds.frame_paths()[1][1]),
        "ilrgbd_jpg": (il_ds.rgb_images[2], il_ds.depth_images[2]),
    }


@pytest.mark.parametrize("name", ["sample1_png", "tum_png", "ilrgbd_jpg"])
def test_load_rgb_and_depth_bitwise_jax(trees, name):
    color_path, depth_path = _frame_files(trees)[name]
    color, depth = core.load_rgb(color_path), core.load_depth_u16(depth_path)
    assert color.dtype == np.uint8 and color.ndim == 3 and depth.dtype == np.uint16 and depth.ndim == 2
    np.testing.assert_array_equal(color, jcore.load_rgb(color_path))
    np.testing.assert_array_equal(depth, jcore.load_depth_u16(depth_path))


@pytest.mark.parametrize("name", ["sample1_png", "tum_png"])
def test_png_decode_without_the_native_library(trees, monkeypatch, name):
    """Where the library does not build, PNG goes through io/png.py: the
    same pixels (both decoders are lossless)."""
    color_path, depth_path = _frame_files(trees)[name]
    want = core.load_rgb(color_path), core.load_depth_u16(depth_path)
    monkeypatch.setattr(native_loader, "available", lambda: False)
    np.testing.assert_array_equal(core.load_rgb(color_path), want[0])
    np.testing.assert_array_equal(core.load_depth_u16(depth_path), want[1])


def test_jpeg_without_native_library_or_pillow_raises(trees, monkeypatch):
    import sys

    color_path = _frame_files(trees)["ilrgbd_jpg"][0]
    monkeypatch.setattr(native_loader, "available", lambda: False)
    monkeypatch.setattr(native_loader, "unavailable_reason", lambda: "no compiler")
    assert core.load_rgb(color_path).shape == (120, 160, 3)  # Pillow
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(tds.DatasetError, match="native loader is unavailable .no compiler. and Pillow"):
        core.load_rgb(color_path)


@pytest.mark.parametrize("fmt", ["slamtb", "tum", "ilrgbd"])
def test_prefetching_dataset_bitwise_plain(trees, native, fmt):
    plain = tds.load_dataset(fmt, SAMPLE1 if fmt == "slamtb" else trees[fmt])
    pre = core.maybe_prefetch(plain, n_threads=2, prefetch=3)
    assert isinstance(pre, core.PrefetchingDataset)
    try:
        assert len(pre) == len(plain)
        assert torch.equal(pre.trajectory().camera_to_world.rotation, plain.trajectory().camera_to_world.rotation)
        for i in range(min(len(plain), 5)):
            a, b = plain.get(i), pre.get(i)
            np.testing.assert_array_equal(a.image.color, b.image.color)
            np.testing.assert_array_equal(a.image.depth, b.image.depth)
            assert a.image.depth_scale == b.image.depth_scale and a.camera == b.camera
            assert torch.equal(a.camera_to_world.rotation, b.camera_to_world.rotation)
            assert pre.camera(i)[0] == plain.camera(i)[0]
    finally:
        pre.close()


def test_maybe_prefetch_keeps_a_dataset_without_paths(trees):
    sub = tds.SubsetDataset(tds.TumRgbdDataset.load(trees["tum"]), [0, 1])
    assert core.maybe_prefetch(sub) is sub


@pytest.mark.parametrize("fmt", FORMATS)
def test_cli_odometry_against_jax(trees, tmp_path, capsys, fmt):
    """The port's command line on the CPU, checkpointing every 2 frames,
    against JAX's run_odometry over the same tree (3 frames, filter on):
    each pose within 1e-3 rad / 1e-3 m, the bound of
    tests/test_torch_odometry.py (measured: 0 on TUM, 5.2e-6 rad / 7.5e-6
    m on IndoorLidar)."""
    from align3d_tpu.ops.bilateral import BilateralFilter as JaxFilter
    from align3d_tpu.range_image import RangeImageBuilder as JaxBuilder

    out = tmp_path / "traj.tum"
    argv = ["odometry", fmt, trees[fmt], "3", "--device", "cpu", "-q", "--save-trajectory", str(out),
            "--checkpoint", str(tmp_path / "ck.npz"), "--checkpoint-every", "2"]
    assert cli.main(argv) == 0
    assert "Mean trajectory error" in capsys.readouterr().out
    ours = Trajectory.from_tum(out.read_text())
    ref = jax_run_odometry(jds.load_dataset(fmt, trees[fmt]), range_builder=JaxBuilder(bilateral_filter=JaxFilter()),
                           max_frames=3)
    ref_traj = Trajectory.from_tum(ref.trajectory.to_tum())
    assert len(ours) == len(ref_traj) == 3
    m = TransformMetrics.new(ref_traj.camera_to_world, ours.camera_to_world)
    assert float(m.angle.max()) <= 1e-3 and float(m.translation.max()) <= 1e-3
    assert torch.isfinite(ours.camera_to_world.translation).all()
