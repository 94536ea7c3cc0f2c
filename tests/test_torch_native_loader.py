"""The port's ctypes wrapper over ``native/loader.cpp``
(``align3d_torch/io/native_loader.py``): counterparts of
``tests/test_native_loader.py`` (decode against Pillow, the prefetch
pipeline in order, prefetched against single-shot, the prefetching dataset
against the plain one), decode against the JAX package's wrapper, and the
build's failure kept as the reason. Tests that need the library skip, with
the build's error as the reason, where it does not build."""

import json
import os

import numpy as np
import pytest
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)
from PIL import Image

from align3d_tpu.io.datasets import core as jcore

from align3d_torch import config
from align3d_torch.io import native_loader
from align3d_torch.io.datasets import SlamTbDataset
from align3d_torch.io.datasets.core import PrefetchingDataset, maybe_prefetch

SAMPLE1 = config.ref_data_path("rgbd", "sample1")


@pytest.fixture
def paths():
    if not native_loader.available():
        pytest.skip(f"the native loader did not build: {native_loader.unavailable_reason()}")
    frames = json.load(open(os.path.join(SAMPLE1, "frames.json")))["root"]
    return ([os.path.join(SAMPLE1, f["rgb_image"]) for f in frames],
            [os.path.join(SAMPLE1, f["depth_image"]) for f in frames])


@pytest.mark.parametrize("path", [os.path.join(SAMPLE1, "frame_00000_rgb.png"),
                                  config.ref_data_path("images", "bloei.jpg")], ids=["png", "jpeg"])
def test_decode_matches_pil(paths, path):
    rgb = native_loader.decode_rgb(path)
    pil = np.asarray(Image.open(path).convert("RGB"))
    assert rgb.shape == pil.shape and rgb.dtype == np.uint8
    if path.endswith(".png"):
        np.testing.assert_array_equal(rgb, pil)
    else:
        # JPEG decoders may differ by their DCT (tests/test_native_loader.py):
        # mean |diff| < 2 (measured bitwise against this Pillow).
        assert np.mean(np.abs(rgb.astype(int) - pil.astype(int))) < 2.0
    np.testing.assert_array_equal(rgb, jcore.load_rgb(path))  # the JAX package's decode of the same file
    depth_path = paths[1][0]
    depth = native_loader.decode_depth(depth_path)
    np.testing.assert_array_equal(depth, np.asarray(Image.open(depth_path)).astype(np.uint16))
    with pytest.raises(IOError):
        native_loader.decode_depth(os.path.join(SAMPLE1, "frames.json"))


def test_prefetch_loader_sequential(paths):
    colors, depths = paths
    loader = native_loader.PrefetchLoader(colors[:6], depths[:6], n_threads=2)
    try:
        assert len(loader) == 6
        for i in range(6):
            color, depth = loader.get(i)
            assert color.shape == (480, 640, 3) and depth.dtype == np.uint16 and depth.max() > 0
        with pytest.raises(IOError):
            loader.get(6)
    finally:
        loader.close()
    with pytest.raises(RuntimeError, match="closed"):
        loader.get(0)


def test_prefetch_matches_single_shot(paths):
    colors, depths = paths
    loader = native_loader.PrefetchLoader(colors[:3], depths[:3], prefetch=2)
    try:
        got = [loader.get(i) for i in (0, 2, 1)]  # out of order: re-issued
    finally:
        loader.close()
    for (c, d), i in zip(got, (0, 2, 1)):
        np.testing.assert_array_equal(c, native_loader.decode_rgb(colors[i]))
        np.testing.assert_array_equal(d, native_loader.decode_depth(depths[i]))


def test_prefetching_dataset_matches_plain(paths):
    plain = SlamTbDataset.load(SAMPLE1)
    pre = maybe_prefetch(plain)
    assert isinstance(pre, PrefetchingDataset)
    try:
        for i in (0, 1, 2):
            a, b = plain.get(i), pre.get(i)
            np.testing.assert_array_equal(a.image.depth, b.image.depth)
            np.testing.assert_array_equal(a.image.color, b.image.color)
            assert a.image.depth_scale == b.image.depth_scale
    finally:
        pre.close()


def test_failed_build_keeps_its_error(tmp_path, monkeypatch):
    """A compiler that cannot run leaves the library unavailable, the
    error kept as the reason; decode then raises it."""
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_error", None)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not native_loader.available()
    assert "no-such-compiler" in native_loader.unavailable_reason()
    with pytest.raises(RuntimeError, match="native loader unavailable"):
        native_loader.decode_rgb(os.path.join(SAMPLE1, "frame_00000_rgb.png"))
    assert maybe_prefetch(SlamTbDataset.load(SAMPLE1)).__class__ is SlamTbDataset
    assert not (tmp_path / "native" / native_loader.LIB_NAME).exists()
