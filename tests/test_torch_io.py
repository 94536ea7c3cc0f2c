"""Host I/O of the PyTorch port: the zlib+numpy PNG decoder against Pillow,
and the SlamTb loader against the JAX package's loader."""

import struct
import zlib

import numpy as np
import pytest
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)
from PIL import Image

from align3d_tpu import config
from align3d_tpu.io.datasets import SlamTbDataset as JaxSlamTb

from align3d_torch.io import png
from align3d_torch.io.datasets import SlamTbDataset, SubsetDataset, load_dataset


@pytest.mark.parametrize("sample", ["sample1", "sample2"])
@pytest.mark.parametrize("kind", ["rgb", "depth"])
def test_png_decode_matches_pillow(sample, kind):
    path = config.ref_data_path("rgbd", sample, f"frame_00000_{kind}.png")
    ours = png.read(path)
    ref = np.asarray(Image.open(path))
    if kind == "depth":
        ref = ref.astype(np.uint16)  # Pillow may hand 16-bit grey back as int32
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)  # bitwise


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _encode(image: np.ndarray, filter_type: int) -> bytes:
    """A minimal PNG encoder that applies one filter type to every row, so
    the decoder's inverse of each filter is checked on its own."""
    if image.dtype == np.uint8:
        bit_depth, color_type, bpp = 8, 2, 3
        raw = image.reshape(image.shape[0], -1)
    else:
        bit_depth, color_type, bpp = 16, 0, 2
        raw = image.astype(">u2").view(np.uint8).reshape(image.shape[0], -1)
    h, stride = raw.shape
    rows = []
    prior = np.zeros(stride, np.int64)
    for y in range(h):
        cur = raw[y].astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if filter_type == 0:
            pred = np.zeros_like(cur)
        elif filter_type == 1:
            pred = left
        elif filter_type == 2:
            pred = prior
        elif filter_type == 3:
            pred = (left + prior) // 2
        else:
            pred = np.asarray([_paeth(a, b, c) for a, b, c in zip(left, prior, upleft)])
        rows.append(bytes([filter_type]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prior = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", image.shape[1], image.shape[0], bit_depth, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b"")
    )


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("fmt", ["rgb8", "gray16"])
def test_png_filters_roundtrip(filter_type, fmt):
    rng = np.random.default_rng(filter_type)
    if fmt == "rgb8":
        image = rng.integers(0, 256, size=(7, 9, 3), dtype=np.uint8)
    else:
        image = rng.integers(0, 65536, size=(7, 9), dtype=np.uint16)
    np.testing.assert_array_equal(png.decode(_encode(image, filter_type)), image)


def test_png_rejects_unsupported_format():
    grey8 = _encode(np.zeros((2, 2, 3), np.uint8), 0)
    ihdr_at = 8 + 8
    patched = bytearray(grey8)
    patched[ihdr_at + 9] = 0  # colour type 0 with bit depth 8
    with pytest.raises(png.PngError):
        png.decode(bytes(patched))
    with pytest.raises(png.PngError):
        png.decode(b"not a png")


@pytest.mark.parametrize("sample", ["sample1", "sample2"])
def test_slamtb_matches_jax_loader(sample):
    path = config.ref_data_path("rgbd", sample)
    ours, ref = SlamTbDataset.load(path), JaxSlamTb.load(path)
    assert len(ours) == len(ref)
    assert ours.depth_scales == ref.depth_scales
    for i in range(len(ref)):
        assert ours.cameras[i].__dict__ == ref.cameras[i].__dict__
    # Poses: the same quaternion round trip in f32 (measured max 6.0e-8).
    np.testing.assert_allclose(
        ours.trajectory().camera_to_world.rotation.numpy(),
        np.asarray(ref.trajectory().camera_to_world.rotation),
        atol=1e-6,
    )
    np.testing.assert_array_equal(
        ours.trajectory().camera_to_world.translation.numpy(),
        np.asarray(ref.trajectory().camera_to_world.translation),
    )
    frame, jframe = ours.get(1), ref.get(1)
    np.testing.assert_array_equal(frame.image.color, jframe.image.color)
    np.testing.assert_array_equal(frame.image.depth, jframe.image.depth)
    sub = SubsetDataset(ours, [0, 2])
    assert len(sub) == 2 and len(sub.trajectory()) == 2


def test_load_dataset_names_unported_formats(tmp_path):
    """Every format of the JAX package's dispatcher loads; an unknown one
    still raises."""
    from _dataset_fixtures import make_indoor_lidar_tree, make_tum_tree

    tum = load_dataset("tum", make_tum_tree(str(tmp_path / "tum"), n_frames=2))
    ilrgbd = load_dataset("ilrgbd", make_indoor_lidar_tree(str(tmp_path / "il"), n_frames=2))
    assert (type(tum).__name__, len(tum)) == ("TumRgbdDataset", 2)
    assert (type(ilrgbd).__name__, len(ilrgbd)) == ("IndoorLidarDataset", 2)
    with pytest.raises(ValueError, match="Invalid dataset format"):
        load_dataset("nope", "/nonexistent")
