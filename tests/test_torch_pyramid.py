"""The pyramid's routing and its kernels' index arithmetic, on the CPU.

``build_pyramid_impl`` on CPU tensors runs ``ops/pyramid.py::pyramid_plain``
(no kernel launch) and returns what the ``RangeImage`` method chain gives.
K12 and K13 (``csrc/pyramid.cu``) run only on the card
(``tests/test_torch_kernels_cuda.py`` holds them bitwise to the twin there);
here numpy transcriptions of their tiling hold the index arithmetic that a
mistake would hide in: the blur's shared colour tile and its two passes
(local rows ``2 * row + k``, columns ``2 * lane + k``, loads clamped in the
finer level), the intensity map's border as each pixel writes it, and the
2x2 windows' float32 row and column picks.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_pyramid_cases import level2_blind_depth, window_rows

from align3d_torch.image import _blur_offsets_weights, py_scale_down, rgb_to_luma_u8
from align3d_torch.io.datasets import SlamTbDataset
from align3d_torch.ops import pyramid as pyr
from align3d_torch.ops.intensity import build_intensity_map
from align3d_torch.ops.resize import _window_taps
from align3d_torch.range_image import RangeImage, build_pyramid_impl

RGBD = Path(__file__).resolve().parent / "data" / "rgbd"
TILE_W, TILE_H = 32, 8  # csrc/pyramid.cu's kTileW, kTileH


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the twin is hundreds of small ops, which crawl on
    many threads while the suite's other workers hold the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def frames():
    """Two sample1 frames at a quarter size (120x160), u8 colour, int32
    depth, and the camera scaled to match."""
    ds = SlamTbDataset.load(str(RGBD / "sample1"))
    got = [ds.get(i) for i in (0, 1)]
    color = np.stack([f.image.color[::4, ::4] for f in got])
    depth = np.stack([f.image.depth[::4, ::4].astype(np.int32) for f in got])
    camera = got[0].camera.scale(0.25)
    return torch.from_numpy(np.ascontiguousarray(color)), torch.from_numpy(np.ascontiguousarray(depth)), camera


def _counts():
    return pyr.BASE_LAUNCHES, pyr.DOWN_LAUNCHES


def _assert_same(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
@pytest.mark.parametrize("flags", [(True, True), (False, True), (True, False)])
def test_build_on_cpu_is_the_plain_twin(frames, levels, flags):
    """No launch counted; every level's tensors the twin's exactly, the
    intrinsics halved a level."""
    color, depth, camera = frames
    with_normals, with_intensity = flags
    args = (with_normals, with_intensity, levels, 1.0, camera, 0.001, color[0], depth[0])
    before = _counts()
    got = build_pyramid_impl(*args)
    assert _counts() == before
    ref = pyr.pyramid_plain(*args)
    assert len(got) == len(ref) == levels
    intr = camera
    for k, (g, r) in enumerate(zip(got, ref)):
        for field in pyr.Level._fields:
            _assert_same(getattr(g, field), getattr(r, field))
        if k == 0:
            assert g.colors is args[6]  # level 0 keeps the colour it was given
        assert dataclasses.asdict(g.intrinsics) == dataclasses.asdict(intr)
        intr = intr.scale(0.5)


def test_plain_twin_is_the_range_image_chain(frames):
    """The twin is the RangeImage method chain that RangeImageBuilder.build
    ran before the kernels: backproject, normals, scale_down a level, luma
    and map; with a per-frame scale tensor over two frames."""
    color, depth, camera = frames
    scales = torch.tensor([0.001, 0.0011], dtype=torch.float64)
    ref = pyr.pyramid_plain(True, True, 3, 1.0, camera, scales, color, depth)
    first = RangeImage.from_rgbd(camera, color, depth, scales).with_normals()
    chain = [ri.with_intensity().with_intensity_map() for ri in first.pyramid(3, 1.0)]
    for g, r in zip(chain, ref):
        for field in pyr.Level._fields:
            _assert_same(getattr(g, field), getattr(r, field))


def test_kernel_wrappers_refuse_cpu_tensors(frames):
    color, depth, camera = frames
    before = _counts()
    with pytest.raises(ValueError):
        pyr.pyramid_base(depth, color, 0.001, camera, True, True)
    level = pyr.pyramid_plain(True, True, 1, 1.0, camera, 0.001, color, depth)[0]
    with pytest.raises(ValueError):
        pyr.pyramid_down(level, 1.0, True)
    assert _counts() == before


def _k13_colour(colors: np.ndarray, sigma: float) -> np.ndarray:
    """K13's colour path, tile by tile, in float32: the (14 + taps, 62 + taps)
    tile of finer colours at clamped rows and columns from (2 v0 + lo, 2 u0 +
    lo), the rows pass at local rows 2 * row + k, the columns pass at local
    columns 2 * lane + k, clamped to [0, 255] and truncated."""
    lo, hi, wts = _blur_offsets_weights(sigma)
    taps = hi - lo
    h, w, _ = colors.shape
    dh, dw = h // 2, w // 2
    out = np.full((dh, dw, 3), -1, np.int64)
    rows_t, cols_t = 2 * (TILE_H - 1) + taps, 2 * (TILE_W - 1) + taps
    for v0 in range(0, dh, TILE_H):
        for u0 in range(0, dw, TILE_W):
            fr = np.clip(2 * v0 + lo + np.arange(rows_t), 0, h - 1)
            fc = np.clip(2 * u0 + lo + np.arange(cols_t), 0, w - 1)
            tile = colors[fr[:, None], fc[None, :]].astype(np.float32)
            rpass = np.stack([tile[2 * oi] * wts[0] for oi in range(TILE_H)])
            for k in range(1, taps):
                rpass = rpass + np.stack([tile[2 * oi + k] * wts[k] for oi in range(TILE_H)])
            acc = rpass[:, 2 * np.arange(TILE_W)] * wts[0]
            for k in range(1, taps):
                acc = acc + rpass[:, 2 * np.arange(TILE_W) + k] * wts[k]
            vals = np.clip(acc, np.float32(0.0), np.float32(255.0)).astype(np.uint8).astype(np.int64)
            nv, nu = min(TILE_H, dh - v0), min(TILE_W, dw - u0)
            out[v0 : v0 + nv, u0 : u0 + nu] = vals[:nv, :nu]
    return out


@pytest.mark.parametrize("shape", [(48, 64), (61, 97), (17, 66), (479 // 8, 639 // 8)])
@pytest.mark.parametrize("sigma", [1.0, 1.7])
def test_k13_colour_tiling_transcription(shape, sigma):
    colors = np.random.default_rng(sum(shape)).integers(0, 256, size=(*shape, 3), dtype=np.uint8)
    ref = py_scale_down(torch.from_numpy(colors), sigma).numpy().astype(np.int64)
    np.testing.assert_array_equal(_k13_colour(colors, sigma), ref)


def _write_map(luma: np.ndarray) -> np.ndarray:
    """The intensity map as K12 and K13 write it: each pixel its cell and the
    border cells it owns (csrc/pyramid.cu::write_map), in an unset (NaN)
    buffer, so that a cell no pixel writes stays NaN."""
    h, w = luma.shape
    m = np.full((h + 2, w + 2), np.nan, np.float32)
    for v in range(h):
        for u in range(w):
            c = np.float32(luma[v, u]) / np.float32(255.0)
            m[v, u] = c
            if v == h - 1 and u <= w - 2:
                m[h, u] = m[h + 1, u] = c
            if u == w - 1 and v <= h - 2:
                m[v, w] = m[v, w + 1] = c
            if v == h - 1 and u == w - 1:
                m[h, w] = m[h + 1, w + 1] = c
                for cell in ((h - 1, w), (h - 1, w + 1), (h, w - 1), (h, w + 1), (h + 1, w - 1), (h + 1, w)):
                    m[cell] = 0.0
    return m


@pytest.mark.parametrize("shape", [(1, 1), (1, 5), (4, 1), (7, 9), (30, 40)])
def test_intensity_map_border_as_each_pixel_writes_it(shape):
    rgb = np.random.default_rng(5).integers(0, 256, size=(*shape, 3), dtype=np.uint8)
    luma = rgb_to_luma_u8(torch.from_numpy(rgb))
    ref = build_intensity_map(luma).numpy()
    np.testing.assert_array_equal(_write_map(luma.numpy()), ref)


@pytest.mark.parametrize("n", [480, 479, 239, 119, 60, 7, 3])
def test_window_picks_as_the_kernel_computes_them(n):
    """trunc(f32(v) * f32(n / dst)) and the next, clamped, pick the rows that
    _window_taps gathers (strided slices at even sizes)."""
    dst = n // 2
    src = torch.arange(n, dtype=torch.float32)[:, None].expand(n, 2).contiguous()
    rows = window_rows(n, dst)
    taps = _window_taps(src, dst, 1)
    np.testing.assert_array_equal(taps[0][:, 0].numpy(), rows[:, 0])
    np.testing.assert_array_equal(taps[2][:, 0].numpy(), rows[:, 1])


def test_level2_blind_frame_is_blind_at_level_two():
    """The CUDA tests' frame: valid pixels at levels 0 and 1, none at 2."""
    depth = torch.from_numpy(level2_blind_depth(479, 639))
    color = torch.zeros((479, 639, 3), dtype=torch.uint8)
    levels = pyr.pyramid_plain(True, True, 3, 1.0, SlamTbDataset.load(str(RGBD / "sample1")).get(0).camera,
                               0.001, color, depth)
    assert bool(levels[0].mask.any()) and bool(levels[1].mask.any())
    assert not bool(levels[2].mask.any())
    assert not bool(levels[2].points.any()) and not bool(levels[2].normals.any())
