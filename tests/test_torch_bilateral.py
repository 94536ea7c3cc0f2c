"""The bilateral depth filter of the PyTorch port against the JAX package.

The splat is held bitwise against both JAX forms: the XLA one-hot ``_splat``
and the Pallas splat kernel in interpret mode (the CUDA splat is held
bitwise against the port's plain ``_splat`` on the card, in
test_torch_kernels_cuda.py and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_tpu.ops import bilateral as jb

from align3d_torch.ops import bilateral as tb

SIGMA_SPACE = tb.BilateralFilter.sigma_space
SIGMA_COLOR = tb.BilateralFilter.sigma_color


def _deep_frame():
    """A synthetic 64x96 frame whose depth span needs > 256 grid channels."""
    rng = np.random.default_rng(3)
    ys, xs = np.meshgrid(np.arange(64), np.arange(96), indexing="ij")
    depth = 500 + 90 * xs + 40 * ys + rng.integers(0, 30, size=(64, 96))
    depth[10:14, 20:30] = 0  # holes
    return depth.astype(np.uint16)


@pytest.fixture(scope="module")
def frames(sample1_dataset):
    return {"sample1": sample1_dataset.get(0).image.depth, "deep": _deep_frame()}


def _grid_shape(depth, pad_to=1):
    h, w = depth.shape
    gh, gw = tb._grid_dims(h, w, SIGMA_SPACE)
    gd = int((float(depth.max()) - float(depth.min())) / SIGMA_COLOR) + 1 + 4
    return gh, gw, -(-gd // pad_to) * pad_to


@pytest.mark.parametrize("name", ["sample1", "deep"])
def test_splat_bitwise_against_jax_xla_and_pallas(frames, name):
    depth = frames[name]
    shape = _grid_shape(depth, pad_to=16)
    if name == "deep":
        assert shape[2] > 256
    else:
        assert shape == (111, 146, 96)  # gw 146: 639 / 4.50000000225 truncates to 141
    cmin = int(depth.min())
    ours = tb._splat(torch.from_numpy(depth.astype(np.int32)), cmin, shape, SIGMA_SPACE, SIGMA_COLOR).numpy()
    args = (jnp.asarray(depth), jnp.min(jnp.asarray(depth)), shape, SIGMA_SPACE, SIGMA_COLOR)
    np.testing.assert_array_equal(ours, np.asarray(jb._splat(*args, interpret=None)))
    np.testing.assert_array_equal(ours, np.asarray(jb._splat(*args, interpret=True)))


@pytest.fixture(scope="module")
def grids(frames):
    depth = frames["sample1"]
    jg = jb.BilateralGrid.from_image(jnp.asarray(depth), SIGMA_SPACE, SIGMA_COLOR, 16)
    tg = tb.BilateralGrid.from_image(torch.from_numpy(depth.astype(np.int32)), SIGMA_SPACE, SIGMA_COLOR, 16)
    return jg.convolve().normalize(), tg.convolve().normalize()


def test_grid_metadata_matches_jax(grids):
    jg, tg = grids
    assert tuple(tg.data_cm.shape) == tuple(jg.data_cm.shape) == (2, 111, 146, 96)
    assert tg.depth_limit == int(jg.depth_limit) == 82
    assert tg.color_min == int(jg.color_min) == 0  # sample1 has holes


@pytest.mark.parametrize("name", ["sample1", "deep"])
def test_grid_geometry_keeps_color_min_on_the_image_device(frames, name):
    """color_min is a 0-d int32 tensor on the image's device, which the splat
    and slice wrappers take as it is, with no copy per call."""
    depth = frames[name]
    image = torch.from_numpy(depth.astype(np.int32))
    cmin, shape, true_gd = tb.grid_geometry(image, SIGMA_SPACE, SIGMA_COLOR, 16)
    assert cmin.shape == () and cmin.dtype == torch.int32 and cmin.device == image.device
    assert int(cmin) == int(depth.min())
    assert shape == _grid_shape(depth, pad_to=16) and true_gd == _grid_shape(depth)[2]
    _, per_frame = tb._frames(image, cmin)
    assert per_frame.data_ptr() == cmin.data_ptr()
    grid = tb.BilateralGrid.from_image(image, SIGMA_SPACE, SIGMA_COLOR, 16)
    assert torch.equal(grid.color_min, cmin) and grid.depth_limit == true_gd


def test_blur_normalize_against_jax(grids):
    jg, tg = grids
    ref = np.asarray(jg.data_cm)
    # rtol 1e-5 (measured max relative 2.0e-7): the same banded matrices,
    # contracted in another order.
    np.testing.assert_allclose(tg.data_cm.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_slice_against_jax(grids, frames):
    jg, tg = grids
    depth = frames["sample1"]
    ref = np.asarray(jb._slice(jg.data_cm, jnp.asarray(depth), jg.color_min, SIGMA_SPACE, SIGMA_COLOR))
    # Same grid into both slices: atol 2e-3, the bound tests/test_bilateral.py
    # holds the Pallas slice to (measured 4.9e-4: XLA contracts the lerps into
    # FMAs, PyTorch does not).
    same = tb._slice(torch.from_numpy(np.array(jg.data_cm)), torch.from_numpy(depth.astype(np.int32)),
                     tg.color_min, SIGMA_SPACE, SIGMA_COLOR)
    np.testing.assert_allclose(same.numpy(), ref, atol=2e-3)


@pytest.mark.parametrize("name", ["sample1", "deep"])
def test_filter_against_jax(frames, name):
    depth = frames[name]
    ref = np.asarray(jb.BilateralFilter().filter(jnp.asarray(depth))).astype(int)
    ours = tb.BilateralFilter().filter(torch.from_numpy(depth.astype(np.int32))).numpy()
    diff = np.abs(ours - ref)
    # u16 output: |diff| <= 1 at a small share of pixels, where a value within
    # an ulp of an integer truncates differently (measured: 1 at 2.9e-5 of
    # sample1's pixels, at 2 of the deep frame's 6144 pixels).
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


def _splat_by_columns(depth, cmin, shape, sigma_space, sigma_color):
    """A numpy transcription of the CUDA splat's column algorithm
    (csrc/bilateral.cu::bilateral_splat). One warp per (gy, gx) column
    zero-fills the column's cells, then takes the window taps 32 at a time
    in the order t = a * B + b, one per lane; zero-weight taps and chan
    outside [0, gd) store nothing. The lowest lane of each group of equal
    chan stores the cell: while the column is exact (every weight so far 1,
    its depths so far summing to at most 2^24) the cell's stored sum plus the
    group's integer sums; otherwise the group's terms added in ascending lane
    order to the stored sum (+0.0 in the first chunk)."""
    h, w = depth.shape
    gh, gw, gd = shape
    inv_ss = 1.0 / sigma_space
    ridx, rwt = tb._splat_window(h, gh, inv_ss, 2)
    cidx, cwt = tb._splat_window(w, gw, inv_ss, 2)
    taps = ridx.shape[1] * cidx.shape[1]
    a, b = np.divmod(np.arange(taps), cidx.shape[1])
    d = depth[ridx[:, a][:, None, :], cidx[:, b][None, :, :]].reshape(gh * gw, taps)
    val = d.astype(np.float32)
    wt = (d > 0).astype(np.float32) * (rwt[:, a][:, None, :] * cwt[:, b][None, :, :]).reshape(gh * gw, taps)
    wv = wt * val
    inv_sc = np.float32(1.0 / sigma_color)
    chan = ((val - np.float32(cmin)) * inv_sc + np.float32(0.5)).astype(np.int32) + 2
    chan = np.where((wt != 0) & (chan >= 0) & (chan < gd), chan, -1)
    value = np.zeros((gh * gw, gd), np.float32)  # the zero fill
    count = np.zeros((gh * gw, gd), np.float32)
    cols = np.arange(gh * gw)
    exact = 1 << 24
    seen = np.zeros(gh * gw, np.int64)
    fast = np.ones(gh * gw, bool)
    for first in range(0, taps, 32):
        ch, c_wt, c_wv = chan[:, first:first + 32], wt[:, first:first + 32], wv[:, first:first + 32]
        c_d = np.where(ch >= 0, np.minimum(d[:, first:first + 32], exact + 1), 0).astype(np.int64)
        seen = np.minimum(seen + c_d.sum(axis=1), exact + 1)
        fast &= ((ch < 0) | (c_wt == 1)).all(axis=1) & (seen <= exact)
        lanes = ch.shape[1]
        group = ch[:, :, None] == ch[:, None, :]  # (columns, lane, lane): __match_any_sync
        for i in range(lanes):
            leader = (ch[:, i] >= 0) & ~group[:, i, :i].any(axis=1)
            at = np.where(leader, ch[:, i], 0)
            acc_c = np.zeros(gh * gw, np.float32) if first == 0 else count[cols, at]
            acc_v = np.zeros(gh * gw, np.float32) if first == 0 else value[cols, at]
            fast_c = acc_c + group[:, i].sum(axis=1).astype(np.float32)
            fast_v = acc_v + (c_d * group[:, i]).sum(axis=1).astype(np.float32)
            for j in range(i, lanes):
                acc_c = np.where(group[:, i, j], acc_c + c_wt[:, j], acc_c)
                acc_v = np.where(group[:, i, j], acc_v + c_wv[:, j], acc_v)
            acc_c, acc_v = np.where(fast, fast_c, acc_c), np.where(fast, fast_v, acc_v)
            count[cols[leader], at[leader]] = acc_c[leader]
            value[cols[leader], at[leader]] = acc_v[leader]
    return np.stack([value, count]).reshape(2, gh, gw, gd)


def _splat_exact_values(depth, cmin, shape, sigma_space, sigma_color):
    """The value channel's exact integer sums (int64), for the rounding check."""
    gh, gw, gd = shape
    rows, cols = ((np.arange(n, dtype=np.float32) * np.float32(1.0 / sigma_space) + 0.5).astype(np.int64) + 2
                  for n in depth.shape)
    chan = ((depth.astype(np.float32) - np.float32(cmin)) * np.float32(1.0 / sigma_color) + np.float32(0.5))
    chan = chan.astype(np.int64) + 2
    ok = (depth > 0) & (chan >= 0) & (chan < gd)
    r, c = np.meshgrid(rows, cols, indexing="ij")
    out = np.zeros(shape, np.int64)
    np.add.at(out, (r[ok], c[ok], chan[ok]), depth[ok])
    return out


def _deeper_frame():
    """A synthetic 64x96 frame whose depth span needs >= 752 grid channels."""
    rng = np.random.default_rng(5)
    ys, xs = np.meshgrid(np.arange(64), np.arange(96), indexing="ij")
    depth = 500 + 180 * xs + 80 * ys + rng.integers(0, 30, size=(64, 96))
    depth[40:44, 60:75] = 0  # holes
    return depth.astype(np.uint16)


def _large_depth_frame():
    """A 24x32 frame of depths in [2^22, 2^23): a 5x5 window's sum passes
    2^24, so float32 sums round and their order shows in the bits."""
    rng = np.random.default_rng(7)
    depth = rng.integers(1 << 22, 1 << 23, size=(24, 32))
    depth[3:6, 4:9] = 0  # holes
    return depth


@pytest.mark.parametrize("case", ["sample1_min_with_holes", "sample1_nonzero_min", "deep_752",
                                  "sigma_space_7", "sigma_space_12_deep", "large_depths"])
def test_splat_column_algorithm_bitwise(frames, case):
    """The CUDA splat's column algorithm, transcribed in numpy, equals the
    plain one-hot _splat bitwise: the ordered-sum claim the kernel rests on.
    The cases cover holes under both color_min conventions (under the
    nonzero minimum the holes' channels fall below 0), a deep grid, windows
    of more than 32 taps per column (two and five 32-tap chunks), and depths
    whose sums round in float32, which take the ordered path."""
    sigma_space, sigma_color, pad = SIGMA_SPACE, SIGMA_COLOR, 16
    depth = {"deep_752": _deeper_frame(), "sigma_space_12_deep": _deep_frame(),
             "large_depths": _large_depth_frame()}.get(case, frames["sample1"])
    depth = depth.astype(np.int32)
    if case == "large_depths":
        sigma_color = 2.0e5  # ~21 channels over the span
    cmin = int(depth[depth > 0].min()) if case == "sample1_nonzero_min" else int(depth.min())
    if case.startswith("sigma_space"):
        sigma_space, pad = float(case.split("_")[2]), 1  # an unpadded, ragged depth
    gh, gw = tb._grid_dims(*depth.shape, sigma_space)
    gd = -(-tb.true_depth(cmin, int(depth.max()), sigma_color) // pad) * pad
    taps = tb._splat_window(depth.shape[0], gh, 1.0 / sigma_space, 2)[0].shape[1] * \
        tb._splat_window(depth.shape[1], gw, 1.0 / sigma_space, 2)[0].shape[1]
    assert taps > 32 if case.startswith("sigma_space") else taps <= 32
    if case == "deep_752":
        assert gd >= 752
    if case == "sample1_nonzero_min":
        assert cmin > 0 and (depth == 0).any()
    ref = tb._splat_plain(torch.from_numpy(depth), cmin, (gh, gw, gd), sigma_space, sigma_color).numpy()
    got = _splat_by_columns(depth, cmin, (gh, gw, gd), sigma_space, sigma_color)
    assert ref.any()
    if case == "large_depths":  # some cell's sum is not the exact integer sum
        assert (ref[0].astype(np.float64) != _splat_exact_values(depth, cmin, (gh, gw, gd), sigma_space,
                                                                 sigma_color)).any()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_color_min_counts_holes():
    """``from_image`` takes the minimum including zero holes (the JAX
    package's convention), so a frame with holes starts its range axis at 0;
    without holes it starts at the nonzero minimum."""
    depth = _deep_frame()
    for frame in (depth, np.where(depth > 0, depth, 777).astype(np.uint16)):
        jg = jb.BilateralGrid.from_image(jnp.asarray(frame), SIGMA_SPACE, SIGMA_COLOR, 16)
        tg = tb.BilateralGrid.from_image(torch.from_numpy(frame.astype(np.int32)), SIGMA_SPACE, SIGMA_COLOR, 16)
        assert tg.color_min == int(jg.color_min) == int(frame.min())
        assert tg.depth_limit == int(jg.depth_limit)
        np.testing.assert_array_equal(
            tb._splat(torch.from_numpy(frame.astype(np.int32)), tg.color_min, tuple(tg.data_cm.shape[1:]),
                      SIGMA_SPACE, SIGMA_COLOR).numpy(),
            np.asarray(jb._splat(jnp.asarray(frame), jg.color_min, tuple(jg.data_cm.shape[1:]),
                                 SIGMA_SPACE, SIGMA_COLOR)),
        )
    assert int(depth.min()) == 0


def _normalize_slice_by_pixels(grid, depth, cmin, sigma_space, sigma_color):
    """A numpy transcription of the slice kernel's form (b)
    (csrc/bilateral.cu::bilateral_slice): per pixel, the value and count of
    its 8 corners, each corner normalized as it is read (value / count where
    count > 0, the value otherwise), then the x-, y- and z-lerps in the
    kernel's order, truncated into int32. ``grid``: (B, 2, gh, gw, gd) float32,
    ``depth``: (B, H, W), ``cmin``: (B,)."""
    b, h, w = depth.shape
    gh, gw, gd = grid.shape[-3:]
    y0, y1, ya, x0, x1, xa = (t.numpy() for t in tb._slice_tables(h, w, gh, gw, sigma_space, torch.device("cpu")))
    ya, xa = ya[:, None], xa[None, :]
    one = np.float32(1.0)
    out = np.empty((b, h, w), np.int32)
    for f in range(b):
        chan = (depth[f].astype(np.float32) - np.float32(cmin[f])) * np.float32(1.0 / sigma_color) + np.float32(2)
        z0 = np.clip(chan.astype(np.int32), 0, gd - 1)
        z1 = np.clip((chan + one).astype(np.int32), 0, gd - 1)
        za = chan - z0.astype(np.float32)

        def corner(y, x, z):
            val, cnt = (grid[f, k][y[:, None], x[None, :], z] for k in (0, 1))
            return np.where(cnt > 0, val / np.where(cnt > 0, cnt, one), val)

        def pmix(z):
            row0 = corner(y0, x0, z) * (one - xa) + corner(y0, x1, z) * xa
            row1 = corner(y1, x0, z) * (one - xa) + corner(y1, x1, z) * xa
            return row0 * (one - ya) + row1 * ya

        m0, m1 = pmix(z0), pmix(z1)
        out[f] = np.where(z0 == z1, ((one - za) + za) * m0, (one - za) * m0 + za * m1).astype(np.int32)
    return out


@pytest.mark.parametrize("name", ["sample1", "deep"])
def test_normalize_slice_bitwise(frames, name):
    """The filter's slice (the kernel's form (b)) equals normalize, the float
    slice and the cast, bitwise: its twin, the numpy transcription of the
    kernel's per-corner arithmetic, and BilateralFilter.filter, which now
    writes no normalized grid."""
    depth = torch.from_numpy(frames[name].astype(np.int32))
    grid = tb.BilateralGrid.from_image(depth, SIGMA_SPACE, SIGMA_COLOR, 16).convolve()
    composed = grid.normalize().slice(depth)
    fused = grid.normalize_slice(depth)
    assert fused.dtype == torch.int32 and torch.equal(fused, composed)
    assert torch.equal(tb._normalize_slice_plain(grid.data_cm, depth, grid.color_min, SIGMA_SPACE, SIGMA_COLOR),
                       composed)
    got = _normalize_slice_by_pixels(grid.data_cm.numpy()[None], depth.numpy()[None], [int(grid.color_min)],
                                     SIGMA_SPACE, SIGMA_COLOR)
    np.testing.assert_array_equal(got[0], composed.numpy())
    assert torch.equal(tb.BilateralFilter().filter(depth), composed)
