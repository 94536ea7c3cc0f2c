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
