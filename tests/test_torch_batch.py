"""The batch-64 throughput path of the PyTorch port against the JAX package,
on the CPU at small sizes: the static and bucketed bilateral filter, the
batched slice at depth > 128, ``accumulate_scan``, the batched pyramids, the
batched align loop and ``odometry_step``.

Where the two differ, and why:

* the bilateral blur: the JAX package contracts each axis with a banded
  matrix (an XLA dot that sums in an order of its own), the port runs the
  same ``M T M T M`` as elementwise passes so that a frame's output does not
  depend on its batch; the u16 outputs then differ by 1 at a few pixels
  where a value sits within an ulp of an integer;
* JAX's ``odometry_step`` runs under one ``jit``, whose fusions change the
  pyramid's last bits (and so coarse-level nearest-to-mean picks) against
  the same stages run eagerly; the port is held tightly against those
  stages and, at a stated bound, against the jitted whole.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_tpu.icp.image_icp import align_batched as jax_align_batched
from align3d_tpu.icp.params import IcpParams as JaxIcpParams
from align3d_tpu.icp.params import MsIcpParams as JaxMsIcpParams
from align3d_tpu.ops import bilateral as jb
from align3d_tpu.parallel import batch as jbatch
from align3d_tpu.se3 import Transform as JaxTransform
from align3d_tpu.trajectory import accumulate_scan as jax_accumulate_scan

from align3d_torch.camera import CameraIntrinsics
from align3d_torch.icp.image_icp import align_batched, align_impl
from align3d_torch.icp.params import IcpParams, MsIcpParams
from align3d_torch.ops import bilateral as tb
from align3d_torch.parallel import batch as tbatch
from align3d_torch.se3 import Transform
from align3d_torch.tools import series
from align3d_torch.trajectory import TrajectoryBuilder, accumulate_scan

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_parallel import _synthetic_sequence  # noqa: E402
from test_torch_bilateral import _normalize_slice_by_pixels  # noqa: E402

FIELDS = ("points", "mask", "normals", "colors", "intensities", "intensity_map")


def _three_span_frames(bloei_luma16):
    """tests/test_bilateral.py::test_filter_static_buckets_bitwise's frames:
    three depth spans, holes in the widest."""
    rng = np.random.default_rng(0)
    h, w = 96, 128
    base = np.asarray(bloei_luma16[:h, :w], np.int64)
    frames = np.stack([base, base // 4 + 500, (base * 10) + rng.integers(0, 50, size=(h, w))]).astype(np.uint16)
    frames[2, :2, :2] = 0
    nz = np.where(frames > 0, frames, np.uint16(65535))
    return frames, nz.reshape(3, -1).min(axis=1), frames.reshape(3, -1).max(axis=1)


def test_filter_static_buckets_against_jax(bloei_luma16):
    frames, cmin, cmax = _three_span_frames(bloei_luma16)
    jf, tf = jb.BilateralFilter(pad_depth_to=1), tb.BilateralFilter(pad_depth_to=1)
    jplan = jb.plan_depth_buckets(cmin, cmax, jf.sigma_color, quantum=16)
    plan = tb.plan_depth_buckets(cmin, cmax, tf.sigma_color, quantum=16)
    assert len(plan) == len(jplan) >= 2
    for (g, idx, lim), (jg, jidx, jlim) in zip(plan, jplan):
        assert g == jg and np.array_equal(idx, jidx) and np.array_equal(lim, jlim)

    ref = np.asarray(jf.filter_static_buckets(jnp.asarray(frames), jnp.asarray(cmin), plan)).astype(int)
    ours = tf.filter_static_buckets(torch.from_numpy(frames.astype(np.int32)), torch.from_numpy(cmin.astype(np.int32)),
                                    plan).numpy()
    # |diff| <= 1 at <= 5e-4 of the pixels (measured: 1 at 7 of 36,864): the
    # blur's sums run in another order (module docstring); the splats into
    # the bucketed grids are bitwise (below).
    diff = np.abs(ours - ref)
    assert diff.max() <= 1 and (diff > 0).mean() <= 5e-4

    for i in range(3):
        gd = tb.true_depth(cmin[i], cmax[i], tf.sigma_color)
        grid = tb.BilateralGrid.from_image_static(
            torch.from_numpy(frames[i].astype(np.int32)), int(cmin[i]), gd, tf.sigma_space, tf.sigma_color, gd)
        jgrid = jb.BilateralGrid.from_image_static(
            jnp.asarray(frames[i]), jnp.asarray(cmin[i]), gd, jf.sigma_space, jf.sigma_color, jnp.int32(gd))
        np.testing.assert_array_equal(grid.data_cm.numpy(), np.asarray(jgrid.data_cm))
        # Bucketed == the port's own per-frame filter_static at the frame's
        # true depth, bitwise (padding and batching change no bit).
        single = tf.filter_static(torch.from_numpy(frames[i].astype(np.int32)), int(cmin[i]), gd, gd)
        np.testing.assert_array_equal(ours[i], single.numpy())


def test_color_min_conventions_on_a_frame_with_holes(bloei_luma16):
    """from_image takes the minimum including holes; the bucket plan and its
    callers take the nonzero minimum, each as in the JAX package."""
    frames, cmin, cmax = _three_span_frames(bloei_luma16)
    frame = frames[2]
    assert frame.min() == 0 < cmin[2]
    grid = tb.BilateralGrid.from_image(torch.from_numpy(frame.astype(np.int32)), tb.BilateralFilter.sigma_space,
                                       tb.BilateralFilter.sigma_color, 16)
    jgrid = jb.BilateralGrid.from_image(jnp.asarray(frame), jb.BilateralFilter.sigma_space,
                                        jb.BilateralFilter.sigma_color, 16)
    assert grid.color_min == int(jgrid.color_min) == 0
    dmin, dmax = tb.nonzero_min_max(torch.from_numpy(frames.astype(np.int32)))
    np.testing.assert_array_equal(dmin.numpy(), cmin)
    np.testing.assert_array_equal(dmax.numpy(), cmax)
    host = series.bucket_plan(frames, tb.BilateralFilter(), quantum=16)
    jplan = jb.plan_depth_buckets(cmin, cmax, jb.BilateralFilter.sigma_color, quantum=16)
    assert [(g, i.tolist(), d.tolist()) for g, i, d in host] == [(g, i.tolist(), d.tolist()) for g, i, d in jplan]
    # The two conventions give different filters on a frame with holes.
    filt = tb.BilateralFilter(pad_depth_to=1)
    gd = tb.true_depth(cmin[2], cmax[2], filt.sigma_color)
    nonzero = filt.filter_static(torch.from_numpy(frame.astype(np.int32)), int(cmin[2]), gd, gd)
    with_holes = filt.filter(torch.from_numpy(frame.astype(np.int32)))
    assert not torch.equal(nonzero, with_holes)


def test_bucket_plan_must_cover_every_frame_once():
    good = [(16, np.array([0, 2]), np.array([9, 9])), (32, np.array([1]), np.array([20]))]
    tb.check_plan_coverage(good, 3)
    bad = {
        "missing": [(16, np.array([0]), np.array([9])), (32, np.array([1]), np.array([20]))],
        "twice": [(16, np.array([0, 1]), np.array([9, 9])), (32, np.array([1, 2]), np.array([20, 20]))],
        "outside": [(16, np.array([0, 1, 3]), np.array([9, 9, 9]))],
        "extra": [(16, np.array([0, 1, 2, 2]), np.array([9, 9, 9, 9]))],
    }
    for name, plan in bad.items():
        with pytest.raises(ValueError, match="exactly once"):
            tb.check_plan_coverage(plan, 3)
    images = torch.zeros((3, 8, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="exactly once"):
        tb.BilateralFilter().filter_static_buckets(images, torch.ones(3, dtype=torch.int32), bad["missing"])


def _deep_frames():
    """Three 64x96 frames with depth spans needing > 128 grid channels."""
    rng = np.random.default_rng(5)
    ys, xs = np.meshgrid(np.arange(64), np.arange(96), indexing="ij")
    out = []
    for k, (a, b) in enumerate(((60, 30), (45, 40), (70, 20))):
        d = 600 + a * xs + b * ys + rng.integers(0, 40, size=(64, 96))
        d[5 + k : 9 + k, 20:30] = 0
        out.append(d)
    return np.stack(out).astype(np.uint16)


def test_slice_plain_batched_at_depth_over_128_against_jax():
    """_slice_plain at B = 3, gd > 128, against JAX's _slice frame by frame
    (the JAX package never tested its batched slice at B >= 3 or gd > 128)."""
    frames = _deep_frames()
    filt = tb.BilateralFilter(pad_depth_to=1)
    cmin = np.where(frames > 0, frames, 65535).reshape(3, -1).min(axis=1)
    gd = max(tb.true_depth(cmin[i], frames[i].max(), filt.sigma_color) for i in range(3))
    assert gd > 128
    jgrids = [
        jb.BilateralGrid.from_image_static(jnp.asarray(frames[i]), jnp.asarray(cmin[i]), gd, filt.sigma_space,
                                           filt.sigma_color).convolve().normalize().data_cm
        for i in range(3)
    ]
    grids = torch.from_numpy(np.stack([np.asarray(g) for g in jgrids]))
    images = torch.from_numpy(frames.astype(np.int32))
    ours = tb._slice_plain(grids, images, torch.from_numpy(cmin.astype(np.int32)), filt.sigma_space, filt.sigma_color)
    for i in range(3):
        ref = np.asarray(jb._slice(jgrids[i], jnp.asarray(frames[i]), jnp.asarray(cmin[i]), filt.sigma_space,
                                   filt.sigma_color))
        # atol 2e-3, tests/test_bilateral.py's bound for the slice kernel
        # (XLA contracts the lerps into FMAs; measured below 1e-3).
        np.testing.assert_allclose(ours[i].numpy(), ref, atol=2e-3)
        # And the batch of three is each frame's batch of one, bitwise.
        one = tb._slice_plain(grids[i], images[i], int(cmin[i]), filt.sigma_space, filt.sigma_color)
        assert torch.equal(one, ours[i])


def test_normalize_slice_batched_at_depth_over_128():
    """The filter's slice (the kernel's form (b): normalize at each corner,
    cast into int32) at B = 3, gd > 128: bitwise ``_slice_plain`` of the
    normalized grids plus the cast, the numpy transcription of the kernel,
    and each frame's batch of one."""
    frames = _deep_frames()
    filt = tb.BilateralFilter(pad_depth_to=1)
    cmin = np.where(frames > 0, frames, 65535).reshape(3, -1).min(axis=1).astype(np.int32)
    limits = np.array([tb.true_depth(cmin[i], frames[i].max(), filt.sigma_color) for i in range(3)], np.int32)
    gd = int(limits.max())
    assert gd > 128
    images = torch.from_numpy(frames.astype(np.int32))
    grid = tb.BilateralGrid.from_image_static(images, torch.from_numpy(cmin), gd, filt.sigma_space, filt.sigma_color,
                                              torch.from_numpy(limits)).convolve()
    args = (images, torch.from_numpy(cmin), filt.sigma_space, filt.sigma_color)
    fused = tb._normalize_slice(grid.data_cm, *args)
    assert torch.equal(fused, tb._slice_plain(tb._normalize(grid.data_cm), *args).to(torch.int32))
    np.testing.assert_array_equal(
        fused.numpy(), _normalize_slice_by_pixels(grid.data_cm.numpy(), frames.astype(np.int32), cmin,
                                                  filt.sigma_space, filt.sigma_color))
    for i in range(3):
        one = tb._normalize_slice(grid.data_cm[i], images[i], int(cmin[i]), filt.sigma_space, filt.sigma_color)
        assert torch.equal(one, fused[i])
    assert torch.equal(fused, filt.filter_static_batched(images, torch.from_numpy(cmin), gd, torch.from_numpy(limits)))


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 64])
def test_accumulate_scan_against_jax(n):
    twists = np.random.default_rng(n).normal(0, 0.05, (n, 6)).astype(np.float32)
    rel = JaxTransform.exp(jnp.asarray(twists))
    rot, trans = np.array(rel.rotation), np.array(rel.translation)
    ref = jax_accumulate_scan(JaxTransform(jnp.asarray(rot), jnp.asarray(trans)))
    ours = accumulate_scan(Transform(torch.from_numpy(rot), torch.from_numpy(trans)))
    assert len(ours) == len(ref) == n + 1
    # The same combine tree as lax.associative_scan; the 3x3 products round
    # differently (XLA on the CPU contracts them into FMAs): atol 1e-6
    # (measured 3.6e-7 on R and 1.8e-7 on t at n = 64, bitwise up to n = 2).
    np.testing.assert_allclose(ours.camera_to_world.rotation.numpy(), np.asarray(ref.camera_to_world.rotation),
                               atol=1e-6)
    np.testing.assert_allclose(ours.camera_to_world.translation.numpy(),
                               np.asarray(ref.camera_to_world.translation), atol=1e-6)
    # And the sequential left fold it replaces.
    builder = TrajectoryBuilder(Transform.identity())
    for i in range(n):
        builder.accumulate(Transform(torch.from_numpy(rot[i]), torch.from_numpy(trans[i])))
    fold = builder.build().camera_to_world
    np.testing.assert_allclose(ours.camera_to_world.rotation.numpy(), fold.rotation.numpy(), atol=1e-5)
    np.testing.assert_allclose(ours.camera_to_world.translation.numpy(), fold.translation.numpy(), atol=1e-5)


@pytest.fixture(scope="module")
def synthetic():
    intr, colors, depths = _synthetic_sequence(4)
    return intr, CameraIntrinsics(**dataclasses.asdict(intr)), colors, depths


def test_build_pyramids_batched_against_jax(synthetic):
    intr, tintr, colors, depths = synthetic
    ref = jbatch.build_pyramids_batched(intr, 0.001, jnp.asarray(colors), jnp.asarray(depths), pyramid_levels=2)
    ours = tbatch.build_pyramids_batched(tintr, 0.001, torch.from_numpy(colors),
                                         torch.from_numpy(depths.astype(np.int32)), pyramid_levels=2)
    for level in range(2):
        assert ours[level].intrinsics == type(ours[level].intrinsics)(**dataclasses.asdict(ref[level].intrinsics))
        for name in FIELDS:  # bitwise, every field of every level (measured)
            np.testing.assert_array_equal(getattr(ours[level], name).numpy(), np.asarray(getattr(ref[level], name)),
                                          err_msg=f"level {level} {name}")
    # The batch is each frame's own build, bitwise.
    one = tbatch.build_pyramids_batched(tintr, 0.001, torch.from_numpy(colors[2]),
                                        torch.from_numpy(depths[2].astype(np.int32)), pyramid_levels=2)
    for level in range(2):
        for name in FIELDS:
            assert torch.equal(getattr(one[level], name), getattr(ours[level], name)[2])


def test_align_impl_batched_against_single_and_jax(synthetic):
    intr, tintr, colors, depths = synthetic
    jpyr = jbatch.build_pyramids_batched(intr, 0.001, jnp.asarray(colors), jnp.asarray(depths), pyramid_levels=1)[0]
    pyr = tbatch.build_pyramids_batched(tintr, 0.001, torch.from_numpy(colors),
                                        torch.from_numpy(depths.astype(np.int32)), pyramid_levels=1)[0]
    n = pyr.height * pyr.width

    def args(src, tgt, b):
        return (src.points.reshape(b, n, 3), src.mask.reshape(b, n), src.intensities.reshape(b, n),
                tgt.points.reshape(b, n, 3), tgt.mask.reshape(b, n), tgt.normals.reshape(b, n, 3), tgt.intensity_map)

    batch = args(pyr.frames(slice(1, None)), pyr.frames(slice(None, -1)), 3)
    pose, res = align_batched(Transform.identity((3,)), *batch, tintr, IcpParams(max_iterations=5))
    # B = 3 against each pair's own align_impl (its batch of one): bitwise
    # on the CPU, where every op of the loop is batch-invariant.
    for b in range(3):
        rot, trans, r = align_impl(torch.eye(3), torch.zeros(3), *(a[b] for a in batch), tintr,
                                   IcpParams(max_iterations=5))
        assert torch.equal(rot, pose.rotation[b]) and torch.equal(trans, pose.translation[b]) and torch.equal(r, res[b])
    jsrc, jtgt = jax.tree.map(lambda a: a[1:], jpyr), jax.tree.map(lambda a: a[:-1], jpyr)
    jpose, jres = jax_align_batched(JaxTransform.identity((3,)), *args(jsrc, jtgt, 3), intr,
                                    JaxIcpParams(max_iterations=5))
    # Against JAX align_batched: atol 1e-4 on R and t (measured 1.2e-7 and
    # 3.5e-6), residual rtol 1e-4 (measured 7.6e-8): the f64 solve against
    # JAX's refined f32 one, sums in another order.
    np.testing.assert_allclose(pose.rotation.numpy(), np.asarray(jpose.rotation), atol=1e-4)
    np.testing.assert_allclose(pose.translation.numpy(), np.asarray(jpose.translation), atol=1e-4)
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), rtol=1e-4)


def test_odometry_step_against_jax():
    intr, colors, depths = _synthetic_sequence(6)
    tintr = CameraIntrinsics(**dataclasses.asdict(intr))
    jparams = JaxMsIcpParams.repeat(2, JaxIcpParams(max_iterations=3))
    ours = tbatch.odometry_step(tintr, 0.001, colors, depths, MsIcpParams.repeat(2, IcpParams(max_iterations=3)),
                                pyramid_levels=2, device="cpu")
    assert len(ours) == 6
    rot, trans = ours.camera_to_world.rotation.numpy(), ours.camera_to_world.translation.numpy()

    # The stages of JAX's odometry_step, run eagerly: within 1e-4 (measured
    # 2.5e-6 on R, 8.1e-6 on t, elementwise on the accumulated poses).
    pyr = jbatch.build_pyramids_batched(intr, 0.001, jnp.asarray(colors), jnp.asarray(depths), pyramid_levels=2)
    rel = jbatch.multiscale_align_batched([jax.tree.map(lambda a: a[:-1], ri) for ri in pyr],
                                          [jax.tree.map(lambda a: a[1:], ri) for ri in pyr], jparams)
    staged = jax_accumulate_scan(rel).camera_to_world
    np.testing.assert_allclose(rot, np.asarray(staged.rotation), atol=1e-4)
    np.testing.assert_allclose(trans, np.asarray(staged.translation), atol=1e-4)

    # JAX's jitted odometry_step: 0.01 rad / 0.02 m per pose (measured 4.8e-3
    # rad and 1.3e-2 m, which is also how far the jitted step lies from its
    # own stages run eagerly: inside one jit XLA's fusions flip pyramid
    # picks). The JAX package's own sharded-vs-single bound is 0.5 deg / 1 cm.
    ref = jbatch.odometry_step(intr, 0.001, jnp.asarray(colors), jnp.asarray(depths), jparams, pyramid_levels=2)
    diff = ref.camera_to_world.inverse() @ JaxTransform(jnp.asarray(rot), jnp.asarray(trans))
    assert float(jnp.max(diff.angle())) < 0.01
    assert float(jnp.max(jnp.linalg.norm(diff.translation, axis=-1))) < 0.02

    # With the bucketed bilateral stage: the same as filtering first, then
    # the step without it, bitwise.
    filt = tb.BilateralFilter()
    filtered, plan = tbatch.filter_buckets(filt, torch.from_numpy(depths.astype(np.int32)))
    assert sum(len(idx) for _, idx, _ in plan) == 6
    params = MsIcpParams.repeat(2, IcpParams(max_iterations=3))
    on = tbatch.odometry_step(tintr, 0.001, colors, depths, params, 2, bilateral_filter=filt, device="cpu")
    again = tbatch.odometry_step(tintr, 0.001, colors, filtered, params, 2, device="cpu")
    assert torch.equal(on.camera_to_world.rotation, again.camera_to_world.rotation)
    assert torch.equal(on.camera_to_world.translation, again.camera_to_world.translation)


def test_real_series_recipes():
    """The series helpers pick the JAX package's frames: 65 frames, sample1
    forward, back, then wrapped; the mixed series crosses both fixtures."""
    real = series.real_frames()
    assert len(real) == 65 and real.colors.shape == (65, 480, 640, 3) and real.depths.shape == (65, 480, 640)
    assert [i for _, i in real.frames] == list(range(31)) + list(range(29, -1, -1)) + [0, 1, 2, 3]
    assert real.true_pairs().sum() == 63  # all but the pair that meets frame 0 again
    mixed = series.mixed_frames()
    names = [name for name, _ in mixed.frames]
    assert names == ["sample1"] * 31 + ["sample2"] * 29 + ["sample1"] * 5
    assert set(np.unique(mixed.depth_scales).tolist()) == {float(np.float32(0.001)), float(np.float32(0.0002))}
    gt = real.relative_ground_truth()
    assert gt.rotation.shape == (64, 3, 3)
