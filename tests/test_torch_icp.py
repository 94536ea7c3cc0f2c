"""Image ICP of the PyTorch port against the JAX package.

Both packages get identical pyramids: the JAX package builds them and
``align3d_torch.convert`` carries them over, so the comparison is not
blurred by preprocessing differences. On the CPU the port's fused GN step
runs its plain twin (``icp_step`` + ``GNSystem.from_residuals``); the CUDA
kernel is held against that twin on the card (test_torch_kernels_cuda.py,
chip_smoke.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_tpu.camera import CameraIntrinsics as JaxIntrinsics
from align3d_tpu.icp.image_icp import align_impl as jax_align
from align3d_tpu.icp.image_icp import align_impl_pallas_v4 as jax_align_v4
from align3d_tpu.icp.image_icp import icp_step as jax_icp_step
from align3d_tpu.icp.params import IcpParams as JaxIcpParams
from align3d_tpu.icp.params import MsIcpParams as JaxMsIcpParams
from align3d_tpu.ops.target_pack import pack_geometry as jax_pack_geometry
from align3d_tpu.ops.target_pack import pack_intensity_taps as jax_pack_taps
from align3d_tpu.range_image import build_pyramid_impl as jax_build
from align3d_tpu.se3 import Transform as JaxTransform

from align3d_torch import _kernels, convert
from align3d_torch.icp.image_icp import ImageIcp, align_impl, icp_step
from align3d_torch.icp.params import IcpParams, MsIcpParams
from align3d_torch.metrics import TransformMetrics
from align3d_torch.ops import icp_fused
from align3d_torch.ops.target_pack import pack_geometry, pack_intensity_taps
from align3d_torch.se3 import Transform

# A pose a few frames of motion away from identity, so every gate is active.
TWIST = np.asarray([0.02, -0.01, 0.006, 0.004, -0.008, 0.002], np.float32)


def _to_torch(ri):
    return convert.range_image_from_numpy(
        *(np.asarray(getattr(ri, k)) for k in ("points", "mask", "normals", "colors", "intensities", "intensity_map")),
        dataclasses.asdict(ri.intrinsics), device="cpu",
    )


@pytest.fixture(scope="module")
def sample2_pyramids(sample2_dataset):
    """Frames 0 (target) and 1 (source) of sample2, as tests/test_icp.py."""

    def build(i):
        f = sample2_dataset.get(i)
        return jax_build(
            True, True, 3, 1.0, f.camera, float(f.image.depth_scale),
            jnp.asarray(f.image.color), jnp.asarray(f.image.depth),
        )

    jax_pyr = [build(0), build(1)]
    gt = sample2_dataset.trajectory().get_relative_transform(1, 0)
    return jax_pyr, [[_to_torch(ri) for ri in pyr] for pyr in jax_pyr], gt


def _flat(ri):
    n = ri.height * ri.width
    return ri.points.reshape(n, 3), ri.mask.reshape(n), ri.intensities.reshape(n)


@pytest.mark.parametrize("engine", ["pallas", "pallas_v4"])
def test_params_carry_over_from_jax(engine):
    """Every field comes over unchanged, the banded engines' band radius
    too: radius 2 at the coarsest level, 1 on the finer ones."""
    jax_ms = JaxMsIcpParams.default_tpu(engine)
    ours = convert.ms_icp_params_from_dicts([dataclasses.asdict(p) for p in jax_ms])
    assert ours == MsIcpParams.default_tpu(engine)
    assert [p.band_radius for p in ours] == [p.band_radius for p in jax_ms] == [1, 1, 2]


@pytest.mark.parametrize("huber", [None, 0.004])
@pytest.mark.parametrize("level", [0, 2])
def test_icp_step_matches_jax(sample2_pyramids, level, huber):
    (jt, js), (tt, ts), _ = sample2_pyramids
    jtgt, jsrc, ttgt, tsrc = jt[level], js[level], tt[level], ts[level]
    h, w = jtgt.height, jtgt.width
    jax_ms = JaxMsIcpParams.default().customize(lambda i, p: p.replace(huber_delta=huber))
    jparams = jax_ms[level]
    params = convert.ms_icp_params_from_dicts([dataclasses.asdict(p) for p in jax_ms])[level]
    jpose = JaxTransform.exp(jnp.asarray(TWIST))
    ref = jax_icp_step(
        jpose, *_flat(jsrc), jax_pack_geometry(jtgt.points, jtgt.normals, jtgt.mask),
        jax_pack_taps(jtgt.intensity_map), h, w, jtgt.intrinsics, jparams,
    )
    pose = convert.transform_from_numpy(np.asarray(jpose.rotation), np.asarray(jpose.translation), device="cpu")
    ours = icp_step(
        pose, *_flat(tsrc), pack_geometry(ttgt.points, ttgt.normals, ttgt.mask),
        pack_intensity_taps(ttgt.intensity_map), h, w, ttgt.intrinsics, params,
    )
    valid = int(tsrc.mask.sum())
    for r, o in zip(ref, ours):
        # Count equal or within 0.01% of the valid pixels (measured: equal
        # gate counts; the Huber weight sums differ by 7.8e-3 of 107784).
        assert abs(float(o.count) - float(r.count)) <= 1e-4 * valid
        # H and g within 1e-4 x max|entry|, sum w r^2 within rtol 1e-4
        # (measured at most 3.2e-6 on H, 8.1e-6 on g, 3.4e-7 on sum w r^2;
        # g is a sum with cancellation, added in another order).
        hs, gs = np.asarray(r.hessian), np.asarray(r.gradient)
        np.testing.assert_allclose(o.hessian.numpy(), hs, rtol=0, atol=1e-4 * np.abs(hs).max())
        np.testing.assert_allclose(o.gradient.numpy(), gs, rtol=0, atol=1e-4 * np.abs(gs).max())
        np.testing.assert_allclose(float(o.squared_residual_sum), float(r.squared_residual_sum), rtol=1e-4)


def test_fused_step_plain_twin_layout(sample2_pyramids):
    """On the CPU icp_step_fused is the plain twin, laid out as the kernel's
    two augmented 8x8 blocks."""
    _, (tt, ts), _ = sample2_pyramids
    tgt, src = tt[2], ts[2]
    h, w = tgt.height, tgt.width
    params = IcpParams()
    pose = Transform.exp(torch.from_numpy(TWIST))
    pts, mask, inten = _flat(src)
    geo = pack_geometry(tgt.points, tgt.normals, tgt.mask)
    launches = _kernels.launches()
    # The fused step takes the bordered intensity map; the plain step its tap pack.
    aug = icp_fused.icp_step_fused(
        pose.rotation[None], pose.translation[None], pts[None], mask[None].to(torch.uint8), inten[None],
        geo[None], tgt.intensity_map[None], h, w, tgt.intrinsics, params,
    )
    assert _kernels.launches() == launches  # no kernel on the CPU
    taps = pack_intensity_taps(tgt.intensity_map)
    geom, color = icp_step(pose, pts, mask, inten, geo, taps, h, w, tgt.intrinsics, params)
    for block, sys in zip(aug[0], (geom, color)):
        np.testing.assert_array_equal(block[:6, :6].numpy(), sys.hessian.numpy())
        np.testing.assert_array_equal(block[:6, 6].numpy(), sys.gradient.numpy())
        np.testing.assert_array_equal(block[6, :6].numpy(), sys.gradient.numpy())
        assert float(block[6, 6]) == float(sys.squared_residual_sum)
        assert float(block[7, 7]) == float(sys.count)


@pytest.mark.parametrize("huber", [None, 0.004])
@pytest.mark.parametrize("level", [0, 2])
def test_fused_step_on_intensity_map_matches_jax(sample2_pyramids, level, huber):
    """icp_step_fused on the bordered intensity map (the kernel's inputs, run
    by the plain twin on the CPU) against JAX's icp_step on its tap pack,
    within the tolerances of test_icp_step_matches_jax."""
    (jt, js), (tt, ts), _ = sample2_pyramids
    jtgt, jsrc, ttgt, tsrc = jt[level], js[level], tt[level], ts[level]
    h, w = jtgt.height, jtgt.width
    jax_ms = JaxMsIcpParams.default().customize(lambda i, p: p.replace(huber_delta=huber))
    params = convert.ms_icp_params_from_dicts([dataclasses.asdict(p) for p in jax_ms])[level]
    jpose = JaxTransform.exp(jnp.asarray(TWIST))
    ref = jax_icp_step(
        jpose, *_flat(jsrc), jax_pack_geometry(jtgt.points, jtgt.normals, jtgt.mask),
        jax_pack_taps(jtgt.intensity_map), h, w, jtgt.intrinsics, jax_ms[level],
    )
    pose = convert.transform_from_numpy(np.asarray(jpose.rotation), np.asarray(jpose.translation), device="cpu")
    pts, mask, inten = _flat(tsrc)
    aug = icp_fused.icp_step_fused(
        pose.rotation[None], pose.translation[None], pts[None], mask[None].to(torch.uint8), inten[None],
        pack_geometry(ttgt.points, ttgt.normals, ttgt.mask)[None], ttgt.intensity_map[None], h, w,
        ttgt.intrinsics, params,
    )[0]
    valid = int(tsrc.mask.sum())
    for r, block in zip(ref, aug):
        hs, gs = np.asarray(r.hessian), np.asarray(r.gradient)
        assert abs(float(block[7, 7]) - float(r.count)) <= 1e-4 * valid
        np.testing.assert_allclose(block[:6, :6].numpy(), hs, rtol=0, atol=1e-4 * np.abs(hs).max())
        np.testing.assert_allclose(block[:6, 6].numpy(), gs, rtol=0, atol=1e-4 * np.abs(gs).max())
        np.testing.assert_allclose(float(block[6, 6]), float(r.squared_residual_sum), rtol=1e-4)


@pytest.mark.parametrize("h, w", [(1, 1), (5, 7), (48, 64)])
def test_map_addressed_taps_equal_pack_rows(h, w):
    """K1 reads tap (dv, du) of base pixel (v0, u0) at flat index
    (v0 + dv) * (W + 2) + u0 + du of the pair's bordered map: bitwise the
    rows pack_intensity_taps builds, at every base pixel including the last
    row and column (the zero lanes 9-11 are not read)."""
    rng = np.random.default_rng(h * 100 + w)
    imap = torch.from_numpy(rng.uniform(0.0, 1.0, (3, h + 2, w + 2)).astype(np.float32))
    taps = pack_intensity_taps(imap)
    v0, u0 = (t.reshape(-1) for t in torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij"))
    flat = imap.reshape(3, -1)
    for dv in range(3):
        for du in range(3):
            assert torch.equal(flat[:, (v0 + dv) * (w + 2) + u0 + du], taps[..., dv * 3 + du])
    assert not taps[..., 9:].any()


def _align_args(tgt, src):
    n = tgt.height * tgt.width
    return (
        src.points.reshape(n, 3), src.mask.reshape(n), src.intensities.reshape(n),
        tgt.points.reshape(n, 3), tgt.mask.reshape(n), tgt.normals.reshape(n, 3), tgt.intensity_map,
    )


@pytest.mark.parametrize("huber", [None, 0.01])
def test_align_matches_jax(sample2_pyramids, huber):
    (jt, js), (tt, ts), gt = sample2_pyramids
    jparams = JaxIcpParams(max_iterations=5, huber_delta=huber)
    ref_r, ref_t, ref_res = jax_align(jnp.eye(3), jnp.zeros(3), *_align_args(jt[0], js[0]), jt[0].intrinsics, jparams)
    rot, trans, res = align_impl(
        torch.eye(3), torch.zeros(3), *_align_args(tt[0], ts[0]), tt[0].intrinsics,
        convert.icp_params_from_dict(dataclasses.asdict(jparams)),
    )
    # Pose atol 1e-4 (measured 6.5e-8 on R, 2.9e-7 on t without Huber;
    # 9.1e-8 / 3.7e-7 with it).
    np.testing.assert_allclose(rot.numpy(), np.asarray(ref_r), atol=1e-4)
    np.testing.assert_allclose(trans.numpy(), np.asarray(ref_t), atol=1e-4)
    np.testing.assert_allclose(float(res), float(ref_res), rtol=1e-3)
    # And the reference accuracy bar on real data (tests/test_icp.py).
    gt_t = convert.transform_from_numpy(np.asarray(gt.rotation), np.asarray(gt.translation), device="cpu")
    assert float(TransformMetrics.new(Transform(rot, trans), gt_t).angle) < 0.01


def test_image_icp_identity_on_same_frame(sample2_pyramids):
    _, (tt, _), _ = sample2_pyramids
    icp = ImageIcp(IcpParams(max_iterations=3), tt[0])
    actual = icp.align(tt[0])
    assert float(actual.angle()) < 1e-3
    assert float(torch.linalg.norm(actual.translation)) < 1e-3
    assert icp.last_residual is not None


def _pair(h, w, seed=0):
    """tests/test_icp_pallas_v4.py's synthetic pair, rebuilt with its seed."""
    rng = np.random.default_rng(seed)
    intr = JaxIntrinsics(fx=0.9 * w, fy=0.9 * w, cx=w / 2 - 0.5, cy=h / 2 - 0.5, width=w, height=h)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    tex = rng.uniform(30, 220, size=(h, w + 8, 3)).astype(np.uint8)
    d0 = (2000 + 3 * xs + 2 * ys + rng.integers(0, 5, (h, w))).astype(np.uint16)
    d1 = (2000 + 3 * (xs + 1) + 2 * ys + rng.integers(0, 5, (h, w))).astype(np.uint16)
    d0[5:9, 10:20] = 0
    target = jax_build(True, True, 1, 1.0, intr, 0.001, jnp.asarray(tex[:, :w]), jnp.asarray(d0))[0]
    source = jax_build(True, True, 1, 1.0, intr, 0.001, jnp.asarray(tex[:, 1 : w + 1]), jnp.asarray(d1))[0]
    return intr, target, source


@pytest.mark.parametrize("huber", [None, 0.01])
def test_align_within_pallas_v4_bounds(huber):
    """The TPU v4 engine (interpret mode) and the port land on the same pose
    within v4's own bound against the exact engine
    (tests/test_icp_pallas_v4.py:130-154, atol 4e-3; measured 9.7e-4 on R,
    2.1e-3 on t: v4 associates inside a band and quantizes normals to bf16)."""
    h, w = 32, 128
    intr, target, source = _pair(h, w)
    jparams = JaxIcpParams(max_iterations=3, huber_delta=huber)
    ref_r, ref_t, _ = jax_align_v4(jnp.eye(3), jnp.zeros(3), *_align_args(target, source), intr, jparams, interpret=True)
    rot, trans, _ = align_impl(
        torch.eye(3), torch.zeros(3), *_align_args(_to_torch(target), _to_torch(source)),
        _to_torch(target).intrinsics, convert.icp_params_from_dict(dataclasses.asdict(jparams)),
    )
    np.testing.assert_allclose(rot.numpy(), np.asarray(ref_r), atol=4e-3)
    np.testing.assert_allclose(trans.numpy(), np.asarray(ref_t), atol=4e-3)
