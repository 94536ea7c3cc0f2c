"""The banded ICP engines of the port (``engine="pallas"`` / ``"pallas_v4"``,
kernels K7 and K8) against the JAX package's Pallas engines.

JAX runs its kernels with ``interpret=True``, as its own tests do; the port
runs the kernels' plain twins (on the CPU a wrapper takes its twin; the
kernels are held against the twins on the card in
``test_torch_kernels_cuda.py``). Both get the same inputs: the JAX package
builds the pyramids and ``align3d_torch.convert`` carries them over. The
pairs are ``tests/test_icp_pallas_v4.py::_pair``'s recipe at h = 40-48 and
w = 300-384, so there are two or three lane groups and the window anchoring,
its clamping and the padding rows and lanes all take part.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_tpu.camera import CameraIntrinsics as JaxIntrinsics
from align3d_tpu.icp import image_icp as jii
from align3d_tpu.icp.multiscale import MultiscaleAlign as JaxMultiscaleAlign
from align3d_tpu.icp.params import IcpParams as JaxIcpParams
from align3d_tpu.icp.params import MsIcpParams as JaxMsIcpParams
from align3d_tpu.ops import icp_pallas_v3 as j3
from align3d_tpu.ops import icp_pallas_v4 as j4
from align3d_tpu.ops.target_pack import pack_geometry as jax_pack_geometry
from align3d_tpu.ops.target_pack import pack_intensity_taps as jax_pack_taps
from align3d_tpu.range_image import build_pyramid_impl as jax_build
from align3d_tpu.se3 import Transform as JaxTransform

from align3d_torch import convert
from align3d_torch.camera import CameraIntrinsics
from align3d_torch.icp import image_icp as tii
from align3d_torch.icp.multiscale import MultiscaleAlign
from align3d_torch.icp.params import MsIcpParams
from align3d_torch.ops import icp_pallas_v3 as t3
from align3d_torch.ops import icp_pallas_v4 as t4
from align3d_torch.parallel import batch as tbatch

# A pose a few frames of motion away from identity, so every gate is active.
TWIST = [0.01, -0.02, 0.01, 0.01, -0.02, 0.005]
# A roll of 0.08 rad about the optical axis: across a 128-lane group the rows
# move by ~10, far beyond a band of 2R + 1 = 5 rows.
BEYOND_BAND = [0.0, 0.0, 0.0, 0.0, 0.0, 0.08]
ENGINES = {"pallas": (j3, t3), "pallas_v4": (j4, t4)}


def _frames(h, w, seed=0):
    """tests/test_icp_pallas_v4.py's synthetic pair (its seed and recipe):
    (intrinsics, colours (2, H, W, 3), depths (2, H, W)), target first."""
    rng = np.random.default_rng(seed)
    intr = JaxIntrinsics(fx=0.9 * w, fy=0.9 * w, cx=w / 2 - 0.5, cy=h / 2 - 0.5, width=w, height=h)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    tex = rng.uniform(30, 220, size=(h, w + 8, 3)).astype(np.uint8)
    d0 = (2000 + 3 * xs + 2 * ys + rng.integers(0, 5, (h, w))).astype(np.uint16)
    d1 = (2000 + 3 * (xs + 1) + 2 * ys + rng.integers(0, 5, (h, w))).astype(np.uint16)
    d0[5:9, 10:20] = 0
    return intr, np.stack([tex[:, :w], tex[:, 1 : w + 1]]), np.stack([d0, d1])


def _pair(h, w, levels=1, seed=0):
    """:func:`_frames` as ``levels``-level pyramids: the JAX package's
    (target, source) and the port's copies."""
    intr, colors, depths = _frames(h, w, seed)
    target, source = (jax_build(True, True, levels, 1.0, intr, 0.001, jnp.asarray(c), jnp.asarray(d))
                      for c, d in zip(colors, depths))
    return target, source, [_to_torch(ri) for ri in target], [_to_torch(ri) for ri in source]


def _to_torch(ri):
    return convert.range_image_from_numpy(
        *(np.asarray(getattr(ri, k)) for k in ("points", "mask", "normals", "colors", "intensities", "intensity_map")),
        dataclasses.asdict(ri.intrinsics), device="cpu",
    )


@pytest.fixture(scope="module", params=[(48, 384), (40, 300)], ids=["48x384", "40x300"])
def pair(request):
    target, source, tt, ts = _pair(*request.param)
    return target[0], source[0], tt[0], ts[0]


def _pose(twist):
    jpose = JaxTransform.exp(jnp.asarray(twist, jnp.float32))
    return jpose, torch.from_numpy(np.asarray(jpose.rotation)), torch.from_numpy(np.asarray(jpose.translation))


def _bits(a):
    return np.asarray(a).view(np.int32) if np.asarray(a).dtype == np.float32 else np.asarray(a)


def _equal(ref, ours):
    for r, o in zip(ref, ours):
        np.testing.assert_array_equal(_bits(o.numpy()), _bits(r))


def _packs(jsrc, jtgt, src, tgt, k):
    (jk, tk) = k
    jsp = j3.pack_source(jsrc.points, jsrc.mask, jsrc.intensities)
    jtp = jk.pack_target(jtgt.points, jtgt.normals, jtgt.mask, jtgt.intensity_map)
    sp = t3.pack_source(src.points, src.mask, src.intensities)
    tp = tk.pack_target(tgt.points, tgt.normals, tgt.mask, tgt.intensity_map)
    return jsp, jtp, sp, tp


@pytest.fixture(scope="module")
def packs(pair):
    """:func:`_packs` of ``pair`` for each engine: (JAX's source and target
    packs, the port's)."""
    return {engine: _packs(*pair, k) for engine, k in ENGINES.items()}


@pytest.mark.parametrize("engine", ["pallas", "pallas_v4"])
def test_packs_bitwise(packs, engine):
    """Source pack and the v3 float32 / v4 int32 target packs: bitwise."""
    jsp, jtp, sp, tp = packs[engine]
    assert tp.dtype == (torch.float32 if engine == "pallas" else torch.int32)
    _equal([jsp, jtp], [sp, tp])


def test_band_prediction_bitwise(pair, packs):
    """predict_bases (dense, strided), source_centroids (XLA's sum order),
    predict_bases_centroid, the kernel's displacement stats and
    bases_from_stats: the JAX package's bits."""
    jsrc, jtgt, src, tgt = pair
    jsp, jtp, sp, tp = packs["pallas"]
    jpose, rot, trans = _pose(TWIST)
    h, w = tgt.height, tgt.width
    hp = sp.shape[0] * t3.CHUNK
    stride = 2 if w % 128 else 1  # the strided projection at one of the two sizes
    _equal(j3.predict_bases(jpose.rotation, jpose.translation, jsp, jtgt.intrinsics, h, stride),
           t3.predict_bases(rot, trans, sp, tgt.intrinsics, h, stride))
    jc, tc = j3.source_centroids(jsp, jtgt.intrinsics), t3.source_centroids(sp, tgt.intrinsics)
    _equal(jc, tc)
    jb = j3.predict_bases_centroid(jpose.rotation, jpose.translation, jc, jtgt.intrinsics, hp)
    tb = t3.predict_bases_centroid(rot, trans, tc, tgt.intrinsics, hp)
    _equal(jb, tb)
    pt = (0.5, math.pi / 10, 2.75, 2)
    *_, jstats = j3.icp_step_pallas(jpose.rotation, jpose.translation, *jb, jsp, jtp, jtgt.intrinsics, h, w, pt,
                                    interpret=True)
    *_, stats = t3.icp_step_pallas(rot, trans, *tb, sp, tp, tgt.intrinsics, h, w, pt)
    assert stats.shape == (sp.shape[0], 3, sp.shape[2] // t3.CHUNK, 8, 128)
    _equal([jstats], [stats])
    _equal(j3.bases_from_stats(jstats, jb[1], jb[2], hp), t3.bases_from_stats(stats, tb[1], tb[2], hp))


@pytest.mark.parametrize("huber", [None, 0.01])
@pytest.mark.parametrize("engine", ["pallas", "pallas_v4"])
def test_step_matches_jax(pair, packs, engine, huber):
    """One banded step at radius 2: gate counts equal (Huber weight sums
    within rtol 1e-4); H within 1e-4 x max|H|, sum w r^2 within rtol 1e-4;
    the geometric g within 1e-4 x max|g|.

    The colour g is a sum with heavy cancellation (max|g| ~ 800 against H
    entries ~ 1e7), and JAX's per-pixel colour terms are not the port's to
    the last bit (XLA on the CPU fuses the kernel's elementwise chains; the
    port's own float32 sums are within 4e-7 of a float64 sum of its stack):
    measured at most 1.2e-4 (v3) and 2.8e-4 (v4, whose bf16 rounding turns
    those last-bit differences into whole bf16 steps) of max|g| over the
    sizes here. So it is held on its Cauchy-Schwarz scale, |g_k| <=
    sqrt(H_kk sum w r^2): within 1e-4 x sqrt(max H_kk x sum w r^2)
    (measured at most 4e-6 of it). A known difference (ROADMAP)."""
    jsrc, jtgt, src, tgt = pair
    jk, tk = ENGINES[engine]
    jsp, jtp, sp, tp = packs[engine]
    jpose, rot, trans = _pose(TWIST)
    h, w = tgt.height, tgt.width
    hp = sp.shape[0] * t3.CHUNK
    pt = (0.5, math.pi / 10, 2.75, 2, 0.0 if huber is None else huber)
    jb = j3.predict_bases_centroid(jpose.rotation, jpose.translation, j3.source_centroids(jsp, jtgt.intrinsics),
                                   jtgt.intrinsics, hp)
    tb = t3.predict_bases_centroid(rot, trans, t3.source_centroids(sp, tgt.intrinsics), tgt.intrinsics, hp)
    ref = jk.icp_step_pallas(jpose.rotation, jpose.translation, *jb, jsp, jtp, jtgt.intrinsics, h, w, pt,
                             interpret=True)
    ours = tk.icp_step_pallas(rot, trans, *tb, sp, tp, tgt.intrinsics, h, w, pt)
    for system, r, o in zip(("geometric", "colour"), ref[:2], ours[:2]):
        r, o = np.asarray(r), o.numpy()
        if huber is None:
            assert o[7, 7] == r[7, 7]
        else:
            np.testing.assert_allclose(o[7, 7], r[7, 7], rtol=1e-4)
        np.testing.assert_allclose(o[:6, :6], r[:6, :6], rtol=0, atol=1e-4 * np.abs(r[:6, :6]).max())
        np.testing.assert_allclose(o[6, 6], r[6, 6], rtol=1e-4)
        g_scale = np.abs(r[:6, 6]).max() if system == "geometric" else np.sqrt(np.diag(r)[:6].max() * r[6, 6])
        np.testing.assert_allclose(o[:6, 6], r[:6, 6], rtol=0, atol=1e-4 * g_scale)


def test_pair_beyond_the_band_drops_what_jax_drops(pair, packs):
    """The fault the banded engines bring: at a roll the band cannot follow,
    JAX's banded count is below the exact engine's count, and the port's
    banded count is JAX's, engine by engine."""
    jsrc, jtgt, src, tgt = pair
    jpose, rot, trans = _pose(BEYOND_BAND)
    h, w = tgt.height, tgt.width
    n = h * w
    params = JaxIcpParams(max_distance=0.5, max_normal_angle=math.pi / 10, max_color_distance=2.75)
    exact, _ = jii.icp_step(jpose, jsrc.points.reshape(n, 3), jsrc.mask.reshape(n), jsrc.intensities.reshape(n),
                            jax_pack_geometry(jtgt.points, jtgt.normals, jtgt.mask), jax_pack_taps(jtgt.intensity_map),
                            h, w, jtgt.intrinsics, params)
    pt = (params.max_distance, params.max_normal_angle, params.max_color_distance, 2, 0.0)
    for engine, (jk, tk) in ENGINES.items():
        jsp, jtp, sp, tp = packs[engine]
        hp = sp.shape[0] * t3.CHUNK
        jb = j3.predict_bases_centroid(jpose.rotation, jpose.translation, j3.source_centroids(jsp, jtgt.intrinsics),
                                       jtgt.intrinsics, hp)
        tb = t3.predict_bases_centroid(rot, trans, t3.source_centroids(sp, tgt.intrinsics), tgt.intrinsics, hp)
        ref = jk.icp_step_pallas(jpose.rotation, jpose.translation, *jb, jsp, jtp, jtgt.intrinsics, h, w, pt,
                                 interpret=True)
        ours = tk.icp_step_pallas(rot, trans, *tb, sp, tp, tgt.intrinsics, h, w, pt)
        assert float(ref[0][7, 7]) < 0.9 * float(exact.count), engine
        assert float(ours[0][7, 7]) == float(ref[0][7, 7]), engine


def _flat(ri, b=None):
    n = ri.height * ri.width
    lead = () if b is None else (b,)
    return (ri.points.reshape(*lead, n, 3), ri.mask.reshape(*lead, n), ri.intensities.reshape(*lead, n))


def _align_args(tgt, src, b=None):
    n = tgt.height * tgt.width
    lead = () if b is None else (b,)
    return (*_flat(src, b), tgt.points.reshape(*lead, n, 3), tgt.mask.reshape(*lead, n),
            tgt.normals.reshape(*lead, n, 3), tgt.intensity_map)


# Poses against JAX's (rad / m, elementwise on R and t). v3: 1e-4 (measured
# at most 8.8e-6 / 2.1e-5 on seeds 0-2 at 32x256). v4: 2e-4 / 5e-4 (measured
# 5.3e-5 / 1.3e-4 on seed 0, 1.2e-4 / 2.8e-4 on seeds 1-2: 4-8x tighter than
# the 9.7e-4 / 2.1e-3 that separate the exact engine from JAX's v4,
# test_torch_icp.py::test_align_within_pallas_v4_bounds). v4 rounds its
# stack to bf16, so a last-bit difference in a pixel's float32 terms (XLA
# fuses the kernel's elementwise chains on the CPU; contracting the port's
# own pose product into FMAs moves its colour g by 1.3e-4 of max|g|) becomes
# a whole bf16 step of that term. A known difference (ROADMAP).
ALIGN_ATOL = {"pallas": (1e-4, 1e-4), "pallas_v4": (2e-4, 5e-4)}


@pytest.fixture(scope="module")
def pairs_32x256():
    """:func:`_pair` at 32x256 (two lane groups), seeds 0 and 1."""
    return _pair(32, 256), _pair(32, 256, seed=1)


@pytest.mark.parametrize("engine", ["pallas", "pallas_v4"])
def test_align_matches_jax(pairs_32x256, engine):
    """align_impl_pallas_v3 / _v4, one pair and a batch of two (the pairs of
    seeds 0 and 1), 3 GN iterations at radius 2, at 32x256 (two lane
    groups): poses within ALIGN_ATOL of JAX's."""
    (jt, js, tt, ts), (jt1, js1, tt1, ts1) = pairs_32x256
    jparams = JaxIcpParams(max_iterations=3, band_radius=2, engine=engine)
    params = convert.icp_params_from_dict(dataclasses.asdict(jparams))
    atol_r, atol_t = ALIGN_ATOL[engine]
    single = {"pallas": (jii.align_impl_pallas_v3, tii.align_impl_pallas_v3),
              "pallas_v4": (jii.align_impl_pallas_v4, tii.align_impl_pallas_v4)}[engine]
    ref = single[0](jnp.eye(3), jnp.zeros(3), *_align_args(jt[0], js[0]), jt[0].intrinsics, jparams, interpret=True)
    ours = single[1](torch.eye(3), torch.zeros(3), *_align_args(tt[0], ts[0]), tt[0].intrinsics, params)
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]), atol=atol_r)
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(ref[1]), atol=atol_t)
    # ImageIcp's dispatch picks the same function.
    assert all(torch.equal(a, b) for a, b in zip(
        tii.align_dispatch(torch.eye(3), torch.zeros(3), *_align_args(tt[0], ts[0]), tt[0].intrinsics, params), ours))

    batched = {"pallas": (jii.align_impl_pallas_v3_batched, tii.align_impl_pallas_v3_batched),
               "pallas_v4": (jii.align_impl_pallas_v4_batched, tii.align_impl_pallas_v4_batched)}[engine]

    def stack2(pairs, stack):
        return [stack(parts) for parts in zip(*(_align_args(tgt[0], src[0]) for tgt, src in pairs))]

    ref = batched[0](jnp.stack([jnp.eye(3)] * 2), jnp.zeros((2, 3)), *stack2([(jt, js), (jt1, js1)], jnp.stack),
                     jt[0].intrinsics, jparams, interpret=True)
    got = batched[1](torch.eye(3).expand(2, 3, 3), torch.zeros(2, 3), *stack2([(tt, ts), (tt1, ts1)], torch.stack),
                     tt[0].intrinsics, params)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=atol_r)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=atol_t)
    # Pair 0 of the batch is the single align, bitwise (the CPU's ops are batch-invariant).
    assert torch.equal(got[0][0], ours[0]) and torch.equal(got[1][0], ours[1])


MS_SIZE = (72, 256)  # 3 levels, 72x256 -> 18x64: the coarsest band still holds its 16 + 2R rows


def _cut(ms):
    return ms.customize(lambda i, p: p.replace(max_iterations=1))


@pytest.fixture(scope="module")
def multiscale_jax():
    """JAX's MultiscaleAlign of the MS_SIZE pair under
    default_tpu("pallas", coarse_exact=...) at 1 GN iteration a level."""
    jt, js, tt, ts = _pair(*MS_SIZE, levels=3)
    ref = {ce: JaxMultiscaleAlign(_cut(JaxMsIcpParams.default_tpu("pallas", coarse_exact=ce)), jt).align(js)
           for ce in (False, True)}
    return ref, tt, ts


@pytest.mark.parametrize("coarse_exact", [False, True])
def test_multiscale_default_tpu_matches_jax(multiscale_jax, coarse_exact):
    """MultiscaleAlign(default_tpu("pallas", coarse_exact=...)): each level
    on its engine and band radius, the pose within 1e-4 of JAX's."""
    ref, tt, ts = multiscale_jax
    jparams = _cut(JaxMsIcpParams.default_tpu("pallas", coarse_exact=coarse_exact))
    params = _cut(MsIcpParams.default_tpu("pallas", coarse_exact=coarse_exact))
    assert params == convert.ms_icp_params_from_dicts([dataclasses.asdict(p) for p in jparams])
    assert params[2].engine == ("xla" if coarse_exact else "pallas") and params[2].band_radius == 2
    assert [p.engine for p in params][:2] == ["pallas", "pallas"] and params[0].band_radius == 1
    ours = MultiscaleAlign(params, tt).align(ts)
    np.testing.assert_allclose(ours.rotation.numpy(), np.asarray(ref[coarse_exact].rotation), atol=1e-4)
    np.testing.assert_allclose(ours.translation.numpy(), np.asarray(ref[coarse_exact].translation), atol=1e-4)


def test_odometry_step_banded_matches_jax(multiscale_jax):
    """odometry_step on the MS_SIZE pair's two frames (filter off) under
    default_tpu("pallas"): it builds the pyramids and aligns each level on
    its engine, and the second frame's pose is JAX's multiscale align of
    those pyramids (the stages of JAX's odometry_step), within 1e-4."""
    ref, _, _ = multiscale_jax
    intr, colors, depths = _frames(*MS_SIZE)
    traj = tbatch.odometry_step(CameraIntrinsics(**dataclasses.asdict(intr)), 0.001, colors, depths,
                                _cut(MsIcpParams.default_tpu("pallas")), device="cpu").camera_to_world
    np.testing.assert_allclose(traj.rotation[1].numpy(), np.asarray(ref[False].rotation), atol=1e-4)
    np.testing.assert_allclose(traj.translation[1].numpy(), np.asarray(ref[False].translation), atol=1e-4)


def test_unknown_engine_raises(pairs_32x256):
    _, _, tt, ts = pairs_32x256[0]
    params = MsIcpParams.default()[0].replace(engine="pallas_v5", max_iterations=1)
    with pytest.raises(ValueError, match="unknown ICP engine"):
        tii.align_dispatch(torch.eye(3), torch.zeros(3), *_align_args(tt[0], ts[0]), tt[0].intrinsics, params)
