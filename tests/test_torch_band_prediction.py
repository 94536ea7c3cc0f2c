"""The banded engines' band prediction at its edges: the port's plain twins of
K9 (``source_centroids_plain``) and K10 (``predict_bases_centroid_plain``)
against the JAX package's ``source_centroids`` / ``predict_bases_centroid``,
bitwise, where ``tests/test_torch_banded.py::test_band_prediction_bitwise``
does not reach; and the wrappers' routing on the CPU.

Each case is a synthetic source frame made with numpy (a slanted plane with
noise and texture from a seed), optionally edited, packed by both packages,
and a pose. The kernels are held
against these twins on the card in ``test_torch_kernels_cuda.py``.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_tpu.ops import icp_pallas_v3 as j3
from align3d_tpu.se3 import Transform as JaxTransform

from align3d_torch import _kernels
from align3d_torch.camera import CameraIntrinsics
from align3d_torch.ops import icp_pallas_v3 as t3

TWIST = [0.01, -0.02, 0.01, 0.01, -0.02, 0.005]  # translation, then rotation (test_torch_banded.py's)
DROP, LIFT = [0.0, -0.5, 0.0, 0.0, 0.0, 0.0], [0.0, 0.5, 0.0, 0.0, 0.0, 0.0]  # 0.5 m along -y / +y


@functools.lru_cache(maxsize=None)
def _source(h: int, w: int):
    """A source frame of (h, w) pixels: a slanted plane ~2 m away with depth
    noise and texture from seed 0 (``tests/test_icp_pallas_v4.py::_pair``'s
    second frame), back-projected through a pinhole in float32. Returns
    ((points, mask, intensities) in numpy, its JAX intrinsics)."""
    from align3d_tpu.camera import CameraIntrinsics as JaxIntrinsics

    rng = np.random.default_rng(0)
    intr = JaxIntrinsics(fx=0.9 * w, fy=0.9 * w, cx=w / 2 - 0.5, cy=h / 2 - 0.5, width=w, height=h)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
    z = (2.0 + 0.003 * (xs + 1) + 0.002 * ys + 0.001 * rng.integers(0, 5, (h, w))).astype(np.float32)
    points = np.stack([(xs - np.float32(intr.cx)) / np.float32(intr.fx) * z,
                       (ys - np.float32(intr.cy)) / np.float32(intr.fy) * z, z], axis=-1)
    intensities = rng.integers(30, 220, (h, w)).astype(np.uint8)
    return (points, np.ones((h, w), bool), intensities), intr


def _empty_groups(points, mask):
    mask[:, 128:256] = False  # group 1 empty in every chunk ...
    mask[16:32] = False  # ... and chunk 1 empty in every group


def _all_empty(points, mask):
    mask[:] = False


def _nan_masked(points, mask):
    mask[3, 5] = mask[20, 200] = False
    points[3, 5, 2] = np.nan
    points[20, 200] = np.nan


def _nan_valid(points, mask):
    mask[3, 5] = True
    points[3, 5, 2] = np.nan


def _to_origin(rotation, pbar, cnt):
    """The translation that takes the first non-empty (chunk, group)'s
    centroid to (0, 0, 0) exactly, in the twins' order of operations: that
    group's pz is 0 (its safe_z 1e-12), and its u, v are cx, cy."""
    c, g = np.argwhere(cnt > 0)[0]
    x = pbar[c, g]
    return -np.array([(rotation[i, 0] * x[0] + rotation[i, 1] * x[1]) + rotation[i, 2] * x[2] for i in range(3)],
                     dtype=np.float32)


# (h, w) of each level: 40x384 (G = 3, hp = 48), then the level-1 and
# level-2 shapes of a pyramid over it, 20x192 (G = 2) and 10x96 (G = 1, hp =
# 16 < 32).
LEVELS = [(40, 384), (20, 192), (10, 96)]
# name: (level, edit of the source, twist, crafted translation or None, check of the band starts or None)
CASES = {
    "empty_groups": (0, _empty_groups, TWIST, None, None),
    "all_empty": (0, _all_empty, TWIST, None, None),
    "pz_zero": (0, None, TWIST, _to_origin, None),
    "chunk_base_clipped_at_0": (0, None, DROP, None, lambda cb, hi: bool((cb[1:] == 0).any())),
    "chunk_base_clipped_at_hp_minus_32": (0, None, LIFT, None, lambda cb, hi: bool((cb[:-1] == hi).any())),
    "level1": (1, None, TWIST, None, None),
    "level2_ten_rows": (2, None, TWIST, None, lambda cb, hi: hi == 0 and bool((cb == 0).all())),
    "nan_z_masked": (0, _nan_masked, TWIST, None, None),
    "nan_z_valid": (0, _nan_valid, TWIST, None, None),
}


def _same(ref, ours, name):
    """NaN in the same places, every other element bitwise."""
    ref, ours = np.asarray(ref), ours.numpy()
    assert ref.shape == ours.shape and ref.dtype == ours.dtype, name
    nan = np.isnan(ref) if ref.dtype == np.float32 else np.zeros(ref.shape, bool)
    np.testing.assert_array_equal(np.isnan(ours) if ours.dtype == np.float32 else nan, nan, err_msg=name)
    bits = (lambda a: a.view(np.int32)) if ref.dtype == np.float32 else (lambda a: a)
    np.testing.assert_array_equal(bits(ours[~nan]), bits(ref[~nan]), err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_band_prediction_edges_bitwise(case):
    """Source pack, centroids and bases: the JAX package's bits (NaN in the
    same places). Empty groups give cnt 0 and bases 0 (a chunk of empty
    groups divides by 1); a centroid at pz == 0 projects through safe_z;
    the band starts clip at 0 and at hp - min(32, hp) (0 at level 2's 10
    rows, hp = 16 < 32); a NaN point under a zero mask packs as +0.0 (XLA makes a
    select of the product with the mask) and under a true mask carries NaN
    into pbar, whose bases convert NaN to 0 as XLA does."""
    level, edit, twist, crafted, check = CASES[case]
    (points, mask, intensities), jintr = _source(*LEVELS[level])
    points, mask, intensities = points.copy(), mask.copy(), intensities.copy()
    if edit is not None:
        edit(points, mask)
    intr = CameraIntrinsics(**dataclasses.asdict(jintr))
    jsp = j3.pack_source(jnp.asarray(points), jnp.asarray(mask), jnp.asarray(intensities))
    sp = t3.pack_source(torch.from_numpy(points), torch.from_numpy(mask), torch.from_numpy(intensities))
    _same(jsp, sp, "source pack")
    jc = j3.source_centroids(jsp, jintr)
    tc = t3.source_centroids_plain(sp[None], intr)
    for name, r, o in zip(("pbar", "rowbar", "colbar", "cnt"), jc, tc):
        _same(r, o[0], name)

    jpose = JaxTransform.exp(jnp.asarray(twist, jnp.float32))
    rotation = np.asarray(jpose.rotation)
    translation = np.asarray(jpose.translation)
    if crafted is not None:
        translation = crafted(rotation, np.asarray(jc[0]), np.asarray(jc[3]))
    hp = sp.shape[0] * t3.CHUNK
    jb = j3.predict_bases_centroid(jnp.asarray(rotation), jnp.asarray(translation), jc, jintr, hp)
    tb = t3.predict_bases_centroid_plain(torch.from_numpy(rotation)[None], torch.from_numpy(translation)[None], tc,
                                         intr, hp)
    for name, r, o in zip(("chunk_base", "dy_base", "dx_base"), jb, tb):
        _same(r, o[0], name)

    cnt, pbar = np.asarray(jc[3]), np.asarray(jc[0])
    if case in ("empty_groups", "all_empty"):
        assert (cnt == 0).any() and (np.asarray(jb[1])[cnt == 0] == 0).all()
    if case == "all_empty":
        assert (cnt == 0).all()
    if case == "pz_zero":
        c, g = np.argwhere(cnt > 0)[0]
        p = rotation @ pbar[c, g].astype(np.float64) + translation
        assert np.abs(p).max() < 1e-6  # the crafted centroid sits at the origin
    if case.startswith("nan_z"):
        assert np.isnan(pbar).any() == (case == "nan_z_valid")
    if check is not None:
        assert check(tb[0][0].numpy(), max(hp - min(32, hp), 0))


def test_band_prediction_routes_by_device():
    """On CPU tensors the wrappers run the twins and K9's and K10's counters
    do not move; a tensor on another device (meta) raises, as it would
    after a failed launch: nothing falls back."""
    (points, mask, intensities), jintr = _source(*LEVELS[0])
    intr = CameraIntrinsics(**dataclasses.asdict(jintr))
    sp = t3.pack_source(*(torch.from_numpy(a)[None] for a in (points, mask, intensities)))
    pose = JaxTransform.exp(jnp.asarray(TWIST, jnp.float32))
    rot, trans = torch.from_numpy(np.asarray(pose.rotation))[None], torch.from_numpy(np.asarray(pose.translation))[None]
    hp = sp.shape[1] * t3.CHUNK
    before = _kernels.launches()
    centroids = t3.source_centroids_batched(sp, intr)
    bases = t3.predict_bases_centroid_batched(rot, trans, centroids, intr, hp)
    assert _kernels.launches() == before
    assert all(torch.equal(a, b) for a, b in zip(centroids, t3.source_centroids_plain(sp, intr)))
    assert all(torch.equal(a, b) for a, b in zip(bases, t3.predict_bases_centroid_plain(rot, trans, centroids,
                                                                                          intr, hp)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        t3.source_centroids_batched(sp.to("meta"), intr)
    with pytest.raises(ValueError, match="cuda or cpu"):
        t3.predict_bases_centroid_batched(rot.to("meta"), trans.to("meta"), tuple(c.to("meta") for c in centroids),
                                          intr, hp)
    assert _kernels.launches() == before
