"""Projective RGB-D ICP, point-to-plane + photometric (port of ``align3d_tpu/icp/image_icp.py``).

Three engines, picked by ``IcpParams.engine`` as in the JAX package
(:func:`align_dispatch`, :class:`ImageIcp`, :func:`align_batched`):

* ``"xla"``: the exact association. :func:`icp_step`, the plain GN
  accumulation over all source pixels, lives beside its fused CUDA kernel K1
  in :mod:`align3d_torch.ops.icp_fused` and is re-exported here.
  :func:`align_impl_batched` runs the GN loop of B frame pairs at once: per
  iteration one fused step over all B pairs (one launch of K1 on the card),
  then the float64 6x6 solve, the SE(3) update and the best-residual select
  (one launch of K11), all on the device, with no wait for it.
  :func:`align_impl` is its batch of one.
* ``"pallas"`` and ``"pallas_v4"``: the banded association of the TPU
  engines (K7, :mod:`align3d_torch.ops.icp_pallas_v3`; K8,
  :mod:`align3d_torch.ops.icp_pallas_v4`). Each iteration re-predicts the
  bands from the current pose (one projected source centroid per 16-row
  chunk and 128-column group) and runs one kernel launch over all B pairs;
  the loop is the exact engine's.

On the card a level's whole align (its prepack too, where the caller hands
over unpacked levels) is one CUDA graph, captured at the level's first call
and replayed after (:mod:`align3d_torch.icp.level_graph`): one launch a
level, the same kernels, arguments and bits as the eager loop. On the CPU
the loop runs eagerly.

Reference semantics kept exactly (``src/icp/image_icp.rs``), as in the JAX
package:

* the target lookup at ``trunc(u + 0.5)`` with bounds and target-mask gates;
* the distance gate ``||q - p||^2 > max_distance^2`` rejects;
* the normal-angle gate compares the transformed source *point* with the
  target normal, ``|acos(p . n)|``, and a NaN angle passes (the banded
  engines compare ``p . n`` with ``f32(cos(angle))`` instead);
* the photometric term samples at clamped coordinates, with ``0.003921569``
  for 1/255 and the re-truncated +0.005 numeric gradient;
* the returned pose is the best-mean-squared-residual one, where the
  residual is read *before* an iteration's update but paired with the
  *updated* transform, and a tie keeps the earlier pose (strict ``<``).
"""

from __future__ import annotations

import torch

from align3d_torch.camera import CameraIntrinsics
from align3d_torch.icp import level_graph
from align3d_torch.icp.params import IcpParams
from align3d_torch.ops import icp_fused
from align3d_torch.ops import icp_pallas_v3 as k3
from align3d_torch.ops import icp_pallas_v4 as k4
from align3d_torch.ops.icp_fused import _f32, icp_step  # noqa: F401  (icp_step is re-exported)
from align3d_torch.ops.target_pack import pack_geometry
from align3d_torch.optim.gauss_newton import GNState, gn_update
from align3d_torch.range_image import RangeImage
from align3d_torch.se3 import Transform
from align3d_torch.utils import profiling


def prepack_batched(
    source_points: torch.Tensor,  # (B, N, 3)
    source_mask: torch.Tensor,  # (B, N)
    source_intensity: torch.Tensor,  # (B, N) u8
    target_points: torch.Tensor,  # (B, N, 3)
    target_mask: torch.Tensor,  # (B, N)
    target_normals: torch.Tensor,  # (B, N, 3)
    target_intensity_map: torch.Tensor,  # (B, H+2, W+2)
) -> tuple:
    """The pose-independent inputs of the exact step for B pairs (the
    exact engine's counterpart of :func:`prepack_v4_batched`): the sources as K1 reads them,
    with their ``uint8`` masks, the targets' geometry pack and their bordered
    intensity maps (K1 reads its taps there). Returns ``(points, mask,
    intensity, geo, intensity_map, h, w)``."""
    bsz = target_intensity_map.shape[0]
    h, w = target_intensity_map.shape[-2] - 2, target_intensity_map.shape[-1] - 2
    geo = pack_geometry(
        target_points.reshape(bsz, h, w, 3), target_normals.reshape(bsz, h, w, 3), target_mask.reshape(bsz, h, w)
    )
    return (
        source_points.reshape(bsz, h * w, 3).contiguous(),
        source_mask.reshape(bsz, h * w).to(torch.uint8),
        source_intensity.reshape(bsz, h * w).contiguous(),
        geo,
        target_intensity_map.to(torch.float32).contiguous(),
        h,
        w,
    )


def _gn_loop(step, initial_rotation, initial_translation, params: IcpParams):
    """The GN loop of B pairs: ``step(rot, trans)`` gives the (geometric,
    colour) 8x8 blocks, (B, 8, 8) each; returns (best_R, best_t,
    best_residual). Each iteration is a span ``gn.iter``, its step and
    solve spans ``gn.step`` and ``gn.solve``; the solve is
    :func:`~align3d_torch.optim.gauss_newton.gn_update` (the merge, the f64
    solve, the SE(3) update and the best-pose select: one launch of K11 on
    the card)."""
    weight, color_weight = _f32(params.weight), _f32(params.color_weight)
    state = GNState.start(initial_rotation, initial_translation)
    for _ in range(params.max_iterations):
        it = profiling.begin("gn.iter")
        span = profiling.begin("gn.step")
        blocks = step(state.rot, state.trans)
        profiling.end(span)
        span = profiling.begin("gn.solve")
        gn_update(*blocks, weight, color_weight, state)
        profiling.end(span)
        profiling.end(it)
    return state.best_rot, state.best_trans, state.best_res


def _level(fn, tensors: tuple, *consts):
    """One level's align, ``fn(*tensors, *consts)``: eager on the CPU; on
    the card through the level's CUDA graph (:mod:`level_graph`), keyed by
    ``fn``, the tensors' shapes and the constants."""
    if tensors[0].device.type == "cuda":
        return level_graph.run(fn, tensors, consts)
    return fn(*tensors, *consts)


def _exact_loop(initial_rotation, initial_translation, points, mask, intensity, geo, intensity_map, h: int, w: int,
                intrinsics: CameraIntrinsics, params: IcpParams):
    """The exact engine's GN loop on prepacked pairs, eager: one K1 and one
    K11 an iteration on the card."""

    def step(rot, trans):
        aug = icp_fused.icp_step_fused(rot, trans, points, mask, intensity, geo, intensity_map, h, w, intrinsics,
                                       params)
        return aug[:, 0], aug[:, 1]

    return _gn_loop(step, initial_rotation, initial_translation, params)


def align_impl_batched(
    initial_rotation: torch.Tensor,  # (B, 3, 3)
    initial_translation: torch.Tensor,  # (B, 3)
    packed: tuple,  # from prepack_batched
    intrinsics: CameraIntrinsics,
    params: IcpParams,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GN loop of B pairs on prepacked inputs, exact engine; returns
    (best_R, best_t, best_residual), (B, 3, 3), (B, 3), (B,), on the inputs'
    device."""
    *tensors, h, w = packed
    return _level(_exact_loop, (initial_rotation, initial_translation, *tensors), h, w, intrinsics, params)


def _prepack_banded(pack_target, source_points, source_mask, source_intensity, target_points, target_mask,
                    target_normals, target_intensity_map, intrinsics):
    bsz = target_intensity_map.shape[0]
    h, w = target_intensity_map.shape[-2] - 2, target_intensity_map.shape[-1] - 2
    sp = k3.pack_source(source_points.reshape(bsz, h, w, 3), source_mask.reshape(bsz, h, w),
                        source_intensity.reshape(bsz, h, w))
    tp = pack_target(target_points.reshape(bsz, h, w, 3), target_normals.reshape(bsz, h, w, 3),
                     target_mask.reshape(bsz, h, w), target_intensity_map)
    return sp, tp, k3.source_centroids_batched(sp, intrinsics), h, w


def prepack_v3_batched(source_points, source_mask, source_intensity, target_points, target_mask, target_normals,
                       target_intensity_map, intrinsics: CameraIntrinsics):
    """The pose-independent inputs of the ``"pallas"`` engine for B pairs
    ((B, N, ...) flattened levels, (B, H+2, W+2) maps): the source packs,
    K7's float32 target packs and the source centroids. Returns ``(sp, tp,
    centroids, h, w)`` for :func:`align_impl_pallas_v3_batched_packed`."""
    return _prepack_banded(k3.pack_target, source_points, source_mask, source_intensity, target_points,
                           target_mask, target_normals, target_intensity_map, intrinsics)


def prepack_v4_batched(source_points, source_mask, source_intensity, target_points, target_mask, target_normals,
                       target_intensity_map, intrinsics: CameraIntrinsics):
    """:func:`prepack_v3_batched` with K8's 5-channel int32 target packs."""
    return _prepack_banded(k4.pack_target, source_points, source_mask, source_intensity, target_points,
                           target_mask, target_normals, target_intensity_map, intrinsics)


def _banded_loop(step_fn, initial_rotation, initial_translation, sp, tp, pbar, rowbar, colbar, cnt, h: int, w: int,
                 intrinsics: CameraIntrinsics, params: IcpParams):
    """A banded engine's GN loop on prepacked pairs, eager: per iteration
    the bands predicted from the current poses (K10), ``step_fn`` (K7 or
    K8) and K11."""
    hp = sp.shape[1] * k3.CHUNK
    pt = k3.params_to_tuple(params)
    centroids = (pbar, rowbar, colbar, cnt)

    def step(rot, trans):
        cb, dyb, dxb = k3.predict_bases_centroid_batched(rot, trans, centroids, intrinsics, hp)
        return step_fn(rot, trans, cb, dyb, dxb, sp, tp, intrinsics, h, w, pt)[:2]

    return _gn_loop(step, initial_rotation, initial_translation, params)


def _v3_loop(*args):
    """The ``"pallas"`` engine's loop: K7 with no stats."""
    return _banded_loop(lambda *a: k3.icp_step_pallas_batched(*a, emit_stats=False), *args)


def _v4_loop(*args):
    """The ``"pallas_v4"`` engine's loop: K8."""
    return _banded_loop(k4.icp_step_pallas_batched, *args)


def align_impl_pallas_v3_batched_packed(initial_rotation, initial_translation, sp, tp, centroids,
                                        intrinsics: CameraIntrinsics, h: int, w: int, params: IcpParams):
    """GN loop of the ``"pallas"`` engine over B prepacked pairs: per
    iteration the bands predicted from the current poses, one launch of K7
    (no stats), the solve and the update. Returns (best_R, best_t,
    best_residual)."""
    return _level(_v3_loop, (initial_rotation, initial_translation, sp, tp, *centroids), h, w, intrinsics, params)


def align_impl_pallas_v4_batched_packed(initial_rotation, initial_translation, sp, tp, centroids,
                                        intrinsics: CameraIntrinsics, h: int, w: int, params: IcpParams):
    """:func:`align_impl_pallas_v3_batched_packed` with K8 (the ``"pallas_v4"``
    engine; ``bench.py``'s timed region)."""
    return _level(_v4_loop, (initial_rotation, initial_translation, sp, tp, *centroids), h, w, intrinsics, params)


def _exact_eager(initial_rotation, initial_translation, source_points, source_mask, source_intensity, target_points,
                 target_mask, target_normals, target_intensity_map, intrinsics: CameraIntrinsics, params: IcpParams):
    """Batched exact align, eager: :func:`prepack_batched`, then the GN loop."""
    *packed, h, w = prepack_batched(source_points, source_mask, source_intensity, target_points, target_mask,
                                    target_normals, target_intensity_map)
    return _exact_loop(initial_rotation, initial_translation, *packed, h, w, intrinsics, params)


def _banded_eager(prepack, loop):
    """A banded engine's batched align, eager: ``prepack``, then ``loop``."""

    def eager(initial_rotation, initial_translation, *level_and_rest):
        *level, intrinsics, params = level_and_rest
        sp, tp, centroids, h, w = prepack(*level, intrinsics)
        return loop(initial_rotation, initial_translation, sp, tp, *centroids, h, w, intrinsics, params)

    return eager


_v3_eager = _banded_eager(prepack_v3_batched, _v3_loop)
_v4_eager = _banded_eager(prepack_v4_batched, _v4_loop)


def align_impl_pallas_v3_batched(initial_rotation, initial_translation, source_points, source_mask,
                                 source_intensity, target_points, target_mask, target_normals, target_intensity_map,
                                 intrinsics: CameraIntrinsics, params: IcpParams):
    """Batched ``"pallas"`` align: :func:`prepack_v3_batched`, then the GN
    loop (on the card both in the level's graph)."""
    return _level(_v3_eager, (initial_rotation, initial_translation, source_points, source_mask, source_intensity,
                              target_points, target_mask, target_normals, target_intensity_map), intrinsics, params)


def align_impl_pallas_v4_batched(initial_rotation, initial_translation, source_points, source_mask,
                                 source_intensity, target_points, target_mask, target_normals, target_intensity_map,
                                 intrinsics: CameraIntrinsics, params: IcpParams):
    """Batched ``"pallas_v4"`` align: :func:`prepack_v4_batched`, then the GN
    loop (on the card both in the level's graph)."""
    return _level(_v4_eager, (initial_rotation, initial_translation, source_points, source_mask, source_intensity,
                              target_points, target_mask, target_normals, target_intensity_map), intrinsics, params)


def _single(batched):
    def single(initial_rotation, initial_translation, *pair_and_rest):
        *pair, intrinsics, params = pair_and_rest
        rot, trans, res = batched(initial_rotation[None], initial_translation[None], *(t[None] for t in pair),
                                  intrinsics, params)
        return rot[0], trans[0], res[0]

    return single


def align_impl_pallas_v3(initial_rotation, initial_translation, source_points, source_mask, source_intensity,
                         target_points, target_mask, target_normals, target_intensity_map,
                         intrinsics: CameraIntrinsics, params: IcpParams):
    """Single-pair ``"pallas"`` align (a batch of one)."""
    return _single(align_impl_pallas_v3_batched)(
        initial_rotation, initial_translation, source_points, source_mask, source_intensity, target_points,
        target_mask, target_normals, target_intensity_map, intrinsics, params)


def align_impl_pallas_v4(initial_rotation, initial_translation, source_points, source_mask, source_intensity,
                         target_points, target_mask, target_normals, target_intensity_map,
                         intrinsics: CameraIntrinsics, params: IcpParams):
    """Single-pair ``"pallas_v4"`` align (a batch of one)."""
    return _single(align_impl_pallas_v4_batched)(
        initial_rotation, initial_translation, source_points, source_mask, source_intensity, target_points,
        target_mask, target_normals, target_intensity_map, intrinsics, params)


def _exact_batched(initial_rotation, initial_translation, source_points, source_mask, source_intensity,
                   target_points, target_mask, target_normals, target_intensity_map, intrinsics: CameraIntrinsics,
                   params: IcpParams):
    """Batched exact align: :func:`prepack_batched`, then the GN loop (on
    the card both in the level's graph)."""
    return _level(_exact_eager, (initial_rotation, initial_translation, source_points, source_mask, source_intensity,
                                 target_points, target_mask, target_normals, target_intensity_map), intrinsics, params)


def align_impl(initial_rotation, initial_translation, source_points, source_mask, source_intensity, target_points,
               target_mask, target_normals, target_intensity_map, intrinsics: CameraIntrinsics,
               params: IcpParams):
    """Full ICP align of one pair, exact engine (a batch of one)."""
    return _single(_exact_batched)(
        initial_rotation, initial_translation, source_points, source_mask, source_intensity, target_points,
        target_mask, target_normals, target_intensity_map, intrinsics, params)


_ENGINES = {"xla": align_impl, "pallas": align_impl_pallas_v3, "pallas_v4": align_impl_pallas_v4}
_BATCHED = {"xla": _exact_batched, "pallas": align_impl_pallas_v3_batched,
            "pallas_v4": align_impl_pallas_v4_batched}
#: ``_BATCHED``'s aligns, never through a CUDA graph (the tests' eager loop on the card).
_EAGER = {"xla": _exact_eager, "pallas": _v3_eager, "pallas_v4": _v4_eager}


def _engine(table: dict, params: IcpParams):
    if params.engine not in table:
        raise ValueError(f"unknown ICP engine {params.engine!r}; expected one of {sorted(table)}")
    return table[params.engine]


def align_dispatch(initial_rotation, initial_translation, source_points, source_mask, source_intensity,
                   target_points, target_mask, target_normals, target_intensity_map,
                   intrinsics: CameraIntrinsics, params: IcpParams):
    """The single-pair align of ``params.engine``."""
    return _engine(_ENGINES, params)(
        initial_rotation, initial_translation, source_points, source_mask, source_intensity, target_points,
        target_mask, target_normals, target_intensity_map, intrinsics, params)


def align_batched(
    initial: Transform,  # (B,)
    source_points: torch.Tensor,  # (B, N, 3)
    source_mask: torch.Tensor,
    source_intensity: torch.Tensor,
    target_points: torch.Tensor,  # (B, N, 3)
    target_mask: torch.Tensor,
    target_normals: torch.Tensor,
    target_intensity_map: torch.Tensor,  # (B, H+2, W+2)
    intrinsics: CameraIntrinsics,
    params: IcpParams,
) -> tuple[Transform, torch.Tensor]:
    """Align B frame pairs at once (the throughput configuration) with
    ``params.engine``; returns the best poses (B,) and their mean squared
    residuals (B,)."""
    rot, trans, res = _engine(_BATCHED, params)(
        initial.rotation, initial.translation, source_points, source_mask, source_intensity, target_points,
        target_mask, target_normals, target_intensity_map, intrinsics, params)
    return Transform(rot, trans), res


class ImageIcp:
    """Aligns a source RangeImage onto a target (reference image_icp.rs:19-43)."""

    def __init__(self, params: IcpParams, target: RangeImage):
        if target.intensity_map is None:
            raise ValueError("the target image should have an intensity map")
        if target.normals is None:
            raise ValueError("the target image should have normals")
        self.params = params
        self.target = target
        self.initial_transform = Transform.identity(device=target.device)
        self.last_residual: float | None = None  # best mean-squared residual

    def align(self, source: RangeImage) -> Transform:
        if source.intensities is None:
            raise ValueError("the source image should have intensity colors")
        t = self.target
        n = t.height * t.width
        best_rot, best_trans, best_res = align_dispatch(
            self.initial_transform.rotation,
            self.initial_transform.translation,
            source.points.reshape(-1, 3),
            source.mask.reshape(-1),
            source.intensities.reshape(-1),
            t.points.reshape(n, 3),
            t.mask.reshape(n),
            t.normals.reshape(n, 3),
            t.intensity_map,
            t.intrinsics,
            self.params,
        )
        wait = profiling.begin("icp.level_wait")
        self.last_residual = float(best_res)  # the one host sync per level
        profiling.end(wait)
        return Transform(best_rot, best_trans)
