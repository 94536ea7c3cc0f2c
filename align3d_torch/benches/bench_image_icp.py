"""Headline bench: image ICP throughput (the port's ``bench.py``).

    python -m align3d_torch.benches.bench_image_icp [--device cpu] [--quick] [--engine ENGINE]

The reference's ``bench_image_icp.rs`` workload: 640x480 RGB-D pairs, level
0, 10 Gauss-Newton iterations, as one batched align over 64 distinct real
pairs of the in-repo fixtures (sample1 + sample2, forward and reversed
adjacent pairs: ``tools/series.py::real_pairs``). The pairs are prepacked
outside the timed calls, as the JAX bench and the reference do. Each call
is, as ``bench.py``'s, the ``"pallas_v4"`` engine's
``icp/image_icp.py::align_impl_pallas_v4_batched_packed`` from identity
poses: per iteration the bands predicted from the current poses and one K8
launch over the batch. ``--engine`` picks another (``pallas``: K7;
``xla``: the exact engine, ``align_impl_batched``, one K1 launch an
iteration). Unless the engine is ``xla``, the exact engine is timed too on
the same pairs and printed beside (``xla_ms_per_pair``), so that the
records taken with it compare. Baseline: 38.576 ms a pair on the
reference's CPU (``bench.py:1-20``). The synthetic slanted-plane pair
(``bench.py::_synthetic_pair``), repeated ``--synthetic-batch`` times, is
timed too and reported on stderr only.

Prints one JSON line: ``image_icp_640x480_ms_per_pair``, wall ms of one
call over the batch; the fixtures must be present (no synthetic fallback).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from align3d_torch import config
from align3d_torch.benches import _harness as h
from align3d_torch.camera import CameraIntrinsics
from align3d_torch.icp import image_icp as ii
from align3d_torch.icp.params import IcpParams
from align3d_torch.range_image import RangeImage, build_pyramid_impl
from align3d_torch.se3 import Transform
from align3d_torch.tools import series

METRIC = "image_icp_640x480_ms_per_pair"
ENGINES = ("xla", "pallas", "pallas_v4")
BASELINE_MS = 38.576
H, W = 480, 640


def synthetic_images(device, height: int = H, width: int = W) -> RangeImage:
    """``bench.py::_synthetic_pair``'s two level-0 range images, batched
    (target, source): a slanted plane 2-4 m away, the source shifted one
    pixel, texture from seed 0."""
    rng = np.random.default_rng(0)
    intr = CameraIntrinsics(fx=525.0, fy=525.0, cx=width / 2 - 0.5, cy=height / 2 - 0.5, width=width, height=height)
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    depth0 = (2000 + 2 * xs + ys + rng.integers(0, 8, size=(height, width))).astype(np.uint16)
    depth1 = (2000 + 2 * (xs + 1) + ys + rng.integers(0, 8, size=(height, width))).astype(np.uint16)
    tex = rng.uniform(30, 220, size=(height, width + 8, 3)).astype(np.uint8)
    colors = np.stack([tex[:, :width], tex[:, 1:width + 1]])
    depths = np.stack([depth0, depth1]).astype(np.int32)
    return build_pyramid_impl(True, True, 1, 1.0, intr, 0.001, torch.from_numpy(colors).to(device),
                              torch.from_numpy(depths).to(device))[0]


def synthetic_pairs(batch: int, device) -> tuple[RangeImage, RangeImage]:
    """(sources, targets): the synthetic pair repeated ``batch`` times."""
    images = synthetic_images(device)
    return (images.frames(torch.ones(batch, dtype=torch.int64, device=images.device)),
            images.frames(torch.zeros(batch, dtype=torch.int64, device=images.device)))


def flat_pairs(sources: RangeImage, targets: RangeImage) -> tuple:
    """The aligns' per-pair arguments: (B, N, ...) sources and targets and
    the targets' (B, H+2, W+2) intensity maps."""
    b, n = sources.points.shape[0], targets.height * targets.width
    return (sources.points.reshape(b, n, 3), sources.mask.reshape(b, n), sources.intensities.reshape(b, n),
            targets.points.reshape(b, n, 3), targets.mask.reshape(b, n), targets.normals.reshape(b, n, 3),
            targets.intensity_map)


def packed_pairs(sources: RangeImage, targets: RangeImage, engine: str = "pallas_v4") -> tuple:
    """The pose-independent inputs of ``engine``'s align (its prepack)."""
    flat = flat_pairs(sources, targets)
    if engine == "xla":
        return ii.prepack_batched(*flat)
    prepack = ii.prepack_v3_batched if engine == "pallas" else ii.prepack_v4_batched
    return prepack(*flat, targets.intrinsics)


def align(packed: tuple, intrinsics: CameraIntrinsics, params: IcpParams):
    """One timed call: the batched align of ``params.engine`` from identity poses."""
    b = packed[0].shape[0]
    pose = Transform.identity((b,), device=packed[0].device)
    if params.engine == "xla":
        return ii.align_impl_batched(pose.rotation, pose.translation, packed, intrinsics, params)
    fn = ii.align_impl_pallas_v3_batched_packed if params.engine == "pallas" else ii.align_impl_pallas_v4_batched_packed
    return fn(pose.rotation, pose.translation, *packed[:3], intrinsics, *packed[3:], params)


def run(argv=None) -> h.Outcome:
    ap = h.parser(__doc__.splitlines()[0], calls=3)
    ap.add_argument("--batch", type=int, default=64, help="distinct real pairs")
    ap.add_argument("--iters", type=int, default=10, help="Gauss-Newton iterations")
    ap.add_argument("--synthetic-batch", type=int, default=8)
    ap.add_argument("--engine", choices=ENGINES, default="pallas_v4", help="bench.py's engine: pallas_v4")
    args = h.parse(ap, argv)
    device = h.setup(args.device)
    if not config.has_ref_data():
        raise RuntimeError(f"the fixtures are missing under {config.REF_DATA_DIR} (tests/data/rgbd)")
    params = IcpParams(max_iterations=args.iters, engine=args.engine)

    sources, targets = synthetic_pairs(args.synthetic_batch, device)
    syn_packed = packed_pairs(sources, targets, args.engine)
    syn = h.measure(lambda: align(syn_packed, sources.intrinsics, params), device, args)
    h.describe(f"{args.engine}, synthetic batch {args.synthetic_batch}, ms a pair", syn.summary(args.synthetic_batch),
               "ms")
    del sources, targets, syn_packed

    sources, targets = series.real_pairs(args.batch, device)
    timings = {}
    for engine in dict.fromkeys([args.engine, "xla"]):
        packed = packed_pairs(sources, targets, engine)
        engine_params = params.replace(engine=engine)
        timings[engine] = h.measure(lambda: align(packed, sources.intrinsics, engine_params), device, args)
        h.describe(f"{engine}, real batch {args.batch}, ms a pair", timings[engine].summary(args.batch), "ms")
        del packed
    extra = {} if args.engine == "xla" else {"xla_ms_per_pair": timings["xla"].summary(args.batch)["value"],
                                             "xla": timings["xla"].summary(args.batch)}
    line = h.record(METRIC, "ms", timings[args.engine], device, units=args.batch, baseline=BASELINE_MS,
                    batch=args.batch, iterations=args.iters, engine=args.engine,
                    synthetic_ms_per_pair=syn.summary(args.synthetic_batch)["value"], **extra)
    return h.Outcome(line, {engine: t.result for engine, t in timings.items()})


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
