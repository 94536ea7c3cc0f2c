"""Headline bench: image ICP throughput (the port's ``bench.py``).

    python -m align3d_torch.benches.bench_image_icp [--device cpu] [--quick]

The reference's ``bench_image_icp.rs`` workload: 640x480 RGB-D pairs, level
0, 10 Gauss-Newton iterations, as one batched align over 64 distinct real
pairs of the in-repo fixtures (sample1 + sample2, forward and reversed
adjacent pairs: ``tools/series.py::real_pairs``). The pairs are prepacked
outside the timed calls, as the JAX bench and the reference do; each call
is ``icp/image_icp.py::align_impl_batched`` from identity poses, one K1
launch an iteration. Baseline: 38.576 ms a pair on the reference's CPU
(``bench.py:1-20``). The synthetic slanted-plane pair (``bench.py::
_synthetic_pair``), repeated ``--synthetic-batch`` times, is timed too and
reported on stderr only.

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
from align3d_torch.icp.image_icp import align_impl_batched, prepack_batched
from align3d_torch.icp.params import IcpParams
from align3d_torch.range_image import RangeImage, build_pyramid_impl
from align3d_torch.se3 import Transform
from align3d_torch.tools import series

METRIC = "image_icp_640x480_ms_per_pair"
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


def packed_pairs(sources: RangeImage, targets: RangeImage) -> tuple:
    b, n = sources.points.shape[0], targets.height * targets.width
    return prepack_batched(
        sources.points.reshape(b, n, 3), sources.mask.reshape(b, n), sources.intensities.reshape(b, n),
        targets.points.reshape(b, n, 3), targets.mask.reshape(b, n), targets.normals.reshape(b, n, 3),
        targets.intensity_map,
    )


def align(packed: tuple, intrinsics: CameraIntrinsics, params: IcpParams):
    """One timed call: the batched align from identity poses."""
    b = packed[0].shape[0]
    pose = Transform.identity((b,), device=packed[0].device)
    return align_impl_batched(pose.rotation, pose.translation, packed, intrinsics, params)


def run(argv=None) -> h.Outcome:
    ap = h.parser(__doc__.splitlines()[0], calls=3)
    ap.add_argument("--batch", type=int, default=64, help="distinct real pairs")
    ap.add_argument("--iters", type=int, default=10, help="Gauss-Newton iterations")
    ap.add_argument("--synthetic-batch", type=int, default=8)
    args = h.parse(ap, argv)
    device = h.setup(args.device)
    if not config.has_ref_data():
        raise RuntimeError(f"the fixtures are missing under {config.REF_DATA_DIR} (tests/data/rgbd)")
    params = IcpParams(max_iterations=args.iters)

    sources, targets = synthetic_pairs(args.synthetic_batch, device)
    syn_packed = packed_pairs(sources, targets)
    syn = h.measure(lambda: align(syn_packed, sources.intrinsics, params), device, args)
    h.describe(f"synthetic batch {args.synthetic_batch}, ms a pair", syn.summary(args.synthetic_batch), "ms")
    del sources, targets, syn_packed

    sources, targets = series.real_pairs(args.batch, device)
    packed = packed_pairs(sources, targets)
    timing = h.measure(lambda: align(packed, sources.intrinsics, params), device, args)
    h.describe(f"real batch {args.batch}, ms a pair", timing.summary(args.batch), "ms")
    line = h.record(METRIC, "ms", timing, device, units=args.batch, baseline=BASELINE_MS, batch=args.batch,
                    iterations=args.iters, synthetic_ms_per_pair=syn.summary(args.synthetic_batch)["value"])
    return h.Outcome(line, timing.result)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
