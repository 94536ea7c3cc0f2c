"""End-to-end odometry throughput, ms a frame (the port's
``benches/bench_odometry.py``).

    python -m align3d_torch.benches.bench_odometry [--device cpu] [--quick]

Each call is one ``parallel/batch.py::odometry_step`` over a frame series
(depth filter, 3-level pyramids, 3-level ICP at 30/20/20 iterations, the
prefix scan), timed with the bilateral filter off and then on (through
per-frame-sized depth buckets). ms a frame is a step over its pairs. The
ICP engine is the JAX bench's default, ``--engine pallas_v4``
(``MsIcpParams.default_tpu("pallas_v4")``: K8 70 launches a step, band
radius 2 at the coarsest level); ``--engine xla`` runs
``MsIcpParams.default()`` (K1 70 launches a step). Unless the engine is
``xla``, the exact engine's step on the real series, filter off, is timed
too and printed beside (``xla_ms_per_frame``), so that the records taken
with it compare. The series, in order:

* the 65 real frames of ``tools/series.py::real_frames`` (sample1 forward,
  back and wrapped: 64 pairs), the headline; with the filter one K2 and
  one K3 launch a bucket;
* the mixed sample1 + sample2 series (``mixed_frames``), whose depth spans
  need buckets of very different depth;
* the JAX bench's synthetic slanted-plane series of ``ODO_NFRAMES`` (9)
  frames (:func:`synthetic_series`).

``--frames`` cuts the real and mixed series and ``--stride`` keeps every
s-th pixel (intrinsics scaled): sizes for a CPU run. The JAX bench's stage
split of the filter is not ported (``StageTimer`` and ``chip_smoke.py``
phase 5 break the step down). Prints one JSON line:
``odometry_e2e_640x480_ms_per_frame``, the real series with the filter off
(as the JAX bench's value), the filter on beside it, and every series'
timing under ``series``.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from align3d_torch import config
from align3d_torch.benches import _harness as h
from align3d_torch.camera import CameraIntrinsics
from align3d_torch.icp.params import MsIcpParams
from align3d_torch.ops.bilateral import BilateralFilter
from align3d_torch.parallel import batch as pb
from align3d_torch.tools import series as sr

METRIC = "odometry_e2e_640x480_ms_per_frame"
H, W = 480, 640


@dataclasses.dataclass
class Frames:
    """One series' inputs as ``odometry_step`` takes them."""

    colors: np.ndarray  # (N, H, W, 3) u8
    depths: np.ndarray  # (N, H, W) u16
    camera: CameraIntrinsics
    depth_scales: np.ndarray | float

    def cut(self, stride: int) -> "Frames":
        """Every ``stride``-th pixel of each frame; the intrinsics follow."""
        if stride == 1:
            return self
        colors, depths = self.colors[:, ::stride, ::stride], self.depths[:, ::stride, ::stride]
        camera = self.camera.scale(1.0 / stride).with_size(depths.shape[2], depths.shape[1])
        return Frames(np.ascontiguousarray(colors), np.ascontiguousarray(depths), camera, self.depth_scales)

    def on(self, device) -> tuple:
        scales = self.depth_scales
        if isinstance(scales, np.ndarray):
            scales = torch.from_numpy(scales).to(device)
        return (torch.from_numpy(self.colors).to(device), torch.from_numpy(self.depths.astype(np.int32)).to(device),
                scales)


def synthetic_series(n_frames: int) -> Frames:
    """``benches/bench_odometry.py::main``'s synthetic series: a slanted
    plane seen from ``n_frames`` positions one pixel apart, texture and
    depth noise from seed 0, depth scale 1/1000."""
    rng = np.random.default_rng(0)
    intr = CameraIntrinsics(fx=525.0, fy=525.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5, width=W, height=H)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    tex = rng.uniform(30, 220, size=(H, W + n_frames + 1, 3)).astype(np.uint8)
    colors = np.stack([tex[:, i : i + W] for i in range(n_frames)])
    depths = np.stack([(2000 + 2 * (xs + i) + ys + rng.integers(0, 8, size=(H, W))).astype(np.uint16)
                       for i in range(n_frames)])
    return Frames(colors, depths, intr, 0.001)


def from_series(s: sr.Series) -> Frames:
    return Frames(s.colors, s.depths, s.camera, s.depth_scales)


def engine_params(engine: str) -> MsIcpParams:
    """The JAX bench's parameters of ``engine``."""
    return MsIcpParams.default() if engine == "xla" else MsIcpParams.default_tpu(engine)


def step(frames: Frames, inputs: tuple, params: MsIcpParams, filt, device):
    """One timed call: the batched odometry of the whole series."""
    colors, depths, scales = inputs
    traj = pb.odometry_step(frames.camera, scales, colors, depths, params, bilateral_filter=filt, device=device)
    return traj.camera_to_world


def run(argv=None) -> h.Outcome:
    ap = h.parser(__doc__.splitlines()[0], calls=1)
    ap.add_argument("--frames", type=int, default=sr.SERIES_FRAMES, help="frames of the real and mixed series")
    ap.add_argument("--synthetic-frames", type=int, default=int(os.environ.get("ODO_NFRAMES", "9")))
    ap.add_argument("--stride", type=int, default=1, help="keep every s-th pixel (a CPU run's size)")
    ap.add_argument("--engine", choices=("xla", "pallas", "pallas_v4"), default="pallas_v4")
    args = h.parse(ap, argv)
    device = h.setup(args.device)
    if not config.has_ref_data():
        raise RuntimeError(f"the fixtures are missing under {config.REF_DATA_DIR} (tests/data/rgbd)")
    params = engine_params(args.engine)
    filt = BilateralFilter()
    all_series = {"real": from_series(sr.real_frames(args.frames)),
                  "mixed": from_series(sr.mixed_frames(args.frames)),
                  "synthetic": synthetic_series(args.synthetic_frames)}
    summaries, timings = {}, {}
    for name, frames in all_series.items():
        frames = frames.cut(args.stride)
        inputs = frames.on(device)
        pairs = len(frames.depths) - 1
        plan = sr.bucket_plan(frames.depths, filt)
        h.log(f"[{name}] {pairs} pairs at {frames.depths.shape[2]}x{frames.depths.shape[1]}; depth buckets "
              + ", ".join(f"{g}x{len(i)}" for g, i, _ in plan))
        summaries[name] = {}
        for label, f in (("off", None), ("on", filt)):
            timing = h.measure(lambda: step(frames, inputs, params, f, device), device, args)
            summaries[name][label] = dict(timing.summary(pairs), pairs=pairs, buckets=len(plan) if f else 0)
            timings[(name, label)] = timing
            h.describe(f"{name}, filter {label}, ms a frame", summaries[name][label], "ms")
    real_pairs = len(all_series["real"].depths) - 1
    extra = {}
    if args.engine != "xla":
        frames = all_series["real"].cut(args.stride)
        inputs = frames.on(device)
        exact = MsIcpParams.default()
        timing = h.measure(lambda: step(frames, inputs, exact, None, device), device, args)
        timings[("real", "off", "xla")] = timing
        extra = {"xla_ms_per_frame": timing.summary(real_pairs)["value"], "xla": timing.summary(real_pairs)}
        h.describe("real, filter off, exact engine, ms a frame", extra["xla"], "ms")
    line = h.record(METRIC, "ms", timings[("real", "off")], device, units=real_pairs, engine=args.engine,
                    bilateral_on=summaries["real"]["on"]["value"], series=summaries, stride=args.stride, **extra)
    return h.Outcome(line, {key: t.result for key, t in timings.items()})


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
