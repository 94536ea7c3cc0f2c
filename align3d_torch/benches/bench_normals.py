"""Range-image normals, 640x480 (the port's ``benches/bench_normals.py``;
baseline: the reference's ``bench_compute_normals``, 1.1778 ms on its CPU,
README.md:132).

    python -m align3d_torch.benches.bench_normals [--device cpu] [--quick]

Uniform points in [-1, 1]^3 and a mask of 90% from seed 0 (:func:`grid`);
each call is ``ops/normals.py::compute_normals``, tensor code with no
kernel of its own. Prints one JSON line: ``compute_normals_640x480_ms``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from align3d_torch.benches import _harness as h
from align3d_torch.ops.normals import compute_normals

METRIC = "compute_normals_640x480_ms"
BASELINE_MS = 1.1778


def grid(height: int, width: int) -> tuple[np.ndarray, np.ndarray]:
    """(points (h, w, 3) f32, mask (h, w) bool), seed 0."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (height, width, 3)).astype(np.float32)
    return pts, rng.random((height, width)) > 0.1


def run(argv=None) -> h.Outcome:
    ap = h.parser(__doc__.splitlines()[0], calls=50)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    args = h.parse(ap, argv)
    device = h.setup(args.device)
    pts, mask = (torch.from_numpy(a).to(device) for a in grid(args.height, args.width))
    timing = h.measure(lambda: compute_normals(pts, mask), device, args)
    h.describe("compute_normals, ms", timing.summary(), "ms")
    line = h.record(METRIC, "ms", timing, device, baseline=BASELINE_MS, size=[args.width, args.height])
    return h.Outcome(line, timing.result)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
