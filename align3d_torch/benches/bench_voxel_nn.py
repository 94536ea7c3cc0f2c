"""Nearest neighbour, 500k database points x 500k queries (the port's
``benches/bench_voxel_nn.py``; baseline: the reference's kd-tree search,
101.75 ms on its CPU, README.md:131).

    python -m align3d_torch.benches.bench_voxel_nn [--device cpu] [--quick]

Two uniform clouds in the unit cube from seed 0 (:func:`clouds`); the
sorted grid (cell 0.02) is built outside the timed calls, as the reference
builds its tree outside its loop. Each call is
``ops/nn_banded.py::nearest_banded`` of all queries: on the card one K4
launch, on the CPU its plain twin. Band 256 is the value, band 512 (the
high-recall point) is timed beside it. Prints one JSON line:
``nn_500k_x_500k_ms``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from align3d_torch.benches import _harness as h
from align3d_torch.ops.nn_banded import SortedGrid, nearest_banded

METRIC = "nn_500k_x_500k_ms"
BASELINE_MS = 101.75
CELL = 0.02
BANDS = (256, 512)  # the value's band, the high-recall band


def clouds(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(database, queries), (n, 3) f32 each, seed 0."""
    rng = np.random.default_rng(0)
    db = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return db, rng.uniform(0, 1, (n, 3)).astype(np.float32)


def run(argv=None) -> h.Outcome:
    ap = h.parser(__doc__.splitlines()[0], calls=10)
    ap.add_argument("--points", type=int, default=500_000)
    args = h.parse(ap, argv)
    device = h.setup(args.device)
    db, q = (torch.from_numpy(a).to(device) for a in clouds(args.points))
    grid = SortedGrid.build(db, CELL)
    timings = {}
    for band in BANDS:
        timings[band] = h.measure(lambda b=band: nearest_banded(grid, q, band_width=b), device, args)
        h.describe(f"nearest, band {band}, ms", timings[band].summary(), "ms")
    first, second = BANDS
    line = h.record(METRIC, "ms", timings[first], device, baseline=BASELINE_MS, points=args.points, band=first,
                    **{f"band_{second}": timings[second].summary()})
    return h.Outcome(line, {band: t.result for band, t in timings.items()})


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
