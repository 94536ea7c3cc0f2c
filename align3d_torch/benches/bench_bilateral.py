"""Bilateral-grid depth filter, 640x480 u16 (the port's
``benches/bench_bilateral.py``; the reference's ``bench_bilateral`` has no
published number).

    python -m align3d_torch.benches.bench_bilateral [--device cpu] [--quick]

Two depth images from seed 0 (:func:`depths`): the JAX bench's narrow span
(2000 + [0, 500)), and its realistic span (a slanted scene over ~2-4.3 m
with 5% holes), the value. Each call is ``BilateralFilter.filter_static`` at
the image's own grid depth and minimum (holes included, as the JAX bench
takes them), both fixed outside the timed calls: on the card one K2 launch,
the blur, one K3 launch (form (b)). Prints one JSON line:
``bilateral_filter_640x480_ms``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from align3d_torch.benches import _harness as h
from align3d_torch.ops.bilateral import BilateralFilter

METRIC = "bilateral_filter_640x480_ms"


def depths(height: int, width: int) -> dict:
    """{"narrow", "wide"}: (h, w) u16 depth images, seed 0."""
    rng = np.random.default_rng(0)
    narrow = (2000 + rng.integers(0, 500, (height, width))).astype(np.uint16)
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    wide = (2000 + 2 * xs + ys + rng.integers(0, 8, (height, width))).astype(np.uint16)
    wide[rng.random((height, width)) < 0.05] = 0
    return {"narrow": narrow, "wide": wide}


def grid_depth(depth: np.ndarray, filt: BilateralFilter) -> int:
    """The JAX bench's static grid depth of one image."""
    return int((int(depth.max()) - int(depth.min())) / filt.sigma_color) + 1 + 4


def run(argv=None) -> h.Outcome:
    ap = h.parser(__doc__.splitlines()[0], calls=50)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    args = h.parse(ap, argv)
    device = h.setup(args.device)
    filt = BilateralFilter()
    timings, gds = {}, {}
    for name, depth in depths(args.height, args.width).items():
        image = torch.from_numpy(depth.astype(np.int32)).to(device)
        cmin = torch.tensor(int(depth.min()), dtype=torch.int32).to(device)
        gd = gds[name] = grid_depth(depth, filt)
        timings[name] = h.measure(lambda i=image, c=cmin, g=gd: filt.filter_static(i, c, g), device, args)
        h.describe(f"bilateral filter, {name} span (gd {gd}), ms", timings[name].summary(), "ms")
    line = h.record(METRIC, "ms", timings["wide"], device, size=[args.width, args.height], grid_depth=gds["wide"],
                    narrow=dict(timings["narrow"].summary(), grid_depth=gds["narrow"]))
    return h.Outcome(line, {name: t.result for name, t in timings.items()})


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
