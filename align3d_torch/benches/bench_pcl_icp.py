"""Point-cloud ICP align, 100k points, 10 iterations (the port's
``benches/bench_pcl_icp.py``; the reference's ``bench_icp.rs`` has no
published number).

    python -m align3d_torch.benches.bench_pcl_icp [--device cpu] [--quick]

The JAX bench's curved surface (:func:`surface`, seed 0: a sinusoidal
height field with analytic normals; a plane would leave the point-to-plane
system rank-deficient), moved by a fixed small twist. Each call is
``Icp(...).align`` of the moved cloud against the surface, the target's
grid built once outside the timed calls: on the card the banded engine,
one K4 launch an iteration (and one host sync an iteration, the re-sort
test); on the CPU the hash engine. Prints one JSON line:
``pcl_icp_100k_10iter_ms``, wall ms an align.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from align3d_torch.benches import _harness as h
from align3d_torch.icp.params import IcpParams
from align3d_torch.icp.pcl_icp import Icp
from align3d_torch.pointcloud import PointCloud
from align3d_torch.se3 import Transform

METRIC = "pcl_icp_100k_10iter_ms"
DELTA = [0.01, -0.005, 0.008, 0.004, -0.006, 0.01]


def surface(n: int) -> tuple[np.ndarray, np.ndarray]:
    """``benches/bench_pcl_icp.py``'s points and unit normals, (n, 3) f32."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pts[:, 2] = 0.3 * np.sin(2.0 * pts[:, 0]) * np.cos(2.0 * pts[:, 1])
    dzdx = 0.6 * np.cos(2.0 * pts[:, 0]) * np.cos(2.0 * pts[:, 1])
    dzdy = -0.6 * np.sin(2.0 * pts[:, 0]) * np.sin(2.0 * pts[:, 1])
    normals = np.stack([-dzdx, -dzdy, np.ones(n, np.float32)], axis=1)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return pts, normals.astype(np.float32)


def clouds(n: int, device) -> tuple[PointCloud, PointCloud, Transform]:
    """(target, source, delta): the surface and the surface moved by ``DELTA``."""
    pts, normals = surface(n)
    target = PointCloud(torch.from_numpy(pts).to(device), torch.ones(n, dtype=torch.bool, device=device),
                        normals=torch.from_numpy(normals).to(device))
    delta = Transform.exp(torch.tensor(DELTA, dtype=torch.float32, device=device))
    return target, target.transformed(delta), delta


def run(argv=None) -> h.Outcome:
    ap = h.parser(__doc__.splitlines()[0], calls=3)
    ap.add_argument("--points", type=int, default=100_000)
    ap.add_argument("--iters", type=int, default=10)
    args = h.parse(ap, argv)
    device = h.setup(args.device)
    target, source, delta = clouds(args.points, device)
    icp = Icp(IcpParams(max_iterations=args.iters), target.points, target.normals)
    h.log(f"engine {icp.nn_engine}; {args.points} points, {args.iters} iterations")
    timing = h.measure(lambda: icp.align(source.points, source.normals), device, args)
    err = float((timing.result.inverse() @ delta.inverse()).angle())
    h.describe("pcl icp align, ms", timing.summary(), "ms")
    line = h.record(METRIC, "ms", timing, device, points=args.points, iterations=args.iters, engine=icp.nn_engine,
                    angle_error_rad=err, resorts=icp.last_resorts)
    return h.Outcome(line, timing.result)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
