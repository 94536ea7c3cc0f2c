"""Mesh vertex normals, 204,800 faces (the port's ``benches/bench_mesh.py``;
the reference's ``bench_mesh.rs`` has no published number).

    python -m align3d_torch.benches.bench_mesh [--device cpu] [--quick]

The JAX bench's height-field grid (``tools/ablate.py::grid_mesh``: side
320, (side + 1)^2 vertices, 2 side^2 faces). ``MeshNormals`` builds its
corner table once, outside the timed calls; each call evaluates the normals
of the points: on the card one K5 launch, on the CPU the plain twin.
Prints one JSON line: ``mesh_normals_200k_faces_ms``.
"""

from __future__ import annotations

import sys

import torch

from align3d_torch.benches import _harness as h
from align3d_torch.ops.mesh import MeshNormals
from align3d_torch.tools.ablate import grid_mesh

METRIC = "mesh_normals_200k_faces_ms"


def run(argv=None) -> h.Outcome:
    ap = h.parser(__doc__.splitlines()[0], calls=50)
    ap.add_argument("--side", type=int, default=320)
    args = h.parse(ap, argv)
    device = h.setup(args.device)
    pts, faces = grid_mesh(args.side)
    h.log(f"mesh: {pts.shape[0]} vertices, {faces.shape[0]} faces")
    evaluator = MeshNormals(faces, pts.shape[0], device=device)
    points = torch.from_numpy(pts).to(device)
    timing = h.measure(lambda: evaluator(points), device, args)
    h.describe("mesh normals, ms", timing.summary(), "ms")
    line = h.record(METRIC, "ms", timing, device, faces=int(faces.shape[0]), vertices=int(pts.shape[0]),
                    max_degree=evaluator.degree)
    return h.Outcome(line, timing.result)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
