"""The GN-step kernel alone and the full align, in µs a pair-iteration
(the port's ``benches/bench_icp_kernel.py``).

    python -m align3d_torch.benches.bench_icp_kernel [--device cpu] [--quick]

The JAX bench's synthetic slanted-plane pair (``bench_image_icp.
synthetic_images``, the same recipe), repeated ``--batch`` (8) times:

* kernel only: ``--iters`` (10) K1 launches a call
  (``ops/icp_fused.py::icp_step_fused`` at identity poses; no solve);
* full align: ``icp/image_icp.py::align_impl_batched``, ``--iters``
  Gauss-Newton iterations, one K1 launch each.

The JAX bench's ``--radius`` (``IcpParams.band_radius``, the association
band of its TPU kernels) is deliberately not ported: K1 gathers exactly,
so the flag is refused. The metric names keep the JAX bench's default
spelling (engine ``v3``, radius 2), so its default line and this one
compare. Prints one JSON line: ``kernel_only_v3_r2_us_per_pair_iter``,
with ``full_align_v3_r2_us_per_pair_iter`` and its timing beside it.
"""

from __future__ import annotations

import sys

from align3d_torch.benches import _harness as h
from align3d_torch.benches.bench_image_icp import align, packed_pairs, synthetic_pairs
from align3d_torch.icp.params import IcpParams
from align3d_torch.ops import icp_fused
from align3d_torch.se3 import Transform

KERNEL_METRIC = "kernel_only_v3_r2_us_per_pair_iter"
FULL_METRIC = "full_align_v3_r2_us_per_pair_iter"


def kernel_steps(packed: tuple, intrinsics, params: IcpParams):
    """One timed kernel-only call: ``params.max_iterations`` K1 launches at
    identity poses; returns the last launch's (B, 2, 8, 8) blocks."""
    b = packed[0].shape[0]
    pose = Transform.identity((b,), device=packed[0].device)
    for _ in range(params.max_iterations):
        blocks = icp_fused.icp_step_fused(pose.rotation, pose.translation, *packed, intrinsics, params)
    return blocks


def run(argv=None) -> h.Outcome:
    ap = h.parser(__doc__.splitlines()[0], calls=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--radius", type=int, default=None, help="not ported: refused")
    args = h.parse(ap, argv)
    if args.radius is not None:
        ap.error("--radius is not ported: IcpParams.band_radius is deliberately left unported (K1 gathers exactly)")
    device = h.setup(args.device)
    params = IcpParams(max_iterations=args.iters)
    sources, targets = synthetic_pairs(args.batch, device)
    packed = packed_pairs(sources, targets)
    units = args.batch * args.iters  # pair-iterations a call

    full = h.measure(lambda: align(packed, sources.intrinsics, params), device, args)
    h.describe("full align, µs a pair-iteration", full.summary(units, "us"), "us")
    kernel = h.measure(lambda: kernel_steps(packed, sources.intrinsics, params), device, args)
    h.describe("kernel only, µs a pair-iteration", kernel.summary(units, "us"), "us")
    full_summary = full.summary(units, "us")
    line = h.record(KERNEL_METRIC, "us", kernel, device, units=units, batch=args.batch, iterations=args.iters,
                    radius=None, **{FULL_METRIC: full_summary["value"]}, full_align=full_summary)
    return h.Outcome(line, {"kernel_only": kernel.result, "full_align": full.result})


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
