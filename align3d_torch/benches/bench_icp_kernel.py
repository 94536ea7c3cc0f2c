"""The banded GN-step kernel alone and the full align, in µs a
pair-iteration (the port's ``benches/bench_icp_kernel.py``).

    python -m align3d_torch.benches.bench_icp_kernel [--device cpu] [--quick] [--radius R]

The JAX bench's synthetic slanted-plane pair (``bench_image_icp.
synthetic_images``, the same recipe), repeated ``--batch`` (8) times, on the
``"pallas"`` engine (v3, the only ``--engine`` of the JAX bench) at band
radius ``--radius`` (2):

* kernel only: the bands predicted once from the identity poses
  (``ops/icp_pallas_v3.py::predict_bases_batched``, a dense projection),
  then ``--iters`` (10) K7 launches a call
  (``icp_step_pallas_batched``, no stats; no solve);
* full align: ``icp/image_icp.py::align_impl_pallas_v3_batched`` (its
  prepack included, as the JAX bench times it), ``--iters`` Gauss-Newton
  iterations, one K7 launch each.

The exact engine's two numbers (K1 alone at identity poses, and
``align_impl_batched`` on prepacked pairs: the calls this bench timed
before it ran the banded engine) are timed too and printed beside, so that
the records taken with them compare. Prints one JSON line:
``kernel_only_v3_r{R}_us_per_pair_iter``, with
``full_align_v3_r{R}_us_per_pair_iter`` and their timings beside it.
"""

from __future__ import annotations

import sys

from align3d_torch.benches import _harness as h
from align3d_torch.benches.bench_image_icp import align, flat_pairs, packed_pairs, synthetic_pairs
from align3d_torch.icp import image_icp as ii
from align3d_torch.icp.params import IcpParams
from align3d_torch.ops import icp_fused
from align3d_torch.ops import icp_pallas_v3 as k3
from align3d_torch.se3 import Transform


def metrics(engine: str, radius: int) -> tuple[str, str]:
    """(kernel-only, full-align) metric names, the JAX bench's spelling."""
    return f"kernel_only_{engine}_r{radius}_us_per_pair_iter", f"full_align_{engine}_r{radius}_us_per_pair_iter"


KERNEL_METRIC, FULL_METRIC = metrics("v3", 2)


def _identity(b: int, device):
    pose = Transform.identity((b,), device=device)
    return pose.rotation, pose.translation


def kernel_steps(packed: tuple, intrinsics, params: IcpParams):
    """One timed kernel-only call on the v3 prepack ``packed``: the bands
    predicted from identity poses, then ``params.max_iterations`` K7
    launches; returns the last (geo, col)."""
    sp, tp, _, h, w = packed
    rot, trans = _identity(sp.shape[0], sp.device)
    bases = k3.predict_bases_batched(rot, trans, sp, intrinsics, h)
    for _ in range(params.max_iterations):
        out = k3.icp_step_pallas_batched(rot, trans, *bases, sp, tp, intrinsics, h, w, k3.params_to_tuple(params),
                                         emit_stats=False)
    return out[:2]


def full_align(sources, targets, params: IcpParams):
    """One timed full-align call: prepack and GN loop of the v3 engine."""
    rot, trans = _identity(sources.points.shape[0], sources.points.device)
    return ii.align_impl_pallas_v3_batched(rot, trans, *flat_pairs(sources, targets), targets.intrinsics, params)


def exact_kernel_steps(packed: tuple, intrinsics, params: IcpParams):
    """``params.max_iterations`` K1 launches at identity poses (the exact
    engine's kernel-only call); returns the last launch's (B, 2, 8, 8) blocks."""
    rot, trans = _identity(packed[0].shape[0], packed[0].device)
    for _ in range(params.max_iterations):
        blocks = icp_fused.icp_step_fused(rot, trans, *packed, intrinsics, params)
    return blocks


def run(argv=None) -> h.Outcome:
    ap = h.parser(__doc__.splitlines()[0], calls=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--radius", type=int, default=2, help="band radius of the banded association")
    ap.add_argument("--engine", choices=["v3"], default="v3")
    args = h.parse(ap, argv)
    device = h.setup(args.device)
    params = IcpParams(max_iterations=args.iters, engine="pallas", band_radius=args.radius)
    sources, targets = synthetic_pairs(args.batch, device)
    units = args.batch * args.iters  # pair-iterations a call
    kernel_metric, full_metric = metrics(args.engine, args.radius)

    full = h.measure(lambda: full_align(sources, targets, params), device, args)
    h.describe(f"full align {args.engine} r{args.radius}, µs a pair-iteration", full.summary(units, "us"), "us")
    packed = packed_pairs(sources, targets, "pallas")
    kernel = h.measure(lambda: kernel_steps(packed, targets.intrinsics, params), device, args)
    h.describe(f"kernel only {args.engine} r{args.radius}, µs a pair-iteration", kernel.summary(units, "us"), "us")
    del packed

    exact = params.replace(engine="xla")
    packed = packed_pairs(sources, targets, "xla")
    xla_full = h.measure(lambda: align(packed, sources.intrinsics, exact), device, args)
    xla_kernel = h.measure(lambda: exact_kernel_steps(packed, sources.intrinsics, exact), device, args)
    h.describe("exact engine: full align, µs a pair-iteration", xla_full.summary(units, "us"), "us")
    h.describe("exact engine: kernel only, µs a pair-iteration", xla_kernel.summary(units, "us"), "us")
    summaries = {name: t.summary(units, "us") for name, t in
                 (("full", full), ("xla_full", xla_full), ("xla_kernel", xla_kernel))}
    line = h.record(kernel_metric, "us", kernel, device, units=units, batch=args.batch, iterations=args.iters,
                    radius=args.radius, engine=args.engine, **{full_metric: summaries["full"]["value"]},
                    full_align=summaries["full"], xla_kernel_only_us_per_pair_iter=summaries["xla_kernel"]["value"],
                    xla_full_align_us_per_pair_iter=summaries["xla_full"]["value"],
                    xla_kernel_only=summaries["xla_kernel"], xla_full_align=summaries["xla_full"])
    return h.Outcome(line, {"kernel_only": kernel.result, "full_align": full.result,
                            "xla_kernel_only": xla_kernel.result, "xla_full_align": xla_full.result})


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
