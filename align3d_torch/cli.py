"""Command line of the port (``align3d-torch``), the ``odometry`` subcommand
of ``align3d_tpu/cli.py``.

    python -m align3d_torch.cli odometry {slamtb,tum,ilrgbd} <dataset> [max_frames]
        [--checkpoint PATH [--checkpoint-every N]] [--loop-closure]

It runs on the GPU (``--device cuda``, the default, which fails when CUDA is
absent); ``--device cpu`` selects the plain-PyTorch path. Frames decode
ahead of the aligner in the native loader's worker pool where that library
builds (:func:`align3d_torch.io.datasets.core.maybe_prefetch`).
"""

from __future__ import annotations

import argparse
import sys


def _progress_printer(total_width: int = 40):
    def show(i, n):
        done = int(total_width * i / n)
        bar = "#" * done + "-" * (total_width - done)
        print(f"\rProcessing frames [{bar}] {i}/{n}", end="", file=sys.stderr)
        if i == n:
            print(file=sys.stderr)

    return show


def cmd_odometry(args) -> int:
    import torch

    from align3d_torch.icp.params import MsIcpParams
    from align3d_torch.io.datasets import SubsetDataset, load_dataset
    from align3d_torch.io.datasets.core import PrefetchingDataset, maybe_prefetch
    from align3d_torch.odometry import refine_with_loop_closures, run_odometry
    from align3d_torch.ops.bilateral import BilateralFilter
    from align3d_torch.range_image import RangeImageBuilder

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available (pass --device cpu for the CPU path)")

    loaded = maybe_prefetch(load_dataset(args.format, args.dataset))
    dataset = loaded
    if args.max_frames is not None:
        dataset = SubsetDataset(loaded, range(min(args.max_frames, len(loaded))))
    builder = RangeImageBuilder(bilateral_filter=None if args.no_bilateral else BilateralFilter())
    params = MsIcpParams.default() if args.engine == "xla" else MsIcpParams.default_tpu(args.engine)
    try:
        result = run_odometry(
            dataset,
            args.device,
            range_builder=builder,
            icp_params=params,
            progress=None if args.quiet else _progress_printer(),
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
        )
        if args.loop_closure:
            before = f"{result.metrics}" if result.metrics is not None else "n/a"
            result = refine_with_loop_closures(dataset, result, args.device, range_builder=builder, icp_params=params)
            print(f"Mean trajectory error before loop closure: {before}")
    finally:
        if isinstance(loaded, PrefetchingDataset):
            loaded.close()
    if result.metrics is not None:
        print(f"Mean trajectory error: {result.metrics}")
    print(f"Seconds per frame: {result.seconds_per_frame:.4f}")
    if args.save_trajectory:
        with open(args.save_trajectory, "w") as f:
            f.write(result.trajectory.to_tum())
        print(f"Trajectory written to {args.save_trajectory} (TUM format)")
    return 0


def _positive_int(value: str) -> int:
    v = int(value)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="align3d_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_odo = sub.add_parser("odometry", help="frame-to-frame odometry over a dataset")
    p_odo.add_argument("format", help="dataset format: ilrgbd, tum, or slamtb")
    p_odo.add_argument("dataset", help="path to the dataset directory")
    p_odo.add_argument("max_frames", nargs="?", type=int, default=None)
    p_odo.add_argument("--no-bilateral", action="store_true")
    p_odo.add_argument(
        "--engine",
        choices=("xla", "pallas", "pallas_v4"),
        default="xla",
        help="accepted for compatibility with align3d-tpu: every engine runs "
        "the same fused GN step (CUDA kernel on the GPU, plain PyTorch on the CPU)",
    )
    p_odo.add_argument(
        "--coarse-exact",
        action="store_true",
        help="accepted for compatibility with align3d-tpu, where it keeps exact "
        "association at the coarsest level of a pallas engine: the port "
        "associates exactly at every level, so it changes nothing",
    )
    p_odo.add_argument(
        "--loop-closure",
        action="store_true",
        help="after odometry, detect loop closures and refine the "
        "trajectory with pose-graph Gauss-Newton",
    )
    p_odo.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p_odo.add_argument("--quiet", "-q", action="store_true")
    p_odo.add_argument("--save-trajectory", metavar="PATH")
    p_odo.add_argument(
        "--checkpoint",
        metavar="PATH",
        help="snapshot the in-progress trajectory here and resume from it "
        "if the file exists (an aborted run continues where it stopped)",
    )
    p_odo.add_argument("--checkpoint-every", type=_positive_int, default=10)
    p_odo.set_defaults(fn=cmd_odometry)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
