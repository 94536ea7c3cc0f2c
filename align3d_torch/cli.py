"""Command line of the port (``align3d-torch``), the subcommands of
``align3d_tpu/cli.py``:

    python -m align3d_torch.cli odometry {slamtb,tum,ilrgbd} <dataset> [max_frames]
        [--engine {xla,pallas,pallas_v4} [--coarse-exact]] [--checkpoint PATH [--checkpoint-every N]] [--loop-closure] [--show PATH]
    python -m align3d_torch.cli viewer {slamtb,tum,ilrgbd} <dataset> [-o PATH]
        [--max-frames N] [--animate | --interactive [--port P]]

Both run on the GPU (``--device cuda``, the default, which fails when CUDA
is absent); ``--device cpu`` selects the plain-PyTorch path. Frames decode
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


def _check_device(device: str) -> None:
    import torch

    if device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available (pass --device cpu for the CPU path)")


def cmd_odometry(args) -> int:
    from align3d_torch.icp.params import MsIcpParams
    from align3d_torch.io.datasets import SubsetDataset, load_dataset
    from align3d_torch.io.datasets.core import PrefetchingDataset, maybe_prefetch
    from align3d_torch.odometry import refine_with_loop_closures, run_odometry
    from align3d_torch.ops.bilateral import BilateralFilter
    from align3d_torch.range_image import RangeImageBuilder

    _check_device(args.device)
    loaded = maybe_prefetch(load_dataset(args.format, args.dataset))
    dataset = loaded
    if args.max_frames is not None:
        dataset = SubsetDataset(loaded, range(min(args.max_frames, len(loaded))))
    builder = RangeImageBuilder(bilateral_filter=None if args.no_bilateral else BilateralFilter())
    params = (
        MsIcpParams.default()
        if args.engine == "xla"
        else MsIcpParams.default_tpu(args.engine, coarse_exact=args.coarse_exact)
    )
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
    if args.show is not None:
        # Reference --show hands off to the dataset viewer
        # (examples/src/bin/odometry.rs:15-28 + rgbd_dataset_viewer.rs); the
        # headless analog renders the clouds posed by the ESTIMATED
        # trajectory: a GIF fly-through for .gif outputs, else a PNG.
        from align3d_torch.viz.dataset_viewer import render_dataset_flythrough, render_dataset_preview

        render = render_dataset_flythrough if args.show.lower().endswith(".gif") else render_dataset_preview
        out = render(args.format, args.dataset, args.show, max_frames=args.max_frames, trajectory=result.trajectory,
                     device=args.device)
        print(f"Wrote {out}")
    return 0


def cmd_viewer(args) -> int:
    from align3d_torch.viz.dataset_viewer import render_dataset_flythrough, render_dataset_preview

    _check_device(args.device)
    if args.interactive:
        from align3d_torch.io.datasets import load_dataset
        from align3d_torch.viz.viewers import RgbdDatasetViewer

        dataset = load_dataset(args.format, args.dataset)
        # Unless explicitly capped, keep the interactive scene at show()'s
        # own default (8 frames): a full TUM sequence would otherwise load
        # thousands of frames before serving.
        max_frames = args.max_frames if args.max_frames is not None else 8
        RgbdDatasetViewer(dataset, device=args.device).show(max_frames=max_frames, port=args.port)
        return 0
    if args.animate or args.output.lower().endswith(".gif"):
        output = args.output if args.output.lower().endswith(".gif") else args.output + ".gif"
        out = render_dataset_flythrough(args.format, args.dataset, output, max_frames=args.max_frames,
                                        device=args.device)
    else:
        out = render_dataset_preview(args.format, args.dataset, args.output, max_frames=args.max_frames,
                                     device=args.device)
    print(f"Wrote {out}")
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
        help="ICP engine: exact association (xla; CUDA kernel K1), or the banded "
        "association of the fused kernels: v3 (pallas, f32 pack; K7) or v4 (pallas_v4, "
        "slim int pack + bf16 reduction; K8). The banded engines associate within a "
        "tracked displacement band (radius 2 at the coarsest level), adequate for "
        "ordinary frame-to-frame motion; for fast motion (several degrees/frame) add "
        "--coarse-exact",
    )
    p_odo.add_argument(
        "--coarse-exact",
        action="store_true",
        help="with a pallas engine: keep the exact association at the coarsest "
        "pyramid level (handles arbitrary displacement; the finer levels stay on "
        "the banded kernel)",
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
    p_odo.add_argument(
        "--show",
        metavar="PATH",
        default=None,
        help="after odometry, render the reconstruction posed by the "
        "estimated trajectory (reference odometry --show): animated GIF "
        "fly-through if PATH ends in .gif, else a single PNG",
    )
    p_odo.set_defaults(fn=cmd_odometry)

    p_view = sub.add_parser("viewer", help="render dataset + trajectory preview PNG")
    p_view.add_argument("format")
    p_view.add_argument("dataset")
    p_view.add_argument("--output", "-o", default="dataset_preview.png")
    p_view.add_argument("--max-frames", type=int, default=None)
    p_view.add_argument(
        "--animate",
        action="store_true",
        help="render an orbiting GIF fly-through instead of a single PNG",
    )
    p_view.add_argument(
        "--interactive",
        action="store_true",
        help="serve an interactive viewer (WASD fly, mouse orbit, 1..9 "
        "visibility toggles, Q quit) at http://127.0.0.1:PORT/",
    )
    p_view.add_argument("--port", type=int, default=8700)
    p_view.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p_view.set_defaults(fn=cmd_viewer)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
