"""Weak-scaling efficiency of data-parallel odometry (the port's
``benches/bench_scaling.py``).

    python -m align3d_torch.benches.bench_scaling [--device cpu] [--quick]

Each rank aligns ``--per-device`` (8) pairs of the JAX bench's synthetic
240x320 series (:func:`series`, seed 7) with ``MsIcpParams.default()``:
world W aligns W x 8 pairs. Two timings a world, each a median over the
repeats, every repeat ended by a barrier (so it is the slowest rank's):

* **full**: ``odometry_step(mesh=)``, the whole trajectory on every rank
  (the pose gather and the prefix scan are the only communication);
* **dp**: each rank's own pairs only (``align_frames``), no collective.

Efficiency is t_full(1) / t_full(2); the collective fraction is
(t_full(2) - t_dp(2)) / t_full(2).

* ``--device cpu``, the JAX bench's own method: worlds 1 and 2 as gloo
  ranks in new processes, each pinned to one core
  (``os.sched_setaffinity``) at one thread, so the number describes the
  program and not the host's spare cores.
* ``--device cuda`` (the default): NCCL over the cards there are. With two
  or more, worlds 1 and 2 are ranks in new processes, one card each. With
  one, world 1 runs in this process (a one-rank NCCL group) and is timed
  with the harness; the value is null with the reason ``one card``: two
  ranks sharing one card measure the host, not scaling.

Prints one JSON line: ``dp_odometry_weak_scaling_eff_2dev_pinned``. The
harness's fields beside it (``host_ms``, ``device_busy_ms``, ``launches``,
...) describe world 1's full step; ``runs``, ``min`` and ``max`` are each
repeat's efficiency.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from align3d_torch.benches import _harness as h
from align3d_torch.camera import CameraIntrinsics
from align3d_torch.icp.params import MsIcpParams
from align3d_torch.parallel import batch as pb
from align3d_torch.parallel import collectives as col

METRIC = "dp_odometry_weak_scaling_eff_2dev_pinned"
H, W = 240, 320
DEPTH_SCALE = 0.001
RANK_TIMEOUT_S = 1800


def camera(height: int = H, width: int = W) -> CameraIntrinsics:
    return CameraIntrinsics(fx=260.0, fy=260.0, cx=width / 2 - 0.5, cy=height / 2 - 0.5, width=width, height=height)


def series(pairs: int, height: int = H, width: int = W) -> tuple[np.ndarray, np.ndarray]:
    """``benches/bench_scaling.py::worker``'s frames, ``pairs + 1`` of them:
    (colors (N, h, w, 3) u8, depths (N, h, w) u16), seed 7."""
    rng = np.random.default_rng(7)
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    tex = rng.uniform(30, 220, size=(height, width + pairs + 1, 3)).astype(np.uint8)
    colors = np.stack([tex[:, i : i + width] for i in range(pairs + 1)])
    depths = np.stack([(2000 + 4 * (xs + i) + 2 * ys + rng.integers(0, 8, size=(height, width))).astype(np.uint16)
                       for i in range(pairs + 1)])
    return colors, depths


def steps(mesh, device, per_device: int, height: int, width: int):
    """(full, dp): the two timed calls of one rank of ``mesh``."""
    params = MsIcpParams.default()
    intr = camera(height, width)
    colors, depths = series(per_device * col.world(mesh), height, width)

    def full():
        return pb.odometry_step(intr, DEPTH_SCALE, colors, depths, params, device=device, mesh=mesh).camera_to_world

    lo, hi, _ = col.share(len(depths) - 1, mesh)
    mine = pb.frame_inputs(colors, depths, slice(lo, hi + 1), device)

    def dp():
        return pb.align_frames(intr, DEPTH_SCALE, *mine, params, 3, None)

    return full, dp


def _rank(rank: int, world: int, store: str, out: str, device_type: str, cores: list, per_device: int, height: int,
          width: int, runs: int, warmup: int) -> None:
    """One rank of a spawned world: time full and dp, rank 0 writes them."""
    import torch.distributed as dist

    from align3d_torch.parallel import multihost

    if device_type == "cpu":
        os.sched_setaffinity(0, {cores[rank]})
        torch.set_num_threads(1)
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    multihost.initialize(f"file://{store}", world, rank, backend="gloo" if device_type == "cpu" else "nccl")
    try:
        mesh = pb.make_mesh(devices=device_type)
        full, dp = steps(mesh, device, per_device, height, width)
        times = {}
        for name, fn in (("full", full), ("dp", dp)):
            for _ in range(warmup):
                fn()
            times[name] = []
            for _ in range(runs):
                dist.barrier()
                t0 = time.perf_counter()
                fn()
                h.sync(device)
                dist.barrier()
                times[name].append((time.perf_counter() - t0) * 1e3)
        pose = full()
        if rank == 0:
            np.savez(Path(out) / "pose.npz", rotation=pose.rotation.cpu().numpy(),
                     translation=pose.translation.cpu().numpy())
            (Path(out) / "times.json").write_text(json.dumps(times))
    finally:
        dist.destroy_process_group()


def spawn_world(world: int, device_type: str, args, cores: list) -> dict:
    """Run ``world`` ranks in new processes; rank 0's timings (ms a step)
    and pose."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank, args=(world, str(Path(tmp) / "store"), tmp, device_type, cores,
                                              args.per_device, args.height, args.width, args.runs, args.warmup),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"world {world} still running after {RANK_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        out = json.loads((Path(tmp) / "times.json").read_text())
        with np.load(Path(tmp) / "pose.npz") as z:
            out["pose"] = (torch.from_numpy(z["rotation"]), torch.from_numpy(z["translation"]))
    return out


def one_card(args, device) -> h.Outcome:
    """World 1 in this process, timed by the harness; no efficiency."""
    import torch.distributed as dist

    mesh = pb.make_mesh(devices=device.type)
    try:
        full, dp = steps(mesh, device, args.per_device, args.height, args.width)
        t_full = h.measure(full, device, args)
        h.describe(f"world 1, full step of {args.per_device} pairs, ms", t_full.summary(), "ms")
        t_dp = h.measure(dp, device, args)
        h.describe("world 1, dp step, ms", t_dp.summary(), "ms")
    finally:
        dist.destroy_process_group()
    s = t_full.summary()
    line = {"metric": METRIC, "value": None, "unit": "fraction", "vs_baseline": None, "reason": "one card",
            "runs": [], "min": None, "max": None, **{k: v for k, v in s.items() if k not in ("value", "runs", "min", "max")},
            "device": str(device), "card": h.card(device),
            "worlds": {"1": {"full_ms": s["value"], "full": s, "dp_ms": t_dp.summary()["value"]}},
            "per_device": args.per_device, "size": [args.width, args.height], "cards": torch.cuda.device_count()}
    print(json.dumps(line), flush=True)
    return h.Outcome(line, (t_full.result.rotation, t_full.result.translation))


def run(argv=None) -> h.Outcome:
    ap = h.parser(__doc__.splitlines()[0], calls=1)
    ap.add_argument("--per-device", type=int, default=8, help="pairs a rank")
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--width", type=int, default=W)
    args = h.parse(ap, argv)
    device = h.setup(args.device)
    if device.type == "cuda" and torch.cuda.device_count() < 2:
        return one_card(args, device)
    cores = sorted(os.sched_getaffinity(0))
    if device.type == "cpu" and len(cores) < 2:
        raise RuntimeError("the pinned measurement needs two cores")
    h.log(f"weak scaling, {args.per_device} pairs a rank at {args.width}x{args.height}, "
          + ("one core a rank" if device.type == "cpu" else "one card a rank"))
    worlds = {w: spawn_world(w, device.type, args, cores) for w in (1, 2)}
    for w, r in worlds.items():
        h.log(f"world {w}: full {statistics.median(r['full']):.1f} ms, dp {statistics.median(r['dp']):.1f} ms "
              f"(runs full {r['full']}, dp {r['dp']})")
    t1, t2 = worlds[1]["full"], worlds[2]["full"]
    effs = [a / b for a, b in zip(t1, t2)]
    eff = statistics.median(t1) / statistics.median(t2)
    full2, dp2 = statistics.median(t2), statistics.median(worlds[2]["dp"])
    line = {"metric": METRIC, "value": eff, "unit": "fraction", "vs_baseline": None, "runs": effs, "min": min(effs),
            "max": max(effs), "host_ms": statistics.median(t1), "host_runs": t1, "device_busy_ms": None,
            "busy_share": None, "launches": None, "profiler_launches": None, "calls": 1,
            "collective_fraction": max(0.0, (full2 - dp2) / full2), "device": str(device), "card": h.card(device),
            "worlds": {str(w): {"full_ms": statistics.median(r["full"]), "full_runs": r["full"],
                                "dp_ms": statistics.median(r["dp"]), "dp_runs": r["dp"]} for w, r in worlds.items()},
            "per_device": args.per_device, "size": [args.width, args.height]}
    print(json.dumps(line), flush=True)
    return h.Outcome(line, worlds[1]["pose"])


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
