"""Two-process drill of the port's distribution layer (port of
``tools/run_multiprocess.py``).

    python -m align3d_torch.tools.run_multiprocess [--device cpu|cuda] [--fault]

Run from the root of a checkout. Two processes join one gloo group through
:func:`align3d_torch.parallel.multihost.initialize` (a file store in a
temporary directory) and build one mesh over both
(:func:`~align3d_torch.parallel.multihost.global_mesh`): on the CPU, or
with ``--device cuda`` both on the current card (NCCL refuses two ranks on
one device, so the drill names gloo, which carries CUDA tensors). Then:

1. the data-parallel pair step: each process feeds only its half of the
   pairs (source frames i + 1, target frames i) through
   :func:`~align3d_torch.parallel.multihost.host_local_batch`, aligns its
   local pairs and all-gathers the relative poses, which every process
   composes;
2. the pose graph of the resulting trajectory, nudged, with its edges
   sharded over both processes;

and process 0 checks both against one process's ``odometry_step`` and
unsharded ``optimize`` (within 1e-4) and prints ``PARITY OK``.

With ``--fault``, the failure drill: both processes run the first half of
the pairs, process 0 checkpoints the partial trajectory
(:mod:`align3d_torch.checkpoint`) and process 1 aborts (exit code 17, a
lost host); two fresh processes resume from the checkpoint, run the second
half and stitch it on, and process 0 checks the whole against the
uninterrupted one-process trajectory (within 5e-4: the chunked
composition reassociates the SE(3) products) and prints ``RESUME OK``.

The exit code is 0 only if every process exited as planned and the check
passed.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

NPROC = 2
H, W = 120, 160
NFRAMES = 9  # 8 pairs, 4 a process
FAULT_FRAMES = 17  # 16 pairs: two halves of 8, 4 a process each
FAULT_EXIT = 17
PARITY_ATOL = 1e-4
RESUME_ATOL = 5e-4
TIMEOUT_S = 600
ROOT = Path(__file__).resolve().parents[2]


def make_problem(nframes: int = NFRAMES):
    """The JAX drill's sequence: a random texture sliding one pixel a frame
    over a slanted plane with depth noise, 160x120."""
    import numpy as np

    rng = np.random.default_rng(7)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    tex = rng.uniform(30, 220, size=(H, W + nframes + 1, 3)).astype(np.uint8)
    colors = np.stack([tex[:, i : i + W] for i in range(nframes)])
    depths = np.stack([(2000 + 4 * (xs + i) + 2 * ys + rng.integers(0, 8, size=(H, W))).astype(np.uint16)
                       for i in range(nframes)])
    return colors, depths


def intrinsics():
    from align3d_torch.camera import CameraIntrinsics

    return CameraIntrinsics(fx=130.0, fy=130.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5, width=W, height=H)


def single_process_reference(colors, depths, device):
    """One process, no mesh: the same pipeline."""
    from align3d_torch.icp.params import MsIcpParams
    from align3d_torch.parallel.batch import odometry_step

    return odometry_step(intrinsics(), 0.001, colors, depths, MsIcpParams.default(), 3, device=device)


def pair_step(mesh, colors, depths, first_pair: int, count: int):
    """Pairs [first_pair, first_pair + count), each process feeding its
    half through ``host_local_batch``: the relative poses of all of them,
    composed on every process."""
    from align3d_torch.icp.params import MsIcpParams
    from align3d_torch.parallel import collectives as col
    from align3d_torch.parallel import multihost
    from align3d_torch.parallel.batch import build_pyramids_batched, multiscale_align_batched
    from align3d_torch.trajectory import accumulate_scan

    per = count // NPROC
    base = first_pair + col.rank(mesh) * per
    src_c = multihost.host_local_batch(mesh, colors[base + 1 : base + per + 1])
    src_d = multihost.host_local_batch(mesh, depths[base + 1 : base + per + 1].astype("int32"))
    tgt_c = multihost.host_local_batch(mesh, colors[base : base + per])
    tgt_d = multihost.host_local_batch(mesh, depths[base : base + per].astype("int32"))
    intr = intrinsics()
    src = build_pyramids_batched(intr, 0.001, col.local(src_c), col.local(src_d))
    tgt = build_pyramids_batched(intr, 0.001, col.local(tgt_c), col.local(tgt_d))
    relative = multiscale_align_batched(tgt, src, MsIcpParams.default())
    return accumulate_scan(col.gather_poses(mesh, relative, per))


def max_gap(a, b) -> float:
    return float((a.translation.cpu() - b.translation.cpu()).abs().max())


def worker(pid: int, device: str, workdir: str) -> int:
    import torch

    from align3d_torch.parallel import multihost
    from align3d_torch.parallel import pose_graph as pg
    from align3d_torch.se3 import Transform
    from align3d_torch.trajectory import Trajectory

    multihost.initialize(f"file://{workdir}/store", NPROC, pid, local_device_ids=[0] if device == "cuda" else None,
                         backend="gloo")
    mesh = multihost.global_mesh(devices=device)
    colors, depths = make_problem()

    t0 = time.perf_counter()
    traj = pair_step(mesh, colors, depths, 0, NFRAMES - 1)
    step_s = time.perf_counter() - t0

    # The pose graph of the trajectory nudged off its odometry, edges sharded.
    nudge = 0.01 * torch.sin(torch.arange(NFRAMES, dtype=torch.float32))[:, None].to(traj.times.device)
    poses = traj.camera_to_world
    noisy = Trajectory(Transform(poses.rotation, poses.translation + nudge), traj.times)
    graph = pg.PoseGraph.from_trajectory(noisy)
    refined = pg.optimize(graph, iterations=5, mesh=mesh)
    ok = True
    if pid == 0:
        ref = single_process_reference(colors, depths, device)
        odo_err = max_gap(ref.camera_to_world, traj.camera_to_world)
        pg_err = max_gap(pg.optimize(graph, iterations=5), refined)
        print(f"[multihost] procs={NPROC} device={device} backend=gloo odo_parity={odo_err:.2e} "
              f"pg_parity={pg_err:.2e} step={step_s:.2f}s", flush=True)
        ok = odo_err < PARITY_ATOL and pg_err < PARITY_ATOL
        print("[multihost] PARITY OK" if ok else "[multihost] PARITY FAIL", flush=True)
    torch.distributed.destroy_process_group()
    return 0 if ok else 1


def worker_fault(pid: int, device: str, workdir: str, phase: int) -> int:
    import torch

    from align3d_torch import checkpoint
    from align3d_torch.parallel import multihost
    from align3d_torch.trajectory import Trajectory

    multihost.initialize(f"file://{workdir}/store{phase}", NPROC, pid,
                         local_device_ids=[0] if device == "cuda" else None, backend="gloo")
    mesh = multihost.global_mesh(devices=device)
    colors, depths = make_problem(FAULT_FRAMES)
    half = (FAULT_FRAMES - 1) // 2
    ckpt = os.path.join(workdir, "odometry.npz")
    if phase == 1:
        traj = pair_step(mesh, colors, depths, 0, half)
        if pid == 0:
            checkpoint.save_odometry(ckpt, traj, next_frame=half + 1)
            print(f"[fault] phase 1 checkpointed at frame {half + 1}", flush=True)
        torch.distributed.barrier()
        if pid == 1:
            os._exit(FAULT_EXIT)  # a lost host
        return 0

    prev, next_frame = checkpoint.load_odometry(ckpt)
    second = pair_step(mesh, colors, depths, next_frame - 1, FAULT_FRAMES - next_frame)
    # The second half's poses are relative to the checkpoint's last pose.
    last = prev.camera_to_world[len(prev) - 1].to(second.times.device)
    tail = (last @ second.camera_to_world)[1:]
    prev_poses = prev.camera_to_world.to(second.times.device)
    stitched = Trajectory(type(tail)(torch.cat([prev_poses.rotation, tail.rotation]),
                                     torch.cat([prev_poses.translation, tail.translation])),
                          torch.arange(FAULT_FRAMES, dtype=torch.float32))
    ok = True
    if pid == 0:
        ref = single_process_reference(colors, depths, device)
        err = max_gap(ref.camera_to_world, stitched.camera_to_world)
        print(f"[fault] resume parity against the uninterrupted run: {err:.2e}", flush=True)
        ok = err < RESUME_ATOL
        print("[fault] RESUME OK" if ok else "[fault] RESUME FAIL", flush=True)
    torch.distributed.destroy_process_group()
    return 0 if ok else 1


def launch(device: str, workdir: str, extra: list[str]) -> list[int]:
    """Start the two processes and wait for both (killing both past
    ``TIMEOUT_S``); echo process 0's output, and a failed process's.
    Returns their exit codes (a killed process: -9)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-m", "align3d_torch.tools.run_multiprocess", "--worker", str(pid),
                               "--device", device, "--workdir", workdir, *extra],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in range(NPROC)]
    deadline = time.monotonic() + TIMEOUT_S
    outs, rcs = [], []
    for proc in procs:
        try:
            out, _ = proc.communicate(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            out, _ = proc.communicate()
            out += f"\n[drill] process killed after {TIMEOUT_S} s\n"
        outs.append(out)
        rcs.append(proc.returncode)
    for pid, (out, rc) in enumerate(zip(outs, rcs)):
        if pid == 0 or rc not in (0, FAULT_EXIT):
            sys.stdout.write(out if pid == 0 else f"[drill] process {pid} exited {rc}:\n{out}")
    sys.stdout.flush()
    return rcs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    parser.add_argument("--fault", action="store_true", help="the abort-and-resume drill")
    parser.add_argument("--worker", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--workdir", help=argparse.SUPPRESS)
    parser.add_argument("--fault-phase", type=int, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker is not None:
        import torch

        torch.set_num_threads(1)  # two processes beside other work: no oversubscription
        if args.fault_phase:
            return worker_fault(args.worker, args.device, args.workdir, args.fault_phase)
        return worker(args.worker, args.device, args.workdir)

    if args.device == "cuda":
        from align3d_torch import _kernels

        _kernels.build()  # once, before two processes could race to build
    with tempfile.TemporaryDirectory() as workdir:
        if not args.fault:
            return 0 if launch(args.device, workdir, []) == [0, 0] else 1
        if launch(args.device, workdir, ["--fault-phase", "1"]) != [0, FAULT_EXIT]:
            print("[fault] phase 1 did not end as planned (process 1 should abort with 17)")
            return 1
        print("[fault] process 1 lost; restarting from the checkpoint", flush=True)
        return 0 if launch(args.device, workdir, ["--fault-phase", "2"]) == [0, 0] else 1


if __name__ == "__main__":
    sys.exit(main())
