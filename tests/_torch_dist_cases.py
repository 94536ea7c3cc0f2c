"""Rank functions of the port's multi-process tests
(``tests/test_torch_distributed.py``, ``tests/test_torch_multihost.py``).

Each test process starts W fresh processes (``spawn``) that import this
module by name, so it imports neither JAX nor a test module: a rank
function reads its inputs from an npz the test wrote, runs the port's
sharded paths on a gloo group of W CPU ranks, and writes what it got to
``rank<r>.npz``. Imported as a top-level module (pytest puts ``tests/`` on
the path).
"""

from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 120  # a hung collective or rank fails its test after this


def spawn(fn, world: int, workdir, *args, timeout: float = TIMEOUT_S) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes joined in
    one gloo group (a file store under ``workdir``: no TCP port to collide
    on); raises if a rank raises, or if the ranks are not done within
    ``timeout`` seconds (then every rank is killed)."""
    import torch.multiprocessing as mp

    store = os.path.join(str(workdir), f"store{world}")
    ctx = mp.start_processes(_rank_main, args=(fn, world, store, args), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)


def _rank_main(rank: int, fn, world: int, store: str, args) -> None:
    from _torch_cpu import start_rank

    from align3d_torch.parallel import multihost

    start_rank()
    multihost.initialize(f"file://{store}", world, rank, backend="gloo",
                         timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def synthetic_sequence(n_frames: int, h: int = 48, w: int = 64):
    """``tests/test_parallel.py::_synthetic_sequence`` in numpy: (fx, fy, cx,
    cy, width, height), colours (N, H, W, 3) u8, depths (N, H, W) u16."""
    rng = np.random.default_rng(0)
    camera = (40.0, 40.0, w / 2 - 0.5, h / 2 - 0.5, w, h)
    base_tex = rng.uniform(50, 200, size=(h + 16, w + 16, 3)).astype(np.uint8)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    colors, depths = [], []
    for i in range(n_frames):
        xi = xs + i
        relief = 40 * np.sin(xi * 0.35) * np.cos(ys * 0.3)
        depths.append((2000 + 3 * xi + 2 * ys + relief).astype(np.uint16))
        colors.append(base_tex[4 : 4 + h, 4 + i : 4 + i + w])
    return camera, np.stack(colors), np.stack(depths)


def camera(values):
    from align3d_torch.camera import CameraIntrinsics

    fx, fy, cx, cy, w, h = (float(v) for v in values)
    return CameraIntrinsics(fx=fx, fy=fy, cx=cx, cy=cy, width=int(w), height=int(h))


def small_params():
    """``tests/test_parallel.py``'s parameters: 2 levels x 3 GN iterations."""
    from align3d_torch.icp.params import IcpParams, MsIcpParams

    return MsIcpParams.repeat(2, IcpParams(max_iterations=3))


#: The benchmark's batch configurations' bilateral filter (sigma space, sigma colour, depth padding).
FILTER = (4.50000000225, 29.9999880000072, 16)
#: What the sequence path records a step on every rank.
SEQUENCE_SPANS = ("batch.step", "batch.upload", "dist.halo", "dist.gather")


def bilateral():
    from align3d_torch.ops.bilateral import BilateralFilter

    return BilateralFilter(*FILTER)


def graph(npz, prefix: str):
    from align3d_torch.convert import pose_graph_from_numpy

    return pose_graph_from_numpy(*(npz[f"{prefix}_{k}"] for k in ("rot", "trans", "edges", "mrot", "mtrans", "w")),
                                 device="cpu")


def problem(npz, prefix: str):
    from align3d_torch.convert import ba_problem_from_numpy

    keys = ("rot", "trans", "landmarks", "obs_pose", "obs_landmark", "obs_uv", "weights")
    intr = dict(zip(("fx", "fy", "cx", "cy", "width", "height"), npz[f"{prefix}_intr"].tolist()))
    intr["width"], intr["height"] = int(intr["width"]), int(intr["height"])
    return ba_problem_from_numpy(*(npz[f"{prefix}_{k}"] for k in keys), intr, obs_z=npz[f"{prefix}_obs_z"],
                                 device="cpu")


def poses(t) -> np.ndarray:
    """A batched Transform as (N, 3, 4) numpy."""
    return np.concatenate([t.rotation.cpu().numpy(), t.translation.cpu().numpy()[..., None]], axis=-1)


def sharded_paths(rank: int, world: int, inputs: str, out_dir: str) -> None:
    """Every sharded path of the port on one mesh of ``world`` CPU ranks,
    on the inputs the test wrote; writes this rank's results."""
    from align3d_torch.parallel import bundle_adjustment as ba
    from align3d_torch.parallel import pose_graph as pg
    from align3d_torch.parallel.batch import make_mesh, odometry_step
    from align3d_torch.parallel.sequence import odometry_sequence_parallel
    from align3d_torch.se3 import Transform
    from align3d_torch.trajectory import Trajectory

    npz = np.load(inputs)
    mesh = make_mesh(world, devices="cpu")
    intr, colors, depths = camera(npz["camera"]), npz["colors"], npz["depths"]
    out = {}
    out["step"] = poses(odometry_step(intr, 0.001, colors, depths, small_params(), 2, mesh=mesh,
                                      device="cpu").camera_to_world)
    for n in (8, 6):
        out[f"seq{n}"] = poses(odometry_sequence_parallel(intr, 0.001, colors[:n], depths[:n], mesh, small_params(),
                                                          pyramid_levels=2).camera_to_world)
    ring = graph(npz, "ring")
    z = Transform(torch.from_numpy(npz["ring_z"][:, :3]), torch.from_numpy(npz["ring_z"][:, 3]))
    traj = Trajectory(ring.nodes, torch.arange(9, dtype=torch.float32))
    out["pg_dense"] = poses(pg.refine_trajectory(traj, loop_edges=[(0, 8, z, 5.0)], iterations=5,
                                                 mesh=mesh).camera_to_world)
    out["pg_cg"] = poses(pg.optimize(graph(npz, "cg"), iterations=4, solver="cg", mesh=mesh))
    p, lm = ba.optimize(problem(npz, "ba_dense"), iterations=4, mesh=mesh)
    out["ba_dense_poses"], out["ba_dense_landmarks"] = poses(p), lm.numpy()
    p, lm = ba.optimize(problem(npz, "ba_coo"), iterations=3, solver="coo", mesh=mesh)
    out["ba_coo_poses"], out["ba_coo_landmarks"] = poses(p), lm.numpy()
    out.update(u16_blocks(rank, world, mesh, intr, colors, depths))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def u16_blocks(rank: int, world: int, mesh, intr, colors, depths) -> dict:
    """The deployment's form of the frame-sharded step: each rank hands its
    own block of u8 colour and u16 depth host arrays to ``host_local_batch``
    and calls ``odometry_step(mesh=)`` with the filter on, recording spans;
    what every rank reports alike: the trajectory, the spans recorded, the
    collectives and bytes the step put through, and whether its
    ``batch.step`` span counts this rank's pairs."""
    from align3d_torch.parallel import collectives as col
    from align3d_torch.parallel import multihost
    from align3d_torch.parallel.batch import odometry_step
    from align3d_torch.utils import profiling

    f = colors.shape[0] // world
    block = slice(rank * f, (rank + 1) * f)
    c = multihost.host_local_batch(mesh, colors[block])
    d = multihost.host_local_batch(mesh, depths[block])
    profiling.clear()
    c0, b0 = col.COLLECTIVES, col.BYTES
    with profiling.recording():
        traj = odometry_step(intr, 0.001, c, d, small_params(), 2, bilateral_filter=bilateral(), mesh=mesh)
    steps = [s for s in profiling.spans() if s.name == "batch.step"]
    pairs_ok = len(steps) == 1 and steps[0].parent < 0 and steps[0].pairs == (f - 1 if rank == 0 else f)
    out = {"u16_step": poses(traj.camera_to_world), "u16_dtype": str(d.to_local().dtype),
           "seq_spans": np.asarray(sorted({s.name for s in profiling.spans()})),
           "seq_collectives": col.COLLECTIVES - c0, "seq_bytes": col.BYTES - b0, "seq_step_pairs_ok": pairs_ok}
    profiling.clear()
    return out


def host_local_paths(rank: int, world: int, inputs: str, out_dir: str) -> None:
    """``host_local_batch`` and ``replicate`` on ``world`` CPU ranks, and
    odometry of a frame-sharded batch: each rank feeds only its own block
    of frames."""
    from align3d_torch.parallel import multihost
    from align3d_torch.parallel.batch import odometry_step

    npz = np.load(inputs)
    mesh = multihost.global_mesh(devices="cpu")
    colors, depths = npz["colors"], npz["depths"]
    f = colors.shape[0] // world
    block = slice(rank * f, (rank + 1) * f)
    c = multihost.host_local_batch(mesh, colors[block])
    d = multihost.host_local_batch(mesh, depths[block].astype(np.int32))
    rep = multihost.replicate(mesh, np.arange(3.0))
    traj = odometry_step(camera(npz["camera"]), 0.001, c, d, small_params(), 2, mesh=mesh, device="cpu")
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), global_shape=np.asarray(c.shape),
             local_shape=np.asarray(c.to_local().shape), placements=str(c.placements),
             replicated=rep.to_local().numpy(), replicated_placements=str(rep.placements),
             step=poses(traj.camera_to_world))
