"""Faulty ranks for the sharded cell's CPU tests (``test_sharded_cell.py``):
each is a worker entry point that breaks rank 2 of the group, then runs the
driver's own worker. The test puts one in place of
``benchmark.drivers.sharded._worker`` in the harness's process; the
spawned ranks import this module by name."""

from __future__ import annotations

import os
import signal
import time

from benchmark.drivers import sharded

#: Steps of the warm-up (one a window of the pool); the window's steps follow.
WARM_STEPS = 4


def nudged_on_rank_2(rank: int, *args) -> None:
    """Rank 2 moves its first pair's relative pose (the halo pair) by 1 mm."""
    if rank == 2:
        from align3d_torch.parallel import batch as pb

        real = pb.multiscale_align_batched

        def align(*a, **k):
            pose = real(*a, **k)
            trans = pose.translation.clone()
            trans[0, 0] += 1e-3
            return type(pose)(pose.rotation, trans)

        pb.multiscale_align_batched = align
    sharded._worker(rank, *args)


def killed_mid_window(rank: int, *args) -> None:
    """Rank 2 is killed (SIGKILL) as its second step of the window starts."""
    if rank == 2:
        from align3d_torch.parallel import batch as pb

        real, calls = pb.odometry_step, [0]

        def step(*a, **k):
            calls[0] += 1
            if calls[0] > WARM_STEPS + 1:
                os.kill(os.getpid(), signal.SIGKILL)
            return real(*a, **k)

        pb.odometry_step = step
    sharded._worker(rank, *args)


def stuck_mid_window(rank: int, *args) -> None:
    """Rank 2 stops making progress (sleeps) as its second step of the window starts."""
    if rank == 2:
        from align3d_torch.parallel import batch as pb

        real, calls = pb.odometry_step, [0]

        def step(*a, **k):
            calls[0] += 1
            if calls[0] > WARM_STEPS + 1:
                time.sleep(3600)
            return real(*a, **k)

        pb.odometry_step = step
    sharded._worker(rank, *args)
