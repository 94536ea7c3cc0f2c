"""Re-processing a recording on several cards: the frame-sharded odometry
step, one process a card, through the port's own entry points.

The harness's process is rank 0, on the device it is given (``cuda:0``);
:meth:`Driver.setup` starts ranks 1 .. R-1 as worker processes, rank r on
``cuda:r`` (on the CPU, for the harness's own tests, every rank on the CPU
over gloo). Each joins one process group with
``multihost.initialize(..., local_device_ids=[r])`` (NCCL on the cards;
every collective and store wait bounded by :data:`BOUND_S`) and makes
``multihost.global_mesh()``. Every rank draws the same pool of windows of
``frames_per_step`` frames from the traffic and the seed and keeps only its
own contiguous block of each (rank r: frames [rF, rF + F), F =
``frames_per_step`` / R) as host arrays, u8 colour and u16 depth as a
recording reader yields them. A step is, on every rank,
``odometry_step(..., mesh=mesh)`` of ``multihost.host_local_batch`` of its
block, which routes to ``odometry_sequence_parallel``: the one-frame halo,
the rank's pairs, the pose gather, the trajectory on every rank. Rank 0
reads the trajectory back to the host; the window is closed-loop.

Control goes through the process group's store, on the host, never through
a device collective: rank 0 sets ``bench/cmd/<n>`` for the n-th command,
``step`` (run window w, keep its outputs or not, forget the outputs no
longer sampled), ``report`` (peak memory and loaded modules, once the window
has closed), ``send`` (write the sampled steps' outputs to files) and
``stop``. A worker that exits before it is told to stop ends the run at
once with exit code 1; a stuck one fails the run when a collective or a
store wait passes :data:`BOUND_S`; a worker whose rank 0 is gone exits.

``correct``: for each sampled step, every frame and pair as each rank
computed them (the halo frames and the halo pairs too) held to the plain
reference, worked out a rank's block at a time from the raw frames; the
trajectory against its own relative poses; every rank's trajectory bitwise
rank 0's, and rank 0's bitwise the port's unsharded ``odometry_step`` of the
same frames on rank 0's device, run once the workers have stopped. A
trajectory that is not bitwise equal makes ``traj_maxabs`` infinite.
"""

from __future__ import annotations

import datetime
import json
import math
import multiprocessing
import os
import shutil
import socket
import sys
import tempfile
import threading
import time
from multiprocessing.connection import wait as wait_for
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from benchmark import check, roofline
from benchmark.drivers import icp_params, sync
from benchmark.drivers.batch import _MarkingTimer
from benchmark.reference import pipeline

UNIT = "step"
#: Seconds that any wait of the deployment may last: a collective, a store wait, a worker's start or stop.
BOUND_S = 120
KEY = "bench/"
LEVEL_KEYS = ("points", "normals", "intensity_map")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=BOUND_S)


class _Rank:
    """One rank's share: its block of each window of the pool as host
    arrays, the program's objects, and the capture of a step's stages
    (``build_pyramids_batched``'s filtered depths and pyramids,
    ``multiscale_align_batched``'s relative poses, as the batch driver
    keeps them)."""

    def __init__(self, config: dict, traffic, seed: int, rank: int, device):
        from align3d_torch.camera import CameraIntrinsics
        from align3d_torch.ops.bilateral import BilateralFilter

        self.config, self.rank, self.device = config, rank, torch.device(device)
        self.ranks = int(config["ranks"])
        frames = int(config["frames_per_step"])
        if frames % self.ranks or int(config["pairs_per_step"]) != frames - 1:
            raise ValueError(f"{frames} frames a step on {self.ranks} ranks: need a multiple of the ranks "
                             f"and pairs_per_step = frames - 1")
        self.block = frames // self.ranks
        self.fixtures = traffic.load_fixtures(config.get("stride", 1))
        lengths = {k: len(v) for k, v in self.fixtures.items()}
        cams = {fx.camera for fx in self.fixtures.values()}
        if len(cams) != 1:
            raise RuntimeError("a step's frames must share one camera")
        self.camera = CameraIntrinsics(*cams.pop())
        lo = rank * self.block
        self.pool = []
        for keys in traffic.windows(seed, lengths, frames):
            mine = keys[lo:lo + self.block]
            scales = [self.fixtures[f].depth_scale for f, _ in keys]
            self.pool.append({
                "frames": keys,
                "colors": np.stack([self.fixtures[f].colors[i] for f, i in mine]),
                "depths": np.stack([self.fixtures[f].depths[i] for f, i in mine]),
                # One depth scale, or one a frame of the whole window (the sequence path indexes it globally).
                "scale": scales[0] if len(set(scales)) == 1 else np.asarray(scales, np.float32),
            })
        filt = config["bilateral_filter"]
        self.filter = BilateralFilter(filt["sigma_space"], filt["sigma_color"], filt["pad_depth_to"])
        self.params = icp_params(config)
        self.mesh = None
        self._install()

    def _install(self) -> None:
        from align3d_torch.parallel import batch as pb

        self._pb, self._orig = pb, (pb.build_pyramids_batched, pb.multiscale_align_batched)
        build, align = self._orig
        self.capture = None

        def build_pyramids_batched(intrinsics, depth_scale, colors, depths, *args, **kwargs):
            out = build(intrinsics, depth_scale, colors, depths, *args, **kwargs)
            if self.capture is not None:
                self.capture["depth"], self.capture["pyramid"] = depths, out
            return out

        def multiscale_align_batched(*args, **kwargs):
            out = align(*args, **kwargs)
            if self.capture is not None:
                self.capture["rel"] = out
            return out

        pb.build_pyramids_batched = build_pyramids_batched
        pb.multiscale_align_batched = multiscale_align_batched

    def uninstall(self) -> None:
        """Put the program's functions back."""
        if getattr(self, "_orig", None) is not None:
            self._pb.build_pyramids_batched, self._pb.multiscale_align_batched = self._orig
            self._orig = None

    def join(self, address: str) -> None:
        """Join the process group and make the mesh (the port's entry points)."""
        from align3d_torch.parallel import multihost

        on_card = self.device.type == "cuda"
        multihost.initialize(address, self.ranks, self.rank, local_device_ids=[self.device.index] if on_card else None,
                             backend=None if on_card else "gloo", timeout=_timeout())
        self.mesh = multihost.global_mesh(devices=self.device.type)

    def step(self, win: int, keep: bool, timer=None):
        """One step of window ``win`` on this rank: (the trajectory, the
        capture when ``keep``)."""
        from align3d_torch.parallel import batch as pb
        from align3d_torch.parallel import multihost

        w = self.pool[win]
        self.capture = {} if keep else None
        colors = multihost.host_local_batch(self.mesh, w["colors"])
        depths = multihost.host_local_batch(self.mesh, w["depths"])
        traj = pb.odometry_step(self.camera, w["scale"], colors, depths, self.params, self.config["pyramid_levels"],
                                self.filter, mesh=self.mesh, timer=timer)
        cap, self.capture = self.capture, None
        if keep and not {"depth", "pyramid", "rel"} <= set(cap):
            raise RuntimeError("odometry_step no longer calls build_pyramids_batched and multiscale_align_batched "
                               "of align3d_torch.parallel.batch: its stages cannot be checked")
        return traj, cap


def _poses(traj) -> torch.Tensor:
    """A trajectory's camera-to-world poses as (N, 3, 4)."""
    c2w = traj.camera_to_world
    return torch.cat([c2w.rotation, c2w.translation[..., None]], dim=-1)


def _outputs(traj, cap: dict, device) -> dict:
    """What a rank computed in one step, on ``device``."""
    return {"traj": _poses(traj).to(device), "depth": cap["depth"].to(device),
            "pyramid": [{k: getattr(ri, k).to(device) for k in LEVEL_KEYS} for ri in cap["pyramid"]],
            "rel": (cap["rel"].rotation.to(device), cap["rel"].translation.to(device))}


def _stitch(parts: list[dict]) -> dict:
    """The ranks' outputs of one step, in rank order along the frame axis."""
    return {"depth": torch.cat([p["depth"] for p in parts]),
            "pyramid": [{k: torch.cat([p["pyramid"][i][k] for p in parts]) for k in LEVEL_KEYS}
                        for i in range(len(parts[0]["pyramid"]))],
            "rel": tuple(torch.cat([p["rel"][j] for p in parts]) for j in range(2))}


def _exit_with_parent() -> None:
    """End this process once rank 0's is gone: a rank 0 that crashed, or
    that NCCL's watchdog tore down, runs no clean-up of its workers."""
    parent = os.getppid()

    def watch() -> None:
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def _worker(rank: int, address: str, config: dict, traffic_name: str, seed: int, device_type: str, threads: int,
            outdir: str) -> None:
    """Rank ``rank`` (> 0): run rank 0's commands until ``stop``."""
    _exit_with_parent()
    from benchmark import run as harness
    from benchmark import traffic

    torch.set_num_threads(threads)
    device = torch.device(device_type, rank) if device_type == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        from align3d_torch import _kernels

        torch.cuda.set_device(device)
        _kernels.lib()
    me = _Rank(config, traffic.Traffic(traffic_name), seed, rank, device)
    me.join(address)
    store = dist.distributed_c10d._get_default_store()
    kept, n = {}, 0
    try:
        while True:
            cmd = json.loads(store.get(f"{KEY}cmd/{n}"))
            if cmd["op"] == "step":
                for s in cmd["drop"]:
                    kept.pop(s, None)
                traj, cap = me.step(cmd["win"], cmd["keep"])
                if cmd["keep"]:
                    kept[n] = (traj, cap)
            elif cmd["op"] == "report":
                peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
                store.set(f"{KEY}report/{rank}", json.dumps({"peak": peak, "forbidden": harness.forbidden_modules()}))
            elif cmd["op"] == "send":
                for s in cmd["steps"]:
                    torch.save(_outputs(*kept[s], "cpu"), Path(outdir) / f"rank{rank}-step{s}.pt")
                store.set(f"{KEY}sent/{rank}", "1")
            elif cmd["op"] == "stop":
                break
            n += 1
    finally:
        me.uninstall()
        dist.destroy_process_group()


class Driver:
    def __init__(self, config: dict, traffic, seed: int, device, cell: dict):
        self.config, self.traffic, self.seed, self.device, self.cell = config, traffic, seed, torch.device(device), cell
        self.pairs = int(config["pairs_per_step"])
        self.ranks = int(config["ranks"])
        self.procs: list = []
        self.me = None
        self.store = None
        self._stopping = False
        self._tmp = None
        self._commands = 0
        self._steps = 0
        self._drop: set = set()
        self._sampled: list = []

    # -- the workers ---------------------------------------------------------

    def _start(self, address: str) -> None:
        self._tmp = tempfile.mkdtemp(prefix="a3d-sharded-")
        ctx = multiprocessing.get_context("spawn")
        for r in range(1, self.ranks):
            p = ctx.Process(target=_worker, name=f"rank {r}", daemon=True,
                            args=(r, address, self.config, self.traffic.name, self.seed, self.device.type,
                                  torch.get_num_threads(), self._tmp))
            p.start()
            self.procs.append(p)
        threading.Thread(target=self._watch, args=(list(self.procs),), daemon=True).start()

    def _watch(self, procs: list) -> None:
        """End the run at once when a worker exits before it is told to stop."""
        while procs:
            ready = wait_for([p.sentinel for p in procs])
            for p in [p for p in procs if p.sentinel in ready]:
                procs.remove(p)
                p.join()
                if not self._stopping:
                    print(f"sharded: {p.name} exited with code {p.exitcode} before it was told to stop; "
                          "ending the run", file=sys.stderr, flush=True)
                    self._kill()
                    os._exit(1)

    def _kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(10)

    def _command(self, **cmd) -> int:
        n, self._commands = self._commands, self._commands + 1
        self.store.set(f"{KEY}cmd/{n}", json.dumps(cmd))
        return n

    def _replies(self, kind: str) -> list:
        keys = [f"{KEY}{kind}/{r}" for r in range(1, self.ranks)]
        self.store.wait(keys, _timeout())
        return [json.loads(self.store.get(k)) for k in keys]

    def _stop(self, wait_s: float) -> None:
        """Tell the workers to stop, leave the process group as they leave it,
        join them (killing any still there after ``wait_s``), put the
        program's functions back and remove the outputs' directory."""
        self._stopping = True
        if self.store is not None:
            try:
                self._command(op="stop")
            except RuntimeError as exc:  # the store went with a failed group
                print(f"sharded: could not send stop: {exc}", file=sys.stderr)
                wait_s = 0.0
        if dist.is_initialized():
            dist.destroy_process_group()
        deadline = time.monotonic() + wait_s
        for p in self.procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        self._kill()
        self.store = None
        if self.me is not None:
            self.me.uninstall()
        if self._tmp is not None:
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._tmp = None

    # -- the harness's interface ---------------------------------------------

    def setup(self) -> None:
        t0 = time.perf_counter()
        address = f"127.0.0.1:{_free_port()}"
        self._start(address)
        self.me = _Rank(self.config, self.traffic, self.seed, 0, self.device)
        t1 = time.perf_counter()
        self.me.join(address)
        self.store = dist.distributed_c10d._get_default_store()
        t2 = time.perf_counter()
        for _ in self.me.pool:  # each window once: every shape and depth bucket the run meets
            self._step(False, None)
        sync(self.device)
        self.setup_note = (f"{self.ranks} ranks; rank 0's fixtures and pool {t1 - t0:.2f} s, the group joined "
                           f"{t2 - t1:.2f} s later, warm-up {time.perf_counter() - t2:.2f} s")

    def _step(self, keep: bool, tracer) -> dict:
        win = self._steps % len(self.me.pool)
        self._steps += 1
        timer = _MarkingTimer(tracer) if tracer is not None else None
        if tracer is not None:
            tracer.mark("upload")
        n = self._command(op="step", win=win, keep=keep, drop=sorted(self._drop))
        self._drop = set()
        traj, cap = self.me.step(win, keep, timer)
        if tracer is not None:
            tracer.mark("readback")
        host = _poses(traj).cpu().numpy()
        return {"step": n, "frames": self.me.pool[win]["frames"], "traj": host, "capture": cap, "out": traj}

    def window(self, seconds: float, tracer, reservoir) -> dict:
        """Steps until the first one that ends past ``seconds``."""
        from align3d_torch.parallel import collectives as col

        t_start = time.perf_counter()
        t_end, steps, counts = t_start, 0, {}
        while True:
            if tracer is not None:
                tracer.maybe_begin(t_end - t_start, seconds)
                if tracer.active and "start" not in counts:
                    counts["start"] = (col.COLLECTIVES, getattr(col, "BYTES", None))
            if t_end - t_start >= seconds and (tracer is None or tracer.done):
                break
            keep = reservoir.offer()
            sampled = {item["step"] for item in reservoir.items}
            out = self._step(keep, tracer)
            t_end = time.perf_counter()
            steps += 1
            if tracer is not None:
                tracer.unit_done()
                if tracer.done and "end" not in counts:
                    counts["end"] = (col.COLLECTIVES, getattr(col, "BYTES", None))
            if keep:
                reservoir.put(out)
                self._drop |= sampled - {item["step"] for item in reservoir.items}
        self._command(op="report")
        reports = self._replies("report")
        forbidden = sorted({m for rep in reports for m in rep["forbidden"]})
        if forbidden:
            raise RuntimeError(f"a worker loaded {forbidden}")
        frames = steps * self.pairs
        peaks = [torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0]
        peaks += [rep["peak"] for rep in reports]
        self.note = (f"steps {steps} of {self.pairs} pairs on {self.ranks} ranks in {t_end - t_start:.3f} s; "
                     f"peak memory by rank {peaks} B")
        if "end" in counts:
            (c0, b0), (c1, b1) = counts["start"], counts["end"]
            moved = "not counted" if b0 is None else b1 - b0  # a program without collectives.BYTES
            self.note += f"; rank 0 in the profiled slice: collectives {c1 - c0}, bytes {moved}"
        return {"attempted": frames, "window_s": t_end - t_start, "units": steps,
                "metrics": {"batch_ms_per_frame": (t_end - t_start) * 1e3 / frames}}

    def slice_work(self, steps: int) -> float:
        """The least time of rank 0's aligns in ``steps`` steps (its device
        is the one profiled)."""
        h, w = self.config["image"]["height"], self.config["image"]["width"]
        shapes = [(h >> k, w >> k) for k in range(self.config["pyramid_levels"])]
        if any(level["engine"] == "xla" for level in self.config["levels"]):
            raise RuntimeError("the exact engine's work needs the slice's valid pixels")
        nbytes, flops = roofline.align_work(self.config["levels"], shapes, self.me.block - 1, [0] * len(shapes))
        return steps * roofline.least_seconds(nbytes, flops)

    def program_outputs(self, items: list) -> list[dict]:
        """Each sampled step's outputs of every rank, stitched in rank order
        (rank r > 0 starts with its halo frame): F + (R - 1) (F + 1) frames
        and the step's pairs."""
        self._command(op="send", steps=[item["step"] for item in items])
        self._replies("sent")
        out = []
        for item in items:
            parts = [_outputs(item["out"], item["capture"], self.device)]
            for r in range(1, self.ranks):
                path = Path(self._tmp) / f"rank{r}-step{item['step']}.pt"
                part = torch.load(path, weights_only=True)
                path.unlink()
                parts.append({"traj": part["traj"], "depth": part["depth"].to(self.device),
                              "pyramid": [{k: lv[k].to(self.device) for k in LEVEL_KEYS} for lv in part["pyramid"]],
                              "rel": tuple(x.to(self.device) for x in part["rel"])})
            host = item["traj"]
            out.append({"frames": item["frames"], **_stitch(parts), "traj": (host[..., :3], host[..., 3]),
                        "rank_trajs": [p["traj"].cpu().numpy() for p in parts[1:]]})
            self._sampled.append(item["frames"])
        return out

    def release(self) -> list:
        """Stop the workers; then the port's unsharded ``odometry_step`` of
        each sampled step's frames on rank 0's device (its trajectories, for
        :meth:`chain_gap`)."""
        from align3d_torch.parallel.batch import odometry_step

        self._stop(BOUND_S)
        self.me.pool = None
        unsharded = []
        for frames in self._sampled:
            fx = self.me.fixtures
            colors = np.stack([fx[f].colors[i] for f, i in frames])
            depths = np.stack([fx[f].depths[i] for f, i in frames])
            scales = [fx[f].depth_scale for f, _ in frames]
            scale = scales[0] if len(set(scales)) == 1 else np.asarray(scales, np.float32)
            traj = odometry_step(self.me.camera, scale, colors, depths, self.me.params, self.config["pyramid_levels"],
                                 self.me.filter, device=self.device)
            unsharded.append(_poses(traj).cpu().numpy())
        return unsharded

    def close(self) -> None:
        """Stop the workers and leave the group, also after a run that raised
        (the workers may then wait in a collective: a few seconds, then killed)."""
        if not self._stopping:
            self._stop(5.0)

    def chain_gap(self, chain: list, outputs: list, prec) -> float:
        """Each sampled step's trajectory against its own relative poses (the
        scan); infinite where a rank's trajectory or the unsharded step's is
        not bitwise rank 0's."""
        gap = 0.0
        for item, unsharded in zip(outputs, chain, strict=True):
            rel = tuple(x.cpu().numpy() for x in item["rel"])
            traj = item["traj"]
            mine = np.concatenate([traj[0], traj[1][..., None]], axis=-1)
            for r, other in enumerate(item["rank_trajs"], 1):
                if not np.array_equal(other, mine):
                    print(f"sharded: rank {r}'s trajectory is not rank 0's (max |diff| "
                          f"{np.abs(other - mine).max()})", file=sys.stderr)
                    gap = math.inf
            if not np.array_equal(unsharded, mine):
                print(f"sharded: rank 0's trajectory is not the unsharded step's (max |diff| "
                      f"{np.abs(unsharded - mine).max()})", file=sys.stderr)
                gap = math.inf
            if prec.lowp:
                rnd = lambda x: torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()  # noqa: E731
                rel, traj = tuple(rnd(x) for x in rel), tuple(rnd(x) for x in traj)
            gap = max(gap, check.scan_gap(rel, traj))
        return gap

    def reference(self, frames: list, prec) -> dict:
        """The reference of a step laid out as the ranks computed it: rank r's
        block with its halo frame in front (r > 0), a block at a time."""
        f = self.me.block
        parts = [pipeline.outputs(self.config, self.me.fixtures, frames[max(r * f - 1, 0):(r + 1) * f], prec,
                                  self.device) for r in range(self.ranks)]
        return _stitch(parts)
