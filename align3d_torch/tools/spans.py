"""The program's spans on the card: what recording costs, and where the
device's idle time falls among them.

    python -m align3d_torch.tools.spans

Needs a CUDA device (and ``nvcc`` for the kernel library) and fails
without one. In one process, on the in-repo sample1 fixtures at 640x480
(``tools/series.py::real_frames``): a live tracker (``RangeImageBuilder``
with the bilateral filter, ``MultiscaleAlign`` on ``MsIcpParams.default()``,
the pose read to the host each frame) and the 64-pair ``odometry_step`` on
``MsIcpParams.default_tpu("pallas_v4")`` with the filter. Prints JSON
lines:

* ``phase``: tracker frames in alternating blocks of three kinds, recording
  off, recording on (:func:`align3d_torch.utils.profiling.recording`), and
  off with a synchronise after the build and after the align (as the
  benchmark's harness ends its spans): ms a frame of each, and, from the
  recorded blocks, the mean ``gn.iter`` length and the mean of each span a
  frame. Three phases: before any profiler has run, after a CUDA-only
  ``torch.profiler`` (the benchmark's traced slice) over 4 frames and 2
  steps, and after the :func:`~align3d_torch.utils.profiling.trace` below;
* ``idle``: the device's idle time over the CUDA-only profile and over the
  trace, each gap named by the innermost program span open when it ends
  (a name with children stands for its self time), by the root span
  (``build`` and ``icp.align``: the tracker's frames; ``batch.step``);
* ``launches``: of the trace's K1 (``icp_step_kernel``) and K8
  (``icp_banded_kernel``) launches, how many the runtime's launch call of
  lies inside a ``gn.step`` span, against the ``gn.step`` spans and the
  port's launch counters (K1's, K8's and K11's, one a ``gn.iter``; K12's
  and K13's, the pyramid's, one a level of each build).

``--ranks N`` (N cards) runs instead the frame-sharded step on N processes,
one a card, as a multi-card deployment does: each hands its own 64-frame
block of a walk over sample1 (u8 colour, u16 depth host arrays) to
``multihost.host_local_batch`` and calls ``odometry_step(mesh=)``. It prints
one ``sharded`` line: rank 0's spans (``batch.step``, ``batch.upload``,
``dist.halo``, ``dist.gather`` and those below) in ms a step, recorded, and
the device's idle split by them over one step under a CUDA-only profile,
with the collectives and bytes rank 0 put through (``collectives.py``).
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import datetime
import json
import os
import statistics
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from align3d_torch import MultiscaleAlign, RangeImageBuilder
from align3d_torch.icp.params import MsIcpParams
from align3d_torch.image import RgbdFrame, RgbdImage
from align3d_torch.ops import icp_fused, icp_pallas_v4
from align3d_torch.ops import pyramid as pyramid_ops
from align3d_torch.ops.bilateral import BilateralFilter
from align3d_torch.optim import gauss_newton
from align3d_torch.parallel.batch import odometry_step
from align3d_torch.tools import series
from align3d_torch.utils import profiling

KERNELS = ("icp_step_kernel", "icp_banded_kernel")
BLOCK, STEP_BLOCK, ROUNDS, PROFILED_FRAMES, PROFILED_STEPS = 5, 2, 8, 4, 2
#: Frames a card holds in ``--ranks`` (64 pairs, the one-card step's).
RANK_FRAMES = 64
#: Seconds a collective, the group's start or the ranks' run may take in ``--ranks``.
RANKS_TIMEOUT_S = 600
DEVICE = "cuda"
#: The benchmark's traced slice records CUDA activity only.
SLICE_ACTIVITIES = [torch.profiler.ProfilerActivity.CUDA]


def innermost_segments(spans: list, keep) -> list[tuple[int, int, int]]:
    """(start ns, end ns, index of the innermost open span, -1 for none)
    pieces covering the time of the closed spans whose index ``keep``
    takes, in order. Spans nest (one thread)."""
    picked = [i for i, s in enumerate(spans) if s.end is not None and keep(i)]
    events = sorted([(spans[i].start, 1, i) for i in picked] + [(spans[i].end, 0, i) for i in picked])
    stack, segments, last = [], [], None
    for t, opens, i in events:
        if last is not None and t > last:
            segments.append((last, t, stack[-1] if stack else -1))
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
        last = t
    return segments


def idle_by_span(intervals: list[tuple[float, float]], spans: list, roots: tuple[str, ...]) -> dict:
    """Over the time of the spans under a root named in ``roots`` (from the
    first one's start to the last one's end): the union of the device's
    (start ns, end ns) intervals (busy) and its gaps, each named by the
    innermost such span open when it ends ("none" between them)."""
    segments = innermost_segments(spans, lambda i: spans[spans[i].root].name in roots)
    if not segments:
        return {}
    starts = [seg[0] for seg in segments]
    lo, hi = segments[0][0], segments[-1][1]
    idle: dict = defaultdict(float)
    busy, last_end = 0.0, lo
    for start, end in sorted(intervals):
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        if start > last_end:
            k = bisect.bisect_right(starts, start) - 1
            index = segments[k][2] if start < segments[k][1] else -1
            idle[spans[index].name if index >= 0 else "none"] += (start - last_end) / 1e9
        if start >= last_end:
            busy += (end - start) / 1e9
            last_end = end
        elif end > last_end:
            busy += (end - last_end) / 1e9
            last_end = end
    return {"busy_s": busy, "window_s": (hi - lo) / 1e9,
            "idle_s": dict(sorted(idle.items(), key=lambda kv: -kv[1]))}


PARTS = {"tracker": ("build", "icp.align"), "batch": ("batch.step",)}


class Tracker:
    """The live tracker over the series' frames, one at a time."""

    def __init__(self, s: series.Series, device):
        self.series, self.device = s, device
        self.builder = RangeImageBuilder(bilateral_filter=BilateralFilter(), pyramid_levels=3)
        self.params = MsIcpParams.default()
        self.i = 0
        self.prev = self.builder.build(self._frame(), device)

    def _frame(self) -> RgbdFrame:
        s, i = self.series, self.i % len(self.series)
        self.i += 1
        return RgbdFrame(s.camera, RgbdImage(s.colors[i], s.depths[i], float(s.depth_scales[i])))

    def frame(self, synced: bool = False) -> None:
        pyramid = self.builder.build(self._frame(), self.device)
        if synced:
            torch.cuda.synchronize()
        rel = MultiscaleAlign(self.params, self.prev).align(pyramid)
        if synced:
            torch.cuda.synchronize()
        rel.rotation.cpu()
        self.prev = pyramid


def batch_step(s: series.Series, device) -> None:
    traj = odometry_step(s.camera, s.depth_scales, s.colors, s.depths, MsIcpParams.default_tpu("pallas_v4"), 3,
                         BilateralFilter(), device)
    traj.camera_to_world.rotation.cpu()


def span_means(spans: list, units: int) -> dict:
    """ms a unit in each span name, over ``units`` frames or steps."""
    out = defaultdict(float)
    for sp in spans:
        out[sp.name] += (sp.end - sp.start) / 1e6 / units
    return dict(sorted(out.items()))


def phase(name: str, tracker: Tracker, s: series.Series, device) -> dict:
    """Blocks of tracker frames off / on / synced and of batch steps off /
    on, the order turning each round."""
    out = {"phase": name}
    units = {"tracker": (lambda synced: tracker.frame(synced), BLOCK, ["off", "on", "synced"]),
             "batch": (lambda synced: batch_step(s, device), STEP_BLOCK, ["off", "on"])}
    for part, (unit, block, kinds) in units.items():
        ms, spans, iters = defaultdict(list), [], []
        for r in range(ROUNDS):
            for kind in kinds[r % len(kinds):] + kinds[:r % len(kinds)]:
                profiling.clear()
                t0 = time.perf_counter()
                with profiling.recording() if kind == "on" else contextlib.nullcontext():
                    for _ in range(block):
                        unit(kind == "synced")
                ms[kind].append((time.perf_counter() - t0) * 1e3 / block)
                if kind == "on":
                    spans += profiling.spans()
        iters = [(sp.end - sp.start) / 1e3 for sp in spans if sp.name == "gn.iter"]
        out[part] = {"ms_per_unit": dict(ms), "median_ms_per_unit": {k: statistics.median(v) for k, v in ms.items()},
                     "gn_iter_us": {"mean": statistics.fmean(iters), "median": statistics.median(iters)},
                     "span_ms_per_unit": span_means(spans, block * ROUNDS)}
    profiling.clear()
    return out


def span_cost(n: int = 100_000) -> dict:
    """ns of one ``begin``/``end`` pair and of one ``with span()``, off and on."""
    out = {}
    for kind in ("off", "on"):
        with profiling.recording() if kind == "on" else contextlib.nullcontext():
            profiling.clear()
            t0 = time.perf_counter_ns()
            for _ in range(n):
                profiling.end(profiling.begin("x"))
            t1 = time.perf_counter_ns()
            profiling.clear()
            for _ in range(n):
                with profiling.span("x"):
                    pass
            t2 = time.perf_counter_ns()
            profiling.clear()
        out[kind] = {"begin_end_ns": (t1 - t0) / n, "with_span_ns": (t2 - t1) / n}
    return out


def profiled_units(tracker: Tracker, s: series.Series, device) -> list:
    """PROFILED_FRAMES tracker frames, then PROFILED_STEPS batch steps;
    returns the spans recorded (none where no profiler runs)."""
    profiling.clear()
    for _ in range(PROFILED_FRAMES):
        tracker.frame()
    torch.cuda.synchronize()
    for _ in range(PROFILED_STEPS):
        batch_step(s, device)
    torch.cuda.synchronize()
    return list(profiling.spans())


def chrome_device(events: list, base: int) -> tuple[list, dict]:
    """The trace's device intervals (ns) and its kernels by correlation id."""
    intervals, kernels = [], {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            start = base + e["ts"] * 1e3
            intervals.append((start, start + e["dur"] * 1e3))
            if e.get("cat") == "kernel":
                kernels[e.get("args", {}).get("correlation")] = e["name"]
    return intervals, kernels


def launches_in_steps(events: list, base: int, kernels: dict, spans: list) -> dict:
    """Each K1/K8 kernel's runtime launch call, found by correlation id,
    and whether it lies inside a ``gn.step`` span."""
    steps = sorted((s.start, s.end) for s in spans if s.name == "gn.step")
    step_starts = [a for a, _ in steps]
    found = {k: {"kernels": 0, "launch_calls": 0, "inside_gn_step": 0} for k in KERNELS}
    for name in kernels.values():
        for k in KERNELS:
            if k in name:
                found[k]["kernels"] += 1
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        name = kernels.get(e.get("args", {}).get("correlation"))
        key = next((k for k in KERNELS if name and k in name), None)
        if key is None:
            continue
        found[key]["launch_calls"] += 1
        start, end = base + e["ts"] * 1e3, base + (e["ts"] + e["dur"]) * 1e3
        j = bisect.bisect_right(step_starts, start) - 1
        found[key]["inside_gn_step"] += j >= 0 and end <= steps[j][1]
    found["gn_step_spans"] = len(steps)
    return found


def sharded_rank(rank: int, ranks: int, address: str, out: str) -> None:
    """One rank of ``--ranks``: warm up, ROUNDS steps recording spans, one
    step under a CUDA-only profiler; rank 0 writes what it saw to ``out``."""
    import torch.distributed as dist

    from align3d_torch.parallel import collectives as col
    from align3d_torch.parallel import multihost

    device = torch.device(DEVICE, rank)
    torch.cuda.set_device(device)
    from align3d_torch import _kernels

    _kernels.lib()
    multihost.initialize(address, ranks, rank, local_device_ids=[rank],
                         timeout=datetime.timedelta(seconds=RANKS_TIMEOUT_S))
    try:
        mesh = multihost.global_mesh()
        s = series.real_frames(61)  # sample1 forward and back: a walk of period 60, every pair adjacent
        walk = np.arange(RANK_FRAMES * ranks) % 60
        mine = walk[rank * RANK_FRAMES:(rank + 1) * RANK_FRAMES]
        params, filt = MsIcpParams.default_tpu("pallas_v4"), BilateralFilter()

        def step() -> None:
            colors = multihost.host_local_batch(mesh, s.colors[mine])
            depths = multihost.host_local_batch(mesh, s.depths[mine])
            traj = odometry_step(s.camera, s.depth_scales[walk], colors, depths, params, 3, filt, mesh=mesh)
            traj.camera_to_world.rotation.cpu()

        for _ in range(2):
            step()
        profiling.clear()
        with profiling.recording():
            for _ in range(ROUNDS):
                step()
        means = span_means(profiling.spans(), ROUNDS)
        profiling.clear()
        counts0 = (col.COLLECTIVES, col.BYTES)
        with torch.profiler.profile(activities=SLICE_ACTIVITIES) as prof:
            step()
            torch.cuda.synchronize()
        spans = list(profiling.spans())
        start_ns = prof.profiler.kineto_results.trace_start_ns()
        intervals = [(start_ns + e.time_range.start * 1e3, start_ns + e.time_range.end * 1e3)
                     for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if rank == 0:
            line = {"sharded": {"ranks": ranks, "frames_per_rank": RANK_FRAMES, "span_ms_per_step": means,
                                "idle": idle_by_span(intervals, spans, ("batch.step",)),
                                "collectives_per_step": col.COLLECTIVES - counts0[0],
                                "bytes_per_step": col.BYTES - counts0[1]}}
            with open(out, "w") as f:
                json.dump(line, f)
    finally:
        dist.destroy_process_group()


def sharded(ranks: int) -> dict:
    """``--ranks``: the ranks in new processes, one card each; rank 0's line."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{sock.getsockname()[1]}"
    with tempfile.TemporaryDirectory(prefix="spans_ranks_") as tmp:
        out = os.path.join(tmp, "rank0.json")
        ctx = mp.start_processes(sharded_rank, args=(ranks, address, out), nprocs=ranks, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{ranks} ranks still running after {RANKS_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        with open(out) as f:
            return json.load(f)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--control", action="store_true",
                        help="run the profiled units with no profiler (is a later phase slower without one?)")
    parser.add_argument("--ranks", type=int, default=1,
                        help="the frame-sharded step on this many cards, one process each, instead")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("the spans tool needs a CUDA device", file=sys.stderr)
        return 2
    if args.ranks > 1:
        if torch.cuda.device_count() < args.ranks:
            print(f"--ranks {args.ranks} needs as many CUDA devices; there are {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        print(json.dumps({"card": torch.cuda.get_device_name(0), "torch": torch.__version__}), flush=True)
        print(json.dumps(sharded(args.ranks)), flush=True)
        return 0
    device = torch.device(DEVICE)
    from align3d_torch import _kernels

    _kernels.lib()
    print(json.dumps({"card": torch.cuda.get_device_name(0), "torch": torch.__version__, "control": args.control,
                      "profiler_flag": hasattr(torch.autograd.profiler, "_is_profiler_enabled")}), flush=True)
    s = series.real_frames()
    tracker = Tracker(s, device)
    for _ in range(3):
        tracker.frame()
    batch_step(s, device)
    torch.cuda.synchronize()
    print(json.dumps({"span_cost": span_cost()}), flush=True)
    print(json.dumps(phase("fresh", tracker, s, device)), flush=True)

    # The benchmark's traced slice: a CUDA-only profiler (spans recorded while it runs).
    with contextlib.nullcontext() if args.control else torch.profiler.profile(activities=SLICE_ACTIVITIES) as prof:
        spans = profiled_units(tracker, s, device)
    if not args.control:
        start_ns = prof.profiler.kineto_results.trace_start_ns()
        intervals = [(start_ns + e.time_range.start * 1e3, start_ns + e.time_range.end * 1e3)
                     for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        for part, roots in PARTS.items():
            print(json.dumps({"idle": "cuda-only profile", "part": part, **idle_by_span(intervals, spans, roots),
                              "span_ms": span_means([x for x in spans if spans[x.root].name in roots], 1)}),
                  flush=True)
        del prof, intervals
    print(json.dumps(phase("after a CUDA-only profile", tracker, s, device)), flush=True)

    if not args.control:
        counts0 = (icp_fused.LAUNCHES, icp_pallas_v4.LAUNCHES, gauss_newton.LAUNCHES, pyramid_ops.BASE_LAUNCHES,
                   pyramid_ops.DOWN_LAUNCHES)
        with tempfile.TemporaryDirectory(prefix="spans_trace_") as log_dir:
            with profiling.trace(log_dir):
                spans = profiled_units(tracker, s, device)
            with open(os.path.join(log_dir, "trace.json")) as f:
                data = json.load(f)
        counts = {"K1": icp_fused.LAUNCHES - counts0[0], "K8": icp_pallas_v4.LAUNCHES - counts0[1],
                  "K11": gauss_newton.LAUNCHES - counts0[2], "K12": pyramid_ops.BASE_LAUNCHES - counts0[3],
                  "K13": pyramid_ops.DOWN_LAUNCHES - counts0[4]}
        base, events = int(data.get("baseTimeNanoseconds", 0)), data["traceEvents"]
        intervals, kernels = chrome_device(events, base)
        for part, roots in PARTS.items():
            print(json.dumps({"idle": "trace (CPU + CUDA)", "part": part, **idle_by_span(intervals, spans, roots)}),
                  flush=True)
        print(json.dumps({"launches": launches_in_steps(events, base, kernels, spans),
                          "counters": counts, "trace_events": len(events),
                          "span_events": sum(1 for e in events if e.get("tid") == profiling.TRACK)}), flush=True)
        del data, events
    else:
        profiled_units(tracker, s, device)
    print(json.dumps({"span_cost": span_cost()}), flush=True)
    print(json.dumps(phase("after a CPU + CUDA trace", tracker, s, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
