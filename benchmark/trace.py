"""The traced run's reading of the device: one ``torch.profiler`` slice of
whole frames or steps from the middle of the window, CUDA activity only
(recording host ops costs seconds a call on these paths).

Spans are told apart by time. The harness notes the host's clock
(``time.time_ns``, the clock the profiler's trace is kept in) at the start
of each span, and every span ends with a synchronise, so each device
activity ran inside the span that issued it: an activity belongs to the
last span that started before it did, whichever kernels a later version of
the program runs. The profiler now and then drops an activity (on an H100
with torch 2.11, one in some ten thousand, in fresh processes too): the
reading then loses that activity's time and nothing else, and the launches
the port's counters issued are printed beside those the profiler saw.

From the slice: the union of the activities' intervals (busy time), busy
time by span, the idle gaps between activities named by the span whose
activity ends them, device time by operation name.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

#: Substrings of the port's kernels' names, by the launch counter that counts them.
KERNELS = {"K1": "icp_step_kernel", "K8": "icp_banded_kernel", "K9": "source_centroids_kernel",
           "K10": "predict_bases_kernel", "K2": "bilateral_splat", "K3": "bilateral_slice"}


def launch_counts() -> dict[str, int]:
    """The port's own launch counters (module globals, read, never reset)."""
    from align3d_torch.ops import bilateral, icp_fused, icp_pallas_v3, icp_pallas_v4

    return {"K1": icp_fused.LAUNCHES, "K8": icp_pallas_v4.LAUNCHES, "K9": icp_pallas_v3.CENTROIDS_LAUNCHES,
            "K10": icp_pallas_v3.PREDICT_LAUNCHES, "K2": bilateral.SPLAT_LAUNCHES,
            "K3": bilateral.SLICE_LAUNCHES + bilateral.NORMALIZE_SLICE_LAUNCHES}


def _profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])


class Tracer:
    """Spans timed on the host (each ended by a synchronise) all through the
    window, and one profiled slice of ``slice_units`` frames or steps."""

    def __init__(self, slice_units: int):
        self.slice_units = slice_units
        self.spans: dict[str, list[float]] = defaultdict(list)  # outside the slice
        self.bounds: list[tuple[int, str]] = []  # (host ns, label) of each span's start in the slice
        self.active = False
        self.done = False
        self.units_in_slice = 0
        self.prof = None
        self.window_s = 0.0
        self.launches_issued: dict[str, int] = {}

    def warm(self) -> None:
        """Start and stop the profiler once in set-up, so that its own
        initialisation stays out of the window."""
        with _profiler():
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def mark(self, label: str) -> None:
        """A span starts (the device has finished the one before)."""
        if self.active:
            self.bounds.append((time.time_ns(), label))

    @contextlib.contextmanager
    def span(self, label: str):
        """A harness span: its start noted in the slice, host-timed to a
        synchronise outside it."""
        self.mark(label)
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        if not self.active:
            self.spans[label].append(time.perf_counter() - t0)

    def maybe_begin(self, elapsed: float, seconds: float) -> None:
        """Open the slice at the first unit that starts past half the window."""
        if not self.done and not self.active and elapsed >= seconds / 2:
            torch.cuda.synchronize()
            self._counts0 = launch_counts()
            self.prof = _profiler()
            self.prof.start()
            self.active = True
            self._t0 = time.perf_counter()

    def unit_done(self) -> None:
        """One frame or step ended (its result on the host)."""
        if not self.active:
            return
        self.units_in_slice += 1
        if self.units_in_slice >= self.slice_units:
            torch.cuda.synchronize()
            self.bounds.append((time.time_ns(), "end"))
            self.window_s = time.perf_counter() - self._t0
            self.prof.stop()
            counts = launch_counts()
            self.launches_issued = {k: counts[k] - self._counts0[k] for k in counts}
            self.active = False
            self.done = True

    def read(self) -> dict | None:
        """The slice's device reading, or None when no slice was taken."""
        if not self.done:
            return None
        start_ns = self.prof.profiler.kineto_results.trace_start_ns()
        acts = sorted((start_ns + e.time_range.start * 1e3, start_ns + e.time_range.end * 1e3, e.name)
                      for e in self.prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        return read_activities(acts, self.bounds, self.window_s, self.launches_issued)


def read_activities(acts: list, bounds: list, window_s: float, launches_issued: dict) -> dict:
    """The reading of (start ns, end ns, name) device activities, sorted,
    against the (host ns, label) span starts; ``bounds[-1]`` is the slice's end."""
    busy_by, gaps_by, ops, seen = defaultdict(float), defaultdict(float), defaultdict(float), defaultdict(int)
    busy, last_end, k, outside = 0.0, None, -1, 0
    for start, end, name in acts:
        while k + 1 < len(bounds) and bounds[k + 1][0] <= start:
            k += 1
        inside = 0 <= k < len(bounds) - 1
        outside += not inside  # before the first span or after the slice's end: no span issued it
        label = bounds[k][1] if inside else "outside"
        ops[name] += (end - start) / 1e9
        for key, sub in KERNELS.items():
            if sub in name:
                seen[key] += 1
        # The union of the intervals, in start order.
        if last_end is None or start >= last_end:
            if last_end is not None:
                gaps_by[label] += (start - last_end) / 1e9
            piece, last_end = (end - start) / 1e9, end
        else:
            piece, last_end = max(0.0, (end - last_end) / 1e9), max(last_end, end)
        busy += piece
        busy_by[label] += piece
    return {
        "busy_s": busy,
        "window_s": window_s,
        "busy_by_label": dict(busy_by),
        "idle_by_label": dict(gaps_by),
        "device_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": [[f"host in {lab}", s] for lab, s in sorted(gaps_by.items(), key=lambda kv: -kv[1])[:10]],
        "launches_seen": {key: seen.get(key, 0) for key in KERNELS},
        "launches_issued": launches_issued,
        "activities": len(acts),
        "outside": outside,
    }
