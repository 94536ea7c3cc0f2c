"""Live tracking on sensor clocks: ``align3d_torch.LiveOdometry`` serving S
RGB-D streams at the traffic's rate, open loop, latest frame wins.

One thread plays the sensors' clock: with T = 1 / ``rate_hz``, stream k's
window frame n arrives at t0 + k T / S + n T (the phases spread evenly over
the period). Before each step the driver pushes every frame that has
arrived (a stream's frame still waiting when its next one arrives is
dropped by the server); when nothing is pending it sleeps until the next
arrival, spinning for the last millisecond. Each stream's frames follow
their own seeded walk over the traffic's sequence (a seed a stream, drawn
from ``traffic.rng``). Set-up warms every bucket (``LiveOdometry.warm``),
starts every stream with its first frame and tracks a few more.

A frame's latency runs from its scheduled arrival until a pose of its
stream stamped at or after its own timestamp is on the host: for a dropped
frame, the next tracked frame's. The window holds the frames that arrive
in ``--seconds`` of sensor time and ends when each of them is covered.

``LiveOdometry.step`` returns only the poses. To hold its stages to the
reference, the driver wraps two functions of ``align3d_torch.live`` that a
step calls, ``filter_buckets`` (its filtered depths) and
``multiscale_align_batched`` (the target and source pyramids it aligns);
the wrappers only hold references. The seeded sample is of tracked pairs,
each compared as the tracker cell's frames are; each stream's chain of
poses goes through ``check.chain_gap``, the worst stream counting.
"""

from __future__ import annotations

import collections
import gc
import time

import numpy as np
import torch

from benchmark import check, roofline, traffic as traffic_mod
from benchmark.drivers import Reservoir, icp_params, sync
from benchmark.reference import live as live_ref

UNIT = "step"
SPIN_S = 1e-3  # the last stretch before an arrival, spun rather than slept


def _levels(pyramid, row: int) -> list[dict]:
    return [{"points": lv.points[row], "mask": lv.mask[row], "normals": lv.normals[row],
             "intensity_map": lv.intensity_map[row]} for lv in pyramid]


class Driver:
    def __init__(self, config: dict, traffic, seed: int, device, cell: dict):
        self.config, self.traffic, self.seed, self.device, self.cell = config, traffic, seed, device, cell
        self.streams = int(traffic.spec["streams"])
        self.period = 1.0 / float(traffic.spec["rate_hz"])
        self.phases = [k * self.period / self.streams for k in range(self.streams)]

    def _install(self) -> None:
        from align3d_torch import live

        self._live = live
        self._orig = (live.filter_buckets, live.multiscale_align_batched)
        filt, align = self._orig
        self.capture = None
        self.last_depths = None

        def filter_buckets(*args, **kwargs):
            out = filt(*args, **kwargs)
            self.last_depths = out[0]
            return out

        def multiscale_align_batched(targets, sources, *args, **kwargs):
            if self.capture is not None:
                self.capture["targets"], self.capture["sources"] = targets, sources
            return align(targets, sources, *args, **kwargs)

        live.filter_buckets = filter_buckets
        live.multiscale_align_batched = multiscale_align_batched

    def setup(self, warm_units: int = 2) -> None:
        from align3d_torch import LiveOdometry
        from align3d_torch.camera import CameraIntrinsics
        from align3d_torch.image import RgbdImage
        from align3d_torch.ops.bilateral import BilateralFilter

        self._install()
        t0 = time.perf_counter()
        self.fixtures = self.traffic.load_fixtures(self.config.get("stride", 1))
        t1 = time.perf_counter()
        cams = {fx.camera for fx in self.fixtures.values()}
        scales = {fx.depth_scale for fx in self.fixtures.values()}
        if len(cams) != 1 or len(scales) != 1:
            raise RuntimeError("the streams must share one camera and one depth scale")
        lengths = {k: len(v) for k, v in self.fixtures.items()}
        gen = traffic_mod.rng(self.seed, 10)
        self.walks = [self.traffic.stream(int(gen.integers(2**62)), lengths) for _ in range(self.streams)]
        self.frames = {(name, i): RgbdImage(fx.colors[i], fx.depths[i], fx.depth_scale)
                       for name, fx in self.fixtures.items() for i in range(len(fx))}
        filt = self.config["bilateral_filter"]
        self.server = LiveOdometry(CameraIntrinsics(*cams.pop()), scales.pop(), self.streams, icp_params(self.config),
                                   BilateralFilter(filt["sigma_space"], filt["sigma_color"], filt["pad_depth_to"]),
                                   self.config["pyramid_levels"], self.config["blur_sigma"], self.device)
        t2 = time.perf_counter()
        captures = self._graph_captures()
        self.server.warm(self.frames[next(iter(self.frames))])
        self.warm_captures = self._graph_captures() - captures
        self.tracked_key: dict[int, tuple] = {}
        self.depth_of: dict[int, tuple] = {}  # stream -> (filtered depths of its last tracked frame's step, row)
        self.last_host = {}
        for n in range(warm_units + 1):  # each stream's first frame, then warm_units tracked ones
            keys = {k: next(self.walks[k]) for k in range(self.streams)}
            for k, key in keys.items():
                self.server.push(k, self.frames[key], n * self.period + self.phases[k])
            self._after(self.server.step(), keys, {})
        self.first_n = warm_units + 1
        sync(self.device)
        self.setup_note = (f"fixtures {t1 - t0:.2f} s, warm-up {time.perf_counter() - t2:.2f} s "
                           f"({self.warm_captures} level graphs captured)")

    @staticmethod
    def _graph_captures() -> int:
        from align3d_torch.icp import level_graph

        return level_graph.counts()["captures"]

    def _after(self, step, keys: dict, kept: dict) -> None:
        """Follow a step: each row's stream's last tracked frame, and the kept
        pairs' outputs."""
        for i, s in enumerate(step.streams):
            if i < step.pairs:
                self.last_host[s] = (step.poses[i, :, :3], step.poses[i, :, 3])
                if s in kept:
                    prev_depths, prev_row = self.depth_of[s]
                    cap = self.capture
                    kept[s].update(frames=[self.tracked_key[s], keys[s]],
                                   depths=(prev_depths[prev_row], self.last_depths[i]),
                                   pyramids=(_levels(cap["targets"], i), _levels(cap["sources"], i)),
                                   rel=(step.relative.rotation[i], step.relative.translation[i]))
            self.tracked_key[s] = keys[s]
            self.depth_of[s] = (self.last_depths, i)

    def window(self, seconds: float, tracer, reservoir: Reservoir) -> dict:
        """The frames that arrive in ``seconds`` of sensor time, each until
        its latency is known (the module docstring). Each frame is pushed
        with its scheduled arrival, from which the server counts its wait.
        Python's cycle collector runs as it would in a user's process (the
        note counts its runs in the window, which ``gc.callbacks`` reports);
        the window's own records go to arrays made before it starts, so the
        harness adds no objects for it to scan."""
        server, period, phases, nstreams = self.server, self.period, self.phases, self.streams
        counts = [max(0, int(np.ceil((seconds - p) / period))) for p in phases]
        sent = [0] * nstreams
        uncovered = [collections.deque() for _ in range(nstreams)]  # (timestamp, scheduled arrival)
        latencies, late, step_s, step_pairs, pairs_hist = [], [], [], [], collections.Counter()
        self.slice_steps = []
        arrived = int(sum(counts))  # at most this many pairs tracked in the window
        self.rel = (torch.empty((arrived, 3, 3), device=self.device), torch.empty((arrived, 3), device=self.device))
        self.abs = np.empty((arrived, 3, 4), np.float32)
        self.rows = np.empty(arrived, np.int64)  # the stream of each tracked pair, in order
        at = 0
        start_pose = dict(self.last_host)
        keys: dict[int, tuple] = {}
        captures = self._graph_captures()
        collected = {0: [0, 0.0], 1: [0, 0.0], 2: [0, 0.0]}  # the collector's runs in the window: count, seconds
        began = [0.0]

        def observe(phase, info):
            if phase == "start":
                began[0] = time.perf_counter()
            else:
                collected[info["generation"]][0] += 1
                collected[info["generation"]][1] += time.perf_counter() - began[0]

        gc.callbacks.append(observe)
        t0 = time.perf_counter() + 0.01
        while True:
            now = time.perf_counter()
            for k in range(nstreams):
                while sent[k] < counts[k] and t0 + phases[k] + sent[k] * period <= now:
                    due = t0 + phases[k] + sent[k] * period
                    stamp = (self.first_n + sent[k]) * period + phases[k]
                    keys[k] = next(self.walks[k])
                    server.push(k, self.frames[keys[k]], stamp, due)
                    late.append(time.perf_counter() - due)
                    uncovered[k].append((stamp, due))
                    sent[k] += 1
            if keys:
                if tracer is not None:
                    tracer.maybe_begin(now - t0, seconds)
                kept = {}
                for k in sorted(keys):
                    if reservoir.offer():
                        kept[k] = {}
                        reservoir.put(kept[k])
                active = tracer is not None and tracer.active
                self.capture = {} if kept or active else None
                if tracer is not None:
                    tracer.mark("step")
                step = server.step()
                done = time.perf_counter()
                if tracer is not None:
                    tracer.mark("wait")
                for i, s in enumerate(step.streams[:step.pairs]):
                    while uncovered[s] and uncovered[s][0][0] <= step.times[i]:
                        latencies.append(done - uncovered[s].popleft()[1])
                self._after(step, keys, kept)
                if active:
                    self.slice_steps.append((step.pairs, [lv.mask[:step.pairs] for lv in self.capture["sources"]]))
                if tracer is not None:
                    tracer.unit_done()
                self.capture = None
                b = step.pairs
                self.rel[0][at:at + b].copy_(step.relative.rotation)
                self.rel[1][at:at + b].copy_(step.relative.translation)
                self.abs[at:at + b] = step.poses
                self.rows[at:at + b] = step.streams[:b]
                at += b
                pairs_hist[b] += 1
                step_s.append(done - now)
                step_pairs.append(b)
                keys = {}
                continue
            if sent == counts and not any(uncovered):
                break
            nxt = min(t0 + phases[k] + sent[k] * period for k in range(nstreams) if sent[k] < counts[k])
            nap = nxt - time.perf_counter() - SPIN_S
            if nap > 0:
                time.sleep(nap)
            while time.perf_counter() < nxt:
                pass
        gc.callbacks.remove(observe)
        self.chain_start, self.tracked = start_pose, at
        lat = np.asarray(latencies) * 1e3
        step_ms = np.asarray(step_s) * 1e3
        slowest = sorted(range(len(step_s)), key=lambda i: -step_s[i])[:3]
        self.summary = {"streams": nstreams, "rate_hz": 1 / period, "arrived": arrived, "tracked": at,
                        "dropped": arrived - at, "p50_ms": float(np.percentile(lat, 50)),
                        "p90_ms": float(np.percentile(lat, 90)), "max_ms": float(lat.max()), "steps": len(step_s),
                        "step_p50_ms": float(np.percentile(step_ms, 50)),
                        "slowest_steps": [[i, step_pairs[i], round(float(step_ms[i]), 3)] for i in slowest],
                        "pairs_a_step": dict(sorted(pairs_hist.items())),
                        "late_p50_ms": float(np.percentile(late, 50)) * 1e3, "late_max_ms": max(late) * 1e3,
                        "captures": self._graph_captures() - captures,
                        "collections": {g: [n, round(t * 1e3, 3)] for g, (n, t) in collected.items()}}
        self.note = ("{streams} streams at {rate_hz:g} Hz: frames {arrived}, tracked {tracked}, dropped {dropped}; "
                     "latency ms p50 {p50_ms:.3f} p90 {p90_ms:.3f} max {max_ms:.3f}; steps {steps}, ms a step p50 "
                     "{step_p50_ms:.3f}, slowest [step, pairs, ms] {slowest_steps}; pairs a step {pairs_a_step}; "
                     "push late ms p50 {late_p50_ms:.3f} max {late_max_ms:.3f}; level graphs captured "
                     "{captures}; cycle collections by generation [count, ms] {collections}").format(**self.summary)
        return {"attempted": arrived, "window_s": time.perf_counter() - t0, "units": len(step_s),
                "metrics": {"track_p90_ms": float(np.percentile(lat, 90))}}

    def slice_work(self, units: int) -> float:
        """The least time of the profiled slice's aligns, at each step's real
        pairs and each level's valid source pixels."""
        h, w = self.config["image"]["height"], self.config["image"]["width"]
        shapes = [(h >> k, w >> k) for k in range(self.config["pyramid_levels"])]
        total = 0.0
        for pairs, masks in self.slice_steps:
            valid = [int(m.sum()) for m in masks]
            total += roofline.least_seconds(*roofline.align_work(self.config["levels"], shapes, pairs, valid))
        return total

    def program_outputs(self, items: list) -> list[dict]:
        """The sampled pairs' outputs as the checks read them."""
        out = []
        for item in items:
            if not item:  # offered before a step that then did not track its stream
                raise RuntimeError("a sampled pair was never tracked")
            levels = item["pyramids"]
            out.append({
                "frames": item["frames"],
                "depth": torch.stack(list(item["depths"])),
                "pyramid": [{k: torch.stack([lv[i][k] for lv in levels]) for k in levels[0][i]}
                            for i in range(len(levels[0]))],
                "rel": (item["rel"][0][None], item["rel"][1][None]),
            })
        return out

    def close(self) -> None:
        """Put the program's functions back (also after a run that raised)."""
        if getattr(self, "_orig", None) is not None:
            self._live.filter_buckets, self._live.multiscale_align_batched = self._orig
            self._orig = None

    def release(self) -> dict:
        """Drop the program's state; return each stream's chain of the window:
        (relative poses, camera-to-world poses, the pose before the window)."""
        self.close()
        chains = {}
        n = getattr(self, "tracked", 0)
        if n:
            rel_r, rel_t = (x[:n].cpu().numpy() for x in self.rel)
            poses, streams = self.abs[:n], self.rows[:n]
            for k in range(self.streams):
                rows = np.flatnonzero(streams == k)
                if len(rows):
                    chains[k] = ((rel_r[rows], rel_t[rows]), (poses[rows, :, :3], poses[rows, :, 3]),
                                 self.chain_start[k])
        for name in ("server", "rel", "abs", "rows", "depth_of", "capture", "last_depths", "slice_steps"):
            setattr(self, name, None)
        return chains

    def chain_gap(self, chain, outputs: list, prec) -> float:
        """Each stream's window poses against its relative poses and the pose
        before each; the worst stream."""
        gap = 0.0
        for rel, abs_, start in chain.values():
            if prec.lowp:  # the control: the accumulated poses kept in bf16
                rnd = lambda x: torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()  # noqa: E731
                rel, abs_, start = [tuple(rnd(x) for x in pair) for pair in (rel, abs_, start)]
            gap = max(gap, check.chain_gap(rel, abs_, start))
        return gap

    def reference(self, frames: list, prec) -> dict:
        return live_ref.pair_outputs(self.config, self.fixtures, frames, prec, self.device)
