"""Re-processing a recording: ``parallel/batch.py::odometry_step`` on steps
of N consecutive frames (N - 1 adjacent pairs), the frames handed over as
host numpy arrays (u8 colour, u16 depth) as a recording reader yields them,
so the upload is in the window, and each step's trajectory read back to the
host. Set-up draws a pool of windows of the traffic; the run cycles them.

``odometry_step`` returns only the trajectory. To hold its stages to the
reference, the driver wraps two functions of ``align3d_torch.parallel.batch``
that ``odometry_step`` calls, ``build_pyramids_batched`` (which receives
the filtered depths and returns the pyramids) and
``multiscale_align_batched`` (which returns the relative poses), and keeps
their outputs for the steps the seeded sample picks. The wrappers only hold
references; without them the run stops.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark import check, roofline
from benchmark.drivers import Reservoir, icp_params, sync
from benchmark.reference import pipeline

UNIT = "step"


class _MarkingTimer:
    """The program's ``StageTimer``, each stage's start marked on the device
    in the profiled slice, each stage's host time (ended by the StageTimer's
    synchronise) kept outside it."""

    def __init__(self, tracer):
        from align3d_torch.utils.profiling import StageTimer

        self.inner, self.tracer = StageTimer(), tracer

    @contextlib.contextmanager
    def stage(self, name: str, force=None):
        self.tracer.mark(name)
        t0 = time.perf_counter()
        with self.inner.stage(name, force):
            yield
        if not self.tracer.active:
            self.tracer.spans[name].append(time.perf_counter() - t0)


class Driver:
    def __init__(self, config: dict, traffic, seed: int, device, cell: dict):
        self.config, self.traffic, self.seed, self.device, self.cell = config, traffic, seed, device, cell
        self.pairs = int(config["pairs_per_step"])

    def _install(self) -> None:
        from align3d_torch.parallel import batch as pb

        self._pb = pb
        self._orig = (pb.build_pyramids_batched, pb.multiscale_align_batched)
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

    def setup(self, warm_units: int | None = None) -> None:
        from align3d_torch.camera import CameraIntrinsics
        from align3d_torch.ops.bilateral import BilateralFilter
        from align3d_torch.parallel.batch import odometry_step

        self._install()
        self.step_fn = odometry_step
        t0 = time.perf_counter()
        self.fixtures = self.traffic.load_fixtures(self.config.get("stride", 1))
        t1 = time.perf_counter()
        lengths = {k: len(v) for k, v in self.fixtures.items()}
        cams = {fx.camera for fx in self.fixtures.values()}
        if len(cams) != 1:
            raise RuntimeError("a step's frames must share one camera")
        self.camera = CameraIntrinsics(*cams.pop())
        self.pool = []
        for keys in self.traffic.windows(self.seed, lengths, self.pairs + 1):
            colors = np.stack([self.fixtures[f].colors[i] for f, i in keys])
            depths = np.stack([self.fixtures[f].depths[i] for f, i in keys])
            scales = [self.fixtures[f].depth_scale for f, _ in keys]
            scale = scales[0] if len(set(scales)) == 1 else np.asarray(scales, np.float32)
            self.pool.append({"frames": keys, "colors": colors, "depths": depths, "scale": scale})
        filt = self.config["bilateral_filter"]
        self.filter = BilateralFilter(filt["sigma_space"], filt["sigma_color"], filt["pad_depth_to"])
        self.params = icp_params(self.config)
        self.count = 0
        # Each window of the pool once: every shape and depth bucket the run meets.
        t2 = time.perf_counter()
        for _ in range(len(self.pool) if warm_units is None else warm_units):
            self._step(None)
        sync(self.device)
        self.setup_note = f"fixtures {t1 - t0:.2f} s, warm-up {time.perf_counter() - t2:.2f} s"

    def _step(self, tracer, keep: bool = False) -> dict:
        win = self.pool[self.count % len(self.pool)]
        self.count += 1
        self.capture = {} if keep else None
        timer = _MarkingTimer(tracer) if tracer is not None else None
        if tracer is not None:
            tracer.mark("upload")
        traj = self.step_fn(self.camera, win["scale"], win["colors"], win["depths"], self.params,
                            self.config["pyramid_levels"], self.filter, device=self.device, timer=timer)
        if tracer is not None:
            tracer.mark("readback")
        host = torch.cat([traj.camera_to_world.rotation, traj.camera_to_world.translation[..., None]], dim=-1)
        host = host.cpu().numpy()
        cap, self.capture = self.capture, None
        if keep and not {"depth", "pyramid", "rel"} <= set(cap):
            raise RuntimeError("odometry_step no longer calls build_pyramids_batched and multiscale_align_batched "
                               "of align3d_torch.parallel.batch: its stages cannot be checked")
        return {"frames": win["frames"], "traj": (host[..., :3], host[..., 3]), "capture": cap}

    def window(self, seconds: float, tracer, reservoir: Reservoir) -> dict:
        """Steps until the first one that ends past ``seconds``."""
        t_start = time.perf_counter()
        t_end, steps = t_start, 0
        while True:
            if tracer is not None:
                tracer.maybe_begin(t_end - t_start, seconds)
            if t_end - t_start >= seconds and (tracer is None or tracer.done):
                break
            keep = reservoir.offer()
            out = self._step(tracer, keep)
            t_end = time.perf_counter()
            steps += 1
            if tracer is not None:
                tracer.unit_done()
            if keep:
                reservoir.put(out)
        frames = steps * self.pairs
        self.note = f"steps {steps} of {self.pairs} pairs in {t_end - t_start:.3f} s"
        return {"attempted": frames, "window_s": t_end - t_start, "units": steps,
                "metrics": {"batch_ms_per_frame": (t_end - t_start) * 1e3 / frames}}

    def slice_work(self, steps: int) -> float:
        h, w = self.config["image"]["height"], self.config["image"]["width"]
        shapes = [(h >> k, w >> k) for k in range(self.config["pyramid_levels"])]
        if any(level["engine"] == "xla" for level in self.config["levels"]):
            raise RuntimeError("the exact engine's work needs the slice's valid pixels")
        nbytes, flops = roofline.align_work(self.config["levels"], shapes, self.pairs, [0] * len(shapes))
        return steps * roofline.least_seconds(nbytes, flops)

    def program_outputs(self, items: list) -> list[dict]:
        out = []
        for item in items:
            cap = item["capture"]
            out.append({
                "frames": item["frames"],
                "depth": cap["depth"],
                "pyramid": [{"points": ri.points, "mask": ri.mask, "normals": ri.normals,
                             "intensity_map": ri.intensity_map} for ri in cap["pyramid"]],
                "rel": (cap["rel"].rotation, cap["rel"].translation),
                "traj": item["traj"],
            })
        return out

    def close(self) -> None:
        """Put the program's functions back (also after a run that raised)."""
        if getattr(self, "_orig", None) is not None:
            self._pb.build_pyramids_batched, self._pb.multiscale_align_batched = self._orig
            self._orig = None

    def release(self) -> None:
        self.close()
        self.pool = None
        return None

    def chain_gap(self, chain, outputs: list, prec) -> float:
        """The scan of each sampled step against its own relative poses."""
        gap = 0.0
        for item in outputs:
            rel = tuple(x.cpu().numpy() for x in item["rel"])
            traj = item["traj"]
            if prec.lowp:
                rnd = lambda x: torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()  # noqa: E731
                rel, traj = tuple(rnd(x) for x in rel), tuple(rnd(x) for x in traj)
            gap = max(gap, check.scan_gap(rel, traj))
        return gap

    def reference(self, frames: list, prec) -> dict:
        return pipeline.outputs(self.config, self.fixtures, frames, prec, self.device)
