"""The live tracker: ``run_odometry``'s loop, one frame at a time, closed
loop. Per frame: ``RangeImageBuilder.build`` (upload, bilateral filter,
pyramid), ``MultiscaleAlign(params, previous).align(current)``,
``TrajectoryBuilder.accumulate``, and the camera-to-world pose read to the
host; the next frame goes in when that pose is there. A frame's latency
runs from handing its arrays to the program to its pose on the host.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark import check, roofline
from benchmark.drivers import Reservoir, icp_params, sync
from benchmark.reference import pipeline

UNIT = "frame"
SPANS = ("build", "align", "accumulate")  # the harness's spans, in a frame's order


class _CapturingFilter:
    """The program's filter, its last output kept (the filtered depth the
    builder goes on with)."""

    def __init__(self, inner):
        self.inner = inner
        self.last = None

    def filter(self, image):
        self.last = self.inner.filter(image)
        return self.last


def _levels(pyramid) -> list[dict]:
    return [{"points": ri.points, "mask": ri.mask, "normals": ri.normals, "intensity_map": ri.intensity_map}
            for ri in pyramid]


class Driver:
    def __init__(self, config: dict, traffic, seed: int, device, cell: dict):
        self.config, self.traffic, self.seed, self.device, self.cell = config, traffic, seed, device, cell

    def setup(self, warm_units: int = 2) -> None:
        from align3d_torch import MultiscaleAlign, RangeImageBuilder, Transform, TrajectoryBuilder
        from align3d_torch.camera import CameraIntrinsics
        from align3d_torch.image import RgbdFrame, RgbdImage
        from align3d_torch.ops.bilateral import BilateralFilter

        t0 = time.perf_counter()
        self.fixtures = self.traffic.load_fixtures(self.config.get("stride", 1))
        t1 = time.perf_counter()
        self.stream = self.traffic.stream(self.seed, {k: len(v) for k, v in self.fixtures.items()})
        frames = {}
        for name, fx in self.fixtures.items():
            camera = CameraIntrinsics(*fx.camera)
            for i in range(len(fx)):
                frames[(name, i)] = RgbdFrame(camera=camera, image=RgbdImage(fx.colors[i], fx.depths[i],
                                                                             fx.depth_scale))
        self.frames = frames
        filt = self.config["bilateral_filter"]
        self.filter = _CapturingFilter(BilateralFilter(filt["sigma_space"], filt["sigma_color"], filt["pad_depth_to"]))
        self.builder = RangeImageBuilder(bilateral_filter=self.filter, pyramid_levels=self.config["pyramid_levels"],
                                         blur_sigma=self.config["blur_sigma"])
        self.params = icp_params(self.config)
        self.align_cls = MultiscaleAlign
        self.traj = TrajectoryBuilder.with_start(Transform.identity(device=self.device), 0.0)
        self.count = 0
        self.prev_key = next(self.stream)
        self.prev = self.builder.build(self.frames[self.prev_key], self.device)
        self.prev_depth = self.filter.last
        self.last_host = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        t2 = time.perf_counter()
        for _ in range(warm_units):
            self._frame(None)
        sync(self.device)
        self.setup_note = f"fixtures {t1 - t0:.2f} s, warm-up {time.perf_counter() - t2:.2f} s"

    def _frame(self, tracer) -> dict:
        span = tracer.span if tracer is not None else (lambda _: contextlib.nullcontext())
        key = next(self.stream)
        with span("build"):
            pyramid = self.builder.build(self.frames[key], self.device)
        with span("align"):
            rel = self.align_cls(self.params, self.prev).align(pyramid)
        with span("accumulate"):
            self.count += 1
            self.traj.accumulate(rel, float(self.count))
            pose = self.traj.current_camera_to_world()
            host = torch.cat([pose.rotation, pose.translation[:, None]], dim=1).cpu().numpy()
        out = {"frames": [self.prev_key, key], "rel": rel, "abs": (host[:, :3], host[:, 3]), "pyramids": (self.prev, pyramid),
               "depths": (self.prev_depth, self.filter.last)}
        self.prev, self.prev_key, self.prev_depth = pyramid, key, self.filter.last
        self.last_host = out["abs"]
        return out

    def window(self, seconds: float, tracer, reservoir: Reservoir) -> dict:
        """Frames until the first one that ends past ``seconds``: the
        window's length, each frame's latency, the chain of poses."""
        latencies, rels, abss = [], [], []
        self.slice_sources = []
        start_pose = self.last_host
        t_start = time.perf_counter()
        t_end = t_start
        while True:
            if tracer is not None:
                tracer.maybe_begin(t_end - t_start, seconds)
            if t_end - t_start >= seconds and (tracer is None or tracer.done):
                break
            keep = reservoir.offer()
            t0 = time.perf_counter()
            out = self._frame(tracer)
            t_end = time.perf_counter()
            latencies.append(t_end - t0)
            if tracer is not None:
                if tracer.active:
                    self.slice_sources.append(out["pyramids"][1])
                tracer.unit_done()
            rels.append(out["rel"])
            abss.append(out["abs"])
            if keep:
                reservoir.put({"frames": out["frames"], "rel": out["rel"], "pyramids": out["pyramids"],
                               "depths": out["depths"]})
        self.chain = (rels, abss, start_pose)
        n = len(latencies)
        lat = np.asarray(latencies) * 1e3
        self.note = (f"frames {n}; latency ms p50 {np.percentile(lat, 50):.2f} p90 {np.percentile(lat, 90):.2f} "
                     f"max {lat.max():.2f}; frames over 1.2x the median {int((lat > 1.2 * np.median(lat)).sum())}")
        return {"attempted": n, "window_s": t_end - t_start, "units": n,
                "metrics": {"track_ms_per_frame": (t_end - t_start) * 1e3 / n,
                            "track_p90_ms": float(np.percentile(lat, 90))}}

    def slice_work(self, units: int) -> float:
        """The least time of the aligns of the profiled slice's frames, from
        each level's shape and valid source pixels."""
        total = 0.0
        for pyramid in self.slice_sources:
            shapes = [tuple(ri.mask.shape) for ri in pyramid]
            valid = [int(ri.mask.sum()) for ri in pyramid]
            total += roofline.least_seconds(*roofline.align_work(self.config["levels"], shapes, 1, valid))
        return total

    def program_outputs(self, items: list) -> list[dict]:
        """The sampled frames' outputs as the checks read them, on the host side of the device."""
        out = []
        for item in items:
            levels = [_levels(p) for p in item["pyramids"]]
            out.append({
                "frames": item["frames"],
                "depth": torch.stack(list(item["depths"])),
                "pyramid": [{k: torch.stack([lv[i][k] for lv in levels]) for k in levels[0][i]}
                            for i in range(len(levels[0]))],
                "rel": (item["rel"].rotation[None], item["rel"].translation[None]),
            })
        return out

    def release(self) -> tuple:
        """Drop the program's state; return what the checks need of the window."""
        rels, abss, start = self.chain
        rel = torch.stack([torch.cat([r.rotation, r.translation[:, None]], dim=1) for r in rels]).cpu().numpy()
        chain = ((rel[:, :, :3], rel[:, :, 3]), (np.stack([a[0] for a in abss]), np.stack([a[1] for a in abss])),
                 start)
        for name in ("prev", "prev_depth", "traj", "builder", "filter", "chain"):
            setattr(self, name, None)
        return chain

    def chain_gap(self, chain, outputs: list, prec) -> float:
        """Each window frame's accumulated pose against its relative pose and
        the pose before it."""
        rel, abs_, start = chain
        if prec.lowp:  # the control: the accumulated poses kept in bf16
            rnd = lambda x: torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()  # noqa: E731
            rel, abs_, start = [tuple(rnd(x) for x in pair) for pair in (rel, abs_, start)]
        return check.chain_gap(rel, abs_, start)

    def reference(self, frames: list, prec) -> dict:
        return pipeline.outputs(self.config, self.fixtures, frames, prec, self.device)
