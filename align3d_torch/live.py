"""Live RGB-D tracking on sensor clocks: one server for the frames of S
streams.

:class:`LiveOdometry` tracks each of S RGB-D streams frame to frame, with
``run_odometry``'s pairs (the new frame as source, the stream's last
tracked frame as target, the identity as the initial pose; upstream's
``examples/src/bin/odometry.rs``), while the frames come in on the
sensors' own clocks:

* **Latest frame wins.** Each stream has a one-slot mailbox.
  :meth:`LiveOdometry.push`, safe from any thread, puts a frame there; a
  frame still waiting when a newer one of its stream arrives is dropped,
  and the stream's next pair is the newer frame against its last tracked
  frame. A stream's first frame only fills its slot: its pose is the start
  of the stream's trajectory, the identity.
* **One batched step.** :meth:`LiveOdometry.step` takes the pending frame
  of every stream that has one (B of S) and, on the card: uploads them
  through pinned buffers, the depths as u16 widened there; filters them in
  one call (``filter_buckets``: K2, blur, K3, each frame on its own true
  depth span); builds their pyramids in one call (``build_pyramids_batched``:
  K12, K13); stacks the B streams' last frames as the targets; aligns
  the B pairs in one ``multiscale_align_batched`` (the exact engine: K1,
  K11); composes each stream's pose and reads the B poses back in one copy.
* **Buckets.** The align's level graphs (:mod:`align3d_torch.icp.level_graph`)
  are keyed by the batch's shape, so B is padded up to its bucket
  (:func:`bucket_of`: a power of two, or S above the largest one below S) by
  repeating the step's first pair, whose copies' results are dropped: a pad
  pair is a real pair, never a NaN. :meth:`LiveOdometry.warm` captures
  every bucket's levels, so no live step captures.
* **Batch invariance.** A stream's pose does not depend on the streams that
  share its step: the filter, K12 / K13, K1 and K11 compute each frame or
  pair alone, in the same order at any batch size (so do their CPU twins),
  the stacking and the padding copy bits, and ``Transform.compose`` gives a
  pose the same bits in any batch. So each stream's trajectory is
  ``run_odometry``'s over the frames the server tracked, with the same
  filter (``tests/test_torch_live.py``).
* **State.** A stream keeps its last frame's levels and its last pose on
  the device, and its trajectory in host arrays that double when full: a
  tracked frame leaves no Python object behind, so the cycle collector's
  full collections do not grow with the frames a server has tracked.

Spans (:mod:`align3d_torch.utils.profiling`): ``live.step`` (root, ``pairs``
= B) and under it ``live.upload``, ``live.filter``, ``live.pyramid`` and
``live.readback``; the align keeps its ``icp.align`` / ``icp.level`` /
``gn.replay``. :func:`counts` counts, over this process's servers, the
frames arrived, tracked, started (a stream's first) and dropped, the steps,
the pad pairs, the steps and pairs by bucket, and the summed wait from
each tracked frame's arrival (given to :meth:`~LiveOdometry.push`, else
the push) to the start of the step that took it.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from align3d_torch.camera import CameraIntrinsics
from align3d_torch.icp.params import MsIcpParams
from align3d_torch.image import RgbdImage
from align3d_torch.ops.bilateral import BilateralFilter
from align3d_torch.parallel.batch import build_pyramids_batched, filter_buckets, multiscale_align_batched
from align3d_torch.range_image import RangeImage
from align3d_torch.se3 import Transform, stack
from align3d_torch.trajectory import Trajectory
from align3d_torch.utils import profiling

#: What ``multiscale_align_batched`` reads of a level of a target or a source.
ALIGN_FIELDS = ("points", "mask", "intensities", "normals", "intensity_map")

_counts_lock = threading.Lock()
_counts = {"arrived": 0, "tracked": 0, "started": 0, "dropped": 0, "steps": 0, "pad_pairs": 0, "wait_s": 0.0,
           "steps_by_bucket": {}, "pairs_by_bucket": {}}


def counts() -> dict:
    """This process's live counters so far (a copy; read differences)."""
    with _counts_lock:
        out = dict(_counts)
        out["steps_by_bucket"] = dict(_counts["steps_by_bucket"])
        out["pairs_by_bucket"] = dict(_counts["pairs_by_bucket"])
    return out


def _count(bucket: int = 0, pairs: int = 0, **added) -> None:
    with _counts_lock:
        for name, n in added.items():
            _counts[name] += n
        if pairs:
            _counts["steps_by_bucket"][bucket] = _counts["steps_by_bucket"].get(bucket, 0) + 1
            _counts["pairs_by_bucket"][bucket] = _counts["pairs_by_bucket"].get(bucket, 0) + pairs


def bucket_of(pairs: int, streams: int) -> int:
    """The batch size a step of ``pairs`` pairs is padded to: the next power
    of two, at most ``streams``."""
    return min(1 << (pairs - 1).bit_length(), streams)


def buckets(streams: int) -> list[int]:
    """Every bucket of a server of ``streams`` streams, smallest first."""
    return sorted({bucket_of(b, streams) for b in range(1, streams + 1)})


def _batch(frames: list[torch.Tensor]) -> torch.Tensor:
    """Single frames' tensors as one batch: a view of a lone frame, else one copy."""
    return frames[0][None] if len(frames) == 1 else torch.stack(frames)


def _fill(rows: torch.Tensor, pairs: int, bucket: int) -> torch.Tensor:
    """The first ``pairs`` rows of a batch, the first repeated up to ``bucket``
    rows (a view when nothing is repeated)."""
    if bucket == pairs:
        return rows[:pairs]
    return torch.cat([rows[:pairs], rows[:1].expand(bucket - pairs, *rows.shape[1:])])


@dataclasses.dataclass
class LiveStep:
    """What one :meth:`LiveOdometry.step` did. Row i of the step's batch is
    the frame of stream ``streams[i]``, stamped ``times[i]``; the first
    ``pairs`` rows were aligned (``poses[i]``, ``relative[i]``), the rest
    started their streams."""

    streams: list[int]
    times: list[float]
    pairs: int
    bucket: int  # the align's batch size, ``pairs`` padded (0: nothing aligned)
    poses: np.ndarray  # (pairs, 3, 4) float32 camera-to-world [R | t] of the aligned streams, on the host
    relative: Transform  # (pairs,) the aligned pairs' relative poses (source in target's frame), on the device


class LiveOdometry:
    """Frame-to-frame tracking of ``streams`` RGB-D streams of one camera
    model (``camera``, ``depth_scale``) on ``device``, a step at a time (the
    module docstring). ``params`` defaults to ``MsIcpParams.default()``
    (upstream's exact engine); ``bilateral_filter`` filters each depth
    frame first. :meth:`push` may be called from any thread; :meth:`step`
    and :meth:`warm` from one."""

    def __init__(self, camera: CameraIntrinsics, depth_scale: float, streams: int,
                 params: MsIcpParams | None = None, bilateral_filter: BilateralFilter | None = None,
                 pyramid_levels: int = 3, blur_sigma: float = 1.0, device="cuda"):
        if streams < 1:
            raise ValueError(f"a server tracks at least one stream, got {streams}")
        self.params = params or MsIcpParams.default()
        if len(self.params) != pyramid_levels:
            raise ValueError(f"{len(self.params)} ICP levels for a {pyramid_levels}-level pyramid")
        self.camera, self.depth_scale, self.streams = camera, float(depth_scale), int(streams)
        self.filter, self.pyramid_levels, self.blur_sigma = bilateral_filter, pyramid_levels, blur_sigma
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._mail: list[tuple | None] = [None] * self.streams  # (frame, timestamp, arrival)
        self._pose: list[Transform | None] = [None] * self.streams  # each stream's last pose, on the device
        # Each stream's camera-to-world [R | t] of its tracked frames and their timestamps, on the host,
        # in arrays that double when full: a tracked frame adds no Python object that outlives its step.
        self._poses: list[np.ndarray | None] = [None] * self.streams
        self._times: list[np.ndarray | None] = [None] * self.streams
        self._length = [0] * self.streams
        self._last: list[list[RangeImage] | None] = [None] * self.streams  # each stream's last frame's levels
        self._staging: tuple | None = None  # pinned colour and depth buffers of S frames, the event of their copy

    def push(self, stream: int, frame: RgbdImage, t: float, arrived: float | None = None) -> bool:
        """Put ``frame`` (u8 colour (H, W, 3), u16 depth (H, W) host arrays),
        stamped ``t`` seconds, in ``stream``'s mailbox. ``arrived`` is when
        the frame came in, a ``time.perf_counter()`` reading (default: now):
        the wait that :func:`counts` sums runs from it to the start of the
        step that takes the frame. Returns whether it replaced a frame still
        waiting there, which is then dropped."""
        if not 0 <= stream < self.streams:
            raise IndexError(f"stream {stream} of a {self.streams}-stream server")
        h, w = self.camera.height, self.camera.width
        if frame.color.shape != (h, w, 3) or frame.depth.shape != (h, w):
            raise ValueError(f"a {w}x{h} camera got colour {frame.color.shape}, depth {frame.depth.shape}")
        if frame.color.dtype != np.uint8 or frame.depth.dtype != np.uint16:
            raise ValueError(f"frames are u8 colour and u16 depth, got {frame.color.dtype} and {frame.depth.dtype}")
        if frame.depth_scale is not None and float(frame.depth_scale) != self.depth_scale:
            raise ValueError(f"depth scale {frame.depth_scale} on a server of depth scale {self.depth_scale}")
        arrived = time.perf_counter() if arrived is None else float(arrived)
        with self._lock:
            replaced = self._mail[stream] is not None
            self._mail[stream] = (frame, float(t), arrived)
        _count(arrived=1, dropped=int(replaced))
        return replaced

    def step(self) -> LiveStep | None:
        """Track every stream's waiting frame in one batched step (the module
        docstring); None when no frame waits."""
        with self._lock:
            taken = [(s, m) for s, m in enumerate(self._mail) if m is not None]
            for s, _ in taken:
                self._mail[s] = None
        if not taken:
            return None
        began = time.perf_counter()
        rows = [r for r in taken if self._pose[r[0]] is not None] + [r for r in taken if self._pose[r[0]] is None]
        streams, times = [s for s, _ in rows], [m[1] for _, m in rows]
        b = sum(self._pose[s] is not None for s in streams)
        bucket = bucket_of(b, self.streams) if b else 0
        with profiling.span("live.step", pairs=b):
            colors, depths = self._upload([m[0] for _, m in rows])
            pyramid = self._preprocess(colors, depths)
            if b:
                relative = self._align(pyramid, streams[:b], bucket)
                now = relative.compose(stack([self._pose[s] for s in streams[:b]]))
            for i, s in enumerate(streams):
                self._last[s] = [level.frames(i) for level in pyramid]
                self._pose[s] = now[i] if i < b else Transform.identity(device=self.device)
            with profiling.span("live.readback"):
                if b:
                    poses = torch.cat([now.rotation, now.translation[..., None]], dim=-1).cpu().numpy()
                else:
                    relative, poses = Transform.identity((0,), device=self.device), np.zeros((0, 3, 4), np.float32)
            for i, (s, t) in enumerate(zip(streams, times)):
                self._record(s, poses[i] if i < b else np.eye(3, 4, dtype=np.float32), t)
        _count(bucket, b, tracked=b, started=len(rows) - b, steps=1, pad_pairs=bucket - b,
               wait_s=sum(began - m[2] for _, m in rows[:b]))
        return LiveStep(streams, times, b, bucket, poses, relative)

    def trajectory(self, stream: int) -> Trajectory:
        """``stream``'s camera-to-world poses of its tracked frames, first at
        the origin, with their timestamps, on the server's device."""
        n = self._length[stream]
        if not n:
            return Trajectory.empty()
        poses = torch.from_numpy(self._poses[stream][:n].copy())
        pose = Transform(poses[:, :, :3].contiguous(), poses[:, :, 3].contiguous())
        return Trajectory(pose, torch.from_numpy(self._times[stream][:n].astype(np.float32))).to(self.device)

    def _record(self, stream: int, pose: np.ndarray, t: float) -> None:
        """Append a tracked frame's (3, 4) camera-to-world pose, stamped ``t``,
        to ``stream``'s arrays, doubling them when full."""
        n, poses = self._length[stream], self._poses[stream]
        if poses is None or n == len(poses):
            grown = np.empty((max(64, 2 * n), 3, 4), np.float32)
            times = np.empty(len(grown), np.float64)
            if n:
                grown[:n], times[:n] = poses, self._times[stream]
            self._poses[stream], self._times[stream] = grown, times
        self._poses[stream][n] = pose
        self._times[stream][n] = t
        self._length[stream] = n + 1

    def warm(self, frame: RgbdImage) -> None:
        """Run a step's whole path once at each bucket, on copies of ``frame``
        aligned against themselves, leaving every stream and counter as it
        was: every bucket's level graphs are captured here, and the filter's
        and the pyramid's kernels loaded."""
        for bucket in buckets(self.streams):
            colors, depths = self._upload([frame] * bucket)
            pyramid = self._preprocess(colors, depths)
            multiscale_align_batched(pyramid, pyramid, self.params)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _upload(self, frames: list[RgbdImage]) -> tuple[torch.Tensor, torch.Tensor]:
        """The frames' colours (N, H, W, 3) u8 and depths (N, H, W) int32 on the
        device: one copy each, the depths as u16, widened there. On the card
        the frames are stacked into pinned buffers of S frames, copied
        asynchronously; the next upload waits for that copy before it writes
        the buffers again."""
        with profiling.span("live.upload"):
            if self.device.type != "cuda":
                colors = torch.from_numpy(np.stack([f.color for f in frames]))
                depths = torch.from_numpy(np.stack([f.depth for f in frames]))
                return colors, depths.to(torch.int32)
            if self._staging is None:
                h, w = self.camera.height, self.camera.width
                self._staging = (torch.empty((self.streams, h, w, 3), dtype=torch.uint8, pin_memory=True),
                                 torch.empty((self.streams, h, w), dtype=torch.uint16, pin_memory=True),
                                 torch.cuda.Event())
            colors, depths, copied = self._staging
            copied.synchronize()
            n = len(frames)
            np.stack([f.color for f in frames], out=colors[:n].numpy())
            np.stack([f.depth for f in frames], out=depths[:n].numpy())
            colors = colors[:n].to(self.device, non_blocking=True)
            depths = depths[:n].to(self.device, non_blocking=True)
            copied.record()
        return colors, depths.to(torch.int32)

    def _preprocess(self, colors: torch.Tensor, depths: torch.Tensor) -> list[RangeImage]:
        with profiling.span("live.filter"):
            if self.filter is not None:
                depths, _ = filter_buckets(self.filter, depths)
        with profiling.span("live.pyramid"):
            return build_pyramids_batched(self.camera, self.depth_scale, colors, depths,
                                          pyramid_levels=self.pyramid_levels, blur_sigma=self.blur_sigma)

    def _align(self, pyramid: list[RangeImage], streams: list[int], bucket: int) -> Transform:
        """The relative poses of the first ``len(streams)`` frames of
        ``pyramid`` against their streams' last frames, aligned as one batch of
        ``bucket`` pairs, the first pair repeated to fill it."""
        b = len(streams)
        fill = streams + streams[:1] * (bucket - b)
        targets, sources = [], []
        for k, level in enumerate(pyramid):
            targets.append(RangeImage(intrinsics=level.intrinsics, **{
                f: _batch([getattr(self._last[s][k], f) for s in fill]) for f in ALIGN_FIELDS}))
            sources.append(RangeImage(intrinsics=level.intrinsics, **{
                f: _fill(getattr(level, f), b, bucket) for f in ALIGN_FIELDS}))
        return multiscale_align_batched(targets, sources, self.params)[:b]
