"""The live tracking server, ``align3d_torch.live.LiveOdometry``.

On the CPU (tier-1), at 64 x 48 (sample1 at a stride of 10) and 4 GN
iterations a level: latest frame wins on a scripted clock, with its
counters; every tracked pair against the benchmark's plain reference
(``benchmark/reference/live.py``); each stream's trajectory bitwise
``run_odometry``'s over the frames the server tracked; a stream's poses the
same bits alone and among other streams, and in a padded bucket; ``push``
from a second thread while ``step`` runs. On the card (marker ``cuda``; on
a GPU machine without JAX: ``python -m pytest --noconftest
tests/test_torch_live.py``), at 640 x 480 and upstream's iterations: no
level graph captured after ``warm()`` while B visits every bucket, the
bucket graphs bitwise the eager loop, batch invariance.
"""

import gc
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_torch import LiveOdometry, RangeImageBuilder, live
from align3d_torch.camera import CameraIntrinsics
from align3d_torch.icp import image_icp, level_graph
from align3d_torch.icp.params import MsIcpParams
from align3d_torch.image import RgbdFrame, RgbdImage
from align3d_torch.odometry import run_odometry
from align3d_torch.ops.bilateral import BilateralFilter
from align3d_torch.parallel.batch import filter_buckets
from benchmark import fixtures
from benchmark.reference import FULL
from benchmark.reference import live as live_ref

ROOT = Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "live-exact-640x480.json").read_text())
LIMITS = json.loads((ROOT / "benchmark" / "cells" / "tracker-exact-640x480.sample1-walk.json").read_text())["limits"]
ITERATIONS = 4
SMALL_CONFIG = {**CONFIG, "levels": [dict(level, iterations=ITERATIONS) for level in CONFIG["levels"]]}
SMALL_PARAMS = MsIcpParams.default().customize(lambda i, p: p.replace(max_iterations=ITERATIONS))
FILTER = BilateralFilter(**CONFIG["bilateral_filter"])

# Before each step, the (stream, sample1 frame, timestamp) pushed, in order. Stream 0's frame 1
# and stream 2's frames 11 and 12 are overtaken while they wait; the last step holds 3 pairs,
# padded to the 4-stream server's bucket of 4.
SCRIPT = [
    [(0, 0, 0.0), (1, 5, 0.0), (2, 10, 0.0)],
    [(0, 1, 1.0), (0, 2, 2.0), (1, 6, 1.0)],
    [(2, 11, 1.0), (2, 12, 2.0), (2, 13, 3.0), (3, 20, 0.0)],
    [(0, 3, 3.0), (1, 7, 2.0), (3, 21, 1.0)],
]


@pytest.fixture(scope="module")
def sample1():
    return fixtures.load("sample1", None, 10)


def _frame(fx, i: int) -> RgbdImage:
    return RgbdImage(fx.colors[i], fx.depths[i], fx.depth_scale)


def _server(fx, streams: int, params=SMALL_PARAMS, device="cpu") -> LiveOdometry:
    return LiveOdometry(CameraIntrinsics(*fx.camera), fx.depth_scale, streams, params, FILTER, device=device)


def _play(server, fx, script) -> tuple[list, dict]:
    """Push and step ``script``; (the steps, each stream's tracked frames)."""
    steps, tracked = [], {}
    for pushes in script:
        latest = {}
        for stream, frame, t in pushes:
            server.push(stream, _frame(fx, frame), t)
            latest[stream] = frame
        step = server.step()
        steps.append(step)
        for s in step.streams:
            tracked.setdefault(s, []).append(latest[s])
    return steps, tracked


def _delta(before: dict, after: dict) -> dict:
    out = {}
    for name, value in after.items():
        if isinstance(value, dict):
            out[name] = {k: n - before[name].get(k, 0) for k, n in value.items() if n != before[name].get(k, 0)}
        else:
            out[name] = value - before[name]
    return out


def test_latest_frame_wins(sample1):
    server = _server(sample1, 4)
    assert server.step() is None
    before = live.counts()
    steps, tracked = _play(server, sample1, SCRIPT)
    assert [(s.streams, s.times, s.pairs, s.bucket) for s in steps] == [
        ([0, 1, 2], [0.0, 0.0, 0.0], 0, 0),
        ([0, 1], [2.0, 1.0], 2, 2),
        ([2, 3], [3.0, 0.0], 1, 1),
        ([0, 1, 3], [3.0, 2.0, 1.0], 3, 4),
    ]
    assert tracked == {0: [0, 2, 3], 1: [5, 6, 7], 2: [10, 13], 3: [20, 21]}
    assert [s.poses.shape for s in steps] == [(0, 3, 4), (2, 3, 4), (1, 3, 4), (3, 3, 4)]
    counts = _delta(before, live.counts())
    wait = counts.pop("wait_s")
    assert counts == {"arrived": 13, "tracked": 6, "started": 4, "dropped": 3, "steps": 4, "pad_pairs": 1,
                      "steps_by_bucket": {1: 1, 2: 1, 4: 1}, "pairs_by_bucket": {1: 1, 2: 2, 4: 3}}
    assert 0.0 <= wait < 60.0
    assert {s: server.trajectory(s).times.tolist() for s in range(4)} == {
        0: [0.0, 2.0, 3.0], 1: [0.0, 1.0, 2.0], 2: [0.0, 3.0], 3: [0.0, 1.0]}
    assert server.step() is None
    assert server.push(1, _frame(sample1, 8), 3.0) is False and server.push(1, _frame(sample1, 9), 4.0) is True
    step = server.step()
    assert (step.streams, step.times, step.pairs) == ([1], [4.0], 1)


def test_the_wait_runs_from_the_arrival(sample1):
    """The summed wait runs from the arrival handed to ``push`` (else the
    push) to the start of the step that takes the frame; a stream's first
    frame, which starts it, adds none."""
    server = _server(sample1, 2)
    server.push(0, _frame(sample1, 0), 0.0)
    server.push(1, _frame(sample1, 5), 0.0)
    server.step()
    before = live.counts()["wait_s"]
    server.push(0, _frame(sample1, 1), 1.0, time.perf_counter() - 2.0)
    server.push(1, _frame(sample1, 6), 1.0)
    pushed = time.perf_counter()
    assert server.step().pairs == 2
    wait = live.counts()["wait_s"] - before
    assert 2.0 <= wait <= 2.0 + 2 * (time.perf_counter() - pushed) + 0.5


def test_a_long_stream_keeps_every_pose_and_no_object_a_frame(sample1):
    """A stream's trajectory holds every tracked frame's pose, as its steps
    returned them, past its arrays' first doubling; tracking adds no object
    for the cycle collector a frame."""
    server = _server(sample1, 1)
    walk = [n % 30 if (n // 30) % 2 == 0 else 30 - n % 30 for n in range(80)]
    returned, alive = [], []
    for n, frame in enumerate(walk):
        server.push(0, _frame(sample1, frame), float(n))
        step = server.step()
        returned.extend(step.poses.copy())
        if n in (40, 79):  # after every frame of the walk has been seen once
            gc.collect()
            alive.append(len(gc.get_objects()))
    traj = server.trajectory(0)
    assert traj.times.tolist() == [float(n) for n in range(80)]
    assert torch.equal(traj.camera_to_world.rotation[1:], torch.from_numpy(np.stack(returned)[:, :, :3]))
    assert torch.equal(traj.camera_to_world.translation[1:], torch.from_numpy(np.stack(returned)[:, :, 3]))
    assert alive[1] - alive[0] < 20, alive  # a Transform kept a frame would add 3 x 39


def test_bad_pushes_raise(sample1):
    server = _server(sample1, 2)
    with pytest.raises(IndexError):
        server.push(2, _frame(sample1, 0), 0.0)
    with pytest.raises(ValueError):
        server.push(0, RgbdImage(sample1.colors[0], sample1.depths[0].astype(np.int32), sample1.depth_scale), 0.0)
    with pytest.raises(ValueError):
        server.push(0, RgbdImage(sample1.colors[0, :8], sample1.depths[0, :8], sample1.depth_scale), 0.0)
    with pytest.raises(ValueError):
        server.push(0, RgbdImage(sample1.colors[0], sample1.depths[0], 2 * sample1.depth_scale), 0.0)
    assert live.bucket_of(3, 4) == 4 and live.bucket_of(5, 6) == 6 and live.buckets(6) == [1, 2, 4, 6]


def test_tracked_pairs_against_the_reference(sample1, monkeypatch):
    """Each tracked pair's filtered depths and pyramids bitwise the plain
    reference's, its relative pose within the tracker cell's limits; each
    stream's trajectory against the reference's chain of its pairs."""
    depths, aligned = [], []
    real_filter, real_align = live.filter_buckets, live.multiscale_align_batched

    def filter_spy(*args):
        out = real_filter(*args)
        depths.append(out[0])
        return out

    def align_spy(targets, sources, params):
        aligned.append((targets, sources))
        return real_align(targets, sources, params)

    monkeypatch.setattr(live, "filter_buckets", filter_spy)
    monkeypatch.setattr(live, "multiscale_align_batched", align_spy)
    server = _server(sample1, 4)
    steps, tracked = _play(server, sample1, SCRIPT)
    fxs = {"sample1": sample1}
    seen, compared = {}, 0  # stream -> the filtered depths of its frames so far
    for step, step_depths in zip(steps, depths):
        targets, sources = aligned.pop(0) if step.pairs else (None, None)
        for i, s in enumerate(step.streams):
            seen.setdefault(s, []).append(step_depths[i])
            if i >= step.pairs:
                continue
            n = len(seen[s]) - 1  # this frame's place among the stream's tracked frames
            keys = [("sample1", tracked[s][n - 1]), ("sample1", tracked[s][n])]
            ref = live_ref.pair_outputs(SMALL_CONFIG, fxs, keys, FULL, "cpu")
            assert torch.equal(torch.stack(seen[s][n - 1:]), ref["depth"])
            for level, (tgt, src, want) in enumerate(zip(targets, sources, ref["pyramid"])):
                for field in ("points", "mask", "normals", "intensity_map"):
                    got = torch.stack([getattr(tgt, field)[i], getattr(src, field)[i]])
                    assert torch.equal(got, want[field]), (level, field)
            chord = (step.relative.rotation[i] - ref["rel"][0][0]).norm()
            angle = 2.0 * torch.asin(torch.clamp(chord / (2.0 * 2.0 ** 0.5), max=1.0))
            assert angle <= LIMITS["pose_rot_rad"]
            assert (step.relative.translation[i] - ref["rel"][1][0]).norm() <= LIMITS["pose_trans_m"]
            compared += 1
    assert compared == 6
    for s, frames in tracked.items():
        want_r, want_t = live_ref.trajectory(SMALL_CONFIG, fxs, [("sample1", f) for f in frames], FULL, "cpu")
        got = server.trajectory(s).camera_to_world
        # Each pair within the limits above, the chain at most their sum.
        assert (got.rotation - want_r).abs().max() <= LIMITS["pose_rot_rad"] * len(frames)
        assert (got.translation - want_t).abs().max() <= LIMITS["pose_trans_m"] * len(frames)


class _NonzeroSpanFilter:
    """The server's filter for ``RangeImageBuilder``: one frame through
    ``filter_buckets`` (its grid from its nonzero depth span)."""

    def filter(self, image):
        return filter_buckets(FILTER, image[None])[0][0]


class _Frames:
    """``run_odometry``'s dataset over some frames of a fixture."""

    def __init__(self, fx, frames):
        self.fx, self.frames = fx, frames
        self.camera = CameraIntrinsics(*fx.camera)

    def __len__(self):
        return len(self.frames)

    def get(self, i):
        return RgbdFrame(camera=self.camera, image=_frame(self.fx, self.frames[i]))

    def trajectory(self):
        return None


def test_each_stream_is_run_odometry_over_its_tracked_frames(sample1):
    """Bitwise: the batched filter, pyramids, align and compose of a step
    give each pair and pose the bits of the one-frame path."""
    server = _server(sample1, 4)
    _, tracked = _play(server, sample1, SCRIPT)
    builder = RangeImageBuilder(bilateral_filter=_NonzeroSpanFilter(), pyramid_levels=3, blur_sigma=1.0)
    for s, frames in tracked.items():
        want = run_odometry(_Frames(sample1, frames), "cpu", builder, SMALL_PARAMS).trajectory.camera_to_world
        got = server.trajectory(s).camera_to_world
        assert torch.equal(got.rotation, want.rotation) and torch.equal(got.translation, want.translation), s


def _trajectories(server) -> list:
    return [server.trajectory(s).camera_to_world for s in range(server.streams)]


def _bitwise(a, b) -> bool:
    return torch.equal(a.rotation, b.rotation) and torch.equal(a.translation, b.translation)


WALKS = {0: [0, 1, 2, 4], 1: [12, 11, 10, 9], 2: [20, 22, 23, 24]}


def _walk_script(streams) -> list:
    return [[(s, WALKS[s][n], float(n)) for s in streams] for n in range(4)]


def test_a_stream_alone_and_among_others_is_bitwise(sample1):
    together = _server(sample1, 3)
    _play(together, sample1, _walk_script([0, 1, 2]))
    for s in range(3):
        alone = _server(sample1, 3)
        _play(alone, sample1, _walk_script([s]))
        assert _bitwise(_trajectories(alone)[s], _trajectories(together)[s]), s


def test_a_padded_bucket_gives_the_unpadded_poses(sample1):
    padded, unpadded = _server(sample1, 4), _server(sample1, 3)  # 3 pairs a step: bucket 4 / bucket 3
    before = live.counts()["pad_pairs"]
    _play(padded, sample1, _walk_script([0, 1, 2]))
    assert live.counts()["pad_pairs"] - before == 3
    _play(unpadded, sample1, _walk_script([0, 1, 2]))
    assert live.counts()["pad_pairs"] - before == 3
    for a, b in zip(_trajectories(padded)[:3], _trajectories(unpadded)):
        assert _bitwise(a, b)


def test_push_from_another_thread_while_stepping(sample1):
    server = _server(sample1, 2)
    pushed = {0: [], 1: []}
    before = live.counts()

    def sensor():
        for n in range(10):
            for s in (0, 1):
                server.push(s, _frame(sample1, n + 10 * s), float(n))
                pushed[s].append(float(n))
            time.sleep(0.005)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        thread = threading.Thread(target=sensor)
        thread.start()
        deadline = time.monotonic() + 120
        while thread.is_alive() and time.monotonic() < deadline:
            server.step()
        thread.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not thread.is_alive()
    server.step()  # what the sensor pushed after the last step
    assert server.step() is None
    counts = _delta(before, live.counts())
    assert counts["arrived"] == 20
    assert counts["tracked"] + counts["started"] + counts["dropped"] == 20
    for s in (0, 1):
        times = server.trajectory(s).times.tolist()
        assert times == sorted(set(times)) and set(times) <= set(pushed[s]) and times[-1] == 9.0
    assert counts["tracked"] == len(server.trajectory(0)) + len(server.trajectory(1)) - 2


# -- on the card ------------------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def full_sample1(cuda_device):
    return fixtures.load("sample1")


# Every bucket of a 4-stream server (1, 2, 4) and the padded B = 3.
CARD_SCRIPT = [[(s, 2 * s, 0.0) for s in range(4)], [(0, 1, 1.0)], [(0, 2, 2.0), (1, 3, 1.0)],
               [(0, 3, 3.0), (1, 4, 2.0), (2, 5, 1.0)], [(s, 2 * s + 6, 4.0) for s in range(4)]]


@pytest.mark.cuda
def test_no_capture_after_warm_and_graphs_bitwise_the_eager_loop(full_sample1, cuda_device, monkeypatch):
    params = MsIcpParams.default()
    server = _server(full_sample1, 4, params, cuda_device)
    server.warm(_frame(full_sample1, 0))
    captures = level_graph.counts()["captures"]
    before = live.counts()
    _play(server, full_sample1, CARD_SCRIPT)
    assert level_graph.counts()["captures"] == captures
    assert _delta(before, live.counts())["steps_by_bucket"] == {1: 1, 2: 1, 4: 2}
    monkeypatch.setitem(image_icp._BATCHED, "xla", image_icp._EAGER["xla"])
    eager = _server(full_sample1, 4, params, cuda_device)
    _play(eager, full_sample1, CARD_SCRIPT)
    assert level_graph.counts()["captures"] == captures
    for a, b in zip(_trajectories(server), _trajectories(eager)):
        assert _bitwise(a, b)


@pytest.mark.cuda
def test_a_stream_alone_and_among_others_is_bitwise_on_the_card(full_sample1, cuda_device):
    params = MsIcpParams.default()
    together = _server(full_sample1, 3, params, cuda_device)
    _play(together, full_sample1, _walk_script([0, 1, 2]))
    for s in range(3):
        alone = _server(full_sample1, 3, params, cuda_device)
        _play(alone, full_sample1, _walk_script([s]))
        assert _bitwise(_trajectories(alone)[s], _trajectories(together)[s]), s
