"""The program's spans (``align3d_torch/utils/profiling.py``): when they are
recorded, their parents, roots and self times, the cap, the spans of the
tracker's and the batch step's paths (with the same results recorded or
not), their clock against the profiler's trace, and the benchmark's four
readers of them. CPU only."""

import importlib.util
import json
import time
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_torch import MultiscaleAlign, RangeImageBuilder
from align3d_torch.camera import CameraIntrinsics
from align3d_torch.icp.params import IcpParams, MsIcpParams
from align3d_torch.image import RgbdFrame, RgbdImage
from align3d_torch.ops.bilateral import BilateralFilter
from align3d_torch.parallel.batch import odometry_step
from align3d_torch.utils import StageTimer, profiling

METRICS = Path(__file__).resolve().parents[1] / "benchmark" / "metrics"


@pytest.fixture(autouse=True)
def _clean():
    profiling.clear()
    yield
    profiling.clear()


def _names(spans=None) -> Counter:
    return Counter(s.name for s in (profiling.spans() if spans is None else spans))


def _sequence(n: int, h: int = 48, w: int = 64):
    """A textured relief drifting one pixel a frame (u8 colour, u16 depth)."""
    rng = np.random.default_rng(0)
    tex = rng.uniform(50, 200, size=(h + 16, w + n + 16, 3)).astype(np.uint8)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    colors, depths = [], []
    for i in range(n):
        relief = 40 * np.sin((xs + i) * 0.35) * np.cos(ys * 0.3)
        depths.append((2000 + 3 * (xs + i) + 2 * ys + relief).astype(np.uint16))
        colors.append(tex[4:4 + h, 4 + i:4 + i + w])
    intr = CameraIntrinsics(fx=40.0, fy=40.0, cx=w / 2 - 0.5, cy=h / 2 - 0.5, width=w, height=h)
    return intr, np.stack(colors), np.stack(depths)


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(f"_metric_{name}", METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_off_by_default_on_under_recording_and_the_profiler():
    assert profiling.begin("a") == -1 and not profiling.spans()
    with profiling.span("b"):
        pass
    assert not profiling.spans()
    with profiling.recording():
        with profiling.recording():
            profiling.end(profiling.begin("c"))
        profiling.end(profiling.begin("d"))
    profiling.end(profiling.begin("e"))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("f"):
            pass
    profiling.end(profiling.begin("g"))
    assert [s.name for s in profiling.spans()] == ["c", "d", "f"]
    assert all(s.end is not None and s.end >= s.start for s in profiling.spans())


def test_parents_roots_and_self_time():
    with profiling.recording():
        with profiling.span("root", pairs=4):
            a = profiling.begin("child", level=1)
            time.sleep(0.002)
            g = profiling.begin("grandchild")
            time.sleep(0.002)
            profiling.end(g)
            profiling.end(a)
            with profiling.span("child"):
                time.sleep(0.002)
        with profiling.span("second"):
            pass
    root, child, grandchild, child2, second = profiling.spans()
    assert [s.parent for s in profiling.spans()] == [-1, 0, 1, 0, -1]
    assert [s.root for s in profiling.spans()] == [0, 0, 0, 0, 4]
    assert (root.pairs, root.level, child.level, child.pairs) == (4, None, 1, None)
    assert profiling.self_time(grandchild) == grandchild.end - grandchild.start
    assert profiling.self_time(child) == (child.end - child.start) - (grandchild.end - grandchild.start)
    kids = (child.end - child.start) + (child2.end - child2.start)
    assert profiling.self_time(root) == (root.end - root.start) - kids >= 0
    assert child.start >= root.start and child2.end <= root.end and grandchild.end <= child.end


def test_a_span_whose_block_raises_is_closed():
    with profiling.recording():
        with pytest.raises(ValueError):
            with profiling.span("outer"):
                profiling.begin("left open")
                raise ValueError
        with profiling.span("after"):
            pass
    outer, inner, after = profiling.spans()
    assert outer.end is not None and inner.end == outer.end
    assert after.parent == -1  # the stack unwound with the raise


def test_past_the_cap_nothing_is_appended(monkeypatch):
    monkeypatch.setattr(profiling, "CAP", 3)
    with profiling.recording():
        for _ in range(5):
            profiling.end(profiling.begin("x"))
        with profiling.span("y"):
            pass
    assert len(profiling.spans()) == 3 and profiling.dropped() == 3
    profiling.clear()
    assert not profiling.spans() and profiling.dropped() == 0


def test_stage_timer_stages_are_spans():
    timer = StageTimer()
    with profiling.recording():
        with timer.stage("filter"):
            with profiling.span("batch.plan_wait"):
                pass
    stage, wait = profiling.spans()
    assert (stage.name, wait.parent, timer.counts["filter"]) == ("filter", 0, 1)
    with timer.stage("filter"):
        pass
    assert len(profiling.spans()) == 2 and timer.counts["filter"] == 2


def _tracker_align(levels: int = 3, iterations: int = 3):
    intr, colors, depths = _sequence(2)
    builder = RangeImageBuilder(bilateral_filter=BilateralFilter(), pyramid_levels=levels)
    frames = [RgbdFrame(intr, RgbdImage(colors[i], depths[i], 0.001)) for i in range(2)]
    params = MsIcpParams.repeat(levels, IcpParams(max_iterations=iterations))
    target = builder.build(frames[0], "cpu")
    source = builder.build(frames[1], "cpu")
    pose = MultiscaleAlign(params, target).align(source)
    return pose.rotation, pose.translation


def test_tracker_spans_and_the_same_pose():
    off = _tracker_align()
    assert not profiling.spans()
    with profiling.recording():
        on = _tracker_align()
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    spans = profiling.spans()
    names = _names()
    assert names["build"] == 2 and names["build.upload"] == names["build.filter"] == names["build.pyramid"] == 2
    assert names["icp.align"] == 1 and names["icp.level"] == names["icp.level_wait"] == 3
    assert names["gn.iter"] == names["gn.step"] == names["gn.solve"] == 3 * 3
    align = next(i for i, s in enumerate(spans) if s.name == "icp.align")
    assert spans[align].parent == -1 and spans[align].pairs == 1
    levels = [i for i, s in enumerate(spans) if s.name == "icp.level"]
    assert [spans[i].level for i in levels] == [2, 1, 0] and all(spans[i].parent == align for i in levels)
    for i, s in enumerate(spans):
        assert s.end is not None
        if s.name in ("gn.iter", "icp.level_wait"):
            assert spans[s.parent].name == "icp.level"
        if s.name == "gn.iter":
            assert sorted(c.name for c in spans if c.parent == i) == ["gn.solve", "gn.step"]
            assert profiling.self_time(s) >= 0
        if s.name.startswith(("icp.", "gn.")):
            assert s.root == align
        if s.name.startswith("build."):
            assert spans[s.parent].name == "build" and s.root == s.parent


def _batch_step():
    intr, colors, depths = _sequence(4)
    params = MsIcpParams.repeat(2, IcpParams(max_iterations=2))
    traj = odometry_step(intr, 0.001, colors, depths, params, 2, BilateralFilter(), "cpu", timer=StageTimer())
    return traj.camera_to_world.rotation, traj.camera_to_world.translation


def test_batch_step_spans_and_the_same_trajectory():
    off = _batch_step()
    with profiling.recording():
        on = _batch_step()
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    spans = profiling.spans()
    names = _names()
    assert names["batch.step"] == names["batch.upload"] == names["batch.plan_wait"] == 1
    assert names["filter"] == names["pyramids"] == names["align"] == names["scan"] == 1
    assert names["icp.align"] == 1 and names["icp.level"] == 2
    assert names["gn.iter"] == names["gn.step"] == names["gn.solve"] == 2 * 2 and "icp.level_wait" not in names
    step = next(i for i, s in enumerate(spans) if s.name == "batch.step")
    assert spans[step].parent == -1 and spans[step].pairs == 3
    by_name = {s.name: s for s in spans}
    assert spans[by_name["batch.upload"].parent].name == "batch.step"
    assert spans[by_name["batch.plan_wait"].parent].name == "filter"
    assert spans[by_name["icp.align"].parent].name == "align" and by_name["icp.align"].pairs == 3
    assert all(s.root == step and s.end is not None for s in spans)


def test_spans_share_the_trace_clock(tmp_path):
    a = torch.randn(96, 96)
    with profiling.trace(str(tmp_path)):
        with profiling.span("around mm"):
            a @ a
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    mm = [e for e in events if e.get("name") == "aten::mm" and e.get("ph") == "X"]
    ours = [e for e in events if e.get("name") == "around mm"]
    assert len(mm) == 1 and len(ours) == 1
    assert ours[0]["tid"] == profiling.TRACK and ours[0]["ph"] == "X"
    assert ours[0]["ts"] <= mm[0]["ts"] and mm[0]["ts"] + mm[0]["dur"] <= ours[0]["ts"] + ours[0]["dur"]


def _span(name, start_us, length_us, parent=-1, root=0):
    s = profiling.Span(name, int(start_us * 1e3), parent, root, None, None)
    s.end = s.start + int(length_us * 1e3)
    return s


def test_the_four_readers():
    ctx = SimpleNamespace(frames_per_unit=64)
    readers = {name: _reader(name) for name in
               ("gn.iter_us.track", "gn.iter_us.batch", "icp.wait_ms.track", "batch.upload_ms")}
    assert all(read(ctx) is None for read in readers.values())
    profiling.spans().extend([
        _span("icp.align", 0, 10_000), _span("icp.level", 0, 5_000, 0),
        _span("gn.iter", 100, 2_000, 1), _span("gn.iter", 2_100, 3_000, 1), _span("icp.level_wait", 5_100, 400, 1),
        _span("icp.align", 20_000, 10_000, root=5), _span("icp.level_wait", 20_000, 200, 5, 5),
        _span("icp.align", 40_000, 1_000, 8, 8),  # under a stage: not a frame of its own
        _span("batch.step", 50_000, 9_000, root=8), _span("batch.upload", 50_000, 1_280, 8, 8),
        _span("batch.step", 60_000, 9_000, root=10), _span("batch.upload", 60_000, 1_920, 10, 10),
    ])
    assert readers["gn.iter_us.track"](ctx) == readers["gn.iter_us.batch"](ctx) == 2_500.0
    assert readers["icp.wait_ms.track"](ctx) == pytest.approx(0.3)  # 600 us over two frames
    assert readers["batch.upload_ms"](ctx) == pytest.approx(3.2 / 128)
    open_span = profiling.Span("gn.iter", 0, -1, 0, None, None)  # still open: not read
    profiling.spans().append(open_span)
    assert readers["gn.iter_us.track"](ctx) == 2_500.0
    profiling.clear()
    assert all(read(ctx) is None for read in readers.values())


def test_a_reader_on_a_program_without_spans(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    ctx = SimpleNamespace(frames_per_unit=64)
    for name in ("gn.iter_us.track", "gn.iter_us.batch", "icp.wait_ms.track", "batch.upload_ms"):
        assert _reader(name)(ctx) is None


def test_the_spans_tool_names_each_gap_by_the_innermost_span():
    from align3d_torch.tools import spans as tool

    recorded = [_span("icp.align", 0, 100), _span("gn.iter", 10, 50, 0), _span("gn.step", 10, 20, 1),
                _span("batch.step", 200, 50, root=3)]
    assert tool.innermost_segments(recorded, lambda i: i < 3) == [
        (0, 10_000, 0), (10_000, 30_000, 2), (30_000, 60_000, 1), (60_000, 100_000, 0)]
    # Device busy 0-5, 12-15 (gap ends in gn.step), 40-45 and 41-47 (in gn.iter's self time), 90-120 (clipped).
    intervals = [(t0 * 1e3, t1 * 1e3) for t0, t1 in ((0, 5), (12, 15), (40, 45), (41, 47), (90, 120), (210, 220))]
    out = tool.idle_by_span(intervals, recorded, ("icp.align",))
    assert out["window_s"] == pytest.approx(100e-6) and out["busy_s"] == pytest.approx(25e-6)
    assert out["idle_s"] == pytest.approx({"gn.step": 7e-6, "gn.iter": 25e-6, "icp.align": 43e-6})
    batch = tool.idle_by_span(intervals, recorded, ("batch.step",))
    assert batch["busy_s"] == pytest.approx(10e-6) and batch["idle_s"] == pytest.approx({"batch.step": 10e-6})


def test_the_spans_tool_finds_launch_calls_inside_gn_step():
    from align3d_torch.tools import spans as tool

    recorded = [_span("gn.iter", 0, 100), _span("gn.step", 10, 20, 0), _span("gn.step", 50, 20, 0)]
    base = 5_000
    events = [{"ph": "X", "cat": "kernel", "name": "void icp_step_kernel<1>", "ts": 31.0, "dur": 5.0,
               "args": {"correlation": 7}},
              {"ph": "X", "cat": "kernel", "name": "void icp_banded_kernel<true>", "ts": 81.0, "dur": 5.0,
               "args": {"correlation": 8}},
              {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 90.0, "dur": 1.0, "args": {"correlation": 9}},
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12.0 - base / 1e3, "dur": 3.0,
               "args": {"correlation": 7}},
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 40.0 - base / 1e3, "dur": 3.0,
               "args": {"correlation": 8}}]
    intervals, kernels = tool.chrome_device(events, base)
    assert len(intervals) == 3 and kernels[7].startswith("void icp_step")
    found = tool.launches_in_steps(events, base, kernels, recorded)
    assert found["icp_step_kernel"] == {"kernels": 1, "launch_calls": 1, "inside_gn_step": 1}
    assert found["icp_banded_kernel"] == {"kernels": 1, "launch_calls": 1, "inside_gn_step": 0}
    assert found["gn_step_spans"] == 2


def test_the_spans_tool_reads_replays_where_no_gn_iter_is():
    """The GN loop's host cost from ``gn.replay`` spans (a level's CUDA
    graph) by level, a replay and an iteration, with the hit share; the
    eager loop's ``gn.iter`` where it ran; one block's parents index it."""
    from align3d_torch.tools import spans as tool

    def level(name, start_us, length_us, lv, parent=-1):
        s = _span(name, start_us, length_us, parent)
        s.level = lv
        return s

    graphed = [_span("icp.align", 0, 100), level("icp.level", 0, 40, 2, 0), _span("gn.replay", 5, 30, 1),
               level("icp.level", 40, 60, 0, 0), _span("gn.replay", 45, 40, 3)]
    again = [level("icp.level", 0, 50, 0), _span("gn.replay", 0, 20, 0)]
    params = MsIcpParams.default()
    out = tool.gn_cost([graphed, again], params, {"captures": 1, "replays": 3})
    assert "gn_iter_us" not in out and out["graph_hit_share"] == 0.75
    assert out["gn_replay_us"] == {0: {"replays": 2, "mean": 30.0, "per_iteration": 1.5},
                                   2: {"replays": 1, "mean": 30.0, "per_iteration": 1.0}}
    eager = [_span("icp.level", 0, 100), _span("gn.iter", 0, 10, 0), _span("gn.iter", 10, 30, 0)]
    out = tool.gn_cost([eager], params, {"captures": 0, "replays": 0})
    assert out == {"gn_iter_us": {"mean": 20.0, "median": 20.0}, "graph_hit_share": None}


def test_the_spans_tool_counts_graph_launches():
    """A graph's kernels share its launch's correlation id: each counts as a
    kernel, the graph launch as none of their launch calls."""
    from align3d_torch.tools import spans as tool

    events = [{"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": 5.0, "args": {"correlation": 7}}
              for name, ts in (("void icp_step_kernel<1>", 31.0), ("gn_update_kernel", 37.0),
                               ("void icp_step_kernel<1>", 43.0), ("CatArrayBatchedCopy", 49.0))]
    events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 12.0, "dur": 3.0,
                   "args": {"correlation": 7}})
    intervals, kernels = tool.chrome_device(events, 0)
    found = tool.launches_in_steps(events, 0, kernels, [])
    assert len(intervals) == 4 and found["graph_launches"] == 1 and found["gn_step_spans"] == 0
    assert found["icp_step_kernel"] == {"kernels": 2, "launch_calls": 0, "inside_gn_step": 0}
