"""CPU tests of the benchmark's harness (``python -m pytest benchmark/tests -q``).

The cells run here at a stride of 8 (80 x 60 frames, camera scaled), on the
port's CPU path, which runs each kernel's plain twin: the harness's flow,
the traffic, the reference's agreement with the port and the faults that
must turn ``correct`` false. Speed is measured on the card only.
"""

from __future__ import annotations

import io
import json
import math
import os
import shutil
import subprocess
import sys
import types
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check, roofline, run, trace, traffic
from benchmark.drivers import Reservoir

ROOT = Path(__file__).resolve().parents[2]
TRACKER = "tracker-exact-640x480.sample1-walk"
BATCH = "batch64-v4-640x480.sample1-walk"
MIXED = "batch64-v4-640x480.mixed-depth"
SMALL = {"stride": 8, "image": {"width": 80, "height": 60}, "pairs_per_step": 6}


def _run(workload: str, seed: int = 2**31 + 7, seconds: float = 1.0, overrides=None) -> tuple[int, dict, str]:
    """One CPU run of a cell at the small size: (exit code, result line, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    torch.set_num_threads(1)
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.run(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"],
                     device="cpu", overrides={**SMALL, **(overrides or {})})
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else {}), err.getvalue()


def test_walk_is_deterministic_and_adjacent():
    t = traffic.Traffic("sample1-walk")
    lengths = {"sample1": 31}
    for seed in (0, 1, 2**31 + 3, 4_000_000_007, -5):
        a = t.stream(seed, lengths)
        b = t.stream(seed, lengths)
        frames = [next(a) for _ in range(500)]
        assert frames == [next(b) for _ in range(500)]
        for (fa, ia), (fb, ib) in zip(frames[:-1], frames[1:]):
            assert fa == fb == "sample1" and abs(ia - ib) == 1
        assert {i for _, i in frames} == set(range(31))  # the walk reaches both ends
    starts = {next(t.stream(seed, lengths)) for seed in range(40)}
    assert len(starts) > 10  # the seed picks the start
    windows = t.windows(11, lengths, 65)
    assert len(windows) == 4 and all(len(w) == 65 for w in windows)
    assert windows == t.windows(11, lengths, 65)


def test_mixed_depth_alternates_fixtures_and_keeps_pairs_adjacent():
    t = traffic.Traffic("mixed-depth")
    lengths = {"sample1": 31, "sample2": 15}
    windows = t.windows(2**31 + 9, lengths, 65)
    assert windows == t.windows(2**31 + 9, lengths, 65)
    assert [{f for f, _ in w} for w in windows] == [{"sample1"}, {"sample2"}] * 2
    for window in windows:
        assert all(a[0] == b[0] and abs(a[1] - b[1]) == 1 for a, b in zip(window[:-1], window[1:]))
    with pytest.raises(ValueError):
        next(t.stream(1, lengths))


def test_byte_counts_equal_a_hand_count_at_640x480():
    h, w = 480, 640
    # K1: mask bytes, 41 B a valid pixel, the bordered map, the pose and the two blocks.
    assert roofline.icp_step_bytes(1, h, w, 250_000) == 307_200 + 250_000 * 41 + 482 * 642 * 4 + 48 + 512
    # K8: 30 chunks x 5 groups; source 2 x 80 x 128 float32 a chunk, target 5 int32 channels x 480 x 128 a group.
    assert roofline.banded_step_bytes(1, h, w) == 2_457_600 + 6_144_000 + 30 * 11 * 4 + 48 + 512
    assert roofline.banded_step_bytes(1, h, w, 7) - roofline.banded_step_bytes(1, h, w) == 8_601_600 - 6_144_000
    assert roofline.centroids_bytes(1, h, w) == 1_228_800 + 3_600
    assert roofline.predict_bytes(1, h, w) == 48 + 30 * 5 * 24 + 30 * 11 * 4
    assert roofline.banded_step_flops(64, h, w) == 64 * 307_200 * 406
    levels = [{"engine": "pallas_v4", "iterations": it} for it in (20, 20, 30)]
    nbytes, flops = roofline.align_work(levels, [(480, 640), (240, 320), (120, 160)], 64, [0, 0, 0])
    by_hand = sum(roofline.centroids_bytes(64, a, b) + it * (roofline.banded_step_bytes(64, a, b)
                                                             + roofline.predict_bytes(64, a, b))
                  for it, (a, b) in zip((20, 20, 30), [(480, 640), (240, 320), (120, 160)]))
    assert nbytes == by_hand
    assert roofline.least_seconds(nbytes, flops) == max(nbytes / 3.35e12, flops / 67e12)


def test_whole_name_check_of_loaded_modules(monkeypatch):
    fake = {"align3d_torch": None, "align3d_torch.ops": None, "align3d_tpu_notes": None, "jaxtyping": None}
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {**fake, "jax.numpy": None, "align3d_tpu.ops": None})
    assert run.forbidden_modules() == ["align3d_tpu", "jax"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; from benchmark import run; from benchmark.drivers import tracker, batch; "
            "import benchmark.readings, align3d_torch, align3d_torch.parallel.batch; "
            "print(run.forbidden_modules())")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_fails_loudly():
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", TRACKER, "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_only_the_benchmark_files_is_not_enough(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", TRACKER, "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_added_cell_config_mix_and_metric_are_found(tmp_path):
    """A new cell, configuration, traffic mix and per-layer metric, each
    added as files (and entries in BENCHMARK.json), with no edit to a file
    the benchmark has."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "benchmark"
    config = json.loads((b / "configs" / "tracker-exact-640x480.json").read_text())
    config.update(name="tracker-v4-640x480", icp_preset="default_tpu", icp_engine="pallas_v4")
    for level in config["levels"]:
        level.update(engine="pallas_v4", band_radius=2 if level["level"] == 2 else 1)
    (b / "configs" / "tracker-v4-640x480.json").write_text(json.dumps(config))
    mix = json.loads((b / "traffic" / "sample1-walk.json").read_text())
    mix["reverse_probability"] = 0.3
    (b / "traffic" / "sample1-twitchy.json").write_text(json.dumps(mix))
    cell = json.loads((b / "cells" / f"{TRACKER}.json").read_text())
    (b / "cells" / "tracker-v4-640x480.sample1-twitchy.json").write_text(json.dumps(cell))
    (b / "metrics" / "track.accumulate_ms.py").write_text(
        "def read(ctx):\n    s = ctx.spans.get('accumulate')\n    return sum(s) / len(s) * 1e3 if s else None\n")
    bench["configs"].append({"name": "tracker-v4-640x480", "source": "s", "file": "benchmark/configs/tracker-v4-640x480.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": "tracker-v4-640x480.sample1-twitchy", "config": "tracker-v4-640x480",
                               "traffic": "sample1-twitchy", "chips": 1, "why": "w"})
    bench["end_to_end"][0]["workloads"].append("tracker-v4-640x480.sample1-twitchy")
    bench["per_layer"].append({"name": "track.accumulate_ms", "unit": "ms/frame", "better": "lower",
                               "source": "host_clock", "layer": "image ICP loop", "moves": "track_ms_per_frame"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, types; from benchmark import run, traffic; from benchmark.drivers import load, icp_params;"
            "bench, entry, config, cell = run.load_spec('tracker-v4-640x480.sample1-twitchy');"
            "p = icp_params(config); t = traffic.Traffic(entry['traffic']);"
            "ctx = types.SimpleNamespace(spans={'accumulate': [0.001, 0.003]}, trace=None, least_align_s=None,"
            " frames_per_unit=1);"
            "m = run.per_layer_metrics(bench, 'tracker-v4-640x480.sample1-twitchy', ctx);"
            "print(json.dumps([config['name'], [q.engine for q in p], t.spec['reverse_probability'],"
            " load(config['driver']).UNIT, m]))")
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, "PYTHONPATH": f"{tmp_path}{os.pathsep}{ROOT}"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    name, engines, p, unit, metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert name == "tracker-v4-640x480" and engines == ["pallas_v4"] * 3 and p == 0.3 and unit == "frame"
    assert math.isclose(metrics["track.accumulate_ms"]["value"], 2.0)


def test_reservoir_is_seeded_and_uniform():
    kept = []
    for seed in range(400):
        r = Reservoir(2, traffic.rng(seed, 1))
        for n in range(10):
            if r.offer():
                r.put(n)
        kept += r.items
    counts = np.bincount(kept, minlength=10)
    assert counts.sum() == 800 and counts.min() > 40  # each unit kept ~80 times of 400
    a, b = Reservoir(3, traffic.rng(9, 1)), Reservoir(3, traffic.rng(9, 1))
    assert [a.offer() for _ in range(50)] == [b.offer() for _ in range(50)]


def test_trace_reading_labels_activities_by_span_starts():
    bounds = [(100, "build"), (1000, "align"), (5000, "end")]
    acts = [(50, 60, "early"), (110, 200, "copy"), (150, 300, "bilateral_splat"), (1010, 2000, "icp_step_kernel"),
            (2000, 2600, "icp_step_kernel"), (4000, 4100, "solve")]
    r = trace.read_activities(acts, bounds, 1e-5, {})
    assert math.isclose(r["busy_s"], (10 + 190 + 1590 + 100) / 1e9)
    assert math.isclose(r["busy_by_label"]["build"], 190e-9) and math.isclose(r["busy_by_label"]["align"], 1690e-9)
    assert math.isclose(r["idle_by_label"]["align"], (710 + 1400) / 1e9)
    assert r["outside"] == 1 and r["busy_by_label"]["outside"] == 10e-9
    assert r["launches_seen"]["K1"] == 2 and r["launches_seen"]["K2"] == 1
    assert r["idle_gaps"][0] == ["host in align", (710 + 1400) / 1e9]


@pytest.mark.parametrize("workload", [TRACKER, BATCH, MIXED])
def test_reference_agrees_with_the_port_on_the_cpu(workload):
    """On the CPU the port runs its kernels' plain twins; the reference,
    written apart, gives the same bits (the card's limits allow for K1 and
    K8's own order of sums)."""
    rc, line, err = _run(workload)
    assert rc == 0, err
    assert line["correct"] is True, err
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    for name in check.NAMES[:-1]:
        assert line["checks"][name]["value"] == 0.0, name
    assert line["checks"]["traj_maxabs"]["value"] < 1e-6
    assert err.strip().splitlines()[-len(check.NAMES):] == [
        f"check {n}: {line['checks'][n]['value']!r} limit {line['checks'][n]['limit']!r}" for n in check.NAMES]
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    assert set(line["metrics"]) == ({"track_ms_per_frame", "track_p90_ms", "setup_s"} if workload == TRACKER
                                    else {"batch_ms_per_frame", "setup_s"})


def _fault_unchanged(monkeypatch):
    from align3d_torch.icp import image_icp

    def loop(step, rot, trans, params):
        return rot, trans, torch.zeros(rot.shape[:1])

    monkeypatch.setattr(image_icp, "_gn_loop", loop)


def _fault_answer_altered(monkeypatch):
    from align3d_torch.icp import image_icp

    real = image_icp._gn_loop

    def loop(step, rot, trans, params):
        r, t, res = real(step, rot, trans, params)
        return r, t + torch.tensor([1e-3, 0.0, 0.0]), res

    monkeypatch.setattr(image_icp, "_gn_loop", loop)


def _fault_half_batch(monkeypatch):
    from align3d_torch.parallel import batch as pb

    real = pb.multiscale_align_batched

    def align(targets, sources, params, initial=None):
        half = [lv.frames(slice(0, max(1, lv.points.shape[0] // 2))) for lv in targets]
        pose = real(half, [lv.frames(slice(0, max(1, lv.points.shape[0] // 2))) for lv in sources], params)
        n = targets[0].points.shape[0]
        idx = torch.arange(n) % pose.rotation.shape[0]  # the left-out pairs take the aligned ones' poses
        return type(pose)(pose.rotation[idx], pose.translation[idx])

    monkeypatch.setattr(pb, "multiscale_align_batched", align)


def _fault_depth_altered(monkeypatch):
    from align3d_torch.ops import bilateral

    real = bilateral.BilateralGrid.normalize_slice

    def normalize_slice(self, image):
        out = real(self, image).clone()
        out.view(-1)[out.numel() // 2] += 1
        return out

    monkeypatch.setattr(bilateral.BilateralGrid, "normalize_slice", normalize_slice)


@pytest.mark.parametrize("workload,fault", [
    (TRACKER, _fault_unchanged), (TRACKER, _fault_answer_altered), (TRACKER, _fault_depth_altered),
    (BATCH, _fault_unchanged), (BATCH, _fault_answer_altered), (BATCH, _fault_half_batch),
    (BATCH, _fault_depth_altered),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    rc, line, err = _run(workload)
    assert rc == 0, err
    assert line["correct"] is False
    assert line["failed"] >= 1 or line["checks"]["traj_maxabs"]["value"] > line["checks"]["traj_maxabs"]["limit"]


@pytest.mark.parametrize("workload", [TRACKER, BATCH])
def test_the_control_fails(workload):
    """The reference in bf16 in the program's place fails the cell's limits
    (on the card the same control sets the upper readings)."""
    from benchmark import drivers
    from benchmark.drivers import Reservoir as R

    bench, entry, config, cell = run.load_spec(workload, SMALL)
    torch.set_num_threads(1)
    driver = drivers.load(config["driver"]).Driver(config, traffic.Traffic(entry["traffic"]), 5, torch.device("cpu"),
                                                   cell)
    driver.setup()
    reservoir = R(1, traffic.rng(5, 1))
    driver.window(0.5, None, reservoir)
    outputs = driver.program_outputs(reservoir.items)
    chain = driver.release()
    numbers, failed, error = run.judge_sample(driver, outputs, chain, cell["limits"], control=True)
    assert error is None
    ok, checks = check.judge(numbers.values, cell["limits"])
    assert not ok and failed == len(outputs)
    over = [n for n, c in checks.items() if c["value"] > c["limit"]]
    assert "points_maxabs_m" in over and "traj_maxabs" in over


@pytest.mark.cuda
def test_a_traced_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", TRACKER, "--seed", "3",
                          "--seconds", "4", "--trace", "1"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["busy_s"] > 0 and set(line["metrics"]) >= {"idle_share.track", "gn_roofline.track"}
