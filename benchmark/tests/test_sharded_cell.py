"""CPU tests of the 4-card cell ``batch64-v4-640x480-dp4.sample1-walk``
(``python -m pytest benchmark/tests -q``): its driver (``drivers/sharded.py``)
runs four ranks here, each a process on the CPU over gloo, at the other
cells' test size (a stride of 8, 80 x 60 frames) with 2 frames a rank. The
port's CPU path runs each kernel's plain twin, so the reference agrees with
it bitwise; the faults must turn ``correct`` false or end the run."""

from __future__ import annotations

import io
import json
import math
import os
import subprocess
import sys
import time
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import torch

from benchmark import check, drivers, run, traffic
from benchmark.drivers import sharded

ROOT = Path(__file__).resolve().parents[2]
CELL = "batch64-v4-640x480-dp4.sample1-walk"
SMALL = {"stride": 8, "image": {"width": 80, "height": 60}, "frames_per_step": 8, "pairs_per_step": 7}
SEED = 2**31 + 7


def _run(seconds: float = 1.0) -> tuple[int, dict, str]:
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.run(["--workload", CELL, "--seed", str(SEED), "--seconds", str(seconds), "--trace", "0"],
                     device="cpu", overrides=SMALL)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else {}), out.getvalue() + err.getvalue()


def test_sharded_cell_is_correct_on_the_cpu():
    """Four ranks, every pair (the halo pairs too) bitwise the reference, the
    trajectory bitwise on every rank and bitwise the unsharded step."""
    rc, line, text = _run()
    assert rc == 0, text
    assert line["correct"] is True, text
    for name in check.NAMES[:-1]:
        assert line["checks"][name]["value"] == 0.0, name
    assert line["checks"]["traj_maxabs"]["value"] < 1e-6
    assert line["attempted"] % 7 == 0 and line["attempted"] >= 7
    assert line["device"]["count"] == 4
    assert set(line["metrics"]) == {"batch_ms_per_frame", "setup_s"}
    assert "on 4 ranks" in text and "sharded:" not in text


def test_a_nudged_pose_on_rank_2_is_not_correct(monkeypatch):
    """Rank 2's halo pair moved by 1 mm: the pair fails its limit and rank
    0's trajectory is no longer the unsharded step's."""
    from benchmark.tests import _sharded_faults

    monkeypatch.setattr(sharded, "_worker", _sharded_faults.nudged_on_rank_2)
    rc, line, text = _run()
    assert rc == 0, text
    assert line["correct"] is False
    assert line["failed"] >= 1
    assert line["checks"]["pose_trans_m"]["value"] > line["checks"]["pose_trans_m"]["limit"]
    assert math.isinf(line["checks"]["traj_maxabs"]["value"])
    assert "not the unsharded step's" in text


def _faulty_run(fault: str, bound_s: int) -> tuple[subprocess.CompletedProcess, float]:
    """The cell in a new process (a dead worker ends it with ``os._exit``),
    rank 2 broken by ``fault``, every wait of the deployment bounded by
    ``bound_s``; (the process, its seconds)."""
    code = ("import sys; from benchmark import run; from benchmark.drivers import sharded; "
            f"from benchmark.tests import _sharded_faults as f; sharded._worker = f.{fault}; "
            f"sharded.BOUND_S = {bound_s}; "
            f"sys.exit(run.run(['--workload', {CELL!r}, '--seed', '{SEED}', '--seconds', '600', '--trace', '0'], "
            f"device='cpu', overrides={SMALL!r}))")
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, "PYTHONPATH": str(ROOT)}
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    return out, time.monotonic() - t0


def test_a_killed_worker_ends_the_run():
    """Rank 2 killed in the window: the run exits non-zero at once, not when
    a collective's bound runs out."""
    out, took = _faulty_run("killed_mid_window", sharded.BOUND_S)
    assert out.returncode == 1, out.stderr
    assert "rank 2 exited with code -9 before it was told to stop" in out.stderr
    assert took < sharded.BOUND_S, took  # set-up and six steps; a bound run out would take longer


def test_a_stuck_worker_ends_the_run_within_the_bound():
    """Rank 2 stops making progress in the window: rank 0's collective fails
    at the bound (here 20 s), and the run exits non-zero with every worker
    gone instead of hanging."""
    out, took = _faulty_run("stuck_mid_window", 20)
    assert out.returncode != 0, out.stderr
    assert took < 20 + 90, took  # set-up, six steps, the bound, the workers' stop


def test_the_control_fails():
    """The reference in bf16 in the program's place fails the cell's limits."""
    bench, entry, config, cell = run.load_spec(CELL, SMALL)
    driver = sharded.Driver(config, traffic.Traffic(entry["traffic"]), 5, torch.device("cpu"), cell)
    try:
        driver.setup()
        reservoir = drivers.Reservoir(1, traffic.rng(5, 1))
        driver.window(0.5, None, reservoir)
        outputs = driver.program_outputs(reservoir.items)
        chain = driver.release()
        numbers, failed, error = run.judge_sample(driver, outputs, chain, cell["limits"], control=True)
    finally:
        driver.close()
    assert error is None
    ok, checks = check.judge(numbers.values, cell["limits"])
    assert not ok and failed == len(outputs) == 1
    over = [n for n, c in checks.items() if c["value"] > c["limit"]]
    assert "points_maxabs_m" in over and "traj_maxabs" in over
