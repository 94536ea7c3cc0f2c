"""CPU tests of the live cells ``live-exact-640x480.sensor-30hz`` and
``live-exact-640x480.fleet-30hz`` (``python -m pytest benchmark/tests -q``):
their driver (``drivers/live.py``) at the other cells' test size (a stride
of 8, 80 x 60 frames). The CPU cannot keep up with 30 Hz, so most frames
are dropped here; the checks are those of the card."""

from __future__ import annotations

import io
import json
from contextlib import redirect_stderr, redirect_stdout

import torch

from benchmark import check, drivers, run, traffic
from benchmark.drivers import live as live_driver

SENSOR = "live-exact-640x480.sensor-30hz"
FLEET = "live-exact-640x480.fleet-30hz"
SMALL = {"stride": 8, "image": {"width": 80, "height": 60}}
SEED = 2**31 + 11


def _run(workload: str, seconds: float = 1.0) -> tuple[int, dict, str]:
    out, err = io.StringIO(), io.StringIO()
    torch.set_num_threads(1)
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.run(["--workload", workload, "--seed", str(SEED), "--seconds", str(seconds), "--trace", "0"],
                     device="cpu", overrides=SMALL)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else {}), out.getvalue() + err.getvalue()


def test_sensor_cell_is_correct_on_the_cpu():
    """Set-up, a short window, the sampled pairs against the reference: the
    filter and pyramids bitwise, the poses within the cell's limits; the
    cell reports the p90 latency and no ms a frame."""
    rc, line, text = _run(SENSOR)
    assert rc == 0, text
    assert line["correct"] is True, text
    for name in ("depth_maxabs", "points_maxabs_m", "normals_maxabs", "intensity_maxabs"):
        assert line["checks"][name]["value"] == 0.0, name
    assert line["attempted"] == 30  # 1 s of one 30-Hz sensor
    assert set(line["metrics"]) == {"track_p90_ms", "setup_s"}
    assert "1 streams at 30 Hz: frames 30" in text


def test_fleet_cell_is_correct_on_the_cpu():
    rc, line, text = _run(FLEET, 0.5)
    assert rc == 0, text
    assert line["correct"] is True, text
    assert line["attempted"] == 12 * 15  # 0.5 s of twelve 30-Hz sensors
    assert set(line["metrics"]) == {"track_p90_ms", "setup_s"}


def test_the_control_fails():
    """The reference in bf16 in the program's place fails the cell's limits."""
    bench, entry, config, cell = run.load_spec(SENSOR, SMALL)
    torch.set_num_threads(1)
    driver = live_driver.Driver(config, traffic.Traffic(entry["traffic"]), 5, torch.device("cpu"), cell)
    try:
        driver.setup()
        reservoir = drivers.Reservoir(2, traffic.rng(5, 1))
        driver.window(0.5, None, reservoir)
        outputs = driver.program_outputs(reservoir.items)
        chain = driver.release()
        numbers, failed, error = run.judge_sample(driver, outputs, chain, cell["limits"], control=True)
    finally:
        driver.close()
    assert error is None
    ok, checks = check.judge(numbers.values, cell["limits"])
    assert not ok and failed == len(outputs) >= 1
    over = [n for n, c in checks.items() if c["value"] > c["limit"]]
    assert "points_maxabs_m" in over and "traj_maxabs" in over
