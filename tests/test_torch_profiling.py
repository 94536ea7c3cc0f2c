"""``align3d_torch/utils/profiling.py`` (port of ``align3d_tpu/utils/profiling.py``):
the stage timer's totals, counts and report, which it shares with the JAX
package's, and the ``torch.profiler`` trace."""

import json
import time

import jax.numpy as jnp
import torch
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_tpu.utils.profiling import StageTimer as JaxStageTimer

from align3d_torch.utils import StageTimer, trace


def test_stage_timer_accumulates_and_reports_as_jax():
    ours, ref = StageTimer(), JaxStageTimer()
    for timer, force in ((ours, torch.ones(3)), (ref, jnp.ones(3))):
        for _ in range(2):
            with timer.stage("slow", force=force):
                time.sleep(0.02)
        with timer.stage("fast"):
            pass
    assert dict(ours.counts) == dict(ref.counts) == {"slow": 2, "fast": 1}
    assert ours.totals["slow"] >= 0.04 and ours.totals["fast"] < ours.totals["slow"]
    lines = ours.report().splitlines()
    assert [line.split(":")[0] for line in lines] == [line.split(":")[0] for line in ref.report().splitlines()]
    assert lines[0].startswith("slow: ") and "2 calls" in lines[0]


def test_stage_timer_counts_a_stage_that_raises():
    timer = StageTimer()
    try:
        with timer.stage("boom"):
            raise ValueError
    except ValueError:
        pass
    assert timer.counts["boom"] == 1


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
