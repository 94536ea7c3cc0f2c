"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. The cell (``BENCHMARK.json``'s ``workloads``) names a
configuration (``configs/<config>.json``: its driver, sizes and ICP
levels) and a traffic mix (``traffic/<mix>.json``); ``cells/<cell>.json``
holds the size of the correctness sample, the profiled slice and the
limits of the compared numbers. A per-layer metric is read by
``metrics/<metric>.py``. A cell, a configuration, a mix or a metric is
added by adding its files.

The run: set-up (build or load the kernel library, decode the fixtures,
warm up the cell's shapes), the measured window, then, with the window
closed and the program's state freed, the seeded sample of what the timed
path produced held to the plain reference (``reference/``). The last line
of standard output is one JSON object; the numbers compared, each beside
its limit, are the last lines of standard error and the result's last key.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "align3d_tpu")


def process_age() -> float:
    """Seconds since this process started (from /proc), or since this module
    was imported where /proc is not there."""
    try:
        start_ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX package's."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_spec(workload: str, overrides: dict | None = None) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, the workload entry, its configuration, its cell file)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[entry["config"]]["file"]).read_text())
    cell = json.loads((HERE / "cells" / f"{workload}.json").read_text())
    for key, value in (overrides or {}).items():
        target = cell if key in cell else config
        target[key] = value
    return bench, entry, config, cell


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def per_layer_metrics(bench: dict, workload: str, ctx) -> dict:
    """The per-layer metrics this cell reports, each from its reader; a
    reader that finds nothing to read gives None and the metric is left out."""
    ends = {m["name"]: m for m in bench["end_to_end"]}
    own_ends = {name for name, m in ends.items() if workload in m.get("workloads", [workload])}
    out = {}
    for m in bench["per_layer"]:
        if workload not in m.get("workloads", [workload] if m["moves"] in own_ends else []):
            continue
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge_sample(driver, outputs: list, chain, limits: dict, control: bool = False, pairs: list | None = None):
    """Hold the sampled outputs to the reference, worked out again from the
    raw frames: (the worst numbers, how many sampled units failed a limit,
    the traceback of a reference or comparison that could not finish).
    ``control``: the reference in bf16 takes the program's place. ``pairs``,
    when given, gets each compared pair's (frames, angle, distance)."""
    import torch

    from benchmark import check
    from benchmark.reference import CONTROL, FULL

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    numbers, failed, error = check.Numbers(), 0, None
    try:
        for item in outputs:
            ref = driver.reference(item["frames"], FULL)
            judged = driver.reference(item["frames"], CONTROL) if control else item
            one = check.Numbers()
            check.compare(one, judged, ref)
            if pairs is not None:
                pairs += [(item["frames"][i], item["frames"][i + 1], a, d) for i, a, d in one.pairs]
            failed += not check.judge({**one.values, "traj_maxabs": 0.0}, limits)[0]
            for name, value in one.values.items():
                numbers.worst(name, value)
            del ref, judged
        numbers.worst("traj_maxabs", driver.chain_gap(chain, outputs, CONTROL if control else FULL))
    except Exception:
        error = traceback.format_exc()
    return numbers, failed, error


def run(argv=None, device=None, overrides: dict | None = None) -> int:
    """One run; returns the exit code. ``device`` and ``overrides`` are for
    the harness's own tests on the CPU (no look for a card; smaller frames)."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    bench, entry, config, cell = load_spec(args.workload, overrides)
    # Every cache the program or PyTorch may write stays in the checkout, at fixed paths.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            print(f"{args.workload} needs {entry['chips']} CUDA card(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: not run", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    torch.set_num_threads(4)

    from benchmark import drivers, trace, traffic

    marks = [("start", process_age())]
    if on_card:
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)  # the allocator's stats exist once it has been used
        torch.cuda.reset_peak_memory_stats(device)
        from align3d_torch import _kernels

        marks.append(("cuda", process_age()))
        _kernels.lib()  # build (first run in a checkout) or load the kernel library
        marks.append(("kernels", process_age()))
    tracer = trace.Tracer(int(cell["trace_slice"])) if args.trace else None
    if tracer is not None and on_card:
        tracer.warm()
    driver = drivers.load(config["driver"]).Driver(config, traffic.Traffic(entry["traffic"]), args.seed, device, cell)
    try:
        return _measure(args, bench, entry, config, cell, driver, tracer, device, on_card, marks)
    finally:
        getattr(driver, "close", lambda: None)()


def _measure(args, bench, entry, config, cell, driver, tracer, device, on_card, marks: list) -> int:
    """Set-up, the window and the checks of one run; returns the exit code."""
    import torch

    from benchmark import check, drivers, traffic

    driver.setup()
    found = forbidden_modules()
    if found:
        print(f"loaded after set-up: {found}", file=sys.stderr)
        return 3
    reservoir = drivers.Reservoir(int(cell["sample"]), traffic.rng(args.seed, 1))
    gc.collect()
    setup_s = process_age()
    marks.append(("driver", setup_s))
    print("setup: " + ", ".join(f"{name} {t - t0:.2f} s" for (_, t0), (name, t) in zip(marks, marks[1:]))
          + f" (interpreter and imports {marks[0][1]:.2f} s; {driver.setup_note})")
    result = driver.window(args.seconds, tracer, reservoir)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    found = forbidden_modules()
    if found:
        print(f"loaded once the window closed: {found}", file=sys.stderr)
        return 3

    if getattr(driver, "note", None):
        print(f"window: {driver.note}")
    reading = tracer.read() if tracer is not None else None
    least_s = driver.slice_work(tracer.units_in_slice) if reading is not None else None
    outputs = driver.program_outputs(reservoir.items)
    reservoir.items = []
    chain = driver.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    numbers, failed, error = judge_sample(driver, outputs, chain, cell["limits"])
    ok, checks = check.judge(numbers.values, cell["limits"])
    ok = ok and error is None and bool(outputs)

    kind = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": int(entry["chips"]), "memory_peak_bytes": int(peak)}
    line = {"correct": ok, "attempted": int(result["attempted"]), "failed": int(failed)}
    if args.trace:
        ctx = types.SimpleNamespace(spans=dict(tracer.spans), frames_per_unit=getattr(driver, "pairs", 1),
                                    trace=reading, least_align_s=least_s, config=config, cell=args.workload)
        metrics = per_layer_metrics(bench, args.workload, ctx)
        if reading is not None:
            kind.update(busy_s=reading["busy_s"], window_s=reading["window_s"])
            line["breakdown"] = {"device_ops": [[n, s] for n, s in reading["device_ops"]],
                                 "idle_gaps": reading["idle_gaps"]}
            print("launches over the profiled slice: issued " + json.dumps(reading["launches_issued"])
                  + " seen " + json.dumps(reading["launches_seen"])
                  + f"; {reading['activities']} device activities, {reading['outside']} outside every span")
            print("device busy by span: " + json.dumps(reading["busy_by_label"])
                  + " idle by span: " + json.dumps(reading["idle_by_label"]))
    else:
        metrics = {name: {"value": value, "unit": unit} for name, value, unit in
                   [(m["name"], result["metrics"].get(m["name"]), m["unit"]) for m in bench["end_to_end"]
                    if m["name"] != "setup_s"] if value is not None}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    line.update(metrics=metrics, device=kind)
    if error is not None:
        print(error, file=sys.stderr)
    line["checks"] = checks
    check.print_checks(checks)
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


def main() -> int:
    try:
        return run()
    except SystemExit:
        raise
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
