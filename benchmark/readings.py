"""The readings that a cell's limits are set from, on the card:

    python3 -m benchmark.readings --workload <cell> --seeds 12 --control-seeds 3 --seconds 5

For each of ``--seeds`` seeds, in one process: set-up, a short window at the
cell's own load (the run's driver, sample size and sizes), then the compared
numbers of the program against the reference (the lower readings). For the
first ``--control-seeds`` of them also the control's numbers: the reference
computed in bf16 (its float32 stages rounded, the solve in float32) put in
the program's place (the upper readings). One JSON line per reading, then
the largest program reading and the smallest control reading of each
number. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from benchmark import run as harness


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--seed-base", type=int, default=2**31 + 12345)
    args = parser.parse_args(argv)

    import torch

    from benchmark import check, drivers, traffic

    if not torch.cuda.is_available():
        print("readings need a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    from align3d_torch import _kernels

    _kernels.lib()
    _, entry, config, cell = harness.load_spec(args.workload)
    lower = {name: 0.0 for name in check.NAMES}
    upper = {name: float("inf") for name in check.NAMES}
    for i in range(args.seeds):
        seed = args.seed_base + 1_000_003 * i
        driver = drivers.load(config["driver"]).Driver(config, traffic.Traffic(entry["traffic"]), seed, device, cell)
        driver.setup()
        reservoir = drivers.Reservoir(int(cell["sample"]), traffic.rng(seed, 1))
        result = driver.window(args.seconds, None, reservoir)
        outputs = driver.program_outputs(reservoir.items)
        reservoir.items = []
        chain = driver.release()
        gc.collect()
        torch.cuda.empty_cache()
        kinds = [("program", False)] + ([("control", True)] if i < args.control_seeds else [])
        for kind, control in kinds:
            pairs, t0 = [], time.perf_counter()
            numbers, failed, error = harness.judge_sample(driver, outputs, chain, cell["limits"], control, pairs)
            torch.cuda.synchronize()
            worst = sorted(pairs, key=lambda p: -p[2])[:3]
            print(json.dumps({"seed": seed, "kind": kind, "units": result["units"], "compared": len(outputs),
                              "numbers": numbers.values, "failed": failed, "error": error,
                              "check_s": time.perf_counter() - t0, "worst_pairs": worst}), flush=True)
            for name, value in numbers.values.items():
                if control:
                    upper[name] = min(upper[name], value)
                else:
                    lower[name] = max(lower[name], value)
        del driver, outputs, chain
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
