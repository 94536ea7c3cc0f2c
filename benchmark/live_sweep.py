"""The capacity of the live server on the card, by a sweep of the stream
count at the traffic's rate:

    python3 -m benchmark.live_sweep --streams 4 8 16 24 32 --seconds 10

For each S, in one process: the fleet cell's driver (``drivers/live.py``)
with S streams, set-up, a window of ``--seconds`` of sensor time, and one
JSON line (frames arrived, tracked and dropped, latency p50 / p90 / max,
pairs a step, how late the clock pushed). The capacity C is the largest
aggregate rate, S x the rate, that the server sustains: no frame dropped
and the p90 latency under one frame period. The fleet cell's S is the
multiple of 4 nearest 0.5 C / rate. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", default="live-exact-640x480.fleet-30hz")
    parser.add_argument("--streams", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--seed", type=int, default=2**31 + 4242)
    args = parser.parse_args(argv)

    import torch

    from benchmark import drivers, run, traffic

    if not torch.cuda.is_available():
        print("the sweep needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    from align3d_torch import _kernels

    _kernels.lib()
    _, entry, config, cell = run.load_spec(args.workload)
    for streams in args.streams:
        mix = traffic.Traffic(entry["traffic"])
        mix.spec["streams"] = streams
        driver = drivers.load(config["driver"]).Driver(config, mix, args.seed + streams, device, cell)
        try:
            driver.setup()
            driver.window(args.seconds, None, drivers.Reservoir(0, traffic.rng(args.seed, 1)))
            summary = driver.summary
        finally:
            driver.close()
        ok = summary["dropped"] == 0 and summary["p90_ms"] < 1e3 / summary["rate_hz"]
        print(json.dumps({**summary, "aggregate_hz": streams * summary["rate_hz"], "sustained": ok,
                          "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}), flush=True)
        driver.release()
        del driver
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
