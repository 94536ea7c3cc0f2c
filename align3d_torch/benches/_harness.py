"""The benches' shared harness (the port's counterpart of
``benches/_harness.py``).

The JAX harness takes a marginal time between two repetition counts inside
one jitted loop, a method the TPU's remote dispatch forced. Here each bench
calls the port's own entry point, and :func:`measure`:

* builds the CUDA kernels first (:func:`setup`) and warms up, so no build
  or first-call cost lands in a timed window;
* profiles k calls with ``tools/roofline.py::device_ms``: the device's
  **busy** ms a call (the kernels, copies and sets it saw, by
  ``per_call_ms``'s arithmetic, which does not read low when the profiler
  misses some), and the launches it saw of each of the port's kernels;
* then times R repeats (5, or 2 with ``--quick``) of k calls each (k a
  constant of each bench). Per repeat: **wall** ms a call, from one CUDA
  event pair around the k calls (where the host is the bound this includes
  the device's idle gaps: it is not device time), and **host** ms a call,
  from ``time.perf_counter`` ended by one synchronise. The launches the
  kernels' counters issued over the last repeat (reset just before, read
  just after) stand beside the launches the profiler saw over its k calls.

On the CPU (``--device cpu``) wall and host are the same clock, and the
device numbers and the card are null. :func:`record` prints the JSON line:
``metric``, ``value`` (median wall, in the bench's unit), ``unit``,
``vs_baseline`` as the JAX benches print them, then ``runs`` (every
repeat's wall), ``min``, ``max``, ``host_ms`` (median; ``host_runs``
every repeat), ``device_busy_ms``, ``busy_share`` (busy over median wall),
``launches``, ``profiler_launches``, ``calls`` (k), ``device`` and ``card``
(``nvidia-smi``'s name and power limit). Everything else goes to stderr.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

import torch

from align3d_torch.ops import bilateral, icp_fused, icp_pallas_v3, icp_pallas_v4, mesh, nn_banded, pyramid
from align3d_torch.viz import sphere

#: The port's kernels on the benches' paths: the symbol the profiler shows
#: and the counters their wrappers add one to a launch.
KERNELS = {
    "K1": ("icp_step_kernel", [(icp_fused, "LAUNCHES")]),
    "K2": ("bilateral_splat", [(bilateral, "SPLAT_LAUNCHES")]),
    "K3": ("bilateral_slice", [(bilateral, "NORMALIZE_SLICE_LAUNCHES"), (bilateral, "SLICE_LAUNCHES")]),
    "K4": ("nn_banded", [(nn_banded, "LAUNCHES")]),
    "K5": ("mesh_normals", [(mesh, "LAUNCHES")]),
    "K6": ("column_mean", [(sphere, "MEAN_LAUNCHES")]),
    "K7": ("icp_banded_kernel<false>", [(icp_pallas_v3, "LAUNCHES")]),
    "K8": ("icp_banded_kernel<true>", [(icp_pallas_v4, "LAUNCHES")]),
    "K9": ("source_centroids_kernel", [(icp_pallas_v3, "CENTROIDS_LAUNCHES")]),
    "K10": ("predict_bases_kernel", [(icp_pallas_v3, "PREDICT_LAUNCHES")]),
    "K12": ("pyramid_base_kernel", [(pyramid, "BASE_LAUNCHES")]),
    "K13": ("pyramid_down_kernel", [(pyramid, "DOWN_LAUNCHES")]),
}
RUNS, WARMUP = 5, 2
TO_UNIT = {"ms": 1.0, "us": 1e3, "s": 1e-3}  # from ms
QUICK_RUNS, QUICK_WARMUP = 2, 1


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def parser(description: str, calls: int) -> argparse.ArgumentParser:
    """The flags every bench takes; a bench adds its sizes."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--quick", action="store_true",
                    help=f"{QUICK_RUNS} timed repeats (not {RUNS}), {QUICK_WARMUP} warm-up call (not {WARMUP})")
    ap.set_defaults(calls=calls)  # k, the calls a repeat
    return ap


def parse(ap: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """The flags, with ``runs`` (timed repeats) and ``warmup`` (untimed
    calls first) set by ``--quick``."""
    args = ap.parse_args(argv)
    args.runs, args.warmup = (QUICK_RUNS, QUICK_WARMUP) if args.quick else (RUNS, WARMUP)
    return args


def setup(name: str) -> torch.device:
    """The bench's device: on ``cuda`` the kernels are built and loaded
    first; without CUDA it raises (a bench never falls back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("this bench runs on cuda and no CUDA device is available (pass --device cpu)")
        from align3d_torch import _kernels

        t0 = time.perf_counter()
        _kernels.build()
        _kernels.lib()
        log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s; device {torch.cuda.get_device_name(device)}")
    elif device.type != "cpu":
        raise ValueError(f"--device takes cuda or cpu, got {name!r}")
    return device


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def counts() -> dict:
    return {k: sum(getattr(m, attr) for m, attr in counters) for k, (_, counters) in KERNELS.items()}


def reset_counts() -> None:
    for _, counters in KERNELS.values():
        for m, attr in counters:
            setattr(m, attr, 0)


@dataclasses.dataclass
class Timing:
    """Per-call milliseconds of one measured function."""

    calls: int
    wall: list  # per repeat
    host: list  # per repeat
    busy: float | None  # device busy ms a call, from one profile
    launches: dict  # issued over the last timed repeat, by kernel
    seen: dict | None  # seen by the profiler over its k calls
    result: object  # the last call's return value

    def summary(self, units: float = 1, unit: str = "ms") -> dict:
        """The JSON fields of this timing, for ``units`` units of work a
        call (pairs, frames, pair-iterations): ``value``, ``runs``, ``min``
        and ``max`` a unit of work in ``unit``; ``host_ms`` and
        ``device_busy_ms`` a unit of work in ms."""
        wall = [w / units * TO_UNIT[unit] for w in self.wall]
        busy = None if self.busy is None else self.busy / units
        median = statistics.median(self.wall)
        return {"value": statistics.median(wall), "runs": wall, "min": min(wall), "max": max(wall),
                "host_ms": statistics.median(self.host) / units, "host_runs": [x / units for x in self.host],
                "device_busy_ms": busy, "busy_share": None if busy is None else self.busy / median,
                "launches": self.launches, "profiler_launches": self.seen, "calls": self.calls}


def measure(fn, device: torch.device, args: argparse.Namespace, calls: int | None = None) -> Timing:
    """Warm up, profile ``calls`` (``args.calls``) calls of ``fn`` (on the
    card), then time ``args.runs`` repeats of ``calls`` calls."""
    calls = calls or args.calls
    cuda = device.type == "cuda"
    busy, seen = None, None
    if cuda:
        from align3d_torch.tools.roofline import device_ms

        for _ in range(args.warmup - 1):  # device_ms makes the last warm-up call itself
            fn()
        busy, acts = device_ms(fn, calls)
        seen = {k: sum(symbol in name for name, _ in acts) for k, (symbol, _) in KERNELS.items()}
    else:
        for _ in range(args.warmup):
            fn()
    wall, host = [], []
    for _ in range(args.runs):
        reset_counts()
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        if cuda:
            start.record()
        for _ in range(calls):
            result = fn()
        if cuda:
            end.record()
        sync(device)
        host.append((time.perf_counter() - t0) * 1e3 / calls)
        wall.append(start.elapsed_time(end) / calls if cuda else host[-1])
    issued = counts()  # the last repeat's (on the CPU the plain twins launch nothing)
    return Timing(calls, wall, host, busy, issued, seen, result)


def card(device: torch.device) -> str | None:
    """``nvidia-smi``'s name and power limit of the card, None on the CPU."""
    if device.type != "cuda":
        return None
    from align3d_torch.tools.roofline import card as smi

    return smi()["nvidia_smi"]


def record(metric: str, unit: str, timing: Timing, device: torch.device, units: float = 1,
           baseline: float | None = None, **extra) -> dict:
    """Print the bench's one JSON line on stdout and return it."""
    s = timing.summary(units, unit)
    value = s.pop("value")
    line = {"metric": metric, "value": value, "unit": unit, "vs_baseline": None if baseline is None else baseline / value,
            **s, "device": str(device), "card": card(device), **extra}
    print(json.dumps(line), flush=True)
    return line


def describe(label: str, s: dict, unit: str) -> None:
    """One stderr line of a summary."""
    busy = "not measured" if s["device_busy_ms"] is None else f"{s['device_busy_ms']:.4f} ms"
    log(f"[{label}] {s['value']:.4f} {unit} (runs {', '.join(f'{w:.4f}' for w in s['runs'])}); "
        f"host {s['host_ms']:.4f} ms; device busy {busy}; launches {s['launches']}, profiler saw {s['profiler_launches']}")


@dataclasses.dataclass
class Outcome:
    """What a bench's ``run`` returns: the printed line and the bench's
    result (the port call's output the timing measured)."""

    line: dict
    result: object
