"""Drivers of the system under test, one module per configuration's
``driver`` key. A driver builds the program's objects from the
configuration, warms up, runs the window, keeps a seeded sample of what the
timed path produced, and hands that sample to the reference."""

from __future__ import annotations

import importlib
import math

import numpy as np


def sync(device) -> None:
    """Wait for ``device`` (a no-op on the CPU, where the harness's tests drive it)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def load(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


class Reservoir:
    """A uniform sample of ``k`` of the units a window completes, drawn from
    the seed: unit n is kept with probability k / (n + 1), replacing a
    random one. Decided before the unit runs, so only the kept ones hold
    their outputs."""

    def __init__(self, k: int, gen: np.random.Generator):
        self.k, self.gen, self.n = k, gen, 0
        self.items: list = []
        self._slot: int | None = None

    def offer(self) -> bool:
        n, self.n = self.n, self.n + 1
        if n < self.k:
            self._slot = n
        else:
            j = int(self.gen.integers(n + 1))
            self._slot = j if j < self.k else None
        return self._slot is not None

    def put(self, item) -> None:
        if self._slot is None:
            return
        if self._slot < len(self.items):
            self.items[self._slot] = item
        else:
            self.items.append(item)


def icp_params(config: dict):
    """The program's ``MsIcpParams`` of the configuration's preset, held to
    the per-level numbers the configuration states (which the reference
    reads): a change to the program's defaults stops the run."""
    from align3d_torch.icp.params import MsIcpParams

    if config["icp_preset"] == "default":
        params = MsIcpParams.default()
    elif config["icp_preset"] == "default_tpu":
        params = MsIcpParams.default_tpu(config["icp_engine"])
    else:
        raise ValueError(f"unknown ICP preset {config['icp_preset']!r}")
    if len(params) != len(config["levels"]):
        raise RuntimeError("the program's ICP levels differ from the configuration's")
    for p, level in zip(params, config["levels"]):
        stated = {"iterations": p.max_iterations, "weight": p.weight, "color_weight": p.color_weight,
                  "max_distance": p.max_distance, "max_normal_angle": p.max_normal_angle,
                  "max_color_distance": p.max_color_distance, "huber_delta": p.huber_delta, "engine": p.engine,
                  "band_radius": p.band_radius, "max_point_to_plane_distance": p.max_point_to_plane_distance}
        for key, value in stated.items():
            want = level[key]
            same = value == want if not isinstance(want, float) else math.isclose(value, want, rel_tol=0, abs_tol=0)
            if not same:
                raise RuntimeError(f"level {level['level']}: the program's {key} is {value!r}, "
                                   f"the configuration states {want!r}")
    return params
