"""The one general generator of the benchmark's traffic.

A traffic mix is a JSON file ``traffic/<mix>.json``:

* ``fixtures``: fixture name -> the SHA-256 of its directory
  (:func:`benchmark.fixtures.digest`);
* ``sequence``: a list of ``[fixture, "forward" | "backward"]`` runs, put
  end to end into one frame sequence (the recipes of the port's
  ``tools/series.py``: sample1 alone, or sample1 and sample2);
* ``order``: ``"walk"`` (a seeded walk over the sequence: each next frame is
  the adjacent one in the current direction, which reverses at either end
  and with probability ``reverse_probability`` at each frame) or
  ``"alternate"`` (one such walk over each run of the sequence; the pool's
  windows take the runs in turn, so every adjacent pair of a window lies in
  one fixture);
* ``pool``: for the batch driver, how many distinct windows of consecutive
  frames set-up draws from the stream; the run cycles them.

The seed picks the start (and the walk's turns); the program gets only the
frames the stream names.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator

import numpy as np

from benchmark import fixtures as fx

HERE = Path(__file__).resolve().parent


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator of ``seed`` for each use (traffic 0, the
    correctness sample 1, ...); any whole number is a seed."""
    return np.random.default_rng(np.random.SeedSequence(entropy=abs(int(seed)), spawn_key=(stream, int(seed) < 0)))


class Traffic:
    def __init__(self, name: str, directory: Path = HERE / "traffic"):
        self.name = name
        self.spec = json.loads((directory / f"{name}.json").read_text())
        self.sequence = []
        for fixture, direction in self.spec["sequence"]:
            if direction not in ("forward", "backward"):
                raise ValueError(f"traffic {name}: direction {direction!r}")
            self.sequence.append((fixture, direction))
        self.order = self.spec["order"]
        if self.order not in ("walk", "alternate"):
            raise ValueError(f"traffic {name}: order {self.order!r}")
        self.pool = int(self.spec.get("pool", 1))

    def load_fixtures(self, stride: int = 1) -> dict[str, fx.Fixture]:
        return {name: fx.load(name, digest, stride) for name, digest in self.spec["fixtures"].items()}

    def _run(self, k: int, lengths: dict[str, int]) -> list[tuple[str, int]]:
        fixture, direction = self.sequence[k]
        idx = range(lengths[fixture])
        return [(fixture, i) for i in (idx if direction == "forward" else reversed(idx))]

    def frames(self, lengths: dict[str, int]) -> list[tuple[str, int]]:
        """The sequence as (fixture, frame index) items; ``lengths`` gives
        each fixture's frame count."""
        return [frame for k in range(len(self.sequence)) for frame in self._run(k, lengths)]

    def stream(self, seed: int, lengths: dict[str, int], run: int | None = None) -> Iterator[tuple[str, int]]:
        """The endless frame stream of ``seed`` (of the sequence's ``run``-th
        run alone, when given: the ``"alternate"`` order's walks)."""
        if self.order == "alternate" and run is None:
            raise ValueError(f"traffic {self.name} alternates walks a window: it has windows, not one stream")
        seq = self.frames(lengths) if run is None else self._run(run, lengths)
        n = len(seq)
        gen = rng(seed, 0 if run is None else 2 + run)
        pos = int(gen.integers(n))
        p = float(self.spec["reverse_probability"])
        step = 1 if gen.random() < 0.5 else -1
        while True:
            yield seq[pos]
            if not 0 <= pos + step < n or gen.random() < p:
                step = -step
            pos += step

    def windows(self, seed: int, lengths: dict[str, int], frames: int) -> list[list[tuple[str, int]]]:
        """``pool`` windows of ``frames`` consecutive frames: consecutive
        cuts of the stream of ``seed`` (``"alternate"``: window k a cut of
        run k mod runs' own walk)."""
        if self.order == "alternate":
            walks = [self.stream(seed, lengths, k) for k in range(len(self.sequence))]
            return [[next(walks[k % len(walks)]) for _ in range(frames)] for k in range(self.pool)]
        stream = self.stream(seed, lengths)
        return [[next(stream) for _ in range(frames)] for _ in range(self.pool)]
