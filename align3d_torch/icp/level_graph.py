"""One CUDA graph a pyramid level for the image ICP loop.

A level's align on the card is its prepack, then ``max_iterations`` x (one
step, K1 or K10 + K8 / K7, and one K11): 40-90 launches, each a ctypes call
behind a Python wrapper that costs the host far more than the kernel costs
the device. :func:`run` captures a level's whole align once into a
``torch.cuda.CUDAGraph`` and replays it after: one launch a level. The
kernels, their arguments and their order are the eager loop's, so a replay
gives the eager loop's bits.

* **Cache.** Per device, the :data:`SIZE` levels used last (3 levels at
  each of 8 batch sizes, say the powers of two 1 to 64 and one more), each
  under :func:`key`: everything its captured launches bake in, i.e. the
  eager function (the engine, and whether the prepack is inside), the
  inputs' shapes and dtypes, and the constants the caller passes (level
  size, intrinsics, every ``IcpParams`` field). Other constants capture
  anew; nothing stale is replayed.
* **First call.** It runs the eager function on the caller's tensors and
  returns that result (so its arguments are checked and its kernels loaded
  before any capture), then captures the function on copies of those
  tensors, the graph's static inputs. A later call copies its tensors into
  them, replays, and returns a copy of the result: the next replay writes
  the graph's own output over.
* **Arrival counters.** K1, K7 and K8 re-arm their per-pair counters every
  launch; each graph gets its own, made before its capture
  (``icp_fused.own_arrivals``), so no replay shares them with a launch on
  another stream.
* **Counts.** A captured launch does not run: the capture takes its
  launches back from ``_kernels.launches()``, and each replay adds them
  again (``_kernels.count``), so the counts read as the eager loop's.
  :func:`counts` gives the captures and replays so far (read differences).
* **Spans.** A replay is one span ``gn.replay`` (under ``icp.level``); a
  capture records none (``profiling.paused``); the eager loop's ``gn.iter``
  / ``gn.step`` / ``gn.solve`` come only from the first call of a level,
  and from the CPU, which never takes this path.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, NamedTuple

import torch

from align3d_torch import _kernels
from align3d_torch.ops import icp_fused
from align3d_torch.utils import profiling

#: Levels kept a device, the least recently used dropped first.
SIZE = 24


class _Level(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: tuple  # static inputs: the captured launches read them
    out: torch.Tensor  # the result, flat: the captured launches write it
    shapes: tuple  # of the result's tensors
    launches: dict  # kernel id -> launches a replay
    arrivals: torch.Tensor  # the graph's own arrival counters


_cache: dict[torch.device, OrderedDict] = {}
_counts = {"captures": 0, "replays": 0}


def key(fn: Callable, tensors: tuple, consts: tuple) -> tuple:
    """The cache key of ``fn(*tensors, *consts)``: the function, the
    tensors' shapes and dtypes and the (hashable) constants."""
    return (fn, tuple((tuple(t.shape), t.dtype) for t in tensors), consts)


def counts() -> dict[str, int]:
    """Captures and replays in this process so far (a copy)."""
    return dict(_counts)


def run(fn: Callable, tensors: tuple, consts: tuple) -> tuple:
    """``fn(*tensors, *consts)`` on the card, through the graph of its
    :func:`key`: one level's align, returning float32 tensors (best
    rotations, translations, residuals), new ones on every call. The
    tensors are on one CUDA device; the first is (B, ...)."""
    levels = _cache.setdefault(tensors[0].device, OrderedDict())
    k = key(fn, tensors, consts)
    level = levels.get(k)
    if level is None:
        result = fn(*tensors, *consts)
        levels[k] = _capture(fn, tensors, consts, result)
        if len(levels) > SIZE:
            levels.popitem(last=False)
        return result
    levels.move_to_end(k)
    handle = profiling.begin("gn.replay")
    for static, t in zip(level.inputs, tensors):
        static.copy_(t)
    level.graph.replay()
    flat = level.out.clone()
    for kid, n in level.launches.items():
        _kernels.count(kid, n)
    _counts["replays"] += 1
    profiling.end(handle)
    out, at = [], 0
    for shape in level.shapes:
        out.append(flat[at:at + shape.numel()].view(shape))
        at += shape.numel()
    return tuple(out)


def _capture(fn: Callable, tensors: tuple, consts: tuple, result: tuple) -> _Level:
    dev = tensors[0].device
    inputs = tuple(t.clone(memory_format=torch.contiguous_format) for t in tensors)
    arrivals = torch.zeros(max(tensors[0].shape[0], 64), dtype=torch.int32, device=dev)
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream(dev)
    before = _kernels.launches()
    with profiling.paused(), icp_fused.own_arrivals(dev, stream.cuda_stream, arrivals):
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            out = torch.cat([t.reshape(-1) for t in fn(*inputs, *consts)])
    launches = {kid: n for kid, n in _kernels.launches(before).items() if n}
    for kid, n in launches.items():
        _kernels.count(kid, -n)
    _counts["captures"] += 1
    return _Level(graph, inputs, out, tuple(t.shape for t in result), launches, arrivals)
