"""Roofline probes of the card, and the K1 GN step measured against them
(port of ``tools/roofline_v4.py``).

    python -m align3d_torch.tools.roofline

Needs a CUDA device and fails without one. Prints one JSON line: the card's
name and power limit, the measured rates, K1's time at batch 64 and its
accounting. The rates:

* **P1** (:func:`fma_chains`, ``csrc/roofline.cu::fma_peak``), float32 FMA
  chains in registers: TFLOP/s beside the published 67 TFLOP/s;
* **P2** (:func:`lane_gather`, :func:`table_gather`), random gathers with
  distinct indices per chain, one mode per level of memory a kernel of the
  port gathers from: ``lane`` (shared memory, the TPU probe's own
  arithmetic), ``l2`` (a table of one pair's target pack, ~25 MB, which the
  50 MB L2 holds: K1 at B = 1, K3) and ``hbm`` (a table of the batch-64
  packs, ~1.6 GB: K1 at B = 64); gathers/s, GB/s of the 4-byte elements and
  of the 32-byte sectors they move. Bounds: ``hbm`` one 32-byte sector a
  gather over the published HBM rate (:func:`table_bound_ms`); ``lane`` one
  4-byte shared-memory load and one store a gather over 32 banks x 132 SMs
  at the SM clock ``nvidia-smi`` reports as its maximum
  (:func:`lane_bound_ms`); ``l2`` none (no published L2 rate);
* two yardsticks, not kernels: a bf16 4096^3 ``torch.matmul`` and a 512 MB
  elementwise stream (read + write).

``kernel_sections`` times K1 at batch 64 distinct real pairs, 640x480
(``align3d_torch.tools.series.real_pairs``), the full kernel only (the TPU
tool's ``ablate`` modes are not ported), and reads its time against the
bytes it must move and the gathers it must make at the measured rates.

Each probe has a plain twin here, taken on a CPU tensor; on a CUDA tensor
the wrapper launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from align3d_torch import _kernels

FMA_ILP, FMA_U = 4, 64
LANE_ILP, LANE_U, ROW = 4, 16, 128
TABLE_ILP, TABLE_U = 4, 16
_FMA_SCALE = 1.0000001
_M32 = 0xFFFFFFFF

#: Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet).
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

SMS = 132
SMEM_BANKS = 32  # 4-byte shared-memory accesses per SM per clock
SECTOR_BYTES = 32  # what one random 4-byte gather moves from L2 or HBM
PACK_BYTES_PER_PIXEL = 80  # K1's target pack: 8 + 12 float32 channels
PAIR_PIXELS = 640 * 480


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _cuda_or_raise(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors on one device")


# -- P1: FMA chains ----------------------------------------------------------


def fma_chains_plain(x: torch.Tensor, steps: int) -> torch.Tensor:
    """The twin of P1: per element, ``steps`` times the TPU probe's chains,
    a_i = x * f32(1 + 1e-7 i), FMA_U times a_i = a_i * 1.0000001 + x (a
    multiply, then an add: two roundings where ``fmaf`` has one), summed."""
    total = torch.zeros_like(x)
    for _ in range(steps):
        accs = [x * float(np.float32(1.0 + 1e-7 * i)) for i in range(FMA_ILP)]
        for _ in range(FMA_U):
            accs = [a * _FMA_SCALE + x for a in accs]
        o = accs[0]
        for a in accs[1:]:
            o = o + a
        total = total + o
    return total


def fma_chains(x: torch.Tensor, steps: int) -> torch.Tensor:
    """P1 over a float32 vector: one thread per element."""
    if x.device.type == "cpu":
        return fma_chains_plain(x, steps)
    _cuda_or_raise("fma_chains", x)
    if x.dtype != torch.float32 or x.ndim != 1:
        raise ValueError("fma_chains takes a float32 vector")
    out = torch.empty_like(x)
    _kernels.launch("P1", x.data_ptr(), out.data_ptr(), x.numel(), steps, _stream(x))
    return out


def fma_flops(n: int, steps: int) -> int:
    """Flops P1 counts: 2 per FMA (the TPU tool's count)."""
    return n * FMA_U * FMA_ILP * 2 * steps


# -- P2: gathers -------------------------------------------------------------


def lane_gather_plain(x: torch.Tensor, idx: torch.Tensor, steps: int) -> torch.Tensor:
    """The twin of P2's lane mode, the TPU probe's arithmetic on (rows, 128)
    int32: per step, chains a_i = x + i, LANE_U times a_i = take(a_i + x,
    idx_i) along the row, summed (int32 sums wrap)."""
    total = torch.zeros_like(x)
    for _ in range(steps):
        accs = [x + i for i in range(LANE_ILP)]
        for _ in range(LANE_U):
            accs = [torch.gather(a + x, 1, idx[i].long()) for i, a in enumerate(accs)]
        acc = accs[0]
        for a in accs[1:]:
            acc = acc + a
        total = total + acc
    return total


def lane_gather(x: torch.Tensor, idx: torch.Tensor, steps: int) -> torch.Tensor:
    """P2, lane mode: x (rows, 128) int32, idx (LANE_ILP, rows, 128) int32 in [0, 128)."""
    if x.device.type == "cpu":
        return lane_gather_plain(x, idx, steps)
    _cuda_or_raise("lane_gather", x, idx)
    rows = x.shape[0]
    if x.dtype != torch.int32 or tuple(x.shape) != (rows, ROW) or idx.dtype != torch.int32 \
            or tuple(idx.shape) != (LANE_ILP, rows, ROW):
        raise ValueError("lane_gather takes int32 x (rows, 128) and idx (4, rows, 128)")
    out = torch.empty_like(x)
    _kernels.launch("P2", x.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, steps, _stream(x),
                    entry="a3d_gather_lane")
    return out


def _mix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & _M32
    return h ^ (h >> 16)


def table_indices(n: int, steps: int, m: int, device, ilp: int = TABLE_ILP, u: int = TABLE_U) -> torch.Tensor:
    """The table mode's gather indices, (steps, u, ilp, n) int64: per
    (element, chain, step) a linear congruential sequence seeded from a
    hash, scaled to [0, m) by a multiply-high, as the kernel makes them
    (``ilp`` x ``u`` other than the library's: the ablation's builds)."""
    e = torch.arange(n, dtype=torch.int64, device=device)
    out = torch.empty((steps, u, ilp, n), dtype=torch.int64, device=device)
    for s in range(steps):
        for i in range(ilp):
            st = _mix32(((s * n + e) * ilp + i) & _M32)
            for k in range(u):
                st = (st * 1664525 + 1013904223) & _M32
                out[s, k, i] = (st * m) >> 32
    return out


def _wrap32(t: torch.Tensor) -> torch.Tensor:
    return (((t & _M32) + 2**31) % 2**32 - 2**31).to(torch.int32)


def table_gather_plain(table: torch.Tensor, x: torch.Tensor, steps: int, ilp: int = TABLE_ILP,
                       u: int = TABLE_U) -> torch.Tensor:
    """The twin of P2's table mode: per element, chains a_i = x + i, u times
    a_i += table[idx], summed over chains and steps (int32 sums wrap)."""
    idx = table_indices(x.numel(), steps, table.numel(), x.device, ilp, u)
    total = torch.zeros_like(x, dtype=torch.int64)
    for s in range(steps):
        for i in range(ilp):
            a = x.to(torch.int64) + i
            for k in range(u):
                a = a + table[idx[s, k, i]].to(torch.int64)
            total = total + a
    return _wrap32(total)


def table_gather(table: torch.Tensor, x: torch.Tensor, steps: int) -> torch.Tensor:
    """P2, table mode: gathers from an int32 device table; x (n,) int32."""
    if x.device.type == "cpu":
        return table_gather_plain(table, x, steps)
    _cuda_or_raise("table_gather", table, x)
    if table.dtype != torch.int32 or x.dtype != torch.int32 or table.ndim != 1 or x.ndim != 1 \
            or not 0 < table.numel() < 2**32:
        raise ValueError("table_gather takes an int32 table (m,), 0 < m < 2^32, and int32 x (n,)")
    out = torch.empty_like(x)
    _kernels.launch("P2", table.data_ptr(), table.numel(), x.data_ptr(), out.data_ptr(), x.numel(), steps,
                    _stream(x), entry="a3d_gather_table")
    return out


def table_bound_ms(gathers: int) -> float:
    """The least time of ``gathers`` random 4-byte gathers from HBM: each
    moves one 32-byte sector (the least the memory moves), at the published
    rate."""
    return gathers * SECTOR_BYTES / PEAK_HBM_BYTES * 1e3


def lane_bound_ms(gathers: int, sm_clock_hz: float) -> float:
    """The least time of ``gathers`` lane-mode gathers: each is one 4-byte
    shared-memory load and one 4-byte store, and each of the 132 SMs serves
    32 such accesses (its banks) a clock."""
    return gathers * 2 / (SMEM_BANKS * SMS * sm_clock_hz) * 1e3


# -- measurement on the card -------------------------------------------------


def card() -> dict:
    """The card's name and power limit, as nvidia-smi gives them."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    line = proc.stdout.strip().splitlines()[0]
    name, limit = (part.strip() for part in line.rsplit(",", 1))
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60)
    if clock.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {clock.stderr.strip()}")
    return {"name": name, "power_limit": limit, "nvidia_smi": line,
            "sm_clock_max_mhz": float(clock.stdout.strip().splitlines()[0])}


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Device time per call of ``fn``: one CUDA event pair around ``reps``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, calls: int, kernel: str | None = None) -> tuple[float | None, list[tuple[str, float]]]:
    """(device ms per call of ``fn`` from ``torch.profiler`` over ``calls``
    calls, the (name, µs) device activities the profiler saw).

    The profiler misses an activity now and then (on an H100 with torch
    2.11: 1 of 50 launches, 2 of 10), so the activities' summed duration is
    not divided by ``calls``. With ``kernel`` every activity must be a launch
    of it (the wrapper issues nothing else) and the time is their mean.
    Without, every call is taken to issue the same ``k = ceil(seen /
    calls)`` activities, and the time is k times their mean. None when the
    profiler saw no activity. Only the device's activities are recorded:
    recording the host's ops too costs seconds a call on paths of tens of
    thousands of launches (the 500-pose graph).
    """
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    acts = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return per_call_ms(acts, calls, kernel), acts


def per_call_ms(activities: list[tuple[str, float]], calls: int, kernel: str | None = None) -> float | None:
    """:func:`device_ms`'s arithmetic on the (name, µs) device activities
    seen over ``calls`` calls."""
    if kernel is not None and not all(kernel in name for name, _ in activities):
        others = sorted({name for name, _ in activities if kernel not in name})
        raise RuntimeError(f"a call of {kernel}'s wrapper issued other device work: {others[:5]}")
    if not activities:
        return None
    per_call = 1 if kernel is not None else -(-len(activities) // calls)
    return sum(us for _, us in activities) / len(activities) * per_call / 1e3


class Probes:
    """Inputs of the probes at their measured sizes, made from a seed on the card."""

    def __init__(self, device, seed: int = 0):
        g = torch.Generator(device=device).manual_seed(seed)
        self.fma_n = SMS * 8 * 256  # one resident wave of 256-thread blocks
        self.fma_x = torch.rand(self.fma_n, generator=g, device=device) + 0.5
        self.lane_rows = SMS * 64  # 8 rows a block, 8 blocks an SM
        self.lane_x = torch.randint(0, 1000, (self.lane_rows, ROW), generator=g, device=device, dtype=torch.int32)
        self.lane_idx = torch.randint(0, ROW, (LANE_ILP, self.lane_rows, ROW), generator=g, device=device,
                                      dtype=torch.int32)
        self.table_n = SMS * 2048 * 4  # four resident waves
        self.table_x = torch.randint(0, 1000, (self.table_n,), generator=g, device=device, dtype=torch.int32)
        pack_ints = PAIR_PIXELS * PACK_BYTES_PER_PIXEL // 4
        self.tables = {
            "l2": torch.randint(0, 1 << 20, (pack_ints,), generator=g, device=device, dtype=torch.int32),
            "hbm": torch.randint(0, 1 << 20, (64 * pack_ints,), generator=g, device=device, dtype=torch.int32),
        }


#: Steps per timed launch: about a millisecond each on an H100.
FMA_STEPS, LANE_STEPS, TABLE_STEPS = 512, 64, {"l2": 8, "hbm": 2}


def measure_probes(p: Probes, sm_clock_hz: float) -> dict:
    """P1 and P2 at their measured sizes: rates, times and bounds (the lane
    mode's at ``sm_clock_hz``)."""
    out = {}
    ms = time_ms(lambda: fma_chains(p.fma_x, FMA_STEPS))
    flops = fma_flops(p.fma_n, FMA_STEPS)
    out["p1"] = {"ms": ms, "flops": flops, "tflops": flops / ms / 1e9, "published_tflops": PEAK_F32_FLOPS / 1e12,
                 "share_of_published": flops / ms / 1e-3 / PEAK_F32_FLOPS, "bound_ms": flops / PEAK_F32_FLOPS * 1e3}
    ms = time_ms(lambda: lane_gather(p.lane_x, p.lane_idx, LANE_STEPS))
    gathers = p.lane_rows * ROW * LANE_ILP * LANE_U * LANE_STEPS
    out["p2_lane"] = {"ms": ms, "gathers": gathers, "gathers_per_s": gathers / ms * 1e3,
                      "gbs": gathers * 4 / ms / 1e6, "table_bytes": LANE_ILP * ROW * 4,
                      "bound_ms": lane_bound_ms(gathers, sm_clock_hz), "sm_clock_hz": sm_clock_hz}
    for mode, table in p.tables.items():
        steps = TABLE_STEPS[mode]
        ms = time_ms(lambda t=table, s=steps: table_gather(t, p.table_x, s))
        gathers = p.table_n * TABLE_ILP * TABLE_U * steps
        out[f"p2_{mode}"] = {"ms": ms, "gathers": gathers, "gathers_per_s": gathers / ms * 1e3,
                             "gbs": gathers * 4 / ms / 1e6, "sector_gbs": gathers * SECTOR_BYTES / ms / 1e6,
                             "table_bytes": table.numel() * 4,
                             "bound_ms": table_bound_ms(gathers) if mode == "hbm" else None}
    return out


def yardsticks(device) -> dict:
    """A bf16 4096^3 matmul and a 512 MB elementwise stream (read + write)."""
    n = 4096
    a = torch.randn(n, n, device=device, dtype=torch.bfloat16)
    b = torch.randn(n, n, device=device, dtype=torch.bfloat16)
    mm_ms = time_ms(lambda: torch.matmul(a, b), reps=20)
    del a, b
    x = torch.ones(128 * 1024 * 1024, device=device)
    y = torch.empty_like(x)
    st_ms = time_ms(lambda: torch.mul(x, 1.0000001, out=y), reps=20)
    nbytes = 2 * x.numel() * 4
    del x, y
    return {"matmul_bf16_4096": {"ms": mm_ms, "tflops": 2 * n**3 / mm_ms / 1e9,
                                 "published_tflops": PEAK_BF16_FLOPS / 1e12},
            "stream_512mb": {"ms": st_ms, "gbs": nbytes / st_ms / 1e6, "published_gbs": PEAK_HBM_BYTES / 1e9}}


#: Bytes of target geometry the GN step needs where a source pixel lands:
#: point, normal and validity, 7 float32 (the pack's 8th lane is padding).
ICP_GEO_BYTES = 7 * 4


def icp_step_bytes(mask: torch.Tensor, h: int, w: int) -> int:
    """Bytes the GN step needs for B pairs of h x w pixels (each input byte
    once, the output once): every source mask byte; per valid source pixel
    its point (12 B), its luma (1 B) and the target geometry where it lands
    (28 B); each pair's bordered (h+2, w+2) float32 intensity map once (the
    function of the 3x3 tap rows K1 gathers, which repeat each value 9
    times); the pose in and the (2, 8, 8) blocks out."""
    valid = int(mask.to(torch.bool).sum())
    per_pair = (h + 2) * (w + 2) * 4 + 12 * 4 + 2 * 64 * 4
    return mask.numel() + valid * (12 + 1 + ICP_GEO_BYTES) + mask.shape[0] * per_pair


#: Float operations of one source pixel in the banded step (K7/K8): ~150 to
#: project, associate, gate and form the 16 stack channels, and the 128
#: products and sums of the two 8x8 blocks.
BANDED_FLOPS_PER_PIXEL = 150 + 2 * 128


def banded_step_bytes(source_pack: torch.Tensor, target_pack: torch.Tensor, emit_stats: bool = False) -> int:
    """Bytes the banded GN step (K7 or K8) needs for B pairs, each input
    byte once and each output byte once: the (B, nchunks, 2, K, 128)
    source packs, the (B, G, C, Hp, 128) target packs (C = 7 float32 for
    K7, 5 int32 for K8), the int32 band bases (a chunk base and G row and
    column bases a chunk), the poses, the (B, 2, 8, 8) blocks and, with
    ``emit_stats``, K7's (B, nchunks, 3, G, 8, 128) stats. A 640x480 pair:
    2,457,600 + 8,601,600 (K7) or 6,144,000 (K8) bytes and a few hundred
    more."""
    b, nchunks, _, k, _ = source_pack.shape
    g = k // 16
    bases = b * nchunks * (1 + 2 * g) * 4
    out = b * 2 * 64 * 4 + (b * nchunks * 3 * g * 8 * 128 * 4 if emit_stats else 0)
    return source_pack.nbytes + target_pack.nbytes + bases + b * 12 * 4 + out


def banded_step_flops(source_pack: torch.Tensor) -> int:
    """Float operations of the banded step over every source pixel of the packs."""
    return source_pack[:, :, 0].numel() * BANDED_FLOPS_PER_PIXEL


#: Float operations of one source pixel in K9: the mask, dirx z, diry z,
#: row m, col m and the six sums.
CENTROID_FLOPS_PER_PIXEL = 11
#: Float operations of one (chunk, group) in K10: the rigid transform (15),
#: the projection (6), the two displacements and the chunk's sums (5).
PREDICT_FLOPS_PER_GROUP = 26


def centroids_bytes(source_pack: torch.Tensor) -> int:
    """Bytes K9 needs for B pairs: the depth channel of the (B, nchunks, 2,
    K, 128) source packs once, and pbar, rowbar, colbar and cnt (six float32
    a (chunk, group)) once. A 640x480 pair: 1,228,800 + 3,600 bytes."""
    b, nchunks, _, k, _ = source_pack.shape
    return b * nchunks * k * 128 * 4 + b * nchunks * (k // 16) * 6 * 4


def centroids_flops(source_pack: torch.Tensor) -> int:
    return source_pack[:, :, 0].numel() * CENTROID_FLOPS_PER_PIXEL


def predict_bytes(b: int, nchunks: int, groups: int) -> int:
    """Bytes K10 needs for B pairs: the poses, K9's six float32 a (chunk,
    group), and the int32 bases out (a chunk base and G row and column bases
    a chunk)."""
    return b * 12 * 4 + b * nchunks * groups * 6 * 4 + b * nchunks * (1 + 2 * groups) * 4


def predict_flops(b: int, nchunks: int, groups: int) -> int:
    return b * nchunks * groups * PREDICT_FLOPS_PER_GROUP


def kernel_sections(device, batch: int = 64, reps: int = 20) -> dict:
    """K1 at ``batch`` distinct real pairs, 640x480, identity poses: ms per launch."""
    from align3d_torch.icp.image_icp import prepack_batched
    from align3d_torch.icp.params import IcpParams
    from align3d_torch.ops import icp_fused
    from align3d_torch.se3 import Transform
    from align3d_torch.tools.series import real_pairs

    sources, targets = real_pairs(batch, device)
    n = targets.height * targets.width
    packed = prepack_batched(
        sources.points.reshape(batch, n, 3), sources.mask.reshape(batch, n), sources.intensities.reshape(batch, n),
        targets.points.reshape(batch, n, 3), targets.mask.reshape(batch, n), targets.normals.reshape(batch, n, 3),
        targets.intensity_map,
    )
    pose = Transform.identity((batch,), device=device)
    args = (pose.rotation, pose.translation, *packed, targets.intrinsics, IcpParams())
    ms = time_ms(lambda: icp_fused.icp_step_fused(*args), reps=reps)
    return {"batch": batch, "ms": ms, "us_per_pair": ms * 1e3 / batch,
            "bytes": icp_step_bytes(packed[1], targets.height, targets.width),
            "gathers": 2 * int(packed[1].to(torch.bool).sum()),
            "target_bytes": packed[3].nbytes + packed[4].nbytes}  # geometry packs and intensity maps


def measure(device="cuda") -> dict:
    """Everything the tool prints, measured on ``device`` (a CUDA device)."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the roofline tool measures a CUDA device and none is available")
    result = {"card": card(), "device": torch.cuda.get_device_name(device)}
    probes = Probes(device)
    result.update(measure_probes(probes, result["card"]["sm_clock_max_mhz"] * 1e6))
    del probes
    result.update(yardsticks(device))
    k1 = kernel_sections(device)
    stream_rate = result["stream_512mb"]["gbs"] * 1e9
    gather_rate = result["p2_hbm"]["gathers_per_s"]
    k1["bound_ms"] = k1["bytes"] / PEAK_HBM_BYTES * 1e3
    k1["at_measured_stream_ms"] = k1["bytes"] / stream_rate * 1e3
    k1["at_measured_gather_ms"] = k1["gathers"] / gather_rate * 1e3
    k1["share_of_bound"] = k1["bound_ms"] / k1["ms"]
    result["k1_batch64"] = k1
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: the roofline tool needs a CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"roofline": measure("cuda")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
