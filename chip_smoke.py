#!/usr/bin/env python3
"""Smoke run of the align3d_torch port on one CUDA GPU.

    python chip_smoke.py

Run from the root of a checkout. Phases, each of which fails the run:

1. CUDA present; print the device and ``nvidia-smi`` name / power limit.
2. Build the CUDA kernels from ``align3d_torch/csrc`` (timed), and print
   the ``-Xptxas -v`` report (registers, shared memory, spills) of K1, K2,
   K3 (its four instantiations), K4 and K5.
3. Hold each kernel against its plain-PyTorch twin on the card at its
   paths' shapes, and time both: device time per call from
   ``torch.profiler`` (for K1-K3 and K5 checked to be one launch of the
   kernel a call and nothing else, as the paths call them), and per-call
   time of back-to-back calls between one CUDA event pair. K1-K3: sample1
   frames 0 and 1, 640x480, the three
   pyramid levels, the (2, 111, 146, 96) bilateral grid; K3 in both forms,
   (b) on the blurred grid (normalize and cast folded in, bitwise against
   ``_normalize_slice_plain``) as the filter paths call it, (a) on the
   normalized grid as before. K4: payload mode
   on the sample1 frame-0 grid (270,213 points, cell 0.05, band 512) with
   frame 1's 270,282 points as queries; nearest mode at 500k x 500k
   uniform, cell 0.02, bands 256 and 512. K5 through ``MeshNormals``: the
   204,800- and 3,276,800-face grid meshes and the teapot, bitwise (the
   sign of zero included, NaN at the same vertices), and
   ``compute_vertex_normals`` (several PyTorch calls) beside it. P1 and P2,
   the roofline probes, against their twins at the sizes the roofline tool
   measures them (P1 relative, P2 bitwise). K2
   and K3 (both forms) over the 65 sample1 frames of the throughput series
   in one launch each, bitwise against 65 single-frame launches and against
   their plain twins, and their library yardsticks (``index_add_``,
   ``grid_sample``) at that shape; K2 over each deep bucket of the mixed
   series at the bucket's depth, bitwise against its plain twin; K3 (both
   forms) over the 29 sample2 frames of the mixed series (gd > 128) against
   its plain twins.
4. Drive each path with its kernels' launch counts reset just before and
   read just after; the filter paths (4a, 4d) must slice through K3's form
   (b) only, with no launch of form (a) and no ``_normalize`` pass:
   a. odometry: ``run_odometry`` on sample1, 10 frames, bilateral filter on;
      the trajectory error against ground truth, the poses against the JAX
      package's golden trajectory, a bitwise-identical second run;
   b. point-cloud ICP: ``Icp(IcpParams())``, banded engine, sample1 frame 0
      <- frame 1 at full resolution: the angle error against ground truth,
      the hash engine within 0.02 rad, one K4 launch per iteration, a
      bitwise-identical second run; and the wavy surface with a large first
      step, which must re-sort;
   c. mesh normals: ``MeshNormals`` of ``teapot.ply`` against the CPU path,
      and of the 204,800-face grid mesh;
   d. the throughput path: ``odometry_step`` on the 65-frame real series
      (64 pairs, 640x480, ``MsIcpParams.default()``), bilateral filter off
      and then bucketed on: one K1 launch per GN iteration over all 64
      pairs (70; K1 is one launch per call), one K2 and one K3 launch per
      bucket; each pair's K1 blocks at B = 64 bitwise their B = 1 blocks,
      and held against the plain twin at those poses moved by phase 3's
      twist; the relative poses bitwise against the
      sequential ``MultiscaleAlign`` on the same pyramids; the pairs
      against ground truth; a bitwise rerun; the mixed sample1 + sample2
      series through at least two depth buckets, each frame's bucketed
      filter bitwise its own ``filter_static``, the true adjacent pairs
      against ground truth.
5. Break a frame's time down: host clock per phase (decode, pyramid build,
   bilateral filter, ICP), each ended by a synchronise, and
   ``torch.profiler`` over the same frames for the device's busy time and
   each kernel's device time per launch; then the same for one point-cloud
   ICP align, with its host syncs per iteration; then the 64-pair step:
   ms per pair (median of 3, bilateral off and on), the device's busy share
   and activities per GN iteration, K1's device time per launch at B = 64,
   the peak device memory.
6. The roofline tool (``align3d_torch.tools.roofline``): P1 and P2 rates,
   the matmul and stream yardsticks, K1 at batch 64 against them; P2's
   bounds (hbm: a 32-byte sector a gather; lane: shared-memory banks).
7. The data path: sample1's frames 0-9 written as a 640x480 TUM tree
   (depth at 1/5000 m, staggered timestamps, ``groundtruth.txt`` by
   ``Trajectory.to_tum``); the port's command line over it, cut at 6
   frames with ``--checkpoint``, then resumed to 10, against one
   uninterrupted ``run_odometry`` (bitwise; the resume must run frames 6-9
   only, and each run's K1, K2 and K3 launches are counted: 70 a pair, one
   splat and one slice a frame built, as on the slamtb run of 4a); the same
   frames through ``maybe_prefetch`` against plain (bitwise); which decoder
   ran and decode ms per frame of ``io/png.py``, the native loader and the
   prefetcher's wait in ``get``; host ms per frame with and without the
   prefetcher; ``RgbdFrame.downsample(1.0)`` on the card against the CPU.
8. Global refinement, each path with K1-K3's launch counts reset just
   before and read just after, all printed as one ``global refinement:``
   JSON line:
   a. ``tests/test_loop_closure_e2e.py`` on the card: the 18-frame
      palindrome of sample1 (0-11, then 10 to 0 in steps of 2), 640x480,
      no filter, odometry at 2 GN iterations a level, then
      ``refine_with_loop_closures`` (closures by ``MsIcpParams.default()``,
      ``min_separation=16``): that test's gates (translation error below
      the odometry's, angle within 1.1x + 1e-3 deg, the revisit closed to
      5e-3) and K1's launches (6 a pair, 70 a closure);
   b. the command line, ``odometry tum <tree> --loop-closure`` over the
      palindrome as a TUM tree (filter on, the defaults), against
      ``run_odometry`` + ``refine_with_loop_closures`` called directly on
      the card (the saved TUM text equal, or within ``CLI_DIRECT_ATOL``);
      K1/K2/K3 launches (70 a pair and a closure; one K2 and one K3 a
      frame built, each closure building two);
   c. the 500-pose graph of ``tests/test_pose_graph.py:198-230``, CG with
      768 trips, 4 GN iterations: its gate (error below 0.6x), the card
      against the CPU, host ms, device busy ms and activities per optimize
      and per PCG trip, peak memory, host syncs per optimize, and one PCG
      call under ``set_sync_debug_mode("error")``; the dense solver at 64
      poses, card against CPU;
   d. bundle adjustment at 500 poses x 50,000 landmarks x 200,000
      observations (``tests/test_bundle_adjustment.py:192-241``, COO, 2
      iterations, 32 PCG trips): its gate (error below 0.2x), the card
      against the CPU and the same measurements as 8c; the dense solver on
      the 6 x 40 scene, card against CPU.

It prints the roofline tool's JSON line, a ``{"kernels": [...]}`` JSON line
(each kernel with its bound from this run's shapes, ``bound_by`` bytes or
operations against the published H100 peaks, and ``library_ms``: the time
of one PyTorch call computing the same function, or null with a reason),
the ``nvidia-smi`` line, and as
its last line ``{"ok": true, "device": {...}}``. Without CUDA, or without the
rest of the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SAMPLE1 = ROOT / "tests" / "data" / "rgbd" / "sample1"
GOLDEN = ROOT / "tests" / "data" / "golden" / "sample1_bilateral_10.tum"
FRAMES = 10
DEVICE = "cuda"

# Tolerances. K2 is held bitwise: every product has a 0/1 factor and the sums
# run in the plain twin's order.
SLICE_ATOL = 2e-3  # K3's form (a) before the cast (tests/test_bilateral.py's kernel bound) ...
SLICE_CAST_MAX = 1  # ... and after the truncating cast; form (b) is held bitwise
ICP_COUNT_SHARE = 1e-4  # K1: count within 0.01% of the valid pixels
ICP_REL = 1e-4  # K1: H and g within 1e-4 x max|entry|
K1_TWIST = [0.004, -0.002, 0.003, 0.002, -0.003, 0.001]  # the pose K1 is held against its twin at
POSE_ATOL = 2e-3  # poses against the golden: rad / m
MEAN_ANGLE_DEG, MEAN_TRANS = 0.5, 0.01  # tests/test_odometry_accuracy.py bound

PCL_MAX_ANGLE = 0.1  # pcl ICP against ground truth (pcl_icp.rs:121-136, tests/test_icp.py)
PCL_ENGINES_ANGLE = 0.02  # banded against hash (tests/test_icp.py::test_pcl_icp_align_banded_engine)
WAVY_BOUND = 0.01  # rad / m (tests/test_icp.py::test_pcl_icp_banded_large_step_resort)
MESH_ATOL = 2e-6  # MeshNormals on the card against the CPU path and compute_vertex_normals (tests/test_mesh.py)

FMA_RTOL = 1e-5  # P1 against its twin: fmaf rounds once, the twin twice
GRID_SAMPLE_ATOL = 0.05  # K3's library yardstick must reproduce the sample this closely (depth units)
INDEX_ADD_RTOL = 1e-5  # K2's library yardstick: the same sums in another order
STEP_ITERATIONS = 70  # GN iterations of one MsIcpParams.default() align: 30 + 20 + 20
TUM_CUT, TUM_EVERY = 6, 3  # phase 7: the cut run's max_frames and --checkpoint-every
TUM_DEPTH_FACTOR = 5  # sample1's 1 mm depth units -> TUM's 1/5000 m
DOWNSAMPLE_COLOR_SHARE = 1e-4  # RgbdFrame.downsample's colour, card vs CPU: the share the CPU tests allow vs JAX
# Phase 8, global refinement. 8a/8b: tests/test_loop_closure_e2e.py's palindrome
# (frames 0-11, then back to 0 in steps of 2), 8a with its cheap odometry.
PALINDROME = list(range(12)) + [10, 8, 6, 4, 2, 0]
CHEAP_ITERATIONS = 2  # GN iterations a level of 8a's odometry
PG_POSES, PG_DENSE_POSES, PG_ITERATIONS, PG_CG_ITERS = 500, 64, 4, 768  # tests/test_pose_graph.py:198-230
BA_SIZE, BA_ITERATIONS, BA_CG_ITERS = (500, 50_000, 200_000), 2, 32  # tests/test_bundle_adjustment.py:192-241
CLI_DIRECT_ATOL = 1e-5  # 8b: saved trajectory (TUM text, 7 decimals) vs the direct call; index_add_ adds by atomics
PG_CARD_CPU_ATOL = 1e-3  # 8c: float32 CG on the 500-chain, card vs CPU (a 1e-7 relative nudge of the nodes moves 5e-5)
PG_DENSE_CARD_CPU_ATOL = 1e-4  # 8c: float64 dense solve of float32 systems, card vs CPU
BA_CARD_CPU_ATOL = 1e-4  # 8d: 32 float32 PCG trips, card vs CPU
BA_DENSE_CARD_CPU_ATOL = 1e-4  # 8d: the dense Schur solve, card vs CPU

# Published H100 SXM peaks at 700 W (the bounds are stated against them).
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12

TIMED_CALLS = 50  # calls per timing, back to back
TIMED_PLAIN_NN = 5  # calls per timing of the K4 twin, which takes ~0.1 s a call ...
PROFILED_PLAIN_NN = 1  # ... and ~40k profiler events per call
PROFILED_FRAMES = 3  # frames 1..3 of sample1 in phase 5
#: Kernel names in csrc/, by the wrapper that launches them (K3's two forms
#: are instantiations of one template).
KERNEL_NAMES = {"icp": ("icp_step_kernel",), "splat": ("bilateral_splat",), "slice": ("bilateral_slice",),
                "mesh": ("mesh_normals",)}
ODOMETRY_KERNELS = ("icp", "splat", "slice")  # the kernels phase 5's frame profile reads
#: The repository's nine ``pl.pallas_call`` sites, by the kernel that replaces them.
PALLAS_CALLS = {"K1": ["align3d_tpu/ops/icp_pallas_v4.py:508", "align3d_tpu/ops/icp_pallas_v3.py:761"],
                "K2": ["align3d_tpu/ops/bilateral.py:171"], "K3": ["align3d_tpu/ops/bilateral.py:598"],
                "K4": ["align3d_tpu/ops/nn_banded.py:370", "align3d_tpu/ops/nn_banded.py:459"],
                "K5": ["align3d_tpu/ops/mesh.py:356"], "P1": ["tools/roofline_v4.py:68"],
                "P2": ["tools/roofline_v4.py:118"]}
PTXAS_NAMES = {**{key: names[0] for key, names in KERNEL_NAMES.items()}, "nn": "nn_banded"}


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over the HBM rate against
    operations over the float32 rate, the larger of the two."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes, "bound_flops": flops}


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def device_events(torch, prof):
    """The device activities (kernels, copies, sets) of a profile."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def timings(torch, fn, n: int = TIMED_CALLS, profiled: int | None = None,
            kernel: str | None = None) -> tuple[float | None, float]:
    """(device ms per call, per-call ms) of ``fn``.

    The device time is ``tools/roofline.py::device_ms`` over ``profiled``
    calls (default ``n``): the mean of the device activities the profiler
    saw, which does not read low when it misses some (it does: 1 of 50
    launches, 2 of 10), times the activities a call issues; with
    ``kernel``, the run fails unless every activity is a launch of that
    kernel, so that a wrapper's copies cannot hide. The per-call time is one
    CUDA event pair around ``n`` back-to-back calls, divided by ``n``: where
    the host dispatches more slowly than the device runs, it is the host's
    time per call.
    """
    from align3d_torch.tools.roofline import device_ms

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    per_call = start.elapsed_time(end) / n
    profiled = n if profiled is None else profiled
    ms, seen = device_ms(fn, profiled, kernel)
    if kernel is not None and seen != profiled:
        print(f"the profiler saw {seen} {kernel} launches of {profiled}")
    return ms, per_call


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def check_splat(torch, bil, depth):
    filt = bil.BilateralFilter()
    cmin, shape, _ = bil.grid_geometry(depth, filt.sigma_space, filt.sigma_color, filt.pad_depth_to)
    args = (depth, cmin, shape, filt.sigma_space, filt.sigma_color)
    got, ref = bil._splat(*args), bil._splat_plain(*args)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    print(f"K2 splat: grid {tuple(got.shape)}, max|kernel - plain| = {err}, "
          f"bitwise = {torch.equal(got, ref)}")
    if not torch.equal(got, ref):
        raise AssertionError("K2 splat differs from its plain twin")
    lib = library_splat(torch, bil, depth, cmin, shape, filt, got)
    # Bytes: the image once and the grid once; ~10 flops per pixel.
    b = bound(depth.numel() * 4 + got.numel() * 4, depth.numel() * 10)
    return (err, timings(torch, lambda: bil._splat(*args), kernel=KERNEL_NAMES["splat"][0]),
            timings(torch, lambda: bil._splat_plain(*args)), b, lib)


def library_splat(torch, bil, depth, cmin, shape, filt, kernel_out, n: int = TIMED_CALLS):
    """One ``index_add_`` of w * v and w into flat channel-major grids, at
    the cells the reference's splat map gives each pixel (timed only).
    ``depth``: (H, W) or (B, H, W) frames; ``cmin``: an int or (B,)."""
    gh, gw, gd = shape
    frames = depth.reshape(-1, *depth.shape[-2:])
    nb, h, w = frames.shape
    inv_ss = float(1.0 / filt.sigma_space)
    rows = ((torch.arange(h, device=depth.device, dtype=torch.float32) * inv_ss + 0.5).to(torch.int64) + 2)
    cols = ((torch.arange(w, device=depth.device, dtype=torch.float32) * inv_ss + 0.5).to(torch.int64) + 2)
    vals = frames.to(torch.float32)
    cm = torch.as_tensor(cmin, device=depth.device).reshape(-1, 1, 1).to(torch.float32)
    # Holes (weight 0) may land outside [0, gd) under the nonzero minimum.
    chan = (((vals - cm) * (1.0 / filt.sigma_color) + 0.5).to(torch.int64) + 2).clamp_(0, gd - 1)
    fb = torch.arange(nb, device=depth.device)[:, None, None]
    idx = (((fb * gh + rows[None, :, None]) * gw + cols[None, None, :]) * gd + chan).reshape(-1)
    wt = (frames > 0).to(torch.float32).reshape(-1)
    src = torch.stack([wt * vals.reshape(-1), wt])
    flat = torch.zeros((2, nb * gh * gw * gd), device=depth.device)

    def call():
        flat.zero_()
        flat.index_add_(1, idx, src)

    call()
    torch.cuda.synchronize()
    got = flat.reshape(2, nb, gh, gw, gd).transpose(0, 1)
    ref = kernel_out.reshape(nb, 2, gh, gw, gd)
    rel = float((got - ref).abs().max() / ref.abs().max())
    del got, ref
    flat_ms, call_ms = timings(torch, lambda: flat.index_add_(1, idx, src), n=n)
    return {"library_ms": flat_ms, "library_call_ms": call_ms, "library_call": "Tensor.index_add_ (2 channels, one call)",
            "library_max_rel_diff": rel, "library_ok": rel <= INDEX_ADD_RTOL}


def check_slice(torch, bil, depth):
    """K3 at one sample1 frame: form (b) on the blurred grid, bitwise against
    its twin, as the filter calls it; form (a) on the normalized grid as
    before. Returns form (b)'s entry and form (a)'s."""
    filt = bil.BilateralFilter()
    blurred = bil.BilateralGrid.from_image(depth, filt.sigma_space, filt.sigma_color, filt.pad_depth_to).convolve()
    grid = blurred.normalize()
    args = (grid.data_cm, depth, grid.color_min, filt.sigma_space, filt.sigma_color)
    got, ref = bil._slice(*args), bil._slice_plain(*args)
    fargs = (blurred.data_cm, depth, blurred.color_min, filt.sigma_space, filt.sigma_color)
    fused, fused_ref = bil._normalize_slice(*fargs), bil._normalize_slice_plain(*fargs)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    cast_err = int((got.to(torch.int32) - ref.to(torch.int32)).abs().max())
    fused_err = int((fused - fused_ref).abs().max())
    fused_same = torch.equal(fused, fused_ref) and torch.equal(fused, got.to(torch.int32))
    print(f"K3 slice, form (a): max|kernel - plain| = {err} before the cast, {cast_err} after, "
          f"bitwise = {torch.equal(got, ref)}; form (b): max|kernel - plain| = {fused_err}, bitwise against its "
          f"twin and against form (a) + the cast = {fused_same}")
    if not (err <= SLICE_ATOL and cast_err <= SLICE_CAST_MAX):
        raise AssertionError("K3's form (a) differs from its plain twin")
    if not fused_same:
        raise AssertionError("K3's form (b) differs from its plain twin")
    lib = library_slice(torch, grid.data_cm, depth, grid.color_min, filt, got)
    cells = sampled_cells(torch, bil, depth, grid.color_min, *grid.data_cm.shape[1:], filt)
    # Bytes: the grid cells sampled (form (a): the value; (b): value and
    # count), the image and the output once; ~30 flops a pixel.
    form_a = (err, timings(torch, lambda: bil._slice(*args), kernel=KERNEL_NAMES["slice"][0]),
              timings(torch, lambda: bil._slice_plain(*args)), bound(cells * 4 + depth.numel() * 8, depth.numel() * 30),
              lib)
    form_b = (fused_err, timings(torch, lambda: bil._normalize_slice(*fargs), kernel=KERNEL_NAMES["slice"][0]),
              timings(torch, lambda: bil._normalize_slice_plain(*fargs)),
              bound(cells * 8 + depth.numel() * 8, depth.numel() * 30), lib)
    return form_b, form_a


def sampled_cells(torch, bil, images, color_min, gh, gw, gd, filt) -> int:
    """Distinct grid cells K3 reads for (B, H, W) images: the 8 trilinear
    corners of every pixel, counted once (the bytes this run's data needs)."""
    frames = images.reshape(-1, *images.shape[-2:])
    y0, y1, _, x0, x1, _ = bil._slice_tables(*frames.shape[1:], gh, gw, filt.sigma_space, images.device)
    cmin = torch.as_tensor(color_min, device=images.device).reshape(-1, 1, 1).to(torch.float32)
    chan = (frames.to(torch.float32) - cmin) * (1.0 / filt.sigma_color) + 2
    zs = [torch.clamp(chan.to(torch.int32), 0, gd - 1), torch.clamp((chan + 1.0).to(torch.int32), 0, gd - 1)]
    b = torch.arange(frames.shape[0], device=images.device)[:, None, None].long()
    cells = [((b * gh + y.long()[None, :, None]) * gw + x.long()[None, None, :]) * gd + z.long()
             for y in (y0, y1) for x in (x0, x1) for z in zs]
    return int(torch.unique(torch.stack(cells)).numel())


def library_slice(torch, grids, depth, color_min, filt, kernel_out, n: int = TIMED_CALLS):
    """``grid_sample`` 5-D trilinear (border padding, corners aligned) at the
    pixels' grid coordinates, as K3's yardstick where it reproduces K3.
    ``grids``: (2, gh, gw, gd) or (B, 2, gh, gw, gd), one per frame of
    ``depth``; ``color_min``: an int or (B,)."""
    import torch.nn.functional as F

    gh, gw, gd = grids.shape[-3:]
    frames = depth.reshape(-1, *depth.shape[-2:])
    nb, h, w = frames.shape
    inv_ss = float(1.0 / filt.sigma_space)
    y = torch.arange(h, device=depth.device, dtype=torch.float32) * inv_ss + 2
    x = torch.arange(w, device=depth.device, dtype=torch.float32) * inv_ss + 2
    cm = torch.as_tensor(color_min, device=depth.device).reshape(-1, 1, 1).to(torch.float32)
    z = (frames.to(torch.float32) - cm) * (1.0 / filt.sigma_color) + 2

    def norm(c, n):
        return c * (2.0 / (n - 1)) - 1.0

    coords = torch.stack([norm(z, gd), norm(x, gw)[None, None, :].expand(nb, h, w),
                          norm(y, gh)[None, :, None].expand(nb, h, w)], -1)
    coords = coords[:, None].contiguous()
    value = grids.reshape(nb, 2, gh, gw, gd)[:, :1].contiguous()

    def call():
        return F.grid_sample(value, coords, mode="bilinear", padding_mode="border", align_corners=True)

    diff = float((call()[:, 0, 0].reshape(kernel_out.shape) - kernel_out).abs().max())
    ms, call_ms = timings(torch, call, n=n)
    ok = diff <= GRID_SAMPLE_ATOL
    return {"library_ms": ms if ok else None, "library_call_ms": call_ms, "library_call": "F.grid_sample 5-D trilinear",
            "library_max_abs_diff": diff, "library_ok": ok,
            **({} if ok else {"library_reason": f"grid_sample differs from the sample by {diff}"})}


def check_icp(torch, pyr0, pyr1):
    from align3d_torch.icp.params import MsIcpParams
    from align3d_torch.ops import icp_fused
    from align3d_torch.ops.target_pack import pack_geometry
    from align3d_torch.se3 import Transform

    params = MsIcpParams.default()
    pose = Transform.exp(torch.tensor(K1_TWIST, device=DEVICE))
    worst_rel, timing = 0.0, None
    for level, (tgt, src) in enumerate(zip(pyr0, pyr1)):
        h, w = tgt.height, tgt.width
        n = h * w
        args = (
            pose.rotation[None].contiguous(), pose.translation[None].contiguous(),
            src.points.reshape(1, n, 3).contiguous(), src.mask.reshape(1, n).to(torch.uint8),
            src.intensities.reshape(1, n).contiguous(),
            pack_geometry(tgt.points, tgt.normals, tgt.mask)[None], tgt.intensity_map[None].contiguous(),
            h, w, tgt.intrinsics, params[level],
        )
        got, ref = icp_fused.icp_step_fused(*args), icp_fused.icp_step_plain(*args)
        torch.cuda.synchronize()
        valid = int(src.mask.sum())
        worst_rel = max(worst_rel, check_icp_blocks(torch, got, ref, args[3], f"K1 level {level}"))
        again = icp_fused.icp_step_fused(*args)
        if not torch.equal(again, got):
            raise AssertionError("K1 is not deterministic")
        if level == 0:
            timing = (timings(torch, lambda: icp_fused.icp_step_fused(*args), kernel=KERNEL_NAMES["icp"][0]),
                      timings(torch, lambda: icp_fused.icp_step_plain(*args)))
            # Bytes: each input byte K1 needs once (tools/roofline.py); ~300
            # flops per valid source pixel.
            from align3d_torch.tools.roofline import icp_step_bytes
            b = bound(icp_step_bytes(args[3], h, w), 300 * valid)
    return worst_rel, *timing, b, {"library_ms": None, "library_reason":
                                   "no PyTorch call computes the gated two-system GN accumulation"}


def check_icp_blocks(torch, got, ref, mask, label: str) -> float:
    """Hold K1's (B, 2, 8, 8) blocks against its twin's, pair by pair: the
    count within ICP_COUNT_SHARE of the pair's valid pixels, H, g and
    sum w r^2 within ICP_REL relative. Returns the worst relative error."""
    valid = mask.to(torch.bool).sum(dim=1).tolist()
    worst = 0.0
    for b in range(got.shape[0]):
        for s, name in ((0, "geometric"), (1, "colour")):
            g, r = got[b, s], ref[b, s]
            count_diff = abs(float(g[7, 7]) - float(r[7, 7]))
            h_err = float((g[:6, :6] - r[:6, :6]).abs().max()) / float(r[:6, :6].abs().max())
            g_err = float((g[:6, 6] - r[:6, 6]).abs().max()) / float(r[:6, 6].abs().max())
            sq_err = abs(float(g[6, 6]) - float(r[6, 6])) / float(r[6, 6])
            worst = max(worst, h_err, g_err, sq_err)
            if got.shape[0] == 1:
                print(f"{label} {name}: count {float(g[7, 7]):.0f} vs {float(r[7, 7]):.0f}, "
                      f"H rel {h_err:.2e}, g rel {g_err:.2e}, sum w r^2 rel {sq_err:.2e}")
            if not (count_diff <= ICP_COUNT_SHARE * valid[b] and h_err <= ICP_REL
                    and g_err <= ICP_REL and sq_err <= ICP_REL):
                raise AssertionError(f"{label}, pair {b} {name}, differs from its plain twin")
    return worst


def cloud(torch, dataset, index):
    """Valid points and normals of a sample1 frame on the card, as the JAX
    package's pcl-ICP test makes them (no bilateral filter)."""
    from align3d_torch.range_image import RangeImage

    frame = dataset.get(index)
    ri = RangeImage.from_rgbd(
        frame.camera, torch.from_numpy(frame.image.color).to(DEVICE),
        torch.from_numpy(frame.image.depth.astype("int32")).to(DEVICE), float(frame.image.depth_scale),
    ).with_normals()
    mask = ri.mask.reshape(-1)
    return ri.points.reshape(-1, 3)[mask].contiguous(), ri.normals.reshape(-1, 3)[mask].contiguous()


def nn_args(torch, nn, grid, queries, band_width, anchor_min):
    """K4's arguments as associate_p2p (block minimum) or nearest_banded
    (first cell of the block) make them, for queries sorted by cell."""
    lin = grid.cell_ids(queries)
    order = torch.argsort(lin, stable=True)
    q_s = queries[order]
    qplanes, bstarts, bw = nn.search_inputs(grid, lin[order], q_s[:, 0], q_s[:, 1], q_s[:, 2], band_width, anchor_min)
    return grid.planes, qplanes, bstarts, bw


def check_nn(torch, nn, label, args, payload):
    got, ref = nn.band_search(*args, payload), nn.band_search_plain(*args, payload)
    torch.cuda.synchronize()
    same = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]) and (
        not payload or torch.equal(got[2], ref[2]))
    err = float(torch.nan_to_num((got[0] - ref[0]).abs(), nan=0.0).max())  # inf - inf: a query with no winner
    print(f"K4 {label}: {args[1].shape[1] // nn.QB} query blocks, band {args[3]}, bitwise = {same}")
    if not same:
        raise AssertionError(f"K4 {label} differs from its plain twin")
    again = nn.band_search(*args, payload)
    if not all(a is None or torch.equal(a, b) for a, b in zip(again, got)):
        raise AssertionError("K4 is not deterministic")
    # Operations: 8 flops per scored candidate, 9 bands of band_width per
    # query; bytes: the planes, the queries and the outputs once.
    planes, qplanes, bstarts, bw = args
    out_bytes = sum(t.numel() * t.element_size() for t in got if t is not None)
    b = bound(planes.numel() * 4 + qplanes.numel() * 4 + bstarts.numel() * 4 + out_bytes,
              qplanes.shape[1] * 9 * bw * 8)
    return err, timings(torch, lambda: nn.band_search(*args, payload)), timings(
        torch, lambda: nn.band_search_plain(*args, payload), TIMED_PLAIN_NN, PROFILED_PLAIN_NN), b, {
        "library_ms": None, "library_reason": "no PyTorch call searches a banded sorted grid (cdist + argmin "
        "are two calls over all N x M pairs)"}


def check_mesh(torch, mesh, label, pts, faces):
    """K5 through ``MeshNormals`` against its twin, bitwise with the sign of
    zero and NaN at the same vertices; ``compute_vertex_normals`` (several
    PyTorch calls: face normals, ``index_add_``, ``bincount``, a division)
    timed beside it as a composed yardstick, within MESH_ATOL."""
    from align3d_torch.tools.ablate import same_bits

    ev = mesh.MeshNormals(faces, pts.shape[0], device=DEVICE)
    points = torch.from_numpy(pts).to(DEVICE)
    args = (points, ev.table, ev.counts)
    got, ref = ev(points), mesh.vertex_normals_plain(*args)
    faces_t = torch.from_numpy(faces).to(DEVICE)
    composed = mesh.compute_vertex_normals(points, faces_t)
    torch.cuda.synchronize()
    same = same_bits(got, ref)
    err = float((torch.nan_to_num(got) - torch.nan_to_num(ref)).abs().max())
    composed_err = float((torch.nan_to_num(got) - torch.nan_to_num(composed)).abs().max())
    print(f"K5 {label}: {faces.shape[0]} faces, {pts.shape[0]} vertices, degree {ev.degree}, bitwise = {same}; "
          f"compute_vertex_normals max |diff| {composed_err}")
    if not same:
        raise AssertionError(f"K5 {label} differs from its plain twin")
    if not (torch.equal(torch.isnan(got), torch.isnan(composed)) and composed_err <= MESH_ATOL):
        raise AssertionError(f"K5 {label} differs from compute_vertex_normals")
    # Bytes: points, corner table, counts and output once; ~30 flops a face.
    b = bound(sum(t.numel() * t.element_size() for t in args) + got.numel() * 4, faces.shape[0] * 30)
    composed_ms, composed_call_ms = timings(torch, lambda: mesh.compute_vertex_normals(points, faces_t))
    return err, timings(torch, lambda: ev(points), kernel=KERNEL_NAMES["mesh"][0]), timings(
        torch, lambda: mesh.vertex_normals_plain(*args)), b, {
        "library_ms": None, "library_reason": "no one PyTorch call computes vertex normals",
        "composed_ms": composed_ms, "composed_call_ms": composed_call_ms,
        "composed_call": "ops/mesh.py::compute_vertex_normals: face normals, index_add_, bincount and a division "
                         "(several calls)", "composed_max_abs_diff": composed_err}


def wavy(torch, Transform, side=100):
    """tests/test_icp.py::test_pcl_icp_banded_large_step_resort's surface and offset."""
    g = torch.linspace(0.0, 2.0, side, device=DEVICE)
    xs, ys = torch.meshgrid(g, g, indexing="ij")
    zs = 0.2 * torch.sin(2 * xs) * torch.cos(2 * ys)
    tp = torch.stack([xs, ys, zs], dim=-1).reshape(-1, 3)
    tn = torch.stack([-0.4 * torch.cos(2 * xs) * torch.cos(2 * ys), 0.4 * torch.sin(2 * xs) * torch.sin(2 * ys),
                      torch.ones_like(zs)], dim=-1).reshape(-1, 3)
    tn = tn / torch.linalg.norm(tn, dim=-1, keepdim=True)
    offset = Transform.exp(torch.tensor([0.2, 0.1, 0.05, 0.03, -0.02, 0.04], device=DEVICE))
    return tp, tn, offset.apply(tp), offset.apply_normals(tn), offset


def pcl_path(torch, nn, Icp, IcpParams, Transform, TransformMetrics, target, source, gt) -> int:
    """Phase 4b; returns K4's launches in the first align."""
    params = IcpParams()
    icp = Icp(params, *target)
    if icp.nn_engine != "banded":
        raise AssertionError(f"the default engine on the card is {icp.nn_engine}")
    nn.LAUNCHES = 0
    first = icp.align(*source)
    launches = nn.LAUNCHES
    resorts = icp.last_resorts
    second = icp.align(*source)
    hashed = Icp(params, *target, nn_engine="hash").align(*source)
    angle = float(TransformMetrics.new(first, gt).angle)
    hash_angle = float(TransformMetrics.new(hashed, gt).angle)
    engines = float(TransformMetrics.new(first, hashed).angle)
    identical = torch.equal(first.rotation, second.rotation) and torch.equal(first.translation, second.translation)
    print(f"pcl ICP, sample1 0 <- 1, {params.max_iterations} iterations: banded {angle:.3e} rad from ground "
          f"truth, hash {hash_angle:.3e} rad, banded vs hash {engines:.3e} rad; K4 launches {launches}; "
          f"last_resorts {resorts}; second run bitwise identical: {identical}")
    if not (abs(angle) < PCL_MAX_ANGLE and abs(engines) < PCL_ENGINES_ANGLE):
        raise AssertionError("point-cloud ICP outside its bounds")
    if launches != params.max_iterations:
        raise AssertionError(f"K4 launched {launches} times in {params.max_iterations} iterations")
    if not identical:
        raise AssertionError("two point-cloud ICP runs differ")
    if not (torch.isfinite(first.rotation).all() and torch.isfinite(first.translation).all()):
        raise AssertionError("non-finite point-cloud ICP pose")

    tp, tn, sp, sn, offset = wavy(torch, Transform)
    wavy_icp = Icp(IcpParams(max_iterations=8, max_distance=0.5), tp, tn)
    err = TransformMetrics.new(wavy_icp.align(sp, sn), offset.inverse())
    print(f"pcl ICP, wavy surface, large first step: last_resorts {wavy_icp.last_resorts}, "
          f"error {float(err.angle):.3e} rad / {float(err.translation):.3e} m")
    if not (wavy_icp.last_resorts >= 1 and abs(float(err.angle)) < WAVY_BOUND
            and float(err.translation) < WAVY_BOUND):
        raise AssertionError("the wavy large-step case did not re-sort or did not converge")
    return launches


def mesh_path(torch, mesh, teapot, grid_pts, grid_faces) -> int:
    """Phase 4c; returns K5's launches over the two MeshNormals calls."""
    mesh.LAUNCHES = 0
    tea = mesh.MeshNormals(teapot.faces, len(teapot.points), device=DEVICE)(torch.from_numpy(teapot.points).to(DEVICE))
    grid_normals = mesh.MeshNormals(grid_faces, len(grid_pts), device=DEVICE)(torch.from_numpy(grid_pts).to(DEVICE))
    torch.cuda.synchronize()
    launches = mesh.LAUNCHES
    tea_cpu = mesh.MeshNormals(teapot.faces, len(teapot.points), device="cpu")(torch.from_numpy(teapot.points))
    err = float((torch.nan_to_num(tea.cpu()) - torch.nan_to_num(tea_cpu)).abs().max())
    print(f"mesh normals: teapot.ply on the card vs the CPU path max |diff| {err}; "
          f"grid mesh {grid_faces.shape[0]} faces; K5 launches {launches}")
    if not (torch.equal(torch.isnan(tea.cpu()), torch.isnan(tea_cpu)) and err <= MESH_ATOL):
        raise AssertionError("MeshNormals on the card differs from the CPU path")
    if not torch.isfinite(grid_normals).all():
        raise AssertionError("non-finite normals on the grid mesh")
    if launches != 2:
        raise AssertionError(f"K5 launched {launches} times in two MeshNormals calls")
    return launches


def profile_pcl(torch, nn, Icp, IcpParams, target, source) -> dict:
    """Phase 5 for point-cloud ICP: host ms per align (median of 3, ended by
    a synchronise), then one profiled align for the device's busy share,
    K4's device time per launch and the host syncs per iteration."""
    from torch.profiler import ProfilerActivity, profile

    params = IcpParams()
    icp = Icp(params, *target)
    icp.align(*source)
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        icp.align(*source)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        icp.align(*source)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(torch, prof)
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    k4 = [e.time_range.elapsed_us() for e in events if "nn_banded" in e.name]
    host_events = [e.name for e in prof.events() if e.device_type != torch.autograd.DeviceType.CUDA]
    iters = params.max_iterations
    return {
        "host_ms_per_align": sorted(host)[1],
        "iterations": iters,
        "resorts": icp.last_resorts,
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "device_activities_per_iteration": len(events) / iters,
        "k4_device_us_per_launch": sum(k4) / max(len(k4), 1),
        "k4_launches": len(k4),
        "host_syncs_per_iteration": sum(n == "aten::_local_scalar_dense" for n in host_events) / iters,
        "stream_syncs_per_iteration": sum(n in ("cudaStreamSynchronize", "cudaDeviceSynchronize")
                                          for n in host_events) / iters,
    }


def profile_frames(torch, dataset, builder, params) -> dict:
    """Phase 5: host ms per phase (median over frames, each phase ended by a
    synchronise), then one profiled pass over the same frames for the
    device's busy time and the kernels' device time per launch."""
    from torch.profiler import ProfilerActivity, profile

    from align3d_torch.icp.multiscale import MultiscaleAlign

    frames = range(1, PROFILED_FRAMES + 1)
    phases = {"decode": [], "build": [], "bilateral filter": [], "icp": []}
    last = builder.build(dataset.get(0), DEVICE)
    for i in frames:
        t0 = time.perf_counter()
        frame = dataset.get(i)
        t1 = time.perf_counter()
        pyramid = builder.build(frame, DEVICE)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        MultiscaleAlign(params, last).align(pyramid)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        depth = torch.from_numpy(frame.image.depth.astype("int32")).to(DEVICE)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        builder.bilateral_filter.filter(depth)
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        for name, sec in zip(phases, (t1 - t0, t2 - t1, t5 - t4, t3 - t2)):
            phases[name].append(sec * 1e3)
        last = pyramid
    host = {name: sorted(ms)[len(ms) // 2] for name, ms in phases.items()}

    pyramids = [builder.build(dataset.get(i), DEVICE) for i in range(PROFILED_FRAMES + 1)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in frames:
            MultiscaleAlign(params, pyramids[i - 1]).align(builder.build(dataset.get(i), DEVICE))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(torch, prof)
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    kernel_us = {key: sum(e.time_range.elapsed_us() for e in events if any(k in e.name for k in KERNEL_NAMES[key]))
                 for key in ODOMETRY_KERNELS}
    kernel_launches = {key: sum(KERNEL_NAMES[key][0] in e.name for e in events) for key in ODOMETRY_KERNELS}
    n = len(frames)
    return {
        "host_ms_per_frame": host,
        "profiled_wall_ms_per_frame": wall_ms / n,
        "device_busy_ms_per_frame": busy_ms / n,
        "device_busy_share": busy_ms / wall_ms,
        "device_activities_per_frame": len(events) / n,
        "kernel_device_us_per_launch": {key: kernel_us[key] / max(kernel_launches[key], 1)
                                        for key in ODOMETRY_KERNELS},
        "kernel_launches_per_frame": {key: kernel_launches[key] / n for key in ODOMETRY_KERNELS},
    }


def check_probes(torch, rl) -> dict:
    """P1 and P2 against their twins at the roofline tool's sizes (a short
    step count for the twins); P2's library yardstick, ``torch.gather`` of
    the hbm mode's indices from the same table."""
    p = rl.Probes(DEVICE)
    got, ref = rl.fma_chains(p.fma_x, 2), rl.fma_chains_plain(p.fma_x, 2)
    p1_rel = float(((got - ref).abs() / ref.abs()).max())

    def int_err(got, ref):
        return int((got.long() - ref.long()).abs().max())

    p2_errs = {"lane": int_err(rl.lane_gather(p.lane_x, p.lane_idx, 2), rl.lane_gather_plain(p.lane_x, p.lane_idx, 2))}
    p2_errs.update({mode: int_err(rl.table_gather(t, p.table_x, 1), rl.table_gather_plain(t, p.table_x, 1))
                    for mode, t in p.tables.items()})
    print(f"P1 FMA chains: max relative |kernel - plain| {p1_rel:.2e}; P2 max |kernel - plain|: "
          + ", ".join(f"{m} {v}" for m, v in p2_errs.items()))
    if not (p1_rel <= FMA_RTOL and not any(p2_errs.values())):
        raise AssertionError("a roofline probe differs from its plain twin")
    # The twins and the library call at the sizes the tool times the kernels
    # (CUDA events around one call; the FMA twin is ~135k launches).
    steps = rl.TABLE_STEPS["hbm"]
    table = p.tables["hbm"]
    idx = rl.table_indices(p.table_n, steps, table.numel(), DEVICE).reshape(-1)
    gather_ms = rl.time_ms(lambda: torch.gather(table, 0, idx), reps=5)
    del idx
    p1_plain_ms = rl.time_ms(lambda: rl.fma_chains_plain(p.fma_x, rl.FMA_STEPS), reps=1, warmup=0)
    p2_plain_ms = rl.time_ms(lambda: rl.table_gather_plain(table, p.table_x, steps), reps=1, warmup=1)
    del p
    return {"p1_max_rel_err": p1_rel, "p2_max_abs_err": max(p2_errs.values()), "p2_errs": p2_errs,
            "p2_library_ms": gather_ms, "p1_plain_ms": p1_plain_ms,
            "p2_plain_ms": p2_plain_ms}


def check_batched_bilateral(torch, bil, real, mixed) -> dict:
    """K2 and K3 (both forms) over the 65 sample1 frames of the throughput
    series, one launch each, bitwise against 65 single-frame launches, K2
    and K3's form (b) bitwise against their plain twins; K2 (bitwise) and K3
    (form (b) bitwise) over the sample2 frames of the mixed series (gd >
    128) against their plain twins."""
    from align3d_torch.tools.roofline import time_ms
    from align3d_torch.tools.series import bucket_plan

    filt = bil.BilateralFilter()
    depths = torch.from_numpy(real.depths.astype("int32")).to(DEVICE)
    cmin, cmax = bil.nonzero_min_max(depths)
    gd = max(bil.true_depth(lo, hi, filt.sigma_color) for lo, hi in zip(cmin.tolist(), cmax.tolist()))
    gh, gw = bil._grid_dims(*depths.shape[-2:], filt.sigma_space)
    splat_args = (depths, cmin, (gh, gw, gd), filt.sigma_space, filt.sigma_color)
    grids = bil._splat(*splat_args)
    ref = bil._splat_plain(*splat_args)
    splat_plain, splat_err = torch.equal(grids, ref), float((grids - ref).abs().max())
    del ref
    splat_lib = library_splat(torch, bil, depths, cmin, (gh, gw, gd), filt, grids, n=10)
    blurred = bil._blur(grids, gd)
    norm = bil._normalize(blurred)
    slice_args = (norm, depths, cmin, filt.sigma_space, filt.sigma_color)
    sliced = bil._slice(*slice_args)
    slice_err = float((sliced - bil._slice_plain(*slice_args)).abs().max())
    slice_lib = library_slice(torch, norm, depths, cmin, filt, sliced, n=10)
    fused_args = (blurred, depths, cmin, filt.sigma_space, filt.sigma_color)
    fused = bil._normalize_slice(*fused_args)
    fused_err = int((fused - bil._normalize_slice_plain(*fused_args)).abs().max())
    fused_same = fused_err == 0 and torch.equal(fused, sliced.to(torch.int32))
    # The twins at this shape, CUDA events around one call each.
    splat_plain_ms = time_ms(lambda: bil._splat_plain(*splat_args), reps=1, warmup=0)
    slice_plain_ms = time_ms(lambda: bil._slice_plain(*slice_args), reps=1, warmup=0)
    fused_plain_ms = time_ms(lambda: bil._normalize_slice_plain(*fused_args), reps=1, warmup=0)
    same_splat = all(torch.equal(bil._splat(depths[b], int(cmin[b]), (gh, gw, gd), filt.sigma_space,
                                            filt.sigma_color), grids[b]) for b in range(len(depths)))
    same_slice = all(torch.equal(bil._slice(norm[b].contiguous(), depths[b], int(cmin[b]), filt.sigma_space,
                                            filt.sigma_color), sliced[b]) for b in range(len(depths)))
    same_fused = all(torch.equal(bil._normalize_slice(blurred[b].contiguous(), depths[b], int(cmin[b]),
                                                      filt.sigma_space, filt.sigma_color), fused[b])
                     for b in range(len(depths)))
    splat_ms, splat_call_ms = timings(torch, lambda: bil._splat(*splat_args), n=10, kernel=KERNEL_NAMES["splat"][0])
    slice_ms, slice_call_ms = timings(torch, lambda: bil._slice(*slice_args), n=10, kernel=KERNEL_NAMES["slice"][0])
    fused_ms, fused_call_ms = timings(torch, lambda: bil._normalize_slice(*fused_args), n=10,
                                      kernel=KERNEL_NAMES["slice"][0])
    cells = sampled_cells(torch, bil, depths, cmin, gh, gw, gd, filt)
    # At this size a call outlasts its dispatch, so the CUDA-event time per
    # call of back-to-back calls checks the profiler's device time.
    print(f"K2/K3 over {len(depths)} frames, grid (2, {gh}, {gw}, {gd}): bitwise against single-frame launches: "
          f"splat {same_splat}, slice (a) {same_slice}, (b) {same_fused}; against the plain twins: K2 bitwise "
          f"{splat_plain}, K3 (a) max |kernel - plain| {slice_err}, (b) {fused_err} (bitwise (a) + the cast: "
          f"{fused_same}); device ms per launch (profiler / CUDA events) {splat_ms} / {splat_call_ms}, "
          f"(a) {slice_ms} / {slice_call_ms}, (b) {fused_ms} / {fused_call_ms}; "
          f"twins {splat_plain_ms} / {slice_plain_ms} / {fused_plain_ms}; index_add_ {splat_lib['library_ms']} / "
          f"{splat_lib['library_call_ms']} (max rel diff {splat_lib['library_max_rel_diff']}), grid_sample "
          f"{slice_lib['library_ms']} / {slice_lib['library_call_ms']} (max diff {slice_lib['library_max_abs_diff']})")
    if not (same_splat and same_slice and same_fused and splat_plain and fused_same and slice_err <= SLICE_ATOL):
        raise AssertionError("batched K2/K3 differ from single-frame launches or from their plain twins")
    del grids, blurred, norm, sliced, fused

    pick = [i for i, (name, _) in enumerate(mixed.frames) if name == "sample2"]
    deep = torch.from_numpy(mixed.depths[pick].astype("int32")).to(DEVICE)
    dmin, dmax = bil.nonzero_min_max(deep)
    dgd = max(bil.true_depth(lo, hi, filt.sigma_color) for lo, hi in zip(dmin.tolist(), dmax.tolist()))
    # K2 as the mixed series' step launches it: each deep bucket's frames at
    # the bucket's depth.
    mdepths = torch.from_numpy(mixed.depths.astype("int32")).to(DEVICE)
    mmin, _ = bil.nonzero_min_max(mdepths)
    deep_buckets = {}
    for g, idx, _ in bucket_plan(mixed.depths, filt):
        if g > 128:
            sub = torch.from_numpy(idx.astype("int64")).to(DEVICE)
            args = (mdepths[sub], mmin[sub], (gh, gw, g), filt.sigma_space, filt.sigma_color)
            deep_buckets[g] = (len(idx), torch.equal(bil._splat(*args), bil._splat_plain(*args)))
    del mdepths
    dblur = bil._blur(bil._splat(deep, dmin, (gh, gw, dgd), filt.sigma_space, filt.sigma_color), dgd)
    dargs = (dblur, deep, dmin, filt.sigma_space, filt.sigma_color)
    deep_fused = torch.equal(bil._normalize_slice(*dargs), bil._normalize_slice_plain(*dargs))
    dnorm = bil._normalize(dblur)
    del dblur, dargs
    got = bil._slice(dnorm, deep, dmin, filt.sigma_space, filt.sigma_color)
    ref = bil._slice_plain(dnorm, deep, dmin, filt.sigma_space, filt.sigma_color)
    err = float((got - ref).abs().max())
    print("K2 over the mixed series' deep buckets, bitwise against its plain twin: "
          + ", ".join(f"gd {g} x {n} frames {same}" for g, (n, same) in deep_buckets.items())
          + f"; K3 over {len(deep)} sample2 frames at gd {dgd}: form (a) max |kernel - plain| {err}, "
          f"form (b) bitwise {deep_fused}")
    if not (deep_buckets and all(same for _, same in deep_buckets.values())):
        raise AssertionError("K2 over the mixed series' deep buckets differs from its plain twin")
    if not (dgd > 128 and len(deep) >= 3 and err <= SLICE_ATOL and deep_fused):
        raise AssertionError("K3 at B >= 3, gd > 128 differs from its plain twin")
    return {"batch": len(depths), "gd": gd, "splat_ms": splat_ms, "slice_ms": slice_ms, "slice_cells": cells,
            "fused_ms": fused_ms, "fused_call_ms": fused_call_ms, "fused_plain_ms": fused_plain_ms,
            "fused_max_abs_err": fused_err, "deep_fused_bitwise_plain": deep_fused,
            "splat_call_ms": splat_call_ms, "slice_call_ms": slice_call_ms,
            "splat_plain_ms": splat_plain_ms, "slice_plain_ms": slice_plain_ms, "slice_max_abs_err": slice_err,
            "splat_max_abs_err": splat_err,
            "splat_ms_per_frame": splat_ms / len(depths) if splat_ms else None,
            "slice_ms_per_frame": slice_ms / len(depths) if slice_ms else None,
            "splat_bitwise_plain": splat_plain, "deep_splat_bitwise_plain": {g: s for g, (_, s) in deep_buckets.items()},
            "deep_batch": len(deep), "deep_gd": dgd, "deep_max_abs_err": err,
            "splat_library": splat_lib, "slice_library": slice_lib}


def relative_errors(torch, TransformMetrics, rel, gt):
    """Per pair: angle (deg) and translation error of relative poses."""
    m = TransformMetrics.new(rel, gt)
    return torch.rad2deg(m.angle), m.translation


def relative_poses(traj):
    """Each pair's relative pose back from a trajectory built by the left
    fold ``P_i+1 = T_i @ P_i`` (trajectory.py): ``T_i = P_i+1 @ P_i^-1``."""
    pose = traj.camera_to_world
    return pose[1:] @ pose[:-1].inverse()


def series_inputs(torch, s):
    return (torch.from_numpy(s.colors).to(DEVICE), torch.from_numpy(s.depths.astype("int32")).to(DEVICE),
            torch.from_numpy(s.depth_scales).to(DEVICE))


def reset_counts(counters: dict) -> None:
    """``counters``: name -> (module, attribute) of a launch count."""
    for module, attr in counters.values():
        setattr(module, attr, 0)


def read_counts(counters: dict) -> dict:
    return {name: getattr(module, attr) for name, (module, attr) in counters.items()}


def throughput_path(torch, real, mixed, counters) -> dict:
    """Phase 4d: ``odometry_step`` on the 64-pair real series, bilateral off
    and bucketed on, then the mixed series; the checks of the module
    docstring. ``counters``: name -> (module, attribute) of launch counts."""
    from align3d_torch.icp.image_icp import prepack_batched
    from align3d_torch.icp.multiscale import MultiscaleAlign
    from align3d_torch.icp.params import MsIcpParams
    from align3d_torch.metrics import TransformMetrics
    from align3d_torch.ops import bilateral as bil
    from align3d_torch.ops import icp_fused
    from align3d_torch.parallel import batch as pb
    from align3d_torch.se3 import Transform
    from align3d_torch.tools.roofline import time_ms
    from align3d_torch.tools.series import bucket_plan

    params = MsIcpParams.default()
    filt = bil.BilateralFilter()
    colors, depths, scales = series_inputs(torch, real)
    out = {}
    trajs = {}
    for label, f in (("off", None), ("on", filt)):
        reset_counts(counters)
        traj = pb.odometry_step(real.camera, scales, colors, depths, params, bilateral_filter=f, device=DEVICE)
        torch.cuda.synchronize()
        launches = read_counts(counters)
        plan = bucket_plan(real.depths, filt)
        want = {"icp": STEP_ITERATIONS, "splat": len(plan) if f else 0, "slice": len(plan) if f else 0,
                "slice_a": 0, "normalize": 0}
        print(f"throughput path, bilateral {label}: launches {launches} (expected {want}; buckets "
              + ", ".join(f"{g}x{len(i)}" for g, i, _ in plan) + ")")
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"throughput path launches {launches}, expected {want}")
        rel = relative_poses(traj)
        ang, tr = relative_errors(torch, TransformMetrics, rel, real.relative_ground_truth().to(DEVICE))
        print(f"  {len(real) - 1} pairs against ground truth: mean {float(ang.mean()):.4f} deg / {float(tr.mean()):.6f}, "
              f"max {float(ang.max()):.4f} deg / {float(tr.max()):.6f}")
        if not (float(ang.mean()) < MEAN_ANGLE_DEG and float(tr.mean()) < MEAN_TRANS):
            raise AssertionError(f"bilateral {label}: the pairs' mean error is above 0.5 deg / 0.01")
        if not (torch.isfinite(traj.camera_to_world.rotation).all() and torch.isfinite(traj.camera_to_world.translation).all()):
            raise AssertionError("non-finite poses in the throughput path")
        out[f"bilateral_{label}"] = {"launches": launches, "mean_deg": float(ang.mean()), "mean_trans": float(tr.mean()),
                                     "max_deg": float(ang.max()), "max_trans": float(tr.max())}
        trajs[label] = traj
    again = pb.odometry_step(real.camera, scales, colors, depths, params, bilateral_filter=filt, device=DEVICE)
    a, b = trajs["on"].camera_to_world, again.camera_to_world
    out["rerun_bitwise"] = torch.equal(a.rotation, b.rotation) and torch.equal(a.translation, b.translation)
    print(f"  rerun bitwise identical: {out['rerun_bitwise']}")
    if not out["rerun_bitwise"]:
        raise AssertionError("two runs of the throughput path differ")

    # The stages of the step (bilateral off), against B = 1 and the sequential align.
    pyramid = pb.build_pyramids_batched(real.camera, scales, colors, depths)
    src = [lv.frames(slice(1, None)) for lv in pyramid]
    tgt = [lv.frames(slice(None, -1)) for lv in pyramid]
    rel = pb.multiscale_align_batched(tgt, src, params)
    scanned = pb.accumulate_scan(rel).camera_to_world
    same_step = torch.equal(scanned.rotation, trajs["off"].camera_to_world.rotation)
    s0, t0 = src[0], tgt[0]
    pairs, n = len(real) - 1, t0.height * t0.width
    packed = prepack_batched(s0.points.reshape(pairs, n, 3), s0.mask.reshape(pairs, n),
                             s0.intensities.reshape(pairs, n), t0.points.reshape(pairs, n, 3),
                             t0.mask.reshape(pairs, n), t0.normals.reshape(pairs, n, 3), t0.intensity_map)
    rot, trans = rel.rotation.contiguous(), rel.translation.contiguous()
    blocks = icp_fused.icp_step_fused(rot, trans, *packed, t0.intrinsics, params[0])
    k1_same = all(torch.equal(icp_fused.icp_step_fused(rot[b:b + 1], trans[b:b + 1], *(t[b:b + 1] for t in packed[:5]),
                                                       *packed[5:], t0.intrinsics, params[0])[0], blocks[b])
                  for b in range(pairs))
    # K1 at B = 64 against its twin, at the converged poses moved by phase 3's
    # twist. At the converged poses themselves g and sum w r^2 sink to float32
    # rounding noise (the palindrome's turn pairs a frame with itself), and
    # there the kernel and the twin each differ more from a float64 step than
    # from each other.
    moved = Transform.exp(torch.tensor(K1_TWIST, device=DEVICE)) @ rel
    margs = (moved.rotation.contiguous(), moved.translation.contiguous(), *packed, t0.intrinsics, params[0])
    k1_plain_rel = check_icp_blocks(torch, icp_fused.icp_step_fused(*margs), icp_fused.icp_step_plain(*margs),
                                    packed[1], f"K1 at B = {pairs}")
    out["k1_batch64_plain_ms"] = time_ms(lambda: icp_fused.icp_step_plain(*margs), reps=1, warmup=0)
    seq = [MultiscaleAlign(params, [lv.frames(b) for lv in tgt]).align([lv.frames(b) for lv in src])
           for b in range(pairs)]
    seq_rot = torch.stack([t.rotation for t in seq])
    seq_trans = torch.stack([t.translation for t in seq])
    bitwise = [bool(torch.equal(seq_rot[b], rel.rotation[b]) and torch.equal(seq_trans[b], rel.translation[b]))
               for b in range(pairs)]
    d = TransformMetrics.new(Transform(seq_rot, seq_trans), rel)
    out["k1_batch64_bitwise_b1"] = k1_same
    out["k1_batch64_max_rel_err_plain"] = k1_plain_rel
    out["stages_equal_step"] = same_step
    out["batched_vs_sequential"] = {"bitwise_pairs": sum(bitwise), "max_rad": float(d.angle.max()),
                                    "max_m": float(d.translation.max()),
                                    "max_abs_r": float((seq_rot - rel.rotation).abs().max()),
                                    "max_abs_t": float((seq_trans - rel.translation).abs().max())}
    print(f"  K1 blocks at B = {pairs} bitwise their B = 1 blocks: {k1_same}; within {k1_plain_rel:.2e} "
          f"relative of the plain twin at the moved poses; step == its stages: {same_step}; "
          f"batched vs sequential MultiscaleAlign: {out['batched_vs_sequential']}")
    if not (k1_same and same_step and sum(bitwise) == pairs):
        raise AssertionError("the batched align differs from B = 1 or from the sequential align")
    del pyramid, src, tgt, packed, margs, seq

    # The mixed series: buckets of very different depth.
    mcolors, mdepths, mscales = series_inputs(torch, mixed)
    filtered, plan = pb.filter_buckets(filt, mdepths)
    cmin, cmax = bil.nonzero_min_max(mdepths)
    per_frame = all(torch.equal(filt.filter_static(mdepths[b], int(cmin[b]), g, g), filtered[b])
                    for b, g in ((b, bil.true_depth(int(cmin[b]), int(cmax[b]), filt.sigma_color))
                                 for b in range(len(mdepths))))
    reset_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    mtraj = pb.odometry_step(mixed.camera, mscales, mcolors, mdepths, params, bilateral_filter=filt, device=DEVICE)
    torch.cuda.synchronize()
    mlaunch = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    mrel = relative_poses(mtraj)
    true = torch.from_numpy(mixed.true_pairs()).to(DEVICE)
    ang, tr = relative_errors(torch, TransformMetrics, mrel, mixed.relative_ground_truth().to(DEVICE))
    out["mixed"] = {"buckets": [(g, len(i)) for g, i, _ in plan], "launches": mlaunch, "max_memory_allocated_bytes": peak,
                    "per_frame_bitwise": per_frame, "true_pairs": int(true.sum()),
                    "mean_deg": float(ang[true].mean()), "mean_trans": float(tr[true].mean()),
                    "max_deg": float(ang[true].max()), "max_trans": float(tr[true].max())}
    print(f"  mixed series: {out['mixed']}")
    if not (len(plan) >= 2 and per_frame and mlaunch["icp"] == STEP_ITERATIONS
            and mlaunch["splat"] == mlaunch["slice"] == len(plan) and mlaunch["slice_a"] == mlaunch["normalize"] == 0
            and out["mixed"]["mean_deg"] < MEAN_ANGLE_DEG and out["mixed"]["mean_trans"] < MEAN_TRANS):
        raise AssertionError("the mixed series failed its checks")
    return out


def profile_step(torch, real) -> dict:
    """Phase 5 for the 64-pair step: host ms per pair (median of 3, ended by
    a synchronise), bilateral off and on; one profiled step for the device's
    busy share, activities per GN iteration and K1's device time per launch;
    the peak device memory of each."""
    from torch.profiler import ProfilerActivity, profile

    from align3d_torch.icp.params import MsIcpParams
    from align3d_torch.ops.bilateral import BilateralFilter
    from align3d_torch.parallel import batch as pb

    params = MsIcpParams.default()
    colors, depths, scales = series_inputs(torch, real)
    pairs = len(real) - 1
    out = {}
    for label, f in (("off", None), ("on", BilateralFilter())):
        def step():
            return pb.odometry_step(real.camera, scales, colors, depths, params, bilateral_filter=f, device=DEVICE)

        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        host = []
        for _ in range(3):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = device_events(torch, prof)
        busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
        k1 = [e for e in events if any(k in e.name for k in KERNEL_NAMES["icp"])]
        k1_launches = sum(KERNEL_NAMES["icp"][0] in e.name for e in events)
        out[f"bilateral_{label}"] = {
            "host_ms_per_step": sorted(host)[1], "host_ms_per_pair": sorted(host)[1] / pairs,
            "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
            "device_activities": len(events), "device_activities_per_gn_iteration": len(events) / STEP_ITERATIONS,
            "k1_device_us_per_launch": sum(e.time_range.elapsed_us() for e in k1) / max(k1_launches, 1),
            "k1_launches": k1_launches, "max_memory_allocated_bytes": peak,
        }
    return out


def write_png16(path: Path, depth) -> None:
    """A 16-bit grayscale PNG of ``depth`` (u16), every row filter type 0."""
    import struct
    import zlib

    h, w = depth.shape
    rows = depth.astype(">u2").view("u1").reshape(h, w * 2)
    raw = b"".join(b"\x00" + row.tobytes() for row in rows)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw))
                     + chunk(b"IEND", b""))


def make_tum_tree(base: Path, dataset, Trajectory, frames: list[int]) -> Path:
    """Sample1's frames ``frames`` (in that order, repeats allowed) at
    640x480 as a TUM tree: the RGB PNGs copied, the depth rewritten at
    1/5000 m, ``groundtruth.txt`` by ``Trajectory.to_tum``. Timestamps are
    staggered as in ``tests/_dataset_fixtures.py``: the k-th depth at 10 +
    0.1k, its RGB 15 ms later, ground truth 5 ms earlier, one stray RGB
    (9.5 s) and one stray depth (99 s) that the association drops."""
    import shutil

    import numpy as np

    from align3d_torch.io.datasets import SubsetDataset
    from align3d_torch.io.datasets.core import load_depth_u16

    (base / "rgb").mkdir(parents=True)
    (base / "depth").mkdir()
    rgb_rows, depth_rows = ["# color images", "9.500000 rgb/stray.png"], ["# depth images"]
    shutil.copy(SAMPLE1 / dataset.rgb_images[0], base / "rgb" / "stray.png")
    for k, index in enumerate(frames):
        t = 10.0 + 0.1 * k
        depth = load_depth_u16(SAMPLE1 / dataset.depth_images[index]).astype(np.int64) * TUM_DEPTH_FACTOR
        if depth.max() > np.iinfo(np.uint16).max:
            raise RuntimeError(f"frame {index}: depth {depth.max()} does not fit in u16 at 1/5000 m")
        write_png16(base / "depth" / f"{t:.6f}.png", depth.astype(np.uint16))
        shutil.copy(SAMPLE1 / dataset.rgb_images[index], base / "rgb" / f"{t + 0.015:.6f}.png")
        rgb_rows.append(f"{t + 0.015:.6f} rgb/{t + 0.015:.6f}.png")
        depth_rows.append(f"{t:.6f} depth/{t:.6f}.png")
    shutil.copy(base / "depth" / f"{10.0:.6f}.png", base / "depth" / "stray.png")
    depth_rows.append("99.000000 depth/stray.png")
    gt = SubsetDataset(dataset, frames).trajectory()  # times 0..len - 1
    gt = Trajectory(gt.camera_to_world, gt.times * 0.1 + (10.0 - 0.005))
    (base / "rgb.txt").write_text("\n".join(rgb_rows) + "\n")
    (base / "depth.txt").write_text("\n".join(depth_rows) + "\n")
    (base / "groundtruth.txt").write_text("# ground truth trajectory\n" + gt.to_tum())
    return base


def data_path(torch, dataset, builder, counters, slamtb_launches: dict) -> dict:
    """Phase 7: the port's data path on the card over a 640x480 TUM tree made
    from sample1: the command line cut at ``TUM_CUT`` frames with a
    checkpoint, resumed to ``FRAMES``, against one uninterrupted run
    (bitwise); the same frames prefetched against plain (bitwise); decode
    ms per frame of each decoder; the kernels' launches per run; and
    ``RgbdFrame.downsample`` on the card against the CPU."""
    import tempfile

    import numpy as np

    from align3d_torch import cli
    from align3d_torch.checkpoint import load_odometry
    from align3d_torch.icp.params import MsIcpParams
    from align3d_torch.io import native_loader, png
    from align3d_torch.io.datasets import TumRgbdDataset
    from align3d_torch.io.datasets.core import PrefetchingDataset, maybe_prefetch
    from align3d_torch.odometry import run_odometry
    from align3d_torch.trajectory import Trajectory

    def expected(frames_built: int, pairs: int) -> dict:
        return {"icp": STEP_ITERATIONS * pairs, "splat": frames_built, "slice": frames_built, "slice_a": 0,
                "normalize": 0}

    def run_timed(ds):
        """run_odometry over the first FRAMES frames; host ms of each frame
        after the first, from the progress callback."""
        stamps = [time.perf_counter()]
        result = run_odometry(ds, DEVICE, range_builder=builder, icp_params=MsIcpParams.default(),
                              max_frames=FRAMES, progress=lambda i, n: stamps.append(time.perf_counter()))
        per_frame = sorted((b - a) * 1e3 for a, b in zip(stamps[1:-1], stamps[2:]))
        return result, per_frame[len(per_frame) // 2]

    out = {"native_loader": native_loader.available(), "native_unavailable_reason": native_loader.unavailable_reason()}
    with tempfile.TemporaryDirectory() as tmp:
        tree = make_tum_tree(Path(tmp) / "tum", dataset, Trajectory, list(range(FRAMES)))
        tum = TumRgbdDataset.load(str(tree))
        if len(tum) != FRAMES or any("stray" in f for f in tum.rgb_images + tum.depth_images):
            raise RuntimeError(f"the TUM association kept {len(tum)} frames: {tum.rgb_images}")
        ck, saved = Path(tmp) / "odometry.npz", Path(tmp) / "resumed.tum"

        # The command line: a cut run, then the resume to FRAMES frames.
        argv = ["odometry", "tum", str(tree), "--checkpoint", str(ck), "--checkpoint-every", str(TUM_EVERY), "-q",
                "--device", DEVICE]
        runs = {}
        for name, frames, extra in (("cut", TUM_CUT, []), ("resumed", FRAMES, ["--save-trajectory", str(saved)])):
            reset_counts(counters)
            if cli.main(argv[:3] + [str(frames)] + argv[3:] + extra) != 0:
                raise RuntimeError(f"the {name} TUM run exited non-zero")
            runs[name] = read_counts(counters)
        want = {"cut": expected(TUM_CUT, TUM_CUT - 1), "resumed": expected(FRAMES - TUM_CUT + 1, FRAMES - TUM_CUT)}
        resumed, next_frame = load_odometry(str(ck))

        # One uninterrupted run, plain; then the same frames prefetched.
        reset_counts(counters)
        plain, plain_ms = run_timed(TumRgbdDataset.load(str(tree)))
        runs["uninterrupted"] = read_counts(counters)
        want["uninterrupted"] = expected(FRAMES, FRAMES - 1)
        pre = maybe_prefetch(TumRgbdDataset.load(str(tree)))
        if isinstance(pre, PrefetchingDataset) != out["native_loader"]:
            raise RuntimeError(f"maybe_prefetch gave {type(pre).__name__} with the native loader "
                               f"{'built' if out['native_loader'] else 'unavailable'}")
        waits = []
        if isinstance(pre, PrefetchingDataset):
            get = pre.loader.get

            def timed_get(i):
                t0 = time.perf_counter()
                frame = get(i)
                waits.append((time.perf_counter() - t0) * 1e3)
                return frame

            pre.loader.get = timed_get
        try:
            fetched, fetched_ms = run_timed(pre)
        finally:
            if isinstance(pre, PrefetchingDataset):
                pre.close()

        # Decode ms per frame (colour + depth) of each decoder, host clock.
        colors, depths = tum.frame_paths()
        decoders = {"png.py": (png.read, png.read)}
        if out["native_loader"]:
            decoders["native single-shot"] = (native_loader.decode_rgb, native_loader.decode_depth)
        decode = {}
        for name, (read_rgb, read_depth) in decoders.items():
            t0 = time.perf_counter()
            for c, d in zip(colors, depths):
                read_rgb(c), read_depth(d)
            decode[name] = (time.perf_counter() - t0) * 1e3 / len(colors)
        if waits:
            decode["prefetcher wait in get"] = sorted(waits)[len(waits) // 2]
        saved_text = saved.read_text()

    traj = plain.trajectory
    a, b, f = traj.camera_to_world, resumed.camera_to_world, fetched.trajectory.camera_to_world
    out["resumed_next_frame"] = next_frame
    out["resumed_bitwise_uninterrupted"] = (torch.equal(a.rotation.cpu(), b.rotation) and
                                            torch.equal(a.translation.cpu(), b.translation) and
                                            torch.equal(traj.times.cpu(), resumed.times))
    out["resumed_tum_text_equal"] = saved_text == traj.to_tum()
    out["prefetched_bitwise_plain"] = torch.equal(a.rotation, f.rotation) and torch.equal(a.translation, f.translation)
    out["launches"] = runs
    out["launches_expected"] = want
    out["slamtb_launches_same_length"] = slamtb_launches
    out["error_vs_ground_truth"] = {"angle_deg": math.degrees(float(plain.metrics.angle)),
                                    "translation": float(plain.metrics.translation)}
    out["finite"] = bool(torch.isfinite(a.rotation).all() and torch.isfinite(a.translation).all())
    out["decode_ms_per_frame"] = decode
    out["odometry_host_ms_per_frame_median"] = {"plain": plain_ms, "prefetched": fetched_ms}

    # RgbdFrame.downsample on the card against the CPU, sample1 frame 0.
    frame = dataset.get(0)
    on_card, on_cpu = frame.downsample(1.0, device=DEVICE), frame.downsample(1.0, device="cpu")
    color_diff = np.abs(on_card.image.color.astype(int) - on_cpu.image.color.astype(int))
    out["downsample"] = {"depth_bitwise": bool(np.array_equal(on_card.image.depth, on_cpu.image.depth)),
                         "color_max_diff": int(color_diff.max()), "color_pixels_off": int((color_diff > 0).sum()),
                         "color_share_off": float((color_diff > 0).mean()),
                         "camera_equal": on_card.camera == on_cpu.camera}
    return out


def ba_intrinsics():
    """The camera of tests/test_bundle_adjustment.py."""
    from align3d_torch.camera import CameraIntrinsics

    return CameraIntrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)


def ring_graph(torch, pg, n: int, seed: int = 3):
    """``tests/test_pose_graph.py::test_cg_long_sequence_scales``'s graph,
    built on the CPU: ``n`` poses on a circle, odometry with 0.01 twist
    noise a step, exact closures (0, n // 2) and (0, n - 1) at weight 10.
    Returns (graph, ground-truth poses)."""
    import numpy as np

    from align3d_torch import se3
    from align3d_torch.se3 import Transform
    from align3d_torch.trajectory import Trajectory

    rng = np.random.default_rng(seed)
    step = Transform.exp(torch.tensor([0.1, 0.0, 0.0, 0.0, 0.0, 2 * math.pi / n]))
    gt = [Transform.identity()]
    for _ in range(n - 1):
        gt.append(gt[-1] @ step)
    est = [gt[0]]
    for k in range(n - 1):
        noise = Transform.exp(torch.from_numpy(rng.normal(0, 0.01, 6).astype(np.float32)))
        est.append(est[-1] @ ((gt[k].inverse() @ gt[k + 1]) @ noise))
    graph = pg.PoseGraph.from_trajectory(Trajectory(se3.stack(est), torch.arange(n, dtype=torch.float32)))
    for j in (n // 2, n - 1):
        graph = graph.with_edge(0, j, gt[0].inverse() @ gt[j], 10.0)
    return graph, se3.stack(gt)


def graph_to(pg, graph, device):
    return pg.PoseGraph(graph.nodes.to(device), graph.edges.to(device), graph.measurements.to(device),
                        graph.weights.to(device))


def problem_to(problem, device):
    import dataclasses

    return dataclasses.replace(
        problem, poses=problem.poses.to(device), landmarks=problem.landmarks.to(device),
        obs_pose=problem.obs_pose.to(device), obs_landmark=problem.obs_landmark.to(device),
        obs_uv=problem.obs_uv.to(device), weights=problem.weights.to(device),
        obs_z=None if problem.obs_z is None else problem.obs_z.to(device))


def ba_large(torch, ba, n: int, m: int, o: int, seed: int = 11):
    """``tests/test_bundle_adjustment.py::test_coo_large_problem_scales``'s
    problem, built on the CPU: ``n`` poses of a random walk, ``m``
    landmarks moved by 5 cm, ``o`` exact (u, v, z) observations of random
    (pose, landmark) pairs."""
    import numpy as np

    from align3d_torch import se3
    from align3d_torch.se3 import Transform

    intr = ba_intrinsics()
    rng = np.random.default_rng(seed)
    landmarks_gt = torch.from_numpy(rng.uniform([-4, -4, 2.0], [4, 4, 8.0], (m, 3)).astype(np.float32))
    poses = [Transform.identity()]
    for _ in range(n - 1):
        poses.append(poses[-1] @ Transform.exp(torch.from_numpy(rng.normal(0, 0.01, 6).astype(np.float32))))
    poses_gt = se3.stack(poses)
    obs_pose = torch.from_numpy(rng.integers(0, n, o))
    obs_landmark = torch.from_numpy(rng.integers(0, m, o))
    p_cam = poses_gt[obs_pose].inverse().apply(landmarks_gt[obs_landmark])
    z = p_cam[:, 2]
    u = p_cam[:, 0] * intr.fx / z + intr.cx
    v = p_cam[:, 1] * intr.fy / z + intr.cy
    noise = torch.from_numpy(rng.normal(0, 0.05, (m, 3)).astype(np.float32))
    return ba.BAProblem(poses_gt, landmarks_gt + noise, obs_pose, obs_landmark, torch.stack([u, v], dim=1),
                        torch.ones(o), intr, obs_z=z)


def ba_scene(torch, ba, n: int = 6, m: int = 40, seed: int = 0):
    """``tests/test_bundle_adjustment.py::_synthetic_problem``'s scene, built
    on the CPU: every landmark seen by every pose, poses moved by 0.02 and
    landmarks by 0.05 (pose 0 the gauge). Returns (problem, poses_gt,
    landmarks_gt)."""
    import numpy as np

    from align3d_torch.se3 import Transform

    intr = ba_intrinsics()
    rng = np.random.default_rng(seed)
    landmarks_gt = torch.from_numpy(np.concatenate(
        [rng.uniform(-1.0, 1.0, (m, 2)), rng.uniform(2.0, 4.0, (m, 1))], axis=1).astype(np.float32))
    twists = rng.normal(0.0, 0.03, (n, 6)).astype(np.float32)
    twists[:, :3] *= 2.0
    twists[0] = 0.0
    poses_gt = Transform.exp(torch.from_numpy(twists))
    p_cam = poses_gt.inverse()[:, None].apply(landmarks_gt[None])  # (n, m, 3)
    uv = torch.stack([p_cam[..., 0] * intr.fx / p_cam[..., 2] + intr.cx,
                      p_cam[..., 1] * intr.fy / p_cam[..., 2] + intr.cy], dim=-1)
    noise = rng.normal(0.0, 0.02, (n, 6)).astype(np.float32)
    noise[0] = 0.0
    poses0 = poses_gt @ Transform.exp(torch.from_numpy(noise))
    landmarks0 = landmarks_gt + torch.from_numpy(rng.normal(0.0, 0.05, (m, 3)).astype(np.float32))
    problem = ba.BAProblem(poses0, landmarks0, torch.arange(n).repeat_interleave(m), torch.arange(m).repeat(n),
                           uv.reshape(-1, 2), torch.ones(n * m), intr, obs_z=p_cam[..., 2].reshape(-1))
    return problem, poses_gt, landmarks_gt


def max_pose_gap(torch, a, b) -> float:
    """Largest elementwise |difference| of two batched Transforms' rotations and translations."""
    return max(float((a.rotation.cpu() - b.rotation.cpu()).abs().max()),
               float((a.translation.cpu() - b.translation.cpu()).abs().max()))


def pose_err(torch, a, b) -> float:
    """``tests/test_pose_graph.py::_pose_err``: the largest |log(a^-1 b)|."""
    return float(torch.linalg.norm((a.inverse() @ b).log(), dim=-1).max())


def host_ms(torch, fn, runs: int = 3) -> tuple[float, object]:
    """Median host ms of ``runs`` calls of ``fn``, each ended by a
    synchronise, and the last call's result."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2], out


def device_profile(torch, fn) -> dict:
    """One ``fn()`` under ``torch.profiler`` (device activity only: a solve
    issues ~10^5 launches): its device-busy ms and activities, beside the
    profiled wall ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(torch, prof)
    return {"device_busy_ms": sum(e.time_range.elapsed_us() for e in events) / 1e3,
            "device_activities": len(events), "profiled_wall_ms": wall_ms}


def solver_profile(torch, run, trips: int) -> dict:
    """Host ms (median of 3), device busy ms, activities and peak memory of
    one solve, ``run(cg_iters)``; per PCG trip, the difference against the
    same solve with no trips, over ``trips``."""
    host, _ = host_ms(torch, lambda: run(None))
    torch.cuda.reset_peak_memory_stats()
    run(None)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    full, zero = device_profile(torch, lambda: run(None)), device_profile(torch, lambda: run(0))
    host_zero, _ = host_ms(torch, lambda: run(0))
    return {"host_ms": host, **full, "peak_memory_bytes": peak,
            "per_pcg_trip": {
                "host_ms": (host - host_zero) / trips,
                "device_busy_ms": (full["device_busy_ms"] - zero["device_busy_ms"]) / trips,
                "device_activities": (full["device_activities"] - zero["device_activities"]) / trips},
            "without_pcg_trips": {"host_ms": host_zero, **zero}}


def syncs_in(torch, fn) -> dict:
    """The host synchronisations ``fn()`` makes, as
    ``set_sync_debug_mode("warn")`` reports them: their count, and for each
    the calls that led to it (the frames of this repository, then the
    innermost one)."""
    import traceback
    import warnings

    sites = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            stack = traceback.extract_stack()[:-1]
            ours = [f"{Path(f.filename).name}:{f.lineno}" for f in stack
                    if str(ROOT) in f.filename and not f.filename.endswith("chip_smoke.py")]
            sites.append(" > ".join(ours + [f"{Path(filename).parent.name}/{Path(filename).name}:{lineno}"]))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return {"count": len(sites), "sites": sorted(set(sites))}


def palindrome_path(torch, dataset, counters) -> tuple[dict, list]:
    """Phase 8a: ``tests/test_loop_closure_e2e.py`` on the card."""
    from align3d_torch.icp.params import MsIcpParams
    from align3d_torch.io.datasets import SubsetDataset
    from align3d_torch.odometry import refine_with_loop_closures, run_odometry
    from align3d_torch.parallel import pose_graph as pg

    ds = SubsetDataset(dataset, PALINDROME)
    last = len(PALINDROME) - 1
    cheap = MsIcpParams.default().customize(lambda _, p: p.replace(max_iterations=CHEAP_ITERATIONS))
    kwargs = {"min_separation": last - 1, "max_translation": 0.5, "max_candidates": 4, "closure_weight": 20.0}
    reset_counts(counters)
    t0 = time.perf_counter()
    raw = run_odometry(ds, DEVICE, icp_params=cheap)
    refined = refine_with_loop_closures(ds, raw, DEVICE, **kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    closures = pg.propose_loop_closures(raw.trajectory, **{k: kwargs[k] for k in kwargs if k != "closure_weight"})
    # K1 once a GN iteration: the cheap odometry's 3 levels x 2 iterations a
    # pair, and MsIcpParams.default()'s 70 a closure; no filter, so no K2/K3.
    want = {"icp": (len(PALINDROME) - 1) * 3 * CHEAP_ITERATIONS + STEP_ITERATIONS * len(closures),
            "splat": 0, "slice": 0, "slice_a": 0, "normalize": 0}
    raw_t, ref_t = float(raw.metrics.translation), float(refined.metrics.translation)
    raw_a, ref_a = math.degrees(float(raw.metrics.angle)), math.degrees(float(refined.metrics.angle))
    poses = refined.trajectory.camera_to_world
    gap = float(torch.linalg.norm((poses[0].inverse() @ poses[last]).log()))
    out = {"frames": PALINDROME, "closures": closures.tolist(), "launches": launches, "launches_expected": want,
           "ate_translation": {"odometry": raw_t, "refined": ref_t}, "ate_angle_deg": {"odometry": raw_a,
                                                                                       "refined": ref_a},
           "revisit_gap": gap, "wall_s": wall}
    failures = []
    if launches != want:
        failures.append(f"8a: launches {launches}, expected {want}")
    if not (ref_t < raw_t and ref_a < raw_a * 1.1 + 1e-3 and gap < 5e-3):
        failures.append(f"8a: the refined palindrome fails tests/test_loop_closure_e2e.py's gates: {out}")
    return out, failures


def loop_closure_cli(torch, dataset, counters) -> tuple[dict, list]:
    """Phase 8b: ``align3d_torch.cli odometry tum <tree> --loop-closure`` over
    the palindrome as a TUM tree (filter on, ``MsIcpParams.default()``),
    against ``run_odometry`` + ``refine_with_loop_closures`` called
    directly on the same tree."""
    import inspect
    import tempfile

    from align3d_torch import cli
    from align3d_torch.io.datasets import TumRgbdDataset
    from align3d_torch.odometry import refine_with_loop_closures, run_odometry
    from align3d_torch.ops.bilateral import BilateralFilter
    from align3d_torch.parallel import pose_graph as pg
    from align3d_torch.range_image import RangeImageBuilder
    from align3d_torch.trajectory import Trajectory

    with tempfile.TemporaryDirectory() as tmp:
        tree = make_tum_tree(Path(tmp) / "tum", dataset, Trajectory, PALINDROME)
        saved = Path(tmp) / "refined.tum"
        reset_counts(counters)
        t0 = time.perf_counter()
        rc = cli.main(["odometry", "tum", str(tree), "--loop-closure", "--save-trajectory", str(saved), "-q",
                       "--device", DEVICE])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(counters)
        text = saved.read_text()
        ds = TumRgbdDataset.load(str(tree))
        builder = RangeImageBuilder(bilateral_filter=BilateralFilter())
        raw = run_odometry(ds, DEVICE, range_builder=builder)
        direct = refine_with_loop_closures(ds, raw, DEVICE, range_builder=builder)
    n = len(PALINDROME)
    # The candidates refine_with_loop_closures proposes with its defaults, as the command line calls it.
    defaults = inspect.signature(refine_with_loop_closures).parameters
    closures = pg.propose_loop_closures(
        raw.trajectory, **{k: defaults[k].default for k in ("min_separation", "max_translation", "max_candidates")})
    # Every frame built once by odometry and two by each closure, each
    # build one K2 and one K3 (form (b)); 70 K1 a pair and a closure.
    want = {"icp": STEP_ITERATIONS * (n - 1 + len(closures)), "splat": n + 2 * len(closures),
            "slice": n + 2 * len(closures), "slice_a": 0, "normalize": 0}
    from_cli = Trajectory.from_tum(text).to(DEVICE).camera_to_world
    same_text = text == direct.trajectory.to_tum()
    gap = max_pose_gap(torch, from_cli, direct.trajectory.camera_to_world)
    out = {"exit_code": rc, "closures": len(closures), "launches": launches, "launches_expected": want,
           "saved_tum_text_equal_direct": same_text, "saved_vs_direct_max_abs": gap, "wall_s": wall,
           "ate_translation": {"odometry": float(raw.metrics.translation),
                               "refined": float(direct.metrics.translation)}}
    failures = []
    if rc != 0:
        failures.append(f"8b: the command line exited {rc}")
    if launches != want:
        failures.append(f"8b: launches {launches}, expected {want}")
    if not (same_text or gap <= CLI_DIRECT_ATOL):
        failures.append(f"8b: the command line's trajectory is {gap} from the direct call's")
    return out, failures


def pose_graph_path(torch) -> tuple[dict, list]:
    """Phase 8c: the 500-pose graph, ``solver="auto"`` (CG), on the card and
    on the CPU; one PCG call under ``set_sync_debug_mode("error")``; the
    dense solver at 64 poses on the card and on the CPU."""
    from align3d_torch.optim.pcg import pcg
    from align3d_torch.parallel import pose_graph as pg

    graph_cpu, gt = ring_graph(torch, pg, PG_POSES)
    graph = graph_to(pg, graph_cpu, DEVICE)

    def run(cg_iters):
        iters = PG_CG_ITERS if cg_iters is None else cg_iters
        return pg.optimize(graph, iterations=PG_ITERATIONS, solver="auto", cg_iters=iters)

    card = run(None)
    cpu_t0 = time.perf_counter()
    cpu = pg.optimize(graph_cpu, iterations=PG_ITERATIONS, solver="auto", cg_iters=PG_CG_ITERS)
    cpu_ms = (time.perf_counter() - cpu_t0) * 1e3
    err_before, err_after = pose_err(torch, graph_cpu.nodes, gt), pose_err(torch, card.to("cpu"), gt)
    gap = max_pose_gap(torch, card, cpu)
    prof = solver_profile(torch, run, PG_ITERATIONS * PG_CG_ITERS)
    syncs = syncs_in(torch, lambda: run(None))

    # One PCG call of PG_CG_ITERS trips on the first GN system, where any
    # host synchronisation raises.
    n = PG_POSES
    hdiag, hij, g = pg._block_system(graph.nodes, graph.edges, graph.measurements, graph.weights, n)
    matvec, precond = pg._cg_operators(pg._finalize_diag(hdiag, 1e-6), hij, graph.edges)
    torch.cuda.synchronize()
    sync_error = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        pcg(matvec, precond, g, PG_CG_ITERS)
    except RuntimeError as exc:
        sync_error = str(exc).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)

    dense_cpu, _ = ring_graph(torch, pg, PG_DENSE_POSES)
    dense_card = pg.optimize(graph_to(pg, dense_cpu, DEVICE), iterations=PG_ITERATIONS, solver="auto")
    dense_ref = pg.optimize(dense_cpu, iterations=PG_ITERATIONS, solver="auto")
    dense_gap = max_pose_gap(torch, dense_card, dense_ref)
    out = {"poses": n, "edges": int(graph.edges.shape[0]), "iterations": PG_ITERATIONS, "cg_iters": PG_CG_ITERS,
           "err_before": err_before, "err_after": err_after, "card_vs_cpu_max_abs": gap, "cpu_host_ms": cpu_ms,
           **prof, "host_syncs_per_optimize": syncs, "pcg_sync_error": sync_error,
           "dense": {"poses": PG_DENSE_POSES, "card_vs_cpu_max_abs": dense_gap}}
    failures = []
    if not err_after < 0.6 * err_before:
        failures.append(f"8c: error {err_after} not below 0.6 x {err_before}")
    if not gap <= PG_CARD_CPU_ATOL:
        failures.append(f"8c: the card's poses are {gap} from the CPU's")
    if sync_error is not None:
        failures.append(f"8c: a PCG trip synchronised with the host: {sync_error}")
    if not dense_gap <= PG_DENSE_CARD_CPU_ATOL:
        failures.append(f"8c: the dense solve on the card is {dense_gap} from the CPU's")
    return out, failures


def bundle_adjustment_path(torch) -> tuple[dict, list]:
    """Phase 8d: bundle adjustment at 500 poses x 50,000 landmarks x 200,000
    observations, ``solver="auto"`` (COO), on the card and on the CPU; the
    dense solver on the 6 x 40 scene on the card and on the CPU."""
    import dataclasses

    from align3d_torch.parallel import bundle_adjustment as ba

    problem_cpu = ba_large(torch, ba, *BA_SIZE)
    problem = problem_to(problem_cpu, DEVICE)

    def run(cg_iters):
        iters = BA_CG_ITERS if cg_iters is None else cg_iters
        return ba.optimize(problem, iterations=BA_ITERATIONS, solver="auto", cg_iters=iters)

    poses, landmarks = run(None)
    cpu_t0 = time.perf_counter()
    cpu_poses, cpu_landmarks = ba.optimize(problem_cpu, iterations=BA_ITERATIONS, solver="auto", cg_iters=BA_CG_ITERS)
    cpu_ms = (time.perf_counter() - cpu_t0) * 1e3
    err0 = float(ba.mean_reprojection_error(problem))
    err = float(ba.mean_reprojection_error(dataclasses.replace(problem, poses=poses, landmarks=landmarks)))
    cpu_err = float(ba.mean_reprojection_error(dataclasses.replace(problem_cpu, poses=cpu_poses,
                                                                   landmarks=cpu_landmarks)))
    gap = max(max_pose_gap(torch, poses, cpu_poses), float((landmarks.cpu() - cpu_landmarks).abs().max()))
    prof = solver_profile(torch, run, BA_ITERATIONS * BA_CG_ITERS)
    syncs = syncs_in(torch, lambda: run(None))

    scene_cpu, poses_gt, landmarks_gt = ba_scene(torch, ba)
    d_poses, d_landmarks = ba.optimize(problem_to(scene_cpu, DEVICE), iterations=8, solver="auto")
    r_poses, r_landmarks = ba.optimize(scene_cpu, iterations=8, solver="auto")
    dense_gap = max(max_pose_gap(torch, d_poses, r_poses), float((d_landmarks.cpu() - r_landmarks).abs().max()))
    dense_err = float(ba.mean_reprojection_error(dataclasses.replace(scene_cpu, poses=d_poses.to("cpu"),
                                                                     landmarks=d_landmarks.cpu())))
    out = {"poses": BA_SIZE[0], "landmarks": BA_SIZE[1], "observations": BA_SIZE[2], "iterations": BA_ITERATIONS,
           "cg_iters": BA_CG_ITERS, "err0_px": err0, "err_px": err, "cpu_err_px": cpu_err,
           "card_vs_cpu_max_abs": gap, "cpu_host_ms": cpu_ms, **prof, "host_syncs_per_optimize": syncs,
           "dense": {"poses": 6, "landmarks": 40, "card_vs_cpu_max_abs": dense_gap, "err_px": dense_err}}
    failures = []
    if not err < 0.2 * err0:
        failures.append(f"8d: reprojection error {err} not below 0.2 x {err0}")
    if not gap <= BA_CARD_CPU_ATOL:
        failures.append(f"8d: the card's solution is {gap} from the CPU's")
    if not (dense_gap <= BA_DENSE_CARD_CPU_ATOL and dense_err < 1e-2):
        failures.append(f"8d: the dense scene on the card: {dense_gap} from the CPU's, error {dense_err} px")
    return out, failures


def global_refinement(torch, dataset, counters) -> tuple[dict, list]:
    """Phase 8; returns (what it measured, its failures)."""
    out, failures = {}, []
    for name, path in (("palindrome", lambda: palindrome_path(torch, dataset, counters)),
                       ("cli", lambda: loop_closure_cli(torch, dataset, counters)),
                       ("pose_graph", lambda: pose_graph_path(torch)),
                       ("bundle_adjustment", lambda: bundle_adjustment_path(torch))):
        t0 = time.perf_counter()
        out[name], failed = path()
        out[name]["phase_s"] = time.perf_counter() - t0
        failures += failed
    return out, failures


def main() -> int:
    start = time.perf_counter()

    def done(phase: str) -> None:
        print(f"[{time.perf_counter() - start:.1f} s] {phase} done")

    if not (ROOT / "align3d_torch" / "csrc").is_dir() or not SAMPLE1.is_dir() or not GOLDEN.is_file():
        return fail("run chip_smoke.py from the root of an align3d checkout")
    import torch

    if not torch.cuda.is_available():
        return fail("CUDA is not available")
    sys.path.insert(0, str(ROOT))

    # -- 1. device ---------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"count {torch.cuda.device_count()}")
    print(f"nvidia-smi: {smi}")

    # -- 2. build ----------------------------------------------------------
    from align3d_torch import _kernels

    t0 = time.perf_counter()
    _kernels.build(verbose=True)
    _kernels.lib()
    print(f"kernel build + load: {time.perf_counter() - t0:.1f} s")
    ptxas = {key: _kernels.ptxas_report(name) for key, name in PTXAS_NAMES.items()}
    for key, lines in ptxas.items():
        print(f"ptxas -v {PTXAS_NAMES[key]}: " + "; ".join(lines))

    done("phases 1-2")

    # -- 3. kernels against their plain twins, main-path shapes -------------
    from align3d_torch.icp.params import MsIcpParams
    from align3d_torch.io.datasets import SlamTbDataset, SubsetDataset
    from align3d_torch.metrics import TransformMetrics
    from align3d_torch.odometry import run_odometry
    from align3d_torch.ops import bilateral as bil
    from align3d_torch.ops import icp_fused
    from align3d_torch.range_image import RangeImageBuilder
    from align3d_torch.trajectory import Trajectory

    dataset = SlamTbDataset.load(str(SAMPLE1))
    frame0, frame1 = dataset.get(0), dataset.get(1)
    depth0 = torch.from_numpy(frame0.image.depth.astype("int32")).cuda()
    splat = check_splat(torch, bil, depth0)
    slice_, slice_a = check_slice(torch, bil, depth0)
    builder = RangeImageBuilder(bilateral_filter=bil.BilateralFilter())
    icp = check_icp(torch, builder.build(frame0, "cuda"), builder.build(frame1, "cuda"))
    done("phase 3, K1-K3")

    import numpy as np

    from align3d_torch.icp.params import IcpParams
    from align3d_torch.icp.pcl_icp import Icp
    from align3d_torch.io import read_ply
    from align3d_torch.ops import mesh
    from align3d_torch.ops import nn_banded as nn
    from align3d_torch.se3 import Transform

    target, source = cloud(torch, dataset, 0), cloud(torch, dataset, 1)
    print(f"sample1 clouds: {len(target[0])} target and {len(source[0])} source points")
    s1_grid = nn.SortedGrid.build(target[0], IcpParams().max_distance / 10.0, normals=target[1])
    nn_p2p = check_nn(torch, nn, "associate_p2p, sample1", nn_args(torch, nn, s1_grid, source[0], 512, True), True)
    rng = np.random.default_rng(0)
    db500 = torch.from_numpy(rng.uniform(0, 1, (500_000, 3)).astype(np.float32)).to(DEVICE)
    q500 = torch.from_numpy(rng.uniform(0, 1, (500_000, 3)).astype(np.float32)).to(DEVICE)
    grid500 = nn.SortedGrid.build(db500, 0.02)
    nn_500 = {bw: check_nn(torch, nn, f"nearest_banded, 500k x 500k, band {bw}",
                           nn_args(torch, nn, grid500, q500, bw, False), False) for bw in (256, 512)}
    del db500, q500, grid500
    done("phase 3, K4")
    from align3d_torch.tools.ablate import grid_mesh

    mesh_pts, mesh_faces = grid_mesh(320)
    teapot = read_ply(ROOT / "tests" / "data" / "teapot.ply")
    mesh_grid = check_mesh(torch, mesh, "grid mesh", mesh_pts, mesh_faces)
    mesh_big = check_mesh(torch, mesh, "grid mesh, side 1280", *grid_mesh(1280))
    mesh_teapot = check_mesh(torch, mesh, "teapot", teapot.points, teapot.faces.astype(np.int32))
    torch.cuda.synchronize()
    done("phase 3, K5")

    from align3d_torch.tools import roofline as rl
    from align3d_torch.tools import series

    probes = check_probes(torch, rl)
    real, mixed = series.real_frames(), series.mixed_frames()
    batched_bil = check_batched_bilateral(torch, bil, real, mixed)
    torch.cuda.synchronize()

    done("phase 3")

    # -- 4. the main path ----------------------------------------------------
    subset = SubsetDataset(dataset, range(FRAMES))
    icp_fused.LAUNCHES = bil.SPLAT_LAUNCHES = bil.NORMALIZE_SLICE_LAUNCHES = 0
    bil.SLICE_LAUNCHES = bil.NORMALIZE_PASSES = 0
    first = run_odometry(subset, "cuda", range_builder=builder, icp_params=MsIcpParams.default())
    launches = {"icp": icp_fused.LAUNCHES, "splat": bil.SPLAT_LAUNCHES, "slice": bil.NORMALIZE_SLICE_LAUNCHES}
    print(f"main-path launches: {launches}; K3 form (a) launches {bil.SLICE_LAUNCHES}, "
          f"_normalize passes {bil.NORMALIZE_PASSES}")
    if min(launches.values()) <= 0:
        return fail(f"a kernel of the main path never launched: {launches}")
    if bil.SLICE_LAUNCHES or bil.NORMALIZE_PASSES:
        return fail("the filter normalized a grid or sliced through K3's form (a)")
    second = run_odometry(subset, "cuda", range_builder=builder, icp_params=MsIcpParams.default())

    angle_deg = math.degrees(float(first.metrics.angle))
    trans = float(first.metrics.translation)
    print(f"odometry: {FRAMES} frames, mean trajectory error {angle_deg:.4f} deg / {trans:.6f}; "
          f"{first.seconds_per_frame * 1e3:.1f} ms/frame (first run), "
          f"{second.seconds_per_frame * 1e3:.1f} ms/frame (second run)")
    if not (angle_deg < MEAN_ANGLE_DEG and trans < MEAN_TRANS):
        return fail("trajectory error above the 0.5 deg / 0.01 bound")

    golden = Trajectory.from_tum(GOLDEN.read_text()).to("cuda")
    diff = TransformMetrics.new(golden.camera_to_world, first.trajectory.camera_to_world)
    max_angle, max_trans = float(diff.angle.max()), float(diff.translation.max())
    print(f"against the JAX golden: max pose difference {max_angle:.2e} rad / {max_trans:.2e} m")
    if not (len(golden) == len(first.trajectory) and max_angle <= POSE_ATOL and max_trans <= POSE_ATOL):
        return fail("trajectory differs from the JAX golden")

    a, b = first.trajectory.camera_to_world, second.trajectory.camera_to_world
    identical = torch.equal(a.rotation, b.rotation) and torch.equal(a.translation, b.translation)
    print(f"second run bitwise identical: {identical}")
    if not identical:
        return fail("two runs of the main path differ")
    for name, result in (("first", first), ("second", second)):
        pose = result.trajectory.camera_to_world
        if not (torch.isfinite(pose.rotation).all() and torch.isfinite(pose.translation).all()):
            return fail(f"non-finite poses in the {name} run")

    done("phase 4a")

    # -- 4b. point-cloud ICP, 4c. mesh normals -------------------------------
    launches["nn"] = pcl_path(torch, nn, Icp, IcpParams, Transform, TransformMetrics, target, source,
                              dataset.trajectory().get_relative_transform(1, 0).to(DEVICE))
    launches["mesh"] = mesh_path(torch, mesh, teapot, mesh_pts, mesh_faces)

    done("phases 4b-4c")

    # -- 4d. the throughput path ---------------------------------------------
    counters = {"icp": (icp_fused, "LAUNCHES"), "splat": (bil, "SPLAT_LAUNCHES"),
                "slice": (bil, "NORMALIZE_SLICE_LAUNCHES"), "slice_a": (bil, "SLICE_LAUNCHES"),
                "normalize": (bil, "NORMALIZE_PASSES")}
    throughput = throughput_path(torch, real, mixed, counters)
    print("throughput path: " + json.dumps(throughput))
    done("phase 4d")

    # -- 5. where a frame's time goes ---------------------------------------
    print("frame profile: " + json.dumps(profile_frames(torch, dataset, builder, MsIcpParams.default())))
    print("pcl profile: " + json.dumps(profile_pcl(torch, nn, Icp, IcpParams, target, source)))
    step_profile = profile_step(torch, real)
    print("step profile: " + json.dumps(step_profile))
    done("phase 5")

    # -- 6. the roofline tool --------------------------------------------------
    rl.FMA_LAUNCHES = rl.GATHER_LAUNCHES = 0
    roof = rl.measure(DEVICE)
    launches["p1"], launches["p2"] = rl.FMA_LAUNCHES, rl.GATHER_LAUNCHES
    if min(launches["p1"], launches["p2"]) <= 0:
        return fail(f"a roofline probe never launched: {launches}")
    p2, lane = roof["p2_hbm"], roof["p2_lane"]
    print(f"P2 bounds: hbm {p2['bound_ms']} ms for {p2['gathers']} gathers at {rl.SECTOR_BYTES} B a gather "
          f"(at 4 B a gather it read {p2['gathers'] * 4 / PEAK_BYTES * 1e3} ms), measured {p2['ms']} ms, "
          f"{p2['bound_ms'] / p2['ms']:.3f} of it; lane {lane['bound_ms']} ms at {lane['sm_clock_hz'] / 1e6:.0f} MHz "
          f"(one shared load and one store a gather, 32 banks x 132 SMs), measured {lane['ms']} ms")
    done("phase 6")

    # -- 7. the data path ----------------------------------------------------
    data = data_path(torch, dataset, builder, counters, {k: launches[k] for k in ODOMETRY_KERNELS})
    print("data path: " + json.dumps(data))
    print("data path decoder: " + ("native loader (libpng/libjpeg, built from native/loader.cpp)"
                                   if data["native_loader"] else
                                   f"io/png.py; the native loader did not build: {data['native_unavailable_reason']}"))
    print(f"data path decode ms per frame (colour + depth, 640x480): {json.dumps(data['decode_ms_per_frame'])}")
    print("data path odometry host ms per frame (median of frames 2-9): "
          + json.dumps(data["odometry_host_ms_per_frame_median"]))
    print(f"data path resume: cut at {TUM_CUT} frames, resumed to {data['resumed_next_frame']}: bitwise the "
          f"uninterrupted run {data['resumed_bitwise_uninterrupted']}, TUM text equal {data['resumed_tum_text_equal']}; "
          f"prefetched bitwise plain {data['prefetched_bitwise_plain']}")
    print(f"data path launches: {json.dumps(data['launches'])}; slamtb, {FRAMES} frames: "
          f"{json.dumps(data['slamtb_launches_same_length'])}")
    err = data["error_vs_ground_truth"]
    print(f"data path TUM odometry against the written ground truth: {err['angle_deg']:.4f} deg / "
          f"{err['translation']:.6f} (not gated: TUM's intrinsics 525 / 319.5 are not sample1's 544.47 / 320)")
    print(f"RgbdFrame.downsample(1.0), card against cpu: {json.dumps(data['downsample'])}")
    if data["launches"] != data["launches_expected"]:
        return fail(f"the data path's launches {data['launches']} are not {data['launches_expected']}")
    if any(data["launches"]["uninterrupted"][k] != v for k, v in data["slamtb_launches_same_length"].items()):
        return fail("the TUM run launched K1-K3 otherwise than the slamtb run of the same length")
    if data["resumed_next_frame"] != FRAMES or not (data["resumed_bitwise_uninterrupted"]
                                                     and data["resumed_tum_text_equal"]):
        return fail("the resumed TUM run differs from the uninterrupted one")
    if not data["prefetched_bitwise_plain"]:
        return fail("the prefetched TUM run differs from the plain one")
    if not data["finite"]:
        return fail("non-finite poses in the TUM run")
    ds = data["downsample"]
    if not (ds["depth_bitwise"] and ds["camera_equal"] and ds["color_max_diff"] <= 1
            and ds["color_share_off"] <= DOWNSAMPLE_COLOR_SHARE):
        return fail(f"RgbdFrame.downsample on the card differs from the CPU: {ds}")
    done("phase 7")

    # -- 8. global refinement --------------------------------------------------
    refinement, failures = global_refinement(torch, dataset, counters)
    print("global refinement: " + json.dumps(refinement))
    if failures:
        return fail("; ".join(failures))
    done("phase 8")
    by_path = {"odometry (4a)": {k: launches[k] for k in ("icp", "splat", "slice")},
               "TUM odometry, uninterrupted (7)": data["launches"]["uninterrupted"],
               "throughput, bilateral off (4d)": throughput["bilateral_off"]["launches"],
               "throughput, bilateral on (4d)": throughput["bilateral_on"]["launches"],
               "mixed series (4d)": throughput["mixed"]["launches"],
               "loop closure, 18-frame palindrome, no filter (8a)": refinement["palindrome"]["launches"],
               "loop closure, command line, TUM palindrome (8b)": refinement["cli"]["launches"]}

    def entry(name, source, replaces, key, checked, err_kind, **extra):
        err, (ms, call_ms), (plain_ms, plain_call_ms), bnd, lib = checked
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "pallas_calls": PALLAS_CALLS[name.split("(")[-1].rstrip(")")],
                "launches": launches[key], "max_abs_err": err, "err": err_kind,
                # ms / plain_ms: device time per call (torch.profiler), None where
                # it saw none; *_call_ms: per-call time of back-to-back calls.
                "ms": ms, "plain_ms": plain_ms, "call_ms": call_ms, "plain_call_ms": plain_call_ms,
                "timed_calls": TIMED_CALLS, **bnd, **lib, **extra}

    def shape_times(checked):
        err, (ms, call_ms), (plain_ms, plain_call_ms), bnd, lib = checked
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "call_ms": call_ms,
                "plain_call_ms": plain_call_ms, **bnd, **lib}

    k1_64 = roof["k1_batch64"]
    frames = batched_bil["batch"]
    gh, gw = bil._grid_dims(480, 640, bil.BilateralFilter.sigma_space)

    kernels = [
        entry("icp_step_fused (K1)", "align3d_torch/csrc/icp_step.cu", "align3d_tpu/ops/icp_pallas_v4.py:96",
              "icp", icp, "max |kernel - plain| / max|plain| over H, g and sum w r^2", ptxas=ptxas["icp"],
              launches_by_path={k: v["icp"] for k, v in by_path.items()},
              shapes={"batch64_real_pairs": {
                  "ms": k1_64["ms"], "us_per_pair": k1_64["us_per_pair"],
                  "device_us_per_launch_in_step": step_profile["bilateral_off"]["k1_device_us_per_launch"],
                  "plain_ms": throughput["k1_batch64_plain_ms"],
                  "max_abs_err": throughput["k1_batch64_max_rel_err_plain"],
                  **bound(k1_64["bytes"], 300 * k1_64["gathers"] / 2)}}),
        entry("bilateral_splat (K2)", "align3d_torch/csrc/bilateral.cu", "align3d_tpu/ops/bilateral.py:80",
              "splat", splat, "max |kernel - plain|", ptxas=ptxas["splat"],
              launches_by_path={k: v["splat"] for k, v in by_path.items()},
              shapes={f"batch{frames}_gd{batched_bil['gd']}": {
                  "ms": batched_bil["splat_ms"], "call_ms": batched_bil["splat_call_ms"],
                  "ms_per_frame": batched_bil["splat_ms_per_frame"],
                  "plain_ms": batched_bil["splat_plain_ms"], "max_abs_err": batched_bil["splat_max_abs_err"],
                  **batched_bil["splat_library"],
                  **bound(frames * (480 * 640 * 4 + 2 * gh * gw * batched_bil["gd"] * 4), frames * 480 * 640 * 10)}}),
        # K3: form (b), the filter paths' slice (normalize and cast folded
        # in; its bound reads value and count of each sampled cell), then
        # form (a) on the normalized grid. grid_sample reads a normalized grid.
        entry("bilateral_slice (K3)", "align3d_torch/csrc/bilateral.cu", "align3d_tpu/ops/bilateral.py:389",
              "slice", slice_, "max |kernel - plain| of the int32 output (form (b))", ptxas=ptxas["slice"],
              form="(b): blurred grid in, normalized at each corner, int32 out",
              launches_by_path={k: v["slice"] for k, v in by_path.items()},
              shapes={f"batch{frames}_gd{batched_bil['gd']}": {
                  "ms": batched_bil["fused_ms"], "call_ms": batched_bil["fused_call_ms"],
                  "ms_per_frame": batched_bil["fused_ms"] / frames if batched_bil["fused_ms"] else None,
                  "plain_ms": batched_bil["fused_plain_ms"], "max_abs_err": batched_bil["fused_max_abs_err"],
                  **batched_bil["slice_library"],
                  **bound(batched_bil["slice_cells"] * 8 + frames * 480 * 640 * 8, frames * 480 * 640 * 30)},
                  "form_a": shape_times(slice_a),
                  f"form_a_batch{frames}_gd{batched_bil['gd']}": {
                  "ms": batched_bil["slice_ms"], "call_ms": batched_bil["slice_call_ms"],
                  "ms_per_frame": batched_bil["slice_ms_per_frame"],
                  "plain_ms": batched_bil["slice_plain_ms"], "max_abs_err": batched_bil["slice_max_abs_err"],
                  **batched_bil["slice_library"],
                  **bound(batched_bil["slice_cells"] * 4 + frames * 480 * 640 * 8, frames * 480 * 640 * 30)},
                  "sample2_deep": {"frames": batched_bil["deep_batch"], "gd": batched_bil["deep_gd"],
                                   "form_a_max_abs_err": batched_bil["deep_max_abs_err"],
                                   "form_b_bitwise": batched_bil["deep_fused_bitwise_plain"]}}),
        # K4's ms at the pcl-ICP path's shape (associate_p2p on sample1);
        # the twin's per-call time is over TIMED_PLAIN_NN calls, its device
        # time over PROFILED_PLAIN_NN.
        entry("nn_banded (K4)", "align3d_torch/csrc/nn_banded.cu", "align3d_tpu/ops/nn_banded.py:178",
              "nn", nn_p2p, "max |kernel - plain| of the scores (positions and payload bitwise)",
              ptxas=ptxas["nn"], plain_timed_calls=TIMED_PLAIN_NN, plain_profiled_calls=PROFILED_PLAIN_NN,
              shapes={"nearest_500k_band256": shape_times(nn_500[256]),
                      "nearest_500k_band512": shape_times(nn_500[512])}),
        entry("mesh_normals (K5)", "align3d_torch/csrc/mesh.cu", "align3d_tpu/ops/mesh.py:243",
              "mesh", mesh_grid, "max |kernel - plain| (bitwise, the sign of zero included; NaN at the same vertices)",
              ptxas=ptxas["mesh"],
              shapes={"grid1280_3276800_faces": shape_times(mesh_big), "teapot": shape_times(mesh_teapot)}),
        # P1 and P2 at the roofline tool's sizes; their twins timed at the same
        # sizes with CUDA events around one call (phase 3).
        {"name": "fma_peak (P1)", "route": "cuda", "source": "align3d_torch/csrc/roofline.cu",
         "replaces": "tools/roofline_v4.py:52", "pallas_calls": PALLAS_CALLS["P1"], "launches": launches["p1"],
         "max_abs_err": probes["p1_max_rel_err"], "err": "max |kernel - plain| / |plain|",
         "ms": roof["p1"]["ms"], "plain_ms": probes["p1_plain_ms"], "tflops": roof["p1"]["tflops"],
         **bound(0, roof["p1"]["flops"]),
         "library_ms": None, "library_reason": "no PyTorch call runs dependent FMA chains"},
        {"name": "gather_peak (P2)", "route": "cuda", "source": "align3d_torch/csrc/roofline.cu",
         "replaces": "tools/roofline_v4.py:98", "pallas_calls": PALLAS_CALLS["P2"], "launches": launches["p2"],
         "max_abs_err": probes["p2_max_abs_err"],
         "err": "max |kernel - plain| of the integer sums over the lane, l2 and hbm modes",
         "err_by_mode": probes["p2_errs"],
         "ms": p2["ms"], "plain_ms": probes["p2_plain_ms"], "mode": "hbm", "gathers_per_s": p2["gathers_per_s"],
         **bound(p2["gathers"] * rl.SECTOR_BYTES, 0),  # one 32-byte sector a gather
         "library_ms": probes["p2_library_ms"], "library_call": "torch.gather of the same indices",
         "modes": {m: roof[f"p2_{m}"] for m in ("lane", "l2", "hbm")}},
    ]
    print(json.dumps({"roofline": roof}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
