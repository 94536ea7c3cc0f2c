#!/usr/bin/env python3
"""Smoke run of the align3d_torch port on one CUDA GPU.

    python chip_smoke.py

Run from the root of a checkout. Phases, each of which fails the run:

1. CUDA present; print the device and ``nvidia-smi`` name / power limit.
2. Build the CUDA kernels from ``align3d_torch/csrc`` (timed), and print
   the ``-Xptxas -v`` report (registers, shared memory, spills) of K1, K2,
   K3 (its four instantiations), K4, K5, K6, K7/K8, K9, K10, K11, K12 and
   K13.
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
   its plain twins. K11 on the blocks of real K1 and K8 steps, sample1
   frames 0 <- 1 (B = 1) and the 64 real pairs (B = 64), level 0, four GN
   iterations each: the best residuals and the select decisions equal the
   twin's, the poses within GN_UPDATE_ATOL, one launch an update. K12 and
   K13, the pyramid, at sample1 frame 1 (B = 1) and the 65 frames of the
   throughput series: every output of every level bitwise the plain twin,
   one K12 and two K13 launches a 3-level build; each launch, the whole
   build and the plain chain timed beside the byte bound.
4. Drive each path with its kernels' launch counts read just before and
   just after; the filter paths (4a, 4d) must slice through K3's form
   (b) only, with no launch of form (a) and no ``_normalize`` pass:
   a. odometry: ``run_odometry`` on sample1, 10 frames, bilateral filter on;
      each of its 27 levels captured or replayed as a CUDA graph
      (``icp/level_graph.py``), replays counted in the launches as the
      eager loop's; the trajectory error against ground truth, the poses against the JAX
      package's golden trajectory, a bitwise-identical second run; how far
      the trajectory moves when the divisions by a number are made as CUDA
      makes them for a CPU scalar (a product with the float32 reciprocal:
      the port before the division fix, ``extra_math.div_scalar``);
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
8. Global refinement, each path with K1-K3's launch counts read just
   before and just after, all printed as one ``global refinement:``
   JSON line:
   a. ``tests/test_loop_closure_e2e.py`` on the card: the 18-frame
      palindrome of sample1 (0-11, then 10 to 0 in steps of 2), 640x480,
      no filter, odometry at 2 GN iterations a level, then
      ``refine_with_loop_closures`` (closures by ``MsIcpParams.default()``,
      ``min_separation=16``): that test's gates (translation error below
      the odometry's, angle within 1.1x + 1e-3 deg, the revisit closed to
      5e-3) and K1's launches (6 a pair, 70 a closure), levels replayed as
      CUDA graphs (8b too);
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
9. Distribution, each path against its unsharded run on the card, first on
   a one-rank NCCL mesh in this process (``make_mesh``), then on two
   processes that both use this card over gloo (named explicitly: NCCL
   refuses two ranks on one device), all printed as one ``distribution:``
   JSON line:
   a. ``odometry_step(mesh=)`` on the 65-frame real series, filter on:
      bitwise the unsharded step; K1-K3 launches per rank, host ms per
      stage (``StageTimer``: filter, pyramids, align, gather, scan), device
      busy ms and peak memory per rank;
   b. ``odometry_sequence_parallel`` on the same frames (65 pad to 66 at
      two ranks; the halo stage added): bitwise the unsharded step;
   c. the 500-pose graph of 8c (CG), edges sharded, and a 9-pose ring
      (dense): within 1e-4 of unsharded; collectives per PCG trip (1);
      at one rank, device activities per trip (8c: 35) and one PCG call
      under ``set_sync_debug_mode("error")``;
   d. BA at 8d's size (COO), observations sharded, and the 6 x 40 scene
      (dense): within 1e-4 of unsharded; collectives per PCG trip (2);
   e. at one rank, ``refine_with_loop_closures(mesh=)`` on 8a's palindrome
      against the call without a mesh.
   A rank that fails, or runs past ``DIST_TIMEOUT_S``, fails the run. The
   two-rank times are host cost on one card, not scaling.
10. Viz, each render on the card and on the CPU path in this process (the
    card's rerun bitwise, host ms a render, device busy ms, peak memory, the
    share of pixels of equal colour), all printed as one ``viz:`` JSON line:
    a. ``render_dataset_preview`` of all 31 sample1 frames at 640x480
       (8,375,903 points with the polyline; its PNG equal to the direct
       render), on the card only, and the 8-frame ``RgbdDatasetViewer``
       scene on both (the CPU comparison is cut to those 8 frames to keep
       the phase near a minute): the 8 clouds built on each device equal
       and the two renders bitwise; the renderer alone bitwise (the CPU
       path's 8 clouds uploaded and rendered on the card); host ms of the
       fitted spheres and of a render that refits every node (before the
       fit was kept per node); K6 (the spheres' centres, numpy's means)
       launched once for all nodes over every render of a viewer, held
       bitwise against numpy on the preview's nodes in that one launch and
       timed so, beside numpy on the host and ``torch.segment_reduce``;
    b. ``render_dataset_flythrough`` at 480x360, 24 views: host s and GIF
       bytes; the GIF decoded by this script's LZW reader, each frame the
       palette's quantization of the card's render of that view;
    c. mesh renders with ``normals=None`` through a scene's mesh node (the
       teapot, the 204,800- and 3,276,800-face grids scaled to 4 x 4 units,
       640x480): exactly one K5 launch a render, the (face, pixel) pairs
       enumerated;
    d. the command line: ``viewer -o p.png --max-frames 8`` (equal to the
       direct render), ``viewer --animate``, and ``odometry slamtb sample1 10
       --show s.png`` with K1/K2/K3 launched as in 4a and K5 never;
    e. ``InteractiveViewer`` on the 8-frame scene driven over HTTP (page,
       frame, W, a drag, key 1, state, quit), each frame equal to a direct
       render of its camera; ms a ``/frame.png`` request.
11. The benches (``align3d_torch/benches``), each with ``--quick`` (two
    repeats, one warm-up call, the JAX shapes) in this process, stdout
    captured: exactly one JSON line under its JAX metric name, with a
    finite positive value (``bench_scaling`` on one card: null with the
    reason "one card", its world-1 step timed); the launches a call each
    bench's line reports against what its path issues (K8 10 an align at
    B = 64 and K1 10 beside it, K7 10 a kernel-only call and 10 a full
    align and K1 10 each beside them, K8 70 an ``odometry_step`` and K1 70
    beside it, K10 once a banded GN iteration and K9 once a banded align
    (one a full align of ``bench_icp_kernel``, 3 an ``odometry_step``), K2
    and K3 one a bucket with the filter and one a ``filter_static``, K4 10 a pcl align and one a nearest search, K5 one a
    call); each bench's result bitwise the same port call made here on the
    same inputs (the global refinement bench excepted: ``index_add_`` adds
    by atomics); each line printed as ``bench <module>: {...}``.
12. The banded engines (``engine="pallas"`` / ``"pallas_v4"``), printed as
    one ``banded:`` JSON line:
    a. K7 (with stats) and K8 against their plain twins on the card at
       640x480: sample1 frames 0 <- 1 (B = 1, level 0, at phase 3's twist)
       and the 64 real pairs (B = 64), the bands predicted from the source
       centroids: gate counts equal, H, g and sum w r^2 within ICP_REL, K7's
       stats bitwise; each pair's blocks at B = 64 bitwise its B = 1
       blocks; device ms a launch (every activity a launch of the kernel)
       and per-call ms of both, the twin's, the bound (tools/roofline.py
       ``banded_step_bytes``), and the band prediction's host ms; K9 (the
       source centroids, ``csrc/band_predict.cu``) bitwise its twin on the
       card and on the CPU (NaN in the same places) at the three levels of
       sample1 frame 1 (B = 1) and of 64 frames of the real series (B = 64,
       each frame's outputs bitwise its B = 1 launch), and on a source with
       empty groups and a NaN depth; K10 (the bases) equal to its twin at the
       pose of each iteration of a 10-iteration ``pallas_v4`` align of the 64
       real pairs, and at crafted poses: a drop and a lift of 0.5 m (band
       starts clipped at 0 and at hp - 32) and a centroid taken to pz == 0;
    b. ``run_odometry`` on sample1, filter on: 31 frames with
       ``default_tpu("pallas_v4")`` (K8 and K10 70 launches a pair, K9 3,
       K1 and K7 none)
       against the JAX package's golden trajectory of that engine within
       POSE_ATOL; 10 frames with ``default_tpu("pallas_v4",
       coarse_exact=True)`` (K8 and K10 40 a pair, K9 2, K1 30) and with
       ``default_tpu("pallas", coarse_exact=True)`` (K7 and K10 40 a pair,
       K9 2, K1 30);
       each against ground truth, finite, and its host ms a frame;
    c. the split (``tools/ablate.py`` ``banded_sections``, in a process of
       its own): K7 and K8 built without the stack's reduction, without the
       target gathers and without both, each timed at B = 1 and B = 64
       beside the full build (held bitwise against the library's kernel),
       printed as ``banded split`` lines;
    d. K9's and K10's times (``tools/ablate.py`` ``band_prediction``, in a
       process of its own): device ms a launch at B = 1 and 64, their twins'
       and, for K9, one ``torch`` sum of the same six channels; host ms a
       call of each wrapper and twin; the device activities of one
       ``pallas_v4`` align's GN loop and prepack at B = 64 on the kernels and
       on the twins (K10 once a GN iteration, K9 once an align), printed as
       ``banded K9/K10`` lines.

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
GOLDEN_V4 = ROOT / "tests" / "data" / "golden" / "sample1_bilateral_pallas_v4_31.tum"
BANDED_FRAMES, BANDED_CUT = 31, 10  # 12b: the pallas_v4 golden's frames; the coarse_exact runs'
BAND_TIMING_TIMEOUT_S = 300  # 12d: K9's and K10's timing in a process of its own
FRAMES = 10
DEVICE = "cuda"

# Tolerances. K2 is held bitwise: every product has a 0/1 factor and the sums
# run in the plain twin's order.
SLICE_ATOL = 2e-3  # K3's form (a) before the cast (tests/test_bilateral.py's kernel bound) ...
SLICE_CAST_MAX = 1  # ... and after the truncating cast; form (b) is held bitwise
ICP_COUNT_SHARE = 1e-4  # K1: count within 0.01% of the valid pixels
ICP_REL = 1e-4  # K1: H and g within 1e-4 x max|entry|
K1_TWIST = [0.004, -0.002, 0.003, 0.002, -0.003, 0.001]  # the pose K1 is held against its twin at
GN_UPDATE_ATOL = 2e-6  # K11: poses within 2e-6 of its twin's (rotation absolute, translation relative)
GN_UPDATE_ITERATIONS = 4  # K11: GN iterations a shape is held to its twin over
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
DIST_SOLVE_ATOL = 1e-4  # 9c/9d vs unsharded: tests/test_pose_graph.py:86-103, test_bundle_adjustment.py:147-155
DIST_TIMEOUT_S = 300  # 9: a rank still running after this fails the run
SPLIT_TIMEOUT_S = 300  # 12c: the split's own process (four builds of icp_banded.cu, 16 timings)
VIZ_SCENE_FRAMES = 8  # 10: the interactive scene and the command line's preview
VIZ_VIEWS = 24  # 10b: views of the fly-through
VIZ_CARD_CPU_SHARE = 0.999  # 10c: pixels of equal colour, card against the CPU path (10a: bitwise)

# Published H100 SXM peaks at 700 W (the bounds are stated against them).
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12

TIMED_CALLS = 50  # calls per timing, back to back
TIMED_PLAIN_NN = 5  # calls per timing of the K4 twin, which takes ~0.1 s a call ...
PROFILED_PLAIN_NN = 1  # ... and ~40k profiler events per call
PROFILED_FRAMES = 3  # frames 1..3 of sample1 in phase 5
#: Kernel names in csrc/, by the wrapper that launches them (K3's two forms
#: are instantiations of one template).
KERNEL_NAMES = {"icp": ("icp_step_kernel",), "splat": ("bilateral_splat",), "slice": ("bilateral_slice",),
                "mesh": ("mesh_normals",), "sphere": ("column_mean",),
                "banded": ("icp_banded_kernel<false>", "icp_banded_kernel<true>"),
                "centroids": ("source_centroids_kernel",), "predict": ("predict_bases_kernel",),
                "k11": ("gn_update_kernel",), "k12": ("pyramid_base_kernel",), "k13": ("pyramid_down_kernel",)}
ODOMETRY_KERNELS = ("icp", "splat", "slice")  # the kernels phase 5's frame profile reads
#: The counts this script reads, by its names for them: the launches of a
#: kernel of ``_kernels.KERNELS`` (``_kernels.launches()``), or None for
#: ``ops/bilateral.py``'s ``NORMALIZE_PASSES`` (plain-PyTorch passes).
COUNTS = {"icp": "K1", "splat": "K2", "slice": "K3b", "slice_a": "K3a", "nn": "K4", "mesh": "K5", "k6": "K6",
          "k7": "K7", "k8": "K8", "k9": "K9", "k10": "K10", "k11": "K11", "k12": "K12", "k13": "K13",
          "p1": "P1", "p2": "P2", "normalize": None}
ODOMETRY_COUNTS = ("icp", "splat", "slice", "slice_a", "normalize", "k11")  # what the odometry paths read
#: The repository's nine ``pl.pallas_call`` sites, by the kernel that replaces them.
PALLAS_CALLS = {"K1": [], "K7": ["align3d_tpu/ops/icp_pallas_v3.py:761"],
                "K8": ["align3d_tpu/ops/icp_pallas_v4.py:508"], "K2": ["align3d_tpu/ops/bilateral.py:171"],
                "K3": ["align3d_tpu/ops/bilateral.py:598"],
                "K4": ["align3d_tpu/ops/nn_banded.py:370", "align3d_tpu/ops/nn_banded.py:459"],
                "K5": ["align3d_tpu/ops/mesh.py:356"], "P1": ["tools/roofline_v4.py:68"],
                "P2": ["tools/roofline_v4.py:118"], "K11": [], "K12": [], "K13": []}
PTXAS_NAMES = {**{key: names[0] for key, names in KERNEL_NAMES.items()}, "nn": "nn_banded",
               "banded": "icp_banded_kernel"}


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
    ms, acts = device_ms(fn, profiled, kernel)
    if kernel is not None and len(acts) != profiled:
        print(f"the profiler saw {len(acts)} {kernel} launches of {profiled}")
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


def check_gn_update(torch, pyr0, pyr1) -> tuple:
    """Phase 3: K11 against its twin on the card, on the blocks that real
    K1 and K8 steps hand it: sample1 frames 0 <- 1 (B = 1, level 0 of
    check_icp's pyramids) and the 64 real pairs of ``series.real_pairs``
    (B = 64), GN_UPDATE_ITERATIONS iterations from K1_TWIST's pose each.
    Every iteration: NaN in the same places, the best residuals and the
    select decisions equal, the poses within GN_UPDATE_ATOL (rotation
    absolute, translation of each pair's largest entry), one launch. Returns
    (worst error, K11's timings, the twin's, bound, library) at B = 1 on K1's
    blocks, and the rows of the four shapes."""
    from align3d_torch.icp import image_icp as ii
    from align3d_torch.icp.params import MsIcpParams
    from align3d_torch.ops import icp_fused
    from align3d_torch.ops import icp_pallas_v3 as k3
    from align3d_torch.ops import icp_pallas_v4 as k4
    from align3d_torch.optim import gauss_newton as gn
    from align3d_torch.se3 import Transform
    from align3d_torch.tools.ablate import GN_UPDATE_BYTES
    from align3d_torch.tools.series import real_pairs

    fields = ("rot", "trans", "best_res", "best_rot", "best_trans")

    def stepper(engine, tgt, src, b):
        n = tgt.height * tgt.width
        args = (src.points.reshape(b, n, 3), src.mask.reshape(b, n), src.intensities.reshape(b, n),
                tgt.points.reshape(b, n, 3), tgt.mask.reshape(b, n), tgt.normals.reshape(b, n, 3),
                tgt.intensity_map.reshape(b, tgt.height + 2, tgt.width + 2))
        if engine == "k1":
            params = MsIcpParams.default()[0]
            packed = ii.prepack_batched(*args)

            def step(rot, trans):
                aug = icp_fused.icp_step_fused(rot, trans, *packed, tgt.intrinsics, params)
                return aug[:, 0], aug[:, 1]
            return step, params
        params = MsIcpParams.default_tpu("pallas_v4")[0]
        sp, tp, centroids, h, w = ii.prepack_v4_batched(*args, tgt.intrinsics)

        def step(rot, trans):
            bases = k3.predict_bases_centroid_batched(rot, trans, centroids, tgt.intrinsics, sp.shape[1] * k3.CHUNK)
            return k4.icp_step_pallas_batched(rot, trans, *bases, sp, tp, tgt.intrinsics, h, w,
                                              k3.params_to_tuple(params))[:2]
        return step, params

    sources, targets = real_pairs(64, DEVICE)
    pose = Transform.exp(torch.tensor(K1_TWIST, device=DEVICE))
    rows, worst, timing = {}, 0.0, None
    for tgt, src, b in ((pyr0[0], pyr1[0], 1), (targets, sources, sources.points.shape[0])):
        shape = f"batch{b}"
        for engine in ("k1", "k8"):
            label = f"K11 on {engine.upper()}'s blocks at B = {b}"
            step, params = stepper(engine, tgt, src, b)
            w1, w2 = icp_fused._f32(params.weight), icp_fused._f32(params.color_weight)
            state = gn.GNState.start(pose.rotation.expand(b, 3, 3), pose.translation.expand(b, 3))
            rot_err = trans_err = 0.0
            selects = 0
            for it in range(GN_UPDATE_ITERATIONS):
                blocks = step(state.rot, state.trans)
                ref = gn.GNState(*(getattr(state, f).clone() for f in fields))
                gn.gn_update_plain(*blocks, w1, w2, ref)
                best, before = state.best_res.clone(), snapshot(("k11",))
                gn.gn_update(*blocks, w1, w2, state)
                torch.cuda.synchronize()
                launches = since(before)["k11"]
                if launches != 1:
                    raise AssertionError(f"{label}: {launches} launches for one update")
                for f in fields:
                    if not torch.equal(torch.isnan(getattr(state, f)), torch.isnan(getattr(ref, f))):
                        raise AssertionError(f"{label}, iteration {it}: NaN in other places of {f} than the twin's")
                chosen, chosen_ref = state.best_res != best, ref.best_res != best
                if not (torch.equal(state.best_res, ref.best_res) and torch.equal(chosen, chosen_ref)):
                    raise AssertionError(f"{label}, iteration {it}: best residuals or selects differ from the twin's")
                selects += int(chosen.sum())
                for r in ("rot", "best_rot"):
                    rot_err = max(rot_err, float((getattr(state, r) - getattr(ref, r)).nan_to_num(0.0).abs().max()))
                for t in ("trans", "best_trans"):
                    gap = (getattr(state, t) - getattr(ref, t)).nan_to_num(0.0).abs().amax(-1)
                    scale = getattr(ref, t).nan_to_num(0.0).abs().amax(-1).clamp(min=torch.finfo(torch.float32).tiny)
                    trans_err = max(trans_err, float((gap / scale).max()))
            if not (rot_err <= GN_UPDATE_ATOL and trans_err <= GN_UPDATE_ATOL):
                raise AssertionError(f"{label}: poses {rot_err:.2e} rad / {trans_err:.2e} relative from the twin's")
            if selects < b:
                raise AssertionError(f"{label}: {selects} selects in {GN_UPDATE_ITERATIONS} iterations")
            worst = max(worst, rot_err, trans_err)
            blocks = step(state.rot, state.trans)
            kstate = gn.GNState(*(getattr(state, f).clone() for f in fields))
            pstate = gn.GNState(*(getattr(state, f).clone() for f in fields))
            kt = timings(torch, lambda: gn.gn_update(*blocks, w1, w2, kstate), kernel=KERNEL_NAMES["k11"][0])
            pt = timings(torch, lambda: gn.gn_update_plain(*blocks, w1, w2, pstate))
            rows[f"{engine}_{shape}"] = {"pairs": b, "rot_err": rot_err, "trans_rel_err": trans_err,
                                         "selects": selects, "ms": kt[0], "call_ms": kt[1], "plain_ms": pt[0],
                                         "plain_call_ms": pt[1], **bound(b * GN_UPDATE_BYTES, 0)}
            print(f"{label}: {GN_UPDATE_ITERATIONS} iterations, {selects} selects, best residuals and selects "
                  f"equal the twin's, poses within {rot_err:.2e} rad / {trans_err:.2e} relative; "
                  f"{kt[0]} ms a launch against the twin's {pt[0]} ms")
            if engine == "k1" and b == 1:
                timing = (kt, pt, bound(GN_UPDATE_BYTES, 0))
    del sources, targets
    return (worst, *timing, {"library_ms": None, "library_reason":
                             "no PyTorch call does the merge, the solve, the SE(3) update and the select"}), rows


def pyramid_bytes(b: int, h: int, w: int, level: int) -> int:
    """Least bytes of one pyramid level of ``b`` frames of (h, w) (the level
    itself for level 0, else the finer level's size): each input read once,
    each output written once. Level 0 reads int32 depth and u8 colour and
    writes points, normals, mask, luma and the (h+2, w+2) map; a coarser
    level reads the finer points, normals, mask and colour and writes those
    four, luma and the map at (h/2, w/2)."""
    if level == 0:
        return b * (h * w * (4 + 3 + 12 + 12 + 1 + 1) + (h + 2) * (w + 2) * 4)
    dh, dw = h // 2, w // 2
    return b * (h * w * (12 + 12 + 1 + 3) + dh * dw * (12 + 12 + 1 + 3 + 1) + (dh + 2) * (dw + 2) * 4)


def check_pyramid(torch) -> dict:
    """Phase 3: K12 and K13 against their twin (``ops/pyramid.py::
    pyramid_plain``) on the card, sample1 frame 1 (B = 1) and the 65 frames
    of ``series.real_frames`` (B = 65, per-frame scales) at 640x480, three
    levels: every output of every level bitwise, one launch a level. Times
    each launch (device ms from the profiler, checked to be the kernel
    alone), the whole 3-launch build and the plain chain (device ms and
    per-call ms of back-to-back calls) beside the byte bound."""
    import numpy as np

    from align3d_torch.io.datasets import SlamTbDataset
    from align3d_torch.ops import pyramid as pyr
    from align3d_torch.tools import series

    frame = SlamTbDataset.load(str(SAMPLE1)).get(1)
    s = series.real_frames()
    shapes = {
        "batch1": (frame.camera, float(frame.image.depth_scale), torch.from_numpy(frame.image.color).to(DEVICE),
                   torch.from_numpy(frame.image.depth.astype(np.int32)).to(DEVICE)),
        f"batch{len(s)}": (s.camera, torch.from_numpy(s.depth_scales).to(DEVICE),
                           torch.from_numpy(s.colors).to(DEVICE),
                           torch.from_numpy(s.depths.astype(np.int32)).to(DEVICE)),
    }
    rows = {}
    for label, (camera, scale, color, depth) in shapes.items():
        b = 1 if depth.ndim == 2 else depth.shape[0]
        h, w = depth.shape[-2:]
        args = (True, True, 3, 1.0, camera, scale, color, depth)
        before = snapshot(("k12", "k13"))
        got = pyr.build(*args)
        torch.cuda.synchronize()
        launches = since(before)
        if (launches["k12"], launches["k13"]) != (1, 2):
            raise AssertionError(f"pyramid {label}: {launches['k12']} K12 and {launches['k13']} K13 launches "
                                 "for a 3-level build")
        ref = pyr.pyramid_plain(*args)
        for k, (g, r) in enumerate(zip(got, ref)):
            for field in pyr.Level._fields:
                a, c = getattr(g, field), getattr(r, field)
                same = a.dtype == c.dtype and a.shape == c.shape and torch.equal(
                    a.view(torch.int32) if a.dtype == torch.float32 else a,
                    c.view(torch.int32) if c.dtype == torch.float32 else c)
                if not same:
                    raise AssertionError(f"pyramid {label}: level {k} {field} differs from the twin's")
        k12 = timings(torch, lambda: pyr.pyramid_base(depth, color, scale, camera, True, True),
                      kernel=KERNEL_NAMES["k12"][0])
        k13 = [timings(torch, lambda lv=lv: pyr.pyramid_down(lv, 1.0, True), kernel=KERNEL_NAMES["k13"][0])
               for lv in got[:2]]
        whole = timings(torch, lambda: pyr.build(*args))
        plain = timings(torch, lambda: pyr.pyramid_plain(*args), n=10, profiled=3)
        sizes = [(h >> k, w >> k) for k in range(3)]
        nbytes = [pyramid_bytes(b, h, w, 0), pyramid_bytes(b, *sizes[0], 1), pyramid_bytes(b, *sizes[1], 2)]
        row = {"frames": b, "bitwise": True,
               "k12": {"ms": k12[0], "call_ms": k12[1], **bound(nbytes[0], 0)},
               "k13_level1": {"ms": k13[0][0], "call_ms": k13[0][1], **bound(nbytes[1], 0)},
               "k13_level2": {"ms": k13[1][0], "call_ms": k13[1][1], **bound(nbytes[2], 0)},
               "build": {"ms": whole[0], "call_ms": whole[1], **bound(sum(nbytes), 0)},
               "plain": {"ms": plain[0], "call_ms": plain[1]}}
        rows[label] = row
        print(f"pyramid K12/K13 {label}: bitwise the twin at every level, 1 K12 + 2 K13 a build; "
              f"K12 {k12[0]} ms (bound {row['k12']['bound_ms']:.4f}), K13 {k13[0][0]} / {k13[1][0]} ms "
              f"(bounds {row['k13_level1']['bound_ms']:.4f} / {row['k13_level2']['bound_ms']:.4f}); "
              f"build {whole[0]} ms device, {whole[1]:.4f} ms a call; plain chain {plain[0]} ms device, "
              f"{plain[1]:.4f} ms a call")
    return rows


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


def reciprocal_division_move(torch, TransformMetrics, subset, builder, first) -> dict:
    """4a's odometry once more with every ``div_scalar`` site dividing by a
    Python number, which CUDA turns into a product with the float32
    reciprocal (the port before the division fix): how far the trajectory
    moves against ``first``, the run on this code."""
    from align3d_torch import camera, se3
    from align3d_torch.icp.params import MsIcpParams
    from align3d_torch.odometry import run_odometry
    from align3d_torch.ops import intensity

    saved = [(m, m.div_scalar) for m in (camera, se3, intensity)]
    try:
        for m, _ in saved:
            m.div_scalar = lambda x, c: x / c
        before = run_odometry(subset, DEVICE, range_builder=builder, icp_params=MsIcpParams.default())
    finally:
        for m, f in saved:
            m.div_scalar = f
    a, b = before.trajectory.camera_to_world, first.trajectory.camera_to_world
    diff = TransformMetrics.new(a, b)
    return {"max_rad": float(diff.angle.max()), "max_m": float(diff.translation.max()),
            "mean_rad": float(diff.angle.mean()), "mean_m": float(diff.translation.mean()),
            "bitwise": torch.equal(a.rotation, b.rotation) and torch.equal(a.translation, b.translation)}


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
    before = snapshot(("nn",))
    first = icp.align(*source)
    launches = since(before)["nn"]
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
    before = snapshot(("mesh",))
    tea = mesh.MeshNormals(teapot.faces, len(teapot.points), device=DEVICE)(torch.from_numpy(teapot.points).to(DEVICE))
    grid_normals = mesh.MeshNormals(grid_faces, len(grid_pts), device=DEVICE)(torch.from_numpy(grid_pts).to(DEVICE))
    torch.cuda.synchronize()
    launches = since(before)["mesh"]
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


def snapshot(names) -> dict:
    """The counts of ``names`` (keys of :data:`COUNTS`) so far in this process."""
    from align3d_torch import _kernels
    from align3d_torch.ops import bilateral

    got = _kernels.launches()
    return {n: bilateral.NORMALIZE_PASSES if COUNTS[n] is None else got[COUNTS[n]] for n in names}


def since(before: dict) -> dict:
    """The counts of ``before``'s names since that :func:`snapshot`."""
    now = snapshot(before)
    return {n: now[n] - before[n] for n in before}


def graphs_since(before: dict | None = None) -> dict:
    """The image ICP levels' CUDA graphs captured and replayed
    (``align3d_torch/icp/level_graph.py``) so far, or since ``before``."""
    from align3d_torch.icp import level_graph

    return {k: n - (before[k] if before else 0) for k, n in level_graph.counts().items()}


def throughput_path(torch, real, mixed, counters) -> dict:
    """Phase 4d: ``odometry_step`` on the 64-pair real series, bilateral off
    and bucketed on, then the mixed series; the checks of the module
    docstring. ``counters``: the names of the launch counts it reads (:data:`COUNTS`)."""
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
        before = snapshot(counters)
        traj = pb.odometry_step(real.camera, scales, colors, depths, params, bilateral_filter=f, device=DEVICE)
        torch.cuda.synchronize()
        launches = since(before)
        plan = bucket_plan(real.depths, filt)
        want = {"icp": STEP_ITERATIONS, "splat": len(plan) if f else 0, "slice": len(plan) if f else 0,
                "slice_a": 0, "normalize": 0, "k11": STEP_ITERATIONS}
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
    before = snapshot(counters)
    torch.cuda.reset_peak_memory_stats()
    mtraj = pb.odometry_step(mixed.camera, mscales, mcolors, mdepths, params, bilateral_filter=filt, device=DEVICE)
    torch.cuda.synchronize()
    mlaunch = since(before)
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
                "normalize": 0, "k11": STEP_ITERATIONS * pairs}

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
            before = snapshot(counters)
            if cli.main(argv[:3] + [str(frames)] + argv[3:] + extra) != 0:
                raise RuntimeError(f"the {name} TUM run exited non-zero")
            runs[name] = since(before)
        want = {"cut": expected(TUM_CUT, TUM_CUT - 1), "resumed": expected(FRAMES - TUM_CUT + 1, FRAMES - TUM_CUT)}
        resumed, next_frame = load_odometry(str(ck))

        # One uninterrupted run, plain; then the same frames prefetched.
        before = snapshot(counters)
        plain, plain_ms = run_timed(TumRgbdDataset.load(str(tree)))
        runs["uninterrupted"] = since(before)
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
    before, graphs0 = snapshot(counters), graphs_since()
    t0 = time.perf_counter()
    raw = run_odometry(ds, DEVICE, icp_params=cheap)
    refined = refine_with_loop_closures(ds, raw, DEVICE, **kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, graphs = since(before), graphs_since(graphs0)
    closures = pg.propose_loop_closures(raw.trajectory, **{k: kwargs[k] for k in kwargs if k != "closure_weight"})
    # K1 once a GN iteration: the cheap odometry's 3 levels x 2 iterations a
    # pair, and MsIcpParams.default()'s 70 a closure; no filter, so no K2/K3.
    want = {"icp": (len(PALINDROME) - 1) * 3 * CHEAP_ITERATIONS + STEP_ITERATIONS * len(closures),
            "splat": 0, "slice": 0, "slice_a": 0, "normalize": 0}
    want["k11"] = want["icp"]  # K11 once a GN iteration, beside K1
    raw_t, ref_t = float(raw.metrics.translation), float(refined.metrics.translation)
    raw_a, ref_a = math.degrees(float(raw.metrics.angle)), math.degrees(float(refined.metrics.angle))
    poses = refined.trajectory.camera_to_world
    gap = float(torch.linalg.norm((poses[0].inverse() @ poses[last]).log()))
    out = {"frames": PALINDROME, "closures": closures.tolist(), "launches": launches, "launches_expected": want,
           "level_graphs": graphs, "ate_translation": {"odometry": raw_t, "refined": ref_t}, "ate_angle_deg": {"odometry": raw_a,
                                                                                       "refined": ref_a},
           "revisit_gap": gap, "wall_s": wall}
    failures = []
    if launches != want:
        failures.append(f"8a: launches {launches}, expected {want}")
    if DEVICE == "cuda" and graphs["replays"] <= 0:
        failures.append(f"8a: no level replayed its CUDA graph: {graphs}")
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
        before, graphs0 = snapshot(counters), graphs_since()
        t0 = time.perf_counter()
        rc = cli.main(["odometry", "tum", str(tree), "--loop-closure", "--save-trajectory", str(saved), "-q",
                       "--device", DEVICE])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, graphs = since(before), graphs_since(graphs0)
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
    want["k11"] = want["icp"]
    from_cli = Trajectory.from_tum(text).to(DEVICE).camera_to_world
    same_text = text == direct.trajectory.to_tum()
    gap = max_pose_gap(torch, from_cli, direct.trajectory.camera_to_world)
    out = {"exit_code": rc, "closures": len(closures), "launches": launches, "launches_expected": want,
           "level_graphs": graphs, "saved_tum_text_equal_direct": same_text, "saved_vs_direct_max_abs": gap, "wall_s": wall,
           "ate_translation": {"odometry": float(raw.metrics.translation),
                               "refined": float(direct.metrics.translation)}}
    failures = []
    if rc != 0:
        failures.append(f"8b: the command line exited {rc}")
    if launches != want:
        failures.append(f"8b: launches {launches}, expected {want}")
    if DEVICE == "cuda" and graphs["replays"] <= 0:
        failures.append(f"8b: no level replayed its CUDA graph: {graphs}")
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


def stage_ms(timer) -> dict:
    """A StageTimer's totals in ms, by stage."""
    return {name: total * 1e3 for name, total in timer.totals.items()}


def launch_want(real, filt) -> dict:
    """K1/K2/K3 launches of one filtered step over ``real``'s frames: 70 K1
    (one a GN iteration over all pairs), one K2 and one K3 a depth bucket."""
    from align3d_torch.tools.series import bucket_plan

    buckets = len(bucket_plan(real.depths, filt))
    return {"icp": STEP_ITERATIONS, "splat": buckets, "slice": buckets, "slice_a": 0, "normalize": 0,
            "k11": STEP_ITERATIONS}


def distribution_paths(torch, mesh, counters, device) -> dict:
    """Phase 9a-9d on ``mesh``, as one rank runs them: the sharded step and
    the sequence-parallel step on the real series (filter on), each with
    K1-K3's counts read just before and just after, its stages timed
    (StageTimer), its device busy ms and the peak memory; the 500-pose graph
    (CG) and the 9-pose ring (dense) with edges sharded; BA at 500 x 50k x
    200k (COO) and the 6 x 40 scene (dense) with observations sharded.
    Returns CPU tensors and numbers."""
    from align3d_torch.icp.params import MsIcpParams
    from align3d_torch.ops.bilateral import BilateralFilter
    from align3d_torch.parallel import bundle_adjustment as ba
    from align3d_torch.parallel import collectives as col
    from align3d_torch.parallel import pose_graph as pg
    from align3d_torch.parallel.batch import odometry_step
    from align3d_torch.parallel.sequence import odometry_sequence_parallel
    from align3d_torch.tools import series
    from align3d_torch.utils.profiling import StageTimer

    real = series.real_frames()
    colors, depths, scales = (t.to(device) for t in series_inputs(torch, real))
    filt, params = BilateralFilter(), MsIcpParams.default()
    steps = {"step": lambda timer=None: odometry_step(real.camera, scales, colors, depths, params, mesh=mesh,
                                                      bilateral_filter=filt, timer=timer),
             "sequence": lambda timer=None: odometry_sequence_parallel(real.camera, scales, colors, depths, mesh,
                                                                      params, bilateral_filter=filt, timer=timer)}
    out = {"rank": col.rank(mesh), "world": col.world(mesh), "backend": torch.distributed.get_backend(mesh.get_group()),
           "launches_expected_unsharded": launch_want(real, filt)}
    for name, run in steps.items():
        run()  # warm: the first call plans and builds what the later ones reuse
        torch.cuda.synchronize()
        timer = StageTimer()
        torch.cuda.reset_peak_memory_stats()
        before = snapshot(counters)
        t0 = time.perf_counter()
        traj = run(timer)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
        launches = since(before)
        peak = torch.cuda.max_memory_allocated()
        out[name] = {"poses": (traj.camera_to_world.rotation.cpu(), traj.camera_to_world.translation.cpu()),
                     "launches": launches, "host_ms": host, "stage_host_ms": stage_ms(timer),
                     "peak_memory_bytes": peak, **device_profile(torch, run)}

    graph, _ = ring_graph(torch, pg, PG_POSES)
    graph = graph_to(pg, graph, device)

    def pg_run(cg_iters):
        return pg.optimize(graph, iterations=PG_ITERATIONS, solver="cg", mesh=mesh,
                           cg_iters=PG_CG_ITERS if cg_iters is None else cg_iters)

    def collectives(fn):
        before = col.COLLECTIVES
        result = fn()
        return col.COLLECTIVES - before, result

    # Collectives a PCG trip: a solve's, less the same solve's with no trips.
    full, (pg_host, nodes) = collectives(lambda: host_ms(torch, lambda: pg_run(None), runs=1))
    zero, _ = collectives(lambda: pg_run(0))
    out["pose_graph"] = {"poses": (nodes.rotation.cpu(), nodes.translation.cpu()), "host_ms": pg_host,
                         "collectives_per_optimize": full,
                         "collectives_per_pcg_trip": (full - zero) / (PG_ITERATIONS * PG_CG_ITERS)}
    dense, _ = ring_graph(torch, pg, 9)
    dnodes = pg.optimize(graph_to(pg, dense, device), iterations=PG_ITERATIONS, solver="dense", mesh=mesh)
    out["pose_graph_dense"] = {"poses": (dnodes.rotation.cpu(), dnodes.translation.cpu())}

    problem = problem_to(ba_large(torch, ba, *BA_SIZE), device)

    def ba_run(cg_iters):
        return ba.optimize(problem, iterations=BA_ITERATIONS, solver="coo", mesh=mesh, cg_iters=cg_iters)

    full, (ba_host, (bp, bl)) = collectives(lambda: host_ms(torch, lambda: ba_run(BA_CG_ITERS), runs=1))
    zero, _ = collectives(lambda: ba_run(0))
    out["bundle_adjustment"] = {"poses": (bp.rotation.cpu(), bp.translation.cpu()), "landmarks": bl.cpu(),
                                "host_ms": ba_host, "collectives_per_optimize": full,
                                "collectives_per_pcg_trip": (full - zero) / (BA_ITERATIONS * BA_CG_ITERS)}
    scene, _, _ = ba_scene(torch, ba)
    sp, sl = ba.optimize(problem_to(scene, device), iterations=8, solver="dense", mesh=mesh)
    out["bundle_adjustment_dense"] = {"poses": (sp.rotation.cpu(), sp.translation.cpu()), "landmarks": sl.cpu()}
    return out


def distribution_rank(rank: int, world: int, store: str, out_dir: str, device: str) -> None:
    """One rank of phase 9's two-rank run: both ranks on the current card,
    over gloo (named explicitly: NCCL refuses two ranks on one device)."""
    import datetime

    import torch

    from align3d_torch.parallel import multihost

    torch.set_num_threads(2)
    multihost.initialize(f"file://{store}", world, rank, local_device_ids=[0] if device == "cuda" else None,
                         backend="gloo", timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        mesh = multihost.global_mesh(devices=device)
        out = distribution_paths(torch, mesh, ODOMETRY_COUNTS, torch.device(device))
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def spawn_ranks(fn, world: int, workdir: str, *args) -> None:
    """``fn(rank, world, store, *args)`` in ``world`` new processes; raises
    if one raises or if they are not done within DIST_TIMEOUT_S (then all
    are killed)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(world, f"{workdir}/store", *args), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + DIST_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks still running after {DIST_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)


def pose_gap_pair(torch, a, b) -> float:
    """Largest |difference| of two (rotation, translation) pairs."""
    return max(float((a[0] - b[0]).abs().max()), float((a[1] - b[1]).abs().max()))


def bitwise_pair(torch, a, b) -> bool:
    return bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))


def distribution(torch, dataset, counters, trip_activities_8c=None) -> tuple[dict, list]:
    """Phase 9; returns (what it measured, its failures).
    ``trip_activities_8c``: phase 8c's device activities a PCG trip, printed
    beside the sharded trip's."""
    import tempfile

    from align3d_torch.icp.params import MsIcpParams
    from align3d_torch.io.datasets import SubsetDataset
    from align3d_torch.ops.bilateral import BilateralFilter
    from align3d_torch.odometry import refine_with_loop_closures, run_odometry
    from align3d_torch.optim.pcg import pcg
    from align3d_torch.parallel import bundle_adjustment as ba
    from align3d_torch.parallel import collectives as col
    from align3d_torch.parallel import pose_graph as pg
    from align3d_torch.parallel.batch import make_mesh, odometry_step
    from align3d_torch.tools import series

    t0 = time.perf_counter()
    failures = []
    # The unsharded references, on the card.
    real = series.real_frames()
    colors, depths, scales = series_inputs(torch, real)
    traj = odometry_step(real.camera, scales, colors, depths, MsIcpParams.default(), bilateral_filter=BilateralFilter(),
                         device=DEVICE)
    ref = {"step": (traj.camera_to_world.rotation.cpu(), traj.camera_to_world.translation.cpu())}
    graph = graph_to(pg, ring_graph(torch, pg, PG_POSES)[0], DEVICE)
    nodes = pg.optimize(graph, iterations=PG_ITERATIONS, solver="cg", cg_iters=PG_CG_ITERS)
    ref["pose_graph"] = (nodes.rotation.cpu(), nodes.translation.cpu())
    dnodes = pg.optimize(graph_to(pg, ring_graph(torch, pg, 9)[0], DEVICE), iterations=PG_ITERATIONS, solver="dense")
    ref["pose_graph_dense"] = (dnodes.rotation.cpu(), dnodes.translation.cpu())
    problem = problem_to(ba_large(torch, ba, *BA_SIZE), DEVICE)
    bp, bl = ba.optimize(problem, iterations=BA_ITERATIONS, solver="coo", cg_iters=BA_CG_ITERS)
    ref["bundle_adjustment"] = (bp.rotation.cpu(), bp.translation.cpu(), bl.cpu())
    sp, sl = ba.optimize(problem_to(ba_scene(torch, ba)[0], DEVICE), iterations=8, solver="dense")
    ref["bundle_adjustment_dense"] = (sp.rotation.cpu(), sp.translation.cpu(), sl.cpu())
    del traj, graph, nodes, problem

    def held(world_out: dict, label: str) -> dict:
        """Each path's gap to the unsharded reference; failures appended."""
        gaps = {}
        for name in ("step", "sequence"):
            same = bitwise_pair(torch, world_out[name]["poses"], ref["step"])
            gaps[name] = {"bitwise": same, "max_abs": pose_gap_pair(torch, world_out[name]["poses"], ref["step"])}
            if not same:
                failures.append(f"9{'a' if name == 'step' else 'b'} ({label}): {name} is not bitwise the unsharded "
                                f"step ({gaps[name]['max_abs']})")
        for name in ("pose_graph", "pose_graph_dense"):
            gaps[name] = pose_gap_pair(torch, world_out[name]["poses"], ref[name])
        for name in ("bundle_adjustment", "bundle_adjustment_dense"):
            got = world_out[name]
            gaps[name] = max(pose_gap_pair(torch, got["poses"], ref[name][:2]),
                             float((got["landmarks"] - ref[name][2]).abs().max()))
        for name in ("pose_graph", "pose_graph_dense", "bundle_adjustment", "bundle_adjustment_dense"):
            if not gaps[name] <= DIST_SOLVE_ATOL:
                failures.append(f"9{'c' if 'pose' in name else 'd'} ({label}): {name} is {gaps[name]} from unsharded")
        return gaps

    def summary(world_out: dict) -> dict:
        """What a rank measured, without its tensors."""
        out = {}
        for k, v in world_out.items():
            if isinstance(v, dict):
                out[k] = {kk: vv for kk, vv in v.items() if kk not in ("poses", "landmarks")}
            else:
                out[k] = v
        return out

    # -- world 1: NCCL, in this process ----------------------------------------
    mesh = make_mesh(devices=DEVICE)
    w1 = distribution_paths(torch, mesh, counters, torch.device(DEVICE))
    out = {"world1": {"backend": w1["backend"], "gaps": held(w1, "world 1"), **summary(w1)}}
    for name in ("step", "sequence"):
        if w1[name]["launches"] != w1["launches_expected_unsharded"]:
            failures.append(f"9{'a' if name == 'step' else 'b'} (world 1): launches {w1[name]['launches']}, "
                            f"expected {w1['launches_expected_unsharded']}")
    # PCG at world 1: launches and device time a trip (against phase 8c's),
    # and no host sync in a trip (one PCG call under sync debug "error").
    graph = graph_to(pg, ring_graph(torch, pg, PG_POSES)[0], DEVICE)

    def pg_run(cg_iters):
        return pg.optimize(graph, iterations=PG_ITERATIONS, solver="cg", mesh=mesh,
                           cg_iters=PG_CG_ITERS if cg_iters is None else cg_iters)

    full, zero = device_profile(torch, lambda: pg_run(None)), device_profile(torch, lambda: pg_run(0))
    trips = PG_ITERATIONS * PG_CG_ITERS
    out["world1"]["pose_graph"]["per_pcg_trip"] = {
        "device_activities": (full["device_activities"] - zero["device_activities"]) / trips,
        "device_activities_unsharded_8c": trip_activities_8c,
        "device_busy_ms": (full["device_busy_ms"] - zero["device_busy_ms"]) / trips}
    hdiag, hij, g = pg._block_system(graph.nodes, graph.edges, graph.measurements, graph.weights, PG_POSES)
    hdiag, g = col.all_reduce(mesh, hdiag, g)
    matvec, precond = pg._cg_operators(pg._finalize_diag(hdiag, 1e-6), hij, graph.edges, mesh)
    torch.cuda.synchronize()
    sync_error = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        pcg(matvec, precond, g, PG_CG_ITERS)
    except RuntimeError as exc:
        sync_error = str(exc).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out["world1"]["pose_graph"]["pcg_sync_error"] = sync_error
    if sync_error is not None:
        failures.append(f"9c (world 1): a sharded PCG trip synchronised with the host: {sync_error}")
    for name, want in (("pose_graph", 1), ("bundle_adjustment", 2)):
        if w1[name]["collectives_per_pcg_trip"] != want:
            failures.append(f"9{'c' if 'pose' in name else 'd'}: {w1[name]['collectives_per_pcg_trip']} "
                            f"collectives a PCG trip, expected {want}")
    del graph, hdiag, hij, g

    # 9e: refine_with_loop_closures(mesh=) on 8a's palindrome.
    ds = SubsetDataset(dataset, PALINDROME)
    cheap = MsIcpParams.default().customize(lambda _, p: p.replace(max_iterations=CHEAP_ITERATIONS))
    kwargs = {"min_separation": len(PALINDROME) - 2, "max_translation": 0.5, "max_candidates": 4,
              "closure_weight": 20.0}
    raw = run_odometry(ds, DEVICE, icp_params=cheap)
    plain = refine_with_loop_closures(ds, raw, DEVICE, **kwargs).trajectory.camera_to_world
    before = snapshot(counters)
    sharded = refine_with_loop_closures(ds, raw, DEVICE, mesh=mesh, **kwargs).trajectory.camera_to_world
    gap = max_pose_gap(torch, plain, sharded)
    out["world1"]["refine_with_loop_closures"] = {"max_abs_vs_no_mesh": gap,
                                                  "bitwise": bitwise_pair(torch, (plain.rotation, plain.translation),
                                                                          (sharded.rotation, sharded.translation)),
                                                  "launches": since(before)}
    if not gap <= CLI_DIRECT_ATOL:
        failures.append(f"9e: refine_with_loop_closures(mesh=) is {gap} from the call without a mesh")
    torch.distributed.destroy_process_group()

    # -- world 2: two processes on this card, over gloo -------------------------
    with tempfile.TemporaryDirectory() as workdir:
        t2 = time.perf_counter()
        spawn_ranks(distribution_rank, 2, workdir, workdir, DEVICE)
        wall2 = time.perf_counter() - t2
        ranks = [torch.load(Path(workdir) / f"rank{r}.pt") for r in range(2)]
    out["world2"] = {"backend": ranks[0]["backend"], "ranks_on": "one card, explicitly over gloo",
                     "wall_s_including_process_start": wall2, "gaps": held(ranks[0], "world 2"),
                     "ranks": [summary(r) for r in ranks]}
    for r in ranks[1:]:
        for name in ("step", "sequence", "pose_graph", "pose_graph_dense"):
            if not bitwise_pair(torch, r[name]["poses"], ranks[0][name]["poses"]):
                failures.append(f"9 (world 2): rank {r['rank']}'s {name} differs from rank 0's")
    for r in ranks:  # K1 once a GN iteration over the rank's pairs; K2/K3 once a bucket of its frames
        for name in ("step", "sequence"):
            got = r[name]["launches"]
            if (got["icp"] != STEP_ITERATIONS or got["k11"] != STEP_ITERATIONS
                    or min(got["splat"], got["slice"]) < 1
                    or got["slice_a"] or got["normalize"]):
                failures.append(f"9 (world 2): rank {r['rank']}'s {name} launched {got}")
    out["phase_s"] = time.perf_counter() - t0
    return out, failures


# -- phase 10: viz ----------------------------------------------------------------

def lzw_decode(data: bytes, min_size: int, n: int) -> bytes:
    """GIF's variable-width LZW (any form, not only the literal one the
    port writes): ``n`` palette indices."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    size, acc, nbits, prev = min_size + 1, 0, 0, None
    table: list = []
    out = bytearray()
    for byte in data:
        acc |= byte << nbits
        nbits += 8
        while nbits >= size:
            code = acc & ((1 << size) - 1)
            acc >>= size
            nbits -= size
            if code == clear:
                table = [bytes([i]) for i in range(clear)] + [b"", b""]
                size, prev = min_size + 1, None
                continue
            if code == end:
                return bytes(out[:n])
            if prev is None:
                entry = table[code]
            else:
                entry = table[code] if code < len(table) else prev + prev[:1]
                if code > len(table):
                    raise ValueError(f"LZW code {code} beyond the table ({len(table)})")
                table.append(prev + entry[:1])
            out += entry
            prev = entry
            if len(table) == (1 << size) and size < 12:
                size += 1
    raise ValueError("LZW stream without an end code")


def gif_frames(data: bytes) -> list:
    """The frames of a GIF (full-size images on its global palette) as
    (H, W, 3) uint8 arrays."""
    import struct

    import numpy as np

    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF")
    packed = data[10]
    pos, palette = 13, None
    if packed & 0x80:
        size = 3 * (2 << (packed & 7))
        palette = np.frombuffer(data[pos:pos + size], np.uint8).reshape(-1, 3)
        pos += size
    frames = []
    while data[pos] != 0x3B:
        kind = data[pos]
        if kind == 0x21:  # extension: label, then sub-blocks
            pos += 2
            while data[pos]:
                pos += data[pos] + 1
            pos += 1
        elif kind == 0x2C:
            _, _, w, h, flags = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
            if flags & 0x80 or palette is None:
                raise ValueError("a local colour table is not read here")
            min_size, pos = data[pos + 10], pos + 11
            chunks = []
            while data[pos]:
                chunks.append(data[pos + 1:pos + 1 + data[pos]])
                pos += data[pos] + 1
            pos += 1
            index = np.frombuffer(lzw_decode(b"".join(chunks), min_size, w * h), np.uint8)
            frames.append(palette[index].reshape(h, w, 3))
        else:
            raise ValueError(f"unexpected GIF block 0x{kind:02x}")
    return frames


def fitted_camera(viewer, azimuth: float = 0.0, elevation: float = 0.0):
    """``GeoViewer.render_frame``'s camera."""
    from align3d_torch.viz.virtual_camera import VirtualCameraSphericalBuilder

    builder = VirtualCameraSphericalBuilder.fit(viewer.scene.bounding_sphere(), math.pi / 2.0)
    builder.azimuth, builder.elevation = azimuth, elevation
    builder.aspect_ratio = viewer.renderer.width / viewer.renderer.height
    return builder.build()


def same_render(torch, a, b) -> bool:
    return torch.equal(a.color.cpu(), b.color.cpu()) and torch.equal(
        a.depth.cpu().view(torch.int32), b.depth.cpu().view(torch.int32))


def card_against_cpu(torch, card_img, cpu_img) -> dict:
    cc, kc = card_img.color.cpu(), cpu_img.color
    dc, dk = card_img.depth.cpu(), cpu_img.depth
    both = torch.isfinite(dc) & torch.isfinite(dk)
    return {"color_equal_share": float((cc == kc).all(dim=-1).double().mean()),
            "max_abs_depth_diff": float((dc[both] - dk[both]).abs().max()) if bool(both.any()) else 0.0,
            "coverage_equal": torch.equal(torch.isfinite(dc), torch.isfinite(dk)),
            "covered_pixels": int(torch.isfinite(dc).sum()), "bitwise": same_render(torch, card_img, cpu_img)}


def render_on_both(torch, viewers: dict, render, cpu_runs: int = 3) -> dict:
    """``render(viewer)`` on the card and, where ``viewers`` has one, on the
    CPU: the card's rerun bitwise, host ms a render (median, ended by a
    synchronise) on each, the card's device busy ms (one profile) and peak
    memory, and the two renders against each other."""
    card = viewers[DEVICE]
    first = render(card)
    rerun = render(card)
    card_ms, _ = host_ms(torch, lambda: render(card))
    torch.cuda.reset_peak_memory_stats()
    render(card)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    prof = device_profile(torch, lambda: render(card))
    out = {"card_rerun_bitwise": same_render(torch, first, rerun), "host_ms": card_ms, **prof,
           "peak_memory_bytes": peak, "_image": first}
    if "cpu" in viewers:
        cpu_ms, cpu_img = host_ms(torch, lambda: render(viewers["cpu"]), runs=cpu_runs)
        out.update(cpu_host_ms=cpu_ms, cpu_runs=cpu_runs, card_vs_cpu=card_against_cpu(torch, first, cpu_img))
    return out


def fit_costs(torch, viewer) -> dict:
    """Host ms of the fitted spheres of every node (their world points, one
    K6 launch for the means, the radii, one copy back), and of a render with
    every node's fit dropped first: what each render paid before the fit was
    kept."""
    from align3d_torch.viz.sphere import Sphere3D

    nodes = [n for n in viewer.scene.nodes if n.visible]

    def refit():
        for n in nodes:
            n._sphere_of = None
        return viewer.render_frame()

    fit_ms, _ = host_ms(torch, lambda: Sphere3D.fit_many([n.world_points() for n in nodes]))
    refit_ms, _ = host_ms(torch, refit)
    return {"fit_host_ms": fit_ms, "host_ms_fit_every_render": refit_ms}


def scene_points(viewer) -> int:
    return sum(int(n.points.shape[0]) for n in viewer.scene.nodes if n.visible)


def check_sphere_mean(torch, viewer) -> tuple:
    """K6 against its twin on the world points of ``viewer``'s nodes, all in
    one launch as the scene's fit gives them, bitwise; its time beside the
    twin's (numpy on the host, the points already there) and
    ``torch.segment_reduce``'s mean (PyTorch's own reduction: not numpy's
    bits). The time is the wrapper's device work: the offsets' copy and K6.
    Returns ``entry``'s ``checked`` tuple and the nodes' sizes."""
    from align3d_torch.viz import sphere

    worlds = [n.world_points() for n in viewer.scene.nodes if n.visible]
    counts = [int(w.shape[0]) for w in worlds]
    pts = torch.cat(worlds)
    pts_cpu = pts.cpu()
    got, ref = sphere.numpy_means(pts, counts).cpu(), sphere.numpy_means_plain(pts_cpu, counts)
    lengths = torch.tensor(counts, device=pts.device)
    lib = torch.segment_reduce(pts, "mean", lengths=lengths, axis=0).cpu()
    print(f"K6 on {len(worlds)} nodes of {min(counts)}-{max(counts)} points, one launch: bitwise numpy's "
          f"means {torch.equal(got, ref)}; torch.segment_reduce differs by {float((lib - ref).abs().max())}")
    if not torch.equal(got, ref):
        raise AssertionError("K6 differs from numpy's mean")
    plain_ms, _ = host_ms(torch, lambda: sphere.numpy_means_plain(pts_cpu, counts))
    library = timings(torch, lambda: torch.segment_reduce(pts, "mean", lengths=lengths, axis=0))
    b = bound(pts.numel() * 4 + len(counts) * 12, pts.numel())  # the points once, the centres out; an add a coordinate
    return (float((got - ref).abs().max()), timings(torch, lambda: sphere.numpy_means(pts, counts)),
            (None, plain_ms), b, {"library_ms": library[0], "library_call_ms": library[1],
                                  "library_call": "torch.segment_reduce(points, 'mean', lengths, axis=0) "
                                                  "(a parallel reduction: not numpy's bits)",
                                  "library_max_abs_diff": float((lib - ref).abs().max())}), counts


def viz_dataset(torch, failures: list) -> dict:
    """10a and 10b."""
    import tempfile

    from align3d_torch.io import gif, png
    from align3d_torch.io.datasets import SlamTbDataset
    from align3d_torch.viz import dataset_viewer
    from align3d_torch.viz.viewers import GeoViewer, RgbdDatasetViewer

    out = {}
    t0 = time.perf_counter()
    preview = dataset_viewer.posed_viewer("slamtb", str(SAMPLE1), None, 640, 480, None, DEVICE).viewer
    torch.cuda.synchronize()
    out["preview_build_s"] = time.perf_counter() - t0
    # The CPU path renders the 8-frame scene only: all 31 frames on the CPU
    # would take phase 10 past a minute.
    scene = {}
    for d in (DEVICE, "cpu"):
        rgbd = RgbdDatasetViewer(SlamTbDataset.load(str(SAMPLE1)), 640, 480, device=d)
        rgbd.build_scene(max_frames=VIZ_SCENE_FRAMES)
        scene[d] = rgbd.viewer
    # The renderer alone: the CPU path's clouds uploaded to the card; and the
    # clouds built on each device, which must be equal (the backprojection
    # divides on the card as on the CPU).
    same = GeoViewer(640, 480, device=DEVICE)
    for node in scene["cpu"].scene.nodes:
        same.add(node.points.to(DEVICE), colors=node.colors.to(DEVICE), transform=node.transform)
    out["scene_8_frames_same_points_bitwise"] = same_render(torch, same.render_frame(), scene["cpu"].render_frame())
    card_pts = torch.cat([n.points.cpu() for n in scene[DEVICE].scene.nodes])
    cpu_pts = torch.cat([n.points for n in scene["cpu"].scene.nodes])
    out["scene_8_frames_clouds"] = {
        "points": int(cpu_pts.shape[0]), "coordinates_differing": int((card_pts != cpu_pts).sum()),
        "max_ulps": int((card_pts.view(torch.int32).long() - cpu_pts.view(torch.int32).long()).abs().max())}
    if not out["scene_8_frames_same_points_bitwise"]:
        failures.append("10a: the card's render of the CPU path's clouds differs from the CPU path's")
    if out["scene_8_frames_clouds"]["coordinates_differing"]:
        failures.append(f"10a: the clouds built on the card differ from the CPU's: {out['scene_8_frames_clouds']}")
    from align3d_torch.viz import sphere

    for name, viewers in (("preview_sample1", {DEVICE: preview}), ("scene_8_frames", scene)):
        before = snapshot(("k6",))
        got = render_on_both(torch, viewers, lambda v: v.render_frame())
        got["k6_launches"] = since(before)["k6"]  # one fit of all nodes, kept through every later render
        got["points"], got["nodes"] = scene_points(viewers[DEVICE]), len(viewers[DEVICE].scene.nodes)
        got.update(fit_costs(torch, viewers[DEVICE]))
        img = got.pop("_image")
        out[name] = got
        if not got["card_rerun_bitwise"]:
            failures.append(f"10a: {name}: a rerun on the card differs")
        if got["k6_launches"] != 1:
            failures.append(f"10a: {name}: {got['k6_launches']} K6 launches for {got['nodes']} nodes, not 1")
        if "card_vs_cpu" in got and not got["card_vs_cpu"]["bitwise"]:
            failures.append(f"10a: {name}: card against CPU {got['card_vs_cpu']}")
        if name == "preview_sample1":
            out["k6"], out["k6_node_points"] = check_sphere_mean(torch, preview)
            with tempfile.TemporaryDirectory() as tmp:
                path = Path(tmp) / "preview.png"
                dataset_viewer.render_dataset_preview("slamtb", str(SAMPLE1), str(path), device=DEVICE)
                out["render_dataset_preview_equal_direct"] = bool(
                    (png.read(path) == img.color.cpu().numpy()).all())
            if not out["render_dataset_preview_equal_direct"]:
                failures.append("10a: render_dataset_preview's PNG differs from the direct render")
    del scene, same

    # 10b: the fly-through, 480x360, 24 views.
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "fly.gif"
        t0 = time.perf_counter()
        dataset_viewer.render_dataset_flythrough("slamtb", str(SAMPLE1), str(path), n_views=VIZ_VIEWS, device=DEVICE)
        wall = time.perf_counter() - t0
        data = path.read_bytes()
    t0 = time.perf_counter()
    frames = gif_frames(data)
    decode_s = time.perf_counter() - t0
    direct = GeoViewer(480, 360, device=DEVICE)  # the preview's scene at the fly-through's size
    direct.scene = preview.scene
    worst, exact = [0, 0, 0], True
    for frame, (az, el) in zip(frames, dataset_viewer.flythrough_views(VIZ_VIEWS)):
        want = direct.render_frame(azimuth=az, elevation=el).color[..., :3].cpu().numpy()
        err = abs(frame.astype("int32") - want.astype("int32")).max(axis=(0, 1))
        worst = [max(w, int(e)) for w, e in zip(worst, err)]
        exact &= bool((frame == gif.PALETTE[gif.quantize(want)]).all())
    del preview, direct
    out["flythrough"] = {"host_s": wall, "gif_bytes": len(data), "frames": len(frames), "size": [480, 360],
                         "lzw_reader_s": decode_s, "max_abs_err_rgb": worst, "palette_bound_rgb": list(gif.BOUND),
                         "decoded_equal_quantized_render": exact}
    if len(frames) != VIZ_VIEWS or any(w > b for w, b in zip(worst, gif.BOUND)) or not exact:
        failures.append(f"10b: the GIF's frames against the card's renders: {out['flythrough']}")
    return out


def viz_meshes(torch, failures: list) -> dict:
    """10c: meshes with ``normals=None`` through a Scene's mesh node."""
    from align3d_torch.io import read_ply
    from align3d_torch.ops import mesh
    from align3d_torch.tools.ablate import grid_mesh
    from align3d_torch.viz import render
    from align3d_torch.viz.viewers import GeoViewer

    def grid(side):
        # The grid spans side x side units; the fitted camera's far plane is
        # the reference's 100 units, so scale it to 4 x 4 (heights +-1).
        pts, faces = grid_mesh(side)
        pts[:, :2] *= 4.0 / side
        return pts, faces

    teapot = read_ply(ROOT / "tests" / "data" / "teapot.ply")
    out = {}
    for name, (pts, faces) in (("teapot", (teapot.points, teapot.faces)), ("grid320", grid(320)),
                               ("grid1280", grid(1280))):
        viewers = {}
        for d in (DEVICE, "cpu"):
            viewers[d] = GeoViewer(640, 480, device=d)
            viewers[d].add(pts, faces=faces)
        camera = fitted_camera(viewers[DEVICE], 0.3, 0.4)

        def draw(v):
            return v.scene.render(v.renderer, camera)

        before = snapshot(("mesh",))
        draw(viewers[DEVICE])
        draw(viewers[DEVICE])
        torch.cuda.synchronize()
        two = since(before)["mesh"]
        got = render_on_both(torch, viewers, draw, cpu_runs=1 if len(faces) > 1_000_000 else 3)
        got.pop("_image")
        world = viewers[DEVICE].scene.nodes[0].world_points()
        x, y, z, ok = render._project(camera, world, 640, 480)
        got["pairs"] = int(render._FaceRaster(x, y, z, ok, viewers[DEVICE].scene.nodes[0].faces, 640, 480)
                           .counts.sum())
        got["faces"], got["k5_launches_two_renders"] = int(len(faces)), two
        out[name] = got
        if two != 2:
            failures.append(f"10c: {name}: K5 launched {two} times in two renders of one mesh node")
        if not got["card_rerun_bitwise"] or got["card_vs_cpu"]["color_equal_share"] < VIZ_CARD_CPU_SHARE:
            failures.append(f"10c: {name}: {got['card_vs_cpu']}, rerun bitwise {got['card_rerun_bitwise']}")
    return out


def viz_cli(torch, counters, failures: list, odometry_launches: dict) -> dict:
    """10d: the command line's viewer and odometry --show on the card."""
    import contextlib
    import io
    import tempfile

    from align3d_torch import cli
    from align3d_torch.io import png
    from align3d_torch.viz import dataset_viewer

    out = {}
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
        p = Path(tmp) / "p.png"
        t0 = time.perf_counter()
        cli.main(["viewer", "slamtb", str(SAMPLE1), "-o", str(p), "--max-frames", str(VIZ_SCENE_FRAMES),
                  "--device", DEVICE])
        out["viewer_png_s"] = time.perf_counter() - t0
        direct = dataset_viewer.posed_viewer("slamtb", str(SAMPLE1), VIZ_SCENE_FRAMES, 640, 480, None, DEVICE)
        out["viewer_png_equal_direct"] = bool((png.read(p) == direct.viewer.render_frame().color.cpu().numpy()).all())
        t0 = time.perf_counter()
        cli.main(["viewer", "slamtb", str(SAMPLE1), "-o", str(Path(tmp) / "fly"), "--max-frames",
                  str(VIZ_SCENE_FRAMES), "--animate", "--device", DEVICE])
        out["viewer_animate_s"] = time.perf_counter() - t0
        out["viewer_animate_frames"] = len(gif_frames((Path(tmp) / "fly.gif").read_bytes()))
        s = Path(tmp) / "s.png"
        before = snapshot(counters)
        t0 = time.perf_counter()
        cli.main(["odometry", "slamtb", str(SAMPLE1), str(FRAMES), "--show", str(s), "--device", DEVICE, "-q"])
        out["odometry_show_s"] = time.perf_counter() - t0
        out["odometry_show_launches"] = since(before)
        shown = png.read(s)
        out["odometry_show_png"] = {"shape": list(shown.shape), "lit_pixels": int((shown[..., :3] > 0).any(-1).sum())}
    if not out["viewer_png_equal_direct"]:
        failures.append("10d: viewer -o p.png differs from the direct render")
    if out["viewer_animate_frames"] != VIZ_VIEWS:
        failures.append(f"10d: viewer --animate wrote {out['viewer_animate_frames']} frames")
    want = {**odometry_launches, "slice_a": 0, "normalize": 0, "mesh": 0, "k11": odometry_launches["icp"]}
    if out["odometry_show_launches"] != want:
        failures.append(f"10d: odometry --show launched {out['odometry_show_launches']}, expected {want}")
    if out["odometry_show_png"]["shape"] != [480, 640, 4] or out["odometry_show_png"]["lit_pixels"] < 1000:
        failures.append(f"10d: odometry --show wrote {out['odometry_show_png']}")
    return out


def viz_interactive(torch, failures: list) -> dict:
    """10e: the interactive viewer driven over HTTP, on the card and on the
    CPU: each frame served equal to a direct render of the same camera."""
    import json as _json
    import urllib.request

    from align3d_torch.io import png
    from align3d_torch.io.datasets import SlamTbDataset
    from align3d_torch.viz.interactive import InteractiveViewer
    from align3d_torch.viz.viewers import RgbdDatasetViewer

    out = {}
    for d in (DEVICE, "cpu"):
        rv = RgbdDatasetViewer(SlamTbDataset.load(str(SAMPLE1)), 640, 480, device=d)
        viewer = InteractiveViewer(rv.build_scene(max_frames=VIZ_SCENE_FRAMES), 640, 480, device=d)
        port = viewer.start(port=0)
        base = f"http://127.0.0.1:{port}"

        def get(path):
            with urllib.request.urlopen(base + path, timeout=60) as r:
                return r.read()

        def post(event):
            req = urllib.request.Request(base + "/event", data=_json.dumps(event).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.read()

        try:
            page_ok = b"WASD" in get("/")
            equal, times = [], []
            for event in (None, {"type": "key", "key": "w"}, {"type": "drag", "dx": 40, "dy": -12},
                          {"type": "key", "key": "1"}):
                if event is not None:
                    post(event)
                t0 = time.perf_counter()
                frame = png.decode(get("/frame.png"))
                times.append((time.perf_counter() - t0) * 1e3)
                want = viewer.scene.render(viewer.renderer, viewer.controller.camera).color.cpu().numpy()
                equal.append(bool((frame == want).all()))
            state = _json.loads(get("/state"))
            post({"type": "quit"})
            quit_ok = viewer.quit_requested.wait(timeout=10)
        finally:
            viewer.stop()
        key = "card" if d == DEVICE else "cpu"
        out[key] = {"page": page_ok, "frames_equal_direct": equal, "frame_request_ms": times,
                    "frame_request_ms_median": sorted(times)[len(times) // 2], "visible_after_key_1": state["visible"],
                    "quit": quit_ok}
        if not (page_ok and all(equal) and quit_ok and state["visible"][0] is False
                and all(state["visible"][1:])):
            failures.append(f"10e ({key}): {out[key]}")
    return out


def viz(torch, counters, odometry_launches: dict) -> tuple[dict, list]:
    """Phase 10; returns (what it measured, its failures)."""
    counters = (*counters, "mesh")
    out, failures = {"phase_s": {}}, []
    for name, path in (("dataset", lambda: viz_dataset(torch, failures)),
                       ("meshes", lambda: viz_meshes(torch, failures)),
                       ("cli", lambda: viz_cli(torch, counters, failures, odometry_launches)),
                       ("interactive", lambda: viz_interactive(torch, failures))):
        t0 = time.perf_counter()
        out[name] = path()
        out["phase_s"][name] = time.perf_counter() - t0
    return out, failures


#: Phase 11: each bench's argv (two repeats, one warm-up call, the JAX shapes).
BENCH_ARGV = ["--quick"]


def captured(run, argv) -> tuple:
    """(outcome, stdout lines) of a bench's ``run(argv)``."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        outcome = run(argv)
    return outcome, [line for line in buf.getvalue().splitlines() if line.strip()]


def per_call(summary: dict) -> dict:
    return {k: v / summary["calls"] for k, v in summary["launches"].items()}


def same(torch, a, b) -> bool:
    """Equal bit for bit: tensors, or tuples, lists and dicts of them."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(torch, a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(torch, x, y) for x, y in zip(a, b))
    if hasattr(a, "rotation"):
        return same(torch, (a.rotation, a.translation), (b.rotation, b.translation))
    return torch.equal(a.cpu(), b.cpu())


def max_gap(torch, a, b) -> float:
    """The largest |a - b| over tensors, or tuples, lists and dicts of them."""
    if isinstance(a, dict):
        return max(max_gap(torch, a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return max(max_gap(torch, x, y) for x, y in zip(a, b))
    if hasattr(a, "rotation"):
        return max_gap(torch, (a.rotation, a.translation), (b.rotation, b.translation))
    return float((a.cpu() - b.cpu()).abs().max())


def direct_results(torch, name: str, mod, line: dict):
    """The port call each bench times, made here on the same inputs as
    ``line`` reports them."""
    import numpy as np

    from align3d_torch.icp.params import IcpParams, MsIcpParams
    from align3d_torch.tools import series

    if name == "bench_image_icp":  # bench.py's engine, and the exact one beside it
        sources, targets = series.real_pairs(64, DEVICE)
        return {engine: mod.align(mod.packed_pairs(sources, targets, engine), sources.intrinsics,
                                  IcpParams(max_iterations=10, engine=engine)) for engine in ("pallas_v4", "xla")}
    if name == "bench_icp_kernel":  # K7 at radius 2, and the exact engine beside it
        from align3d_torch.benches.bench_image_icp import align

        sources, targets = mod.synthetic_pairs(8, DEVICE)
        params = IcpParams(max_iterations=10, engine="pallas", band_radius=2)
        exact = params.replace(engine="xla")
        packed = mod.packed_pairs(sources, targets, "xla")
        return {"kernel_only": mod.kernel_steps(mod.packed_pairs(sources, targets, "pallas"), sources.intrinsics,
                                                params),
                "full_align": mod.full_align(sources, targets, params),
                "xla_kernel_only": mod.exact_kernel_steps(packed, sources.intrinsics, exact),
                "xla_full_align": align(packed, sources.intrinsics, exact)}
    if name == "bench_odometry":
        from align3d_torch.ops.bilateral import BilateralFilter
        from align3d_torch.parallel import batch as pb

        synthetic = mod.synthetic_series(line["series"]["synthetic"]["off"]["pairs"] + 1)
        out = {}
        for key, s in (("real", series.real_frames()), ("mixed", series.mixed_frames()), ("synthetic", synthetic)):
            scales = s.depth_scales
            colors, depths = torch.from_numpy(s.colors).to(DEVICE), torch.from_numpy(s.depths.astype("int32")).to(DEVICE)
            if isinstance(scales, np.ndarray):
                scales = torch.from_numpy(scales).to(DEVICE)
            for label, f in (("off", None), ("on", BilateralFilter())):
                out[(key, label)] = pb.odometry_step(s.camera, scales, colors, depths,
                                                     MsIcpParams.default_tpu("pallas_v4"), bilateral_filter=f,
                                                     device=DEVICE).camera_to_world
            if key == "real":  # the exact engine beside the JAX bench's default
                out[(key, "off", "xla")] = pb.odometry_step(s.camera, scales, colors, depths, MsIcpParams.default(),
                                                            device=DEVICE).camera_to_world
        return out
    if name == "bench_pcl_icp":
        from align3d_torch.icp.pcl_icp import Icp

        target, source, _ = mod.clouds(100_000, DEVICE)
        return Icp(IcpParams(max_iterations=10), target.points, target.normals).align(source.points, source.normals)
    if name == "bench_voxel_nn":
        from align3d_torch.ops.nn_banded import SortedGrid, nearest_banded

        db, q = (torch.from_numpy(a).to(DEVICE) for a in mod.clouds(500_000))
        grid = SortedGrid.build(db, mod.CELL)
        return {band: nearest_banded(grid, q, band_width=band) for band in (256, 512)}
    if name == "bench_mesh":
        from align3d_torch.ops.mesh import MeshNormals
        from align3d_torch.tools.ablate import grid_mesh

        pts, faces = grid_mesh(320)
        return MeshNormals(faces, pts.shape[0], device=DEVICE)(torch.from_numpy(pts).to(DEVICE))
    if name == "bench_normals":
        from align3d_torch.ops.normals import compute_normals

        pts, mask = (torch.from_numpy(a).to(DEVICE) for a in mod.grid(480, 640))
        return compute_normals(pts, mask)
    if name == "bench_bilateral":
        from align3d_torch.ops.bilateral import BilateralFilter

        filt = BilateralFilter()
        out = {}
        for key, depth in mod.depths(480, 640).items():
            image = torch.from_numpy(depth.astype(np.int32)).to(DEVICE)
            cmin = torch.tensor(int(depth.min()), dtype=torch.int32).to(DEVICE)
            out[key] = filt.filter_static(image, cmin, mod.grid_depth(depth, filt))
        return out
    if name == "bench_scaling":
        from align3d_torch.parallel import batch as pb

        colors, depths = mod.series(8)
        traj = pb.odometry_step(mod.camera(), mod.DEPTH_SCALE, colors, depths, MsIcpParams.default(), device=DEVICE)
        return (traj.camera_to_world.rotation, traj.camera_to_world.translation)
    if name == "bench_global_refine":
        from align3d_torch.parallel import bundle_adjustment as ba
        from align3d_torch.parallel import pose_graph as pg

        probs = mod.problems(line["poses"], line["landmarks"], line["observations"]).to(DEVICE)
        return {"pose_graph": pg.optimize(probs.graph, iterations=mod.PG_ITERS, solver="cg",
                                          cg_iters=line["pg_cg_iters"]),
                "bundle_adjustment": ba.optimize(probs.problem, iterations=mod.BA_ITERS, solver="coo",
                                                 cg_iters=line["ba_cg_iters"])}
    raise KeyError(name)


def bench_launch_failures(name: str, line: dict) -> list:
    """The launches a bench's line reports against what its path issues,
    and the profiler's count beside them (reported, not gated)."""
    # K10 once a banded GN iteration; K11 once a GN iteration of an align (not of the kernel-only
    # calls); K9 once a banded align (3 an odometry step, one a level); K12 once and K13 twice an
    # odometry step (its 3-level pyramids).
    pyramids = {"K12": 1, "K13": 2}
    exact_step = {"K1": STEP_ITERATIONS, "K11": STEP_ITERATIONS, **pyramids}
    banded_step = {"K8": STEP_ITERATIONS, "K9": 3, "K10": STEP_ITERATIONS, "K11": STEP_ITERATIONS, **pyramids}
    want = {"bench_image_icp": {"K8": 10, "K10": 10, "K11": 10}, "bench_icp_kernel": {"K7": 10},
            "bench_pcl_icp": {"K4": 10}, "bench_voxel_nn": {"K4": 1}, "bench_mesh": {"K5": 1},
            "bench_bilateral": {"K2": 1, "K3b": 1}, "bench_odometry": banded_step,
            "bench_scaling": exact_step}.get(name, {})
    checks = [("line", line, want)]
    if name == "bench_image_icp":
        checks.append(("xla", line["xla"], {"K1": 10, "K11": 10}))
    if name == "bench_icp_kernel":
        checks += [("full_align", line["full_align"], {"K7": 10, "K9": 1, "K10": 10, "K11": 10}),
                   ("xla_full_align", line["xla_full_align"], {"K1": 10, "K11": 10}),
                   ("xla_kernel_only", line["xla_kernel_only"], {"K1": 10})]
    if name == "bench_odometry":
        checks.append(("xla", line["xla"], exact_step))
        for key in ("real", "mixed", "synthetic"):
            on = line["series"][key]["on"]
            checks.append((f"{key} filter on", on, {**banded_step, "K2": on["buckets"], "K3b": on["buckets"]}))
    out = []
    for label, summary, kernels in checks:
        if summary.get("launches") is None:  # the scaling bench's spawned worlds count none
            continue
        got = per_call(summary)
        expected = {k: float(kernels.get(k, 0)) for k in got}
        if got != expected:
            out.append(f"11 {name} ({label}): launches a call {got}, expected {expected}")
    return out


def benches(torch) -> tuple[dict, list]:
    """Phase 11: the ten benches of ``align3d_torch/benches`` with
    ``--quick`` on the card, in this process, stdout captured: one JSON line
    each under its JAX metric name with a finite positive value (the
    scaling bench on one card: null, reason "one card", its world-1 step
    timed); the launches each path issues; each bench's result bitwise the
    same port call made directly (every series of bench 3, filter off and
    on); bench 9's pose graph and BA within phase 8's card-against-CPU
    tolerances of the direct calls (``index_add_`` adds by atomics)."""
    import importlib

    from align3d_torch.benches import BENCHES

    out, failures = {"lines": {}, "seconds": {}, "result_bitwise_direct": {}}, []
    for name in BENCHES:
        mod = importlib.import_module(f"align3d_torch.benches.{name}")
        t0 = time.perf_counter()
        outcome, lines = captured(mod.run, BENCH_ARGV)
        out["seconds"][name] = time.perf_counter() - t0
        metric = getattr(mod, "METRIC", None) or mod.KERNEL_METRIC
        parsed = [json.loads(line) for line in lines]
        line = parsed[0] if len(parsed) == 1 else None
        out["lines"][name] = line
        if line is None or line.get("metric") != metric or line != outcome.line:
            failures.append(f"11 {name}: stdout was not one JSON line under {metric}: {lines[:3]}")
            continue
        value = line["value"]
        if name == "bench_scaling" and torch.cuda.device_count() < 2:
            ok = value is None and line.get("reason") == "one card" and line["worlds"]["1"]["full_ms"] > 0
        else:
            ok = isinstance(value, float) and math.isfinite(value) and value > 0
        if not ok:
            failures.append(f"11 {name}: value {value!r}")
        failures += bench_launch_failures(name, line)
        direct = direct_results(torch, name, mod, line)
        if name == "bench_global_refine":  # index_add_ adds by atomics on the card: no rerun is bitwise
            gaps = {key: max_gap(torch, outcome.result[key], direct[key]) for key in direct}
            out["global_refine_gap_direct"] = gaps
            if not (gaps["pose_graph"] <= PG_CARD_CPU_ATOL and gaps["bundle_adjustment"] <= BA_CARD_CPU_ATOL):
                failures.append(f"11 {name}: the bench's result is {gaps} from the port calls made directly, "
                                f"beyond {PG_CARD_CPU_ATOL} (pose graph) or {BA_CARD_CPU_ATOL} (BA)")
            continue
        bitwise = same(torch, outcome.result, direct)
        out["result_bitwise_direct"][name] = bitwise
        if not bitwise:
            failures.append(f"11 {name}: the bench's result differs from the port call made directly")
    return out, failures

# -- phase 12: the banded engines --------------------------------------------------


def banded_args(torch, k3, mod, sources, targets, pose, params):
    """K7/K8 arguments for the batched level-0 images ``sources`` /
    ``targets`` at ``pose`` (one pose for every pair), the bands predicted
    from the source centroids; and the band prediction's host ms."""
    h, w = targets.height, targets.width
    b = sources.points.numel() // (h * w * 3)  # a batched image or one frame's
    sp = k3.pack_source(sources.points.reshape(b, h, w, 3), sources.mask.reshape(b, h, w),
                        sources.intensities.reshape(b, h, w))
    tp = mod.pack_target(targets.points.reshape(b, h, w, 3), targets.normals.reshape(b, h, w, 3),
                         targets.mask.reshape(b, h, w), targets.intensity_map.reshape(b, h + 2, w + 2))
    rot = pose.rotation.expand(b, 3, 3).contiguous()
    trans = pose.translation.expand(b, 3).contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    centroids = k3.source_centroids_batched(sp, targets.intrinsics)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    bases = k3.predict_bases_centroid_batched(rot, trans, centroids, targets.intrinsics, sp.shape[1] * k3.CHUNK)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    host = {"source_centroids_ms": (t1 - t0) * 1e3, "predict_bases_centroid_ms": (t2 - t1) * 1e3}
    return (rot, trans, *bases, sp, tp, targets.intrinsics, h, w, k3.params_to_tuple(params)), host


def check_banded(torch, label, kernel, plain, args, stats: bool, timed_plain: int):
    """Hold K7 or K8 against its twin on ``args``: counts equal, H, g and
    sum w r^2 within ICP_REL (check_icp_blocks), K7's stats bitwise, a rerun
    bitwise; then time both. Returns (worst relative error, kernel timings,
    twin timings, blocks)."""
    got, ref = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    blocks, ref_blocks = torch.stack(got[:2], dim=1), torch.stack(ref[:2], dim=1)
    mask = (args[5][:, :, 0] > 0).reshape(args[5].shape[0], -1)
    worst = check_icp_blocks(torch, blocks, ref_blocks, mask, label)
    if not torch.equal(blocks[:, :, 7, 7], ref_blocks[:, :, 7, 7]):
        raise AssertionError(f"{label}: the gate counts differ from the twin's")
    if stats and not torch.equal(got[2], ref[2]):
        raise AssertionError(f"{label}: the stats differ from the twin's")
    again = kernel(*args)
    if not all(torch.equal(a, b) for a, b in zip(again, got) if a is not None):
        raise AssertionError(f"{label} is not deterministic")
    name = KERNEL_NAMES["banded"][1 if "K8" in label else 0]
    timing = timings(torch, lambda: kernel(*args), kernel=name)
    plain_timing = timings(torch, lambda: plain(*args), n=timed_plain, profiled=1)
    return worst, timing, plain_timing, blocks


def banded_odometry(torch, dataset, builder, counters, frames: int, params, want: dict) -> dict:
    """``run_odometry`` on the first ``frames`` sample1 frames with
    ``params``; the launch counts against ``want`` (a pair's), ground truth,
    finite poses."""
    from align3d_torch.io.datasets import SubsetDataset
    from align3d_torch.odometry import run_odometry

    subset = SubsetDataset(dataset, range(frames))
    before = snapshot(counters)
    result = run_odometry(subset, DEVICE, range_builder=builder, icp_params=params)
    torch.cuda.synchronize()
    launches = since(before)
    expected = {k: want.get(k, 0) * (frames - 1) for k in launches}
    pose = result.trajectory.camera_to_world
    out = {"frames": frames, "launches": launches, "launches_expected": expected,
           "mean_deg": math.degrees(float(result.metrics.angle)), "mean_trans": float(result.metrics.translation),
           "host_ms_per_frame": result.seconds_per_frame * 1e3,
           "finite": bool(torch.isfinite(pose.rotation).all() and torch.isfinite(pose.translation).all())}
    if launches != expected:
        raise AssertionError(f"banded odometry launched {launches}, expected {expected}")
    if not (out["finite"] and out["mean_deg"] < MEAN_ANGLE_DEG and out["mean_trans"] < MEAN_TRANS):
        raise AssertionError(f"banded odometry failed its ground-truth bound or is not finite: {out}")
    return out, result


def banded_split() -> dict:
    """``tools/ablate.py``'s ``banded_sections``: K7 and K8 built with and
    without the stack's reduction and the target gathers, device ms of each
    (the mean of two timings) at B = 1 and B = 64, and what the reduction and
    the gathers add, beside the bound. It runs in a process of its own: late
    in this one the profiler sees only part of the launches, at times none
    (PERF.md question 6), and the split needs every time."""
    from align3d_torch.tools import ablate

    proc = subprocess.run([sys.executable, "-m", "align3d_torch.tools.ablate", "banded_sections"], cwd=ROOT,
                          capture_output=True, text=True, timeout=SPLIT_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"the split failed ({proc.returncode}): {proc.stderr[-2000:]}")
    sections = json.loads(proc.stdout.strip().splitlines()[-1])["ablate"]["banded_sections"]
    return {key: {shape: {**{f"{name}_ms": sum(row[f"{name}_ms"]) / 2 for name in ablate.BANDED_VARIANTS},
                          **{k: row[k] for k in ("reduce_ms", "gather_ms", "bound_ms", "share_of_bound")}}
                  for shape, row in shapes.items()}
            for key, shapes in sections.items()}


def max_abs_gap(torch, got, ref) -> float:
    """The largest |got - ref| over tuples of tensors, NaN where both are NaN skipped."""
    gaps = []
    for g, r in zip(got, ref):
        g, r = g.double().cpu(), r.double().cpu()
        both = torch.isnan(g) & torch.isnan(r)
        gaps.append(float((g - r)[~both].abs().max()) if (~both).any() else 0.0)
    return max(gaps)


def check_band_prediction(torch, dataset, builder) -> tuple[dict, list]:
    """12a, K9 and K10 (module docstring)."""
    import numpy as np

    from align3d_torch.icp import image_icp as ii
    from align3d_torch.icp.params import IcpParams
    from align3d_torch.ops import icp_pallas_v3 as k3
    from align3d_torch.range_image import build_pyramid_impl
    from align3d_torch.se3 import Transform
    from align3d_torch.tools import series
    from align3d_torch.tools.ablate import same_bits

    out, failures = {"k9": {}, "k10": {}}, []

    def pack(ri, b, points=None, mask=None):
        h, w = ri.height, ri.width
        return k3.pack_source(ri.points.reshape(b, h, w, 3) if points is None else points,
                              ri.mask.reshape(b, h, w) if mask is None else mask, ri.intensities.reshape(b, h, w))

    def check_k9(label, sp, intr, singles: bool):
        got = k3.source_centroids_batched(sp, intr)
        ref, cpu = k3.source_centroids_plain(sp, intr), k3.source_centroids_plain(sp.cpu(), intr)
        row = {"shape": list(sp.shape), "bitwise_plain": all(same_bits(g, r) for g, r in zip(got, ref)),
               "bitwise_cpu_plain": all(same_bits(g.cpu(), c) for g, c in zip(got, cpu)),
               "max_abs_err": max_abs_gap(torch, got, ref), "nan": int(torch.isnan(got[0]).sum()),
               "empty_groups": int((got[3] == 0).sum())}
        if singles:
            row["bitwise_b1"] = all(all(same_bits(o[0], x[i])
                                        for o, x in zip(k3.source_centroids_batched(sp[i:i + 1], intr), got))
                                    for i in range(sp.shape[0]))
        if not all(v for k, v in row.items() if k.startswith("bitwise")):
            failures.append(f"12a K9 {label}: {row}")
        out["k9"][label] = row
        return got

    # K9 at the three levels: sample1 frame 1 (B = 1) and 64 frames of the real series (B = 64).
    s = series.real_frames()
    levels64 = build_pyramid_impl(True, True, 3, 1.0, s.camera, torch.from_numpy(s.depth_scales),
                                  torch.from_numpy(s.colors).to(DEVICE),
                                  torch.from_numpy(s.depths.astype(np.int32)).to(DEVICE))
    one = builder.build(dataset.get(1), DEVICE)
    for level in range(3):
        check_k9(f"level{level}_batch1", pack(one[level], 1), one[level].intrinsics, False)
        src = levels64[level].frames(torch.arange(1, s.depths.shape[0], device=DEVICE))
        check_k9(f"level{level}_batch64", pack(src, s.depths.shape[0] - 1), src.intrinsics, True)
    del levels64
    # Empty groups (lanes 128-255 and rows 16-31 masked out) and a NaN depth under a true mask.
    src = one[0]
    h, w = src.height, src.width
    points, mask = src.points.reshape(1, h, w, 3).clone(), src.mask.reshape(1, h, w).clone()
    mask[:, :, 128:256] = False
    mask[:, 16:32] = False
    mask[0, 40, 300] = True
    points[0, 40, 300, 2] = float("nan")
    sp1 = pack(src, 1)
    check_k9("level0_empty_groups_nan", pack(src, 1, points, mask), src.intrinsics, False)
    if not (out["k9"]["level0_empty_groups_nan"]["nan"] and out["k9"]["level0_empty_groups_nan"]["empty_groups"]):
        failures.append("12a K9: the edited source has no NaN or no empty group")

    def check_k10(rot, trans, centroids, intr, hp):
        got = k3.predict_bases_centroid_batched(rot, trans, centroids, intr, hp)
        ref = k3.predict_bases_centroid_plain(rot, trans, centroids, intr, hp)
        return got, all(torch.equal(g, r) for g, r in zip(got, ref)), max_abs_gap(torch, got, ref)

    # K10 at the pose of every iteration of a 10-iteration pallas_v4 align of the 64 real pairs.
    sources, targets = series.real_pairs(64, DEVICE)
    b, n = sources.points.shape[0], targets.height * targets.width
    flat = (sources.points.reshape(b, n, 3), sources.mask.reshape(b, n), sources.intensities.reshape(b, n),
            targets.points.reshape(b, n, 3), targets.mask.reshape(b, n), targets.normals.reshape(b, n, 3),
            targets.intensity_map)
    packed = ii.prepack_v4_batched(*flat, targets.intrinsics)
    poses, kernel = [], k3.predict_bases_centroid_batched

    def recording(rot, trans, *rest):
        poses.append((rot.clone(), trans.clone()))
        return kernel(rot, trans, *rest)

    ident = Transform.identity((b,), device=DEVICE)
    k3.predict_bases_centroid_batched = recording
    try:
        # The eager loop: a graph's replay would call no Python, so record nothing.
        ii._v4_loop(ident.rotation, ident.translation, *packed[:2], *packed[2], *packed[3:], targets.intrinsics,
                    IcpParams(max_iterations=10, engine="pallas_v4"))
    finally:
        k3.predict_bases_centroid_batched = kernel
    hp = packed[0].shape[1] * k3.CHUNK
    checked = [check_k10(rot, trans, packed[2], targets.intrinsics, hp) for rot, trans in poses]
    out["k10"]["align_pallas_v4_batch64"] = {"iterations": len(poses), "equal_plain": [c[1] for c in checked],
                                             "max_abs_err": max(c[2] for c in checked)}
    if len(poses) != 10 or not all(c[1] for c in checked):
        failures.append(f"12a K10: the 64-pair align's bases differ from the twin's: {out['k10']}")
    del packed, sources, targets

    # K10 at crafted poses on sample1 frame 1, level 0: a drop and a lift of
    # 0.5 m (band starts clipped at 0 and at hp - 32), and a translation that
    # takes the first non-empty group's centroid to the origin (its pz == 0).
    centroids = k3.source_centroids_batched(sp1, src.intrinsics)
    hp = sp1.shape[1] * k3.CHUNK
    twist = Transform.exp(torch.tensor(K1_TWIST, device=DEVICE))
    c, g = (int(i) for i in torch.nonzero(centroids[3][0] > 0)[0])
    x, r = centroids[0][0, c, g], twist.rotation
    to_origin = -torch.stack([(r[i, 0] * x[0] + r[i, 1] * x[1]) + r[i, 2] * x[2] for i in range(3)])
    crafted = {"twist": twist, "drop": Transform.exp(torch.tensor([0.0, -0.5, 0, 0, 0, 0], device=DEVICE)),
               "lift": Transform.exp(torch.tensor([0.0, 0.5, 0, 0, 0, 0], device=DEVICE)),
               "pz_zero": Transform(r, to_origin)}
    edge = max(hp - min(32, hp), 0)
    for name, pose in crafted.items():
        got, equal, err = check_k10(pose.rotation[None].contiguous(), pose.translation[None].contiguous(), centroids,
                                    src.intrinsics, hp)
        out["k10"][name] = {"equal_plain": equal, "max_abs_err": err, "chunk_base": got[0][0].tolist()}
        if not equal:
            failures.append(f"12a K10 {name}: the bases differ from the twin's")
    clipped = {"drop": 0 in out["k10"]["drop"]["chunk_base"][1:-1],
               "lift": edge in out["k10"]["lift"]["chunk_base"][1:-1]}
    out["k10"]["clipped"] = clipped
    if not all(clipped.values()):
        failures.append(f"12a K10: the crafted poses did not clip the band starts: {clipped}")
    out["k9_max_abs_err"] = max(row["max_abs_err"] for row in out["k9"].values())
    out["k10_max_abs_err"] = max(v["max_abs_err"] for v in out["k10"].values() if isinstance(v, dict)
                                 and "max_abs_err" in v)
    return out, failures


def band_timing() -> dict:
    """12d: ``tools/ablate.py band_prediction`` in a process of its own
    (fresh, so that the profiler sees every launch): K9's and K10's device
    ms, their twins', K9's library call, host ms, and the device activities
    of a pallas_v4 align's GN loop and prepack on the kernels and on the
    twins."""
    proc = subprocess.run([sys.executable, "-m", "align3d_torch.tools.ablate", "band_prediction"], cwd=ROOT,
                          capture_output=True, text=True, timeout=BAND_TIMING_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"the band prediction's timing failed ({proc.returncode}): {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])["ablate"]["band_prediction"]


def banded(torch, dataset, builder, counters) -> tuple[dict, list]:
    """Phase 12 (module docstring)."""
    from align3d_torch.icp.params import MsIcpParams
    from align3d_torch.metrics import TransformMetrics
    from align3d_torch.ops import icp_pallas_v3 as k3
    from align3d_torch.ops import icp_pallas_v4 as k4
    from align3d_torch.se3 import Transform
    from align3d_torch.tools.roofline import banded_step_bytes, banded_step_flops
    from align3d_torch.tools.series import real_pairs
    from align3d_torch.trajectory import Trajectory

    t_phase = time.perf_counter()
    out, failures = {}, []
    params = MsIcpParams.default_tpu("pallas")[0]  # the finest level: band radius 1
    pose = Transform.exp(torch.tensor(K1_TWIST, device=DEVICE))
    one = (builder.build(dataset.get(1), DEVICE)[0], builder.build(dataset.get(0), DEVICE)[0])
    sources64, targets64 = real_pairs(64, DEVICE)
    variants = {"K7": (k3, lambda *a: k3.icp_step_pallas_batched(*a, emit_stats=True),
                       lambda *a: k3.icp_step_plain(*a, emit_stats=True), True),
                "K8": (k4, k4.icp_step_pallas_batched, k4.icp_step_plain, False)}
    for key, (mod, kernel, plain, stats) in variants.items():
        res = {}
        for shape, (src, tgt), timed_plain in (("batch1", one, TIMED_CALLS), ("batch64", (sources64, targets64), 3)):
            args, host = banded_args(torch, k3, mod, src, tgt, pose, params)
            worst, timing, plain_timing, blocks = check_banded(torch, f"{key} {shape}", kernel, plain, args, stats,
                                                               timed_plain)
            b = bound(banded_step_bytes(args[5], args[6], stats), banded_step_flops(args[5]))
            res[shape] = {"max_abs_err": worst, "ms": timing[0], "call_ms": timing[1], "plain_ms": plain_timing[0],
                          "plain_call_ms": plain_timing[1], **b,
                          "share_of_bound": None if timing[0] is None else b["bound_ms"] / timing[0],
                          **host, "pairs": args[0].shape[0], "library_ms": None,
                          "library_reason": "no PyTorch call does the banded association and its gated GN sums"}
            if shape == "batch64":
                singles = [kernel(*(a[i:i + 1] for a in args[:7]), *args[7:]) for i in range(args[0].shape[0])]
                res[shape]["bitwise_b1"] = all(torch.equal(torch.stack(s[:2], dim=1)[0], blocks[i])
                                               for i, s in enumerate(singles))
                if not res[shape]["bitwise_b1"]:
                    failures.append(f"12a {key}: a pair's blocks at B = 64 differ from its B = 1 blocks")
            print(f"banded {key} {shape}: {json.dumps(res[shape])}")
        out[key] = res
    del sources64, targets64

    # 12a, K9 and K10: bitwise their twins at the levels, the real align's poses and the crafted ones.
    out["band_prediction"], band_failures = check_band_prediction(torch, dataset, builder)
    failures += band_failures
    print(f"banded K9/K10 checks: {json.dumps(out['band_prediction'])}")

    # 12c: the split of K7's and K8's time, from builds without the reduction or the gathers.
    try:
        out["split"] = banded_split()
        for key, shapes in out["split"].items():
            for shape, row in shapes.items():
                print(f"banded split {key} {shape}: {json.dumps(row)}")
    except AssertionError as exc:
        failures.append(f"12c: {exc}")

    golden = Trajectory.from_tum(GOLDEN_V4.read_text()).to(DEVICE)
    # A pair's launches: K10 once a banded GN iteration, K9 once a banded level.
    # K11 once a GN iteration of either engine.
    runs = (("pallas_v4", BANDED_FRAMES, MsIcpParams.default_tpu("pallas_v4"),
             {"k8": 70, "k9": 3, "k10": 70, "k11": 70}),
            ("pallas_v4_coarse_exact", BANDED_CUT, MsIcpParams.default_tpu("pallas_v4", coarse_exact=True),
             {"k8": 40, "icp": 30, "k9": 2, "k10": 40, "k11": 70}),
            ("pallas_coarse_exact", BANDED_CUT, MsIcpParams.default_tpu("pallas", coarse_exact=True),
             {"k7": 40, "icp": 30, "k9": 2, "k10": 40, "k11": 70}))
    for name, frames, ms_params, want in runs:
        try:
            got, result = banded_odometry(torch, dataset, builder, counters, frames, ms_params, want)
        except AssertionError as exc:
            failures.append(f"12b {name}: {exc}")
            continue
        if name == "pallas_v4":
            diff = TransformMetrics.new(golden.camera_to_world, result.trajectory.camera_to_world)
            got["golden_max_rad"], got["golden_max_m"] = float(diff.angle.max()), float(diff.translation.max())
            if not (len(golden) == len(result.trajectory) and got["golden_max_rad"] <= POSE_ATOL
                    and got["golden_max_m"] <= POSE_ATOL):
                failures.append(f"12b: the pallas_v4 trajectory differs from the JAX golden: {got}")
        out[name] = got
        print(f"banded odometry {name}: {json.dumps(got)}")

    # 12d: K9's and K10's times, in a process of its own.
    try:
        out["band_timing"] = band_timing()
        for shape, row in out["band_timing"]["shapes"].items():
            print(f"banded K9/K10 {shape}: {json.dumps(row)}")
        print(f"banded pallas_v4 align activities: {json.dumps(out['band_timing']['align_pallas_v4_batch64'])}")
    except AssertionError as exc:
        failures.append(f"12d: {exc}")
    out["phase_s"] = time.perf_counter() - t_phase
    return out, failures


def band_entry(key: str, banded_out: dict, launches: int, launches_by_path: dict, ptxas_lines: list) -> dict:
    """The ``kernels`` line's entry of K9 or K10: 12d's times at B = 1 (and
    B = 64 under ``shapes``), 12a's errors."""
    rows, checks, k = banded_out["band_timing"]["shapes"], banded_out["band_prediction"], key.lower()

    def times(row):
        t_bytes, t_ops = row[f"{k}_bound_bytes"] / PEAK_BYTES, row[f"{k}_bound_flops"] / PEAK_F32
        return {"ms": row[f"{k}_ms"], "call_ms": row[f"{k}_call_ms"], "plain_ms": row[f"{k}_plain_ms"],
                "plain_call_ms": row[f"{k}_plain_call_ms"], "bound_ms": row[f"{k}_bound_ms"],
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_bytes": row[f"{k}_bound_bytes"], "bound_flops": row[f"{k}_bound_flops"],
                "host_ms": row[f"{k}_host_ms"][len(row[f"{k}_host_ms"]) // 2],
                "plain_host_ms": row[f"{k}_plain_host_ms"][len(row[f"{k}_plain_host_ms"]) // 2],
                "library_ms": row["k9_library_ms"] if k == "k9" else None}

    library = ({"library_call": "one torch sum of the six channels, reshape(6, B, nchunks, G, 16, 128)"
                                ".sum(dim=(-2, -1)): the same sums, not XLA's order",
                "library_max_abs_diff": rows["batch1"]["k9_library_max_abs_diff"]} if k == "k9" else
               {"library_reason": "no PyTorch call projects the centroids into band bases"})
    return {"name": {"k9": "source_centroids (K9)", "k10": "predict_bases_centroid (K10)"}[k], "route": "cuda",
            "source": "align3d_torch/csrc/band_predict.cu",
            "replaces": {"k9": "align3d_tpu/ops/icp_pallas_v3.py:203", "k10": "align3d_tpu/ops/icp_pallas_v3.py:250"}[k],
            "pallas_calls": [],
            "replaces_note": "plain jnp that XLA fuses into the jitted banded align (align3d_tpu/icp/image_icp.py:"
                             + ("278" if k == "k9" else "285") + "); no TPU kernel computes it",
            "launches": launches, "launches_by_path": launches_by_path, "max_abs_err": checks[f"{k}_max_abs_err"],
            "err": ("max |kernel - plain| (bitwise at the three levels, B = 1 and 64, NaN in the same places)"
                    if k == "k9" else "max |kernel - plain| of the int32 bases (equal at every pose)"),
            **times(rows["batch1"]), "timed_calls": 50, "shape": "sample1 frames 0 <- 1, 640x480, level 0",
            "host_ms_of": "a call ended by a synchronise, median (kernel of 20, twin of 5)",
            **library, "ptxas": ptxas_lines, "shapes": {"batch64_real_pairs": times(rows["batch64"])}}


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
    from align3d_torch.range_image import RangeImageBuilder
    from align3d_torch.trajectory import Trajectory

    dataset = SlamTbDataset.load(str(SAMPLE1))
    frame0, frame1 = dataset.get(0), dataset.get(1)
    depth0 = torch.from_numpy(frame0.image.depth.astype("int32")).cuda()
    splat = check_splat(torch, bil, depth0)
    slice_, slice_a = check_slice(torch, bil, depth0)
    builder = RangeImageBuilder(bilateral_filter=bil.BilateralFilter())
    pyr0, pyr1 = builder.build(frame0, "cuda"), builder.build(frame1, "cuda")
    icp = check_icp(torch, pyr0, pyr1)
    gn_update, gn_update_rows = check_gn_update(torch, pyr0, pyr1)
    del pyr0, pyr1
    pyramid_rows = check_pyramid(torch)
    done("phase 3, K1-K3, K11-K13")

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
    before, graphs0 = snapshot(("icp", "splat", "slice", "k11", "k12", "k13", "slice_a", "normalize")), graphs_since()
    first = run_odometry(subset, "cuda", range_builder=builder, icp_params=MsIcpParams.default())
    launches, graphs = since(before), graphs_since(graphs0)
    unwanted = {k: launches.pop(k) for k in ("slice_a", "normalize")}
    print(f"main-path launches: {launches}; K3 form (a) launches {unwanted['slice_a']}, "
          f"_normalize passes {unwanted['normalize']}; level graphs {graphs} of {3 * (FRAMES - 1)} levels")
    if min(launches.values()) <= 0:
        return fail(f"a kernel of the main path never launched: {launches}")
    if graphs["captures"] + graphs["replays"] != 3 * (FRAMES - 1) or graphs["replays"] <= 0:
        return fail(f"the levels took their CUDA graphs otherwise than once a level, replayed after: {graphs}")
    if launches["k11"] != launches["icp"]:
        return fail(f"K11 launched otherwise than once a GN iteration: {launches}")
    if (launches["k12"], launches["k13"]) != (FRAMES, 2 * FRAMES):
        return fail(f"the pyramid launched otherwise than K12 once and K13 twice a frame: {launches}")
    if any(unwanted.values()):
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
    moved = reciprocal_division_move(torch, TransformMetrics, subset, builder, first)
    print("division fix: the 10-frame odometry with the divisions by a number done as CUDA does them for a CPU "
          "scalar (the float32 reciprocal, before the fix) against the divisions of this run: " + json.dumps(moved))

    done("phase 4a")

    # -- 4b. point-cloud ICP, 4c. mesh normals -------------------------------
    launches["nn"] = pcl_path(torch, nn, Icp, IcpParams, Transform, TransformMetrics, target, source,
                              dataset.trajectory().get_relative_transform(1, 0).to(DEVICE))
    launches["mesh"] = mesh_path(torch, mesh, teapot, mesh_pts, mesh_faces)

    done("phases 4b-4c")

    # -- 4d. the throughput path ---------------------------------------------
    counters = ODOMETRY_COUNTS
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
    before = snapshot(("p1", "p2"))
    roof = rl.measure(DEVICE)
    launches.update(since(before))
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

    # -- 9. distribution ---------------------------------------------------------
    distributed, failures = distribution(torch, dataset, counters,
                                         refinement["pose_graph"]["per_pcg_trip"]["device_activities"])
    print("distribution: " + json.dumps(distributed))
    if failures:
        return fail("; ".join(failures))
    done("phase 9")

    # -- 10. viz -------------------------------------------------------------------
    shown, failures = viz(torch, counters, {k: launches[k] for k in ODOMETRY_KERNELS})
    print("viz: " + json.dumps(shown))
    for name in ("preview_sample1", "scene_8_frames"):
        got = shown["dataset"][name]
        print(f"viz {name}: {got['points']} points in {got['nodes']} nodes, 640x480; card against CPU "
              f"{json.dumps(got.get('card_vs_cpu', 'not run (8-frame scene only)'))}; card rerun bitwise "
              f"{got['card_rerun_bitwise']}; host ms a render card {got['host_ms']:.2f}, CPU path "
              f"{got.get('cpu_host_ms', 'not run')}; device busy ms {got['device_busy_ms']:.3f} "
              f"({got['device_activities']} activities); peak memory {got['peak_memory_bytes']} B; the fit of "
              f"every node {got['fit_host_ms']:.2f} ms, a render refitting every node "
              f"{got['host_ms_fit_every_render']:.2f} ms")
    print(f"viz renderer alone, the CPU path's 8 clouds on the card: bitwise "
          f"{shown['dataset']['scene_8_frames_same_points_bitwise']}; the clouds built on the card against the CPU's: "
          f"{json.dumps(shown['dataset']['scene_8_frames_clouds'])}")
    for name, got in shown["meshes"].items():
        print(f"viz mesh {name}: {got['faces']} faces, {got['pairs']} (face, pixel) pairs; K5 launches in two renders "
              f"{got['k5_launches_two_renders']}; card against CPU {json.dumps(got['card_vs_cpu'])}; host ms a render "
              f"card {got['host_ms']:.2f}, CPU path {got['cpu_host_ms']:.2f}; device busy ms {got['device_busy_ms']:.3f}")
    print(f"viz interactive: ms a /frame.png request, card {shown['interactive']['card']['frame_request_ms_median']:.1f}, "
          f"CPU path {shown['interactive']['cpu']['frame_request_ms_median']:.1f}")
    if failures:
        return fail("; ".join(failures))
    done("phase 10")

    # -- 11. the benches -----------------------------------------------------------
    t11 = time.perf_counter()
    benched, failures = benches(torch)
    for name, line in benched["lines"].items():
        print(f"bench {name}: {json.dumps(line)}")
    print(f"benches: seconds {json.dumps(benched['seconds'])}; result bitwise the direct call "
          f"{json.dumps(benched['result_bitwise_direct'])}; bench 9's gap to the direct calls "
          f"{json.dumps(benched.get('global_refine_gap_direct'))}; phase 11 {time.perf_counter() - t11:.1f} s")
    if failures:
        return fail("; ".join(failures))
    done("phase 11")

    # -- 12. the banded engines --------------------------------------------------
    banded_out, failures = banded(torch, dataset, builder, ("icp", "k7", "k8", "k9", "k10", "k11"))
    print("banded: " + json.dumps(banded_out))
    if failures:
        return fail("; ".join(failures))
    launches["k7"] = banded_out["pallas_coarse_exact"]["launches"]["k7"]
    launches["k8"] = banded_out["pallas_v4"]["launches"]["k8"]
    launches["k9"] = banded_out["pallas_v4"]["launches"]["k9"]
    launches["k10"] = banded_out["pallas_v4"]["launches"]["k10"]
    done("phase 12")
    by_path = {"odometry (4a)": {k: launches[k] for k in ("icp", "splat", "slice")},
               "TUM odometry, uninterrupted (7)": data["launches"]["uninterrupted"],
               "throughput, bilateral off (4d)": throughput["bilateral_off"]["launches"],
               "throughput, bilateral on (4d)": throughput["bilateral_on"]["launches"],
               "mixed series (4d)": throughput["mixed"]["launches"],
               "loop closure, 18-frame palindrome, no filter (8a)": refinement["palindrome"]["launches"],
               "loop closure, command line, TUM palindrome (8b)": refinement["cli"]["launches"],
               "sharded step, filter on, world 1 (9a)": distributed["world1"]["step"]["launches"],
               "sequence parallel, filter on, world 1 (9b)": distributed["world1"]["sequence"]["launches"],
               **{f"sharded step, filter on, world 2, rank {r['rank']} (9a)": r["step"]["launches"]
                  for r in distributed["world2"]["ranks"]},
               **{f"sequence parallel, filter on, world 2, rank {r['rank']} (9b)": r["sequence"]["launches"]
                  for r in distributed["world2"]["ranks"]},
               "odometry --show, 10 frames (10d)": shown["cli"]["odometry_show_launches"],
               **{f"banded odometry {name}, {banded_out[name]['frames']} frames (12b)": banded_out[name]["launches"]
                  for name in ("pallas_v4", "pallas_v4_coarse_exact", "pallas_coarse_exact")},
               "viz": {"mesh": sum(m["k5_launches_two_renders"] for m in shown["meshes"].values()),
                       "sphere": sum(shown["dataset"][k]["k6_launches"] for k in ("preview_sample1", "scene_8_frames"))}}

    def paths(key):
        return {k: v[key] for k, v in by_path.items() if key in v}

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

    def banded_entry(key):
        got, b1 = banded_out[key], banded_out[key]["batch1"]
        return {"name": f"icp_banded {'v3' if key == 'K7' else 'v4'} ({key})", "route": "cuda",
                "source": "align3d_torch/csrc/icp_banded.cu",
                "replaces": {"K7": "align3d_tpu/ops/icp_pallas_v3.py:337",
                             "K8": "align3d_tpu/ops/icp_pallas_v4.py:96"}[key],
                "pallas_calls": PALLAS_CALLS[key], "launches": launches[key.lower()],
                "launches_by_path": paths(key.lower()), "max_abs_err": b1["max_abs_err"],
                "err": "max |kernel - plain| / max|plain| over H, g and sum w r^2 (gate counts equal"
                       + (", stats bitwise)" if key == "K7" else ")"),
                "ms": b1["ms"], "plain_ms": b1["plain_ms"], "call_ms": b1["call_ms"],
                "plain_call_ms": b1["plain_call_ms"], "timed_calls": TIMED_CALLS,
                **{k: b1[k] for k in ("bound_ms", "bound_by", "bound_bytes", "bound_flops", "library_ms",
                                      "library_reason")},
                "shape": "sample1 frames 0 <- 1, 640x480, level 0" + (", stats emitted" if key == "K7" else ""),
                "ptxas": ptxas["banded"], "shapes": {"batch64_real_pairs": got["batch64"]},
                "redesigned": "the stack's sums on tensor cores (mma.sync), a tile in two blocks",
                "split": banded_out["split"][key]}

    k1_64 = roof["k1_batch64"]
    frames = batched_bil["batch"]
    gh, gw = bil._grid_dims(480, 640, bil.BilateralFilter.sigma_space)

    kernels = [
        entry("icp_step_fused (K1)", "align3d_torch/csrc/icp_step.cu", "align3d_tpu/icp/image_icp.py:54",
              "icp", icp, "max |kernel - plain| / max|plain| over H, g and sum w r^2", ptxas=ptxas["icp"],
              replaces_note="the XLA engine's exact GN step (plain jnp icp_step); no TPU kernel",
              launches_by_path=paths("icp"),
              shapes={"batch64_real_pairs": {
                  "ms": k1_64["ms"], "us_per_pair": k1_64["us_per_pair"],
                  "device_us_per_launch_in_step": step_profile["bilateral_off"]["k1_device_us_per_launch"],
                  "plain_ms": throughput["k1_batch64_plain_ms"],
                  "max_abs_err": throughput["k1_batch64_max_rel_err_plain"],
                  **bound(k1_64["bytes"], 300 * k1_64["gathers"] / 2)}}),
        *(banded_entry(key) for key in ("K7", "K8")),
        entry("gn_update (K11)", "align3d_torch/csrc/gn_update.cu", "align3d_tpu/icp/image_icp.py", "k11",
              gn_update, "max of |kernel - plain| of the rotations and of the translations over the largest "
              "entry, over GN_UPDATE_ITERATIONS iterations (best residuals and selects equal)",
              ptxas=ptxas["k11"], replaces_note="the GN loop's merge, f64 solve, SE(3) update and select "
              "(plain jnp in the jitted align); no TPU kernel",
              shape="sample1 frames 0 <- 1, K1's blocks at level 0", launches_by_path=paths("k11"),
              shapes=gn_update_rows),
        *(band_entry(key, banded_out, launches[key.lower()], paths(key.lower()),
                     ptxas["centroids" if key == "K9" else "predict"]) for key in ("K9", "K10")),
        # K12 and K13 replace no TPU kernel: the JAX package's pyramid is plain
        # jnp that XLA fuses; their twin is the plain chain of the port.
        *({"name": f"{name} ({key.upper()})", "route": "cuda", "source": "align3d_torch/csrc/pyramid.cu",
           "replaces": "align3d_tpu/range_image.py:189", "pallas_calls": PALLAS_CALLS[key.upper()],
           "replaces_note": "the pyramid's plain jnp, fused by XLA into the jitted, vmapped build; no TPU kernel",
           "launches": launches[key], "launches_by_path": {"odometry (4a)": launches[key]},
           "max_abs_err": 0.0, "err": "bitwise the twin (ops/pyramid.py::pyramid_plain) at every level and output",
           "timed_calls": TIMED_CALLS, "ptxas": ptxas[key],
           "shapes": {label: {part: row[part] for part in parts} | {"plain_chain": row["plain"]}
                      for label, row in pyramid_rows.items()}}
          for key, name, parts in (("k12", "pyramid_base", ("k12", "build")),
                                   ("k13", "pyramid_down", ("k13_level1", "k13_level2")))),
        entry("bilateral_splat (K2)", "align3d_torch/csrc/bilateral.cu", "align3d_tpu/ops/bilateral.py:80",
              "splat", splat, "max |kernel - plain|", ptxas=ptxas["splat"],
              launches_by_path=paths("splat"),
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
              launches_by_path=paths("slice"),
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
              ptxas=ptxas["mesh"], launches_by_path={"mesh normals (4c)": launches["mesh"], **paths("mesh")},
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
    # K6 replaces no TPU kernel: the JAX viewers fit with numpy on the host.
    err6, (ms6, call_ms6), (_, plain_ms6), bound6, library6 = shown["dataset"]["k6"]
    kernels.append({"name": "column_mean (K6)", "route": "cuda", "source": "align3d_torch/csrc/sphere.cu",
                    "replaces": "align3d_tpu/viz/sphere.py:29", "pallas_calls": [],
                    "replaces_note": "numpy's mean(axis=0) on the host in Sphere3D.from_points; no TPU kernel",
                    "launches": by_path["viz"]["sphere"], "launches_by_path": paths("sphere"),
                    "max_abs_err": err6, "err": "max |kernel - numpy| (bitwise on every node of the preview, one launch)",
                    "ms": ms6, "call_ms": call_ms6, "plain_ms": plain_ms6,
                    "plain": "numpy's mean(axis=0) of the points on the host: host ms, median of 3",
                    "timed_calls": TIMED_CALLS, "nodes": len(shown["dataset"]["k6_node_points"]),
                    "points": sum(shown["dataset"]["k6_node_points"]),
                    "ptxas": ptxas["sphere"], **bound6, **library6})
    print(json.dumps({"roofline": roof}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
