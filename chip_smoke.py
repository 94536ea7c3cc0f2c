#!/usr/bin/env python3
"""Smoke run of the align3d_torch port on one CUDA GPU.

    python chip_smoke.py

Run from the root of a checkout. Phases, each of which fails the run:

1. CUDA present; print the device and ``nvidia-smi`` name / power limit.
2. Build the CUDA kernels from ``align3d_torch/csrc`` (timed).
3. Hold each kernel against its plain-PyTorch twin on the card at its
   paths' shapes, and time both: device time per call from
   ``torch.profiler``, and per-call time of back-to-back calls between one
   CUDA event pair. K1-K3: sample1 frames 0 and 1, 640x480, the three
   pyramid levels, the (2, 111, 146, 96) bilateral grid. K4: payload mode
   on the sample1 frame-0 grid (270,213 points, cell 0.05, band 512) with
   frame 1's 270,282 points as queries; nearest mode at 500k x 500k
   uniform, cell 0.02, bands 256 and 512. K5: the 204,800-face grid mesh
   and the teapot.
4. Drive each path with its kernels' launch counts reset just before and
   read just after:
   a. odometry: ``run_odometry`` on sample1, 10 frames, bilateral filter on;
      the trajectory error against ground truth, the poses against the JAX
      package's golden trajectory, a bitwise-identical second run;
   b. point-cloud ICP: ``Icp(IcpParams())``, banded engine, sample1 frame 0
      <- frame 1 at full resolution: the angle error against ground truth,
      the hash engine within 0.02 rad, one K4 launch per iteration, a
      bitwise-identical second run; and the wavy surface with a large first
      step, which must re-sort;
   c. mesh normals: ``MeshNormals`` of ``teapot.ply`` against the CPU path,
      and of the 204,800-face grid mesh.
5. Break a frame's time down: host clock per phase (decode, pyramid build,
   bilateral filter, ICP), each ended by a synchronise, and
   ``torch.profiler`` over the same frames for the device's busy time and
   each kernel's device time per launch; then the same for one point-cloud
   ICP align, with its host syncs per iteration.

It prints a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line, and as
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
SLICE_ATOL = 2e-3  # K3 before the cast (tests/test_bilateral.py's kernel bound)
SLICE_CAST_MAX = 1  # K3 after the truncating cast
ICP_COUNT_SHARE = 1e-4  # K1: count within 0.01% of the valid pixels
ICP_REL = 1e-4  # K1: H and g within 1e-4 x max|entry|
POSE_ATOL = 2e-3  # poses against the golden: rad / m
MEAN_ANGLE_DEG, MEAN_TRANS = 0.5, 0.01  # tests/test_odometry_accuracy.py bound

PCL_MAX_ANGLE = 0.1  # pcl ICP against ground truth (pcl_icp.rs:121-136, tests/test_icp.py)
PCL_ENGINES_ANGLE = 0.02  # banded against hash (tests/test_icp.py::test_pcl_icp_align_banded_engine)
WAVY_BOUND = 0.01  # rad / m (tests/test_icp.py::test_pcl_icp_banded_large_step_resort)
MESH_ATOL = 2e-6  # MeshNormals on the card against the CPU path (tests/test_mesh.py)

TIMED_CALLS = 50  # calls per timing, back to back
TIMED_PLAIN_NN = 5  # calls per timing of the K4 twin, which takes ~0.1 s a call ...
PROFILED_PLAIN_NN = 1  # ... and ~40k profiler events per call
PROFILED_FRAMES = 3  # frames 1..3 of sample1 in phase 5
#: Kernel names in csrc/, by the wrapper that launches them.
KERNEL_NAMES = {"icp": ("icp_step_partials", "icp_step_finish"),
                "splat": ("bilateral_splat",), "slice": ("bilateral_slice",)}


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def device_events(torch, prof):
    """The device activities (kernels, copies, sets) of a profile."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def timings(torch, fn, n: int = TIMED_CALLS, profiled: int | None = None) -> tuple[float | None, float]:
    """(device ms per call, per-call ms) of ``fn``.

    The device time is the summed duration of the device activities that
    ``torch.profiler`` records over ``profiled`` calls (default ``n``),
    divided by their number (None when the profiler sees none). The per-call
    time is one CUDA event pair around ``n`` back-to-back calls, divided by
    ``n``: where the host dispatches more slowly than the device runs, it is
    the host's time per call.
    """
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            fn()
        torch.cuda.synchronize()
    device_us = sum(e.time_range.elapsed_us() for e in device_events(torch, prof))
    return (device_us / 1e3 / profiled if device_us > 0 else None), per_call


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
    return err, timings(torch, lambda: bil._splat(*args)), timings(torch, lambda: bil._splat_plain(*args))


def check_slice(torch, bil, depth):
    filt = bil.BilateralFilter()
    grid = bil.BilateralGrid.from_image(depth, filt.sigma_space, filt.sigma_color, filt.pad_depth_to)
    grid = grid.convolve().normalize()
    args = (grid.data_cm, depth, grid.color_min, filt.sigma_space, filt.sigma_color)
    got, ref = bil._slice(*args), bil._slice_plain(*args)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    cast_err = int((got.to(torch.int32) - ref.to(torch.int32)).abs().max())
    print(f"K3 slice: max|kernel - plain| = {err} before the cast, {cast_err} after")
    if not (err <= SLICE_ATOL and cast_err <= SLICE_CAST_MAX):
        raise AssertionError("K3 slice differs from its plain twin")
    return err, timings(torch, lambda: bil._slice(*args)), timings(torch, lambda: bil._slice_plain(*args))


def check_icp(torch, pyr0, pyr1):
    from align3d_torch.icp.params import MsIcpParams
    from align3d_torch.ops import icp_fused
    from align3d_torch.ops.target_pack import pack_geometry, pack_intensity_taps
    from align3d_torch.se3 import Transform

    params = MsIcpParams.default()
    pose = Transform.exp(torch.tensor([0.004, -0.002, 0.003, 0.002, -0.003, 0.001], device=DEVICE))
    worst_rel, timing = 0.0, None
    for level, (tgt, src) in enumerate(zip(pyr0, pyr1)):
        h, w = tgt.height, tgt.width
        n = h * w
        args = (
            pose.rotation[None].contiguous(), pose.translation[None].contiguous(),
            src.points.reshape(1, n, 3).contiguous(), src.mask.reshape(1, n).to(torch.uint8),
            src.intensities.reshape(1, n).contiguous(),
            pack_geometry(tgt.points, tgt.normals, tgt.mask)[None],
            pack_intensity_taps(tgt.intensity_map)[None],
            h, w, tgt.intrinsics, params[level],
        )
        got, ref = icp_fused.icp_step_fused(*args), icp_fused.icp_step_plain(*args)
        torch.cuda.synchronize()
        valid = int(src.mask.sum())
        for s, name in ((0, "geometric"), (1, "colour")):
            g, r = got[0, s], ref[0, s]
            count_diff = abs(float(g[7, 7]) - float(r[7, 7]))
            h_err = float((g[:6, :6] - r[:6, :6]).abs().max()) / float(r[:6, :6].abs().max())
            g_err = float((g[:6, 6] - r[:6, 6]).abs().max()) / float(r[:6, 6].abs().max())
            sq_err = abs(float(g[6, 6]) - float(r[6, 6])) / float(r[6, 6])
            worst_rel = max(worst_rel, h_err, g_err, sq_err)
            print(f"K1 level {level} {name}: count {float(g[7, 7]):.0f} vs {float(r[7, 7]):.0f}, "
                  f"H rel {h_err:.2e}, g rel {g_err:.2e}, sum w r^2 rel {sq_err:.2e}")
            if not (count_diff <= ICP_COUNT_SHARE * valid and h_err <= ICP_REL
                    and g_err <= ICP_REL and sq_err <= ICP_REL):
                raise AssertionError(f"K1 level {level} {name} differs from its plain twin")
        again = icp_fused.icp_step_fused(*args)
        if not torch.equal(again, got):
            raise AssertionError("K1 is not deterministic")
        if level == 0:
            timing = (timings(torch, lambda: icp_fused.icp_step_fused(*args)),
                      timings(torch, lambda: icp_fused.icp_step_plain(*args)))
    return worst_rel, *timing


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
    return err, timings(torch, lambda: nn.band_search(*args, payload)), timings(
        torch, lambda: nn.band_search_plain(*args, payload), TIMED_PLAIN_NN, PROFILED_PLAIN_NN)


def grid_mesh(np, side, freq):
    """benches/bench_mesh.py's height-field mesh: side 320 has 204,800 faces."""
    ys, xs = np.meshgrid(np.arange(side + 1), np.arange(side + 1), indexing="ij")
    zs = np.sin(xs * freq) * np.cos(ys * freq)
    pts = np.stack([xs, ys, zs], axis=-1).reshape(-1, 3).astype(np.float32)
    faces = []
    for r in range(side):
        base, a = r * (side + 1), np.arange(side)
        faces.append(np.stack([base + a, base + a + 1, base + side + 1 + a], 1))
        faces.append(np.stack([base + a + 1, base + side + 2 + a, base + side + 1 + a], 1))
    return pts, np.concatenate(faces).astype(np.int32)


def check_mesh(torch, mesh, label, pts, faces):
    ev = mesh.MeshNormals(faces, pts.shape[0], device=DEVICE)
    points = torch.from_numpy(pts).to(DEVICE)
    args = (points, ev.faces, ev.table, ev.counts)
    got, ref = mesh.vertex_normals(*args), mesh.vertex_normals_plain(*args)
    torch.cuda.synchronize()
    same = torch.equal(torch.isnan(got), torch.isnan(ref)) and torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref))
    err = float((torch.nan_to_num(got) - torch.nan_to_num(ref)).abs().max())
    print(f"K5 {label}: {faces.shape[0]} faces, degree {ev.degree}, bitwise = {same}")
    if not same:
        raise AssertionError(f"K5 {label} differs from its plain twin")
    return err, timings(torch, lambda: mesh.vertex_normals(*args)), timings(torch, lambda: mesh.vertex_normals_plain(*args))


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
    tea_cpu = mesh.MeshNormals(teapot.faces, len(teapot.points))(torch.from_numpy(teapot.points))
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
    kernel_us = {key: sum(e.time_range.elapsed_us() for e in events if any(k in e.name for k in names))
                 for key, names in KERNEL_NAMES.items()}
    kernel_launches = {key: sum(names[0] in e.name for e in events) for key, names in KERNEL_NAMES.items()}
    n = len(frames)
    return {
        "host_ms_per_frame": host,
        "profiled_wall_ms_per_frame": wall_ms / n,
        "device_busy_ms_per_frame": busy_ms / n,
        "device_busy_share": busy_ms / wall_ms,
        "device_activities_per_frame": len(events) / n,
        "kernel_device_us_per_launch": {key: kernel_us[key] / max(kernel_launches[key], 1)
                                        for key in KERNEL_NAMES},
        "kernel_launches_per_frame": {key: kernel_launches[key] / n for key in KERNEL_NAMES},
    }


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
    slice_ = check_slice(torch, bil, depth0)
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
    mesh_pts, mesh_faces = grid_mesh(np, 320, 0.1)
    teapot = read_ply(ROOT / "tests" / "data" / "teapot.ply")
    mesh_grid = check_mesh(torch, mesh, "grid mesh", mesh_pts, mesh_faces)
    mesh_teapot = check_mesh(torch, mesh, "teapot", teapot.points, teapot.faces.astype(np.int32))
    torch.cuda.synchronize()

    done("phase 3")

    # -- 4. the main path ----------------------------------------------------
    subset = SubsetDataset(dataset, range(FRAMES))
    icp_fused.LAUNCHES = bil.SPLAT_LAUNCHES = bil.SLICE_LAUNCHES = 0
    first = run_odometry(subset, "cuda", range_builder=builder, icp_params=MsIcpParams.default())
    launches = {"icp": icp_fused.LAUNCHES, "splat": bil.SPLAT_LAUNCHES, "slice": bil.SLICE_LAUNCHES}
    print(f"main-path launches: {launches}")
    if min(launches.values()) <= 0:
        return fail(f"a kernel of the main path never launched: {launches}")
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

    # -- 5. where a frame's time goes ---------------------------------------
    print("frame profile: " + json.dumps(profile_frames(torch, dataset, builder, MsIcpParams.default())))
    print("pcl profile: " + json.dumps(profile_pcl(torch, nn, Icp, IcpParams, target, source)))
    done("phase 5")

    def entry(name, source, replaces, key, checked, err_kind, **extra):
        err, (ms, call_ms), (plain_ms, plain_call_ms) = checked
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[key], "max_abs_err": err, "err": err_kind,
                # ms / plain_ms: device time per call (torch.profiler), None where
                # it saw none; *_call_ms: per-call time of back-to-back calls.
                "ms": ms, "plain_ms": plain_ms, "call_ms": call_ms, "plain_call_ms": plain_call_ms,
                "timed_calls": TIMED_CALLS, **extra}

    def shape_times(checked):
        err, (ms, call_ms), (plain_ms, plain_call_ms) = checked
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "call_ms": call_ms,
                "plain_call_ms": plain_call_ms}

    kernels = [
        entry("icp_step_fused (K1)", "align3d_torch/csrc/icp_step.cu", "align3d_tpu/ops/icp_pallas_v4.py:96",
              "icp", icp, "max |kernel - plain| / max|plain| over H, g and sum w r^2"),
        entry("bilateral_splat (K2)", "align3d_torch/csrc/bilateral.cu", "align3d_tpu/ops/bilateral.py:80",
              "splat", splat, "max |kernel - plain|"),
        entry("bilateral_slice (K3)", "align3d_torch/csrc/bilateral.cu", "align3d_tpu/ops/bilateral.py:389",
              "slice", slice_, "max |kernel - plain| before the cast"),
        # K4's ms at the pcl-ICP path's shape (associate_p2p on sample1);
        # the twin's per-call time is over TIMED_PLAIN_NN calls, its device
        # time over PROFILED_PLAIN_NN.
        entry("nn_banded (K4)", "align3d_torch/csrc/nn_banded.cu", "align3d_tpu/ops/nn_banded.py:178",
              "nn", nn_p2p, "max |kernel - plain| of the scores (positions and payload bitwise)",
              plain_timed_calls=TIMED_PLAIN_NN, plain_profiled_calls=PROFILED_PLAIN_NN,
              shapes={"nearest_500k_band256": shape_times(nn_500[256]),
                      "nearest_500k_band512": shape_times(nn_500[512])}),
        entry("mesh_normals (K5)", "align3d_torch/csrc/mesh.cu", "align3d_tpu/ops/mesh.py:243",
              "mesh", mesh_grid, "max |kernel - plain| (NaN at the same vertices)",
              shapes={"teapot": shape_times(mesh_teapot)}),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
