#!/usr/bin/env python3
"""Smoke run of the align3d_torch port on one CUDA GPU.

    python chip_smoke.py

Run from the root of a checkout. Phases, each of which fails the run:

1. CUDA present; print the device and ``nvidia-smi`` name / power limit.
2. Build the CUDA kernels from ``align3d_torch/csrc`` (timed).
3. Hold each kernel against its plain-PyTorch twin on the card at the main
   path's shapes (sample1 frames 0 and 1, 640x480, the three pyramid levels,
   the (2, 111, 146, 96) bilateral grid), and time both: device time per
   call from ``torch.profiler``, and per-call time of back-to-back calls
   between one CUDA event pair.
4. Drive the main path: ``run_odometry`` on sample1, 10 frames, bilateral
   filter on, on the GPU, with every kernel's launch count reset just
   before; check the counts, the trajectory error against ground truth, the
   poses against the JAX package's golden trajectory, and that a second run
   gives a bitwise-identical trajectory.
5. Break a frame's time down: host clock per phase (decode, pyramid build,
   bilateral filter, ICP), each ended by a synchronise, and
   ``torch.profiler`` over the same frames for the device's busy time and
   each kernel's device time per launch.

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

TIMED_CALLS = 50  # calls per timing, back to back
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


def timings(torch, fn, n: int = TIMED_CALLS) -> tuple[float | None, float]:
    """(device ms per call, per-call ms) of ``fn`` over ``n`` calls.

    The device time is the summed duration of the device activities that
    ``torch.profiler`` records over the calls, divided by ``n`` (None when
    the profiler sees none). The per-call time is one CUDA event pair around
    ``n`` back-to-back calls, divided by ``n``: where the host dispatches
    more slowly than the device runs, it is the host's time per call.
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    device_us = sum(e.time_range.elapsed_us() for e in device_events(torch, prof))
    return (device_us / 1e3 / n if device_us > 0 else None), per_call


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
    torch.cuda.synchronize()

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

    # -- 5. where a frame's time goes ---------------------------------------
    print("frame profile: " + json.dumps(profile_frames(torch, dataset, builder, MsIcpParams.default())))

    def entry(name, source, replaces, key, checked, err_kind):
        err, (ms, call_ms), (plain_ms, plain_call_ms) = checked
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[key], "max_abs_err": err, "err": err_kind,
                # ms / plain_ms: device time per call (torch.profiler), None where
                # it saw none; *_call_ms: per-call time of back-to-back calls.
                "ms": ms, "plain_ms": plain_ms, "call_ms": call_ms, "plain_call_ms": plain_call_ms,
                "timed_calls": TIMED_CALLS}

    kernels = [
        entry("icp_step_fused (K1)", "align3d_torch/csrc/icp_step.cu", "align3d_tpu/ops/icp_pallas_v4.py:96",
              "icp", icp, "max |kernel - plain| / max|plain| over H, g and sum w r^2"),
        entry("bilateral_splat (K2)", "align3d_torch/csrc/bilateral.cu", "align3d_tpu/ops/bilateral.py:80",
              "splat", splat, "max |kernel - plain|"),
        entry("bilateral_slice (K3)", "align3d_torch/csrc/bilateral.cu", "align3d_tpu/ops/bilateral.py:389",
              "slice", slice_, "max |kernel - plain| before the cast"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
