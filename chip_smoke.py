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
   and the teapot. P1 and P2, the roofline probes, against their twins at
   the sizes the roofline tool measures them (P1 relative, P2 bitwise). K2
   and K3 over the 65 sample1 frames of the throughput series in one launch
   each, bitwise against 65 single-frame launches, and K2 bitwise against
   its plain twin; K2 over each deep bucket of the mixed series at the
   bucket's depth, bitwise against its plain twin; K3 over the 29 sample2
   frames of the mixed series (gd > 128) against its plain twin.
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
      and of the 204,800-face grid mesh;
   d. the throughput path: ``odometry_step`` on the 65-frame real series
      (64 pairs, 640x480, ``MsIcpParams.default()``), bilateral filter off
      and then bucketed on: one K1 launch per GN iteration over all 64 pairs
      (70), one K2 and one K3 launch per bucket; each pair's K1 blocks at
      B = 64 bitwise their B = 1 blocks, and held against the plain twin
      at those poses moved by phase 3's twist; the relative poses bitwise
      against the sequential ``MultiscaleAlign`` on the same pyramids; the
      pairs against
      ground truth; a bitwise rerun; the mixed sample1 + sample2 series
      through at least two depth buckets, each frame's bucketed filter
      bitwise its own ``filter_static``, the true adjacent pairs against
      ground truth.
5. Break a frame's time down: host clock per phase (decode, pyramid build,
   bilateral filter, ICP), each ended by a synchronise, and
   ``torch.profiler`` over the same frames for the device's busy time and
   each kernel's device time per launch; then the same for one point-cloud
   ICP align, with its host syncs per iteration; then the 64-pair step:
   ms per pair (median of 3, bilateral off and on), the device's busy share
   and activities per GN iteration, K1's device time per launch at B = 64,
   the peak device memory.
6. The roofline tool (``align3d_torch.tools.roofline``): P1 and P2 rates,
   the matmul and stream yardsticks, K1 at batch 64 against them.

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
SLICE_ATOL = 2e-3  # K3 before the cast (tests/test_bilateral.py's kernel bound)
SLICE_CAST_MAX = 1  # K3 after the truncating cast
ICP_COUNT_SHARE = 1e-4  # K1: count within 0.01% of the valid pixels
ICP_REL = 1e-4  # K1: H and g within 1e-4 x max|entry|
K1_TWIST = [0.004, -0.002, 0.003, 0.002, -0.003, 0.001]  # the pose K1 is held against its twin at
POSE_ATOL = 2e-3  # poses against the golden: rad / m
MEAN_ANGLE_DEG, MEAN_TRANS = 0.5, 0.01  # tests/test_odometry_accuracy.py bound

PCL_MAX_ANGLE = 0.1  # pcl ICP against ground truth (pcl_icp.rs:121-136, tests/test_icp.py)
PCL_ENGINES_ANGLE = 0.02  # banded against hash (tests/test_icp.py::test_pcl_icp_align_banded_engine)
WAVY_BOUND = 0.01  # rad / m (tests/test_icp.py::test_pcl_icp_banded_large_step_resort)
MESH_ATOL = 2e-6  # MeshNormals on the card against the CPU path (tests/test_mesh.py)

FMA_RTOL = 1e-5  # P1 against its twin: fmaf rounds once, the twin twice
GRID_SAMPLE_ATOL = 0.05  # K3's library yardstick must reproduce the sample this closely (depth units)
INDEX_ADD_RTOL = 1e-5  # K2's library yardstick: the same sums in another order
STEP_ITERATIONS = 70  # GN iterations of one MsIcpParams.default() align: 30 + 20 + 20

# Published H100 SXM peaks at 700 W (the bounds are stated against them).
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12

TIMED_CALLS = 50  # calls per timing, back to back
TIMED_PLAIN_NN = 5  # calls per timing of the K4 twin, which takes ~0.1 s a call ...
PROFILED_PLAIN_NN = 1  # ... and ~40k profiler events per call
PROFILED_FRAMES = 3  # frames 1..3 of sample1 in phase 5
#: Kernel names in csrc/, by the wrapper that launches them.
KERNEL_NAMES = {"icp": ("icp_step_partials", "icp_step_finish"),
                "splat": ("bilateral_splat",), "slice": ("bilateral_slice",)}


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
    lib = library_splat(torch, bil, depth, cmin, shape, filt, got)
    # Bytes: the image once and the grid once; ~10 flops per pixel.
    b = bound(depth.numel() * 4 + got.numel() * 4, depth.numel() * 10)
    return err, timings(torch, lambda: bil._splat(*args)), timings(torch, lambda: bil._splat_plain(*args)), b, lib


def library_splat(torch, bil, depth, cmin, shape, filt, kernel_out):
    """One ``index_add_`` of w * v and w into the flat channel-major grid,
    at the cells the reference's splat map gives each pixel (timed only)."""
    gh, gw, gd = shape
    h, w = depth.shape
    inv_ss = float(1.0 / filt.sigma_space)
    rows = ((torch.arange(h, device=depth.device, dtype=torch.float32) * inv_ss + 0.5).to(torch.int64) + 2)
    cols = ((torch.arange(w, device=depth.device, dtype=torch.float32) * inv_ss + 0.5).to(torch.int64) + 2)
    vals = depth.to(torch.float32)
    chan = ((vals - cmin) * (1.0 / filt.sigma_color) + 0.5).to(torch.int64) + 2
    idx = ((rows[:, None] * gw + cols[None, :]) * gd + chan).reshape(-1)
    wt = (depth > 0).to(torch.float32).reshape(-1)
    src = torch.stack([wt * vals.reshape(-1), wt])
    flat = torch.zeros((2, gh * gw * gd), device=depth.device)

    def call():
        flat.zero_()
        flat.index_add_(1, idx, src)

    call()
    torch.cuda.synchronize()
    rel = float((flat.reshape(kernel_out.shape) - kernel_out).abs().max() / kernel_out.abs().max())
    flat_ms, _ = timings(torch, lambda: flat.index_add_(1, idx, src))
    return {"library_ms": flat_ms, "library_call": "Tensor.index_add_ (2 channels, one call)",
            "library_max_rel_diff": rel, "library_ok": rel <= INDEX_ADD_RTOL}


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
    lib = library_slice(torch, grid, depth, filt, got)
    # Bytes: the grid cells sampled, the image and the output once; ~30 flops a pixel.
    cells = sampled_cells(torch, bil, depth, grid.color_min, *grid.data_cm.shape[1:], filt)
    b = bound(cells * 4 + depth.numel() * 8, depth.numel() * 30)
    return err, timings(torch, lambda: bil._slice(*args)), timings(torch, lambda: bil._slice_plain(*args)), b, lib


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


def library_slice(torch, grid, depth, filt, kernel_out):
    """``grid_sample`` 5-D trilinear (border padding, corners aligned) at the
    pixels' grid coordinates, as K3's yardstick where it reproduces K3."""
    import torch.nn.functional as F

    gh, gw, gd = grid.data_cm.shape[1:]
    h, w = depth.shape
    inv_ss = float(1.0 / filt.sigma_space)
    y = torch.arange(h, device=depth.device, dtype=torch.float32) * inv_ss + 2
    x = torch.arange(w, device=depth.device, dtype=torch.float32) * inv_ss + 2
    z = (depth.to(torch.float32) - grid.color_min) * (1.0 / filt.sigma_color) + 2

    def norm(c, n):
        return c * (2.0 / (n - 1)) - 1.0

    coords = torch.stack([norm(z, gd), norm(x, gw)[None, :].expand(h, w), norm(y, gh)[:, None].expand(h, w)], -1)
    coords = coords[None, None].contiguous()
    value = grid.data_cm[0][None, None].contiguous()

    def call():
        return F.grid_sample(value, coords, mode="bilinear", padding_mode="border", align_corners=True)

    diff = float((call()[0, 0, 0] - kernel_out).abs().max())
    ms, _ = timings(torch, call)
    ok = diff <= GRID_SAMPLE_ATOL
    return {"library_ms": ms if ok else None, "library_call": "F.grid_sample 5-D trilinear",
            "library_max_abs_diff": diff, "library_ok": ok,
            **({} if ok else {"library_reason": f"grid_sample differs from the sample by {diff}"})}


def check_icp(torch, pyr0, pyr1):
    from align3d_torch.icp.params import MsIcpParams
    from align3d_torch.ops import icp_fused
    from align3d_torch.ops.target_pack import pack_geometry, pack_intensity_taps
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
            pack_geometry(tgt.points, tgt.normals, tgt.mask)[None],
            pack_intensity_taps(tgt.intensity_map)[None],
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
            timing = (timings(torch, lambda: icp_fused.icp_step_fused(*args)),
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
    # Bytes: points, faces, incidence table, counts and output once; ~30 flops a face.
    b = bound(sum(t.numel() * t.element_size() for t in args) + got.numel() * 4, faces.shape[0] * 30)
    return err, timings(torch, lambda: mesh.vertex_normals(*args)), timings(torch, lambda: mesh.vertex_normals_plain(*args)), b, {
        "library_ms": None, "library_reason": "no PyTorch call computes vertex normals (face normals, then a "
        "scatter, then a division)"}


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
    """K2 and K3 over the 65 sample1 frames of the throughput series, one
    launch each, bitwise against 65 single-frame launches, and K2 bitwise
    against its plain twin; K2 (bitwise) and K3 over the sample2 frames of
    the mixed series (gd > 128) against their plain twins."""
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
    norm = bil._normalize(bil._blur(grids, gd))
    slice_args = (norm, depths, cmin, filt.sigma_space, filt.sigma_color)
    sliced = bil._slice(*slice_args)
    slice_err = float((sliced - bil._slice_plain(*slice_args)).abs().max())
    # The twins at this shape, CUDA events around one call each.
    splat_plain_ms = time_ms(lambda: bil._splat_plain(*splat_args), reps=1, warmup=0)
    slice_plain_ms = time_ms(lambda: bil._slice_plain(*slice_args), reps=1, warmup=0)
    same_splat = all(torch.equal(bil._splat(depths[b], int(cmin[b]), (gh, gw, gd), filt.sigma_space,
                                            filt.sigma_color), grids[b]) for b in range(len(depths)))
    same_slice = all(torch.equal(bil._slice(norm[b].contiguous(), depths[b], int(cmin[b]), filt.sigma_space,
                                            filt.sigma_color), sliced[b]) for b in range(len(depths)))
    splat_ms, _ = timings(torch, lambda: bil._splat(*splat_args), n=10)
    slice_ms, _ = timings(torch, lambda: bil._slice(*slice_args), n=10)
    cells = sampled_cells(torch, bil, depths, cmin, gh, gw, gd, filt)
    print(f"K2/K3 over {len(depths)} frames, grid (2, {gh}, {gw}, {gd}): bitwise against single-frame launches: "
          f"splat {same_splat}, slice {same_slice}; against the plain twins: K2 bitwise {splat_plain}, "
          f"K3 max |kernel - plain| {slice_err}; device ms per launch {splat_ms} / {slice_ms}, "
          f"twins {splat_plain_ms} / {slice_plain_ms}")
    if not (same_splat and same_slice and splat_plain and slice_err <= SLICE_ATOL):
        raise AssertionError("batched K2/K3 differ from single-frame launches or from their plain twins")
    del grids, norm, sliced

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
    dnorm = bil._normalize(bil._blur(bil._splat(deep, dmin, (gh, gw, dgd), filt.sigma_space, filt.sigma_color),
                                     dgd))
    got = bil._slice(dnorm, deep, dmin, filt.sigma_space, filt.sigma_color)
    ref = bil._slice_plain(dnorm, deep, dmin, filt.sigma_space, filt.sigma_color)
    err = float((got - ref).abs().max())
    print("K2 over the mixed series' deep buckets, bitwise against its plain twin: "
          + ", ".join(f"gd {g} x {n} frames {same}" for g, (n, same) in deep_buckets.items())
          + f"; K3 over {len(deep)} sample2 frames at gd {dgd}: max |kernel - plain| {err}")
    if not (deep_buckets and all(same for _, same in deep_buckets.values())):
        raise AssertionError("K2 over the mixed series' deep buckets differs from its plain twin")
    if not (dgd > 128 and len(deep) >= 3 and err <= SLICE_ATOL):
        raise AssertionError("K3 at B >= 3, gd > 128 differs from its plain twin")
    return {"batch": len(depths), "gd": gd, "splat_ms": splat_ms, "slice_ms": slice_ms, "slice_cells": cells,
            "splat_plain_ms": splat_plain_ms, "slice_plain_ms": slice_plain_ms, "slice_max_abs_err": slice_err,
            "splat_max_abs_err": splat_err,
            "splat_ms_per_frame": splat_ms / len(depths) if splat_ms else None,
            "slice_ms_per_frame": slice_ms / len(depths) if slice_ms else None,
            "splat_bitwise_plain": splat_plain, "deep_splat_bitwise_plain": {g: s for g, (_, s) in deep_buckets.items()},
            "deep_batch": len(deep), "deep_gd": dgd, "deep_max_abs_err": err}


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

    def reset():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read():
        return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}

    params = MsIcpParams.default()
    filt = bil.BilateralFilter()
    colors, depths, scales = series_inputs(torch, real)
    out = {}
    trajs = {}
    for label, f in (("off", None), ("on", filt)):
        reset()
        traj = pb.odometry_step(real.camera, scales, colors, depths, params, bilateral_filter=f, device=DEVICE)
        torch.cuda.synchronize()
        launches = read()
        plan = bucket_plan(real.depths, filt)
        want = {"icp": STEP_ITERATIONS, "splat": len(plan) if f else 0, "slice": len(plan) if f else 0}
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
    reset()
    torch.cuda.reset_peak_memory_stats()
    mtraj = pb.odometry_step(mixed.camera, mscales, mcolors, mdepths, params, bilateral_filter=filt, device=DEVICE)
    torch.cuda.synchronize()
    mlaunch = read()
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
            and mlaunch["splat"] == mlaunch["slice"] == len(plan)
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

    # -- 4d. the throughput path ---------------------------------------------
    counters = {"icp": (icp_fused, "LAUNCHES"), "splat": (bil, "SPLAT_LAUNCHES"), "slice": (bil, "SLICE_LAUNCHES")}
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
    done("phase 6")
    by_path = {"odometry (4a)": {k: launches[k] for k in ("icp", "splat", "slice")},
               "throughput, bilateral off (4d)": throughput["bilateral_off"]["launches"],
               "throughput, bilateral on (4d)": throughput["bilateral_on"]["launches"],
               "mixed series (4d)": throughput["mixed"]["launches"]}

    def entry(name, source, replaces, key, checked, err_kind, **extra):
        err, (ms, call_ms), (plain_ms, plain_call_ms), bnd, lib = checked
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
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
    p2 = roof["p2_hbm"]

    kernels = [
        entry("icp_step_fused (K1)", "align3d_torch/csrc/icp_step.cu", "align3d_tpu/ops/icp_pallas_v4.py:96",
              "icp", icp, "max |kernel - plain| / max|plain| over H, g and sum w r^2",
              launches_by_path={k: v["icp"] for k, v in by_path.items()},
              shapes={"batch64_real_pairs": {
                  "ms": k1_64["ms"], "us_per_pair": k1_64["us_per_pair"],
                  "device_us_per_launch_in_step": step_profile["bilateral_off"]["k1_device_us_per_launch"],
                  "plain_ms": throughput["k1_batch64_plain_ms"],
                  "max_abs_err": throughput["k1_batch64_max_rel_err_plain"],
                  **bound(k1_64["bytes"], 300 * k1_64["gathers"] / 2)}}),
        entry("bilateral_splat (K2)", "align3d_torch/csrc/bilateral.cu", "align3d_tpu/ops/bilateral.py:80",
              "splat", splat, "max |kernel - plain|",
              launches_by_path={k: v["splat"] for k, v in by_path.items()},
              shapes={f"batch{frames}_gd{batched_bil['gd']}": {
                  "ms": batched_bil["splat_ms"], "ms_per_frame": batched_bil["splat_ms_per_frame"],
                  "plain_ms": batched_bil["splat_plain_ms"], "max_abs_err": batched_bil["splat_max_abs_err"],
                  **bound(frames * (480 * 640 * 4 + 2 * gh * gw * batched_bil["gd"] * 4), frames * 480 * 640 * 10)}}),
        entry("bilateral_slice (K3)", "align3d_torch/csrc/bilateral.cu", "align3d_tpu/ops/bilateral.py:389",
              "slice", slice_, "max |kernel - plain| before the cast",
              launches_by_path={k: v["slice"] for k, v in by_path.items()},
              shapes={f"batch{frames}_gd{batched_bil['gd']}": {
                  "ms": batched_bil["slice_ms"], "ms_per_frame": batched_bil["slice_ms_per_frame"],
                  "plain_ms": batched_bil["slice_plain_ms"], "max_abs_err": batched_bil["slice_max_abs_err"],
                  **bound(batched_bil["slice_cells"] * 4 + frames * 480 * 640 * 8, frames * 480 * 640 * 30)},
                  "sample2_deep": {"frames": batched_bil["deep_batch"], "gd": batched_bil["deep_gd"],
                                   "max_abs_err": batched_bil["deep_max_abs_err"]}}),
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
        # P1 and P2 at the roofline tool's sizes; their twins timed at the same
        # sizes with CUDA events around one call (phase 3).
        {"name": "fma_peak (P1)", "route": "cuda", "source": "align3d_torch/csrc/roofline.cu",
         "replaces": "tools/roofline_v4.py:52", "launches": launches["p1"],
         "max_abs_err": probes["p1_max_rel_err"], "err": "max |kernel - plain| / |plain|",
         "ms": roof["p1"]["ms"], "plain_ms": probes["p1_plain_ms"], "tflops": roof["p1"]["tflops"],
         **bound(0, roof["p1"]["flops"]),
         "library_ms": None, "library_reason": "no PyTorch call runs dependent FMA chains"},
        {"name": "gather_peak (P2)", "route": "cuda", "source": "align3d_torch/csrc/roofline.cu",
         "replaces": "tools/roofline_v4.py:98", "launches": launches["p2"],
         "max_abs_err": probes["p2_max_abs_err"],
         "err": "max |kernel - plain| of the integer sums over the lane, l2 and hbm modes",
         "err_by_mode": probes["p2_errs"],
         "ms": p2["ms"], "plain_ms": probes["p2_plain_ms"], "mode": "hbm", "gathers_per_s": p2["gathers_per_s"],
         **bound(p2["gathers"] * 4, 0),
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
