"""The port's benches (``align3d_torch/benches``) against the JAX package's
(``bench.py``, ``benches/``), on the CPU at small sizes.

* each bench prints its JAX counterpart's metric name;
* each input the JAX bench builds in a function is what the port's builder
  makes from the same seed (``bench.py::_synthetic_pair``: bitwise, the
  normals within ``NORMALS_ATOL``;
  ``benches/bench_odometry.py::_bucket_plan``: equal); each input a JAX
  bench builds inline is held to a numpy copy of the cited lines at a
  reduced count (bitwise), the seed-11 pose graph and BA problem to the
  cited lines run with the JAX package (the random draws bitwise, the
  poses within ``POSE_ATOL``: two SE(3) implementations in float32);
* each bench's ``main --device cpu --quick`` at tiny sizes prints exactly
  one JSON line with the harness's keys, and its result is bitwise the
  same port call made directly;
* ``--device cuda`` without CUDA raises (no fallback), as do missing
  fixtures; ``bench_icp_kernel --radius`` reaches the banded kernel;
* importing the benches pulls in neither ``jax`` nor ``align3d_tpu``.
"""

import contextlib
import importlib
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import _torch_cpu
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_torch.benches import BENCHES
from align3d_torch.benches import _harness as harness

ROOT = Path(__file__).resolve().parent.parent
JAX_SOURCE = {name: ROOT / "benches" / f"{name}.py" for name in BENCHES}
JAX_SOURCE["bench_image_icp"] = ROOT / "bench.py"
KEYS = {"metric", "value", "unit", "vs_baseline", "runs", "min", "max", "host_ms", "device_busy_ms", "busy_share",
        "launches", "profiler_launches", "card"}
POSE_ATOL = 1e-5  # the seed-11 circle's poses, the port's SE(3) against JAX's, float32 over 30 compositions
UV_ATOL = 1e-2  # pixels: POSE_ATOL at 2-8 m through a 525-pixel focal length
# The synthetic pair's normals: bitwise when JAX compiles its program here;
# when it loads it from the persistent compilation cache (built for another
# CPU's features), 10 of 307,200 target pixels are 1 ulp (1.2e-7) off.
NORMALS_ATOL, NORMALS_SHARE = 2.4e-7, 1e-4


def _bench(name):
    return importlib.import_module(f"align3d_torch.benches.{name}")


def _metric(mod) -> str:
    return getattr(mod, "METRIC", None) or mod.KERNEL_METRIC


def _run(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        outcome = mod.run(argv)
    return outcome, [line for line in buf.getvalue().splitlines() if line.strip()]


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if hasattr(a, "rotation"):
        return _same((a.rotation, a.translation), (b.rotation, b.translation))
    return torch.equal(a, b)


# -- metric names ---------------------------------------------------------------

@pytest.mark.parametrize("name", BENCHES)
def test_metric_name_is_the_jax_benchs(name):
    src = JAX_SOURCE[name].read_text()
    metric = _metric(_bench(name))
    if name == "bench_icp_kernel":
        # JAX formats the name from its flags; the port prints its defaults' spelling.
        assert 'f"{name}_us_per_pair_iter"' in src and 'f"kernel_only_{args.engine}_r{args.radius}"' in src
        assert '"--radius", type=int, default=2' in src and 'default="v3"' in src
        assert metric == "kernel_only_v3_r2_us_per_pair_iter"
        assert 'f"full_align_{args.engine}_r{args.radius}"' in src
        assert _bench(name).FULL_METRIC == "full_align_v3_r2_us_per_pair_iter"
    else:
        assert f'"{metric}"' in src


# -- inputs against the JAX benches' ----------------------------------------------

def test_synthetic_pair_bitwise_bench_py():
    from align3d_torch.benches.bench_image_icp import synthetic_images

    spec = importlib.util.spec_from_file_location("jax_bench_py", ROOT / "bench.py")
    jax_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_bench)
    source, target = jax_bench._synthetic_pair()
    ours = synthetic_images("cpu")
    assert ours.intrinsics.fx == source.intrinsics.fx and ours.intrinsics.cx == source.intrinsics.cx
    for b, ref in ((0, target), (1, source)):
        for field in ("points", "mask", "intensities", "intensity_map"):
            got = getattr(ours, field)[b].numpy()
            want = np.asarray(getattr(ref, field))
            assert got.dtype == want.dtype and np.array_equal(got.view(np.uint8), want.view(np.uint8)), field
        got, want = ours.normals[b].numpy(), np.asarray(ref.normals)
        off = (got != want).any(axis=-1)
        assert np.abs(got - want).max() <= NORMALS_ATOL and off.mean() <= NORMALS_SHARE


def test_real_pairs_are_bench_pys():
    """``bench.py::_real_pairs``'s first pairs (source frame i + 1, target
    frame i of sample1), built with the JAX package frame by frame."""
    import jax.numpy as jnp

    from align3d_tpu import config as jconfig
    from align3d_tpu.io.datasets.slamtb import SlamTbDataset as JaxSlamTb
    from align3d_tpu.range_image import build_pyramid_impl as jax_build
    from align3d_torch.tools import series

    ds = JaxSlamTb.load(jconfig.ref_data_path("rgbd", "sample1"))

    def jax_image(i):
        f = ds.get(i)
        return jax_build(True, True, 1, 1.0, f.camera, float(f.image.depth_scale), jnp.asarray(f.image.color),
                         jnp.asarray(f.image.depth))[0]

    images = [jax_image(i) for i in range(3)]
    sources, targets = series.real_pairs(2, "cpu")
    for b in range(2):
        for ours, ref in ((sources, images[b + 1]), (targets, images[b])):
            for field in ("points", "mask", "intensities", "intensity_map"):
                assert np.array_equal(getattr(ours, field)[b].numpy(), np.asarray(getattr(ref, field))), field
            assert np.abs(ours.normals[b].numpy() - np.asarray(ref.normals)).max() <= NORMALS_ATOL


def test_bucket_plan_equals_bench_odometry():
    from benches.bench_odometry import _bucket_plan

    from align3d_tpu.ops.bilateral import BilateralFilter as JaxFilter
    from align3d_torch.benches.bench_odometry import synthetic_series
    from align3d_torch.ops.bilateral import BilateralFilter
    from align3d_torch.tools import series

    depths = np.concatenate([series.mixed_frames(40).depths[::3], synthetic_series(3).depths])
    want = _bucket_plan(depths, JaxFilter())
    got = series.bucket_plan(depths, BilateralFilter())
    assert len(got) == len(want) >= 2
    for (g, idx, lim), (jg, jidx, jlim) in zip(got, want):
        assert g == jg and list(idx) == list(jidx) and list(lim) == list(jlim)


def test_odometry_synthetic_series_is_bench_odometry_main():
    """``benches/bench_odometry.py::main``'s inline series (NFRAMES = 3)."""
    from align3d_torch.benches.bench_odometry import H, W, synthetic_series

    n = 3
    rng = np.random.default_rng(0)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    tex = rng.uniform(30, 220, size=(H, W + n + 1, 3)).astype(np.uint8)
    colors = np.stack([tex[:, i : i + W] for i in range(n)])
    depths = np.stack([(2000 + 2 * (xs + i) + ys + rng.integers(0, 8, size=(H, W))).astype(np.uint16)
                       for i in range(n)])
    got = synthetic_series(n)
    assert np.array_equal(got.colors, colors) and np.array_equal(got.depths, depths)
    assert (got.camera.fx, got.camera.cx, got.camera.cy, got.depth_scales) == (525.0, W / 2 - 0.5, H / 2 - 0.5, 0.001)


def test_mesh_grid_is_bench_mesh():
    """``benches/bench_mesh.py:20-33`` at side 12."""
    from align3d_torch.tools.ablate import grid_mesh

    side = 12
    ys, xs = np.meshgrid(np.arange(side + 1), np.arange(side + 1), indexing="ij")
    zs = np.sin(xs * 0.1) * np.cos(ys * 0.1)
    pts = np.stack([xs, ys, zs], axis=-1).reshape(-1, 3).astype(np.float32)
    faces = []
    for r in range(side):
        base = r * (side + 1)
        a = np.arange(side)
        faces.append(np.stack([base + a, base + a + 1, base + side + 1 + a], axis=1))
        faces.append(np.stack([base + a + 1, base + side + 2 + a, base + side + 1 + a], axis=1))
    got_pts, got_faces = grid_mesh(side)
    assert np.array_equal(got_pts, pts) and np.array_equal(got_faces, np.concatenate(faces).astype(np.int32))


def test_pcl_surface_is_bench_pcl_icp():
    """``benches/bench_pcl_icp.py:24-33`` at 1,000 points."""
    from align3d_torch.benches.bench_pcl_icp import surface

    n = 1000
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pts[:, 2] = 0.3 * np.sin(2.0 * pts[:, 0]) * np.cos(2.0 * pts[:, 1])
    dzdx = 0.6 * np.cos(2.0 * pts[:, 0]) * np.cos(2.0 * pts[:, 1])
    dzdy = -0.6 * np.sin(2.0 * pts[:, 0]) * np.sin(2.0 * pts[:, 1])
    normals = np.stack([-dzdx, -dzdy, np.ones(n, np.float32)], axis=1)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    got_pts, got_normals = surface(n)
    assert np.array_equal(got_pts, pts) and np.array_equal(got_normals, normals.astype(np.float32))


def test_nn_clouds_are_bench_voxel_nn():
    """``benches/bench_voxel_nn.py:23-24`` (jnp.asarray of float64 -> float32) at 5,000 points."""
    from align3d_torch.benches.bench_voxel_nn import clouds

    rng = np.random.default_rng(0)
    db, q = rng.uniform(0, 1, (5000, 3)), rng.uniform(0, 1, (5000, 3))
    got_db, got_q = clouds(5000)
    assert np.array_equal(got_db, db.astype(np.float32)) and np.array_equal(got_q, q.astype(np.float32))


def test_normals_and_bilateral_inputs_are_the_jax_benches():
    """``benches/bench_normals.py:24-25`` and ``benches/bench_bilateral.py:47-54``."""
    from align3d_torch.benches.bench_bilateral import depths, grid_depth
    from align3d_torch.benches.bench_normals import grid
    from align3d_torch.ops.bilateral import BilateralFilter

    h, w = 24, 32
    rng = np.random.default_rng(0)
    pts, mask = grid(h, w)
    assert np.array_equal(pts, rng.uniform(-1, 1, (h, w, 3)).astype(np.float32))
    assert np.array_equal(mask, rng.random((h, w)) > 0.1)
    rng = np.random.default_rng(0)
    narrow = (2000 + rng.integers(0, 500, (h, w))).astype(np.uint16)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    wide = (2000 + 2 * xs + ys + rng.integers(0, 8, (h, w))).astype(np.uint16)
    wide[rng.random((h, w)) < 0.05] = 0
    got = depths(h, w)
    assert np.array_equal(got["narrow"], narrow) and np.array_equal(got["wide"], wide)
    filt = BilateralFilter()
    assert grid_depth(wide, filt) == int((int(wide.max()) - int(wide.min())) / filt.sigma_color) + 1 + 4


def test_scaling_series_is_bench_scaling_worker():
    """``benches/bench_scaling.py:69-78`` at 3 pairs, 24x32."""
    from align3d_torch.benches.bench_scaling import camera, series

    h, w, pairs = 24, 32, 3
    rng = np.random.default_rng(7)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    tex = rng.uniform(30, 220, size=(h, w + pairs + 1, 3)).astype(np.uint8)
    colors = np.stack([tex[:, i : i + w] for i in range(pairs + 1)])
    depths = np.stack([(2000 + 4 * (xs + i) + 2 * ys + rng.integers(0, 8, size=(h, w))).astype(np.uint16)
                       for i in range(pairs + 1)])
    got_colors, got_depths = series(pairs, h, w)
    assert np.array_equal(got_colors, colors) and np.array_equal(got_depths, depths)
    assert (camera(h, w).fx, camera(h, w).cx) == (260.0, w / 2 - 0.5)


def test_global_refine_problems_are_bench_global_refine():
    """``benches/bench_global_refine.py:30-100``'s lines run with the JAX
    package at 30 poses, 40 landmarks, 100 observations."""
    import jax.numpy as jnp

    from align3d_tpu.parallel import pose_graph as jpg
    from align3d_tpu.se3 import Transform as JT
    from align3d_tpu.se3 import stack as jstack
    from align3d_tpu.trajectory import Trajectory as JTraj
    from align3d_torch.benches.bench_global_refine import INTRINSICS, problems

    n, m, o = 30, 40, 100
    rng = np.random.default_rng(11)
    gt = [JT.identity()]
    for _ in range(n - 1):
        gt.append(gt[-1] @ JT.exp(jnp.asarray([0.1, 0, 0, 0, 0, 2 * np.pi / n], jnp.float32)))
    est = [gt[0]]
    for k in range(n - 1):
        rel = gt[k].inverse() @ gt[k + 1]
        est.append(est[-1] @ (rel @ JT.exp(jnp.asarray(rng.normal(0, 0.01, 6), jnp.float32))))
    graph = jpg.PoseGraph.from_trajectory(JTraj(jstack(est), jnp.arange(n, dtype=jnp.float32)))
    for j in (n // 2, n - 1):
        graph = graph.with_edge(0, j, gt[0].inverse() @ gt[j], 10.0)
    landmarks_gt = np.asarray(jnp.asarray(rng.uniform([-4, -4, 2.0], [4, 4, 8.0], (m, 3)), jnp.float32))
    obs_pose = rng.integers(0, n, o)
    obs_landmark = rng.integers(0, m, o)
    noise = np.asarray(jnp.asarray(rng.normal(0, 0.05, (m, 3)), jnp.float32))

    got = problems(n, m, o)
    np.testing.assert_allclose(got.graph.nodes.rotation.numpy(), np.asarray(graph.nodes.rotation), atol=POSE_ATOL)
    np.testing.assert_allclose(got.graph.nodes.translation.numpy(), np.asarray(graph.nodes.translation),
                               atol=POSE_ATOL)
    assert np.array_equal(got.graph.edges.numpy(), np.asarray(graph.edges))
    assert np.array_equal(got.graph.weights.numpy(), np.asarray(graph.weights))
    np.testing.assert_allclose(got.graph.measurements.translation.numpy(),
                               np.asarray(graph.measurements.translation), atol=POSE_ATOL)
    p = got.problem
    assert np.array_equal(p.obs_pose.numpy(), obs_pose) and np.array_equal(p.obs_landmark.numpy(), obs_landmark)
    assert np.array_equal(p.landmarks.numpy(), (landmarks_gt + noise).astype(np.float32))
    assert p.intrinsics == INTRINSICS and torch.equal(p.weights, torch.ones(o))
    # (u, v, z) exact: the landmarks seen from the true poses.
    poses_gt = jstack(gt)
    np.testing.assert_allclose(p.poses.translation.numpy(), np.asarray(poses_gt.translation), atol=POSE_ATOL)
    t_cw = JT(jnp.take(poses_gt.rotation, obs_pose, axis=0), jnp.take(poses_gt.translation, obs_pose, axis=0))
    p_cam = np.asarray(t_cw.inverse().apply(jnp.take(jnp.asarray(landmarks_gt), obs_landmark, axis=0)))
    z = p_cam[:, 2]
    uv = np.stack([p_cam[:, 0] * INTRINSICS.fx / z + INTRINSICS.cx, p_cam[:, 1] * INTRINSICS.fy / z + INTRINSICS.cy],
                  axis=1)
    np.testing.assert_allclose(p.obs_z.numpy(), z, atol=POSE_ATOL)
    np.testing.assert_allclose(p.obs_uv.numpy(), uv, atol=UV_ATOL)


# -- each bench at a tiny size on the CPU ------------------------------------------

#: Tiny sizes, and the port call each bench times, made directly.
TINY = {
    "bench_image_icp": ["--batch", "2", "--iters", "2", "--synthetic-batch", "1"],
    "bench_icp_kernel": ["--batch", "1", "--iters", "2"],
    "bench_odometry": ["--frames", "3", "--synthetic-frames", "2", "--stride", "8"],
    "bench_pcl_icp": ["--points", "2000", "--iters", "3"],
    "bench_voxel_nn": ["--points", "3000"],
    "bench_mesh": ["--side", "8"],
    "bench_normals": ["--height", "24", "--width", "32"],
    "bench_bilateral": ["--height", "48", "--width", "64"],
    "bench_global_refine": ["--poses", "20", "--landmarks", "60", "--observations", "240", "--pg-cg-iters", "8",
                            "--ba-cg-iters", "4"],
    "bench_scaling": ["--per-device", "1", "--height", "48", "--width", "64"],
}


def _direct(name, mod):
    from align3d_torch.icp.params import IcpParams, MsIcpParams
    from align3d_torch.parallel import batch as pb
    from align3d_torch.tools import series

    if name == "bench_image_icp":  # bench.py's engine, and the exact one beside it
        s, t = series.real_pairs(2, "cpu")
        return {engine: mod.align(mod.packed_pairs(s, t, engine), s.intrinsics,
                                  IcpParams(max_iterations=2, engine=engine)) for engine in ("pallas_v4", "xla")}
    if name == "bench_icp_kernel":  # K7 at radius 2, and the exact engine beside it
        from align3d_torch.benches.bench_image_icp import align

        s, t = mod.synthetic_pairs(1, "cpu")
        params = IcpParams(max_iterations=2, engine="pallas", band_radius=2)
        exact = params.replace(engine="xla")
        return {"kernel_only": mod.kernel_steps(mod.packed_pairs(s, t, "pallas"), s.intrinsics, params),
                "full_align": mod.full_align(s, t, params),
                "xla_kernel_only": mod.exact_kernel_steps(mod.packed_pairs(s, t, "xla"), s.intrinsics, exact),
                "xla_full_align": align(mod.packed_pairs(s, t, "xla"), s.intrinsics, exact)}
    if name == "bench_odometry":
        from align3d_torch.ops.bilateral import BilateralFilter

        out = {}
        for key, s in (("real", series.real_frames(3)), ("mixed", series.mixed_frames(3)),
                       ("synthetic", mod.synthetic_series(2))):
            frames = (mod.from_series(s) if key != "synthetic" else s).cut(8)
            colors, depths, scales = frames.on("cpu")
            for label, f in (("off", None), ("on", BilateralFilter())):
                out[(key, label)] = pb.odometry_step(frames.camera, scales, colors, depths,
                                                     MsIcpParams.default_tpu("pallas_v4"), bilateral_filter=f,
                                                     device="cpu").camera_to_world
            if key == "real":  # the exact engine beside the JAX bench's default
                out[(key, "off", "xla")] = pb.odometry_step(frames.camera, scales, colors, depths,
                                                            MsIcpParams.default(), device="cpu").camera_to_world
        return out
    if name == "bench_pcl_icp":
        from align3d_torch.icp.pcl_icp import Icp

        target, source, _ = mod.clouds(2000, "cpu")
        return Icp(IcpParams(max_iterations=3), target.points, target.normals).align(source.points, source.normals)
    if name == "bench_voxel_nn":
        from align3d_torch.ops.nn_banded import SortedGrid, nearest_banded

        db, q = (torch.from_numpy(a) for a in mod.clouds(3000))
        grid = SortedGrid.build(db, mod.CELL)
        return {b: nearest_banded(grid, q, band_width=b) for b in (256, 512)}
    if name == "bench_mesh":
        from align3d_torch.ops.mesh import MeshNormals
        from align3d_torch.tools.ablate import grid_mesh

        pts, faces = grid_mesh(8)
        return MeshNormals(faces, pts.shape[0], device="cpu")(torch.from_numpy(pts))
    if name == "bench_normals":
        from align3d_torch.ops.normals import compute_normals

        return compute_normals(*(torch.from_numpy(a) for a in mod.grid(24, 32)))
    if name == "bench_bilateral":
        from align3d_torch.ops.bilateral import BilateralFilter

        filt = BilateralFilter()
        return {k: filt.filter_static(torch.from_numpy(d.astype(np.int32)), torch.tensor(int(d.min()), dtype=torch.int32),
                                      mod.grid_depth(d, filt))
                for k, d in mod.depths(48, 64).items()}
    if name == "bench_global_refine":
        from align3d_torch.parallel import bundle_adjustment as ba
        from align3d_torch.parallel import pose_graph as pg

        probs = mod.problems(20, 60, 240)
        return {"pose_graph": pg.optimize(probs.graph, iterations=4, solver="cg", cg_iters=8),
                "bundle_adjustment": ba.optimize(probs.problem, iterations=3, solver="coo", cg_iters=4)}
    if name == "bench_scaling":  # the ranks run at one thread too
        colors, depths = mod.series(1, 48, 64)
        pose = pb.odometry_step(mod.camera(48, 64), mod.DEPTH_SCALE, colors, depths, MsIcpParams.default(),
                                device="cpu").camera_to_world
        return (pose.rotation, pose.translation)
    raise KeyError(name)


@pytest.mark.parametrize("name", BENCHES)
def test_bench_prints_one_line_and_times_the_port_call(name):
    mod = _bench(name)
    outcome, lines = _run(mod, ["--device", "cpu", "--quick", *TINY[name]])
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == outcome.line and KEYS <= line.keys()
    assert line["metric"] == _metric(mod) and line["device"] == "cpu" and line["card"] is None
    assert line["device_busy_ms"] is None and line["profiler_launches"] is None
    assert isinstance(line["value"], float) and np.isfinite(line["value"]) and line["value"] > 0
    assert len(line["runs"]) == harness.QUICK_RUNS
    assert _same(outcome.result, _direct(name, mod))


@pytest.mark.parametrize("name", BENCHES)
def test_bench_without_cuda_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _bench(name).run(["--quick"])


@pytest.mark.parametrize("name", ["bench_image_icp", "bench_odometry"])
def test_bench_without_fixtures_raises(name, monkeypatch):
    from align3d_torch import config

    monkeypatch.setattr(config, "has_ref_data", lambda: False)
    with pytest.raises(RuntimeError, match="fixtures are missing"):
        _bench(name).run(["--device", "cpu", "--quick"])


def test_icp_kernel_bench_radius_reaches_the_kernel(monkeypatch):
    """``--radius 1``: every banded step the bench makes (kernel only and
    full align) runs at band radius 1, and the line is named for it, as
    the JAX bench names its line."""
    from align3d_torch.ops import icp_pallas_v3 as k3

    radii, plain = [], k3.icp_step_plain

    def spy(*args, **kwargs):
        radii.append(k3.step_constants(args[10])["radius"])
        return plain(*args, **kwargs)

    monkeypatch.setattr(k3, "icp_step_plain", spy)
    monkeypatch.setattr(harness, "QUICK_RUNS", 1)  # one repeat, no warm-up: the radius is the point here
    monkeypatch.setattr(harness, "QUICK_WARMUP", 0)
    mod = _bench("bench_icp_kernel")
    outcome, lines = _run(mod, ["--device", "cpu", "--quick", "--radius", "1", *TINY["bench_icp_kernel"]])
    line = json.loads(lines[0])
    assert line["metric"] == "kernel_only_v3_r1_us_per_pair_iter" and line["radius"] == 1
    assert "full_align_v3_r1_us_per_pair_iter" in line
    assert radii and set(radii) == {1}


def test_benches_import_no_jax():
    code = ("import sys, importlib\n"
            "from align3d_torch.benches import BENCHES, _harness\n"
            "for name in BENCHES: importlib.import_module('align3d_torch.benches.' + name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'align3d_tpu', 'benches')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_torch_cpu.env(), check=True, timeout=120)
