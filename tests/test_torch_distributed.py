"""The port's sharded paths (``align3d_torch/parallel``: ``odometry_step(mesh=)``,
``odometry_sequence_parallel``, the pose graph's and bundle adjustment's
``mesh=``) on gloo groups of 2 and 4 CPU processes, against the port
unsharded and against the JAX package's sharded functions on as many of
its virtual CPU devices (``tests/conftest.py``), on the JAX tests' own
cases: ``tests/test_parallel.py``'s synthetic sequence,
``tests/test_pose_graph.py``'s 9-pose ring and
``tests/test_bundle_adjustment.py``'s scenes.

Tolerances:

* odometry, sharded against the port unsharded: bitwise (each pair is the
  same computation; only which rank runs it changes); against JAX's
  sharded step, 0.01 rad / 0.02 m, the bound the port already meets
  against JAX's jitted step (``tests/test_torch_batch.py``);
* pose graph and bundle adjustment: 1e-4, the JAX tests' own gate for
  sharded against single (``tests/test_pose_graph.py:86-103, 183-196``,
  ``tests/test_bundle_adjustment.py:147-155, 181-190``), against both the
  port unsharded and JAX sharded;
* every rank returns the same result, bitwise.
"""

import dataclasses
import json
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)
from _torch_dist_cases import (
    FILTER,
    SEQUENCE_SPANS,
    bilateral,
    camera,
    poses,
    sharded_paths,
    small_params,
    spawn,
    synthetic_sequence,
)
from jax.sharding import Mesh
from test_bundle_adjustment import _synthetic_problem
from test_parallel import _synthetic_sequence
from test_pose_graph import _noisy_ring

from align3d_tpu.icp.params import IcpParams as JaxIcpParams
from align3d_tpu.icp.params import MsIcpParams as JaxMsIcpParams
from align3d_tpu.parallel import batch as jbatch
from align3d_tpu.parallel import bundle_adjustment as jba
from align3d_tpu.parallel import pose_graph as jpg
from align3d_tpu.parallel.sequence import odometry_sequence_parallel as jax_sequence_parallel

from benchmark import check
from benchmark.reference import FULL, pipeline

from align3d_torch.parallel import batch as tbatch
from align3d_torch.parallel import bundle_adjustment as ba
from align3d_torch.parallel import pose_graph as pg
from align3d_torch.parallel.sequence import odometry_sequence_parallel
from align3d_torch.se3 import Transform

import _torch_dist_cases as cases

WORLDS = [2, 4]
ROOT = Path(__file__).resolve().parent.parent
ODOMETRY_ANGLE, ODOMETRY_TRANS = 0.01, 0.02  # rad, m: the port against JAX's jitted odometry_step
SOLVE_ATOL = 1e-4  # the JAX tests' sharded-vs-single gate


def jax_poses(t) -> np.ndarray:
    return np.concatenate([np.asarray(t.rotation), np.asarray(t.translation)[..., None]], axis=-1)


def pose_gap(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    """Largest angle (rad) and translation of a^-1 b over (N, 3, 4) poses."""
    ta = Transform(torch.from_numpy(a[..., :3]), torch.from_numpy(a[..., 3]))
    tb = Transform(torch.from_numpy(b[..., :3]), torch.from_numpy(b[..., 3]))
    d = ta.inverse() @ tb
    return float(d.angle().max()), float(torch.linalg.norm(d.translation, dim=-1).max())


def graph_arrays(prefix: str, g) -> dict:
    return {f"{prefix}_rot": np.asarray(g.nodes.rotation), f"{prefix}_trans": np.asarray(g.nodes.translation),
            f"{prefix}_edges": np.asarray(g.edges), f"{prefix}_mrot": np.asarray(g.measurements.rotation),
            f"{prefix}_mtrans": np.asarray(g.measurements.translation), f"{prefix}_w": np.asarray(g.weights)}


def problem_arrays(prefix: str, p) -> dict:
    intr = dataclasses.asdict(p.intrinsics)
    return {f"{prefix}_rot": np.asarray(p.poses.rotation), f"{prefix}_trans": np.asarray(p.poses.translation),
            f"{prefix}_landmarks": np.asarray(p.landmarks), f"{prefix}_obs_pose": np.asarray(p.obs_pose),
            f"{prefix}_obs_landmark": np.asarray(p.obs_landmark), f"{prefix}_obs_uv": np.asarray(p.obs_uv),
            f"{prefix}_weights": np.asarray(p.weights), f"{prefix}_obs_z": np.asarray(p.obs_z),
            f"{prefix}_intr": np.asarray([intr[k] for k in ("fx", "fy", "cx", "cy", "width", "height")], np.float64)}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX tests' inputs (written for the ranks), and the JAX results."""
    jintr, jcolors, jdepths = _synthetic_sequence(8)
    cam, colors, depths = synthetic_sequence(8)
    assert np.array_equal(colors, jcolors) and np.array_equal(depths, jdepths)
    assert cam == (jintr.fx, jintr.fy, jintr.cx, jintr.cy, jintr.width, jintr.height)

    _, traj, gt_list, _ = _noisy_ring(n=9)
    z = gt_list[0].inverse() @ gt_list[8]
    ring = jpg.PoseGraph.from_trajectory(traj)
    cg = ring.with_edge(0, 8, z, 5.0)
    ba_dense, _, _ = _synthetic_problem(seed=1)
    ba_coo, _, _ = _synthetic_problem(seed=5)
    arrays = {"camera": np.asarray(cam, np.float64), "colors": colors, "depths": depths,
              "ring_z": np.concatenate([np.asarray(z.rotation), np.asarray(z.translation)[:, None]], axis=1),
              **graph_arrays("ring", ring), **graph_arrays("cg", cg),
              **problem_arrays("ba_dense", ba_dense), **problem_arrays("ba_coo", ba_coo)}
    path = tmp_path_factory.mktemp("dist_inputs") / "inputs.npz"
    np.savez(path, **arrays)
    return {"path": str(path), "jax": {"traj": traj, "z": z, "cg": cg, "ba_dense": ba_dense, "ba_coo": ba_coo,
                                       "intr": jintr, "colors": jnp.asarray(colors), "depths": jnp.asarray(depths)}}


@pytest.fixture(scope="module")
def unsharded(case):
    """The port without a mesh, in this process, at the ranks' thread count
    (``tests/_torch_cpu.py``)."""
    return _unsharded(case)


def _unsharded(case):
    npz = np.load(case["path"])
    intr, colors, depths = camera(npz["camera"]), npz["colors"], npz["depths"]
    out = {f"step{n}": poses(tbatch.odometry_step(intr, 0.001, colors[:n], depths[:n], small_params(), 2,
                                                  device="cpu").camera_to_world) for n in (8, 6)}
    out["u16_step"] = poses(tbatch.odometry_step(intr, 0.001, colors, depths, small_params(), 2, bilateral(),
                                                 device="cpu").camera_to_world)
    ring = cases.graph(npz, "ring")
    z = Transform(torch.from_numpy(npz["ring_z"][:, :3]), torch.from_numpy(npz["ring_z"][:, 3]))
    from align3d_torch.trajectory import Trajectory

    out["pg_dense"] = poses(pg.refine_trajectory(Trajectory(ring.nodes, torch.arange(9, dtype=torch.float32)),
                                                 loop_edges=[(0, 8, z, 5.0)], iterations=5).camera_to_world)
    out["pg_cg"] = poses(pg.optimize(cases.graph(npz, "cg"), iterations=4, solver="cg"))
    p, lm = ba.optimize(cases.problem(npz, "ba_dense"), iterations=4)
    out["ba_dense_poses"], out["ba_dense_landmarks"] = poses(p), lm.numpy()
    p, lm = ba.optimize(cases.problem(npz, "ba_coo"), iterations=3, solver="coo")
    out["ba_coo_poses"], out["ba_coo_landmarks"] = poses(p), lm.numpy()
    return out


def jax_sharded(case, w: int) -> dict:
    """JAX's sharded functions on ``w`` of its virtual CPU devices."""
    j = case["jax"]
    params = JaxMsIcpParams.repeat(2, JaxIcpParams(max_iterations=3))
    mesh = jbatch.make_mesh(n_devices=w)
    ref = {"step": jax_poses(jbatch.odometry_step(j["intr"], 0.001, j["colors"], j["depths"], params,
                                                  pyramid_levels=2, mesh=mesh).camera_to_world)}
    for n in (8, 6):
        ref[f"seq{n}"] = jax_poses(jax_sequence_parallel(j["intr"], 0.001, j["colors"][:n], j["depths"][:n], mesh,
                                                         params, pyramid_levels=2).camera_to_world)
    ref["pg_dense"] = jax_poses(jpg.refine_trajectory(j["traj"], loop_edges=[(0, 8, j["z"], 5.0)], iterations=5,
                                                      mesh=mesh).camera_to_world)
    ref["pg_cg"] = jax_poses(jpg.optimize(j["cg"], iterations=4, solver="cg", mesh=mesh))
    obs_mesh = Mesh(np.asarray(jax.devices()[:w]), (jba.OBS_AXIS,))
    p, lm = jba.optimize(j["ba_dense"], iterations=4, mesh=obs_mesh)
    ref["ba_dense_poses"], ref["ba_dense_landmarks"] = jax_poses(p), np.asarray(lm)
    p, lm = jba.optimize(j["ba_coo"], iterations=3, solver="coo", mesh=obs_mesh)
    ref["ba_coo_poses"], ref["ba_coo_landmarks"] = jax_poses(p), np.asarray(lm)
    return ref


@pytest.fixture(scope="module")
def worlds(case, tmp_path_factory):
    """Per world W: (each rank's results, JAX's sharded results on W
    devices). The groups of every world run at once, in their own
    processes, while this process runs JAX."""
    dirs = {w: tmp_path_factory.mktemp(f"dist_world{w}") for w in WORLDS}
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        runs = [pool.submit(spawn, sharded_paths, w, dirs[w], case["path"], str(dirs[w])) for w in WORLDS]
        refs = {w: jax_sharded(case, w) for w in WORLDS}
        for run in runs:
            run.result()
    return {w: ([dict(np.load(dirs[w] / f"rank{r}.npz")) for r in range(w)], refs[w]) for w in WORLDS}


@pytest.fixture(params=WORLDS, ids=[f"world{w}" for w in WORLDS])
def world(request, worlds):
    return (request.param, *worlds[request.param])


def test_every_rank_returns_the_same(world):
    _, ranks, _ = world
    for other in ranks[1:]:
        assert other.keys() == ranks[0].keys()
        for k in ranks[0]:
            assert np.array_equal(other[k], ranks[0][k]), k


@pytest.mark.parametrize("key,n", [("step", 8), ("seq8", 8), ("seq6", 6)])
def test_odometry_sharded(world, unsharded, key, n):
    """``odometry_step(mesh=)`` and ``odometry_sequence_parallel`` (N = 6 pads
    to 8 at world 4): bitwise the port unsharded, and within 0.01 rad / 0.02
    m of JAX's sharded function on as many devices."""
    _, ranks, ref = world
    got = ranks[0][key]
    assert got.shape == (n, 3, 4)
    np.testing.assert_array_equal(got, unsharded[f"step{n}"])
    angle, trans = pose_gap(ref[key], got)
    assert angle < ODOMETRY_ANGLE and trans < ODOMETRY_TRANS, (angle, trans)


@pytest.mark.parametrize("key", ["pg_dense", "pg_cg", "ba_dense_poses", "ba_dense_landmarks", "ba_coo_poses",
                                 "ba_coo_landmarks"])
def test_refinement_sharded(world, unsharded, key):
    """The pose graph (dense via ``refine_trajectory``, CG via ``optimize``)
    and bundle adjustment (dense and COO), observations or edges sharded:
    within 1e-4 of the port unsharded and of JAX sharded."""
    _, ranks, ref = world
    got = ranks[0][key]
    np.testing.assert_allclose(got, unsharded[key], atol=SOLVE_ATOL, rtol=0)
    np.testing.assert_allclose(got, ref[key], atol=SOLVE_ATOL, rtol=0)


@pytest.fixture
def one_rank_group():
    """An in-process group of one rank (global state): destroyed after."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def test_one_rank_mesh_in_process(case, unsharded, one_rank_group):
    """``make_mesh`` in a process with no group gives a one-rank gloo mesh;
    every sharded path on it matches the port unsharded."""
    npz = np.load(case["path"])
    mesh = tbatch.make_mesh(devices="cpu")
    assert mesh.size() == 1 and mesh.mesh_dim_names == (tbatch.BATCH_AXIS,)
    assert torch.distributed.get_backend(mesh.get_group()) == "gloo"
    with pytest.raises(ValueError):
        tbatch.make_mesh(2, devices="cpu")
    intr, colors, depths = camera(npz["camera"]), npz["colors"], npz["depths"]
    step = tbatch.odometry_step(intr, 0.001, colors, depths, small_params(), 2, mesh=mesh)
    np.testing.assert_array_equal(poses(step.camera_to_world), unsharded["step8"])
    seq = odometry_sequence_parallel(intr, 0.001, colors[:6], depths[:6], mesh, small_params(), 2)
    np.testing.assert_array_equal(poses(seq.camera_to_world), unsharded["step6"])
    cg = pg.optimize(cases.graph(npz, "cg"), iterations=4, solver="cg", mesh=mesh)
    np.testing.assert_allclose(poses(cg), unsharded["pg_cg"], atol=SOLVE_ATOL, rtol=0)
    p, lm = ba.optimize(cases.problem(npz, "ba_coo"), iterations=3, solver="coo", mesh=mesh)
    np.testing.assert_allclose(lm.numpy(), unsharded["ba_coo_landmarks"], atol=SOLVE_ATOL, rtol=0)
    with pytest.raises(ValueError):  # a CPU mesh runs on the CPU: no silent move to the card
        tbatch.odometry_step(intr, 0.001, colors, depths, small_params(), 2, mesh=mesh, device="cuda")


@pytest.fixture(scope="module")
def reference_rel(case):
    """The benchmark's plain reference (``benchmark/reference/``) of the 8
    frames' pairs, from the raw frames, at the ranks' parameters and the
    batch configurations' filter."""
    npz = np.load(case["path"])
    fixture = types.SimpleNamespace(colors=npz["colors"], depths=npz["depths"], depth_scale=0.001,
                                    camera=tuple(npz["camera"]))
    levels = [{"level": i, "engine": p.engine, "iterations": p.max_iterations, "weight": p.weight,
               "color_weight": p.color_weight, "max_distance": p.max_distance, "max_normal_angle": p.max_normal_angle,
               "max_color_distance": p.max_color_distance, "band_radius": p.band_radius}
              for i, p in enumerate(small_params())]
    config = {"bilateral_filter": dict(zip(("sigma_space", "sigma_color", "pad_depth_to"), FILTER)),
              "filter_span": "nonzero", "pyramid_levels": 2, "blur_sigma": 1.0, "levels": levels}
    return pipeline.outputs(config, {"synthetic": fixture}, [("synthetic", i) for i in range(8)], FULL, "cpu")["rel"]


def test_sequence_spans_and_collective_bytes(world):
    """The frame-sharded step records ``batch.step`` (a root, this rank's
    pairs), ``batch.upload``, ``dist.halo`` and ``dist.gather`` on every
    rank, and ``collectives.BYTES`` rises by what the halo and the pose
    gather move: W broadcasts of one frame (u8 colour and int32 depth) and
    W of a rank's F pose slots (3x3 + 3 float32, 48 B)."""
    w, ranks, _ = world
    f, (h, wd) = 8 // w, (48, 64)
    for rank in ranks:
        assert set(SEQUENCE_SPANS) <= set(rank["seq_spans"].tolist())
        assert bool(rank["seq_step_pairs_ok"])
        assert int(rank["seq_collectives"]) == 2 * w
        assert int(rank["seq_bytes"]) == w * h * wd * (3 + 4) + w * f * 48


def test_u16_host_local_step(world, unsharded, reference_rel):
    """Each rank's own block of u16 depth host arrays through
    ``host_local_batch`` and ``odometry_step(mesh=)``, filter on: bitwise
    the port unsharded, and each pair within the batch cells' pose limits
    (``benchmark/cells/``) of the benchmark's plain reference."""
    _, ranks, _ = world
    got = ranks[0]["u16_step"]
    assert str(ranks[0]["u16_dtype"]) == "torch.uint16"
    np.testing.assert_array_equal(got, unsharded["u16_step"])
    # rel_i = P_i P_(i-1)^-1, in float64.
    rot, trans = got[..., :3].astype(np.float64), got[..., 3].astype(np.float64)
    rel_rot = rot[1:] @ np.swapaxes(rot[:-1], -1, -2)
    rel_trans = trans[1:] - np.einsum("nij,nj->ni", rel_rot, trans[:-1])
    numbers = check.Numbers()
    numbers.pose((torch.from_numpy(rel_rot), torch.from_numpy(rel_trans)), reference_rel)
    limits = json.loads((ROOT / "benchmark" / "cells" / "batch64-v4-640x480.sample1-walk.json").read_text())["limits"]
    for name in ("pose_rot_rad", "pose_trans_m"):
        assert numbers.values[name] <= limits[name], (name, numbers.values[name])
