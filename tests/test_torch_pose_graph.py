"""The port's pose graph (``align3d_torch/parallel/pose_graph.py``) against
``align3d_tpu.parallel.pose_graph`` on the JAX tests' own cases
(``tests/test_pose_graph.py``): the same numpy state fed to both packages.
The port solves the dense system in float64, JAX in float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pose_graph import _dense_propose, _noisy_ring

from align3d_tpu.parallel import pose_graph as jpg
from align3d_tpu.se3 import Transform as JaxTransform
from align3d_tpu.trajectory import Trajectory as JaxTrajectory

from align3d_torch.convert import pose_graph_from_numpy, transform_from_numpy
from align3d_torch.parallel import pose_graph as pg
from align3d_torch.se3 import Transform
from align3d_torch.trajectory import Trajectory


def to_port_transform(t) -> Transform:
    return transform_from_numpy(np.asarray(t.rotation), np.asarray(t.translation), device="cpu")


def to_port_traj(traj) -> Trajectory:
    return Trajectory(to_port_transform(traj.camera_to_world), torch.from_numpy(np.array(traj.times)))


def to_port_graph(graph) -> pg.PoseGraph:
    return pose_graph_from_numpy(
        np.asarray(graph.nodes.rotation), np.asarray(graph.nodes.translation), np.asarray(graph.edges),
        np.asarray(graph.measurements.rotation), np.asarray(graph.measurements.translation),
        np.asarray(graph.weights), device="cpu",
    )


def assert_poses_close(port: Transform, jax_t, atol: float):
    np.testing.assert_allclose(port.rotation.numpy(), np.asarray(jax_t.rotation), atol=atol, rtol=0)
    np.testing.assert_allclose(port.translation.numpy(), np.asarray(jax_t.translation), atol=atol, rtol=0)


def pose_err(a: Transform, b: Transform) -> float:
    """``tests/test_pose_graph.py::_pose_err`` on the port."""
    return float(torch.linalg.norm((a.inverse() @ b).log(), dim=-1).max())


@pytest.fixture(scope="module")
def drift_case():
    """The drift case of ``tests/test_pose_graph.py::test_pose_graph_reduces_drift``:
    a 12-pose ring, noisy odometry, one exact closure (0, 11) at weight 10."""
    gt, traj, gt_list, _ = _noisy_ring()
    n = len(gt_list)
    z = gt_list[0].inverse() @ gt_list[n - 1]
    ref = jpg.refine_trajectory(traj, loop_edges=[(0, n - 1, z, 10.0)], iterations=10)
    return gt, traj, z, ref


def _jacobian_graph(kind: str):
    gt, traj, gt_list, _ = _noisy_ring()
    graph = jpg.PoseGraph.from_trajectory(traj)
    if kind == "noisy":
        # Ground-truth nodes against the noisy odometry measurements, plus the closure.
        graph = jpg.PoseGraph(gt, graph.edges, graph.measurements, graph.weights)
        graph = graph.with_edge(0, 11, gt_list[0].inverse() @ gt_list[11] @ JaxTransform.exp(
            jnp.asarray([0.01, -0.02, 0.005, 0.02, 0.01, -0.03], jnp.float32)), 10.0)
    return graph  # "exact_chain": the measurements are the nodes' own relative poses


@pytest.mark.parametrize("kind", ["noisy", "exact_chain"])
def test_edge_jacobians_match_jax(kind):
    graph = _jacobian_graph(kind)
    ref = jpg._edge_jacobians(graph.nodes, graph.edges, graph.measurements)
    port = to_port_graph(graph)
    got = pg._edge_jacobians(port.nodes, port.edges, port.measurements)
    for name, a, b in zip(("res", "j_i", "j_j"), got, ref):
        # Measured: res 6.0e-8 / 6.0e-8, j_i 2.9e-7 / 6.0e-8, j_j 2.9e-7 /
        # 1.2e-7 (noisy / exact chain).
        assert a.dtype == torch.float32 and torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0, err_msg=name)


def test_dense_system_matches_jax():
    graph = _jacobian_graph("noisy")
    n, damping = 12, 1e-6
    h_ref, g_ref = jpg._edge_system(graph.nodes, graph.edges, graph.measurements, graph.weights, n)
    h_ref = np.asarray(h_ref.at[0:6, :].set(0.0).at[:, 0:6].set(0.0).at[0:6, 0:6].set(jnp.eye(6)))
    h_ref = h_ref + damping * np.eye(n * 6, dtype=np.float32)
    port = to_port_graph(graph)
    hdiag, hij, g = pg._block_system(port.nodes, port.edges, port.measurements, port.weights, n)
    h = pg._dense_system(pg._finalize_diag(hdiag, damping), hij, port.edges).numpy()
    h[:6, :6] += damping * np.eye(6, dtype=np.float32)  # JAX's gauge block is (1 + damping) I
    scale = np.abs(h_ref).max()
    # Measured: 1.7e-7 x max|H|, g 3.8e-7 x max|g|.
    assert np.abs(h - h_ref).max() <= 1e-6 * scale
    g_ref = np.asarray(g_ref.at[0:6].set(0.0))
    assert np.abs(g.reshape(-1).numpy() - g_ref).max() <= 1e-6 * np.abs(g_ref).max()


def test_dense_optimize_matches_jax(drift_case):
    gt, traj, z, ref = drift_case
    n = len(traj)
    got = pg.refine_trajectory(to_port_traj(traj), loop_edges=[(0, n - 1, to_port_transform(z), 10.0)],
                               iterations=10)
    # JAX's sharded-against-single tolerance (tests/test_pose_graph.py:94-102);
    # measured 1.2e-7.
    assert_poses_close(got.camera_to_world, ref.camera_to_world, 1e-4)
    assert torch.equal(got.times, to_port_traj(traj).times)
    # The JAX test's own properties, on the port.
    gt_p = to_port_transform(gt)
    assert pose_err(got.camera_to_world, gt_p) < pose_err(to_port_transform(traj.camera_to_world), gt_p)
    poses = got.camera_to_world
    gap = (poses[0].inverse() @ poses[n - 1]).inverse() @ to_port_transform(z)
    assert float(torch.linalg.norm(gap.log())) < 0.02


def test_cg_matches_jax_and_dense():
    """``tests/test_pose_graph.py::test_cg_matches_dense`` on the port, and
    the port's CG against JAX's CG."""
    _, traj, gt_list, _ = _noisy_ring(n=10)
    z = gt_list[0].inverse() @ gt_list[9]
    graph = jpg.PoseGraph.from_trajectory(traj).with_edge(0, 9, z, 5.0)
    ref_cg = jpg.optimize(graph, iterations=6, solver="cg", cg_iters=128)
    port = to_port_graph(graph)
    cg = pg.optimize(port, iterations=6, solver="cg", cg_iters=128)
    dense = pg.optimize(port, iterations=6, solver="dense")
    # JAX's CG-against-dense tolerance, 2e-4; measured 8.9e-8 against JAX's
    # CG and 2.2e-5 against the port's dense solve.
    assert_poses_close(cg, ref_cg, 2e-4)
    np.testing.assert_allclose(cg.rotation.numpy(), dense.rotation.numpy(), atol=2e-4, rtol=0)
    np.testing.assert_allclose(cg.translation.numpy(), dense.translation.numpy(), atol=2e-4, rtol=0)


def _propose_case(kind: str):
    """(JAX trajectory, propose kwargs) of the cases of tests/test_pose_graph.py:106-164."""
    if kind == "ring":
        return _noisy_ring(n=12)[1], {"min_separation": 6, "max_translation": 1.5}
    if kind.startswith("chunked"):
        rng = np.random.default_rng(3)
        t = rng.normal(0, 1.0, (400, 3)).astype(np.float32)
        t[37], t[38] = t[350], t[351]  # distance-0 ties across chunks
        k = int(kind.split("-")[1])
        kwargs = {"min_separation": 10, "max_translation": 0.6, "max_candidates": k, "row_chunk": 23}
    else:  # "walk-10k": a random walk that revisits its start
        rng = np.random.default_rng(5)
        t = np.cumsum(rng.normal(0, 0.05, (10_000, 3)), axis=0).astype(np.float32)
        t[-1] = t[0] + 1e-4
        kwargs = {"min_separation": 100, "max_translation": 0.05, "max_candidates": 16}
    n = t.shape[0]
    poses = JaxTransform(jnp.broadcast_to(jnp.eye(3), (n, 3, 3)), jnp.asarray(t))
    return JaxTrajectory(poses, jnp.arange(n, dtype=jnp.float32)), kwargs


@pytest.mark.parametrize("kind", ["ring", "chunked-8", "chunked-32", "walk-10k"])
def test_propose_loop_closures_bitwise(kind):
    traj, kwargs = _propose_case(kind)
    got = pg.propose_loop_closures(to_port_traj(traj), **kwargs)
    ref = jpg.propose_loop_closures(traj, **kwargs)
    assert got.dtype == ref.dtype == np.int64
    np.testing.assert_array_equal(got, ref)
    assert len(got) > 0
    if kind.startswith("chunked"):
        dense = {k: v for k, v in kwargs.items() if k != "row_chunk"}
        np.testing.assert_array_equal(got, _dense_propose(traj, **dense))
    if kind == "walk-10k":
        assert len(got) == 16 and tuple(got[0]) == (0, 9_999)


def test_with_edge_and_chain_match_jax():
    _, traj, gt_list, _ = _noisy_ring(n=9)
    z = gt_list[0].inverse() @ gt_list[8]
    ref = jpg.PoseGraph.from_trajectory(traj).with_edge(0, 8, z, 5.0)
    got = pg.PoseGraph.from_trajectory(to_port_traj(traj)).with_edge(0, 8, to_port_transform(z), 5.0)
    assert got.edges.dtype == torch.int64
    np.testing.assert_array_equal(got.edges.numpy(), np.asarray(ref.edges))
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(ref.weights))
    # Measured: 6.0e-8 (the relative poses are composed by each package's own product).
    assert_poses_close(got.measurements, ref.measurements, 1e-6)
