"""The port's bundle adjustment (``align3d_torch/parallel/bundle_adjustment.py``)
against ``align3d_tpu.parallel.bundle_adjustment`` on the synthetic RGB-D
scenes of ``tests/test_bundle_adjustment.py``: the same numpy state fed to
both packages. The port solves the dense Schur system in float64, JAX in
float32."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_bundle_adjustment import INTR, _synthetic_problem

from align3d_tpu.parallel import bundle_adjustment as jba

from align3d_torch.convert import ba_problem_from_numpy, transform_from_numpy
from align3d_torch.parallel import bundle_adjustment as ba


def to_port_problem(p) -> ba.BAProblem:
    return ba_problem_from_numpy(
        np.asarray(p.poses.rotation), np.asarray(p.poses.translation), np.asarray(p.landmarks),
        np.asarray(p.obs_pose), np.asarray(p.obs_landmark), np.asarray(p.obs_uv), np.asarray(p.weights),
        dataclasses.asdict(p.intrinsics), obs_z=None if p.obs_z is None else np.asarray(p.obs_z),
        depth_weight=p.depth_weight, device="cpu",
    )


def refined(problem: ba.BAProblem, poses, landmarks) -> ba.BAProblem:
    return dataclasses.replace(problem, poses=poses, landmarks=landmarks)


def max_rel(got: torch.Tensor, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())


def _partials_args(problem, with_depth: bool):
    z = problem.obs_z[:, None] if with_depth else jnp.zeros_like(problem.obs_uv[:, :1])
    obs_uvz = jnp.concatenate([problem.obs_uv, z], axis=1)
    return (problem.poses, problem.landmarks, problem.obs_pose, problem.obs_landmark, obs_uvz, problem.weights,
            INTR, problem.n_poses, problem.n_landmarks)


def _port_partials_args(port, with_depth: bool):
    z = port.obs_z[:, None] if with_depth else torch.zeros_like(port.obs_uv[:, :1])
    return (port.poses, port.landmarks, port.obs_pose, port.obs_landmark, torch.cat([port.obs_uv, z], dim=1),
            port.weights, port.intrinsics, port.n_poses, port.n_landmarks)


@pytest.fixture(scope="module")
def scene():
    """``tests/test_bundle_adjustment.py::test_recovers_synthetic_scene``'s
    problem (6 poses x 40 landmarks) and JAX's dense solution, 8 iterations."""
    problem, poses_gt, landmarks_gt = _synthetic_problem()
    return problem, poses_gt, landmarks_gt, jba.optimize(problem, iterations=8)


@pytest.mark.parametrize("with_depth", [True, False], ids=["depth", "no_depth"])
def test_partials_match_jax(scene, with_depth):
    problem = scene[0]
    ref = jba._partials(*_partials_args(problem, with_depth), with_depth=with_depth)
    got = ba._partials(*_port_partials_args(to_port_problem(problem), with_depth), with_depth=with_depth)
    # Each piece within 1e-6 x its max |entry| (Jacobian entries reach
    # fx / z ~ 260 px a metre, where float32 resolves 3e-5). Measured, depth /
    # no depth: hpp 1.6e-7 / 8.2e-8, hll 7.3e-8 / 1.5e-7, w_obs 2.4e-7 /
    # 2.4e-7, gp 1.5e-7 / 1.4e-7, gl 5.1e-7 / 4.9e-7, sq 7.4e-8 / 8.2e-8.
    for name, a, b in zip(("hpp", "hll", "w_obs", "gp", "gl", "sq"), got[:6], ref[:6]):
        assert a.dtype == torch.float32, name
        assert max_rel(a, b) <= 1e-6, name
    assert int(got[6]) == int(ref[6]) == problem.obs_pose.shape[0]


def test_dense_optimize_matches_jax_and_recovers(scene):
    problem, poses_gt, landmarks_gt, (ref_poses, ref_lm) = scene
    port = to_port_problem(problem)
    poses, landmarks = ba.optimize(port, iterations=8)
    # Measured: rotation 6.0e-8, translation 3.8e-7, landmarks 2.4e-7.
    np.testing.assert_allclose(poses.rotation.numpy(), np.asarray(ref_poses.rotation), atol=1e-4, rtol=0)
    np.testing.assert_allclose(poses.translation.numpy(), np.asarray(ref_poses.translation), atol=1e-4, rtol=0)
    np.testing.assert_allclose(landmarks.numpy(), np.asarray(ref_lm), atol=1e-4, rtol=0)
    # tests/test_bundle_adjustment.py:81-98 on the port.
    assert float(ba.mean_reprojection_error(port)) > 1.0
    assert float(ba.mean_reprojection_error(refined(port, poses, landmarks))) < 1e-2
    d0 = (port.poses[0].inverse() @ poses[0]).log()
    assert float(d0.abs().max()) <= 1e-6
    gt = transform_from_numpy(np.asarray(poses_gt.rotation), np.asarray(poses_gt.translation), device="cpu")
    assert float(torch.linalg.norm((gt.inverse() @ poses).log(), dim=-1).max()) < 1e-3
    assert float(torch.linalg.norm(landmarks - torch.from_numpy(np.array(landmarks_gt)), dim=-1).max()) < 1e-3


def test_noisy_observations_converge():
    """``tests/test_bundle_adjustment.py::test_noisy_observations_converge`` on the port."""
    problem, poses_gt, _ = _synthetic_problem(seed=2, px_noise=0.5)
    port = to_port_problem(problem)
    poses, landmarks = ba.optimize(port, iterations=8)
    assert float(ba.mean_reprojection_error(refined(port, poses, landmarks))) < 1.0
    gt = transform_from_numpy(np.asarray(poses_gt.rotation), np.asarray(poses_gt.translation), device="cpu")
    assert float(torch.linalg.norm((gt.inverse() @ poses).log(), dim=-1).max()) < 5e-3


def _schur_inputs():
    """``tests/test_bundle_adjustment.py::test_schur_matches_dense_solve``'s
    problem (3 poses x 8 landmarks) and JAX's normal-equation pieces."""
    problem, _, _ = _synthetic_problem(n_poses=3, n_landmarks=8, seed=3)
    hpp, hll, w_obs, gp, gl, _, _ = jba._partials(*_partials_args(problem, True), with_depth=True,
                                                  depth_weight=problem.depth_weight)
    return problem, hpp, hll, w_obs, gp, gl


def test_schur_matches_full_dense_solve():
    """The port's Schur-reduced update equals the full joint (6N + 3M)
    dense solve of the same gauge-fixed damped system (as
    ``tests/test_bundle_adjustment.py:101-144``, on the port's pieces)."""
    problem, *_ = _schur_inputs()
    port = to_port_problem(problem)
    n, m = port.n_poses, port.n_landmarks
    hpp, hll, w_obs, gp, gl, _, _ = ba._partials(*_port_partials_args(port, True), with_depth=True)
    w_blk = ba._densify_w(w_obs, port.obs_pose, port.obs_landmark, n, m)
    damping = 1e-4
    dp, dl = ba._schur_solve(hpp, hll, w_blk, gp, gl, damping)

    size = n * 6 + m * 3
    h = np.zeros((size, size), np.float64)
    g = np.zeros(size, np.float64)
    for i in range(n):
        h[i * 6:i * 6 + 6, i * 6:i * 6 + 6] = hpp[i].numpy()
        g[i * 6:i * 6 + 6] = gp[i].numpy()
    for j in range(m):
        o = n * 6 + j * 3
        h[o:o + 3, o:o + 3] = hll[j].numpy()
        g[o:o + 3] = gl[j].numpy()
    wb = w_blk.numpy()
    for i in range(n):
        for j in range(m):
            h[i * 6:i * 6 + 6, n * 6 + j * 3:n * 6 + j * 3 + 3] = wb[i, j]
            h[n * 6 + j * 3:n * 6 + j * 3 + 3, i * 6:i * 6 + 6] = wb[i, j].T
    h[0:6, :] = 0.0
    h[:, 0:6] = 0.0
    h[0:6, 0:6] = np.eye(6)
    g[0:6] = 0.0
    h += damping * np.eye(size)
    delta = -np.linalg.solve(h, g)
    np.testing.assert_allclose(dp.numpy().ravel(), delta[:n * 6], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(dl.numpy().ravel(), delta[n * 6:], rtol=2e-3, atol=2e-4)


def test_schur_solve_matches_jax():
    """Both packages' dense Schur solves on JAX's pieces. The diagonal
    blocks go in as ``s[ar, :, ar, :] += hpp`` (JAX:
    ``s.at[arange(n), :, arange(n), :].add(hpp)``): two advanced indices
    split by a slice put their axis first in both."""
    problem, hpp, hll, w_obs, gp, gl = _schur_inputs()
    n, m = hpp.shape[0], hll.shape[0]
    w_ref = jba._densify_w(w_obs, problem.obs_pose, problem.obs_landmark, n, m)
    dp_ref, dl_ref = jba._schur_solve(hpp, hll, w_ref, gp, gl, 1e-4)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    dp, dl = ba._schur_solve(t(hpp), t(hll), t(w_ref), t(gp), t(gl), 1e-4)
    # Measured: 1.1e-5 / 1.2e-6 x max|dp| / max|dl|: JAX's float32 solve
    # against the port's float64 one.
    assert max_rel(dp, dp_ref) <= 1e-3 and max_rel(dl, dl_ref) <= 1e-3


def test_densify_w_adds_repeated_pairs_as_jax():
    rng = np.random.default_rng(7)
    n, m, o = 4, 5, 60  # 60 observations over 20 (pose, landmark) pairs: every pair repeats
    op, ol = rng.integers(0, n, o).astype(np.int32), rng.integers(0, m, o).astype(np.int32)
    w_obs = rng.normal(0.0, 1.0, (o, 6, 3)).astype(np.float32)
    ref = np.asarray(jba._densify_w(jnp.asarray(w_obs), jnp.asarray(op), jnp.asarray(ol), n, m))
    got = ba._densify_w(torch.from_numpy(w_obs), torch.from_numpy(op).long(), torch.from_numpy(ol).long(), n, m)
    # Measured: bitwise (both add each pair's blocks in observation order).
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy().sum(), w_obs.sum(dtype=np.float64), rtol=1e-5)


def test_coo_matches_dense_and_jax():
    """``tests/test_bundle_adjustment.py::test_coo_matches_dense_solver`` on
    the port (5e-4), and the port's COO against JAX's COO."""
    problem, _, _ = _synthetic_problem(seed=4)
    port = to_port_problem(problem)
    pd, ld = ba.optimize(port, iterations=4, solver="dense")
    pc, lc = ba.optimize(port, iterations=4, solver="coo", cg_iters=128)
    np.testing.assert_allclose(pc.translation.numpy(), pd.translation.numpy(), atol=5e-4, rtol=0)
    np.testing.assert_allclose(lc.numpy(), ld.numpy(), atol=5e-4, rtol=0)
    ref_p, ref_l = jba.optimize(problem, iterations=4, solver="coo", cg_iters=128)
    # Measured: translation 2.2e-7, landmarks 2.4e-7 against JAX's COO (2.9e-7 / 2.4e-7
    # against the port's dense solve).
    np.testing.assert_allclose(pc.translation.numpy(), np.asarray(ref_p.translation), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lc.numpy(), np.asarray(ref_l), atol=1e-5, rtol=0)


@pytest.mark.parametrize("with_depth", [True, False], ids=["depth", "no_depth"])
def test_mean_reprojection_error_matches_jax(scene, with_depth):
    problem = scene[0] if with_depth else dataclasses.replace(scene[0], obs_z=None)
    ref = float(jba.mean_reprojection_error(problem))
    got = ba.mean_reprojection_error(to_port_problem(problem))
    assert got.dtype == torch.float32
    # Measured: 0 (the same float32 value).
    assert abs(float(got) - ref) <= 1e-5 * ref
