"""Core math of the PyTorch port against the JAX package: SE(3), camera,
Gauss-Newton. Inputs are made with numpy from a seed and handed to both."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_tpu.camera import CameraIntrinsics as JaxIntrinsics
from align3d_tpu.optim.gauss_newton import GNSystem as JaxGN
from align3d_tpu.optim.gauss_newton import huber_weight as jax_huber
from align3d_tpu.optim.gauss_newton import solve_spd
from align3d_tpu.se3 import Transform as JaxTransform

from align3d_torch.camera import CameraIntrinsics
from align3d_torch.optim.gauss_newton import GNSystem, huber_weight
from align3d_torch.se3 import Transform

# Twist rotation magnitudes across the exp's Taylor switch points:
# theta^2 < 1e-16 (quaternion Taylor), 1e-16 <= theta^2 < 1e-8 (left-Jacobian
# Taylor only), and the closed forms up to large angles.
ANGLES = [0.0, 3e-9, 5e-5, 1e-3, 0.3, 2.5]


def _twists(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for a in ANGLES:
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        out.append(np.concatenate([rng.normal(size=3) * 0.5, axis * a]))
    return np.asarray(out, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_se3_exp_log_against_jax():
    twists = _twists()
    jt = JaxTransform.exp(jnp.asarray(twists))
    tt = Transform.exp(_t(twists))
    # atol 1e-6 (measured max 0 on rotation, 1.5e-8 on translation).
    np.testing.assert_allclose(tt.rotation.numpy(), np.asarray(jt.rotation), atol=1e-6)
    np.testing.assert_allclose(tt.translation.numpy(), np.asarray(jt.translation), atol=1e-6)
    # log of the same transforms, fed identical matrices (measured 1.5e-8).
    same = Transform(_t(jt.rotation), _t(jt.translation))
    np.testing.assert_allclose(same.log().numpy(), np.asarray(jt.log()), atol=1e-6)


def test_se3_compose_inverse_apply_against_jax():
    rng = np.random.default_rng(1)
    a, b = _twists(2), _twists(3)
    ja, jb = JaxTransform.exp(jnp.asarray(a)), JaxTransform.exp(jnp.asarray(b))
    ta = Transform(_t(ja.rotation), _t(ja.translation))
    tb = Transform(_t(jb.rotation), _t(jb.translation))
    pts = rng.normal(size=(6, 3)).astype(np.float32)
    cloud = rng.normal(size=(50, 3)).astype(np.float32)
    # atol 1e-6: a few f32 roundings apart (measured max 1.2e-7).
    comp, jcomp = ta @ tb, ja @ jb
    np.testing.assert_allclose(comp.rotation.numpy(), np.asarray(jcomp.rotation), atol=1e-6)
    np.testing.assert_allclose(comp.translation.numpy(), np.asarray(jcomp.translation), atol=1e-6)
    inv, jinv = ta.inverse(), ja.inverse()
    np.testing.assert_allclose(inv.translation.numpy(), np.asarray(jinv.translation), atol=1e-6)
    np.testing.assert_allclose(ta.apply(_t(pts)).numpy(), np.asarray(ja.apply(jnp.asarray(pts))), atol=1e-6)
    single_j, single_t = ja[4], ta[4]
    np.testing.assert_allclose(
        single_t.apply(_t(cloud)).numpy(), np.asarray(single_j.apply(jnp.asarray(cloud))), atol=1e-6
    )
    np.testing.assert_allclose(ta.angle().numpy(), np.asarray(ja.angle()), atol=1e-6)
    m4 = np.asarray(ja.to_matrix4())
    np.testing.assert_array_equal(ta.to_matrix4().numpy(), m4)
    back, jback = Transform.from_matrix4(m4), JaxTransform.from_matrix4(m4)
    np.testing.assert_allclose(back.rotation.numpy(), np.asarray(jback.rotation), atol=1e-6)


@pytest.mark.parametrize("batch", [1, 5, 64])
def test_se3_compose_is_batch_invariant(batch):
    """A pose composed in a batch has the bits it has composed alone, and
    is the product to float32 rounding (atol 1e-6 against float64)."""
    rng = np.random.default_rng(batch)
    a = Transform.exp(torch.from_numpy(rng.normal(size=(batch, 6)).astype(np.float32)))
    b = Transform.exp(torch.from_numpy(rng.normal(size=(batch, 6)).astype(np.float32)))
    comp = a @ b
    for i in range(batch):
        one = a[i] @ b[i]
        assert torch.equal(one.rotation, comp.rotation[i]) and torch.equal(one.translation, comp.translation[i])
    ref_r = a.rotation.double() @ b.rotation.double()
    ref_t = (a.rotation.double() @ b.translation.double()[..., None])[..., 0] + a.translation.double()
    np.testing.assert_allclose(comp.rotation.numpy(), ref_r.numpy(), atol=1e-6)
    np.testing.assert_allclose(comp.translation.numpy(), ref_t.numpy(), atol=1e-6)


def test_camera_backproject_and_scale_against_jax():
    rng = np.random.default_rng(4)
    fields = dict(fx=544.4732666015625, fy=544.4732666015625, cx=320.0, cy=240.0, width=64, height=48)
    depth = rng.uniform(0.5, 4.0, size=(48, 64)).astype(np.float32)
    jcam, tcam = JaxIntrinsics(**fields), CameraIntrinsics(**fields)
    # Same f32 expressions: bitwise.
    np.testing.assert_array_equal(
        tcam.backproject_grid(_t(depth)).numpy(), np.asarray(jcam.backproject_grid(jnp.asarray(depth)))
    )
    assert dataclasses.asdict(tcam.scale(0.5)) == dataclasses.asdict(jcam.scale(0.5))


def _icp_like_system(seed=2):
    """The ill-conditioned ICP-like Hessian of tests/test_gauss_newton.py."""
    rng = np.random.default_rng(seed)
    scales = np.asarray([1.0, 1.0, 1.0, 500.0, 500.0, 700.0])
    jac = rng.normal(size=(5000, 6)) * scales
    return jac.T @ jac, jac.T @ rng.normal(size=5000)


def test_solve_against_numpy_f64_and_jax():
    h64, g64 = _icp_like_system()
    x64 = np.linalg.solve(h64, g64)
    sys = GNSystem(_t(h64.astype(np.float32)), _t(g64.astype(np.float32)), torch.tensor(0.0), torch.tensor(1.0))
    x = sys.solve().numpy()
    # rtol 1e-6 against numpy f64 on the f32-rounded system (measured 4.4e-8):
    # the port solves in f64, so only the final f32 cast is lost.
    h32, g32 = h64.astype(np.float32).astype(np.float64), g64.astype(np.float32).astype(np.float64)
    np.testing.assert_allclose(x, np.linalg.solve(h32, g32), rtol=1e-6)
    # rtol 1e-4 against the JAX f32 Jacobi + refinement solve (measured 9.4e-8),
    # and the same 1e-4 relative-error bar against the exact f64 system
    # (measured 8.9e-8).
    np.testing.assert_allclose(
        x, np.asarray(solve_spd(jnp.asarray(h64, jnp.float32), jnp.asarray(g64, jnp.float32))), rtol=1e-4
    )
    assert np.linalg.norm(x - x64) / np.linalg.norm(x64) < 1e-4


def test_gn_goldens():
    """The goldens of tests/test_gauss_newton.py (reference gaussnewton.rs:140-167)."""
    jac = torch.tile(torch.tensor([[1.0, 2.0, 3.0, 4.0, 5.0, 6.0]]), (3, 1))
    gn = GNSystem.from_residuals(jac, torch.tensor([1.0, 2.0, 3.0]), torch.ones(3))
    base = np.asarray([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    np.testing.assert_allclose(gn.hessian.numpy(), 3.0 * np.outer(base, base), rtol=1e-6)
    np.testing.assert_allclose(gn.gradient.numpy(), 6.0 * base, rtol=1e-6)
    assert float(gn.squared_residual_sum) == 14.0
    assert float(gn.count) == 3.0

    empty = GNSystem.from_residuals(torch.zeros(10, 6), torch.zeros(10), torch.zeros(10))
    np.testing.assert_array_equal(empty.solve().numpy(), np.zeros(6))


def test_gn_accumulate_and_merge_against_jax():
    rng = np.random.default_rng(1)
    jac = rng.normal(size=(200, 6)).astype(np.float32)
    res = rng.normal(size=200).astype(np.float32)
    wts = (rng.random(200) > 0.3).astype(np.float32) * rng.uniform(0.5, 1.0, 200).astype(np.float32)
    ja = JaxGN.from_residuals(jnp.asarray(jac), jnp.asarray(res), jnp.asarray(wts))
    jb = JaxGN.from_residuals(jnp.asarray(jac * 2), jnp.asarray(res * 3), jnp.asarray(wts))
    ta = GNSystem.from_residuals(_t(jac), _t(res), _t(wts))
    tb = GNSystem.from_residuals(_t(jac * 2), _t(res * 3), _t(wts))
    jm, tm = ja.add_weighted(jb, 1.0, 0.5), ta.add_weighted(tb, 1.0, 0.5)
    # rtol 1e-5: the same sums in another order (measured 9.7e-8).
    for name in ("hessian", "gradient", "squared_residual_sum", "count"):
        np.testing.assert_allclose(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tm.mean_squared_residual().numpy(), np.asarray(jm.mean_squared_residual()), rtol=1e-5
    )


@pytest.mark.parametrize("delta", [0.004, 0.5])
def test_huber_weight_against_jax(delta):
    res = np.random.default_rng(5).normal(scale=0.05, size=1000).astype(np.float32)
    res[:3] = 0.0
    # Same f32 expressions: bitwise.
    np.testing.assert_array_equal(huber_weight(_t(res), delta).numpy(), np.asarray(jax_huber(jnp.asarray(res), delta)))


def test_trajectory_metrics_against_jax():
    from align3d_tpu.metrics import TransformMetrics as JaxMetrics
    from align3d_tpu.metrics import ate_rmse as jax_ate
    from align3d_tpu.metrics import rpe as jax_rpe
    from align3d_tpu.trajectory import Trajectory as JaxTrajectory

    from align3d_torch.convert import transform_from_numpy
    from align3d_torch.metrics import TransformMetrics, ate_rmse, rpe
    from align3d_torch.trajectory import Trajectory

    rng = np.random.default_rng(6)
    twists = (rng.normal(size=(2, 8, 6)) * [0.05, 0.05, 0.05, 0.02, 0.02, 0.02]).astype(np.float32)
    jax_trajs, trajs = [], []
    for tw in twists:
        jt = JaxTransform.exp(jnp.asarray(tw))
        jax_trajs.append(JaxTrajectory(jt, jnp.arange(8, dtype=jnp.float32)))
        trajs.append(Trajectory(transform_from_numpy(np.asarray(jt.rotation), np.asarray(jt.translation), device="cpu"),
                                torch.arange(8, dtype=torch.float32)))
    jp, jg = jax_trajs[0].first_frame_at_origin(), jax_trajs[1]
    tp, tg = trajs[0].first_frame_at_origin(), trajs[1]
    # atol 1e-6 on the metrics (measured max 1.5e-8); TUM text equal to 2e-7
    # (measured equal, up to the sign of zero).
    m, jm = TransformMetrics.mean_trajectory_error(tp, tg), JaxMetrics.mean_trajectory_error(jp, jg)
    np.testing.assert_allclose([float(m.angle), float(m.translation)], [float(jm.angle), float(jm.translation)],
                               atol=1e-6)
    for ours, ref in ((ate_rmse(tp, tg), jax_ate(jp, jg)), (rpe(tp, tg, 2), jax_rpe(jp, jg, 2))):
        np.testing.assert_allclose([float(v) for v in ours], [float(v) for v in ref], atol=1e-6)
    rel, jrel = tg.get_relative_transform(5, 2), jg.get_relative_transform(5, 2)
    np.testing.assert_allclose(rel.translation.numpy(), np.asarray(jrel.translation), atol=1e-6)
    text = tp.to_tum()
    np.testing.assert_allclose(np.loadtxt(text.splitlines()), np.loadtxt(jp.to_tum().splitlines()), atol=2e-7)
    back = Trajectory.from_tum("# comment\n" + text)
    np.testing.assert_allclose(back.camera_to_world.rotation.numpy(), tp.camera_to_world.rotation.numpy(), atol=1e-6)
