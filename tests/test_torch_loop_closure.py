"""The port's loop-closure refinement (``align3d_torch.odometry.
refine_with_loop_closures``) against ``align3d_tpu.odometry.
refine_with_loop_closures`` on a short sample1 palindrome; the JAX e2e test
(``tests/test_loop_closure_e2e.py``) on the port; the ``mesh=`` forms on a
one-rank mesh (``tests/test_torch_distributed.py`` holds them at 2 and 4
ranks); and the command line's ``--loop-closure``."""

import math
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_tpu.icp.params import MsIcpParams as JaxMsIcpParams
from align3d_tpu.io.datasets.core import SubsetDataset as JaxSubsetDataset
from align3d_tpu.odometry import refine_with_loop_closures as jax_refine
from align3d_tpu.odometry import run_odometry as jax_run_odometry

from align3d_torch import cli
from align3d_torch.convert import transform_from_numpy
from align3d_torch.icp.params import MsIcpParams
from align3d_torch.io.datasets import SlamTbDataset, SubsetDataset
from align3d_torch.metrics import TransformMetrics
from align3d_torch.odometry import OdometryResult, refine_with_loop_closures, run_odometry
from align3d_torch.parallel import bundle_adjustment as ba
from align3d_torch.parallel import pose_graph as pg
from align3d_torch.se3 import Transform
from align3d_torch.trajectory import Trajectory

ROOT = Path(__file__).resolve().parent.parent
SAMPLE1 = ROOT / "tests" / "data" / "rgbd" / "sample1"
PALINDROME = [0, 1, 2, 1, 0]  # frame 4 revisits frame 0: the one pair min_separation=3 admits
PALINDROME_18 = list(range(12)) + [10, 8, 6, 4, 2, 0]  # tests/test_loop_closure_e2e.py:30-32
KWARGS = {"min_separation": 3, "closure_weight": 20.0}


def cheap(params_cls):
    """2 GN iterations a level, for odometry and closures alike."""
    return params_cls.default().customize(lambda _, p: p.replace(max_iterations=2))


def _port_refine(indices, **kwargs):
    ds = SubsetDataset(SlamTbDataset.load(str(SAMPLE1)), indices)
    raw = run_odometry(ds, "cpu", icp_params=cheap(MsIcpParams))
    return raw, refine_with_loop_closures(ds, raw, "cpu", **kwargs)


@pytest.fixture(scope="module")
def jax_palindrome(sample1_dataset):
    """JAX's cheap odometry over the 5-frame palindrome and its refinement."""
    jds = JaxSubsetDataset(sample1_dataset, PALINDROME)
    raw = jax_run_odometry(jds, icp_params=cheap(JaxMsIcpParams))
    return raw, jax_refine(jds, raw, icp_params=cheap(JaxMsIcpParams), **KWARGS)


def to_port_traj(traj) -> Trajectory:
    poses = transform_from_numpy(np.asarray(traj.camera_to_world.rotation),
                                 np.asarray(traj.camera_to_world.translation), device="cpu")
    return Trajectory(poses, torch.from_numpy(np.array(traj.times)))


def max_pose_diff(a: Transform, b: Transform) -> tuple:
    diff = TransformMetrics.new(a, b)
    return float(diff.angle.max()), float(diff.translation.max())


def test_refine_matches_jax(jax_palindrome):
    jraw, ref = jax_palindrome
    raw, got = _port_refine(PALINDROME, icp_params=cheap(MsIcpParams), **KWARGS)
    assert pg.propose_loop_closures(raw.trajectory, min_separation=3).tolist() == [[0, 4]]
    angle, trans = max_pose_diff(to_port_traj(ref.trajectory).camera_to_world, got.trajectory.camera_to_world)
    # tests/test_torch_odometry.py's pose bound, 1e-3 rad / 1e-3 m; measured
    # 2.4e-4 rad / 4.1e-4 m, within the two packages' cheap odometry's own
    # gap (3.2e-4 rad / 5.6e-4 m: two GN iterations a level leave each pair
    # unconverged, where rounding moves the association).
    assert angle <= 1e-3 and trans <= 1e-3
    assert torch.equal(got.trajectory.times, raw.trajectory.times)
    assert got.seconds_per_frame == raw.seconds_per_frame
    assert abs(float(got.metrics.translation) - float(ref.metrics.translation)) <= 1e-3


def test_refine_of_the_same_odometry_matches_jax(jax_palindrome):
    """The refinement alone: the port refines JAX's own odometry trajectory."""
    jraw, ref = jax_palindrome
    ds = SubsetDataset(SlamTbDataset.load(str(SAMPLE1)), PALINDROME)
    same = OdometryResult(to_port_traj(jraw.trajectory), None, jraw.seconds_per_frame)
    got = refine_with_loop_closures(ds, same, "cpu", icp_params=cheap(MsIcpParams), **KWARGS)
    angle, trans = max_pose_diff(to_port_traj(ref.trajectory).camera_to_world, got.trajectory.camera_to_world)
    # Measured: 1.9e-7 rad / 1.0e-6 m.
    assert angle <= 1e-5 and trans <= 1e-5


@pytest.mark.slow
def test_refine_reduces_ate_on_the_18_frame_palindrome():
    """``tests/test_loop_closure_e2e.py`` on the port: cheap odometry, full
    ICP for the one closure (0, 17)."""
    last = len(PALINDROME_18) - 1
    raw, refined = _port_refine(PALINDROME_18, min_separation=last - 1, max_translation=0.5, max_candidates=4,
                                closure_weight=20.0)
    raw_t, ref_t = float(raw.metrics.translation), float(refined.metrics.translation)
    raw_a, ref_a = math.degrees(float(raw.metrics.angle)), math.degrees(float(refined.metrics.angle))
    assert ref_t < raw_t
    assert ref_a < raw_a * 1.1 + 1e-3
    poses = refined.trajectory.camera_to_world
    assert float(torch.linalg.norm((poses[0].inverse() @ poses[last]).log())) < 5e-3


def _tiny_graph():
    traj = Trajectory(Transform.exp(torch.tensor([[0.0] * 6, [0.1, 0, 0, 0, 0, 0.05]])), torch.arange(2.0))
    return pg.PoseGraph.from_trajectory(traj), traj


def _tiny_problem():
    """Two cameras at the origin, four landmarks seen by both, moved 1 cm."""
    from align3d_torch.camera import CameraIntrinsics

    lm = torch.tensor([[-0.5, -0.5, 2.0], [0.5, -0.5, 2.5], [-0.5, 0.5, 3.0], [0.5, 0.5, 2.0]])
    uv = lm[:, :2] * 525.0 / lm[:, 2:] + torch.tensor([319.5, 239.5])
    return ba.BAProblem(Transform.identity((2,)), lm + 0.01, torch.tensor([0] * 4 + [1] * 4), torch.arange(4).repeat(2),
                        uv.repeat(2, 1), torch.ones(8), CameraIntrinsics(525.0, 525.0, 319.5, 239.5, 640, 480),
                        obs_z=lm[:, 2].repeat(2))


def _refine_palindrome(mesh):
    """The palindrome's ground truth, nudged, as the odometry: one closure
    (0, 4) measured and the pose graph solved."""
    ds = SubsetDataset(SlamTbDataset.load(str(SAMPLE1)), PALINDROME)
    gt = ds.trajectory().camera_to_world
    nudged = Trajectory(gt @ Transform.exp(torch.full((len(PALINDROME), 6), 1e-3)), torch.arange(5.0))
    raw = OdometryResult(trajectory=nudged, metrics=None, seconds_per_frame=0.0)
    return refine_with_loop_closures(ds, raw, "cpu", icp_params=cheap(MsIcpParams), mesh=mesh, **KWARGS).trajectory


CALLS = {
    "pose_graph.optimize": lambda mesh: pg.optimize(_tiny_graph()[0], mesh=mesh),
    "pose_graph.refine_trajectory": lambda mesh: pg.refine_trajectory(_tiny_graph()[1], mesh=mesh),
    "bundle_adjustment.optimize": lambda mesh: ba.optimize(_tiny_problem(), mesh=mesh),
    "refine_with_loop_closures": _refine_palindrome,
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_mesh_is_not_ported_and_says_so(name):
    """``mesh=`` raised NotImplementedError until the sharded forms were
    ported; now each call runs on a one-rank CPU mesh and gives the poses
    of the same call without a mesh (within 1e-6: one rank's sums are the
    unsharded sums)."""
    from align3d_torch.parallel.batch import make_mesh

    mesh = make_mesh(devices="cpu")
    try:
        outs = [CALLS[name](m) for m in (mesh, None)]
    finally:
        torch.distributed.destroy_process_group()
    got, ref = (out.camera_to_world if isinstance(out, Trajectory) else out[0] if isinstance(out, tuple) else out
                for out in outs)
    assert torch.isfinite(got.rotation).all() and torch.isfinite(got.translation).all()
    torch.testing.assert_close(got.rotation, ref.rotation, atol=1e-6, rtol=0)
    torch.testing.assert_close(got.translation, ref.translation, atol=1e-6, rtol=0)


def test_cli_loop_closure_on_cpu(tmp_path, capsys):
    out = tmp_path / "traj.tum"
    rc = cli.main(["odometry", "slamtb", str(SAMPLE1), "2", "--no-bilateral", "--loop-closure", "--device", "cpu",
                   "-q", "--save-trajectory", str(out)])
    assert rc == 0
    printed = capsys.readouterr().out.splitlines()
    before = [line for line in printed if line.startswith("Mean trajectory error before loop closure: angle")]
    after = [line for line in printed if line.startswith("Mean trajectory error: angle")]
    assert len(before) == 1 and len(after) == 1
    assert printed.index(before[0]) < printed.index(after[0])
    saved = Trajectory.from_tum(out.read_text())
    assert len(saved) == 2 and torch.isfinite(saved.camera_to_world.translation).all()
