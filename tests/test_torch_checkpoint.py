"""Checkpoint and resume of the port (``align3d_torch/checkpoint.py`` and
``run_odometry(checkpoint_path=...)``): counterparts of
``tests/test_checkpoint.py``, a resumed run bitwise the uninterrupted one,
and the npz layout read across the two packages. The odometry runs take the
120x160 TUM fixture tree of ``tests/_dataset_fixtures.py`` on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_tpu import checkpoint as jax_checkpoint
from align3d_tpu.se3 import Transform as JaxTransform
from align3d_tpu.trajectory import Trajectory as JaxTrajectory

from _dataset_fixtures import make_tum_tree
from align3d_torch import checkpoint
from align3d_torch.icp.params import IcpParams, MsIcpParams
from align3d_torch.io.datasets import SubsetDataset, TumRgbdDataset
from align3d_torch.odometry import run_odometry
from align3d_torch.ops.bilateral import BilateralFilter
from align3d_torch.range_image import RangeImageBuilder
from align3d_torch.se3 import Transform, stack
from align3d_torch.trajectory import Trajectory

FRAMES = 5
BUILDER = RangeImageBuilder(bilateral_filter=BilateralFilter())
# 3 Gauss-Newton iterations a level keep the runs short; the resume's bits
# do not depend on the count.
PARAMS = MsIcpParams.default().customize(lambda i, p: p.replace(max_iterations=3))


@pytest.fixture(scope="module")
def tum(tmp_path_factory):
    return TumRgbdDataset.load(make_tum_tree(str(tmp_path_factory.mktemp("tum_ck")), n_frames=FRAMES))


def _run(dataset, icp_params=PARAMS, **kwargs):
    return run_odometry(dataset, "cpu", range_builder=BUILDER, icp_params=icp_params, **kwargs)


def _random_trajectory(n, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    poses = [Transform.exp(torch.from_numpy(rng.normal(0, scale, 6).astype(np.float32))) for _ in range(n)]
    return Trajectory(stack(poses), torch.arange(n, dtype=torch.float32))


def _assert_bitwise(a: Trajectory, b: Trajectory):
    assert torch.equal(a.camera_to_world.rotation, b.camera_to_world.rotation)
    assert torch.equal(a.camera_to_world.translation, b.camera_to_world.translation)
    assert torch.equal(a.times, b.times)


def test_state_roundtrip(tmp_path):
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, {"a": np.arange(5), "b": np.float32(2.5), "t": torch.arange(3.0)})
    s = checkpoint.load_state(path)
    np.testing.assert_array_equal(s["a"], np.arange(5))
    assert float(s["b"]) == 2.5
    np.testing.assert_array_equal(s["t"], [0.0, 1.0, 2.0])
    assert [p.name for p in tmp_path.iterdir()] == ["state.npz"]  # no temporary file left


def test_odometry_roundtrip(tmp_path):
    traj = _random_trajectory(4, 0)
    path = str(tmp_path / "odo.npz")
    checkpoint.save_odometry(path, traj, next_frame=4)
    back, nf = checkpoint.load_odometry(path)
    assert nf == 4 and back.camera_to_world.device.type == "cpu"
    _assert_bitwise(back, traj)  # float32 through npz: bitwise


def test_tum_roundtrip():
    traj = _random_trajectory(3, 1, 0.2)
    traj = Trajectory(traj.camera_to_world, torch.tensor([0.0, 0.5, 1.0]))
    back = Trajectory.from_tum(traj.to_tum())
    # The tolerances of tests/test_checkpoint.py (7 decimals in the text).
    np.testing.assert_allclose(back.camera_to_world.translation.numpy(), traj.camera_to_world.translation.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(back.times.numpy(), traj.times.numpy(), atol=1e-6)


def test_run_odometry_resume_matches_uninterrupted(tum, tmp_path):
    full = _run(tum, max_frames=FRAMES)
    ck = str(tmp_path / "odo.npz")
    part = _run(tum, max_frames=3, checkpoint_path=ck, checkpoint_every=2)  # the "aborted" run
    assert len(part.trajectory) == 3
    resumed = _run(tum, max_frames=FRAMES, checkpoint_path=ck, checkpoint_every=2)
    assert len(resumed.trajectory) == FRAMES
    assert len(resumed.residuals) == 2  # only frames 3 and 4 ran
    _assert_bitwise(resumed.trajectory, full.trajectory)
    # The checkpoint now holds the whole run.
    saved, next_frame = checkpoint.load_odometry(ck)
    assert next_frame == FRAMES
    _assert_bitwise(saved, full.trajectory)


def test_odometry_fingerprint_mismatch_refuses(tmp_path):
    traj = Trajectory(stack([Transform.identity(), Transform.identity()]), torch.tensor([0.0, 1.0]))
    path = str(tmp_path / "odo.npz")
    checkpoint.save_odometry(path, traj, next_frame=2, fingerprint="run-a")
    assert checkpoint.load_odometry(path, fingerprint="run-a")[1] == 2
    with pytest.raises(ValueError, match="different run"):
        checkpoint.load_odometry(path, fingerprint="run-b")
    # A checkpoint without a stored fingerprint still loads.
    checkpoint.save_odometry(path, traj, next_frame=2)
    checkpoint.load_odometry(path, fingerprint="run-a")


def test_run_odometry_refuses_another_runs_checkpoint(tum, tmp_path):
    ck = str(tmp_path / "odo.npz")
    _run(tum, max_frames=2, checkpoint_path=ck)
    # Another ICP configuration is another run; a subset of the same
    # dataset (another max_frames) is the same one.
    _run(SubsetDataset(tum, range(2)), max_frames=2, checkpoint_path=ck)
    with pytest.raises(ValueError, match="different run"):
        _run(tum, max_frames=3, checkpoint_path=ck, icp_params=MsIcpParams.repeat(3, IcpParams(max_iterations=2)))


def test_run_odometry_rejects_bad_checkpoint_every(tum):
    with pytest.raises(ValueError, match="checkpoint_every"):
        _run(tum, max_frames=2, checkpoint_every=0)


def test_run_odometry_resume_truncates_to_max_frames(tum, tmp_path):
    ck = str(tmp_path / "odo.npz")
    _run(tum, max_frames=4, checkpoint_path=ck, checkpoint_every=2)
    short = _run(tum, max_frames=2, checkpoint_path=ck, checkpoint_every=2)
    assert len(short.trajectory) == 2 and short.metrics is not None
    assert short.residuals == []  # nothing left to align


def _jax_trajectory(n, seed):
    rng = np.random.default_rng(seed)
    twists = jnp.asarray(rng.normal(0, 0.1, (n, 6)).astype(np.float32))
    return JaxTrajectory(JaxTransform.exp(twists), jnp.arange(n, dtype=jnp.float32) * 0.5)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_read_across_packages(tmp_path, writer):
    """Each package's ``load_odometry``, called without a fingerprint,
    reads the other's file: the same keys, float32 bitwise."""
    path = str(tmp_path / "odo.npz")
    jtraj = _jax_trajectory(3, 2)
    traj = Trajectory(Transform(torch.from_numpy(np.array(jtraj.camera_to_world.rotation)),
                                torch.from_numpy(np.array(jtraj.camera_to_world.translation))),
                      torch.from_numpy(np.array(jtraj.times)))
    if writer == "jax":
        jax_checkpoint.save_odometry(path, jtraj, 3, fingerprint="jax-run")
        back, nf = checkpoint.load_odometry(path)
        _assert_bitwise(back, traj)
    else:
        checkpoint.save_odometry(path, traj, 3, fingerprint="port-run")
        jback, nf = jax_checkpoint.load_odometry(path)
        np.testing.assert_array_equal(np.asarray(jback.camera_to_world.rotation), traj.camera_to_world.rotation.numpy())
        np.testing.assert_array_equal(np.asarray(jback.camera_to_world.translation),
                                      traj.camera_to_world.translation.numpy())
        np.testing.assert_array_equal(np.asarray(jback.times), traj.times.numpy())
    assert nf == 3
    assert sorted(checkpoint.load_state(path)) == ["fingerprint", "next_frame", "rotation", "times", "translation"]
