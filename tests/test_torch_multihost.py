"""The port's multi-process runtime (``align3d_torch/parallel/multihost.py``)
and its two-process drill (``align3d_torch/tools/run_multiprocess.py``), on
the CPU over gloo: the counterparts of ``tests/test_multihost.py``.

* ``initialize`` is a no-op for a single process, and ``global_mesh`` /
  ``host_local_batch`` then give a one-rank mesh and the data as it is
  (``tests/test_multihost.py:37-49``);
* on two processes, ``host_local_batch`` gives a DTensor sharded on dim 0
  of twice the local length, ``replicate`` a replicated one, and odometry
  of the frame-sharded batch (each process feeding only its own frames)
  is bitwise the port's unsharded ``odometry_step`` at one thread;
* the drill prints ``PARITY OK``, and under ``--fault`` ``RESUME OK`` (its
  own bounds, 1e-4 and 5e-4, as the JAX drill's).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import _torch_cpu
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)
from _torch_dist_cases import camera, host_local_paths, poses, small_params, spawn, synthetic_sequence

from align3d_tpu.parallel import multihost as jmultihost

from align3d_torch.parallel import multihost
from align3d_torch.parallel.batch import odometry_step

ROOT = Path(__file__).resolve().parent.parent
DRILL_TIMEOUT_S = 300


@pytest.fixture
def one_rank_group():
    """The in-process group ``global_mesh`` makes is global state: destroyed after."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def test_initialize_noop_single_process(one_rank_group, monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    multihost.initialize(None, None, None)  # must not raise or join anything
    assert not torch.distributed.is_initialized()
    multihost.initialize("localhost:1", 1, 0)  # one process: nothing to join either
    assert not torch.distributed.is_initialized()
    mesh = multihost.global_mesh(devices="cpu")
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("pairs",)
    arr = multihost.host_local_batch(mesh, np.zeros((mesh.size(), 3)))
    assert isinstance(arr, torch.Tensor) and tuple(arr.shape) == (1, 3)
    # The JAX package's single-process mesh passes the same shape through.
    jmesh = jmultihost.global_mesh()
    assert jmultihost.host_local_batch(jmesh, np.zeros((jmesh.devices.size, 3))).shape == (jmesh.devices.size, 3)


def test_host_local_batch_two_processes(tmp_path):
    cam, colors, depths = synthetic_sequence(8)
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, camera=np.asarray(cam, np.float64), colors=colors, depths=depths)
    spawn(host_local_paths, 2, tmp_path, str(inputs), str(tmp_path))
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    ref = poses(odometry_step(camera(cam), 0.001, colors, depths, small_params(), 2, device="cpu").camera_to_world)
    for r in ranks:
        assert r["global_shape"].tolist() == [8, 48, 64, 3] and r["local_shape"].tolist() == [4, 48, 64, 3]
        assert str(r["placements"]) == "(Shard(dim=0),)"
        assert str(r["replicated_placements"]) == "(Replicate(),)"
        np.testing.assert_array_equal(r["replicated"], np.arange(3.0))
        np.testing.assert_array_equal(r["step"], ref)


def drill(*args: str) -> subprocess.CompletedProcess:
    env = _torch_cpu.env(PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-m", "align3d_torch.tools.run_multiprocess", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=DRILL_TIMEOUT_S)


def test_drill_parity():
    proc = drill()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PARITY OK" in proc.stdout, proc.stdout


def test_drill_fault_abort_resume():
    proc = drill("--fault")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "process 1 lost" in proc.stdout and "RESUME OK" in proc.stdout, proc.stdout
