"""The port's main path end to end on the CPU: sample1 odometry with the
bilateral filter on, against the JAX package, its golden trajectory and the
reference accuracy bound; the ``align3d_torch`` command line; and that the
port never imports JAX."""

import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import _torch_cpu
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_tpu.odometry import run_odometry as jax_run_odometry
from align3d_tpu.ops.bilateral import BilateralFilter as JaxBilateralFilter
from align3d_tpu.range_image import RangeImageBuilder as JaxRangeImageBuilder

from align3d_torch import cli
from align3d_torch.convert import transform_from_numpy
from align3d_torch.io.datasets import SlamTbDataset
from align3d_torch.metrics import TransformMetrics
from align3d_torch.odometry import run_odometry
from align3d_torch.ops.bilateral import BilateralFilter
from align3d_torch.range_image import RangeImageBuilder
from align3d_torch.se3 import Transform
from align3d_torch.trajectory import Trajectory

ROOT = Path(__file__).resolve().parent.parent
SAMPLE1 = ROOT / "tests" / "data" / "rgbd" / "sample1"
GOLDEN = ROOT / "tests" / "data" / "golden" / "sample1_bilateral_10.tum"
FRAMES = 3
# The bound of tests/test_odometry_accuracy.py:27-34.
ANGLE_BOUND_DEG, TRANS_BOUND = 0.5, 0.01


def _port_run(frames):
    builder = RangeImageBuilder(bilateral_filter=BilateralFilter())
    return run_odometry(SlamTbDataset.load(str(SAMPLE1)), "cpu", range_builder=builder, max_frames=frames)


def _pose_diff(a: Transform, b: Transform):
    m = TransformMetrics.new(a, b)
    return m.angle.numpy(), m.translation.numpy()


def _assert_bounds(metrics):
    assert math.degrees(float(metrics.angle)) < ANGLE_BOUND_DEG
    assert float(metrics.translation) < TRANS_BOUND


@pytest.fixture(scope="module")
def port_result():
    return _port_run(FRAMES)


def test_odometry_matches_jax(port_result, sample1_dataset):
    builder = JaxRangeImageBuilder(bilateral_filter=JaxBilateralFilter())
    ref = jax_run_odometry(sample1_dataset, range_builder=builder, max_frames=FRAMES)
    ref_poses = transform_from_numpy(
        np.asarray(ref.trajectory.camera_to_world.rotation), np.asarray(ref.trajectory.camera_to_world.translation),
        device="cpu",
    )
    angle, trans = _pose_diff(ref_poses, port_result.trajectory.camera_to_world)
    # Each pose within 1e-3 rad / 1e-3 m (measured max 1.1e-6 rad, 2.0e-6 m).
    assert angle.max() <= 1e-3 and trans.max() <= 1e-3
    _assert_bounds(port_result.metrics)
    assert len(port_result.residuals) == FRAMES - 1


def test_odometry_prefix_matches_golden(port_result):
    golden = Trajectory.from_tum(GOLDEN.read_text())
    assert len(golden) == 10
    angle, trans = _pose_diff(golden.slice(0, FRAMES).camera_to_world, port_result.trajectory.camera_to_world)
    # The 3-frame bound, 1e-3 rad / 1e-3 m (measured max 1.1e-6 rad,
    # 2.0e-6 m; the golden's text keeps 7 decimals).
    assert angle.max() <= 1e-3 and trans.max() <= 1e-3


def test_cli_odometry_on_cpu(port_result, tmp_path, capsys):
    out = tmp_path / "traj.tum"
    rc = cli.main(
        ["odometry", "slamtb", str(SAMPLE1), str(FRAMES), "--device", "cpu", "--quiet", "--save-trajectory", str(out)]
    )
    assert rc == 0
    printed = capsys.readouterr().out
    assert "Mean trajectory error" in printed and "Seconds per frame" in printed
    saved = Trajectory.from_tum(out.read_text())
    angle, trans = _pose_diff(saved.camera_to_world, port_result.trajectory.camera_to_world)
    # The same run, through TUM text with 7 decimals.
    assert angle.max() <= 1e-6 and trans.max() <= 1e-6


def test_cli_requires_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["odometry", "slamtb", str(SAMPLE1), "2", "--quiet"])


def test_cli_rejects_unported_formats():
    # Every format of the JAX package is ported; an unknown one is refused.
    with pytest.raises(ValueError, match="Invalid dataset format"):
        cli.main(["odometry", "nope", str(SAMPLE1), "--device", "cpu", "--quiet"])


FORBIDDEN = ("jax", "jaxlib", "align3d_tpu", "bench", "benches")


def _imported_roots(path: Path) -> set:
    """Top-level names a Python file imports, anywhere in it."""
    import ast

    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_never_imports_jax():
    # No module of the port, its tools included, nor chip_smoke.py names
    # jax, the JAX package, bench or benches in an import, even lazily.
    files = sorted((ROOT / "align3d_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert any(f.parent.name == "tools" for f in files) and any(f.parent.name == "parallel" for f in files)
    for path in files:
        assert not (_imported_roots(path) & set(FORBIDDEN)), path
    # And running it loads none of them.
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from align3d_torch.io.datasets import SlamTbDataset\n"
        "from align3d_torch.odometry import run_odometry\n"
        "from align3d_torch.ops.bilateral import BilateralFilter\n"
        "from align3d_torch.range_image import RangeImageBuilder\n"
        f"ds = SlamTbDataset.load({str(SAMPLE1)!r})\n"
        f"r = run_odometry(ds, 'cpu', range_builder=RangeImageBuilder(bilateral_filter=BilateralFilter()), "
        f"max_frames={FRAMES})\n"
        # One point-cloud ICP align on each engine and one MeshNormals call.
        "import torch\n"
        "from align3d_torch.icp.pcl_icp import Icp\n"
        "from align3d_torch.icp.params import IcpParams, MsIcpParams\n"
        "from align3d_torch.io import read_ply\n"
        "from align3d_torch.ops.mesh import MeshNormals\n"
        f"geo = read_ply({str(ROOT / 'tests' / 'data' / 'teapot.ply')!r})\n"
        "pts, nrm = torch.from_numpy(geo.points), torch.from_numpy(geo.normals)\n"
        "for engine in ('banded', 'hash'):\n"
        "    Icp(IcpParams(max_iterations=2), pts, nrm, nn_engine=engine).align(pts + 0.001, nrm)\n"
        "vn = MeshNormals(geo.faces, len(geo.points), device='cpu')(pts)\n"
        # The throughput path on three real frames (bucketed filter on), the
        # series helpers and the roofline tool's twins.
        "from align3d_torch.parallel.batch import odometry_step\n"
        "from align3d_torch.tools import ablate, roofline, series\n"
        "s = series.real_frames(3)\n"
        "t = odometry_step(s.camera, 0.001, s.colors[:, ::8, ::8], s.depths[:, ::8, ::8],\n"
        "                  MsIcpParams.repeat(2, IcpParams(max_iterations=2)), 2, BilateralFilter(), 'cpu')\n"
        "roofline.fma_chains(torch.ones(8), 1)\n"
        "roofline.table_gather(torch.arange(64, dtype=torch.int32), torch.zeros(8, dtype=torch.int32), 1)\n"
        # Global refinement: one tiny pose graph and one tiny bundle adjustment.
        "from align3d_torch.camera import CameraIntrinsics\n"
        "from align3d_torch.optim.pcg import pcg\n"
        "from align3d_torch.parallel import bundle_adjustment as ba, pose_graph as pg\n"
        "from align3d_torch.odometry import refine_with_loop_closures\n"
        "from align3d_torch.se3 import Transform\n"
        "graph = pg.PoseGraph.from_trajectory(r.trajectory)\n"
        "nodes = pg.optimize(graph.with_edge(0, 2, graph.measurements[0] @ graph.measurements[1]), iterations=2)\n"
        "lm = torch.tensor([[-0.5, -0.5, 2.0], [0.5, -0.5, 2.5], [-0.5, 0.5, 3.0], [0.5, 0.5, 2.0]])\n"
        "uv = lm[:, :2] * 525.0 / lm[:, 2:] + torch.tensor([319.5, 239.5])\n"
        "prob = ba.BAProblem(Transform.identity((2,)), lm + 0.01, torch.tensor([0] * 4 + [1] * 4),\n"
        "                    torch.arange(4).repeat(2), uv.repeat(2, 1), torch.ones(8),\n"
        "                    CameraIntrinsics(525.0, 525.0, 319.5, 239.5, 640, 480), obs_z=lm[:, 2].repeat(2))\n"
        "poses, lms = ba.optimize(prob, iterations=2)\n"
        "assert torch.isfinite(nodes.translation).all() and torch.isfinite(lms).all()\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print('LOADED', bad, len(r.trajectory), tuple(vn.shape), len(t), len(nodes.translation), tuple(lms.shape))\n"
    )
    proc = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True, timeout=300,
                          env=_torch_cpu.env())
    assert proc.returncode == 0, proc.stderr
    assert f"LOADED [] {FRAMES} (480, 3) 3 {FRAMES} (4, 3)" in proc.stdout


@pytest.mark.slow
def test_ten_frames_within_bound_and_golden():
    result = _port_run(10)
    _assert_bounds(result.metrics)
    golden = Trajectory.from_tum(GOLDEN.read_text())
    angle, trans = _pose_diff(golden.camera_to_world, result.trajectory.camera_to_world)
    # chip_smoke.py's bound on the card (measured on the CPU: 2.8e-6 rad, 8.5e-6 m).
    assert angle.max() <= 2e-3 and trans.max() <= 2e-3
