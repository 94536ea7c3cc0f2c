"""Point-cloud ICP of the PyTorch port (``icp/pcl_icp.py``) against the JAX
package's ``Icp`` and against ground truth. Both packages get the same
clouds: the JAX range images' arrays, or a synthetic surface made with numpy.

The port's banded engine runs the plain twin of CUDA kernel K4 here; the
JAX banded engine (Pallas in interpret mode) is too slow to be the oracle,
so the port is held against the JAX hash engine, and its two engines
against each other, as ``tests/test_icp.py`` holds the JAX engines. The
port solves the 6x6 system in float64 and JAX in float32 with refinement,
and the port's source sort is stable where JAX's is not, so the poses
agree to a measured tolerance, not bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_tpu.icp.params import IcpParams as JaxIcpParams
from align3d_tpu.icp.pcl_icp import Icp as JaxIcp
from align3d_tpu.range_image import RangeImage as JaxRangeImage
from align3d_tpu.se3 import Transform as JaxTransform

from align3d_torch.icp.params import IcpParams
from align3d_torch.icp.pcl_icp import Icp
from align3d_torch.se3 import Transform

# Port against the JAX hash engine on the same clouds (measured: wavy 2.4e-8
# rad / 1.2e-7 m; sample1 1.7e-7 rad / 2.6e-7 m).
JAX_ANGLE, JAX_TRANS = 1e-5, 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _port(t) -> Transform:
    return Transform(_t(t.rotation), _t(t.translation))


def _diff(a: Transform, b: Transform) -> tuple[float, float]:
    d = a.inverse() @ b
    return float(d.angle()), float(torch.linalg.norm(d.translation))


def _wavy(side=60):
    """The wavy surface of tests/test_icp.py::test_pcl_icp_banded_large_step_resort
    (there 100 x 100), with analytic normals, and the offset source."""
    g = np.linspace(0.0, 2.0, side, dtype=np.float32)
    xs, ys = np.meshgrid(g, g, indexing="ij")
    zs = 0.2 * np.sin(2 * xs) * np.cos(2 * ys)
    tp = np.stack([xs, ys, zs], axis=-1).reshape(-1, 3)
    dzdx = 0.4 * np.cos(2 * xs) * np.cos(2 * ys)
    dzdy = -0.4 * np.sin(2 * xs) * np.sin(2 * ys)
    tn = np.stack([-dzdx, -dzdy, np.ones_like(zs)], axis=-1).reshape(-1, 3)
    tn = (tn / np.linalg.norm(tn, axis=-1, keepdims=True)).astype(np.float32)
    offset = JaxTransform.exp(jnp.asarray([0.2, 0.1, 0.05, 0.03, -0.02, 0.04], jnp.float32))
    return tp, tn, np.asarray(offset.apply(jnp.asarray(tp))), np.asarray(offset.apply_normals(jnp.asarray(tn))), offset


@pytest.fixture(scope="module")
def wavy_jax_hash():
    tp, tn, sp, sn, offset = _wavy()
    params = JaxIcpParams(max_iterations=8, max_distance=0.5)
    return _port(JaxIcp(params, tp, tn, nn_engine="hash").align(sp, sn))


@pytest.mark.parametrize("engine", ["banded", "hash"])
def test_wavy_large_step(wavy_jax_hash, engine):
    tp, tn, sp, sn, offset = _wavy()
    icp = Icp(IcpParams(max_iterations=8, max_distance=0.5), _t(tp), _t(tn), nn_engine=engine)
    result = icp.align(_t(sp), _t(sn))
    # The first step moves the cloud by several cells: the stale-sort guard
    # re-sorts the banded engine's source (the hash engine never sorts).
    if engine == "banded":
        assert icp.last_resorts >= 1, icp.last_resorts
    else:
        assert icp.last_resorts == 0
    angle, trans = _diff(result, _port(offset.inverse()))
    assert angle < 0.01 and trans < 0.01, (angle, trans)
    angle, trans = _diff(result, wavy_jax_hash)
    assert angle < JAX_ANGLE and trans < JAX_TRANS, (angle, trans)


@pytest.fixture(scope="module")
def sample1_pair(sample1_dataset):
    """Valid points and normals of sample1 frames 0 (target) and 1 (source),
    every 4th (tests/test_icp.py::test_pcl_icp_align_banded_engine), and the
    ground-truth 1 -> 0 transform."""

    def cloud(i):
        ri = JaxRangeImage.from_frame(sample1_dataset.get(i)).with_normals()
        mask = np.asarray(ri.mask).reshape(-1)
        return np.asarray(ri.points).reshape(-1, 3)[mask][::4], np.asarray(ri.normals).reshape(-1, 3)[mask][::4]

    gt = sample1_dataset.trajectory().get_relative_transform(1, 0)
    return cloud(0), cloud(1), _port(gt)


def test_sample1_engines_against_ground_truth_and_jax(sample1_pair):
    (tp, tn), (sp, sn), gt = sample1_pair
    params = IcpParams(max_iterations=5)
    results = {}
    for engine in ("banded", "hash"):
        results[engine] = Icp(params, _t(tp), _t(tn), nn_engine=engine).align(_t(sp), _t(sn))
        # The reference bound (pcl_icp.rs:121-136; measured 8.4e-4 banded, 7.3e-4 hash).
        assert _diff(results[engine], gt)[0] < 0.1
    # tests/test_icp.py::test_pcl_icp_align_banded_engine's bound (measured 2.5e-4).
    assert _diff(results["banded"], results["hash"])[0] < 0.02
    ref = _port(JaxIcp(JaxIcpParams(max_iterations=5), tp, tn, nn_engine="hash").align(sp, sn))
    angle, trans = _diff(results["hash"], ref)
    assert angle < JAX_ANGLE and trans < JAX_TRANS, (angle, trans)


def test_default_engine_and_errors():
    tp, tn, *_ = _wavy(side=8)
    assert Icp(IcpParams(), _t(tp), _t(tn)).nn_engine == "hash"  # a CPU target
    with pytest.raises(ValueError, match="normals"):
        Icp(IcpParams(), _t(tp), None)
    with pytest.raises(ValueError, match="nn_engine"):
        Icp(IcpParams(), _t(tp), _t(tn), nn_engine="kdtree")
