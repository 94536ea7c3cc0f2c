"""The normal-angle gates of the port's two ICPs at their boundaries,
against the JAX package (inputs: tests/_torch_gate_cases.py).

* Image ICP (``ops/icp_fused.py::icp_step``, the plain twin of K1; JAX
  ``icp/image_icp.py::icp_step``) rejects a pixel at angle >= threshold and
  keeps a NaN angle: the geometric system's count says which.
* Point-cloud ICP (``icp/pcl_icp.py::Icp``, both NN engines; JAX ``Icp``,
  hash engine) rejects a point at angle > threshold and keeps a NaN angle.
  A gated point changes only its weight, so one iteration from the identity
  gives bitwise the same pose whenever the same points are kept, and a
  visibly other pose when the probe points drop out.

K1 is held against its twin at the same inputs on the card
(tests/test_torch_kernels_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_tpu.camera import CameraIntrinsics as JaxIntrinsics
from align3d_tpu.icp.image_icp import icp_step as jax_icp_step
from align3d_tpu.icp.params import IcpParams as JaxIcpParams
from align3d_tpu.icp.params import MsIcpParams as JaxMsIcpParams
from align3d_tpu.icp.pcl_icp import Icp as JaxIcp
from align3d_tpu.ops.target_pack import pack_geometry as jax_pack_geometry
from align3d_tpu.ops.target_pack import pack_intensity_taps as jax_pack_taps
from align3d_tpu.se3 import Transform as JaxTransform

from align3d_torch.camera import CameraIntrinsics
from align3d_torch.icp.params import IcpParams, MsIcpParams
from align3d_torch.icp.pcl_icp import Icp
from align3d_torch.ops.icp_fused import icp_step
from align3d_torch.ops.target_pack import pack_geometry, pack_intensity_taps
from align3d_torch.se3 import Transform
from _torch_gate_cases import COSINE, H, IMAGE_KEEPS, INTRINSICS, PCL_KEEPS, W, dot_cases, image_inputs


@pytest.fixture(scope="module")
def threshold():
    """The float32 arccos of COSINE, the same in PyTorch and in JAX (checked),
    and the cases' angles on either side of it."""
    t = float(torch.arccos(torch.tensor(COSINE)))
    assert float(jnp.arccos(jnp.float32(COSINE))) == t
    assert np.float32(t) == t  # a float32 value: f32(max_normal_angle) is t itself
    cases = dot_cases()
    for name, dot in cases.items():
        angles = (float(torch.arccos(torch.tensor(dot))), float(jnp.arccos(jnp.float32(dot))))
        want = {"at": t, "nan": None}.get(name)
        for a in angles:
            if name == "inside":
                assert a < t
            elif name == "outside":
                assert a > t
            elif name == "nan":
                assert np.isnan(a)
            else:
                assert a == want
    return t


@pytest.mark.parametrize("case", list(IMAGE_KEEPS))
def test_image_icp_gate_boundary(threshold, case):
    x = image_inputs(dot_cases()[case])
    params = MsIcpParams.default()[0].replace(max_normal_angle=threshold)
    jparams = JaxMsIcpParams.default()[0].replace(max_normal_angle=threshold)
    intr = CameraIntrinsics(**INTRINSICS, width=W, height=H)
    jintr = JaxIntrinsics(**INTRINSICS, width=W, height=H)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    ours = icp_step(
        Transform(torch.eye(3), torch.zeros(3)), t["points"], t["mask"], t["intensity"],
        pack_geometry(t["target_points"], t["target_normals"], t["target_mask"]),
        pack_intensity_taps(t["intensity_map"][None])[0], H, W, intr, params)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    ref = jax_icp_step(
        JaxTransform(jnp.eye(3), jnp.zeros(3)), j["points"], j["mask"], j["intensity"],
        jax_pack_geometry(j["target_points"], j["target_normals"], j["target_mask"]),
        jax_pack_taps(j["intensity_map"]), H, W, jintr, jparams)
    assert float(ours[0].count) == float(ref[0].count) == float(IMAGE_KEEPS[case])
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.hessian.numpy(), np.asarray(r.hessian), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(o.gradient.numpy(), np.asarray(r.gradient), rtol=1e-6, atol=1e-6)


def _pcl_clouds(dot):
    """A wavy target (tests/test_torch_pcl_icp.py) beside a flat 6 x 6 patch
    at z = 0 whose normals are (0, 0, 1). The source: the wavy part moved by
    a small translation (normals unchanged), and probe points 0.01 above the
    patch whose normals have z = ``dot`` (the gate's dot product)."""
    g = np.linspace(0.0, 2.0, 30, dtype=np.float32)
    xs, ys = np.meshgrid(g, g, indexing="ij")
    zs = 0.2 * np.sin(2 * xs) * np.cos(2 * ys)
    wavy = np.stack([xs, ys, zs], -1).reshape(-1, 3)
    wn = np.stack([-0.4 * np.cos(2 * xs) * np.cos(2 * ys), 0.4 * np.sin(2 * xs) * np.sin(2 * ys),
                   np.ones_like(zs)], -1).reshape(-1, 3)
    wn = (wn / np.linalg.norm(wn, axis=-1, keepdims=True)).astype(np.float32)
    p = np.arange(6, dtype=np.float32) * np.float32(0.02)
    px, py = np.meshgrid(p + np.float32(3.0), p, indexing="ij")
    patch = np.stack([px, py, np.zeros_like(px)], -1).reshape(-1, 3)
    up = np.zeros_like(patch)
    up[:, 2] = 1.0
    probe_n = np.zeros_like(patch)
    probe_n[:, 0] = 0.3
    probe_n[:, 2] = dot
    tp = np.concatenate([wavy, patch]).astype(np.float32)
    tn = np.concatenate([wn, up]).astype(np.float32)
    sp = np.concatenate([wavy + np.float32([0.004, -0.003, 0.005]), patch + np.float32([0.0, 0.0, 0.01])])
    sn = np.concatenate([wn, probe_n])
    return tp, tn, sp.astype(np.float32), sn.astype(np.float32)


def _pcl_align(threshold, dot, engine):
    tp, tn, sp, sn = _pcl_clouds(dot)
    if engine == "jax":
        out = JaxIcp(JaxIcpParams(max_iterations=1, max_normal_angle=threshold), tp, tn, nn_engine="hash").align(sp, sn)
        return np.asarray(out.rotation), np.asarray(out.translation)
    t = [torch.from_numpy(a) for a in (tp, tn, sp, sn)]
    out = Icp(IcpParams(max_iterations=1, max_normal_angle=threshold), t[0], t[1], nn_engine=engine).align(t[2], t[3])
    return out.rotation.numpy(), out.translation.numpy()


@pytest.mark.parametrize("engine", ["banded", "hash", "jax"])
def test_pcl_icp_gate_boundary(threshold, engine):
    cases = dot_cases()
    got = {name: _pcl_align(threshold, dot, engine) for name, dot in cases.items()}
    kept, dropped = got["inside"], got["outside"]
    # The probes pull the pose down by ~0.01 in z: visible when they drop out.
    assert abs(float(kept[1][2]) - float(dropped[1][2])) > 1e-3
    for name, (rot, trans) in got.items():
        want = kept if PCL_KEEPS[name] else dropped
        assert np.array_equal(rot, want[0]) and np.array_equal(trans, want[1]), name
    if engine != "jax":
        # Against JAX's hash engine, case by case (tests/test_torch_pcl_icp.py's bound).
        for name, dot in cases.items():
            ref = _pcl_align(threshold, dot, "jax")
            np.testing.assert_allclose(got[name][0], ref[0], atol=1e-5, rtol=0)
            np.testing.assert_allclose(got[name][1], ref[1], atol=1e-5, rtol=0)
