"""Point clouds and geometry I/O of the PyTorch port against the JAX package:
``io/{geometry,off,ply}.py``, ``pointcloud.py``,
``range_image.range_image_to_pointcloud``, ``Transform.apply_normals`` and
``GNSystem.weight``/``add``. Inputs are made with numpy from a seed (or read
from the fixtures) and handed to both."""

import dataclasses
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from align3d_tpu.config import ref_data_path
from align3d_tpu.io.geometry import Geometry as JaxGeometry
from align3d_tpu.io.off import read_off as jax_read_off
from align3d_tpu.io.ply import read_ply as jax_read_ply
from align3d_tpu.io.ply import write_ply as jax_write_ply
from align3d_tpu.optim.gauss_newton import GNSystem as JaxGN
from align3d_tpu.pointcloud import PointCloud as JaxPointCloud
from align3d_tpu.range_image import RangeImage as JaxRangeImage
from align3d_tpu.range_image import range_image_to_pointcloud as jax_ri_to_pc
from align3d_tpu.se3 import Transform as JaxTransform

from align3d_torch import convert
from align3d_torch.camera import CameraIntrinsics
from align3d_torch.io import Geometry, OffError, PlyError, read_off, read_ply, write_ply
from align3d_torch.optim.gauss_newton import GNSystem
from align3d_torch.pointcloud import PointCloud
from align3d_torch.range_image import RangeImage, range_image_to_pointcloud
from align3d_torch.se3 import Transform


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_geometry_equal(ours, ref):
    for field in dataclasses.fields(ref):
        a, b = getattr(ours, field.name), getattr(ref, field.name)
        assert (a is None) == (b is None), field.name
        if a is not None:
            assert a.dtype == b.dtype, field.name
            np.testing.assert_array_equal(a, b)


# -- geometry I/O -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["teapot.off", "teapot.ply"])
def test_read_teapot_matches_jax(name):
    reader, jax_reader = (read_off, jax_read_off) if name.endswith("off") else (read_ply, jax_read_ply)
    ours, ref = reader(ref_data_path(name)), jax_reader(ref_data_path(name))
    _assert_geometry_equal(ours, ref)
    assert ours.points.shape == (480, 3) and ours.len_faces() == 880
    if name.endswith("ply"):
        assert ours.normals.shape == (480, 3)


@pytest.mark.parametrize("binary", [True, False])
def test_write_ply_matches_jax_and_round_trips(tmp_path, binary):
    rng = np.random.default_rng(0)
    n, m = 3000, 2000
    arrays = dict(
        points=rng.normal(size=(n, 3)).astype(np.float32),
        normals=rng.normal(size=(n, 3)).astype(np.float32),
        colors=rng.integers(0, 256, (n, 3)).astype(np.uint8),
        faces=rng.integers(0, n, (m, 3)).astype(np.int64),
    )
    write_ply(tmp_path / "ours.ply", convert.geometry_from_numpy(**arrays), binary=binary)
    jax_write_ply(tmp_path / "jax.ply", JaxGeometry(**arrays), binary=binary)
    assert (tmp_path / "ours.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    # Bitwise both ways: ASCII writes float32's shortest repr, which reads back exactly.
    back = read_ply(tmp_path / "ours.ply")
    for key, value in arrays.items():
        np.testing.assert_array_equal(getattr(back, key), value)


def test_off_quad_fan_split_and_arity_rejection(tmp_path):
    # tests/test_mesh.py::test_off_quad_fan_split_and_arity_rejection (off.rs:78-86).
    quad = tmp_path / "quad.off"
    quad.write_text("OFF\n4 1 0\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n")
    np.testing.assert_array_equal(read_off(str(quad)).faces, [[0, 1, 2], [0, 2, 3]])
    bad = tmp_path / "penta.off"
    bad.write_text("OFF\n5 1 0\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n0.5 2 0\n5 0 1 2 3 4\n")
    with pytest.raises(OffError, match="arity"):
        read_off(str(bad))


def test_ply_binary_truncated_raises(tmp_path):
    # tests/test_mesh.py::test_ply_binary_truncated_raises.
    rng = np.random.default_rng(0)
    geom = Geometry(points=rng.normal(size=(50, 3)).astype(np.float32), faces=rng.integers(0, 50, (30, 3)))
    write_ply(tmp_path / "t.ply", geom, binary=True)
    (tmp_path / "trunc.ply").write_bytes((tmp_path / "t.ply").read_bytes()[:-7])
    with pytest.raises(PlyError):
        read_ply(tmp_path / "trunc.ply")


def test_ply_binary_quads_rejected(tmp_path):
    # tests/test_mesh.py::test_ply_binary_quads_rejected.
    header = (
        b"ply\nformat binary_little_endian 1.0\nelement vertex 4\n"
        b"property float x\nproperty float y\nproperty float z\n"
        b"element face 1\nproperty list uchar int vertex_indices\nend_header\n"
    )
    body = b"".join(struct.pack("<3f", *v) for v in [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0)])
    body += struct.pack("<B4i", 4, 0, 1, 2, 3)
    (tmp_path / "quad.ply").write_bytes(header + body)
    with pytest.raises(PlyError):
        read_ply(tmp_path / "quad.ply")


# -- point clouds -------------------------------------------------------------------


@pytest.fixture(scope="module")
def sample1_range_images(sample1_dataset):
    """sample1 frame 0 as a JAX range image with normals, and the port's
    own range image of the same frame."""
    frame = sample1_dataset.get(0)
    ref = JaxRangeImage.from_frame(frame).with_normals()
    ours = RangeImage.from_rgbd(
        CameraIntrinsics(**dataclasses.asdict(frame.camera)), torch.from_numpy(frame.image.color),
        torch.from_numpy(frame.image.depth.astype(np.int32)), float(frame.image.depth_scale),
    ).with_normals()
    return ref, ours


def test_from_range_image_matches_jax(sample1_range_images):
    ref_ri, ours_ri = sample1_range_images
    ref = JaxPointCloud.from_range_image(ref_ri)
    ours = PointCloud.from_range_image(ours_ri)
    # Built independently, points and mask are bitwise (the normals differ in
    # the last bit where XLA contracts into FMAs, tests/test_torch_range_image.py).
    np.testing.assert_array_equal(ours.points.numpy(), np.asarray(ref.points))
    np.testing.assert_array_equal(ours.mask.numpy(), np.asarray(ref.mask))
    assert int(ours.len_valid()) == int(ref.len_valid()) == 270_213
    compact = ours.compacted()
    assert len(compact) == 270_213 and bool(compact.mask.all())
    # Fed the JAX range image's arrays, the flattening is bitwise in every field.
    carried = convert.range_image_from_numpy(
        np.asarray(ref_ri.points), np.asarray(ref_ri.mask), np.asarray(ref_ri.normals), np.asarray(ref_ri.colors),
        None, None, dataclasses.asdict(ref_ri.intrinsics),
    )
    ours = PointCloud.from_range_image(carried).compacted()
    ref = ref.compacted()
    for name in ("points", "mask", "normals", "colors"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)))
    flat, ref_flat = range_image_to_pointcloud(carried), jax_ri_to_pc(ref_ri)
    assert sorted(flat) == sorted(ref_flat)
    for key in flat:
        np.testing.assert_array_equal(flat[key].numpy(), np.asarray(ref_flat[key]))


def _cloud(n=64, seed=0):
    rng = np.random.default_rng(seed)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return (rng.standard_normal((n, 3)).astype(np.float32), rng.random(n) > 0.25, nrm,
            rng.integers(0, 255, (n, 3), dtype=np.uint8))


def test_transformed_and_apply_normals_match_jax():
    pts, mask, nrm, col = _cloud()
    twist = np.asarray([0.1, -0.2, 0.3, 0.2, -0.1, 0.15], np.float32)
    jt = JaxTransform.exp(jnp.asarray(twist))
    tt = Transform(_t(jt.rotation), _t(jt.translation))
    ref = JaxPointCloud(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(nrm), jnp.asarray(col)).transformed(jt)
    ours = PointCloud(_t(pts), _t(mask), _t(nrm), _t(col)).transformed(tt)
    np.testing.assert_allclose(ours.points.numpy(), np.asarray(ref.points), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours.normals.numpy(), np.asarray(ref.normals), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(ours.normals.numpy(), axis=1), 1.0, atol=1e-5)
    # apply_normals rotates only, batched and single (src/transform.rs:151).
    np.testing.assert_allclose(tt.apply_normals(_t(nrm[0])).numpy(), np.asarray(jt.apply_normals(jnp.asarray(nrm[0]))),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tt.apply_normals(_t(nrm)).numpy(), (_t(nrm) @ tt.rotation.T).numpy())


def test_geometry_round_trip():
    pts, mask, nrm, col = _cloud(seed=1)
    pc = PointCloud(_t(pts), _t(mask), _t(nrm), _t(col))
    geo = pc.to_geometry()
    ref = JaxPointCloud(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(nrm), jnp.asarray(col)).to_geometry()
    _assert_geometry_equal(geo, ref)
    back = PointCloud.from_geometry(geo, device="cpu")
    np.testing.assert_array_equal(back.points.numpy(), geo.points)
    np.testing.assert_array_equal(back.colors.numpy(), geo.colors)
    assert bool(back.mask.all()) and len(back) == int(mask.sum())


# -- Gauss-Newton additions ----------------------------------------------------------


def test_gn_weight_and_add_match_jax():
    rng = np.random.default_rng(2)
    jac = rng.normal(size=(2, 200, 6)).astype(np.float32)
    res = rng.normal(size=(2, 200)).astype(np.float32)
    w = (rng.random((2, 200)) > 0.3).astype(np.float32)
    ja, jb = (JaxGN.from_residuals(jnp.asarray(jac[i]), jnp.asarray(res[i]), jnp.asarray(w[i])) for i in range(2))
    ta, tb = (GNSystem.from_residuals(_t(jac[i]), _t(res[i]), _t(w[i])) for i in range(2))
    for ours, ref in ((ta.add(tb), ja.add(jb)), (ta.weight(0.7), ja.weight(jnp.float32(0.7)))):
        # The reductions themselves run in another order (atol 1e-4 on sums of 200 terms).
        for name in ("hessian", "gradient", "squared_residual_sum", "count"):
            np.testing.assert_allclose(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)), rtol=1e-5, atol=1e-4)
    # weight(): H by w^2, g and the residual sum by w, the count unscaled.
    scaled = ta.weight(0.5)
    np.testing.assert_array_equal(scaled.hessian.numpy(), (ta.hessian * 0.25).numpy())
    np.testing.assert_array_equal(scaled.gradient.numpy(), (ta.gradient * 0.5).numpy())
    np.testing.assert_array_equal(scaled.squared_residual_sum.numpy(), (ta.squared_residual_sum * 0.5).numpy())
    assert torch.equal(scaled.count, ta.count)


def test_from_geometry_defaults_to_the_card():
    """Entry points run on the card unless the caller asks for the CPU."""
    import inspect

    assert inspect.signature(PointCloud.from_geometry).parameters["device"].default == "cuda"
    geo = Geometry(points=np.zeros((4, 3), np.float32))
    if torch.cuda.is_available():
        assert PointCloud.from_geometry(geo).points.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            PointCloud.from_geometry(geo)
    assert PointCloud.from_geometry(geo, device="cpu").points.device.type == "cpu"
