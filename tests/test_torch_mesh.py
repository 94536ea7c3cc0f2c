"""Mesh vertex normals of the PyTorch port against the JAX package
(``ops/mesh.py``): the port's ``MeshNormals`` runs the plain twin of CUDA
kernel K5 on the CPU, and is held against JAX ``compute_vertex_normals``
(a segment sum) and the JAX ``MeshNormals`` gather path at atol 2e-6, the
JAX tests' own bound (``tests/test_mesh.py``): the sums run in another
order there. The JAX Pallas path is not an oracle here: in interpret mode
it takes ~20 s on the 48-side grid mesh, and it refuses a vertex degree
above 16, which the port takes.

One difference, and why: a face with a repeated corner has e1 == e2, so its
cross product is exactly zero and the reference keeps the zero normal
(mesh.rs:22-25). XLA on the CPU contracts ``a*b - c*d`` into an FMA, which
leaves the rounding error of ``c*d`` (~1e-8) and normalises it into a unit
vector of noise (where that error is not itself zero); the port keeps the
zero. The random mesh has nine such faces, three of them noisy in JAX: their
normals, and the vertex normals of their corners, are held to the
reference's zero instead of to JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from align3d_tpu.config import ref_data_path
from align3d_tpu.io.off import read_off as jax_read_off
from align3d_tpu.ops import mesh as jax_mesh

from align3d_torch.ops import mesh

ATOL = 2e-6  # tests/test_mesh.py


def _grid_mesh(side=48, freq=0.2):
    """The height-field mesh of tests/test_mesh.py (side 320, freq 0.1 is
    benches/bench_mesh.py's 204,800-face mesh)."""
    ys, xs = np.meshgrid(np.arange(side + 1), np.arange(side + 1), indexing="ij")
    zs = np.sin(xs * freq) * np.cos(ys * freq)
    pts = np.stack([xs, ys, zs], axis=-1).reshape(-1, 3).astype(np.float32)
    faces = []
    for r in range(side):
        base, a = r * (side + 1), np.arange(side)
        faces.append(np.stack([base + a, base + a + 1, base + side + 1 + a], 1))
        faces.append(np.stack([base + a + 1, base + side + 2 + a, base + side + 1 + a], 1))
    return pts, np.concatenate(faces).astype(np.int32)


def _fan_mesh(spokes=40):
    """A closed fan: vertex 0 is a corner of every face (degree 40 > the
    TPU band path's limit of 16)."""
    ang = np.linspace(0.0, 2 * np.pi, spokes, endpoint=False)
    rim = np.stack([np.cos(ang), np.sin(ang), 0.1 * np.sin(3 * ang)], axis=1)
    pts = np.concatenate([[[0.0, 0.0, 0.5]], rim]).astype(np.float32)
    i = np.arange(spokes)
    faces = np.stack([np.zeros(spokes, np.int64), 1 + i, 1 + (i + 1) % spokes], axis=1).astype(np.int32)
    return pts, faces


def _random_mesh():
    # tests/test_mesh.py::test_mesh_normals_cached_matches_oneshot: the last
    # 10 vertices are isolated and give NaN.
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    return pts, rng.integers(0, 490, (900, 3)).astype(np.int32)


def _teapot():
    geo = jax_read_off(ref_data_path("teapot.off"))
    return geo.points, geo.faces.astype(np.int32)


CASES = {
    "triangle": lambda: (np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32), np.asarray([[0, 1, 2]], np.int32)),
    "ridge": lambda: (
        np.asarray([[0, 0, 0], [1, 0, 0], [0.5, 1, 1], [0.5, -1, 1]], np.float32),
        np.asarray([[0, 1, 2], [0, 3, 1]], np.int32),
    ),
    "degenerate": lambda: (np.asarray([[0, 0, 0], [1, 0, 0], [2, 0, 0]], np.float32), np.asarray([[0, 1, 2]], np.int32)),
    "random_isolated": _random_mesh,
    "teapot": _teapot,
    "grid48": _grid_mesh,
    "fan_degree40": _fan_mesh,
}


def _repeated_corner(faces):
    return (faces[:, 0] == faces[:, 1]) | (faces[:, 1] == faces[:, 2]) | (faces[:, 0] == faces[:, 2])


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_normals_match_jax(name):
    pts, faces = CASES[name]()
    ref = np.asarray(jax_mesh.compute_vertex_normals(jnp.asarray(pts), jnp.asarray(faces)))
    gather = np.asarray(jax_mesh.MeshNormals(faces, pts.shape[0])(jnp.asarray(pts), method="gather"))
    ours = mesh.MeshNormals(faces, pts.shape[0], device="cpu")(torch.from_numpy(pts)).numpy()
    one_shot = mesh.compute_vertex_normals(torch.from_numpy(pts), torch.from_numpy(faces)).numpy()
    # NaN exactly at the isolated vertices, in both packages.
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    keep = np.ones(pts.shape[0], bool)
    keep[faces[_repeated_corner(faces)].ravel()] = False  # see the module docstring
    for want in (ref, gather, one_shot):
        np.testing.assert_allclose(ours[keep], want[keep], atol=ATOL, rtol=0)


def test_face_normals_match_jax():
    pts, faces = _random_mesh()
    rep = _repeated_corner(faces)
    assert rep.sum() == 9
    ref = np.asarray(jax_mesh.face_normals(jnp.asarray(pts), jnp.asarray(faces)))
    ours = mesh.face_normals(torch.from_numpy(pts), torch.from_numpy(faces)).numpy()
    np.testing.assert_allclose(ours[~rep], ref[~rep], atol=1e-6, rtol=0)
    assert np.all(ours[rep] == 0.0)  # the reference's zero, where JAX on the CPU has noise


def test_face_normals_bitwise_against_numpy_float32():
    """The twin's arithmetic is K5's: float32 ops in a fixed order and a
    correctly rounded root, which numpy's float32 ops give too."""
    pts, faces = _random_mesh()
    p0, p1, p2 = pts[faces[:, 0]], pts[faces[:, 1]], pts[faces[:, 2]]
    a, b = p1 - p0, p2 - p0
    n = np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1], a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                  a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], axis=1)
    mag = np.sqrt((n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1]) + n[:, 2] * n[:, 2])[:, None]
    want = np.where(mag > 0, n / np.where(mag == 0, np.float32(1), mag), n)
    np.testing.assert_array_equal(mesh.face_normals(torch.from_numpy(pts), torch.from_numpy(faces)).numpy(), want)


def test_reference_semantics():
    # tests/test_mesh.py: a unit normal per face, the mean (not unit) at a
    # ridge, the zero normal of a degenerate face, NaN at isolated vertices.
    pts, faces = CASES["ridge"]()
    fn = mesh.face_normals(torch.from_numpy(pts), torch.from_numpy(faces)).numpy()
    vn = mesh.MeshNormals(faces, 4, device="cpu")(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(vn[0], (fn[0] + fn[1]) / 2.0, atol=1e-6)
    assert abs(np.linalg.norm(vn[0]) - 1.0) > 1e-3
    pts, faces = CASES["degenerate"]()
    assert np.all(mesh.face_normals(torch.from_numpy(pts), torch.from_numpy(faces)).numpy() == 0.0)
    pts, faces = _random_mesh()
    assert np.isnan(mesh.MeshNormals(faces, 500, device="cpu")(torch.from_numpy(pts)).numpy()[-10:]).all()


def test_mesh_normals_degree_and_table():
    pts, faces = _fan_mesh()
    ev = mesh.MeshNormals(faces, pts.shape[0], device="cpu")
    assert ev.degree == 40 and tuple(ev.table.shape) == (41, 40)
    assert int(ev.table[1, 2]) == faces.shape[0]  # a rim vertex has 2 faces; the rest is padding


def test_mesh_normals_rejects_bad_input():
    pts, faces = CASES["triangle"]()
    with pytest.raises(ValueError, match="face ids"):
        mesh.MeshNormals(faces, 2, device="cpu")
    ev = mesh.MeshNormals(faces, 3, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ev(torch.from_numpy(pts))


def test_mesh_normals_default_to_the_card():
    """Entry points run on the card unless the caller asks for the CPU."""
    import inspect

    assert inspect.signature(mesh.MeshNormals).parameters["device"].default == "cuda"
    faces = np.array([[0, 1, 2]], np.int32)
    if torch.cuda.is_available():
        assert mesh.MeshNormals(faces, 3).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            mesh.MeshNormals(faces, 3)
