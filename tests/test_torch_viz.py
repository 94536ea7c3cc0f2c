"""The port's viz (``align3d_torch/viz``) against the JAX package's
(``align3d_tpu/viz``), on the CPU, on the same inputs made from a seed.

Tolerances, measured here:
* camera and builder matrices, ``Sphere3D`` of a numpy array, colour
  packing and the trajectory polyline: bitwise;
* ``render_points`` and ``render_mesh`` with a given camera: bitwise
  (colour and depth), planted depth ties included; meshes with
  ``normals=None`` take K5's normals (the port's ``MeshNormals``), which
  differ from JAX's ``compute_vertex_normals`` by float32 rounding: at
  most 0.1% of the covered pixels one step of the 8-bit colour off
  (measured: 0 of 12,469 on the teapot, 1 of 200,858 at 640x480);
* scenes: each node's points, colours, transform and world points
  bitwise; the scene's render with JAX's fitted camera bitwise in colour,
  and in depth up to ~10^4 points a node. Above that numpy's float32
  vector-matrix product for the perspective divisor (``vp[3, :3] @
  pts.T``) changes its arithmetic (OpenBLAS's gemv), and depths move by a
  few ulps (``DEPTH_ULPS``; measured: 3 ulps at 289 of 10,434 covered
  pixels on two sample1 frames). The
  viewers fit their camera to ``Sphere3D.from_points`` of the world points,
  numpy's own mean of a host copy, so a render through each package's own
  fit is bitwise in colour too (``FIT_SHARE``);
* the GIF: each pixel within the 3-3-2 palette's half step, ``gif.BOUND``.
"""

import math

import numpy as np
import pytest
import torch
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

import jax.numpy as jnp
from align3d_tpu import cli as jax_cli
from align3d_tpu.io.datasets import SlamTbDataset as JaxSlamTb
from align3d_tpu.io.datasets import SubsetDataset as JaxSubset
from align3d_tpu.ops.mesh import compute_vertex_normals
from align3d_tpu.trajectory import Trajectory as JaxTrajectory
from align3d_tpu.viz import dataset_viewer as jdv
from align3d_tpu.viz import datatypes as jdt
from align3d_tpu.viz import render as jrender
from align3d_tpu.viz import sphere as jsphere
from align3d_tpu.viz import viewers as jviewers
from align3d_tpu.viz import virtual_camera as jcam

from _dataset_fixtures import make_indoor_lidar_tree
from align3d_torch import cli, config
from align3d_torch.io import gif, png, read_ply
from align3d_torch.io.datasets import SlamTbDataset, SubsetDataset
from align3d_torch.trajectory import Trajectory
from align3d_torch.viz import Manager, Node, Scene, dataset_viewer, datatypes, render, sphere, viewers
from align3d_torch.viz import virtual_camera as cam

SAMPLE1 = config.ref_data_path("rgbd", "sample1")
CPU = torch.device("cpu")
W, H = 160, 120
MESH_SHARE = 1e-3  # of covered pixels, each at most one colour step off
# A render through each package's own fitted camera: the share of pixels of
# equal colour (both fit with numpy's mean of the same world points).
FIT_SHARE = 1.0
# ``odometry --show``: each package renders its own trajectory, and the two
# odometries differ by float32 rounding (up to 4e-6 in a 3-frame IndoorLidar
# pose), so a point near a pixel's edge moves (measured 0.99997).
SHOW_SHARE = 0.999
DEPTH_ULPS = 4


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({4: np.int32, 8: np.int64, 1: np.uint8}[a.dtype.itemsize])


def _equal_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(_bits(a), _bits(b))


def _camera_pair(seed: int):
    rng = np.random.default_rng(seed)
    center = rng.normal(size=3).astype(np.float32)
    radius, azimuth, elevation = float(rng.uniform(0.5, 3.0)), float(rng.uniform(0, 6.3)), float(rng.uniform(-1, 1))
    builders = []
    for mod in (jcam, cam):
        b = mod.VirtualCameraSphericalBuilder.fit(mod.Sphere3D(center.copy(), radius), math.pi / 2.0)
        b.azimuth, b.elevation, b.aspect_ratio = azimuth, elevation, W / H
        builders.append(b)
    return builders


def _jax_camera(points: np.ndarray, elevation=0.3, azimuth=0.2, width=W, height=H):
    b = jcam.VirtualCameraSphericalBuilder.fit(jsphere.Sphere3D.from_points(points), math.pi / 2.0)
    b.aspect_ratio, b.elevation, b.azimuth = width / height, elevation, azimuth
    return b.build()


def _pair_renders(width=W, height=H):
    return jrender.OffscreenRenderer(width, height), render.OffscreenRenderer(width, height, device=CPU)


# -- host camera math, spheres, colour packing --------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_camera_and_builder_matrices_bitwise(seed):
    jb, tb = _camera_pair(seed)
    assert (jb.distance, jb.fov_y, jb.near_plane_distance) == (tb.distance, tb.fov_y, tb.near_plane_distance)
    jc, tc = jb.build(), tb.build()
    for name in ("eye", "view", "up"):
        assert _equal_bits(getattr(jc, name), getattr(tc, name))
    assert _equal_bits(jc.projection.matrix(), tc.projection.matrix())
    assert _equal_bits(jc.view_matrix(), tc.view_matrix())
    assert _equal_bits(jc.view_projection(), tc.view_projection())
    for step, arg in (("translate_eye", 0.3), ("translate_right", -0.7), ("rotate_right_axis", 0.2),
                      ("rotate_up_axis", -0.4)):
        getattr(jc, step)(arg)
        getattr(tc, step)(arg)
        assert _equal_bits(jc.eye, tc.eye) and _equal_bits(jc.view, tc.view)


def test_sphere_from_numpy_union_transformed_bitwise():
    rng = np.random.default_rng(4)
    a_pts, b_pts = rng.normal(0, 1, (500, 3)), rng.normal(3, 0.5, (300, 3)).astype(np.float32)
    ja, jb = jsphere.Sphere3D.from_points(a_pts), jsphere.Sphere3D.from_points(b_pts)
    ta, tb = sphere.Sphere3D.from_points(a_pts), sphere.Sphere3D.from_points(b_pts)
    for j, t in ((ja, ta), (jb, tb), (ja.union(jb), ta.union(tb)), (jb.union(ja), tb.union(ta))):
        assert _equal_bits(j.center, t.center) and j.radius == t.radius
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [1.0, -2.0, 0.5]
    assert _equal_bits(ja.transformed(m).center, ta.transformed(m).center)
    assert sphere.Sphere3D.from_points(np.zeros((0, 3))).is_empty
    assert sphere.Sphere3D.from_points(torch.zeros((0, 3))).is_empty


def test_sphere_from_tensor_is_numpys_fit():
    """A CPU tensor's sphere is fitted with numpy's own float32 mean and
    distance: bitwise JAX's."""
    pts = np.random.default_rng(5).normal(1.0, 0.5, (20000, 3)).astype(np.float32)
    t = sphere.Sphere3D.from_points(torch.from_numpy(pts))
    j = jsphere.Sphere3D.from_points(pts)
    assert _equal_bits(t.center, j.center)
    assert t.radius == j.radius
    assert _equal_bits(sphere.numpy_means(torch.from_numpy(pts), [20000])[0].numpy(), j.center)  # K6's plain twin


def test_sphere_fit_many_is_each_sets_fit():
    """fit_many gives each set JAX's fit, an empty set the empty sphere; K6's
    plain twin takes each block of rows on its own."""
    rng = np.random.default_rng(6)
    sets = [rng.normal(c, s, (n, 3)).astype(np.float32) for c, s, n in ((1.0, 0.5, 700), (-3.0, 2.0, 1), (9.0, 0.1, 5))]
    fits = sphere.Sphere3D.fit_many([torch.from_numpy(sets[0]), torch.zeros((0, 3)), *(torch.from_numpy(p) for p in sets[1:])])
    assert fits[1].is_empty
    for got, pts in zip([fits[0], *fits[2:]], sets):
        j = jsphere.Sphere3D.from_points(pts)
        assert _equal_bits(got.center, j.center) and got.radius == j.radius
    means = sphere.numpy_means(torch.from_numpy(np.concatenate(sets)), [len(p) for p in sets]).numpy()
    assert _equal_bits(means, np.stack([p.mean(axis=0) for p in sets]))


def test_pack_unpack_color_bitwise():
    rgb = np.random.default_rng(6).integers(0, 256, (257, 3)).astype(np.uint8)
    packed = datatypes.pack_color_u8(rgb)
    assert _equal_bits(packed, jdt.pack_color_u8(rgb))
    assert _equal_bits(datatypes.unpack_color_u8(packed), jdt.unpack_color_u8(packed))
    assert int(datatypes.pack_color_u8(np.array([255, 155, 55], np.uint8))) == 0xFF9B37


def test_trajectory_polyline_bitwise():
    ds = SlamTbDataset.load(SAMPLE1)
    text = ds.trajectory().to_tum()
    ours = dataset_viewer.trajectory_polyline(Trajectory.from_tum(text))
    theirs = jdv.trajectory_polyline(JaxTrajectory.from_tum(text))
    assert ours.shape == ((len(ds) - 1) * 24 + 1, 3) and _equal_bits(ours, theirs)


# -- the rasterizer -----------------------------------------------------------

@pytest.mark.parametrize("radius", [1, 3])
def test_render_points_bitwise_with_planted_ties(radius):
    """3,000 points, 200 of them repeated with other colours (exact depth
    ties: the later point wins, as numpy's stable sort and last write), and
    a second splat over the first (the depth before the pass)."""
    rng = np.random.default_rng(radius)
    pts = rng.normal(size=(3000, 3)).astype(np.float32)
    pts[1500:1700] = pts[:200]
    cols = rng.integers(0, 256, (3000, 3)).astype(np.uint8)
    camera = _jax_camera(pts)
    jr, tr = _pair_renders()
    jt, tt = jr.new_target(), tr.new_target()
    for sl in (slice(0, 2000), slice(1000, 3000)):
        jr.render_points(jt, camera, pts[sl], cols[sl], radius)
        tr.render_points(tt, camera, torch.from_numpy(pts[sl]), torch.from_numpy(cols[sl]), radius)
    assert np.isfinite(jt.depth).sum() > 500
    assert _equal_bits(tt.color.numpy(), jt.color) and _equal_bits(tt.depth.numpy(), jt.depth)


def test_render_points_default_colour_and_points_behind():
    pts = np.random.default_rng(7).normal(size=(2000, 3)).astype(np.float32)
    camera = _jax_camera(pts[:1000], elevation=0.0)
    camera.eye = np.zeros(3, np.float32)  # half the points behind the camera
    jr, tr = _pair_renders()
    jt, tt = jr.new_target(), tr.new_target()
    jr.render_points(jt, camera, pts)
    tr.render_points(tt, camera, pts)
    assert _equal_bits(tt.color.numpy(), jt.color) and _equal_bits(tt.depth.numpy(), jt.depth)


QUAD = (np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32), np.array([[0, 1, 2], [0, 2, 3]]))


def _mesh(name):
    if name == "quad":
        return QUAD
    tea = read_ply(config.ref_data_path("teapot.ply"))
    return tea.points.astype(np.float32), tea.faces


@pytest.mark.parametrize("given", [True, False], ids=["normals", "none"])
@pytest.mark.parametrize("name,size", [("quad", (128, 96)), ("teapot", (W, H)), ("teapot", (640, 480))])
def test_render_mesh_against_jax(name, size, given):
    pts, faces = _mesh(name)
    normals = np.asarray(compute_vertex_normals(jnp.asarray(pts), jnp.asarray(faces))) if given else None
    jr, tr = _pair_renders(*size)
    for elevation in (0.4, 1.0):
        camera = _jax_camera(pts, elevation=elevation, azimuth=0.3, width=size[0], height=size[1])
        jt, tt = jr.new_target(), tr.new_target()
        jr.render_mesh(jt, camera, pts, faces, normals=normals)
        tr.render_mesh(tt, camera, pts, faces, normals=normals)
        covered = np.isfinite(jt.depth)
        assert covered.sum() > 500 and _equal_bits(tt.depth.numpy(), jt.depth)
        diff = np.abs(tt.color.numpy().astype(np.int32) - jt.color).max(axis=-1)
        if given:
            assert diff.max() == 0
        else:  # K5's normals against compute_vertex_normals
            assert diff.max() <= 1 and (diff > 0).sum() <= MESH_SHARE * covered.sum()


def test_render_mesh_over_points_and_large_boxes(monkeypatch):
    """A mesh z-tested against a point splat already in the target, and
    faces whose boxes span most of the image, enumerated in several chunks."""
    rng = np.random.default_rng(8)
    pts = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    faces = rng.integers(0, 40, (60, 3))
    cloud = rng.normal(0, 0.5, (3000, 3)).astype(np.float32)
    camera = _jax_camera(np.concatenate([pts, cloud]))
    jr, tr = _pair_renders()
    jt, tt = jr.new_target(), tr.new_target()
    jr.render_points(jt, camera, cloud)
    tr.render_points(tt, camera, cloud)
    jr.render_mesh(jt, camera, pts, faces, normals=np.ones((40, 3), np.float32))
    monkeypatch.setattr(render, "PAIR_CHUNK", 1000)
    tr.render_mesh(tt, camera, pts, faces, normals=np.ones((40, 3), np.float32))
    assert _equal_bits(tt.color.numpy(), jt.color) and _equal_bits(tt.depth.numpy(), jt.depth)


def test_renderer_refuses_a_tensor_on_another_device():
    tr = render.OffscreenRenderer(W, H, device=CPU)
    with pytest.raises(ValueError, match="renderer on cpu"):
        tr.render_points(tr.new_target(), _jax_camera(np.eye(3, dtype=np.float32)), torch.zeros((3, 3), device="meta"))


def test_scene_mesh_node_keeps_its_normals_evaluator(monkeypatch):
    """A mesh node without normals builds K5's corner table once and
    reuses it on every render, until its faces change."""
    from align3d_torch.ops import mesh

    built = []
    real = mesh.MeshNormals

    class Counting(real):
        def __init__(self, *args, **kwargs):
            built.append(1)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(mesh, "MeshNormals", Counting)
    pts, faces = _mesh("teapot")
    scene = Scene()
    node = scene.add(Node(points=torch.from_numpy(pts), faces=torch.from_numpy(faces.astype(np.int64))))
    tr = render.OffscreenRenderer(W, H, device=CPU)
    camera = _jax_camera(pts)
    first = scene.render(tr, camera)
    second = scene.render(tr, camera)
    assert len(built) == 1 and torch.equal(first.color, second.color)
    node.faces = node.faces.flip(0)
    scene.render(tr, camera)
    assert len(built) == 2


def test_scene_node_keeps_its_fitted_sphere(monkeypatch):
    """A node fits its sphere once and reuses it on every render, until its
    points are replaced or modified or its transform changes."""
    fits = []
    real = sphere.Sphere3D.from_points.__func__

    def counting(cls, points):
        fits.append(1)
        return real(cls, points)

    monkeypatch.setattr(sphere.Sphere3D, "from_points", classmethod(counting))
    v = viewers.GeoViewer(W, H, device=CPU)
    v.add(np.random.default_rng(1).normal(0, 1, (500, 3)).astype(np.float32))
    node = v.scene.nodes[0]
    first = v.render_frame()
    assert torch.equal(first.color, v.render_frame().color) and len(fits) == 1
    node.transform = node.transform.copy()  # same values: kept
    v.render_frame()
    assert len(fits) == 1
    before = v.scene.bounding_sphere()
    node.transform[0, 3] = 0.5
    moved = v.scene.bounding_sphere()
    assert len(fits) == 2 and moved.center[0] == pytest.approx(before.center[0] + 0.5, abs=1e-6)
    node.points.mul_(2.0)
    assert v.scene.bounding_sphere().radius == pytest.approx(2.0 * moved.radius, rel=1e-5) and len(fits) == 3
    node.points = node.points.clone()
    v.scene.bounding_sphere()
    assert len(fits) == 4


def test_png_of_a_render_decodes_to_its_colour(tmp_path):
    from PIL import Image

    pts = np.random.default_rng(9).normal(size=(2000, 3)).astype(np.float32)
    gv = viewers.GeoViewer(W, H, device=CPU)
    gv.add(pts, colors=np.random.default_rng(10).integers(0, 256, (2000, 3)))
    img = gv.render_frame()
    img.color[::7, :, 3] = 17  # alpha varies too
    img.save_png(tmp_path / "f.png")
    color = img.color.numpy()
    assert np.array_equal(np.asarray(Image.open(tmp_path / "f.png").convert("RGBA")), color)
    assert np.array_equal(png.read(tmp_path / "f.png"), color)


# -- scenes and viewers -------------------------------------------------------

def _geo_pair():
    rng = np.random.default_rng(11)
    jg, tg = jviewers.GeoViewer(W, H), viewers.GeoViewer(W, H, device=CPU)
    for k in range(2):
        p = rng.normal(k, 0.5, (4000, 3)).astype(np.float32)
        c = rng.integers(0, 256, (4000, 3)).astype(np.uint8)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
        m[:3, 3] = [0.1 * k, 0.0, -0.2]
        jg.add(p, colors=c, transform=m)
        tg.add(p, colors=c, transform=m)
    return jg, tg


def _hold_scene(jscene, tscene, depth_ulps: int = 0):
    """Nodes bitwise; the render with JAX's fitted camera bitwise in colour
    and within ``depth_ulps`` in depth; the two packages' fitted spheres
    bitwise."""
    assert len(jscene.nodes) == len(tscene.nodes)
    for jn, tn in zip(jscene.nodes, tscene.nodes):
        assert _equal_bits(jn.points, tn.points.numpy()) and _equal_bits(jn.transform, tn.transform)
        assert _equal_bits(jn.colors, tn.colors.numpy())
        assert _equal_bits(jn.world_points(), tn.world_points().numpy())
    camera = _jax_camera(np.concatenate([n.world_points() for n in jscene.nodes]), azimuth=0.5)
    jr, tr = _pair_renders()
    jimg, timg = jscene.render(jr, camera), tscene.render(tr, camera)
    assert _equal_bits(timg.color.numpy(), jimg.color)
    tdepth = timg.depth.numpy()
    assert np.array_equal(np.isfinite(tdepth), np.isfinite(jimg.depth))
    assert np.abs(_bits(tdepth).astype(np.int64) - _bits(jimg.depth)).max() <= depth_ulps
    js, ts = jscene.bounding_sphere(), tscene.bounding_sphere()
    assert _equal_bits(ts.center, js.center) and ts.radius == js.radius


def test_geo_viewer_against_jax():
    jg, tg = _geo_pair()
    _hold_scene(jg.scene, tg.scene)
    for az in (0.0, 1.0):
        a, b = jg.render_frame(az), tg.render_frame(az)
        assert (a.color == b.color.numpy()).all(axis=-1).mean() >= FIT_SHARE


def test_rgbd_dataset_viewer_build_scene_on_two_sample1_frames():
    jv = jviewers.RgbdDatasetViewer(JaxSubset(JaxSlamTb.load(SAMPLE1), [0, 1]), W, H)
    tv = viewers.RgbdDatasetViewer(SubsetDataset(SlamTbDataset.load(SAMPLE1), [0, 1]), W, H, device=CPU)
    jscene, tscene = jv.build_scene(), tv.build_scene()
    assert all(n.points.device == CPU for n in tscene.nodes)
    _hold_scene(jscene, tscene, DEPTH_ULPS)
    a, b = jv.viewer.render_frame(2.0), tv.viewer.render_frame(2.0)
    assert (a.color == b.color.numpy()).all(axis=-1).mean() >= FIT_SHARE


def test_visibility_toggle_and_orbit(tmp_path):
    v = viewers.GeoViewer(64, 48, device=CPU)
    v.add(np.random.default_rng(0).uniform(-1, 1, (100, 3)).astype(np.float32))
    drawn = int(np.isfinite(v.render_frame().depth.numpy()).sum())
    v.toggle_visibility(0)
    with pytest.raises(ValueError):
        v.render_frame()  # empty scene -> empty sphere -> fit raises
    v.toggle_visibility(0)
    assert int(np.isfinite(v.render_frame().depth.numpy()).sum()) == drawn
    paths = v.run(tmp_path, n_frames=3)
    assert [png.read(p).shape for p in paths] == [(48, 64, 4)] * 3


def test_manager_binds_its_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Manager.default()
    m = Manager(torch.device("cpu"))
    assert m.device_name == "cpu:0"
    assert m.renderer(64, 48).device == CPU and m.renderer(64, 48).width == 64
    assert m.geo_viewer(64, 48).renderer.device == CPU
    assert m.dataset_viewer(None, 64, 48).viewer.device == CPU
    assert Manager(torch.device("cuda", 0)).device_name == "cuda:0"


# -- the GIF, the dataset previews and the command line ------------------------

@pytest.fixture(scope="module")
def il_tree(tmp_path_factory):
    return make_indoor_lidar_tree(str(tmp_path_factory.mktemp("il_fix")))


def test_flythrough_gif_within_the_palette_bound(il_tree, tmp_path):
    from PIL import Image

    out = dataset_viewer.render_dataset_flythrough("ilrgbd", il_tree, str(tmp_path / "fly.gif"), max_frames=2,
                                                   width=64, height=48, n_views=10, device=CPU)
    viewer = dataset_viewer.posed_viewer("ilrgbd", il_tree, 2, 64, 48, None, CPU)
    img = Image.open(out)
    assert img.format == "GIF" and img.n_frames == 10
    for k, (az, el) in enumerate(dataset_viewer.flythrough_views(10)):
        img.seek(k)
        want = viewer.viewer.render_frame(azimuth=az, elevation=el).color[..., :3].numpy().astype(np.int32)
        got = np.asarray(img.convert("RGB")).astype(np.int32)
        assert (np.abs(got - want).max(axis=(0, 1)) <= np.array(gif.BOUND)).all()
        assert np.array_equal(gif.PALETTE[gif.quantize(want.astype(np.uint8))], got)
    assert gif.BOUND == (18, 18, 42)


def test_cli_viewer_png_against_jax(il_tree, tmp_path, capsys):
    from PIL import Image

    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png")
    assert cli.main(["viewer", "ilrgbd", il_tree, "-o", ours, "--max-frames", "2", "--device", "cpu"]) == 0
    assert jax_cli.main(["viewer", "ilrgbd", il_tree, "-o", theirs, "--max-frames", "2"]) == 0
    a, b = png.read(ours), np.asarray(Image.open(theirs).convert("RGBA"))
    assert a.shape == b.shape == (480, 640, 4)
    assert (a == b).all(axis=-1).mean() >= FIT_SHARE
    assert f"Wrote {ours}" in capsys.readouterr().out


def test_cli_odometry_show_png_against_jax(il_tree, tmp_path, capsys):
    from PIL import Image

    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png")
    assert cli.main(["odometry", "ilrgbd", il_tree, "3", "--no-bilateral", "-q", "--show", ours,
                     "--device", "cpu"]) == 0
    assert jax_cli.main(["odometry", "ilrgbd", il_tree, "3", "--no-bilateral", "-q", "--show", theirs]) == 0
    a, b = png.read(ours), np.asarray(Image.open(theirs).convert("RGBA"))
    assert a.shape == b.shape == (480, 640, 4)
    assert (a == b).all(axis=-1).mean() >= SHOW_SHARE
    assert f"Wrote {ours}" in capsys.readouterr().out


def test_cli_viewer_animate_writes_a_gif(il_tree, tmp_path, capsys):
    from PIL import Image

    out = tmp_path / "fly"
    assert cli.main(["viewer", "ilrgbd", il_tree, "-o", str(out), "--max-frames", "2", "--animate",
                     "--device", "cpu"]) == 0
    img = Image.open(str(out) + ".gif")
    assert img.format == "GIF" and img.n_frames == 24 and img.size == (480, 360)


def test_cli_viewer_without_cuda_raises(il_tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["viewer", "ilrgbd", il_tree, "-o", str(tmp_path / "x.png")])


def test_viz_needs_no_pillow(monkeypatch, tmp_path):
    """The preview PNG, the fly-through GIF and the interactive viewer's
    frame are written without Pillow (the card's machine may lack it)."""
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)  # any import of PIL now raises
    with pytest.raises(ImportError):
        import PIL.Image  # noqa: F401
    from align3d_torch.viz.interactive import InteractiveViewer

    dataset_viewer.render_dataset_preview("slamtb", SAMPLE1, str(tmp_path / "p.png"), max_frames=2, width=64,
                                          height=48, device=CPU)
    dataset_viewer.render_dataset_flythrough("slamtb", SAMPLE1, str(tmp_path / "f.gif"), max_frames=2, width=64,
                                             height=48, n_views=3, device=CPU)
    gv = viewers.GeoViewer(64, 48, device=CPU)
    gv.add(np.random.default_rng(12).normal(size=(300, 3)).astype(np.float32))
    frame = InteractiveViewer(gv.scene, 64, 48, device=CPU).render_png()
    assert png.read(tmp_path / "p.png").shape == (48, 64, 4) and png.decode(frame).shape == (48, 64, 4)
    assert (tmp_path / "f.gif").read_bytes()[:6] == b"GIF89a"
