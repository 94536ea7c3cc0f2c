"""The port's CUDA kernels against their plain-PyTorch twins, on the card.

Marked ``cuda``; every test skips without a CUDA device (the ``cuda_device``
fixture decides at run time, never at import). The file needs neither JAX
nor the repository's conftest, so on a GPU machine without JAX run
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``;
``chip_smoke.py`` covers the same comparisons at the main path's shapes.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from align3d_torch.icp import image_icp
from align3d_torch.icp.params import MsIcpParams
from align3d_torch.io import read_off
from align3d_torch.io.datasets import SlamTbDataset
from align3d_torch.ops import bilateral as bil
from align3d_torch.ops import icp_fused, mesh, nn_banded
from align3d_torch.ops import icp_pallas_v3 as k3
from align3d_torch.ops import icp_pallas_v4 as k4
from align3d_torch.ops.target_pack import pack_geometry
from align3d_torch.optim import gauss_newton as gn
from align3d_torch.range_image import RangeImageBuilder
from align3d_torch.se3 import Transform

pytestmark = pytest.mark.cuda

SIGMA_SPACE = bil.BilateralFilter.sigma_space
SIGMA_COLOR = bil.BilateralFilter.sigma_color
DATA = Path(__file__).resolve().parent / "data"
RGBD = DATA / "rgbd"


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _frames(sample_dir):
    rng = np.random.default_rng(3)
    ys, xs = np.meshgrid(np.arange(64), np.arange(96), indexing="ij")
    deep = (500 + 90 * xs + 40 * ys + rng.integers(0, 30, size=(64, 96))).astype(np.int32)
    deep[10:14, 20:30] = 0
    sample = SlamTbDataset.load(str(sample_dir)).get(0).image.depth.astype(np.int32)
    return {"sample1": sample, "deep": deep}


@pytest.fixture(scope="module")
def depth_frames(cuda_device):
    frames = _frames(RGBD / "sample1")
    return {k: torch.from_numpy(v).to(cuda_device) for k, v in frames.items()}


@pytest.mark.parametrize("name", ["sample1", "deep"])
def test_splat_kernel_bitwise(depth_frames, name):
    depth = depth_frames[name]
    cmin, shape, _ = bil.grid_geometry(depth, SIGMA_SPACE, SIGMA_COLOR, 16)
    args = (depth, cmin, shape, SIGMA_SPACE, SIGMA_COLOR)
    before = bil.SPLAT_LAUNCHES
    got = bil._splat(*args)
    assert bil.SPLAT_LAUNCHES == before + 1
    assert torch.equal(got, bil._splat_plain(*args))


@pytest.mark.parametrize("sigma_space", [7.0, 12.0])
@pytest.mark.parametrize("name", ["sample1", "deep"])
def test_splat_kernel_bitwise_wide_window_ragged_depth(depth_frames, name, sigma_space):
    """Windows of more than 32 taps per column (49 and 144: the warp takes
    them in 32-tap chunks) at an unpadded, ragged grid depth, under both
    color_min conventions."""
    depth = depth_frames[name]
    gh, gw = bil._grid_dims(*depth.shape, sigma_space)
    taps = bil._splat_tables(*depth.shape, gh, gw, sigma_space, depth.device)
    assert taps[0].shape[1] * taps[2].shape[1] > 32
    for cmin in (int(depth.min()), int(depth[depth > 0].min())):
        gd = bil.true_depth(cmin, int(depth.max()), SIGMA_COLOR) | 1  # odd: no column is 16-B aligned throughout
        args = (depth, cmin, (gh, gw, gd), sigma_space, SIGMA_COLOR)
        before = bil.SPLAT_LAUNCHES
        got = bil._splat(*args)
        assert bil.SPLAT_LAUNCHES == before + 1
        assert torch.equal(got, bil._splat_plain(*args))


def test_splat_kernel_bitwise_rounding_sums(cuda_device):
    """Depths in [2^22, 2^23): a window's sum passes 2^24 and rounds in
    float32, so the kernel takes its ordered path; still bitwise."""
    rng = np.random.default_rng(7)
    depth = rng.integers(1 << 22, 1 << 23, size=(48, 64))
    depth[3:6, 4:9] = 0
    depth = torch.from_numpy(depth.astype(np.int32)).to(cuda_device)
    sigma_color = 2.0e5  # ~21 channels over the span
    for sigma_space in (SIGMA_SPACE, 7.0):
        gh, gw = bil._grid_dims(*depth.shape, sigma_space)
        cmin = int(depth[depth > 0].min())
        args = (depth, cmin, (gh, gw, bil.true_depth(cmin, int(depth.max()), sigma_color)), sigma_space, sigma_color)
        assert torch.equal(bil._splat(*args), bil._splat_plain(*args))


@pytest.mark.parametrize("name", ["sample1", "deep"])
def test_slice_kernel_matches_plain(depth_frames, name):
    depth = depth_frames[name]
    grid = bil.BilateralGrid.from_image(depth, SIGMA_SPACE, SIGMA_COLOR, 16).convolve().normalize()
    args = (grid.data_cm, depth, grid.color_min, SIGMA_SPACE, SIGMA_COLOR)
    before = bil.SLICE_LAUNCHES
    got = bil._slice(*args)
    assert bil.SLICE_LAUNCHES == before + 1
    # Bitwise: the kernel's form (a) uses round-to-nearest intrinsics in the
    # plain op order.
    assert torch.equal(got, bil._slice_plain(*args))


@pytest.mark.parametrize("name", ["sample1", "deep", "odd_width", "two_segments", "two_segments_odd"])
def test_normalize_slice_kernel_bitwise(depth_frames, name):
    """Form (b) on the blurred grid equals normalize, form (a) and the cast,
    bitwise; also where a row is no whole number of 4-pixel groups, and
    where a row spans two blocks' segments (1,024 pixels each)."""
    sample = depth_frames["sample1"]
    depth = {"odd_width": sample[:, :637], "two_segments": torch.cat([sample, sample], dim=1)[:240],
             "two_segments_odd": torch.cat([sample, sample], dim=1)[:240, :1282]}.get(name, depth_frames.get(name))
    depth = depth.contiguous()
    grid = bil.BilateralGrid.from_image(depth, SIGMA_SPACE, SIGMA_COLOR, 16).convolve()
    args = (grid.data_cm, depth, grid.color_min, SIGMA_SPACE, SIGMA_COLOR)
    before = (bil.NORMALIZE_SLICE_LAUNCHES, bil.NORMALIZE_PASSES)
    got = bil._normalize_slice(*args)
    assert (bil.NORMALIZE_SLICE_LAUNCHES, bil.NORMALIZE_PASSES) == (before[0] + 1, before[1])
    assert got.dtype == torch.int32
    assert torch.equal(got, bil._normalize_slice_plain(*args))
    assert torch.equal(got, grid.normalize().slice(depth))
    assert torch.equal(got, bil.BilateralFilter().filter(depth))


@pytest.fixture(scope="module")
def pyramids(cuda_device):
    ds = SlamTbDataset.load(str(RGBD / "sample2"))
    builder = RangeImageBuilder(bilateral_filter=bil.BilateralFilter())
    return builder.build(ds.get(0), cuda_device), builder.build(ds.get(1), cuda_device)


def _step_args(tgt, src, pose, params):
    n = tgt.height * tgt.width
    return (
        pose.rotation[None].contiguous(), pose.translation[None].contiguous(),
        src.points.reshape(1, n, 3).contiguous(), src.mask.reshape(1, n).to(torch.uint8),
        src.intensities.reshape(1, n).contiguous(),
        pack_geometry(tgt.points, tgt.normals, tgt.mask)[None], tgt.intensity_map[None].contiguous(),
        tgt.height, tgt.width, tgt.intrinsics, params,
    )


@pytest.mark.parametrize("huber", [None, 0.004])
@pytest.mark.parametrize("level", [0, 1, 2])
def test_icp_step_kernel_matches_plain(pyramids, cuda_device, level, huber):
    tgt, src = pyramids[0][level], pyramids[1][level]
    params = MsIcpParams.default()[level].replace(huber_delta=huber)
    pose = Transform.exp(torch.tensor([0.02, -0.01, 0.006, 0.004, -0.008, 0.002], device=cuda_device))
    args = _step_args(tgt, src, pose, params)
    got, ref = icp_fused.icp_step_fused(*args), icp_fused.icp_step_plain(*args)
    valid = int(src.mask.sum())
    for g, r in zip(got[0], ref[0]):
        # Count within 0.01% of the valid pixels; H and g within
        # 1e-4 x max|entry|; sum w r^2 within rtol 1e-4.
        assert abs(float(g[7, 7]) - float(r[7, 7])) <= 1e-4 * valid
        assert float((g[:6, :6] - r[:6, :6]).abs().max()) <= 1e-4 * float(r[:6, :6].abs().max())
        assert float((g[:6, 6] - r[:6, 6]).abs().max()) <= 1e-4 * float(r[:6, 6].abs().max())
        assert abs(float(g[6, 6]) - float(r[6, 6])) <= 1e-4 * float(r[6, 6])
    # No float atomics: a rerun is bitwise identical.
    assert torch.equal(icp_fused.icp_step_fused(*args), got)


def test_icp_step_kernel_batch_equals_single(pyramids, cuda_device):
    tgt, src = pyramids[0][1], pyramids[1][1]
    params = MsIcpParams.default()[1]
    poses = [Transform.exp(torch.tensor(t, device=cuda_device)) for t in ([0.0] * 6, [0.01, 0, 0, 0, 0.003, 0])]
    singles = [icp_fused.icp_step_fused(*_step_args(tgt, src, p, params)) for p in poses]
    one = _step_args(tgt, src, poses[0], params)
    batched = icp_fused.icp_step_fused(
        torch.cat([p.rotation[None] for p in poses]), torch.cat([p.translation[None] for p in poses]),
        *(torch.cat([a, a]) for a in one[2:7]), *one[7:],
    )
    assert torch.equal(batched, torch.cat(singles))


@pytest.mark.parametrize("case", ["at", "inside", "outside", "nan"])
def test_icp_step_kernel_gate_boundary(cuda_device, case):
    """K1 against its twin with the normal-angle gate exactly on its
    threshold (tests/_torch_gate_cases.py; the CPU twin is held against JAX
    there, tests/test_torch_gates.py): rejected at angle >= threshold, kept
    at a NaN angle. The threshold is arccos(c) as the card rounds it."""
    from align3d_torch.camera import CameraIntrinsics
    from _torch_gate_cases import COSINE, H, IMAGE_KEEPS, INTRINSICS, W, dot_cases, image_inputs

    thr = float(torch.arccos(torch.tensor(COSINE, device=cuda_device)))
    dot = dot_cases()[case]
    angle = float(torch.arccos(torch.tensor(dot, device=cuda_device)))
    assert {"at": angle == thr, "inside": angle < thr, "outside": angle > thr, "nan": angle != angle}[case]
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in image_inputs(dot).items()}
    params = MsIcpParams.default()[0].replace(max_normal_angle=thr)
    args = (torch.eye(3, device=cuda_device)[None], torch.zeros((1, 3), device=cuda_device), t["points"][None],
            t["mask"][None].to(torch.uint8), t["intensity"][None],
            pack_geometry(t["target_points"], t["target_normals"], t["target_mask"])[None],
            t["intensity_map"][None].contiguous(), H, W, CameraIntrinsics(**INTRINSICS, width=W, height=H), params)
    before = icp_fused.LAUNCHES
    got = icp_fused.icp_step_fused(*args)
    assert icp_fused.LAUNCHES == before + 1
    ref = icp_fused.icp_step_plain(*args)
    assert float(got[0, 0, 7, 7]) == float(ref[0, 0, 7, 7]) == float(IMAGE_KEEPS[case])
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


def test_wrappers_reject_bad_inputs(depth_frames):
    depth = depth_frames["deep"]
    with pytest.raises(ValueError):
        bil._splat(depth.float(), 0, (20, 25, 16), SIGMA_SPACE, SIGMA_COLOR)
    with pytest.raises(ValueError):
        bil._slice(torch.zeros(2, 4, 4, 4, device=depth.device), depth.t(), 0, SIGMA_SPACE, SIGMA_COLOR)


# -- K4: banded sorted-grid NN ----------------------------------------------------


def _grid_and_queries(device, n_db, n_q, cell, seed):
    rng = np.random.default_rng(seed)
    db = rng.uniform(0, 1, (n_db, 3)).astype(np.float32)
    nrm = rng.normal(size=(n_db, 3)).astype(np.float32)
    q = np.concatenate([db[rng.integers(0, n_db, n_q // 2)] + rng.normal(0, 0.005, (n_q // 2, 3)),
                        rng.uniform(-0.2, 1.2, (n_q - n_q // 2, 3))]).astype(np.float32)
    grid = nn_banded.SortedGrid.build(torch.from_numpy(db).to(device), cell, normals=torch.from_numpy(nrm).to(device))
    return grid, torch.from_numpy(q).to(device)


def _search_args(grid, queries, band_width, anchor_min):
    """K4's arguments as nearest_banded (first cell of a block) or
    associate_p2p (block minimum) make them."""
    lin = grid.cell_ids(queries)
    order = torch.argsort(lin, stable=True)
    q_s = queries[order]
    qplanes, bstarts, bw = nn_banded.search_inputs(grid, lin[order], q_s[:, 0], q_s[:, 1], q_s[:, 2],
                                                   band_width, anchor_min)
    return grid.planes, qplanes, bstarts, bw


# Bands of 1, 3, 4, 5 and 8 tiles: the kernel stages 4 tiles at a time.
@pytest.mark.parametrize("payload", [False, True])
@pytest.mark.parametrize("band_width", [128, 384, 512, 640, 1024])
@pytest.mark.parametrize("n_db, n_q", [(20000, 999), (300, 130)])  # ragged Q; a DB smaller than the band
def test_nn_banded_kernel_bitwise(cuda_device, n_db, n_q, band_width, payload):
    grid, queries = _grid_and_queries(cuda_device, n_db, n_q, 0.05, seed=n_db + band_width)
    args = _search_args(grid, queries, band_width, anchor_min=payload)
    before = nn_banded.LAUNCHES
    got = nn_banded.band_search(*args, payload)
    assert nn_banded.LAUNCHES == before + 1
    ref = nn_banded.band_search_plain(*args, payload)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert (got[2] is None) == (not payload)
    if payload:
        assert torch.equal(got[2], ref[2])
    # No atomics: a rerun is bitwise identical.
    again = nn_banded.band_search(*args, payload)
    assert all(a is None or torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("band_width", [512, 640])
def test_nn_banded_kernel_bitwise_tied_duplicates(cuda_device, band_width):
    """Each DB point three times at different sorted positions: every score
    ties at least three ways, and the smallest position must win in the
    kernel as in the twin, also across overlapping bands."""
    rng = np.random.default_rng(4)
    db = np.repeat(rng.uniform(0, 1, (4000, 3)).astype(np.float32), 3, axis=0)[rng.permutation(12000)]
    grid = nn_banded.SortedGrid.build(torch.from_numpy(db).to(cuda_device), 0.05,
                                      normals=torch.from_numpy(rng.normal(size=db.shape).astype(np.float32)).to(cuda_device))
    queries = torch.from_numpy(db[:1500] + np.float32(0.001)).to(cuda_device)
    for payload in (False, True):
        args = _search_args(grid, queries, band_width, anchor_min=payload)
        got, ref = nn_banded.band_search(*args, payload), nn_banded.band_search_plain(*args, payload)
        assert all(a is None and b is None or torch.equal(a, b) for a, b in zip(got, ref))


def test_nn_banded_ptxas_report(cuda_device):
    """K4's -Xptxas -v report: registers and shared memory, no spills."""
    from align3d_torch import _kernels

    _kernels.lib()
    lines = _kernels.ptxas_report("nn_banded")
    assert any("registers" in line for line in lines), lines
    assert all("spill" not in line or "0 bytes spill stores, 0 bytes spill loads" in line for line in lines), lines


def test_banded_ptxas_report(cuda_device):
    """K7's and K8's -Xptxas -v report (``icp_banded_kernel<false>`` and
    ``<true>``): registers and shared memory of both, no spills."""
    from align3d_torch import _kernels

    _kernels.lib()
    lines = _kernels.ptxas_report("icp_banded_kernel")
    entries = [line for line in lines if "Compiling entry function" in line]
    assert len(entries) == 2 and all(any(t in line for line in entries) for t in ("ILb0E", "ILb1E")), lines
    assert sum("registers" in line and "smem" in line for line in lines) == 2, lines
    assert all("spill" not in line or "0 bytes spill stores, 0 bytes spill loads" in line for line in lines), lines


def test_nn_banded_grid_and_search_match_cpu(cuda_device):
    """The whole search on the card (grid build, sort, K4) equals the CPU
    path (the same build, the plain twin) bitwise."""
    grid, queries = _grid_and_queries(cuda_device, 20000, 3000, 0.05, seed=5)
    cpu_grid, cpu_queries = _grid_and_queries(torch.device("cpu"), 20000, 3000, 0.05, seed=5)
    for name in ("planes", "orig_idx", "starts"):
        assert torch.equal(getattr(grid, name).cpu(), getattr(cpu_grid, name)), name
    idx, sq = nn_banded.nearest_banded(grid, queries)
    cpu_idx, cpu_sq = nn_banded.nearest_banded(cpu_grid, cpu_queries)
    assert torch.equal(idx.cpu(), cpu_idx) and torch.equal(sq.cpu(), cpu_sq)


def test_nn_banded_rejects_bad_inputs(cuda_device):
    grid, queries = _grid_and_queries(cuda_device, 2000, 256, 0.05, seed=1)
    planes, qplanes, bstarts, bw = _search_args(grid, queries, 512, anchor_min=False)
    bad = [
        (planes, qplanes.cpu(), bstarts),  # device
        (planes.double(), qplanes, bstarts),  # dtype
        (planes, qplanes, bstarts.long()),  # dtype
        (planes, qplanes[:, :200], bstarts),  # not whole blocks
        (planes, qplanes.t().contiguous().t(), bstarts),  # not contiguous
    ]
    for args in bad:
        with pytest.raises(ValueError):
            nn_banded.band_search(*args, bw, False)
    with pytest.raises(ValueError):
        nn_banded.band_search(planes, qplanes, bstarts, 100, False)  # not whole tiles


# -- K5: mesh vertex normals ---------------------------------------------------------


def _grid_mesh(side, freq):
    ys, xs = np.meshgrid(np.arange(side + 1), np.arange(side + 1), indexing="ij")
    zs = np.sin(xs * freq) * np.cos(ys * freq)
    pts = np.stack([xs, ys, zs], axis=-1).reshape(-1, 3).astype(np.float32)
    faces = []
    for r in range(side):
        base, a = r * (side + 1), np.arange(side)
        faces.append(np.stack([base + a, base + a + 1, base + side + 1 + a], 1))
        faces.append(np.stack([base + a + 1, base + side + 2 + a, base + side + 1 + a], 1))
    return pts, np.concatenate(faces).astype(np.int32)


def _meshes():
    rng = np.random.default_rng(1)
    teapot = read_off(str(DATA / "teapot.off"))
    ang = np.linspace(0.0, 2 * np.pi, 40, endpoint=False)
    fan_pts = np.concatenate([[[0.0, 0.0, 0.5]], np.stack([np.cos(ang), np.sin(ang), 0.1 * np.sin(3 * ang)], 1)])
    i = np.arange(40)
    return {
        "teapot": (teapot.points, teapot.faces.astype(np.int32)),
        "grid320": _grid_mesh(320, 0.1),  # 204,800 faces
        "random_isolated": (rng.normal(size=(500, 3)).astype(np.float32),
                            rng.integers(0, 490, (900, 3)).astype(np.int32)),
        "fan_degree40": (fan_pts.astype(np.float32),
                         np.stack([np.zeros(40, np.int64), 1 + i, 1 + (i + 1) % 40], 1).astype(np.int32)),
    }


def _same_bits(a, b):
    """Equal bit for bit, the sign of zero included; NaN at the same places
    (0/0 gives another NaN pattern on the card than on the CPU)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


@pytest.mark.parametrize("name", ["teapot", "grid320", "random_isolated", "fan_degree40"])
def test_mesh_kernel_bitwise(cuda_device, name):
    pts, faces = _meshes()[name]
    ev = mesh.MeshNormals(faces, pts.shape[0], device=cuda_device)
    points = torch.from_numpy(pts).to(cuda_device)
    before = mesh.LAUNCHES
    got = ev(points)
    assert mesh.LAUNCHES == before + 1
    ref = mesh.vertex_normals_plain(points, ev.table, ev.counts)
    # Bitwise with the sign of zero, NaN at the same (isolated) vertices.
    assert _same_bits(got, ref)
    assert _same_bits(ev(points), got)
    assert _same_bits(mesh.vertex_normals(points, ev.table, ev.counts), got)
    # And the CPU evaluator gives the same, bitwise.
    cpu = mesh.MeshNormals(faces, pts.shape[0], device="cpu")(torch.from_numpy(pts))
    assert _same_bits(got.cpu(), cpu)


def test_mesh_kernel_is_one_launch(cuda_device):
    """A MeshNormals call issues one launch of K5 and no other device work."""
    from align3d_torch.tools.roofline import device_ms

    pts, faces = _meshes()["grid320"]
    ev = mesh.MeshNormals(faces, pts.shape[0], device=cuda_device)
    points = torch.from_numpy(pts).to(cuda_device)
    ms, acts = device_ms(lambda: ev(points), 10, "mesh_normals")  # raises on any other activity
    assert ms is not None and 1 <= len(acts) <= 10


def test_mesh_kernel_bitwise_3m_faces(cuda_device):
    """The 3,276,800-face grid (side 1280, 1,640,961 vertices, degree 6)."""
    pts, faces = _grid_mesh(1280, 0.1)
    ev = mesh.MeshNormals(faces, pts.shape[0], device=cuda_device)
    assert ev.degree == 6 and tuple(ev.table.shape) == (6, 1_640_961, 2)
    points = torch.from_numpy(pts).to(cuda_device)
    assert _same_bits(ev(points), mesh.vertex_normals_plain(points, ev.table, ev.counts))


def test_mesh_kernel_padding_adds_positive_zero(cuda_device):
    """Flat second triangles only (tests/test_torch_mesh.py): -0.0 sums stay
    -0.0 at full-degree vertices and become +0.0 where a slot pads."""
    side = 40
    pts, faces = _grid_mesh(side, 0.1)
    pts[:, 2] = 0.0
    faces = faces.reshape(side, 2, side, 3)[:, 1].reshape(-1, 3)
    ev = mesh.MeshNormals(faces, pts.shape[0], device=cuda_device)
    points = torch.from_numpy(pts).to(cuda_device)
    got = ev(points)
    assert _same_bits(got, mesh.vertex_normals_plain(points, ev.table, ev.counts))
    zero = got == 0.0
    full = (ev.counts == ev.degree)[:, None] & zero
    padded = ((ev.counts > 0) & (ev.counts < ev.degree))[:, None] & zero
    assert torch.signbit(got[full]).any() and not torch.signbit(got[padded]).any()


def test_mesh_kernel_rejects_bad_inputs(cuda_device):
    pts, faces = _meshes()["teapot"]
    ev = mesh.MeshNormals(faces, pts.shape[0], device=cuda_device)
    points = torch.from_numpy(pts).to(cuda_device)
    # The evaluator checks the points on every call ...
    for bad in (points.double(), points[:-1].contiguous(), points.t().contiguous().t(), points.cpu()):
        with pytest.raises(ValueError):
            ev(bad)
    # ... and the free function every tensor: dtype, layout ((D, N, 2), not
    # (N, D, 2)), contiguity, device.
    with pytest.raises(ValueError):
        mesh.vertex_normals(points.double(), ev.table, ev.counts)
    with pytest.raises(ValueError):
        mesh.vertex_normals(points, ev.table.long(), ev.counts)
    with pytest.raises(ValueError):
        mesh.vertex_normals(points, ev.table.transpose(0, 1).contiguous(), ev.counts)
    with pytest.raises(ValueError):
        mesh.vertex_normals(points.t().contiguous().t(), ev.table, ev.counts)
    with pytest.raises(ValueError):
        mesh.vertex_normals(points, ev.table.cpu(), ev.counts)
    with pytest.raises(ValueError):
        mesh.vertex_normals(points, ev.table, ev.counts[:-1])
    before = mesh.LAUNCHES
    ev(points)
    assert mesh.LAUNCHES == before + 1


def test_mesh_ptxas_report(cuda_device):
    """K5's -Xptxas -v report: registers, no spills."""
    from align3d_torch import _kernels

    _kernels.lib()
    lines = _kernels.ptxas_report("mesh_normals")
    assert any("registers" in line for line in lines), lines
    assert all("spill" not in line or "0 bytes spill stores, 0 bytes spill loads" in line for line in lines), lines


# -- the throughput path: K2/K3 over a batch, K1 at batch 64 ------------------------


def _series_depths(device, frames=12):
    from align3d_torch.tools import series

    mixed = series.mixed_frames()
    pick = list(range(frames // 2)) + list(range(31, 31 + frames // 2))  # sample1 and sample2 frames
    return torch.from_numpy(mixed.depths[pick].astype(np.int32)).to(device)


def test_batched_splat_and_slice_bitwise_against_single_frames(cuda_device):
    depths = _series_depths(cuda_device)
    filt = bil.BilateralFilter()
    cmin, cmax = bil.nonzero_min_max(depths)
    gd = max(bil.true_depth(lo, hi, filt.sigma_color) for lo, hi in zip(cmin.tolist(), cmax.tolist()))
    assert gd > 128
    gh, gw = bil._grid_dims(*depths.shape[-2:], filt.sigma_space)
    before = (bil.SPLAT_LAUNCHES, bil.SLICE_LAUNCHES)
    grids = bil._splat(depths, cmin, (gh, gw, gd), filt.sigma_space, filt.sigma_color)
    norm = bil._normalize(bil._blur(grids, gd))
    sliced = bil._slice(norm, depths, cmin, filt.sigma_space, filt.sigma_color)
    assert (bil.SPLAT_LAUNCHES, bil.SLICE_LAUNCHES) == (before[0] + 1, before[1] + 1)
    for b in range(depths.shape[0]):
        one = bil._splat(depths[b], int(cmin[b]), (gh, gw, gd), filt.sigma_space, filt.sigma_color)
        assert torch.equal(one, grids[b])
        assert torch.equal(bil._slice(norm[b].contiguous(), depths[b], int(cmin[b]), filt.sigma_space,
                                      filt.sigma_color), sliced[b])
    # The batched slice at B >= 3, gd > 128 against its plain twin.
    assert torch.equal(sliced, bil._slice_plain(norm, depths, cmin, filt.sigma_space, filt.sigma_color))


def test_batched_normalize_slice_bitwise_against_single_frames(cuda_device):
    """Form (b) over 12 frames at gd > 128 in one launch: bitwise its plain
    twin and each frame's own launch."""
    depths = _series_depths(cuda_device)
    filt = bil.BilateralFilter()
    cmin, cmax = bil.nonzero_min_max(depths)
    gd = max(bil.true_depth(lo, hi, filt.sigma_color) for lo, hi in zip(cmin.tolist(), cmax.tolist()))
    gh, gw = bil._grid_dims(*depths.shape[-2:], filt.sigma_space)
    grids = bil._blur(bil._splat(depths, cmin, (gh, gw, gd), filt.sigma_space, filt.sigma_color), gd)
    before = bil.NORMALIZE_SLICE_LAUNCHES
    got = bil._normalize_slice(grids, depths, cmin, filt.sigma_space, filt.sigma_color)
    assert bil.NORMALIZE_SLICE_LAUNCHES == before + 1
    assert torch.equal(got, bil._normalize_slice_plain(grids, depths, cmin, filt.sigma_space, filt.sigma_color))
    for b in range(depths.shape[0]):
        one = bil._normalize_slice(grids[b].contiguous(), depths[b], int(cmin[b]), filt.sigma_space, filt.sigma_color)
        assert torch.equal(one, got[b])


def test_bucketed_filter_bitwise_against_per_frame(cuda_device):
    depths = _series_depths(cuda_device, 6)
    filt = bil.BilateralFilter()
    cmin, cmax = bil.nonzero_min_max(depths)
    plan = bil.plan_depth_buckets(cmin.cpu().numpy(), cmax.cpu().numpy(), filt.sigma_color)
    assert len(plan) >= 2
    out = filt.filter_static_buckets(depths, cmin, plan)
    for b in range(depths.shape[0]):
        gd = bil.true_depth(int(cmin[b]), int(cmax[b]), filt.sigma_color)
        assert torch.equal(filt.filter_static(depths[b], int(cmin[b]), gd, gd), out[b])


def test_icp_step_batch64_bitwise_against_single(cuda_device):
    from align3d_torch.icp.image_icp import prepack_batched
    from align3d_torch.tools.series import real_pairs

    sources, targets = real_pairs(64, cuda_device)
    n = targets.height * targets.width
    packed = prepack_batched(
        sources.points.reshape(64, n, 3), sources.mask.reshape(64, n), sources.intensities.reshape(64, n),
        targets.points.reshape(64, n, 3), targets.mask.reshape(64, n), targets.normals.reshape(64, n, 3),
        targets.intensity_map,
    )
    pose = Transform.exp(torch.tensor([0.004, -0.002, 0.003, 0.002, -0.003, 0.001], device=cuda_device))
    rot, trans = pose.rotation.expand(64, 3, 3).contiguous(), pose.translation.expand(64, 3).contiguous()
    params = MsIcpParams.default()[0]
    batched = icp_fused.icp_step_fused(rot, trans, *packed, targets.intrinsics, params)
    for b in range(64):
        one = icp_fused.icp_step_fused(rot[b:b + 1], trans[b:b + 1], *(t[b:b + 1] for t in packed[:5]),
                                       *packed[5:], targets.intrinsics, params)
        assert torch.equal(one[0], batched[b]), b


def test_icp_step_kernel_gate_counts_equal_twin(cuda_device):
    """K1's per-pixel arithmetic is its twin's (-fmad=false, the twin's
    order), so across the 64 real pairs at three poses every gate decides
    as the twin's does: both systems' counts are equal, and the sums stay
    within 1e-4 of the twin's largest entry. Huber off: the weight sum at
    [7, 7] is then a count, exact in any order of addition."""
    from align3d_torch.icp.image_icp import prepack_batched
    from align3d_torch.tools.series import real_pairs

    sources, targets = real_pairs(64, cuda_device)
    n = targets.height * targets.width
    packed = prepack_batched(
        sources.points.reshape(64, n, 3), sources.mask.reshape(64, n), sources.intensities.reshape(64, n),
        targets.points.reshape(64, n, 3), targets.mask.reshape(64, n), targets.normals.reshape(64, n, 3),
        targets.intensity_map,
    )
    params = MsIcpParams.default()[0].replace(huber_delta=None)
    for twist in ([0.0] * 6, [0.004, -0.002, 0.003, 0.002, -0.003, 0.001], [-0.01, 0.006, 0.002, 0.008, 0.0, -0.004]):
        pose = Transform.exp(torch.tensor(twist, device=cuda_device))
        rot, trans = pose.rotation.expand(64, 3, 3).contiguous(), pose.translation.expand(64, 3).contiguous()
        args = (rot, trans, *packed, targets.intrinsics, params)
        got, ref = icp_fused.icp_step_fused(*args), icp_fused.icp_step_plain(*args)
        assert torch.equal(got[:, :, 7, 7], ref[:, :, 7, 7]), twist
        for s in range(2):
            g, r = got[:, s, :7, :7], ref[:, s, :7, :7]
            assert bool(((g - r).abs().amax((-1, -2)) <= 1e-4 * r.abs().amax((-1, -2))).all()), (twist, s)


def test_icp_step_kernel_rearms_across_batch_sizes(cuda_device):
    """K1 launched back to back at B = 64, 1, 3, 64: each call is bitwise a
    repeat of itself (the last block of each pair re-arms its arrival
    counter), and each pair's blocks are bitwise its blocks at B = 64."""
    from align3d_torch.icp.image_icp import prepack_batched
    from align3d_torch.tools.series import real_pairs

    sources, targets = real_pairs(64, cuda_device)
    n = targets.height * targets.width
    packed = prepack_batched(
        sources.points.reshape(64, n, 3), sources.mask.reshape(64, n), sources.intensities.reshape(64, n),
        targets.points.reshape(64, n, 3), targets.mask.reshape(64, n), targets.normals.reshape(64, n, 3),
        targets.intensity_map,
    )
    pose = Transform.exp(torch.tensor([0.004, -0.002, 0.003, 0.002, -0.003, 0.001], device=cuda_device))
    rot, trans = pose.rotation.expand(64, 3, 3).contiguous(), pose.translation.expand(64, 3).contiguous()
    params = MsIcpParams.default()[0]

    def step(b):
        return icp_fused.icp_step_fused(rot[:b], trans[:b], *(t[:b] for t in packed[:5]), *packed[5:],
                                        targets.intrinsics, params)

    before = icp_fused.LAUNCHES
    first = step(64)
    for b in (64, 1, 3, 64):
        got = step(b)
        assert torch.equal(got, step(b)), b
        assert torch.equal(got, first[:b]), b
    assert icp_fused.LAUNCHES == before + 9
    torch.cuda.synchronize()
    assert not icp_fused._ARRIVALS[(rot.device, torch.cuda.current_stream().cuda_stream)].any()

    # Two side streams at once, each with its own counters: every launch is
    # still bitwise the default stream's result.
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    outs = {}
    torch.cuda.synchronize()
    for _ in range(3):
        for s in streams:
            with torch.cuda.stream(s):
                outs.setdefault(s.cuda_stream, []).append(step(64))
    torch.cuda.synchronize()
    assert all(torch.equal(got, first) for runs in outs.values() for got in runs)
    assert all(not icp_fused._ARRIVALS[(rot.device, s.cuda_stream)].any() for s in streams)


# -- K7, K8: the banded GN step ----------------------------------------------------

BANDED = {"v3": (k3, lambda *a: k3.icp_step_pallas_batched(*a, emit_stats=True)), "v4": (k4, k4.icp_step_pallas_batched)}


def _banded_args(mod, tgt, src, pose, params, bsz=1, empty_source=False):
    """Packs, poses and bases of ``bsz`` copies of one pair (or B pairs when
    the range images are batched) for K7/K8 at ``pose``; with
    ``empty_source`` the source mask is all False."""
    lead = tgt.points.shape[:-3]
    b = lead[0] if lead else 1
    h, w = tgt.height, tgt.width
    src_mask = src.mask.reshape(b, h, w)
    sp = k3.pack_source(src.points.reshape(b, h, w, 3), torch.zeros_like(src_mask) if empty_source else src_mask,
                        src.intensities.reshape(b, h, w))
    tp = mod.pack_target(tgt.points.reshape(b, h, w, 3), tgt.normals.reshape(b, h, w, 3),
                         tgt.mask.reshape(b, h, w), tgt.intensity_map.reshape(b, h + 2, w + 2))
    if bsz > b:
        sp, tp = sp.expand(bsz, *sp.shape[1:]).contiguous(), tp.expand(bsz, *tp.shape[1:]).contiguous()
    rot = pose.rotation.expand(bsz, 3, 3).contiguous()
    trans = pose.translation.expand(bsz, 3).contiguous()
    bases = k3.predict_bases_centroid_batched(rot, trans, k3.source_centroids_batched(sp, tgt.intrinsics),
                                              tgt.intrinsics, sp.shape[1] * k3.CHUNK)
    return (rot, trans, *bases, sp, tp, tgt.intrinsics, h, w, k3.params_to_tuple(params))


@pytest.mark.parametrize("huber", [None, 0.004])
@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("variant", ["v3", "v4"])
def test_banded_kernel_matches_plain(pyramids, cuda_device, variant, level, huber):
    """K7/K8 against their twins on the card, at the default_tpu level's band
    radius: the per-pixel arithmetic is the twin's (no contraction), so the
    gate counts are equal and K7's stats bitwise; H, g and sum w r^2 (sums in
    another order) within 1e-4 x max|entry|."""
    mod, step = BANDED[variant]
    tgt, src = pyramids[0][level], pyramids[1][level]
    params = MsIcpParams.default_tpu("pallas")[level].replace(huber_delta=huber)
    pose = Transform.exp(torch.tensor([0.02, -0.01, 0.006, 0.004, -0.008, 0.002], device=cuda_device))
    args = _banded_args(mod, tgt, src, pose, params)
    before = mod.LAUNCHES
    got = step(*args)
    assert mod.LAUNCHES == before + 1
    ref = mod.icp_step_plain(*args, **({"emit_stats": True} if variant == "v3" else {}))
    for g, r in zip(got[:2], ref[:2]):
        g, r = g[0], r[0]
        count_gap = abs(float(g[7, 7]) - float(r[7, 7]))
        assert count_gap == 0.0 if huber is None else count_gap <= 1e-4 * float(r[7, 7])
        assert float((g[:6, :6] - r[:6, :6]).abs().max()) <= 1e-4 * float(r[:6, :6].abs().max())
        assert float((g[:6, 6] - r[:6, 6]).abs().max()) <= 1e-4 * float(r[:6, 6].abs().max())
        assert abs(float(g[6, 6]) - float(r[6, 6])) <= 1e-4 * float(r[6, 6])
    if variant == "v3":
        assert torch.equal(got[2], ref[2])
    # No float atomics: a rerun is bitwise identical.
    again = step(*args)
    assert all(torch.equal(a, b) for a, b in zip(again[:2], got[:2]))


@pytest.mark.parametrize("variant", ["v3", "v4"])
def test_banded_kernel_batch64_bitwise_against_single(cuda_device, variant):
    """K7/K8 at B = 64 real pairs, each pair's blocks bitwise its B = 1
    blocks; then launched back to back at B = 64, 1, 3, 64, each call bitwise
    the first (the last block of each pair re-arms its counter)."""
    from align3d_torch.tools.series import real_pairs

    mod, step = BANDED[variant]
    sources, targets = real_pairs(64, cuda_device)
    pose = Transform.exp(torch.tensor([0.004, -0.002, 0.003, 0.002, -0.003, 0.001], device=cuda_device))
    args = _banded_args(mod, targets, sources, pose, MsIcpParams.default_tpu("pallas")[0], 64)
    batched = step(*args)
    for b in range(64):
        one = step(*(a[b:b + 1] for a in args[:7]), *args[7:])
        assert all(torch.equal(o[0], x[b]) for o, x in zip(one, batched)), b
    for b in (64, 1, 3, 64):
        got = step(*(a[:b] for a in args[:7]), *args[7:])
        assert all(torch.equal(o, x[:b]) for o, x in zip(got, batched)), b
    torch.cuda.synchronize()
    assert not icp_fused._ARRIVALS[(args[0].device, torch.cuda.current_stream().cuda_stream)].any()


def _check_all_zero(variant, got, ref):
    """The edge cases' blocks: every weight 0, so every entry (the counts
    too) is 0 in the twin, and the kernel within its tolerance of that."""
    for g, r in zip(got[:2], ref[:2]):
        assert float(r.abs().max()) == 0.0
        assert float(g[0, 7, 7]) == float(r[0, 7, 7]) == 0.0
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max())
    if variant == "v3":
        assert torch.equal(got[2], ref[2])


@pytest.mark.parametrize("level", [0, 2])
@pytest.mark.parametrize("variant", ["v3", "v4"])
def test_banded_kernel_all_gated_out(pyramids, cuda_device, variant, level):
    """Every pixel gated out: the pose moves the source 1 km sideways, so no
    projection lands in the image (the bases clip to the edges of the band
    range). All weights are 0 and the blocks are zeros, in the kernel as in
    the twin; a rerun is bitwise."""
    mod, step = BANDED[variant]
    tgt, src = pyramids[0][level], pyramids[1][level]
    pose = Transform.exp(torch.tensor([0.0, 0.0, 0.0, 1000.0, 0.0, 0.0], device=cuda_device))
    args = _banded_args(mod, tgt, src, pose, MsIcpParams.default_tpu("pallas")[level])
    got = step(*args)
    _check_all_zero(variant, got, mod.icp_step_plain(*args, **({"emit_stats": True} if variant == "v3" else {})))
    assert all(torch.equal(a, b) for a, b in zip(step(*args)[:2], got[:2]))


@pytest.mark.parametrize("level", [0, 2])
@pytest.mark.parametrize("variant", ["v3", "v4"])
def test_banded_kernel_empty_source_mask(pyramids, cuda_device, variant, level):
    """An empty source mask: every source depth is 0 in the pack (and the
    bands are predicted from empty centroids), so no pixel is valid and the
    blocks and K7's stats are zeros, as in the twin."""
    mod, step = BANDED[variant]
    tgt, src = pyramids[0][level], pyramids[1][level]
    pose = Transform.exp(torch.tensor([0.02, -0.01, 0.006, 0.004, -0.008, 0.002], device=cuda_device))
    args = _banded_args(mod, tgt, src, pose, MsIcpParams.default_tpu("pallas")[level], empty_source=True)
    got = step(*args)
    _check_all_zero(variant, got, mod.icp_step_plain(*args, **({"emit_stats": True} if variant == "v3" else {})))


def test_banded_kernels_reject_bad_inputs(pyramids, cuda_device):
    tgt, src = pyramids[0][0], pyramids[1][0]
    args = _banded_args(k4, tgt, src, Transform.identity(device=cuda_device), MsIcpParams.default_tpu()[0])
    with pytest.raises(ValueError):
        k3.icp_step_pallas_batched(*args)  # K8's int32 pack handed to K7
    with pytest.raises(ValueError):
        k4.icp_step_pallas_batched(*args[:5], args[5][:, :, :, :-1].contiguous(), *args[6:])


# -- K9, K10: the band prediction ----------------------------------------------------


def _source_pack(src, edit=None):
    """(1, nchunks, 2, K, 128) source pack of a range image; ``edit`` is
    "empty_and_nan": lanes 128-255 and rows 16-31 masked out, and a valid
    pixel's z set to NaN."""
    h, w = src.height, src.width
    points, mask = src.points.reshape(1, h, w, 3).clone(), src.mask.reshape(1, h, w).clone()
    if edit == "empty_and_nan":
        mask[:, :, 128:256] = False
        mask[:, 16:32] = False
        mask[0, 40, 300] = True
        points[0, 40, 300, 2] = float("nan")
    return k3.pack_source(points, mask, src.intensities.reshape(1, h, w))


@pytest.mark.parametrize("level, edit", [(0, None), (1, None), (2, None), (0, "empty_and_nan")])
def test_source_centroids_kernel_bitwise(pyramids, cuda_device, level, edit):
    """K9 against its twin on the card and on the CPU, bitwise (NaN in the
    same places), one launch a call."""
    src = pyramids[1][level]
    sp = _source_pack(src, edit)
    before = k3.CENTROIDS_LAUNCHES
    got = k3.source_centroids_batched(sp, src.intrinsics)
    assert k3.CENTROIDS_LAUNCHES == before + 1
    ref = k3.source_centroids_plain(sp, src.intrinsics)
    cpu = k3.source_centroids_plain(sp.cpu(), src.intrinsics)
    for g, r, c in zip(got, ref, cpu):
        assert _same_bits(g, r) and _same_bits(g.cpu(), c)
    if edit:
        assert torch.isnan(got[0]).any() and (got[3] == 0).any()


def _predict_poses(device, sp, intrinsics):
    """Poses K10 is held at: a twist, a drop and a lift of 0.5 m (band
    starts clipped at 0 and at hp - 32), and a translation that takes the
    first non-empty group's centroid to the origin (its pz == 0)."""
    twist = Transform.exp(torch.tensor([0.02, -0.01, 0.006, 0.004, -0.008, 0.002], device=device))
    poses = [twist, Transform.exp(torch.tensor([0.0, -0.5, 0.0, 0.0, 0.0, 0.0], device=device)),
             Transform.exp(torch.tensor([0.0, 0.5, 0.0, 0.0, 0.0, 0.0], device=device))]
    pbar, _, _, cnt = k3.source_centroids_plain(sp[:1], intrinsics)
    c, g = (int(i) for i in torch.nonzero(cnt[0] > 0)[0])
    x, r = pbar[0, c, g], twist.rotation
    t = -torch.stack([(r[i, 0] * x[0] + r[i, 1] * x[1]) + r[i, 2] * x[2] for i in range(3)])
    return poses + [Transform(r, t)]


@pytest.mark.parametrize("level", [0, 1, 2])
def test_predict_bases_kernel_equals_plain(pyramids, cuda_device, level):
    """K10's three int32 outputs equal its twin's on the card, one launch a
    call, at each pose of ``_predict_poses``; the drop and the lift clip
    some band starts at 0 and at hp - min(32, hp)."""
    src = pyramids[1][level]
    sp = _source_pack(src)
    centroids = k3.source_centroids_batched(sp, src.intrinsics)
    hp = sp.shape[1] * k3.CHUNK
    clipped = set()
    for pose in _predict_poses(cuda_device, sp, src.intrinsics):
        rot, trans = pose.rotation[None].contiguous(), pose.translation[None].contiguous()
        before = k3.PREDICT_LAUNCHES
        got = k3.predict_bases_centroid_batched(rot, trans, centroids, src.intrinsics, hp)
        assert k3.PREDICT_LAUNCHES == before + 1
        ref = k3.predict_bases_centroid_plain(rot, trans, centroids, src.intrinsics, hp)
        assert all(g.dtype == torch.int32 and torch.equal(g, r) for g, r in zip(got, ref))
        clipped |= {int(v) for v in got[0][0, 1:-1]} & {0, max(hp - min(32, hp), 0)}
    assert clipped == {0, max(hp - min(32, hp), 0)}


def test_band_prediction_batch64_bitwise_against_single(cuda_device):
    """K9 and K10 at B = 64 real pairs: each pair's outputs bitwise its
    B = 1 outputs, and K10's equal its twin's at B = 64."""
    from align3d_torch.tools.series import real_pairs

    sources, targets = real_pairs(64, cuda_device)
    h, w = targets.height, targets.width
    sp = k3.pack_source(sources.points.reshape(64, h, w, 3), sources.mask.reshape(64, h, w),
                        sources.intensities.reshape(64, h, w))
    pose = Transform.exp(torch.tensor([0.004, -0.002, 0.003, 0.002, -0.003, 0.001], device=cuda_device))
    rot, trans = pose.rotation.expand(64, 3, 3).contiguous(), pose.translation.expand(64, 3).contiguous()
    hp = sp.shape[1] * k3.CHUNK
    centroids = k3.source_centroids_batched(sp, targets.intrinsics)
    assert all(_same_bits(g, r) for g, r in zip(centroids, k3.source_centroids_plain(sp, targets.intrinsics)))
    bases = k3.predict_bases_centroid_batched(rot, trans, centroids, targets.intrinsics, hp)
    ref = k3.predict_bases_centroid_plain(rot, trans, centroids, targets.intrinsics, hp)
    assert all(torch.equal(g, r) for g, r in zip(bases, ref))
    for b in range(64):
        one = k3.source_centroids_batched(sp[b:b + 1], targets.intrinsics)
        assert all(_same_bits(o[0], x[b]) for o, x in zip(one, centroids)), b
        one_bases = k3.predict_bases_centroid_batched(rot[b:b + 1], trans[b:b + 1], one, targets.intrinsics, hp)
        assert all(torch.equal(o[0], x[b]) for o, x in zip(one_bases, bases)), b


def test_band_prediction_rejects_bad_inputs(pyramids, cuda_device):
    src = pyramids[1][0]
    sp = _source_pack(src)
    with pytest.raises(ValueError):
        k3.source_centroids_batched(sp[:, :, :, :-1], src.intrinsics)  # not contiguous
    centroids = k3.source_centroids_batched(sp, src.intrinsics)
    rot, trans = torch.eye(3, device=cuda_device)[None], torch.zeros(1, 3, device=cuda_device)
    with pytest.raises(ValueError):
        k3.predict_bases_centroid_batched(rot.double(), trans, centroids, src.intrinsics, sp.shape[1] * 16)
    with pytest.raises(ValueError):
        k3.predict_bases_centroid_batched(rot, trans, centroids[:3] + (centroids[3][..., :1].contiguous(),),
                                          src.intrinsics, sp.shape[1] * 16)


def test_band_predict_ptxas_report(cuda_device):
    """K9 and K10 built (the file's -fmad=false among their flags) with no
    spills."""
    from align3d_torch import _kernels

    _kernels.lib()
    for name in ("source_centroids_kernel", "predict_bases_kernel"):
        lines = _kernels.ptxas_report(name)
        assert sum("Compiling entry function" in line for line in lines) == 1, lines
        assert all("spill" not in line or "0 bytes spill stores, 0 bytes spill loads" in line for line in lines), lines


# -- K11: the GN iteration's merge, solve, update and select ---------------------------

STATE_FIELDS = ("rot", "trans", "best_res", "best_rot", "best_trans")


def _clone(state):
    return gn.GNState(*(getattr(state, f).clone() for f in STATE_FIELDS))


def _pair(state, b, stop=None):
    """Pairs b to ``stop`` (b alone by default) of a state, copied."""
    return gn.GNState(*(getattr(state, f)[b:b + 1 if stop is None else stop].clone() for f in STATE_FIELDS))


def _flat(images):
    """(B, ...) flattened levels of batched range images (a leading axis of 1
    added to a single one) for the prepacks."""
    lead = images.points.shape[:-3]
    b = lead[0] if lead else 1
    h, w = images.height, images.width
    return (images.points.reshape(b, h * w, 3), images.mask.reshape(b, h * w),
            images.intensities.reshape(b, h * w), images.normals.reshape(b, h * w, 3),
            images.intensity_map.reshape(b, h + 2, w + 2))


def _gn_step(engine, tgt, src, params):
    """``step(rot, trans)`` of the exact engine (K1) or ``pallas_v4`` (K10 +
    K8) over B pairs: the two (B, 8, 8) block views the GN loop hands K11."""
    sp_, sm, si, _, _ = _flat(src)
    tp_, tm, _, tn, tmap = _flat(tgt)
    if engine == "k1":
        packed = image_icp.prepack_batched(sp_, sm, si, tp_, tm, tn, tmap)

        def step(rot, trans):
            aug = icp_fused.icp_step_fused(rot, trans, *packed, tgt.intrinsics, params)
            return aug[:, 0], aug[:, 1]
        return step
    sp, tp, centroids, h, w = image_icp.prepack_v4_batched(sp_, sm, si, tp_, tm, tn, tmap, tgt.intrinsics)

    def step(rot, trans):
        bases = k3.predict_bases_centroid_batched(rot, trans, centroids, tgt.intrinsics, sp.shape[1] * k3.CHUNK)
        return k4.icp_step_pallas_batched(rot, trans, *bases, sp, tp, tgt.intrinsics, h, w,
                                          k3.params_to_tuple(params))[:2]
    return step


def _start(device, bsz):
    pose = Transform.exp(torch.tensor([0.02, -0.01, 0.006, 0.004, -0.008, 0.002], device=device))
    return gn.GNState.start(pose.rotation.expand(bsz, 3, 3), pose.translation.expand(bsz, 3))


def _weights(params):
    return icp_fused._f32(params.weight), icp_fused._f32(params.color_weight)


def _assert_close_to_twin(got, ref):
    """NaN in the same places; equal residuals and select decisions; the
    other pose entries within 2e-6 absolute (rotation) and 2e-6 of each
    pair's largest translation entry."""
    for f in STATE_FIELDS:
        assert torch.equal(torch.isnan(getattr(got, f)), torch.isnan(getattr(ref, f))), f
    assert torch.equal(got.best_res, ref.best_res)
    for r in ("rot", "best_rot"):
        assert float((getattr(got, r) - getattr(ref, r)).nan_to_num(0.0).abs().max()) <= 2e-6, r
    for t in ("trans", "best_trans"):
        gap = (getattr(got, t) - getattr(ref, t)).nan_to_num(0.0).abs().amax(-1)
        assert bool((gap <= 2e-6 * getattr(ref, t).nan_to_num(0.0).abs().amax(-1)).all()), t


@pytest.fixture(scope="module")
def real64(cuda_device):
    from align3d_torch.tools.series import real_pairs

    return real_pairs(64, cuda_device)


@pytest.mark.parametrize("huber", [None, 0.004])
@pytest.mark.parametrize("shape", ["b1_level0", "b1_level1", "b1_level2", "b64_level0"])
@pytest.mark.parametrize("engine", ["k1", "k8"])
def test_gn_update_kernel_matches_plain(pyramids, real64, cuda_device, engine, shape, huber):
    """K11 against its twin on the card on the blocks of real K1 and K8
    steps, four GN iterations from the same state each: the residuals and the
    decisions equal, the poses within 2e-6. One launch an update."""
    bsz, level = (64, 0) if shape.startswith("b64") else (1, int(shape[-1]))
    tgt, src = (real64[1], real64[0]) if bsz == 64 else (pyramids[0][level], pyramids[1][level])
    ms = MsIcpParams.default() if engine == "k1" else MsIcpParams.default_tpu("pallas_v4")
    params = ms[level].replace(huber_delta=huber)
    step, (w1, w2) = _gn_step(engine, tgt, src, params), _weights(params)
    state = _start(cuda_device, bsz)
    selected = 0
    for _ in range(4):
        blocks = step(state.rot, state.trans)
        ref = _clone(state)
        gn.gn_update_plain(*blocks, w1, w2, ref)
        before, best = gn.LAUNCHES, state.best_res.clone()
        gn.gn_update(*blocks, w1, w2, state)
        assert gn.LAUNCHES == before + 1
        _assert_close_to_twin(state, ref)
        selected += int((state.best_res != best).sum())
    assert selected >= bsz  # the first iteration selects in every pair
    if bsz == 1:
        assert bool(torch.isfinite(state.rot).all() and torch.isfinite(state.trans).all())


@pytest.mark.parametrize("engine", ["k1", "k8"])
def test_gn_update_kernel_batch64_bitwise_against_single(real64, cuda_device, engine):
    """Pair b of a B = 64 launch is bitwise the pair launched alone, over
    three iterations."""
    params = (MsIcpParams.default() if engine == "k1" else MsIcpParams.default_tpu("pallas_v4"))[0]
    step, (w1, w2) = _gn_step(engine, real64[1], real64[0], params), _weights(params)
    state = _start(cuda_device, 64)
    for _ in range(3):
        geom, color = step(state.rot, state.trans)
        singles = [_pair(state, b) for b in range(64)]
        gn.gn_update(geom, color, w1, w2, state)
        for b, one in enumerate(singles):
            gn.gn_update(geom[b:b + 1], color[b:b + 1], w1, w2, one)
            assert all(torch.equal(getattr(one, f)[0], getattr(state, f)[b]) for f in STATE_FIELDS), b


def _blocks(device, hessians, gradient=None, sq=None, count=None):
    """(B, 8, 8) geometric blocks of the given (B, 6, 6) hessians, and zero
    colour blocks. The default gradients are H x for x of ~0.01: updates of
    the size the ICP loop takes."""
    bsz = hessians.shape[0]
    gen = torch.Generator().manual_seed(5)
    geom = torch.zeros(bsz, 8, 8)
    geom[:, :6, :6] = hessians
    if gradient is None:
        gradient = (hessians @ (0.01 * torch.randn(bsz, 6, 1, generator=gen)))[..., 0]
    geom[:, :6, 6], geom[:, 6, :6] = gradient, gradient
    geom[:, 6, 6] = torch.rand(bsz, generator=gen) + 0.5 if sq is None else sq
    geom[:, 7, 7] = 100.0 if count is None else count
    return geom.to(device), torch.zeros_like(geom).to(device)


def _pd(n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    jac = torch.randn(n, 12, 6, generator=gen) * 0.1
    return jac.transpose(1, 2) @ jac + 0.01 * torch.eye(6)


def _run_both(blocks, state, w1=1.0, w2=0.5):
    ref = _clone(state)
    gn.gn_update_plain(*blocks, w1, w2, ref)
    gn.gn_update(*blocks, w1, w2, state)
    return ref


def test_gn_update_kernel_empty_tie_and_nan(cuda_device):
    """Pair 0: count 0, so a zero update leaves the pose bitwise unchanged and
    the residual (0 / 0) is not selected. Pair 1: its residual equals the
    best so far, so the earlier best pose stays (strict <). Pair 2: a NaN
    residual, never selected, while the pose still moves. Pair 3: selected."""
    hessians = _pd(4)
    sq = torch.tensor([0.0, 2.0, float("nan"), 1.0])
    blocks = _blocks(cuda_device, hessians, sq=sq, count=torch.tensor([0.0, 10.0, 10.0, 10.0]))
    state = _start(cuda_device, 4)
    state.best_res.copy_(torch.tensor([1.0, 0.2, 5.0, 5.0]))  # pair 1: 2.0 / 10 == f32(0.2)
    state.best_rot.copy_(Transform.identity((4,), device=cuda_device).rotation)
    before = _clone(state)
    ref = _run_both(blocks, state)
    _assert_close_to_twin(state, ref)
    assert torch.equal(state.rot[0], before.rot[0]) and torch.equal(state.trans[0], before.trans[0])
    assert torch.equal(state.best_res[:3], before.best_res[:3])
    assert float(state.best_res[3]) == float(torch.tensor(0.1))
    assert torch.equal(state.best_rot[:3], before.best_rot[:3]) and torch.equal(state.best_trans[:3],
                                                                                 before.best_trans[:3])
    assert not torch.equal(state.rot[1:], before.rot[1:]) and torch.equal(state.best_rot[3], state.rot[3])


def _rank_cases():
    """Hessians whose Cholesky fails: rank 1 and 5 (J^T J), zero, a zero pivot
    in the middle and last, a negative pivot, an indefinite matrix, a NaN."""
    gen = torch.Generator().manual_seed(1)
    cases = {}
    for rank in (1, 5):
        jac = torch.randn(rank, 6, generator=gen)
        cases[f"rank{rank}"] = jac.T @ jac
    cases["zero"] = torch.zeros(6, 6)
    for name, diag in (("zero_mid", [1, 1, 1, 0, 1, 1]), ("zero_last", [1, 1, 1, 1, 1, 0]),
                       ("negative_mid", [1, 1, -1, 1, 1, 1])):
        cases[name] = torch.diag(torch.tensor(diag, dtype=torch.float32))
    sym = torch.randn(6, 6, generator=gen)
    cases["indefinite"] = sym + sym.T
    nan = _pd(1, 7)[0]
    nan[2, 1] = nan[1, 2] = float("nan")
    cases["nan"] = nan
    return cases


@pytest.mark.parametrize("bsz", [1, 64])
@pytest.mark.parametrize("case", sorted(_rank_cases()))
def test_gn_update_kernel_failed_cholesky_pattern(cuda_device, case, bsz):
    """A Hessian whose factorization fails gives the twin's NaN / finite
    pattern on the card (cuSOLVER: NaN where a pivot is not positive), at B = 1
    and in pair 0 of B = 64 beside positive-definite pairs, which stay close
    to the twin."""
    hessians = torch.cat([_rank_cases()[case][None], _pd(bsz - 1, 3)]) if bsz > 1 else _rank_cases()[case][None]
    gradient = (hessians @ (0.01 * torch.randn(bsz, 6, 1, generator=torch.Generator().manual_seed(2))))[..., 0]
    gradient[0] = torch.randn(6, generator=torch.Generator().manual_seed(4))  # not in the range of H
    blocks = _blocks(cuda_device, hessians, gradient)
    state = _start(cuda_device, bsz)
    ref = _run_both(blocks, state)
    for f in STATE_FIELDS:
        assert torch.equal(torch.isfinite(getattr(state, f)), torch.isfinite(getattr(ref, f))), f
        assert torch.equal(torch.isnan(getattr(state, f)), torch.isnan(getattr(ref, f))), f
    if case not in ("rank1", "rank5", "indefinite"):  # the sign of their failing pivot is the data's
        assert not bool(torch.isfinite(state.rot[0]).all())
    if bsz > 1:
        _assert_close_to_twin(_pair(state, 1, bsz), _pair(ref, 1, bsz))


def test_gn_update_launches_once_a_gn_iteration(pyramids, cuda_device):
    """An align on the card launches K11 once a ``gn.iter`` span: beside K1
    in the exact engine, beside K8 in ``pallas_v4``."""
    from align3d_torch.utils import profiling

    tgt, src = pyramids[0][2], pyramids[1][2]
    for engine, mod in (("xla", icp_fused), ("pallas_v4", k4)):
        params = (MsIcpParams.default() if engine == "xla" else MsIcpParams.default_tpu("pallas_v4"))[2]
        icp = image_icp.ImageIcp(params, tgt)
        before, step_before = gn.LAUNCHES, mod.LAUNCHES
        profiling.clear()
        with profiling.recording():
            icp.align(src)
        iters = sum(s.name == "gn.iter" for s in profiling.spans())
        profiling.clear()
        assert iters == params.max_iterations
        assert gn.LAUNCHES - before == mod.LAUNCHES - step_before == iters, engine


def test_gn_update_rejects_bad_inputs(cuda_device):
    blocks = _blocks(cuda_device, _pd(2))
    state = _start(cuda_device, 2)
    bad_blocks = [
        (blocks[0][:1], blocks[1][:1]),  # one pair for two
        (blocks[0].double(), blocks[1].double()),
        (blocks[0].cpu(), blocks[1]),
        (blocks[0].transpose(1, 2), blocks[1].transpose(1, 2)),  # rows not contiguous
        (torch.zeros(2, 2, 8, 8, device=cuda_device)[:, 0], blocks[1]),  # pair strides 128 and 64
    ]
    for geom, color in bad_blocks:
        with pytest.raises(ValueError):
            gn.gn_update(geom, color, 1.0, 0.5, state)
    # The state is checked once, when it is made, not at every update.
    for f, bad in (("rot", state.rot.double()), ("trans", state.trans[:1]), ("best_res", state.best_res.cpu()),
                   ("best_rot", state.best_rot.transpose(1, 2))):
        fields = {g: getattr(state, g).clone() for g in STATE_FIELDS}
        fields[f] = bad
        with pytest.raises(ValueError):
            gn.GNState(**fields)


def test_gn_update_ptxas_report(cuda_device):
    """K11 built (-fmad=false among its flags) with no spills."""
    from align3d_torch import _kernels

    _kernels.lib()
    lines = _kernels.ptxas_report("gn_update_kernel")
    assert sum("Compiling entry function" in line for line in lines) == 1, lines
    assert all("spill" not in line or "0 bytes spill stores, 0 bytes spill loads" in line for line in lines), lines


# -- K12, K13: the range-image pyramid ---------------------------------------------------

PYRAMID_FRAMES = 65  # a 64-pair batch step's frames


@pytest.fixture(scope="module")
def pyramid_inputs(cuda_device):
    """Per sample: (colours, int32 depths, per-frame scales, camera) of
    PYRAMID_FRAMES frames cycled through the sequence, on the card."""
    out = {}
    for name in ("sample1", "sample2"):
        ds = SlamTbDataset.load(str(RGBD / name))
        frames = [ds.get(i) for i in range(len(ds))]
        pick = [frames[i % len(frames)] for i in range(PYRAMID_FRAMES)]
        colors = torch.from_numpy(np.stack([f.image.color for f in pick])).to(cuda_device)
        depths = torch.from_numpy(np.stack([f.image.depth.astype(np.int32) for f in pick])).to(cuda_device)
        # One scale a frame, each its own, around the recording's.
        scales = torch.from_numpy((np.float32(frames[0].image.depth_scale)
                                   * np.linspace(0.9, 1.1, PYRAMID_FRAMES)).astype(np.float32))
        out[name] = (colors, depths, scales, frames[0].image.depth_scale, frames[0].camera)
    return out


def _same_bits(a, b) -> bool:
    if a.dtype == torch.float32:
        return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))
    return a.dtype == b.dtype and torch.equal(a, b)


def _pyramid_against_twin(args, levels: int):
    """K12 and K13 through ops/pyramid.py::build against the plain twin on
    the card: every output of every level bitwise (the sign of zero too),
    one launch a level. Returns the kernels' levels."""
    from align3d_torch.ops import pyramid as pyr

    before = pyr.BASE_LAUNCHES + pyr.DOWN_LAUNCHES
    got = pyr.build(*args)
    assert pyr.BASE_LAUNCHES + pyr.DOWN_LAUNCHES == before + levels
    ref = pyr.pyramid_plain(*args)
    assert len(got) == len(ref) == levels
    for k, (g, r) in enumerate(zip(got, ref)):
        for field in pyr.Level._fields:
            a, b = getattr(g, field), getattr(r, field)
            assert (a is None) == (b is None), (k, field)
            if a is not None:
                assert _same_bits(a, b), (k, field)
    return got


@pytest.mark.parametrize("scale_kind", ["float", "per_frame"])
@pytest.mark.parametrize("batch", [1, PYRAMID_FRAMES])
@pytest.mark.parametrize("name", ["sample1", "sample2"])
def test_pyramid_kernels_bitwise_twin(pyramid_inputs, name, batch, scale_kind):
    colors, depths, scales, scale, camera = pyramid_inputs[name]
    if batch == 1:
        colors, depths, scales = colors[1], depths[1], scales[1]
    else:
        colors, depths, scales = colors[:batch], depths[:batch], scales[:batch]
    _pyramid_against_twin((True, True, 3, 1.0, camera, scales if scale_kind == "per_frame" else scale, colors,
                           depths), 3)


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
def test_pyramid_kernels_levels(pyramid_inputs, levels):
    colors, depths, _, scale, camera = pyramid_inputs["sample1"]
    _pyramid_against_twin((True, True, levels, 1.0, camera, scale, colors[:3], depths[:3]), levels)


@pytest.mark.parametrize("flags", [(False, True), (True, False), (False, False)])
def test_pyramid_kernels_flags_off(pyramid_inputs, flags):
    colors, depths, _, scale, camera = pyramid_inputs["sample2"]
    got = _pyramid_against_twin((*flags, 3, 1.0, camera, scale, colors[:2], depths[:2]), 3)
    assert all((lv.normals is not None) == flags[0] for lv in got)
    assert all((lv.intensity_map is not None) == flags[1] for lv in got)


def test_pyramid_kernels_odd_shape(pyramid_inputs):
    """479x639: the windows' float32 picks (ratios 479 / 239, 239 / 119, ...)
    and the blur's clamped borders at odd sizes, four levels, three frames."""
    colors, depths, scales, _, camera = pyramid_inputs["sample1"]
    _pyramid_against_twin((True, True, 4, 1.0, camera, scales[:3], colors[:3, :479, :639].contiguous(),
                           depths[:3, :479, :639].contiguous()), 4)


def test_pyramid_kernels_empty_and_blind_frames(pyramid_inputs, cuda_device):
    """An all-zero depth frame, and a 479x639 frame whose level 1 has valid
    pixels and level 2 none (every level-2 window invalid), beside a real
    frame in one batch."""
    from _torch_pyramid_cases import level2_blind_depth

    colors, depths, _, scale, camera = pyramid_inputs["sample1"]
    colors = colors[:3, :479, :639].contiguous()
    depth = depths[:3, :479, :639].clone()
    depth[0] = 0
    depth[1] = torch.from_numpy(level2_blind_depth(479, 639)).to(cuda_device)
    got = _pyramid_against_twin((True, True, 3, 1.0, camera, scale, colors, depth.contiguous()), 3)
    assert not bool(got[0].mask[0].any()) and bool(got[1].mask[1].any()) and not bool(got[2].mask[1].any())


def test_pyramid_kernels_batch_bitwise_single(pyramid_inputs):
    """Each frame of a 65-frame launch is bitwise its own one-frame launch."""
    from align3d_torch.ops import pyramid as pyr

    colors, depths, scales, _, camera = pyramid_inputs["sample2"]
    batch = pyr.build(True, True, 3, 1.0, camera, scales, colors, depths)
    for i in (0, 7, PYRAMID_FRAMES - 1):
        one = pyr.build(True, True, 3, 1.0, camera, scales[i], colors[i], depths[i])
        for lb, lo in zip(batch, one):
            for field in pyr.Level._fields:
                assert _same_bits(getattr(lb, field)[i], getattr(lo, field)), (i, field)


def test_pyramid_launches_a_build(pyramid_inputs, cuda_device):
    """RangeImageBuilder.build and the batched build: one K12 and one K13 a
    coarser level, nothing of the plain chain."""
    from align3d_torch.ops import pyramid as pyr
    from align3d_torch.parallel.batch import build_pyramids_batched

    ds = SlamTbDataset.load(str(RGBD / "sample1"))
    counts = (pyr.BASE_LAUNCHES, pyr.DOWN_LAUNCHES)
    RangeImageBuilder(bilateral_filter=bil.BilateralFilter()).build(ds.get(2), cuda_device)
    assert (pyr.BASE_LAUNCHES, pyr.DOWN_LAUNCHES) == (counts[0] + 1, counts[1] + 2)
    colors, depths, scales, _, camera = pyramid_inputs["sample1"]
    build_pyramids_batched(camera, scales, colors, depths)
    assert (pyr.BASE_LAUNCHES, pyr.DOWN_LAUNCHES) == (counts[0] + 2, counts[1] + 4)


def test_pyramid_kernels_reject_bad_inputs(pyramid_inputs):
    from align3d_torch.ops import pyramid as pyr

    colors, depths, _, scale, camera = pyramid_inputs["sample1"]
    color, depth = colors[0], depths[0]
    counts = (pyr.BASE_LAUNCHES, pyr.DOWN_LAUNCHES)
    bad_base = [
        (depth.to(torch.int16), color),  # dtype
        (depth.to(torch.float32), color),
        (depth, color.to(torch.int32)),
        (depth, color.cpu()),  # device
        (depth.t().contiguous().t(), color),  # contiguity
        (depth, color[:, :, [2, 1, 0]].permute(2, 0, 1).contiguous().permute(1, 2, 0)),
        (depth, color[:-1]),  # shape
    ]
    for d, c in bad_base:
        with pytest.raises(ValueError):
            pyr.pyramid_base(d, c, scale, camera, True, True)
    level = pyr.pyramid_base(depth, color, scale, camera, True, True)
    for bad in (level._replace(points=level.points.double()), level._replace(mask=level.mask.to(torch.uint8)),
                level._replace(normals=level.normals.cpu()), level._replace(colors=level.colors[:, ::2]),
                level._replace(points=level.points.transpose(0, 1).contiguous().transpose(0, 1))):
        with pytest.raises(ValueError):
            pyr.pyramid_down(bad, 1.0, True)
    with pytest.raises(ValueError):
        pyr.pyramid_down(level, 9.0, True)  # more blur taps than K13 takes
    assert (pyr.BASE_LAUNCHES, pyr.DOWN_LAUNCHES) == (counts[0] + 1, counts[1])


def test_pyramid_ptxas_report(cuda_device):
    """K12 and K13 built (-fmad=false among their flags) with no spills."""
    from align3d_torch import _kernels

    _kernels.lib()
    for name in ("pyramid_base_kernel", "pyramid_down_kernel"):
        lines = _kernels.ptxas_report(name)
        assert sum("Compiling entry function" in line for line in lines) == 1, lines
        assert all("spill" not in line or "0 bytes spill stores, 0 bytes spill loads" in line for line in lines), lines


# -- P1, P2: the roofline probes ------------------------------------------------------


def test_fma_probe_against_twin(cuda_device):
    from align3d_torch.tools import roofline as rl

    x = torch.rand(132 * 256, device=cuda_device) + 0.5
    before = rl.FMA_LAUNCHES
    got = rl.fma_chains(x, 2)
    assert rl.FMA_LAUNCHES == before + 1
    # rtol 1e-5: fmaf rounds once where the twin's multiply and add round
    # twice, over chains of 64.
    torch.testing.assert_close(got, rl.fma_chains_plain(x, 2), rtol=1e-5, atol=0)


def test_gather_probes_bitwise_against_twins(cuda_device):
    from align3d_torch.tools import roofline as rl

    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randint(0, 1000, (257, 128), generator=g, device=cuda_device, dtype=torch.int32)
    idx = torch.randint(0, 128, (4, 257, 128), generator=g, device=cuda_device, dtype=torch.int32)
    assert torch.equal(rl.lane_gather(x, idx, 3), rl.lane_gather_plain(x, idx, 3))
    for m in (4096, 6_144_000):
        table = torch.randint(-(2**31), 2**31 - 1, (m,), generator=g, device=cuda_device, dtype=torch.int32)
        xs = torch.randint(0, 1000, (10_001,), generator=g, device=cuda_device, dtype=torch.int32)
        assert torch.equal(rl.table_gather(table, xs, 2), rl.table_gather_plain(table, xs, 2))


def test_compose_bitwise_across_batch_sizes(cuda_device):
    """``Transform.compose`` on the card gives a pose the same bits at batch
    1, 64 and 4096 (a batched GEMM would not)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = Transform.exp(torch.randn(4096, 6, generator=g, device=cuda_device))
    b = Transform.exp(torch.randn(4096, 6, generator=g, device=cuda_device))
    full = a @ b
    for n in (1, 64):
        part = Transform(a.rotation[:n], a.translation[:n]) @ Transform(b.rotation[:n], b.translation[:n])
        assert torch.equal(part.rotation, full.rotation[:n]) and torch.equal(part.translation, full.translation[:n])


def test_align_batched_bitwise_against_single_pairs(cuda_device):
    """The batched GN loop gives each pair the bits of its own align: K1,
    the f64 solve, the SE(3) exp and the (batch-invariant) compose."""
    from align3d_torch.icp.image_icp import align_batched, align_impl
    from align3d_torch.icp.params import IcpParams
    from align3d_torch.tools.series import real_pairs

    sources, targets = real_pairs(6, cuda_device)
    n = targets.height * targets.width
    args = (sources.points.reshape(6, n, 3), sources.mask.reshape(6, n), sources.intensities.reshape(6, n),
            targets.points.reshape(6, n, 3), targets.mask.reshape(6, n), targets.normals.reshape(6, n, 3),
            targets.intensity_map)
    params = IcpParams(max_iterations=10)
    pose, res = align_batched(Transform.identity((6,), device=cuda_device), *args, targets.intrinsics, params)
    eye, zero = torch.eye(3, device=cuda_device), torch.zeros(3, device=cuda_device)
    for b in range(6):
        rot, trans, r = align_impl(eye, zero, *(a[b] for a in args), targets.intrinsics, params)
        assert torch.equal(rot, pose.rotation[b]) and torch.equal(trans, pose.translation[b]) and torch.equal(r, res[b])


def _renders_equal(a, b) -> bool:
    return torch.equal(a.color.cpu(), b.color.cpu()) and torch.equal(
        a.depth.cpu().view(torch.int32), b.depth.cpu().view(torch.int32))


def test_viz_points_card_bitwise_cpu_and_rerun(cuda_device):
    """Two sample1 frames as posed clouds, built on the CPU and rendered
    there and, uploaded, on the card: bitwise (the projection is float64
    elementwise arithmetic and the z-test a min of int64 keys), and a rerun
    on the card bitwise. (Clouds built on the card differ in the last bit
    where the backprojection divides by a scalar.)"""
    from align3d_torch.io.datasets import SubsetDataset
    from align3d_torch.viz.viewers import GeoViewer, RgbdDatasetViewer

    cpu = RgbdDatasetViewer(SubsetDataset(SlamTbDataset.load(str(RGBD / "sample1")), [0, 1]), 160, 120,
                            device="cpu")
    cpu.build_scene()
    card = GeoViewer(160, 120, device=cuda_device)
    for node in cpu.viewer.scene.nodes:
        card.add(node.points.to(cuda_device), colors=node.colors.to(cuda_device), transform=node.transform)
    for az in (0.0, 2.0):
        first, want = card.render_frame(az), cpu.viewer.render_frame(az)
        assert _renders_equal(first, want) and _renders_equal(card.render_frame(az), first)
        assert torch.isfinite(first.depth).sum() > 1000


def test_viz_mesh_one_k5_launch_a_render(cuda_device):
    """A mesh node without normals: one K5 launch a render (its corner
    table kept between renders), bitwise the CPU path's render."""
    from align3d_torch.viz.viewers import GeoViewer

    geom = read_off(DATA / "teapot.off")
    renders = {}
    for device in (cuda_device, torch.device("cpu")):
        viewer = GeoViewer(640, 480, device=device)
        viewer.add(geom.points, faces=geom.faces)
        before = mesh.LAUNCHES
        renders[device.type] = [viewer.render_frame(0.3, 0.4), viewer.render_frame(0.3, 0.4)]
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert mesh.LAUNCHES - before == 2
    card, cpu = renders["cuda"], renders["cpu"]
    assert _renders_equal(card[0], card[1]) and _renders_equal(card[0], cpu[0])
    assert torch.isfinite(card[0].depth).sum() > 10000


def test_divisions_by_a_number_on_the_card_bitwise_the_cpu(cuda_device):
    """Where the port divides a tensor by a Python number, the card divides
    as the CPU does (the CPU path is the one held bitwise to JAX): the
    backprojections, the intensity map at all 256 u8 levels, the
    small-angle branch of ``Transform.log``, and every frame's scene cloud."""
    from align3d_torch.camera import CameraIntrinsics
    from align3d_torch.io.datasets import SubsetDataset
    from align3d_torch.ops.intensity import build_intensity_map
    from align3d_torch.viz.viewers import RgbdDatasetViewer

    cpu = torch.device("cpu")
    cam = CameraIntrinsics(fx=544.47329, fy=544.47329, cx=320.0, cy=240.0, width=640, height=480)
    frame = SlamTbDataset.load(str(RGBD / "sample1")).get(0)
    depth = torch.from_numpy(frame.image.depth.astype(np.float32) * np.float32(frame.image.depth_scale))
    assert torch.equal(cam.backproject_grid(depth.to(cuda_device)).cpu(), cam.backproject_grid(depth))
    rng = np.random.default_rng(0)
    u, v, z = (torch.from_numpy(rng.uniform(lo, hi, 100_000).astype(np.float32))
               for lo, hi in ((0, 640), (0, 480), (0.3, 8.0)))
    got = cam.backproject(u.to(cuda_device), v.to(cuda_device), z.to(cuda_device)).cpu()
    assert torch.equal(got, cam.backproject(u, v, z))
    levels = torch.arange(256, dtype=torch.uint8).reshape(16, 16)
    assert torch.equal(build_intensity_map(levels.to(cuda_device)).cpu(), build_intensity_map(levels))
    twists = torch.from_numpy(rng.normal(0, 1, (4096, 6)).astype(np.float32)) * torch.logspace(-7, -4, 4096)[:, None]
    small = Transform.exp(twists)
    assert bool((small.angle() < 1e-3).all())  # the log's small-angle branch: cos(theta) > 1 - 1e-6
    card = Transform(small.rotation.to(cuda_device), small.translation.to(cuda_device))
    assert torch.equal(card.log().cpu(), small.log())
    scenes = []
    for device in (cuda_device, cpu):
        viewer = RgbdDatasetViewer(SubsetDataset(SlamTbDataset.load(str(RGBD / "sample1")), [0, 1]), 160, 120,
                                   device=device)
        viewer.build_scene()
        scenes.append(torch.cat([n.points.cpu() for n in viewer.viewer.scene.nodes]))
    assert torch.equal(scenes[0], scenes[1])


def _sphere_points(n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    pts = (rng.normal(0, 1, (n, 3)) * [3.0, 0.5, 40.0] + [1e3, -2.0, 7.0]).astype(np.float32)
    pts[0] = [-0.0, 0.0, -0.0] if n > 1 else pts[0]
    return pts


@pytest.mark.parametrize("n", [1, 3, 1023, 1024, 1025, 100_003, 2_100_000])
def test_sphere_mean_kernel_bitwise_numpy(cuda_device, n):
    """K6 is numpy's float32 mean along axis 0, bit for bit (rows added in
    order from row 0, the sum divided by N in float64), one launch; and the
    fitted sphere on the card is numpy's, centre and radius."""
    from align3d_torch.viz import sphere

    pts = _sphere_points(n)
    before = sphere.MEAN_LAUNCHES
    got = sphere.numpy_means(torch.from_numpy(pts).to(cuda_device), [n]).cpu().numpy()[0]
    assert sphere.MEAN_LAUNCHES == before + 1
    want = pts.mean(axis=0)
    assert got.dtype == want.dtype and np.array_equal(got.view(np.int32), want.view(np.int32))
    fit = sphere.Sphere3D.from_points(torch.from_numpy(pts).to(cuda_device))
    ref = sphere.Sphere3D.from_points(pts)
    assert np.array_equal(fit.center.view(np.int32), ref.center.view(np.int32)) and fit.radius == ref.radius


def test_sphere_fit_many_is_one_launch(cuda_device):
    """Many nodes' spheres fitted together: one K6 launch, each bitwise
    numpy's fit of its own points (an empty set the empty sphere)."""
    from align3d_torch.viz import sphere

    sets = [_sphere_points(n) for n in (1, 3, 1025, 100_003, 262_144)]
    before = sphere.MEAN_LAUNCHES
    fits = sphere.Sphere3D.fit_many([torch.from_numpy(p).to(cuda_device) for p in sets]
                                    + [torch.zeros((0, 3), device=cuda_device)])
    assert sphere.MEAN_LAUNCHES == before + 1 and fits[-1].is_empty
    for fit, pts in zip(fits, sets):
        ref = sphere.Sphere3D.from_points(pts)
        assert np.array_equal(fit.center.view(np.int32), ref.center.view(np.int32)) and fit.radius == ref.radius


def test_sphere_mean_kernel_rejects_bad_inputs(cuda_device):
    from align3d_torch.viz import sphere

    with pytest.raises(ValueError):
        sphere.numpy_means(torch.zeros((4, 3), dtype=torch.float64, device=cuda_device), [4])
    with pytest.raises(ValueError):
        sphere.numpy_means(torch.zeros((3, 4), device=cuda_device)[:, :3], [3])
    with pytest.raises(ValueError):
        sphere.numpy_means(torch.zeros((4, 3), device=cuda_device), [4, 0])
