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

from align3d_torch.icp.params import MsIcpParams
from align3d_torch.io import read_off
from align3d_torch.io.datasets import SlamTbDataset
from align3d_torch.ops import bilateral as bil
from align3d_torch.ops import icp_fused, mesh, nn_banded
from align3d_torch.ops.target_pack import pack_geometry, pack_intensity_taps
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


@pytest.mark.parametrize("name", ["sample1", "deep"])
def test_slice_kernel_matches_plain(depth_frames, name):
    depth = depth_frames[name]
    grid = bil.BilateralGrid.from_image(depth, SIGMA_SPACE, SIGMA_COLOR, 16).convolve().normalize()
    args = (grid.data_cm, depth, grid.color_min, SIGMA_SPACE, SIGMA_COLOR)
    got, ref = bil._slice(*args), bil._slice_plain(*args)
    # atol 2e-3 before the cast, <= 1 after it (measured bitwise on an H100:
    # the kernel uses round-to-nearest intrinsics in the plain op order).
    assert float((got - ref).abs().max()) <= 2e-3
    assert int((got.to(torch.int32) - ref.to(torch.int32)).abs().max()) <= 1


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
        pack_geometry(tgt.points, tgt.normals, tgt.mask)[None], pack_intensity_taps(tgt.intensity_map)[None],
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


@pytest.mark.parametrize("payload", [False, True])
@pytest.mark.parametrize("band_width", [128, 512, 1024])
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


@pytest.mark.parametrize("name", ["teapot", "grid320", "random_isolated", "fan_degree40"])
def test_mesh_kernel_bitwise(cuda_device, name):
    pts, faces = _meshes()[name]
    ev = mesh.MeshNormals(faces, pts.shape[0], device=cuda_device)
    points = torch.from_numpy(pts).to(cuda_device)
    before = mesh.LAUNCHES
    got = ev(points)
    assert mesh.LAUNCHES == before + 1
    ref = mesh.vertex_normals_plain(points, ev.faces, ev.table, ev.counts)
    # Bitwise, NaN at the same (isolated) vertices.
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref))
    again = ev(points)
    assert torch.equal(torch.nan_to_num(again), torch.nan_to_num(got))
    # And the CPU evaluator gives the same, bitwise.
    cpu = mesh.MeshNormals(faces, pts.shape[0], device="cpu")(torch.from_numpy(pts))
    assert torch.equal(torch.isnan(got.cpu()), torch.isnan(cpu))
    assert torch.equal(torch.nan_to_num(got.cpu()), torch.nan_to_num(cpu))


def test_mesh_kernel_rejects_bad_inputs(cuda_device):
    pts, faces = _meshes()["teapot"]
    ev = mesh.MeshNormals(faces, pts.shape[0], device=cuda_device)
    points = torch.from_numpy(pts).to(cuda_device)
    with pytest.raises(ValueError):
        mesh.vertex_normals(points.double(), ev.faces, ev.table, ev.counts)  # dtype
    with pytest.raises(ValueError):
        mesh.vertex_normals(points, ev.faces.long(), ev.table, ev.counts)  # dtype
    with pytest.raises(ValueError):
        mesh.vertex_normals(points.t().contiguous().t(), ev.faces, ev.table, ev.counts)  # contiguity
    with pytest.raises(ValueError):
        mesh.vertex_normals(points, ev.faces, ev.table.cpu(), ev.counts)  # device
    with pytest.raises(ValueError):
        ev(points.cpu())  # the topology lives on the card


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
    ref = bil._slice_plain(norm, depths, cmin, filt.sigma_space, filt.sigma_color)
    assert float((sliced - ref).abs().max()) <= 2e-3


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
