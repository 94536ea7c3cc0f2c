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
from align3d_torch.io.datasets import SlamTbDataset
from align3d_torch.ops import bilateral as bil
from align3d_torch.ops import icp_fused
from align3d_torch.ops.target_pack import pack_geometry, pack_intensity_taps
from align3d_torch.range_image import RangeImageBuilder
from align3d_torch.se3 import Transform

pytestmark = pytest.mark.cuda

SIGMA_SPACE = bil.BilateralFilter.sigma_space
SIGMA_COLOR = bil.BilateralFilter.sigma_color
RGBD = Path(__file__).resolve().parent / "data" / "rgbd"


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
