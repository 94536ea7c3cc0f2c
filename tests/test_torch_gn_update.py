"""The image ICP loop's GN update (``optim/gauss_newton.py::gn_update``) on
the CPU: there it runs its plain twin, K11 is never launched, and the loop
gives bitwise the poses and residuals of the loop body it replaced, which
is kept here. K11 itself is held to the twin on the card in
``tests/test_torch_kernels_cuda.py``."""

import numpy as np
import pytest
import torch
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_torch import RangeImageBuilder, _kernels
from align3d_torch.camera import CameraIntrinsics
from align3d_torch.icp import image_icp
from align3d_torch.icp.params import IcpParams, MsIcpParams
from align3d_torch.image import RgbdFrame, RgbdImage
from align3d_torch.ops.bilateral import BilateralFilter
from align3d_torch.ops.icp_fused import _f32
from align3d_torch.optim import gauss_newton as gn
from align3d_torch.optim.gauss_newton import GNSystem
from align3d_torch.se3 import Transform


def _loop_before(step, initial_rotation, initial_translation, params):
    """``_gn_loop`` as it was before K11: the merge, the f64 solve, the SE(3)
    update and the select as separate PyTorch ops."""
    weight, color_weight = _f32(params.weight), _f32(params.color_weight)
    rot, trans = initial_rotation, initial_translation
    best_res = torch.full(rot.shape[:1], torch.inf, dtype=torch.float32, device=rot.device)
    best_rot, best_trans = rot, trans
    for _ in range(params.max_iterations):
        blocks = step(rot, trans)
        geom, color = (GNSystem(a[..., 0:6, 0:6], a[..., 0:6, 6], a[..., 6, 6], a[..., 7, 7]) for a in blocks)
        merged = geom.add_weighted(color, weight, color_weight)
        residual = merged.mean_squared_residual()
        new_transform = Transform.exp(merged.solve()) @ Transform(rot, trans)
        better = residual < best_res
        best_res = torch.where(better, residual, best_res)
        best_rot = torch.where(better[:, None, None], new_transform.rotation, best_rot)
        best_trans = torch.where(better[:, None], new_transform.translation, best_trans)
        rot, trans = new_transform.rotation, new_transform.translation
    return best_rot, best_trans, best_res


def _synthetic_step(bsz: int, seed: int = 0):
    """``step(rot, trans)``: two (B, 8, 8) blocks of fixed positive-definite
    hessians whose gradients pull each pose towards a target. Pair 1's
    residual never changes (ties after its first iteration), pair 2's is NaN
    every second iteration, pair 3's systems are empty at the third."""
    gen = torch.Generator().manual_seed(seed)
    jac = torch.randn(bsz, 2, 24, 6, generator=gen) * 0.3
    hessians = jac.transpose(-1, -2) @ jac
    target = Transform.exp(torch.randn(bsz, 6, generator=gen) * 0.05)
    calls = [0]

    def step(rot, trans):
        k = calls[0]
        calls[0] += 1
        rel = target.rotation @ rot.transpose(-1, -2)
        skew = 0.5 * torch.stack([rel[:, 2, 1] - rel[:, 1, 2], rel[:, 0, 2] - rel[:, 2, 0],
                                  rel[:, 1, 0] - rel[:, 0, 1]], dim=-1)
        err = torch.cat([target.translation - trans, skew], dim=-1)
        hess = hessians.clone()
        grad = (hess @ err[:, None, :, None])[..., 0]
        sq = (10.0 * (err * err).sum(-1) + 1e-3)[:, None].repeat(1, 2)
        count = torch.full((bsz, 2), 50.0)
        sq[1] = 0.25
        if k % 2:
            sq[2] = float("nan")
        if k == 2:
            hess[3], grad[3], sq[3], count[3] = 0.0, 0.0, 0.0, 0.0
        aug = torch.zeros(bsz, 2, 8, 8)
        aug[..., :6, :6] = hess
        aug[..., :6, 6] = grad
        aug[..., 6, :6] = grad
        aug[..., 6, 6] = sq
        aug[..., 7, 7] = count
        return aug[:, 0], aug[:, 1]

    return step


@pytest.mark.parametrize("weights", [(1.0, 0.1), (0.7, 1.3)])
@pytest.mark.parametrize("iterations", [0, 1, 7])
def test_gn_loop_on_cpu_is_bitwise_the_loop_before(weights, iterations):
    params = IcpParams(max_iterations=iterations, weight=weights[0], color_weight=weights[1])
    start = Transform.exp(torch.randn(5, 6, generator=torch.Generator().manual_seed(3)) * 0.02)
    before = _kernels.launches()
    got = image_icp._gn_loop(_synthetic_step(5), start.rotation, start.translation, params)
    want = _loop_before(_synthetic_step(5), start.rotation, start.translation, params)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert _kernels.launches() == before
    assert bool(torch.isfinite(got[2]).all()) or iterations == 0  # NaN and empty residuals are never kept


def _frames(n: int = 2, h: int = 48, w: int = 64):
    """A textured relief drifting one pixel a frame, built as range images."""
    rng = np.random.default_rng(0)
    tex = rng.uniform(50, 200, size=(h + 16, w + n + 16, 3)).astype(np.uint8)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    intr = CameraIntrinsics(fx=40.0, fy=40.0, cx=w / 2 - 0.5, cy=h / 2 - 0.5, width=w, height=h)
    builder = RangeImageBuilder(bilateral_filter=BilateralFilter(), pyramid_levels=1)
    out = []
    for i in range(n):
        depth = (2000 + 3 * (xs + i) + 2 * ys + 40 * np.sin((xs + i) * 0.35) * np.cos(ys * 0.3)).astype(np.uint16)
        frame = RgbdFrame(intr, RgbdImage(tex[4:4 + h, 4 + i:4 + i + w], depth, 0.001))
        out.append(builder.build(frame, "cpu")[0])
    return out


@pytest.mark.parametrize("engine", ["xla", "pallas_v4"])
def test_align_on_cpu_is_bitwise_the_loop_before(monkeypatch, engine):
    """A real align (the exact engine's and ``pallas_v4``'s plain steps): the
    same bits through the loop and through the loop body it replaced; no
    launch of K11."""
    target, source = _frames()
    base = MsIcpParams.default() if engine == "xla" else MsIcpParams.default_tpu("pallas_v4")
    params = base[0].replace(max_iterations=6)
    before = _kernels.launches()
    icp = image_icp.ImageIcp(params, target)
    got = icp.align(source)
    got_res = icp.last_residual
    monkeypatch.setattr(image_icp, "_gn_loop", _loop_before)
    want = icp.align(source)
    assert torch.equal(got.rotation, want.rotation) and torch.equal(got.translation, want.translation)
    assert got_res == icp.last_residual and np.isfinite(got_res)
    assert _kernels.launches() == before


def test_gn_state_copies_the_initial_pose():
    start = Transform.identity((3,))
    state = gn.GNState.start(start.rotation.expand(3, 3, 3), start.translation)
    assert state.rot.is_contiguous() and state.rot.data_ptr() != start.rotation.data_ptr()
    assert state.best_rot.data_ptr() != state.rot.data_ptr() and state.best_trans.data_ptr() != state.trans.data_ptr()
    assert torch.equal(state.best_rot, start.rotation) and bool(torch.isinf(state.best_res).all())
    step = _synthetic_step(3)
    gn.gn_update(*step(state.rot, state.trans), 1.0, 0.5, state)
    assert torch.equal(start.rotation, Transform.identity((3,)).rotation)  # the caller's pose is not written


def test_gn_update_refuses_other_devices():
    state = gn.GNState(*(torch.empty(shape, device="meta") for shape in ((1, 3, 3), (1, 3), (1,), (1, 3, 3), (1, 3))))
    blocks = torch.empty(1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        gn.gn_update(blocks, blocks, 1.0, 1.0, state)
