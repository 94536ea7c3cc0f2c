"""The roofline probes of the port (``align3d_torch/tools/roofline.py``) on
the CPU: their plain twins against numpy transcriptions of the TPU probes'
kernel bodies, and the tool's accounting.

The TPU probes' bodies are closures inside ``vpu_fma_peak`` and
``lane_gather_peak`` (``tools/roofline_v4.py:52-66, 98-116``), built around
a ``pallas_call`` that needs a TPU; they cannot be called without editing
``tools/``, which stays as it is. So each body is transcribed into numpy
here, line for line, and the twins are held to it. The CUDA kernels are held
to the twins on the card (test_torch_kernels_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from align3d_torch.tools import roofline as rl


def _vpu_fma_kern(x: np.ndarray, steps: int, ilp: int = 4, u: int = 64) -> np.ndarray:
    """roofline_v4.py:52-66 over ``steps`` grid steps: o_ref starts at zero
    and accumulates each step's o (numpy float32: a multiply, then an add)."""
    o_ref = np.zeros_like(x)
    for _ in range(steps):
        accs = [x * np.float32(1.0 + 1e-7 * i) for i in range(ilp)]
        for _ in range(u):
            accs = [a * np.float32(1.0000001) + x for a in accs]
        o = accs[0]
        for a in accs[1:]:
            o = o + a
        o_ref = o_ref + o
    return o_ref


def _lane_gather_kern(x: np.ndarray, idx: np.ndarray, steps: int, ilp: int = 4, u: int = 16) -> np.ndarray:
    """roofline_v4.py:98-116 over ``steps`` grid steps (int32 wraps)."""
    o_ref = np.zeros_like(x)
    with np.errstate(over="ignore"):
        for _ in range(steps):
            idxs = [idx[i] for i in range(ilp)]
            accs = [x + np.int32(i) for i in range(ilp)]
            for _ in range(u):
                accs = [np.take_along_axis(a + x, idxs[i], axis=1) for i, a in enumerate(accs)]
            acc = accs[0]
            for a in accs[1:]:
                acc = acc + a
            o_ref = o_ref + acc
    return o_ref


def test_fma_twin_matches_the_tpu_kernel_body():
    x = (np.random.default_rng(0).random((16, 128)) + 0.5).astype(np.float32)
    ref = _vpu_fma_kern(x, steps=3)
    got = rl.fma_chains_plain(torch.from_numpy(x.reshape(-1)), 3).numpy().reshape(16, 128)
    # Bitwise: the twin rounds the multiply and the add separately, as the
    # transcription does (the CUDA kernel's fmaf rounds once; it is held to
    # the twin at a relative tolerance on the card).
    np.testing.assert_array_equal(got, ref)
    launches = rl.FMA_LAUNCHES
    assert torch.equal(rl.fma_chains(torch.from_numpy(x.reshape(-1)), 3), torch.from_numpy(ref.reshape(-1)))
    assert rl.FMA_LAUNCHES == launches  # the CPU takes the twin
    # The TPU tool's flop count: rows * 128 * u * ilp * 2 * steps.
    assert rl.fma_flops(16 * 128, 3) == 16 * 128 * 64 * 4 * 2 * 3


def test_lane_gather_twin_matches_the_tpu_kernel_body():
    rng = np.random.default_rng(0)
    rows = 80  # the TPU probe's NCH * CHUNK rows
    x = rng.integers(-(2**31), 2**31, size=(rows, 128), dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, 128, size=(4, rows, 128)).astype(np.int32)
    ref = _lane_gather_kern(x, idx, steps=2)
    got = rl.lane_gather(torch.from_numpy(x), torch.from_numpy(idx), 2)
    np.testing.assert_array_equal(got.numpy(), ref)  # integer sums: bitwise


def _table_gather_numpy(table: np.ndarray, x: np.ndarray, steps: int) -> np.ndarray:
    """An independent numpy form of the table mode with uint32 wraparound."""
    n, m = x.size, np.uint64(table.size)
    e = np.arange(n, dtype=np.uint32)
    total = np.zeros(n, np.uint32)
    with np.errstate(over="ignore"):
        for s in range(steps):
            for i in range(rl.TABLE_ILP):
                h = (np.uint32(s) * np.uint32(n) + e) * np.uint32(rl.TABLE_ILP) + np.uint32(i)
                h ^= h >> np.uint32(16)
                h *= np.uint32(0x7FEB352D)
                h ^= h >> np.uint32(15)
                h *= np.uint32(0x2C1B3C6D)
                h ^= h >> np.uint32(16)
                a = x.astype(np.uint32) + np.uint32(i)
                for _ in range(rl.TABLE_U):
                    h = h * np.uint32(1664525) + np.uint32(1013904223)
                    j = (h.astype(np.uint64) * m) >> np.uint64(32)
                    a = a + table[j].astype(np.uint32)
                total = total + a
    return total.view(np.int32)


@pytest.mark.parametrize("m", [1000, 4096, 6_144_000])
def test_table_gather_twin(m):
    rng = np.random.default_rng(m)
    table = rng.integers(-(2**31), 2**31, size=m, dtype=np.int64).astype(np.int32)
    x = rng.integers(0, 1000, size=777).astype(np.int32)
    ref = _table_gather_numpy(table, x, steps=2)
    got = rl.table_gather(torch.from_numpy(table), torch.from_numpy(x), 2)
    np.testing.assert_array_equal(got.numpy(), ref)
    idx = rl.table_indices(777, 2, m, "cpu")
    assert int(idx.min()) >= 0 and int(idx.max()) < m
    # Distinct indices per chain: no two chains of an element share a sequence.
    assert not torch.equal(idx[:, :, 0], idx[:, :, 1])


def test_icp_step_bytes_counts_each_input_once():
    mask = torch.zeros((2, 100), dtype=torch.uint8)
    mask[0, :30] = 1
    mask[1, :7] = 1
    # 200 mask bytes; 37 valid pixels x (12 point + 1 luma + 28 geometry);
    # per pair a 12 x 12 float32 intensity map, 48 B of pose, 512 B of blocks.
    assert rl.icp_step_bytes(mask, 10, 10) == 200 + 37 * 41 + 2 * (12 * 12 * 4 + 48 + 512)


def test_tool_fails_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert rl.main() != 0
    assert capsys.readouterr().out == ""
    with pytest.raises(RuntimeError, match="CUDA"):
        rl.measure("cuda")
