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
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_torch import _kernels
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
    launches = _kernels.launches()
    assert torch.equal(rl.fma_chains(torch.from_numpy(x.reshape(-1)), 3), torch.from_numpy(ref.reshape(-1)))
    assert _kernels.launches() == launches  # the CPU takes the twin
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


def _table_gather_numpy(table: np.ndarray, x: np.ndarray, steps: int, ilp: int = rl.TABLE_ILP,
                        u: int = rl.TABLE_U) -> np.ndarray:
    """An independent numpy form of the table mode with uint32 wraparound."""
    n, m = x.size, np.uint64(table.size)
    e = np.arange(n, dtype=np.uint32)
    total = np.zeros(n, np.uint32)
    with np.errstate(over="ignore"):
        for s in range(steps):
            for i in range(ilp):
                h = (np.uint32(s) * np.uint32(n) + e) * np.uint32(ilp) + np.uint32(i)
                h ^= h >> np.uint32(16)
                h *= np.uint32(0x7FEB352D)
                h ^= h >> np.uint32(15)
                h *= np.uint32(0x2C1B3C6D)
                h ^= h >> np.uint32(16)
                a = x.astype(np.uint32) + np.uint32(i)
                for _ in range(u):
                    h = h * np.uint32(1664525) + np.uint32(1013904223)
                    j = (h.astype(np.uint64) * m) >> np.uint64(32)
                    a = a + table[j].astype(np.uint32)
                total = total + a
    return total.view(np.int32)


# The library's chains (TABLE_ILP x TABLE_U) and the ablation's other builds.
@pytest.mark.parametrize("ilp,u", [(rl.TABLE_ILP, rl.TABLE_U), (4, 16), (8, 8), (16, 4)])
@pytest.mark.parametrize("m", [1000, 4096, 6_144_000])
def test_table_gather_twin(m, ilp, u):
    rng = np.random.default_rng(m)
    table = rng.integers(-(2**31), 2**31, size=m, dtype=np.int64).astype(np.int32)
    x = rng.integers(0, 1000, size=777).astype(np.int32)
    ref = _table_gather_numpy(table, x, 2, ilp, u)
    if (ilp, u) == (rl.TABLE_ILP, rl.TABLE_U):
        got = rl.table_gather(torch.from_numpy(table), torch.from_numpy(x), 2)
    else:
        got = rl.table_gather_plain(torch.from_numpy(table), torch.from_numpy(x), 2, ilp, u)
    np.testing.assert_array_equal(got.numpy(), ref)
    idx = rl.table_indices(777, 2, m, "cpu", ilp, u)
    assert tuple(idx.shape) == (2, u, ilp, 777)
    assert int(idx.min()) >= 0 and int(idx.max()) < m
    # Distinct indices per chain: no two chains of an element share a sequence.
    assert not torch.equal(idx[:, :, 0], idx[:, :, 1])


def test_gather_bounds_count_sectors_and_banks():
    """P2's hbm bound counts a 32-byte sector a gather (the 138.4 M gathers
    of the hbm mode: 1.32 ms at 3.35 TB/s, not the 0.165 ms of 4 bytes), and
    the lane bound one shared-memory load and one store a gather over 32
    banks x 132 SMs a clock."""
    gathers = rl.SMS * 2048 * 4 * rl.TABLE_ILP * rl.TABLE_U * rl.TABLE_STEPS["hbm"]
    assert gathers == 138_412_032
    assert rl.table_bound_ms(gathers) == pytest.approx(gathers * 32 / 3.35e12 * 1e3, rel=1e-12)
    assert rl.table_bound_ms(gathers) == pytest.approx(1.3222, abs=1e-4)
    assert rl.lane_bound_ms(4224, 1.98e9) == pytest.approx(2 * 4224 / (32 * 132 * 1.98e9) * 1e3, rel=1e-12)


def test_measure_probes_reports_the_bounds(monkeypatch):
    """measure_probes' accounting on tiny CPU probes (time_ms stubbed to
    1 ms a call; the twins run instead of the kernels)."""
    import types

    g = torch.Generator().manual_seed(0)
    p = types.SimpleNamespace(
        fma_n=256, fma_x=torch.rand(256, generator=g) + 0.5, lane_rows=2,
        lane_x=torch.randint(0, 1000, (2, rl.ROW), generator=g, dtype=torch.int32),
        lane_idx=torch.randint(0, rl.ROW, (rl.LANE_ILP, 2, rl.ROW), generator=g, dtype=torch.int32),
        table_n=64, table_x=torch.randint(0, 1000, (64,), generator=g, dtype=torch.int32),
        tables={m: torch.randint(0, 1 << 20, (4096,), generator=g, dtype=torch.int32) for m in ("l2", "hbm")})
    monkeypatch.setattr(rl, "time_ms", lambda fn, reps=10, warmup=2: 1.0)
    out = rl.measure_probes(p, 1.98e9)
    hbm = out["p2_hbm"]
    assert hbm["gathers"] == 64 * rl.TABLE_ILP * rl.TABLE_U * rl.TABLE_STEPS["hbm"]
    assert hbm["bound_ms"] == rl.table_bound_ms(hbm["gathers"])
    assert hbm["sector_gbs"] == hbm["gathers"] * 32 / 1e6
    assert out["p2_l2"]["bound_ms"] is None  # no published L2 rate
    lane = out["p2_lane"]
    assert lane["bound_ms"] == rl.lane_bound_ms(2 * rl.ROW * rl.LANE_ILP * rl.LANE_U * rl.LANE_STEPS, 1.98e9)


def test_icp_step_bytes_counts_each_input_once():
    mask = torch.zeros((2, 100), dtype=torch.uint8)
    mask[0, :30] = 1
    mask[1, :7] = 1
    # 200 mask bytes; 37 valid pixels x (12 point + 1 luma + 28 geometry);
    # per pair a 12 x 12 float32 intensity map, 48 B of pose, 512 B of blocks.
    assert rl.icp_step_bytes(mask, 10, 10) == 200 + 37 * 41 + 2 * (12 * 12 * 4 + 48 + 512)


@pytest.mark.parametrize("seen,calls,kernel,want_ms", [
    (50, 50, "k", 0.004),  # every launch seen
    (49, 50, "k", 0.004),  # one dropped: the mean does not read low
    (7, 10, "k", 0.004),
    (9766, 50, None, 196 * 0.004),  # 196 activities a call, 34 dropped
])
def test_device_ms_does_not_read_low_when_the_profiler_drops(seen, calls, kernel, want_ms):
    acts = [("k", 4.0)] * seen
    assert rl.per_call_ms(acts, calls, kernel) == pytest.approx(want_ms, rel=1e-12)


def test_device_ms_rejects_a_wrapper_that_issues_other_work():
    with pytest.raises(RuntimeError, match="Memcpy"):
        rl.per_call_ms([("k", 4.0), ("Memcpy HtoD", 1.0)], 1, "k")
    assert rl.per_call_ms([], 5, "k") is None


def test_tool_fails_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert rl.main() != 0
    assert capsys.readouterr().out == ""
    with pytest.raises(RuntimeError, match="CUDA"):
        rl.measure("cuda")


def test_ablation_tool_fails_without_a_card(monkeypatch, capsys):
    from align3d_torch.tools import ablate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ablate.main([]) != 0
    assert ablate.main(["mesh_designs"]) != 0
    assert ablate.main(["banded_sections"]) != 0
    assert capsys.readouterr().out == ""
    assert ablate.main(["no_such_comparison"]) != 0
    assert capsys.readouterr().out == ""


def test_banded_ablation_inputs():
    """``ablate.banded_inputs`` (the split of K7's and K8's time): each
    kernel's B = 1 arguments are the first of its B pairs, and the twins give
    that pair the same blocks on both (the bands are predicted per pair)."""
    from align3d_torch.ops import icp_pallas_v3 as k3
    from align3d_torch.ops import icp_pallas_v4 as k4
    from align3d_torch.tools import ablate

    inputs = ablate.banded_inputs(torch.device("cpu"), batch=2)
    for key, mod, nch, dtype in (("K7", k3, k3.NCH, torch.float32), ("K8", k4, k4.NCH, torch.int32)):
        one, many = inputs[key]["batch1"], inputs[key]["batch64"]
        assert many[0].shape[0] == 2 and one[0].shape[0] == 1
        assert many[6].shape[2] == nch and many[6].dtype == dtype
        assert all(torch.equal(a[0], b[0]) for a, b in zip(one[:7], many[:7]))
        assert one[7:] == many[7:]
        for a, b in zip(mod.icp_step_plain(*one)[:2], mod.icp_step_plain(*many)[:2]):
            assert torch.equal(a[0], b[0])
