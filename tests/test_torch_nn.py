"""Nearest-neighbour search of the PyTorch port against the JAX package: the
voxel hash (``ops/voxel_hash.py``) and the banded sorted-grid search
(``ops/nn_banded.py``, the plain twin of CUDA kernel K4 on the CPU).

The JAX package's Pallas search runs in interpret mode here, as its own
tests run it. Inputs are made with numpy from a seed and handed to both.

Where the two differ, and why:

* JAX sorts the queries with ``lax.sort``, which is not stable; the port's
  sort is. Queries of one cell can then fall into other 128-query blocks,
  so ``nearest_banded`` is held against the exact brute force, and
  ``associate_p2p`` is held against JAX on the same grid and the same
  pre-sorted queries, where the sort plays no part.
* The JAX kernel scores with a matmul and the port in the fixed order
  ``c3 + ((qx*c0 + qy*c1) + qz*c2)``, so scores may differ in the last
  bits; squared distances are held at 5e-6, the JAX test's own bound
  (``tests/test_nn_banded.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_tpu.ops import nn_banded as jax_nn
from align3d_tpu.ops import voxel_hash as jax_vh

from align3d_torch import convert
from align3d_torch.ops import nn_banded, voxel_hash

SQ_ATOL = 5e-6  # |c|^2 - 2 q.c + |q|^2 in f32 (tests/test_nn_banded.py)


def _cloud(n, seed, scale=1.0):
    return np.random.default_rng(seed).uniform(0, scale, (n, 3)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _brute(db, queries):
    """Exact f64 nearest neighbour (index, squared distance)."""
    d = ((queries[:, None, :].astype(np.float64) - db[None, :, :]) ** 2).sum(-1)
    return d.argmin(axis=1), d.min(axis=1)


# -- voxel hash ---------------------------------------------------------------


def test_cell_hash_bitwise():
    cells = np.random.default_rng(0).integers(-5000, 5000, (4000, 3)).astype(np.int32)
    ref = np.asarray(jax_vh._cell_hash(jnp.asarray(cells)))
    # The products wrap around in int32 in both packages.
    np.testing.assert_array_equal(voxel_hash._cell_hash(_t(cells)).numpy(), ref)


@pytest.mark.parametrize("cell", [0.5, 0.07])
def test_voxel_hash_build_bitwise(cell):
    pts = np.random.default_rng(1).uniform(-2, 2, (5000, 3)).astype(np.float32)
    ref = jax_vh.VoxelHashGrid.build(jnp.asarray(pts), cell)
    ours = voxel_hash.VoxelHashGrid.build(_t(pts), cell)
    np.testing.assert_array_equal(ours.sorted_hash.numpy(), np.asarray(ref.sorted_hash))
    np.testing.assert_array_equal(ours.sorted_points.numpy(), np.asarray(ref.sorted_points))
    np.testing.assert_array_equal(ours.sorted_indices.numpy(), np.asarray(ref.sorted_indices))


def test_voxel_hash_small_golden():
    # The reference kd-tree test (src/kdtree.rs:141-160), as in tests/test_voxel_hash.py.
    db = np.asarray([[1.0, 2, 3], [2, 3, 4], [5, 6, 7], [8, 9, 1]], np.float32)
    queries = np.asarray([[8.0, 9.1, 1.3], [5.1, 6.4, 7.0], [1.5, 2.1, 3.3], [2.2, 3.1, 4.2]], np.float32)
    idx, _ = voxel_hash.nearest(voxel_hash.VoxelHashGrid.build(_t(db), 2.0), _t(queries), max_per_cell=8)
    np.testing.assert_array_equal(idx.numpy(), [3, 2, 0, 1])


def test_voxel_hash_nearest_matches_jax():
    rng = np.random.default_rng(2)
    db = rng.uniform(-2, 2, (5000, 3)).astype(np.float32)
    queries = rng.uniform(-2, 2, (9000, 3)).astype(np.float32)  # more than one 8192 chunk
    jgrid = jax_vh.VoxelHashGrid.build(jnp.asarray(db), 0.5)
    ref_idx, ref_sq = jax_vh.nearest(jgrid, jnp.asarray(queries), max_per_cell=64)
    grid = voxel_hash.VoxelHashGrid.build(_t(db), 0.5)
    idx, sq = voxel_hash.nearest(grid, _t(queries), max_per_cell=64)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    # XLA contracts dx*dx + dy*dy + dz*dz into FMAs, PyTorch does not.
    np.testing.assert_allclose(sq.numpy(), np.asarray(ref_sq), atol=1e-6, rtol=0)
    # The JAX grid, carried over, gives the same answer.
    carried = convert.voxel_hash_grid_from_numpy(
        np.asarray(jgrid.sorted_hash), np.asarray(jgrid.sorted_points), np.asarray(jgrid.sorted_indices), 0.5,
        device="cpu",
    )
    assert torch.equal(voxel_hash.nearest(carried, _t(queries), max_per_cell=64)[0], idx)


def test_voxel_hash_shuffled_grid_exact():
    # tests/test_voxel_hash.py::test_shuffled_grid_exact (kdtree.rs:162-199).
    pts = np.arange(500 * 3, dtype=np.float32).reshape(500, 3)
    shuffled = pts[np.random.default_rng(5).permutation(500)]
    idx, sq = voxel_hash.nearest(voxel_hash.VoxelHashGrid.build(_t(shuffled), 10.0), _t(pts), max_per_cell=16)
    np.testing.assert_allclose(sq.numpy(), 0.0, atol=1e-6)
    np.testing.assert_array_equal(shuffled[idx.numpy()], pts)


def test_brute_force_matches_jax():
    rng = np.random.default_rng(3)
    db = rng.uniform(-2, 2, (3000, 3)).astype(np.float32)
    queries = rng.uniform(-2, 2, (700, 3)).astype(np.float32)
    ref_idx, ref_sq = jax_vh.nearest_brute_force(jnp.asarray(db), jnp.asarray(queries))
    idx, sq = voxel_hash.nearest_brute_force(_t(db), _t(queries))
    # The matmul form loses ~1e-6 to cancellation in both; indices agree
    # except where two candidates tie within that noise (measured: none).
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(sq.numpy(), np.asarray(ref_sq), atol=SQ_ATOL, rtol=0)
    np.testing.assert_array_equal(idx.numpy(), _brute(db, queries)[0])


# -- sorted grid ----------------------------------------------------------------


def _assert_grid_equal(ours, ref):
    np.testing.assert_array_equal(ours.planes.numpy(), np.asarray(ref.planes))
    np.testing.assert_array_equal(ours.orig_idx.numpy(), np.asarray(ref.orig_idx))
    np.testing.assert_array_equal(ours.starts.numpy(), np.asarray(ref.starts))
    assert (ours.cell_size, ours.origin, ours.dims, ours.n) == (ref.cell_size, ref.origin, ref.dims, ref.n)


def test_sorted_grid_build_bitwise_uniform():
    db = _cloud(4000, 0)
    _assert_grid_equal(nn_banded.SortedGrid.build(_t(db), 0.05), jax_nn.SortedGrid.build(jnp.asarray(db), 0.05))


@pytest.fixture(scope="module")
def sample1_cloud(sample1_dataset):
    """Valid points and normals of sample1 frame 0 from the JAX range image."""
    from align3d_tpu.range_image import RangeImage as JaxRangeImage

    ri = JaxRangeImage.from_frame(sample1_dataset.get(0)).with_normals()
    mask = np.asarray(ri.mask).reshape(-1)
    return np.asarray(ri.points).reshape(-1, 3)[mask], np.asarray(ri.normals).reshape(-1, 3)[mask]


def test_sorted_grid_build_bitwise_sample1_normals(sample1_cloud):
    pts, nrm = sample1_cloud[0][::8], sample1_cloud[1][::8]
    ref = jax_nn.SortedGrid.build(jnp.asarray(pts), 0.05, normals=jnp.asarray(nrm))
    _assert_grid_equal(nn_banded.SortedGrid.build(_t(pts), 0.05, normals=_t(nrm)), ref)


# -- banded search (the K4 twin) --------------------------------------------------


def test_nearest_banded_exact_within_cell_ring():
    # tests/test_nn_banded.py::test_matches_brute_force_within_cell_ring.
    db = _cloud(4000, 0)
    queries = db[:2048] + _cloud(2048, 1, 0.004) - 0.002
    idx, sq = nn_banded.nearest_banded(nn_banded.SortedGrid.build(_t(db), 0.05), _t(queries), band_width=512)
    bidx, bsq = _brute(db, queries)
    np.testing.assert_array_equal(idx.numpy(), bidx)
    np.testing.assert_allclose(sq.numpy(), bsq, atol=SQ_ATOL, rtol=0)


def test_nearest_banded_ragged_and_unsort():
    # tests/test_nn_banded.py::test_ragged_query_count_and_unsort: Q = 999.
    db = _cloud(3000, 3)
    queries = db[np.random.default_rng(4).permutation(999)] + 0.001
    idx, _ = nn_banded.nearest_banded(nn_banded.SortedGrid.build(_t(db), 0.05), _t(queries))
    np.testing.assert_array_equal(idx.numpy(), _brute(db, queries)[0])


def test_nearest_banded_far_queries():
    # tests/test_nn_banded.py::test_queries_outside_grid_get_far_distances.
    db = _cloud(1000, 2)
    far = np.full((130, 3), 50.0, np.float32)
    idx, sq = nn_banded.nearest_banded(nn_banded.SortedGrid.build(_t(db), 0.05), _t(far))
    assert np.all(sq.numpy() > 100.0)
    d = np.linalg.norm(db[idx.numpy()] - far, axis=1)
    np.testing.assert_allclose(d * d, sq.numpy(), rtol=1e-5)


@pytest.mark.parametrize("n", [3, 100, 300])
def test_nearest_banded_db_smaller_than_band(n):
    # tests/test_nn_banded.py::test_small_db_smaller_than_band: the band is
    # clamped to the padded DB. With a cell of 0.25 the 3x3 (dx, dy) bands
    # reach every point of these DBs, so the search is exact.
    db = _cloud(n, 11)
    queries = _cloud(64, 12)
    grid = nn_banded.SortedGrid.build(_t(db), 0.25)
    assert grid.planes.shape[0] * 128 < 512
    idx, sq = nn_banded.nearest_banded(grid, _t(queries), band_width=512)
    bidx, bsq = _brute(db, queries)
    np.testing.assert_array_equal(idx.numpy(), bidx)
    np.testing.assert_allclose(sq.numpy(), bsq, atol=SQ_ATOL, rtol=0)


def test_nearest_banded_dense_band_truncation():
    # tests/test_nn_banded.py::test_band_truncation_is_graceful.
    db = _cloud(5000, 5, scale=0.2)
    grid = nn_banded.SortedGrid.build(_t(db), 0.05)
    idx, sq = nn_banded.nearest_banded(grid, _t(db[:256]), band_width=128)
    d = np.linalg.norm(db[idx.numpy()] - db[:256], axis=1)
    np.testing.assert_allclose(d * d, sq.numpy(), atol=1e-5)
    idx2, sq2 = nn_banded.nearest_banded(grid, _t(db), band_width=1024)
    np.testing.assert_array_equal(idx2.numpy(), np.arange(db.shape[0]))
    np.testing.assert_allclose(sq2.numpy(), 0.0, atol=2e-5)


def test_band_width_must_be_whole_tiles():
    grid = nn_banded.SortedGrid.build(_t(_cloud(300, 0)), 0.25)
    for bad in (0, 100, 200):
        with pytest.raises(ValueError, match="band_width"):
            nn_banded.nearest_banded(grid, _t(_cloud(10, 1)), band_width=bad)


def _p2p_inputs(db_pts, db_nrm, queries, cell):
    """The JAX grid with normals, and the queries sorted by their cell id
    once, by numpy, for both packages."""
    jgrid = jax_nn.SortedGrid.build(jnp.asarray(db_pts), cell, normals=jnp.asarray(db_nrm))
    grid = convert.sorted_grid_from_numpy(
        np.asarray(jgrid.planes), np.asarray(jgrid.orig_idx), np.asarray(jgrid.starts),
        jgrid.cell_size, jgrid.origin, jgrid.dims, jgrid.n, device="cpu",
    )
    lin = grid.cell_ids(_t(queries)).numpy()
    order = np.argsort(lin, kind="stable")
    return jgrid, grid, lin[order], queries[order]


def _assert_p2p_matches_jax(jgrid, grid, lin_s, q_s, max_other_winners: int):
    """sq within SQ_ATOL everywhere, and the winner's payload [nx, ny, nz,
    p.n] bitwise equal for all but ``max_other_winners`` queries: where two
    DB points tie to within the last bits of a score, the matmul's order and
    the port's fixed order can pick different ones (their sq still agree)."""
    ref = jax_nn.associate_p2p(jgrid, jnp.asarray(lin_s), *(jnp.asarray(q_s[:, k]) for k in range(3)))
    ours = nn_banded.associate_p2p(grid, _t(lin_s), *(_t(q_s[:, k]) for k in range(3)))
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]), atol=SQ_ATOL, rtol=0)
    got = np.stack([t.numpy() for t in ours[1:]])
    want = np.stack([np.asarray(t) for t in ref[1:]])
    assert int((got != want).any(axis=0).sum()) <= max_other_winners


def test_associate_p2p_matches_jax_uniform():
    rng = np.random.default_rng(7)
    db = _cloud(4000, 0)
    nrm = rng.normal(size=(4000, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    queries = db[rng.permutation(4000)[:2000]] + _cloud(2000, 8, 0.02) - 0.01  # ragged: 2000 = 15.6 blocks
    _assert_p2p_matches_jax(*_p2p_inputs(db, nrm, queries, 0.05), max_other_winners=0)


def test_associate_p2p_matches_jax_sample1(sample1_cloud):
    pts, nrm = sample1_cloud[0][::16], sample1_cloud[1][::16]
    queries = sample1_cloud[0][5::40] + np.float32(0.004)
    # Measured: 5 of 6,756 queries take the other of two winners whose exact
    # squared distances differ by less than the score's f32 rounding (~2 ulp
    # of |c|^2; e.g. 3.7790e-5 against 3.7757e-5, 3.4e-8 apart).
    _assert_p2p_matches_jax(*_p2p_inputs(pts, nrm, queries, 0.05), max_other_winners=10)


def test_band_search_plain_chunking_does_not_change_results(monkeypatch):
    db = _cloud(3000, 9)
    grid = nn_banded.SortedGrid.build(_t(db), 0.05)
    queries = _t(_cloud(1500, 10))
    ref = nn_banded.nearest_banded(grid, queries)
    monkeypatch.setattr(nn_banded, "_PLAIN_BLOCKS", 3)
    got = nn_banded.nearest_banded(grid, queries)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_band_search_nan_query_has_no_winner():
    grid = nn_banded.SortedGrid.build(_t(_cloud(500, 1)), 0.25, normals=_t(_cloud(500, 2)))
    q = torch.zeros((3, 128))
    q[:, 5] = torch.nan
    bstarts = torch.zeros(9, dtype=torch.int32)
    score, pos, pay = nn_banded.band_search(grid.planes, q, bstarts, 512, True)
    assert score[5] == torch.inf and int(pos[5]) == 2**31 - 1 and torch.all(pay[:, 5] == 0)
    assert torch.all(pos[:5] < 512) and torch.isfinite(score[:5]).all()


# -- K4's scan order, transcribed -------------------------------------------------

_K4_WARPS, _K4_SLICE, _K4_CHUNK_TILES = 8, 16, 4  # csrc/nn_banded.cu: kWarps, kSlice, kChunkTiles


def _before(s, p, best, bpos):
    """The lexicographic (score, position) order of the kernel's merges."""
    return (s < best) | ((s == best) & (p < bpos))


def _band_search_by_warps(planes, queries, bstarts, band_width, payload):
    """A numpy transcription of K4's scan order (csrc/nn_banded.cu). Per
    query block, each of 8 warps scores 16 of every tile's 128 candidates,
    tiles taken 4 at a time per band. Within a band a warp's positions
    increase, so a strict ``s < best`` (NaN never wins) keeps the first of
    equal scores; the band's winner merges into the warp's running winner
    by the full (score, position) rule, and then the 8 warps' winners merge
    by that rule in warp order. A query with no finite score takes the
    first position whose score is +inf, if any."""
    planes, q, bst = planes.numpy(), queries.numpy(), bstarts.numpy()
    tiles, band_tiles, nblocks = planes.shape[0], band_width // 128, q.shape[1] // 128
    rows = planes.transpose(1, 0, 2).reshape(8, -1)
    tile0 = np.clip(bst.reshape(nblocks, 9) // 128, 0, tiles - band_tiles)
    qx, qy, qz = (q[r].reshape(nblocks, 1, 128) for r in range(3))
    slices = np.arange(_K4_WARPS) * _K4_SLICE
    no_winner = np.int64(2**31 - 1)
    best = np.full((nblocks, _K4_WARPS, 128), np.inf, np.float32)
    bpos = np.full(best.shape, no_winner)
    with np.errstate(all="ignore"):
        for b in range(9):
            band_best, band_pos = np.full_like(best, np.inf), np.full_like(bpos, no_winner)
            for first in range(0, band_tiles, _K4_CHUNK_TILES):
                for j in range(min(_K4_CHUNK_TILES, band_tiles - first)):
                    slice_pos = (tile0[:, b, None] + first + j) * 128 + slices  # (nblocks, warps)
                    won = np.full(best.shape, -1)
                    for u in range(_K4_SLICE):
                        c0, c1, c2, c3 = (rows[r][slice_pos + u][..., None] for r in range(4))
                        s = c3 + ((qx * c0 + qy * c1) + qz * c2)
                        win = s < band_best
                        band_best, won = np.where(win, s, band_best), np.where(win, u, won)
                    band_pos = np.where(won >= 0, slice_pos[..., None] + won, band_pos)
            take = _before(band_best, band_pos, best, bpos)
            best, bpos = np.where(take, band_best, best), np.where(take, band_pos, bpos)
        score, pos = best[:, 0], bpos[:, 0]
        for w in range(1, _K4_WARPS):
            take = _before(best[:, w], bpos[:, w], score, pos)
            score, pos = np.where(take, best[:, w], score), np.where(take, bpos[:, w], pos)
        for blk, t in zip(*np.nonzero(score == np.inf)):
            cand = (tile0[blk, :, None] * 128 + np.arange(band_width)).reshape(-1)
            s = rows[3][cand] + ((qx[blk, 0, t] * rows[0][cand] + qy[blk, 0, t] * rows[1][cand])
                                 + qz[blk, 0, t] * rows[2][cand])
            if (s == np.inf).any():
                pos[blk, t] = cand[s == np.inf].min()
    score, pos = score.reshape(-1), pos.reshape(-1).astype(np.int32)
    pay = None
    if payload:
        found = pos != no_winner
        pay = np.where(found, rows[4:][:, np.where(found, pos, 0)], np.float32(0.0))
    return score, pos, pay


def _k4_case(case):
    """(DB points, normals, queries, cell, NaN query columns) of each case."""
    rng = np.random.default_rng(21)
    if case == "duplicates":  # each point three times, at different sorted positions: tied scores
        db = np.repeat(_cloud(3000, 22), 3, axis=0)[rng.permutation(9000)]
        queries = db[:900] + np.float32(0.001)
    elif case == "small_db":  # a DB smaller than one band: the bands overlap or coincide
        db, queries = _cloud(300, 23), _cloud(130, 24)
    else:
        db = _cloud(12000, 25)
        queries = np.concatenate([db[rng.integers(0, 12000, 500)] + rng.normal(0, 0.005, (500, 3)),
                                  rng.uniform(-0.2, 1.2, (499, 3))]).astype(np.float32)
    nrm = rng.normal(size=db.shape).astype(np.float32)
    cell = 0.25 if case == "small_db" else 0.05
    return db, nrm, queries, cell, (3, 200, 640) if case == "nan_query" else ()


@pytest.mark.parametrize("band_width", [128, 512, 1024])
@pytest.mark.parametrize("case", ["uniform", "duplicates", "small_db", "nan_query"])
def test_k4_scan_order_bitwise_against_twin(case, band_width):
    """The kernel's candidate split and merge rule, transcribed, give the
    twin's bits in both modes: scores, positions and payload."""
    db, nrm, queries, cell, nan_cols = _k4_case(case)
    grid = nn_banded.SortedGrid.build(_t(db), cell, normals=_t(nrm))
    lin = grid.cell_ids(_t(queries))
    order = torch.argsort(lin, stable=True)
    q_s = _t(queries)[order]
    for payload in (False, True):
        qplanes, bstarts, bw = nn_banded.search_inputs(grid, lin[order], q_s[:, 0], q_s[:, 1], q_s[:, 2],
                                                       band_width, anchor_on_min=payload)
        qplanes[:, list(nan_cols)] = torch.nan
        ref = nn_banded.band_search_plain(grid.planes, qplanes, bstarts, bw, payload)
        got = _band_search_by_warps(grid.planes, qplanes, bstarts, bw, payload)
        np.testing.assert_array_equal(got[0].view(np.uint32), ref[0].numpy().view(np.uint32))
        np.testing.assert_array_equal(got[1], ref[1].numpy())
        if payload:
            np.testing.assert_array_equal(got[2].view(np.uint32), ref[2].numpy().view(np.uint32))
        if case == "small_db":
            assert grid.planes.shape[0] * 128 < 512
        if nan_cols:
            assert (ref[1].numpy()[list(nan_cols)] == 2**31 - 1).all()


def test_k4_scan_order_first_inf_position():
    """Scores that overflow to +inf: a query block whose bands hold no finite
    score takes the first +inf position, as the twin does, and a NaN query
    none."""
    rng = np.random.default_rng(26)
    planes = _t(rng.normal(size=(6, 8, 128)).astype(np.float32))
    planes[:, 3, :] = torch.inf
    planes[2, 3, 50] = 1.0  # one finite candidate, which only the first block's bands reach
    queries = _t(rng.normal(size=(3, 256)).astype(np.float32))
    queries[:, 7] = torch.nan
    bstarts = torch.tensor([256, 384, 0, 128, 384, 0, 256, 128, 0] + [384, 384, 0, 0, 0, 0, 384, 0, 384],
                           dtype=torch.int32)
    for payload in (False, True):
        ref = nn_banded.band_search_plain(planes, queries, bstarts, 256, payload)
        got = _band_search_by_warps(planes, queries, bstarts, 256, payload)
        np.testing.assert_array_equal(got[0].view(np.uint32), ref[0].numpy().view(np.uint32))
        np.testing.assert_array_equal(got[1], ref[1].numpy())
        assert int(ref[1][0]) == 306 and int(ref[1][7]) == 2**31 - 1 and int(ref[1][128]) == 0
