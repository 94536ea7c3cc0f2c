"""Banded projective-ICP GN step, CUDA kernel K7 and its plain twin (port of
``align3d_tpu/ops/icp_pallas_v3.py``; the CUDA counterpart of the Pallas
engine ``engine="pallas"``).

The banded engines compute another function than the exact step
(:mod:`align3d_torch.ops.icp_fused`): a source pixel only finds its target
inside a predicted band. Source rows come in chunks of ``CHUNK`` = 16 and
columns in groups of 128 lanes. For chunk ``i`` the band starts at row
``chunk_base[i]``; for each (chunk, group) the predicted row and column
displacements ``dy_base``/``dx_base`` pick ``2 * radius + 1`` candidate
target rows and two 128-lane groups. A pixel whose projected
correspondence ``(vi, ui)`` lies outside them gathers zeros and gets weight
0. Membership reduces to arithmetic on the pixel's row ``s`` in its chunk::

    rb0s = clip(i * 16 + dy_base - R - chunk_base, 0, band_rows - (16 + 2R))
    ga = clip(floor((dx_base + 128 j - 64) / 128), 0, G - 2)   (0 when G == 1)
    matched = 0 <= vi - s - chunk_base - rb0s <= 2R  and  128 ga <= ui < 128 (ga + n_dg)

with ``band_rows = min(32, Hp)`` and ``n_dg = min(G, 2)``. The rest is the
exact step's arithmetic in the TPU kernel's form: the source x/y rebuilt
from the pixel ray, the target point from the target pixel's ray, the
normal-angle gate as ``dot <= f32(cos(angle)) & dot >= -1`` (no ``acos``),
the 3x3 intensity taps packed as u8 in float32 words, and both systems
reduced as one (16, N) stack ``aw @ a.T`` of which the two diagonal 8x8
blocks are returned (``[[H, g], [g^T, sum w r^2]]``, the weight sum at
[7, 7]).

The band prediction is two kernels of ``csrc/band_predict.cu``: K9, the
source centroids once per align (:func:`source_centroids_batched`, whose
float sums run in XLA's CPU order, a 16 x 32 window at a time, so that the
bases are the JAX package's bit for bit), and K10, the bases from the
projected centroids once per GN iteration
(:func:`predict_bases_centroid_batched`). Their twins
(:func:`source_centroids_plain`, :func:`predict_bases_centroid_plain`) give
the same bits.

:func:`icp_step_pallas_batched` launches ``csrc/icp_banded.cu`` (K7: float32
7-channel target pack, optional displacement stats) on a CUDA tensor, one
launch per call over all B pairs, and runs :func:`icp_step_plain`, the
vectorised twin, on a CPU tensor; K9 and K10 route the same way. Nothing else
selects between a kernel and its twin.
"""

from __future__ import annotations

import ctypes
import math

import torch

from align3d_torch import _kernels
from align3d_torch.camera import CameraIntrinsics
from align3d_torch.ops.icp_fused import _arrivals, _f32
from align3d_torch.ops.intensity import GRAD_H, GRAD_H_INV

CHUNK = 16  # source rows per chunk
HALO = 8  # extra target rows on each side of the chunk's predicted band
BAND = CHUNK + 2 * HALO
DY_RADIUS = 1  # default candidate-row radius around the predicted row
NCH = 7  # packed target channels
BLOCKS_PER_TILE = 2  # csrc/icp_banded.cu's blocks a (chunk, group) tile: partials per tile

# Read by benchmark/trace.py; goes when a benchmark change reads _kernels.launches() instead.
__getattr__ = _kernels.legacy_counts(__name__, {"CENTROIDS_LAUNCHES": "K9", "PREDICT_LAUNCHES": "K10"})

_XLA_WINDOW = 32  # XLA's CPU reduce: 16-row x 32-lane windows, each added in order
_INT_SUMS_MAX = 8192  # K9's integer sums of a tile's rows / columns stay below 2^24 up to this many


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _band(hp: int) -> int:
    return min(BAND, hp)


def _masked_z(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The packs' depth: z where the mask holds, else +0.0, NaN points too
    (XLA makes a select of the JAX package's product with the 0/1 mask)."""
    return torch.where(mask.bool(), points[..., 2], 0.0)


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """Integer-valued float32 -> int32 as XLA and CUDA convert: saturating,
    NaN to 0 (a CPU cast gives INT_MIN for both)."""
    return torch.nan_to_num(x.to(torch.float64), nan=0.0).clamp(-2.0**31, 2.0**31 - 1).to(torch.int32)


def _taps_u8(intensity_map: torch.Tensor, h: int, w: int) -> list[torch.Tensor]:
    """The 3x3 tap planes round(map * 255) of each pixel: tap (dv, du) at
    offsets (dv - 1, du - 1), from the bordered map with its first row and
    column repeated once more (as the JAX package's edge pre-pad)."""
    m = torch.cat([intensity_map[..., :1, :], intensity_map], dim=-2)
    m = torch.cat([m[..., :, :1], m], dim=-1)
    return [torch.round(m[..., dv : dv + h, du : du + w] * 255.0) for dv in range(3) for du in range(3)]


def _tile(channels: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(..., C, H, W) -> (..., G, C, Hp, 128) channel-major tiles, zero padded."""
    g, hp = _ceil_div(w, 128), _ceil_div(h, CHUNK) * CHUNK
    t = torch.nn.functional.pad(channels, (0, g * 128 - w, 0, hp - h))
    t = t.reshape(*t.shape[:-1], g, 128)  # (..., C, Hp, G, 128)
    return t.movedim(-2, -4).contiguous()


def pack_target(
    points: torch.Tensor,  # (..., H, W, 3) f32
    normals: torch.Tensor,  # (..., H, W, 3)
    mask: torch.Tensor,  # (..., H, W) bool
    intensity_map: torch.Tensor,  # (..., H+2, W+2) f32 bordered map
) -> torch.Tensor:
    """Target -> (..., G, 7, Hp, 128) float32 tiles: z (invalid pixels store
    exactly 0), nx, ny, nz, and the 9 u8 taps three to a word
    (``t0 * 65536 + t1 * 256 + t2``, exact in float32)."""
    h, w = mask.shape[-2:]
    taps = _taps_u8(intensity_map, h, w)
    channels = [
        _masked_z(points, mask),
        normals[..., 0],
        normals[..., 1],
        normals[..., 2],
        *(taps[k] * 65536.0 + taps[k + 1] * 256.0 + taps[k + 2] for k in (0, 3, 6)),
    ]
    return _tile(torch.stack(channels, dim=-3), h, w)


def pack_source(
    points: torch.Tensor,  # (..., H, W, 3)
    mask: torch.Tensor,  # (..., H, W)
    intensities: torch.Tensor,  # (..., H, W) u8
) -> torch.Tensor:
    """Source -> (..., nchunks, 2, CHUNK*G, 128) = [z, intensity], rows
    j-major (row r = j * CHUNK + s). Invalid pixels z = 0."""
    h, w = mask.shape[-2:]
    g, hp = _ceil_div(w, 128), _ceil_div(h, CHUNK) * CHUNK
    nchunks = hp // CHUNK
    s = torch.stack([_masked_z(points, mask), intensities.to(torch.float32)], dim=-3)
    s = torch.nn.functional.pad(s, (0, g * 128 - w, 0, hp - h))
    lead = s.shape[:-3]
    s = s.reshape(*lead, 2, nchunks, CHUNK, g, 128)
    n = len(lead)
    s = s.permute(*range(n), n + 1, n, n + 3, n + 2, n + 4)  # (..., nchunks, 2, G, CHUNK, 128)
    return s.reshape(*lead, nchunks, 2, g * CHUNK, 128).contiguous()


def _pixel_grid(nchunks: int, k: int, device, stride: int = 1):
    """(row (nchunks, K/stride, 1), col (K/stride, 128/stride)) float32 pixel
    coordinates of the source pack's rows and lanes (rows j-major)."""
    r_io = torch.arange(0, k, stride, device=device)
    lane = torch.arange(0, 128, stride, device=device)
    col = ((r_io // CHUNK)[:, None] * 128 + lane[None, :]).to(torch.float32)
    row = (torch.arange(nchunks, device=device)[:, None, None] * CHUNK + (r_io % CHUNK)[None, :, None])
    return row.to(torch.float32), col


def _rays(row: torch.Tensor, col: torch.Tensor, intrinsics: CameraIntrinsics):
    """Unit-depth pixel rays: ((col - cx) * f32(1/fx), (row - cy) * f32(1/fy))."""
    dirx = (col - _f32(intrinsics.cx)) * _f32(1.0 / intrinsics.fx)
    diry = (row - _f32(intrinsics.cy)) * _f32(1.0 / intrinsics.fy)
    return dirx, diry


def _rigid(rotation: torch.Tensor, translation: torch.Tensor, x, y, z, lead: int):
    """R (x, y, z) + t of (B, 3, 3) / (B, 3) poses, each output as
    ``((r0 x + r1 y) + r2 z) + t``; the pose broadcasts over ``lead`` axes."""
    shape = (rotation.shape[0],) + (1,) * lead
    r = rotation.reshape(-1, 9)
    out = []
    for row in range(3):
        r0, r1, r2 = (r[:, 3 * row + c].reshape(shape) for c in range(3))
        out.append(r0 * x + r1 * y + r2 * z + translation[:, row].reshape(shape))
    return out


def _project(px, py, pz, intrinsics: CameraIntrinsics):
    """(u, v, 1 / safe_z) of camera-space points."""
    safe_z = torch.where(pz == 0.0, _f32(1e-12), pz)
    inv_z = torch.reciprocal(safe_z)
    u = px * _f32(intrinsics.fx) * inv_z + _f32(intrinsics.cx)
    v = py * _f32(intrinsics.fy) * inv_z + _f32(intrinsics.cy)
    return u, v, inv_z


def _ray_uv(rotation, translation, source_pack, intrinsics, stride: int = 1):
    """Dense projection of the packed sources of B pairs under (R, t), (B, 3,
    3) and (B, 3); returns (u_int, v_int, valid) each (B, nchunks, K/stride,
    128/stride) and the row/col pixel maps. ``stride`` subsamples pixels."""
    z = source_pack[:, :, 0, ::stride, ::stride]
    nchunks, k = z.shape[1], source_pack.shape[3]
    row, col = _pixel_grid(nchunks, k, z.device, stride)
    dirx, diry = _rays(row, col, intrinsics)
    px, py, pz = _rigid(rotation, translation, dirx * z, diry * z, z, 3)
    pz_safe = torch.where(pz == 0.0, _f32(1e-12), pz)
    u = px * _f32(intrinsics.fx) / pz_safe + _f32(intrinsics.cx)
    v = py * _f32(intrinsics.fy) / pz_safe + _f32(intrinsics.cy)
    return torch.trunc(u + 0.5), torch.trunc(v + 0.5), z > 0, row, col


def _chunk_base(chunk_mean: torch.Tensor, hp: int) -> torch.Tensor:
    """Band start rows clip(i * CHUNK + round(mean) - HALO, 0, hp - band)."""
    chunk0 = torch.arange(chunk_mean.shape[-1], dtype=torch.int32, device=chunk_mean.device) * CHUNK
    return torch.clamp(chunk0 + _to_int32(torch.round(chunk_mean)) - HALO, 0, max(hp - _band(hp), 0))


def predict_bases_batched(rotation, translation, source_pack, intrinsics, h: int, stride: int = 1):
    """:func:`predict_bases` of B pairs: (B, 3, 3), (B, 3), (B, nchunks, 2, K, 128)."""
    nchunks, k = source_pack.shape[1], source_pack.shape[3]
    g, b = k // CHUNK, source_pack.shape[0]
    cs = CHUNK // stride
    u_int, v_int, m, row, col = _ray_uv(rotation, translation, source_pack, intrinsics, stride)
    mf = m.to(torch.float32)
    shape = (b, nchunks, g, cs, 128 // stride)
    dy = ((v_int - row) * mf).reshape(shape)  # integer-valued: exact sums in any order
    dx = ((u_int - col) * mf).reshape(shape)
    mfc = mf.reshape(shape)
    cnt = torch.clamp(mfc.sum(dim=(3, 4)), min=1.0)
    dy_base = torch.round(dy.sum(dim=(3, 4)) / cnt).to(torch.int32)
    dx_base = torch.round(dx.sum(dim=(3, 4)) / cnt).to(torch.int32)
    chunk_mean = dy.sum(dim=(2, 3, 4)) / torch.clamp(mfc.sum(dim=(2, 3, 4)), min=1.0)
    return _chunk_base(chunk_mean, nchunks * CHUNK), dy_base, dx_base


def predict_bases(rotation, translation, source_pack, intrinsics, h: int, stride: int = 1):
    """Per-chunk band starts and per-(chunk, group) row/col displacement
    bases from a dense (optionally strided) projection of the pose. Returns
    (chunk_base (nchunks,), dy_base (nchunks, G), dx_base (nchunks, G)) as
    int32."""
    out = predict_bases_batched(rotation[None], translation[None], source_pack[None], intrinsics, h, stride)
    return tuple(x[0] for x in out)


def _group_sums(a: torch.Tensor) -> torch.Tensor:
    """(..., nchunks, K, 128) -> (..., nchunks, G): the sum over each
    group's (CHUNK, 128) block in XLA's CPU order: each 16-row x 32-lane
    window added element by element in row-major order from 0, then the
    four window sums in order."""
    *lead, nchunks, k, _ = a.shape
    g = k // CHUNK
    nwin = 128 // _XLA_WINDOW
    win = a.reshape(*lead, nchunks, g, CHUNK, nwin, _XLA_WINDOW).movedim(-2, -3)
    win = win.reshape(*lead, nchunks, g, nwin, CHUNK * _XLA_WINDOW)
    part = torch.zeros(win.shape[:-1], dtype=a.dtype, device=a.device)
    for e in range(win.shape[-1]):
        part = part + win[..., e]
    total = torch.zeros(part.shape[:-1], dtype=a.dtype, device=a.device)
    for e in range(nwin):
        total = total + part[..., e]
    return total


def source_centroids_plain(source_pack: torch.Tensor, intrinsics: CameraIntrinsics):
    """The plain-PyTorch twin of K9 (same arguments and returns as
    :func:`source_centroids_batched`)."""
    z = source_pack[:, :, 0]
    nchunks, k = z.shape[1], z.shape[2]
    row, col = _pixel_grid(nchunks, k, z.device)
    dirx, diry = _rays(row, col, intrinsics)
    m = (z > 0).to(torch.float32)
    sums = _group_sums(torch.stack([m, dirx * z, diry * z, z, row * m, col * m]))
    cnt = sums[0]
    safe = torch.clamp(cnt, min=1.0)
    pbar = torch.stack([sums[1], sums[2], sums[3]], dim=-1) / safe[..., None]
    return pbar, sums[4] / safe, sums[5] / safe, cnt


def source_centroids_batched(source_pack: torch.Tensor, intrinsics: CameraIntrinsics):
    """:func:`source_centroids` of B pairs, (B, nchunks, 2, K, 128): on a
    CUDA tensor one launch of K9, on a CPU tensor :func:`source_centroids_plain`."""
    if source_pack.device.type == "cpu":
        return source_centroids_plain(source_pack, intrinsics)
    if source_pack.device.type != "cuda":
        raise ValueError(f"source_centroids_batched runs on cuda or cpu tensors, got {source_pack.device}")
    dev = source_pack.device
    bsz, nchunks, _, k, _ = source_pack.shape
    g = k // CHUNK
    _kernels.check_tensor(source_pack, "source_pack", (bsz, nchunks, 2, g * CHUNK, 128), torch.float32, dev)
    if max(nchunks * CHUNK, g * 128) > _INT_SUMS_MAX:
        raise ValueError(f"K9 sums a tile's rows and columns as exact integers: at most {_INT_SUMS_MAX} of each, "
                         f"got {nchunks * CHUNK} x {g * 128}")
    tiles = bsz * nchunks * g
    out = torch.empty(tiles * 6, dtype=torch.float32, device=dev)  # one allocation, four contiguous outputs
    pbar = out[: 3 * tiles].view(bsz, nchunks, g, 3)
    rowbar, colbar, cnt = (out[k * tiles : (k + 1) * tiles].view(bsz, nchunks, g) for k in (3, 4, 5))
    _kernels.launch(
        "K9", source_pack.data_ptr(), bsz, nchunks, g, _f32(intrinsics.cx), _f32(intrinsics.cy),
        _f32(1.0 / intrinsics.fx), _f32(1.0 / intrinsics.fy), pbar.data_ptr(), rowbar.data_ptr(),
        colbar.data_ptr(), cnt.data_ptr(), ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    return pbar, rowbar, colbar, cnt


def source_centroids(source_pack: torch.Tensor, intrinsics: CameraIntrinsics):
    """Per-(chunk, group) masked mean source point and mean pixel row/col,
    once per align; feeds :func:`predict_bases_centroid`. Returns (pbar
    (nchunks, G, 3), rowbar (nchunks, G), colbar (nchunks, G), cnt
    (nchunks, G))."""
    return tuple(x[0] for x in source_centroids_batched(source_pack[None], intrinsics))


def predict_bases_centroid_plain(rotation, translation, centroids, intrinsics, hp: int):
    """The plain-PyTorch twin of K10 (same arguments and returns as
    :func:`predict_bases_centroid_batched`)."""
    pbar, rowbar, colbar, cnt = centroids
    px, py, pz = _rigid(rotation, translation, pbar[..., 0], pbar[..., 1], pbar[..., 2], 2)
    safe_z = torch.where(pz == 0.0, _f32(1e-12), pz)
    u = px * _f32(intrinsics.fx) / safe_z + _f32(intrinsics.cx)
    v = py * _f32(intrinsics.fy) / safe_z + _f32(intrinsics.cy)
    dyf, dxf = v - rowbar, u - colbar
    have = cnt > 0
    dy_base = _to_int32(torch.where(have, torch.round(dyf), 0.0))
    dx_base = _to_int32(torch.where(have, torch.round(dxf), 0.0))
    chunk_cnt = torch.clamp(cnt.sum(dim=-1), min=1.0)
    chunk_mean = (torch.where(have, dyf, 0.0) * cnt).sum(dim=-1) / chunk_cnt
    return _chunk_base(chunk_mean, hp), dy_base, dx_base


def predict_bases_centroid_batched(rotation, translation, centroids, intrinsics, hp: int):
    """:func:`predict_bases_centroid` of B pairs: (B, 3, 3), (B, 3), the
    centroids of :func:`source_centroids_batched`. On a CUDA tensor one
    launch of K10, which reads the poses on the device; on a CPU tensor
    :func:`predict_bases_centroid_plain`."""
    if rotation.device.type == "cpu":
        return predict_bases_centroid_plain(rotation, translation, centroids, intrinsics, hp)
    if rotation.device.type != "cuda":
        raise ValueError(f"predict_bases_centroid_batched runs on cuda or cpu tensors, got {rotation.device}")
    dev = rotation.device
    pbar, rowbar, colbar, cnt = centroids
    bsz, nchunks, g = cnt.shape
    f32, i32 = torch.float32, torch.int32
    _kernels.check_tensor(rotation, "rotation", (bsz, 3, 3), f32, dev)
    _kernels.check_tensor(translation, "translation", (bsz, 3), f32, dev)
    _kernels.check_tensor(pbar, "pbar", (bsz, nchunks, g, 3), f32, dev)
    for name, t in (("rowbar", rowbar), ("colbar", colbar), ("cnt", cnt)):
        _kernels.check_tensor(t, name, (bsz, nchunks, g), f32, dev)
    tiles = bsz * nchunks * g
    out = torch.empty(bsz * nchunks + 2 * tiles, dtype=i32, device=dev)  # one allocation, three outputs
    chunk_base = out[: bsz * nchunks].view(bsz, nchunks)
    dy_base, dx_base = (out[bsz * nchunks + k * tiles : bsz * nchunks + (k + 1) * tiles].view(bsz, nchunks, g)
                        for k in (0, 1))
    _kernels.launch(
        "K10", rotation.data_ptr(), translation.data_ptr(), pbar.data_ptr(), rowbar.data_ptr(), colbar.data_ptr(),
        cnt.data_ptr(), bsz, nchunks, g, _f32(intrinsics.fx), _f32(intrinsics.fy), _f32(intrinsics.cx),
        _f32(intrinsics.cy), max(hp - _band(hp), 0), chunk_base.data_ptr(), dy_base.data_ptr(), dx_base.data_ptr(),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    return chunk_base, dy_base, dx_base


def predict_bases_centroid(rotation, translation, centroids, intrinsics, hp: int):
    """(chunk_base, dy_base, dx_base) from one projected centroid per
    (chunk, group): :func:`predict_bases`'s contract at O(nchunks * G) work
    per GN iteration."""
    batched = tuple(c[None] for c in centroids)
    return tuple(x[0] for x in predict_bases_centroid_batched(rotation[None], translation[None], batched,
                                                              intrinsics, hp))


def bases_from_stats_batched(stats, prev_dy_base, prev_dx_base, hp: int):
    """:func:`bases_from_stats` of B pairs: (B, nchunks, 3, G, 8, 128)."""
    sums = stats.sum(dim=(-2, -1))  # integer-valued partials: exact in any order
    dy_sum, dx_sum, cnt = sums[:, :, 0], sums[:, :, 1], sums[:, :, 2]
    safe = torch.clamp(cnt, min=1.0)
    dy_base = torch.where(cnt > 0, torch.round(dy_sum / safe).to(torch.int32), prev_dy_base)
    dx_base = torch.where(cnt > 0, torch.round(dx_sum / safe).to(torch.int32), prev_dx_base)
    chunk_mean = dy_sum.sum(dim=-1) / torch.clamp(cnt.sum(dim=-1), min=1.0)
    return _chunk_base(chunk_mean, hp), dy_base, dx_base


def bases_from_stats(stats, prev_dy_base, prev_dx_base, hp: int):
    """Fold the kernel's displacement stats (nchunks, 3, G, 8, 128) into the
    next iteration's (chunk_base, dy_base, dx_base)."""
    out = bases_from_stats_batched(stats[None], prev_dy_base[None], prev_dx_base[None], hp)
    return tuple(x[0] for x in out)


# -- the step ------------------------------------------------------------------


def step_constants(params_tuple: tuple) -> dict:
    """The float32 thresholds and the band radius of a params tuple
    ``(max_distance, max_normal_angle, max_color_distance[, radius[,
    huber_delta]])``, as the TPU kernels take them."""
    max_distance, max_normal_angle, max_color_distance = params_tuple[:3]
    radius = int(params_tuple[3]) if len(params_tuple) > 3 else DY_RADIUS
    huber = float(params_tuple[4]) if len(params_tuple) > 4 else 0.0
    if huber < 0.0:
        raise ValueError(f"huber_delta must be positive or 0 (off), got {huber}")
    return {
        "max_dist2": _f32(float(max_distance) ** 2),
        "cos_angle": _f32(math.cos(_f32(max_normal_angle))),
        "max_color2": _f32(float(max_color_distance) ** 2),
        "radius": radius,
        "huber": _f32(huber),
    }


def params_to_tuple(params) -> tuple:
    """The params tuple of an :class:`~align3d_torch.icp.params.IcpParams`."""
    huber = 0.0 if params.huber_delta is None else params.huber_delta
    return (params.max_distance, params.max_normal_angle, params.max_color_distance, params.band_radius, huber)


def _banded_gather(ui, vi, cb, dyb, dxb, target_planes, radius: int):
    """The banded association of the plain twins: each pixel's target
    channels at (vi, ui) where that lies in its band, else zeros.

    ``ui``/``vi`` are (B, nchunks, K, 128) int64, ``cb`` (B, nchunks) and
    ``dyb``/``dxb`` (B, nchunks, G); ``target_planes`` (B, C, Hp, G*128).
    Returns (B, C, nchunks, K, 128) in the planes' dtype."""
    bsz, nchunks, k, _ = ui.shape
    g = k // CHUNK
    hp = target_planes.shape[2]
    dev = ui.device
    n_dg = 2 if g > 1 else 1
    jj = torch.arange(k, device=dev) // CHUNK
    s_in = (torch.arange(k, device=dev) % CHUNK)[None, None, :, None]
    chunk_row = (torch.arange(nchunks, device=dev) * CHUNK)[None, :, None]
    cb3 = cb.to(torch.int64)[:, :, None]
    rb0s = torch.clamp(chunk_row + dyb.to(torch.int64) - radius - cb3, 0, _band(hp) - (CHUNK + 2 * radius))
    if g > 1:
        j128 = (torch.arange(g, device=dev) * 128)[None, None, :]
        ga = torch.clamp(torch.div(dxb.to(torch.int64) + j128 - 64, 128, rounding_mode="floor"), 0, g - n_dg)
    else:
        ga = torch.zeros_like(dyb, dtype=torch.int64)
    rel = vi - s_in - cb3[..., None] - rb0s[:, :, jj, None]
    lo = ga[:, :, jj, None] * 128
    matched = (rel >= 0) & (rel <= 2 * radius) & (ui >= lo) & (ui < lo + 128 * n_dg)
    flat = target_planes.reshape(bsz, target_planes.shape[1], -1)
    index = (vi * target_planes.shape[3] + ui).reshape(bsz, 1, -1).expand(-1, flat.shape[1], -1)
    got = torch.gather(flat, 2, index).reshape(bsz, -1, nchunks, k, 128)
    return torch.where(matched[:, None], got, torch.zeros((), dtype=got.dtype, device=dev))


def _planes(target_pack: torch.Tensor) -> torch.Tensor:
    """(B, G, C, Hp, 128) tiles -> (B, C, Hp, G*128) planes."""
    b, g, c, hp, _ = target_pack.shape
    return target_pack.permute(0, 2, 3, 1, 4).reshape(b, c, hp, g * 128)


def _unpack_taps_f32(words) -> list[torch.Tensor]:
    """K7's three tap words -> 9 taps in [0, 1]: the bytes by
    ``floor(word * f32(1/65536))`` and ``floor(rem * f32(1/256))``."""
    inv255 = _f32(1.0 / 255.0)
    taps = []
    for word in words:
        a = torch.floor(word * _f32(1.0 / 65536.0))
        rem = word - a * 65536.0
        bb = torch.floor(rem * _f32(1.0 / 256.0))
        cc = rem - bb * 256.0
        taps += [a * inv255, bb * inv255, cc * inv255]
    return taps


def plain_step(rotation, translation, cb, dyb, dxb, source_pack, target_pack, intrinsics, h: int, w: int,
               params_tuple: tuple, decode, bf16_stack: bool, emit_stats: bool):
    """The plain twin shared by K7 and K8: association, gates, residuals and
    Jacobians of every source pixel, then the (16, N) stack reduced as
    ``aw @ a.T`` per system, in float32 (``bf16_stack``: the stack and the
    weighted stack rounded to bf16 first, as K8). ``decode`` maps the
    gathered channels (B, C, nchunks, K, 128) to (tz, nx, ny, nz, 9 taps).
    Returns (geo (B, 8, 8), col (B, 8, 8), stats (B, nchunks, 3, G, 8, 128)
    or None)."""
    c = step_constants(params_tuple)
    f32 = torch.float32
    bsz, nchunks, _, k, _ = source_pack.shape
    g = k // CHUNK
    z, s_int = source_pack[:, :, 0], source_pack[:, :, 1]
    row_f, col_f = _pixel_grid(nchunks, k, z.device)
    dirx, diry = _rays(row_f, col_f, intrinsics)
    px, py, pz = _rigid(rotation, translation, dirx * z, diry * z, z, 3)
    u, v, inv_z = _project(px, py, pz, intrinsics)

    u_int, v_int = torch.trunc(u + 0.5), torch.trunc(v + 0.5)
    inb = (u_int >= 0) & (u_int < w) & (v_int >= 0) & (v_int < h)
    ui = torch.nan_to_num(u_int, nan=0.0).clamp(0, w - 1).to(torch.int64)
    vi = torch.nan_to_num(v_int, nan=0.0).clamp(0, h - 1).to(torch.int64)
    gathered = _banded_gather(ui, vi, cb, dyb, dxb, _planes(target_pack), c["radius"])
    tz, nx_, ny_, nz_, taps = decode(gathered)
    tvalid = tz > 0.0

    uif, vif = ui.to(f32), vi.to(f32)
    tpx = (uif - _f32(intrinsics.cx)) * tz * _f32(1.0 / intrinsics.fx)
    tpy = (vif - _f32(intrinsics.cy)) * tz * _f32(1.0 / intrinsics.fy)
    dx_, dy_, dz_ = tpx - px, tpy - py, tz - pz
    dist_ok = dx_ * dx_ + dy_ * dy_ + dz_ * dz_ <= c["max_dist2"]
    dot_pn = px * nx_ + py * ny_ + pz * nz_
    angle_rejected = (dot_pn <= c["cos_angle"]) & (dot_pn >= -1.0)
    valid = (z > 0) & inb & tvalid
    w_geom = (valid & dist_ok & ~angle_rejected).to(f32)

    r_geom = dx_ * nx_ + dy_ * ny_ + dz_ * nz_
    if c["huber"] > 0.0:
        abs_r = torch.abs(r_geom)
        hub = torch.full_like(abs_r, c["huber"]) / torch.clamp(abs_r, min=_f32(1e-30))
        w_geom = w_geom * torch.where(abs_r <= c["huber"], 1.0, hub)
    jg3 = py * nz_ - pz * ny_
    jg4 = pz * nx_ - px * nz_
    jg5 = px * ny_ - py * nx_

    u_s = torch.clamp(u, 0.0, float(w - 1))
    v_s = torch.clamp(v, 0.0, float(h - 1))
    u0, v0 = torch.trunc(u_s), torch.trunc(v_s)
    fu, fv = u_s - u0, v_s - v0
    cu1 = torch.nan_to_num(u0, nan=-1.0).to(torch.int64) == ui
    cv1 = torch.nan_to_num(v0, nan=-1.0).to(torch.int64) == vi

    def row_sel(col):
        return torch.where(cv1, taps[3 + col], taps[col]), torch.where(cv1, taps[6 + col], taps[3 + col])

    r0c0, r1c0 = row_sel(0)
    r0c1, r1c1 = row_sel(1)
    r0c2, r1c2 = row_sel(2)
    t00, t01 = torch.where(cu1, r0c1, r0c0), torch.where(cu1, r0c2, r0c1)
    t10, t11 = torch.where(cu1, r1c1, r1c0), torch.where(cu1, r1c2, r1c1)

    def lerp2(a00, a01, a10, a11, fuu, fvv):
        r0 = a00 * (1.0 - fuu) + a01 * fuu
        r1 = a10 * (1.0 - fuu) + a11 * fuu
        return r0 * (1.0 - fvv) + r1 * fvv

    value = lerp2(t00, t01, t10, t11, fu, fv)
    uh_c = u_s + _f32(GRAD_H)
    u0h = torch.trunc(uh_c)
    cross_u = u0h > u0
    uh = lerp2(torch.where(cross_u, t01, t00), torch.where(cross_u, r0c2, t01),
               torch.where(cross_u, t11, t10), torch.where(cross_u, r1c2, t11), uh_c - u0h, fv)
    vh_c = v_s + _f32(GRAD_H)
    v0h = torch.trunc(vh_c)
    cross_v = v0h > v0
    t20, t21 = torch.where(cu1, taps[7], taps[6]), torch.where(cu1, taps[8], taps[7])
    vh = lerp2(torch.where(cross_v, t10, t00), torch.where(cross_v, t11, t01),
               torch.where(cross_v, t20, t10), torch.where(cross_v, t21, t11), fu, vh_c - v0h)
    du_g = (uh - value) * _f32(GRAD_H_INV)
    dv_g = (vh - value) * _f32(GRAD_H_INV)

    r_color = s_int * _f32(0.003921569) - value
    w_color = w_geom * (r_color * r_color <= c["max_color2"]).to(f32)
    fx, fy = _f32(intrinsics.fx), _f32(intrinsics.fy)
    gx = du_g * fx * inv_z
    gy = dv_g * fy * inv_z
    gz = -(du_g * px * fx + dv_g * py * fy) * inv_z * inv_z
    jc3 = py * gz - pz * gy
    jc4 = pz * gx - px * gz
    jc5 = px * gy - py * gx

    ones = torch.ones_like(w_geom)
    blocks = []
    for chans, wt in (((nx_, ny_, nz_, jg3, jg4, jg5, r_geom, ones), w_geom),
                      ((gx, gy, gz, jc3, jc4, jc5, r_color, ones), w_color)):
        a = torch.stack(chans, dim=1).reshape(bsz, 8, -1)
        wt = wt.reshape(bsz, 1, -1)
        if bf16_stack:
            a = a.to(torch.bfloat16).to(f32)
            aw = (a * wt.to(torch.bfloat16).to(f32)).to(torch.bfloat16).to(f32)
        else:
            aw = a * wt
        blocks.append(torch.bmm(aw, a.transpose(1, 2)))
    stats = None
    if emit_stats:
        # A select, as XLA makes of the product with the 0/1 weight: +0 off the weight.
        pw = (z > 0) & inb
        vals = torch.stack([torch.where(pw, v_int - row_f, 0.0), torch.where(pw, u_int - col_f, 0.0), pw.to(f32)],
                           dim=2)  # (B, nchunks, 3, K, 128)
        vals = vals.reshape(bsz, nchunks, 3, g, 2, 8, 128)
        stats = vals[:, :, :, :, 0] + vals[:, :, :, :, 1]
    return blocks[0], blocks[1], stats


def _decode(gathered: torch.Tensor):
    return gathered[:, 0], gathered[:, 1], gathered[:, 2], gathered[:, 3], _unpack_taps_f32(gathered[:, 4:7].unbind(1))


def icp_step_plain(rotation, translation, chunk_base, dy_base, dx_base, source_pack, target_pack, intrinsics,
                   h: int, w: int, params_tuple: tuple, emit_stats: bool = True):
    """The plain-PyTorch twin of K7 (same arguments and returns as
    :func:`icp_step_pallas_batched`)."""
    return plain_step(rotation, translation, chunk_base, dy_base, dx_base, source_pack, target_pack, intrinsics,
                      h, w, params_tuple, _decode, False, emit_stats)


def launch(variant: int, rotation, translation, chunk_base, dy_base, dx_base, source_pack, target_pack,
           intrinsics: CameraIntrinsics, h: int, w: int, params_tuple: tuple, emit_stats: bool, nch: int,
           pack_dtype: torch.dtype, library=None):
    """One launch of ``csrc/icp_banded.cu`` over B pairs: ``variant`` 0 is
    K7 (float32 pack), 1 is K8 (int32 pack, bf16 stack). Returns (geo, col,
    stats or None). ``library``: another build of the source (the ablation
    tool's); the library's by default."""
    dev = rotation.device
    bsz, nchunks, _, k, _ = source_pack.shape
    g = k // CHUNK
    hp = nchunks * CHUNK
    f32, i32 = torch.float32, torch.int32
    _kernels.check_tensor(rotation, "rotation", (bsz, 3, 3), f32, dev)
    _kernels.check_tensor(translation, "translation", (bsz, 3), f32, dev)
    _kernels.check_tensor(chunk_base, "chunk_base", (bsz, nchunks), i32, dev)
    _kernels.check_tensor(dy_base, "dy_base", (bsz, nchunks, g), i32, dev)
    _kernels.check_tensor(dx_base, "dx_base", (bsz, nchunks, g), i32, dev)
    _kernels.check_tensor(source_pack, "source_pack", (bsz, nchunks, 2, k, 128), f32, dev)
    _kernels.check_tensor(target_pack, "target_pack", (bsz, g, nch, hp, 128), pack_dtype, dev)
    if not (0 < h <= hp and 0 < w <= g * 128):
        raise ValueError(f"h, w = {h}, {w} do not fit the packs' {hp} x {g * 128}")
    c = step_constants(params_tuple)
    tiles = nchunks * g
    stream = torch.cuda.current_stream(dev).cuda_stream
    partials = torch.empty((bsz, tiles * BLOCKS_PER_TILE, 128), dtype=f32, device=dev)
    arrivals = _arrivals(dev, stream, bsz)  # shared with K1: launches on a stream run in order
    out = torch.empty((bsz, 2, 8, 8), dtype=f32, device=dev)
    stats = torch.empty((bsz, nchunks, 3, g, 8, 128), dtype=f32, device=dev) if emit_stats else None
    _kernels.launch(
        ("K7", "K8")[variant], variant, rotation.data_ptr(), translation.data_ptr(), chunk_base.data_ptr(),
        dy_base.data_ptr(), dx_base.data_ptr(), source_pack.data_ptr(), target_pack.data_ptr(),
        bsz, nchunks, g, h, w, c["radius"],
        _f32(intrinsics.fx), _f32(intrinsics.fy), _f32(intrinsics.cx), _f32(intrinsics.cy),
        _f32(1.0 / intrinsics.fx), _f32(1.0 / intrinsics.fy),
        c["max_dist2"], c["cos_angle"], c["max_color2"], c["huber"],
        partials.data_ptr(), arrivals.data_ptr(), out.data_ptr(), 0 if stats is None else stats.data_ptr(),
        ctypes.c_void_p(stream), library=library,
    )
    return out[:, 0], out[:, 1], stats


def icp_step_pallas_batched(
    rotation: torch.Tensor,  # (B, 3, 3)
    translation: torch.Tensor,  # (B, 3)
    chunk_base: torch.Tensor,  # (B, nchunks) i32
    dy_base: torch.Tensor,  # (B, nchunks, G) i32
    dx_base: torch.Tensor,  # (B, nchunks, G) i32
    source_pack: torch.Tensor,  # (B, nchunks, 2, K, 128) f32
    target_pack: torch.Tensor,  # (B, G, 7, Hp, 128) f32
    intrinsics: CameraIntrinsics,
    h: int,
    w: int,
    params_tuple: tuple,  # (max_distance, max_normal_angle, max_color_distance[, radius[, huber]])
    emit_stats: bool = True,
):
    """One banded GN accumulation over B pairs: (geo_aug (B, 8, 8),
    color_aug (B, 8, 8), stats (B, nchunks, 3, G, 8, 128) or None). On a
    CUDA tensor one launch of K7; on a CPU tensor :func:`icp_step_plain`."""
    args = (rotation, translation, chunk_base, dy_base, dx_base, source_pack, target_pack, intrinsics, h, w,
            params_tuple)
    if rotation.device.type == "cpu":
        return icp_step_plain(*args, emit_stats=emit_stats)
    if rotation.device.type != "cuda":
        raise ValueError(f"icp_step_pallas_batched runs on cuda or cpu tensors, got {rotation.device}")
    return launch(0, *args, emit_stats, NCH, torch.float32)


def icp_step_pallas(rotation, translation, chunk_base, dy_base, dx_base, source_pack, target_pack, intrinsics,
                    h: int, w: int, params_tuple: tuple, emit_stats: bool = True):
    """Single-pair form of :func:`icp_step_pallas_batched`."""
    geo, col, stats = icp_step_pallas_batched(
        rotation[None], translation[None], chunk_base[None], dy_base[None], dx_base[None], source_pack[None],
        target_pack[None], intrinsics, h, w, params_tuple, emit_stats,
    )
    return geo[0], col[0], stats[0] if emit_stats else None
