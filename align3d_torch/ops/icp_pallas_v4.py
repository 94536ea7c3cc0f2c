"""Banded projective-ICP GN step on the slim int-packed target, CUDA kernel
K8 and its plain twin (port of ``align3d_tpu/ops/icp_pallas_v4.py``; the
CUDA counterpart of the Pallas engine ``engine="pallas_v4"``).

The association, gates and residuals of K7 (:mod:`icp_pallas_v3`), on a
5-channel int32 target pack:

    c0: float32 bits of z (invalid pixels store exactly 0)
    c1: bf16 bits of nx << 16 | bf16 bits of ny
    c2: bf16 bits of nz << 16 | tap[8] (u8)
    c3: taps[0..3], 4 x u8      c4: taps[4..7], 4 x u8

Normals are rounded to nearest-even bf16. The (16, N) reduction stack is
rounded to bf16 as well: each channel ``a`` and each weight ``w``, then
``aw = bf16(a * w)``; the products ``aw * a`` are exact in float32 and are
added in float32. There are no stats: the align loops re-predict the bands
from the source centroids.

:func:`icp_step_pallas_batched` launches ``csrc/icp_banded.cu`` (K8) on a
CUDA tensor, one launch per call over all B pairs, and runs
:func:`icp_step_plain` on a CPU tensor. Nothing else selects between the
two.
"""

from __future__ import annotations

import torch

from align3d_torch import _kernels
from align3d_torch.ops import icp_pallas_v3 as k3
from align3d_torch.ops.icp_fused import _f32
from align3d_torch.ops.icp_pallas_v3 import CHUNK, DY_RADIUS, pack_source  # noqa: F401  (v4 shares v3's source pack)

NCH = 5  # packed target channels (int32)

# Read by benchmark/trace.py; goes when a benchmark change reads _kernels.launches() instead.
__getattr__ = _kernels.legacy_counts(__name__, {"LAUNCHES": "K8"})

_MASK_HI = -65536  # 0xFFFF0000 as an int32


def _bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 holding the round-to-nearest-even bf16 bit pattern
    (low 16 bits)."""
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF


def pack_target(
    points: torch.Tensor,  # (..., H, W, 3) f32
    normals: torch.Tensor,  # (..., H, W, 3)
    mask: torch.Tensor,  # (..., H, W) bool
    intensity_map: torch.Tensor,  # (..., H+2, W+2) f32 bordered map
) -> torch.Tensor:
    """Target -> (..., G, 5, Hp, 128) int32 tiles; invalid pixels store z = 0."""
    h, w = mask.shape[-2:]
    taps = [t.to(torch.int32) for t in k3._taps_u8(intensity_map, h, w)]
    z = k3._masked_z(points, mask).contiguous()
    c0 = z.view(torch.int32)
    c1 = (_bf16_bits(normals[..., 0]) << 16) | _bf16_bits(normals[..., 1])
    c2 = (_bf16_bits(normals[..., 2]) << 16) | taps[8]
    c3 = (taps[0] << 24) | (taps[1] << 16) | (taps[2] << 8) | taps[3]
    c4 = (taps[4] << 24) | (taps[5] << 16) | (taps[6] << 8) | taps[7]
    return k3._tile(torch.stack([c0, c1, c2, c3, c4], dim=-3), h, w)


def _as_f32(bits: torch.Tensor) -> torch.Tensor:
    return bits.contiguous().view(torch.float32)


def _decode(words: torch.Tensor):
    """Gathered (B, 5, ...) int32 words -> (tz, nx, ny, nz, 9 taps)."""
    inv255 = _f32(1.0 / 255.0)
    w1, w2, w3, w4 = words[:, 1], words[:, 2], words[:, 3], words[:, 4]

    def byte(word, shift):
        return ((word >> shift) & 0xFF).to(torch.float32) * inv255

    taps = [byte(w3, 24), byte(w3, 16), byte(w3, 8), byte(w3, 0),
            byte(w4, 24), byte(w4, 16), byte(w4, 8), byte(w4, 0), byte(w2, 0)]
    return (_as_f32(words[:, 0]), _as_f32(w1 & _MASK_HI), _as_f32(w1 << 16), _as_f32(w2 & _MASK_HI), taps)


def icp_step_plain(rotation, translation, chunk_base, dy_base, dx_base, source_pack, target_pack, intrinsics,
                   h: int, w: int, params_tuple: tuple):
    """The plain-PyTorch twin of K8 (same arguments and returns as
    :func:`icp_step_pallas_batched`): K7's twin on the decoded int pack,
    with the stack rounded to bf16 (``.to(torch.bfloat16)``, nearest even)."""
    geo, col, _ = k3.plain_step(rotation, translation, chunk_base, dy_base, dx_base, source_pack, target_pack,
                                intrinsics, h, w, params_tuple, _decode, True, False)
    return geo, col


def icp_step_pallas_batched(
    rotation: torch.Tensor,  # (B, 3, 3)
    translation: torch.Tensor,  # (B, 3)
    chunk_base: torch.Tensor,  # (B, nchunks) i32
    dy_base: torch.Tensor,  # (B, nchunks, G) i32
    dx_base: torch.Tensor,  # (B, nchunks, G) i32
    source_pack: torch.Tensor,  # (B, nchunks, 2, K, 128) f32
    target_pack: torch.Tensor,  # (B, G, 5, Hp, 128) i32
    intrinsics,
    h: int,
    w: int,
    params_tuple: tuple,  # (max_distance, max_normal_angle, max_color_distance[, radius[, huber]])
):
    """One banded GN accumulation over B pairs: (geo_aug (B, 8, 8),
    color_aug (B, 8, 8)). On a CUDA tensor one launch of K8; on a CPU tensor
    :func:`icp_step_plain`."""
    args = (rotation, translation, chunk_base, dy_base, dx_base, source_pack, target_pack, intrinsics, h, w,
            params_tuple)
    if rotation.device.type == "cpu":
        return icp_step_plain(*args)
    if rotation.device.type != "cuda":
        raise ValueError(f"icp_step_pallas_batched runs on cuda or cpu tensors, got {rotation.device}")
    geo, col, _ = k3.launch(1, *args, False, NCH, torch.int32)
    return geo, col


def icp_step_pallas(rotation, translation, chunk_base, dy_base, dx_base, source_pack, target_pack, intrinsics,
                    h: int, w: int, params_tuple: tuple):
    """Single-pair form of :func:`icp_step_pallas_batched`."""
    geo, col = icp_step_pallas_batched(
        rotation[None], translation[None], chunk_base[None], dy_base[None], dx_base[None], source_pack[None],
        target_pack[None], intrinsics, h, w, params_tuple,
    )
    return geo[0], col[0]
