"""The least time of the align's work: frozen copies of the port's
``tools/roofline.py`` counts (``icp_step_bytes``, ``banded_step_bytes``,
``banded_step_flops``, ``centroids_bytes``, ``predict_bytes`` and their
flops), written from shapes and valid-pixel counts, and the published peaks
of one H100 SXM at 700 W (NVIDIA's data sheet).

Each input byte is counted once and each output byte once, whatever a
kernel reads again. The count is of the work, not of a kernel: a later
change that fuses, splits or graphs the kernels leaves it as it is.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

ICP_GEO_BYTES = 7 * 4  # target point, normal, validity where a source pixel lands
BANDED_FLOPS_PER_PIXEL = 150 + 2 * 128
CENTROID_FLOPS_PER_PIXEL = 11
PREDICT_FLOPS_PER_GROUP = 26
CHUNK = 16


def icp_step_bytes(pairs: int, h: int, w: int, valid: int) -> int:
    """The exact GN step over ``pairs`` pairs of h x w pixels with ``valid``
    valid source pixels in all: every source mask byte; a valid pixel's
    point, luma and the target geometry where it lands; each pair's
    bordered float32 intensity map once; the pose in, two 8x8 blocks out."""
    per_pair = (h + 2) * (w + 2) * 4 + 12 * 4 + 2 * 64 * 4
    return pairs * h * w + valid * (12 + 1 + ICP_GEO_BYTES) + pairs * per_pair


def banded_shape(h: int, w: int) -> tuple[int, int, int, int]:
    """(nchunks, groups, K, Hp) of the banded packs of an h x w level."""
    nchunks, groups = -(-h // CHUNK), -(-w // 128)
    return nchunks, groups, CHUNK * groups, nchunks * CHUNK


def banded_step_bytes(pairs: int, h: int, w: int, target_channels: int = 5) -> int:
    """The banded GN step (K8: 5 int32 target channels; K7: 7 float32): the
    source packs (z, luma), the target packs, the band bases, the poses and
    the two 8x8 blocks."""
    nchunks, groups, k, hp = banded_shape(h, w)
    source = pairs * nchunks * 2 * k * 128 * 4
    target = pairs * groups * target_channels * hp * 128 * 4
    bases = pairs * nchunks * (1 + 2 * groups) * 4
    return source + target + bases + pairs * 12 * 4 + pairs * 2 * 64 * 4


def banded_step_flops(pairs: int, h: int, w: int) -> int:
    nchunks, _, k, _ = banded_shape(h, w)
    return pairs * nchunks * k * 128 * BANDED_FLOPS_PER_PIXEL


def centroids_bytes(pairs: int, h: int, w: int) -> int:
    """The band prediction's source centroids (K9), once an align: the depth
    channel once, six float32 a (chunk, group) out."""
    nchunks, groups, k, _ = banded_shape(h, w)
    return pairs * nchunks * k * 128 * 4 + pairs * nchunks * groups * 6 * 4


def centroids_flops(pairs: int, h: int, w: int) -> int:
    nchunks, _, k, _ = banded_shape(h, w)
    return pairs * nchunks * k * 128 * CENTROID_FLOPS_PER_PIXEL


def predict_bytes(pairs: int, h: int, w: int) -> int:
    """The bases from the centroids (K10), once an iteration: the poses, six
    float32 a (chunk, group) in, the int32 bases out."""
    nchunks, groups, _, _ = banded_shape(h, w)
    return pairs * 12 * 4 + pairs * nchunks * groups * 6 * 4 + pairs * nchunks * (1 + 2 * groups) * 4


def predict_flops(pairs: int, h: int, w: int) -> int:
    nchunks, groups, _, _ = banded_shape(h, w)
    return pairs * nchunks * groups * PREDICT_FLOPS_PER_GROUP


def align_work(levels: list[dict], shapes: list[tuple[int, int]], pairs: int, valid: list[int]) -> tuple[int, int]:
    """(bytes, flops) of one multiscale align of ``pairs`` pairs: per level
    (fine -> coarse) its engine's step times its iterations, plus the
    banded engine's centroids once. ``valid``: the valid source pixels of
    each level over all pairs (read by the exact engine only)."""
    nbytes = flops = 0
    for level, (h, w), n_valid in zip(levels, shapes, valid):
        it = int(level["iterations"])
        if level["engine"] == "xla":
            nbytes += it * icp_step_bytes(pairs, h, w, n_valid)
        elif level["engine"] in ("pallas", "pallas_v4"):
            channels = 5 if level["engine"] == "pallas_v4" else 7
            nbytes += centroids_bytes(pairs, h, w) + it * (banded_step_bytes(pairs, h, w, channels)
                                                           + predict_bytes(pairs, h, w))
            flops += centroids_flops(pairs, h, w) + it * (banded_step_flops(pairs, h, w) + predict_flops(pairs, h, w))
        else:
            raise ValueError(f"no work count for engine {level['engine']!r}")
    return nbytes, flops


def least_seconds(nbytes: int, flops: int) -> float:
    """The larger of bytes over the HBM peak and flops over the float32 peak."""
    return max(nbytes / PEAK_HBM_BYTES, flops / PEAK_F32_FLOPS)
