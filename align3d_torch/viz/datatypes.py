"""Vertex-buffer datatypes for renderer interchange (port of
``align3d_tpu/viz/datatypes.py``, host numpy as there).

Counterpart of the reference GPU vertex formats
(``src/viz/geometry/datatypes.rs:16-86``): positions/normals are plain f32
triples here (device arrays already are), and the one format with actual
packing semantics — ``ColorU8``'s 0xRRGGBB-in-u32 encoding — is replicated
as vectorized pack/unpack helpers. The software renderer
(:mod:`align3d_torch.viz.render`) consumes float colors, so these exist for
parity and for compact color interchange (e.g. writing packed-color point
clouds).
"""

from __future__ import annotations

import numpy as np


def pack_color_u8(rgb: np.ndarray) -> np.ndarray:
    """(…, 3) u8 RGB -> (…,) u32 packed 0xRRGGBB (datatypes.rs:50-55)."""
    rgb = np.asarray(rgb, np.uint32)
    return (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]


def unpack_color_u8(packed: np.ndarray) -> np.ndarray:
    """(…,) u32 0xRRGGBB -> (…, 3) u8 RGB (datatypes.rs:57-64)."""
    packed = np.asarray(packed, np.uint32)
    return np.stack(
        [
            (packed >> 16) & 0xFF,
            (packed >> 8) & 0xFF,
            packed & 0xFF,
        ],
        axis=-1,
    ).astype(np.uint8)
