"""An animated-GIF encoder on numpy, for the renderer's fly-throughs.

Every frame is quantized to one fixed 256-colour palette, 3-3-2: eight
levels of red and of green and four of blue, spread evenly over 0-255
(``round(k * 255 / 7)`` and ``k * 85``), each channel to its nearest level.
So a decoded pixel is within half a step of the rendered one: at most
:data:`BOUND` = (18, 18, 42) in red, green and blue, and black and white
exactly. (PIL, which the JAX package writes its GIFs with, picks an
adaptive palette per image; the pixels differ, the bound does not depend
on the image.)

The image data is LZW in its stored-literal form: every pixel is one 9-bit
literal code, and a clear code precedes each run of :data:`RUN` literals,
so the decoder's table never outgrows 9-bit codes. Every decoder reads
that form, and it packs without a loop over pixels.
"""

from __future__ import annotations

import struct

import numpy as np

_LEVELS = (np.round(np.arange(8) * 255 / 7).astype(np.int32), np.round(np.arange(8) * 255 / 7).astype(np.int32),
           np.arange(4, dtype=np.int32) * 85)
# Per channel, value -> index of its nearest level.
_NEAREST = [np.abs(np.arange(256)[:, None] - lv[None, :]).argmin(axis=1) for lv in _LEVELS]
PALETTE = np.stack(np.meshgrid(*_LEVELS, indexing="ij"), axis=-1).reshape(256, 3).astype(np.uint8)
BOUND = tuple(int(np.abs(np.arange(256) - lv[near]).max()) for lv, near in zip(_LEVELS, _NEAREST))
RUN = 250  # literals between clear codes: the table reaches code 258 + 249 < 512
_CLEAR, _END = 256, 257


def quantize(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 -> (...,) uint8 index into :data:`PALETTE`."""
    rgb = np.asarray(rgb, np.uint8)
    return (_NEAREST[0][rgb[..., 0]] * 32 + _NEAREST[1][rgb[..., 1]] * 4 + _NEAREST[2][rgb[..., 2]]).astype(np.uint8)


def _lzw_literal(indices: np.ndarray) -> bytes:
    """The stored-literal LZW stream of ``indices``, in 255-byte sub-blocks."""
    n = indices.size
    runs = -(-n // RUN)
    codes = np.empty(n + runs + 1, np.uint16)
    codes[np.arange(runs) * (RUN + 1)] = _CLEAR
    pixel = np.arange(n)
    codes[pixel + pixel // RUN + 1] = indices.reshape(-1)
    codes[-1] = _END
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1).astype(np.uint8)
    data = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    blocks = [data[i:i + 255] for i in range(0, len(data), 255)]
    return b"".join(bytes([len(b)]) + b for b in blocks) + b"\x00"


def encode(frames, ms_per_frame: int = 120) -> bytes:
    """(H, W, 3) uint8 frames -> an animated GIF that loops forever."""
    frames = [np.asarray(f, np.uint8) for f in frames]
    height, width = frames[0].shape[:2]
    out = [b"GIF89a", struct.pack("<HHBBB", width, height, 0xF7, 0, 0), PALETTE.tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    delay = struct.pack("<H", int(round(ms_per_frame / 10)))
    for frame in frames:
        if frame.shape != (height, width, 3):
            raise ValueError(f"frame of shape {frame.shape}, expected {(height, width, 3)}")
        out.append(b"\x21\xf9\x04\x04" + delay + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, width, height, 0) + b"\x08")
        out.append(_lzw_literal(quantize(frame)))
    out.append(b"\x3b")
    return b"".join(out)


def write(path, frames, ms_per_frame: int = 120) -> None:
    with open(path, "wb") as f:
        f.write(encode(frames, ms_per_frame))
