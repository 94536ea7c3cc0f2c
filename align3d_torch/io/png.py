"""A PNG decoder and encoder on ``zlib``, ``struct`` and numpy, for the
frames the datasets hold and the images the renderer writes.

The decoder supports non-interlaced 8-bit RGB (colour type 2), 8-bit RGBA
(colour type 6) and 16-bit grayscale (colour type 0) with filter types 0-4
— the formats of RGB-D colour and depth frames and of :func:`encode`'s
output. Anything else raises :class:`PngError`. :func:`encode` writes 8-bit
RGBA, every row with filter type 0.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (bit depth, colour type) -> (channels, numpy dtype of a sample)
_FORMATS = {(8, 2): (3, np.uint8), (8, 6): (4, np.uint8), (16, 0): (1, np.dtype(">u2"))}


class PngError(ValueError):
    pass


def _paeth_row(filt: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = filt.astype(np.int32)
    up = prior.astype(np.int32)
    for x in range(out.size):
        a = out[x - bpp] if x >= bpp else 0
        b = up[x]
        c = up[x - bpp] if x >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[x] = (out[x] + pred) & 0xFF
    return out.astype(np.uint8)


def _average_row(filt: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = filt.astype(np.int32)
    up = prior.astype(np.int32)
    for x in range(out.size):
        a = out[x - bpp] if x >= bpp else 0
        out[x] = (out[x] + ((a + up[x]) >> 1)) & 0xFF
    return out.astype(np.uint8)


def _sub_row(filt: np.ndarray, bpp: int) -> np.ndarray:
    out = filt.astype(np.uint32).reshape(-1, bpp)
    return (np.cumsum(out, axis=0) & 0xFF).astype(np.uint8).reshape(-1)


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    data = np.frombuffer(raw, np.uint8)
    if data.size != height * (stride + 1):
        raise PngError(f"decompressed size {data.size} != {height * (stride + 1)}")
    rows = data.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, filt = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            out[y] = filt
        elif ftype == 1:
            out[y] = _sub_row(filt, bpp)
        elif ftype == 2:
            out[y] = filt + prior  # uint8 arithmetic wraps mod 256
        elif ftype == 3:
            out[y] = _average_row(filt, prior, bpp)
        elif ftype == 4:
            out[y] = _paeth_row(filt, prior, bpp)
        else:
            raise PngError(f"unknown filter type {ftype} in row {y}")
        prior = out[y]
    return out


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) or (H, W, 4) uint8, or (H, W) uint16."""
    if data[:8] != _SIGNATURE:
        raise PngError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise PngError("missing IHDR")
    width, height, bit_depth, color_type, _, _, interlace = header
    if (bit_depth, color_type) not in _FORMATS or interlace != 0:
        raise PngError(f"unsupported PNG: bit depth {bit_depth}, colour type {color_type}, interlace {interlace}")
    channels, dtype = _FORMATS[(bit_depth, color_type)]
    bpp = channels * np.dtype(dtype).itemsize
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp)
    image = pixels.view(dtype).reshape(height, width, channels)
    if channels == 1:
        return image[..., 0].astype(np.uint16)
    return image


def read(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode(rgba: np.ndarray) -> bytes:
    """(H, W, 4) uint8 -> PNG bytes (8-bit RGBA, non-interlaced)."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    if rgba.ndim != 3 or rgba.shape[2] != 4:
        raise PngError(f"expected (H, W, 4) uint8, got shape {rgba.shape}")
    height, width = rgba.shape[:2]
    rows = np.zeros((height, width * 4 + 1), np.uint8)  # filter byte 0, then the row
    rows[:, 1:] = rgba.reshape(height, width * 4)
    header = struct.pack(">IIBBBBB", width, height, 8, 6, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def write(path, rgba: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(rgba))
