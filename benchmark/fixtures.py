"""The benchmark's own reader of the RGB-D fixtures (SlamTb format).

A frozen copy of the port's PNG decoder (``align3d_torch/io/png.py::decode``,
non-interlaced 8-bit RGB and 16-bit grey, filter types 0-4) and of the
SlamTb ``frames.json`` reader, so that a later change to the program's I/O
cannot change the traffic. Each fixture directory is also hashed, and the
hash is held against the one the traffic file states: a changed fixture
stops the run instead of changing the workload unseen.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import struct
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "data" / "rgbd"

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_FORMATS = {(8, 2): (3, np.uint8), (16, 0): (1, np.dtype(">u2"))}


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


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, filt = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            out[y] = filt
        elif ftype == 1:
            out[y] = (np.cumsum(filt.astype(np.uint32).reshape(-1, bpp), axis=0) & 0xFF).astype(np.uint8).reshape(-1)
        elif ftype == 2:
            out[y] = filt + prior
        elif ftype == 3:
            out[y] = _average_row(filt, prior, bpp)
        elif ftype == 4:
            out[y] = _paeth_row(filt, prior, bpp)
        else:
            raise ValueError(f"unknown PNG filter type {ftype} in row {y}")
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 or (H, W) uint16."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("missing IHDR")
    width, height, bit_depth, color_type, _, _, interlace = header
    if (bit_depth, color_type) not in _FORMATS or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {bit_depth}, colour type {color_type}, interlace {interlace}")
    channels, dtype = _FORMATS[(bit_depth, color_type)]
    bpp = channels * np.dtype(dtype).itemsize
    image = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp).view(dtype)
    image = image.reshape(height, width, channels)
    return image[..., 0].astype(np.uint16) if channels == 1 else image


@dataclasses.dataclass
class Fixture:
    """One decoded SlamTb sequence: host arrays, as a sensor or a recording
    reader hands them over."""

    name: str
    colors: np.ndarray  # (N, H, W, 3) u8
    depths: np.ndarray  # (N, H, W) u16
    depth_scale: float
    camera: tuple  # (fx, fy, cx, cy, width, height)

    def __len__(self) -> int:
        return len(self.depths)


def digest(name: str) -> str:
    """SHA-256 over the fixture directory's file names and bytes, in name order."""
    h = hashlib.sha256()
    for path in sorted((FIXTURES / name).iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def load(name: str, expected_digest: str | None = None, stride: int = 1) -> Fixture:
    """Decode every frame of ``tests/data/rgbd/<name>``; raise if its digest
    is not ``expected_digest`` or its frames do not share one camera and one
    depth scale. ``stride`` > 1 keeps every stride-th row and column, with
    the camera scaled to match (the harness's CPU tests run so)."""
    base = FIXTURES / name
    if expected_digest is not None and digest(name) != expected_digest:
        raise RuntimeError(f"fixture {name} differs from the one the traffic was defined on")
    doc = json.loads((base / "frames.json").read_text())["root"]
    cameras, scales, colors, depths = set(), set(), [], []
    for frame in doc:
        info = frame["info"]
        k = info["kcam"]["matrix"]
        w, h = info["kcam"]["image_size"]
        cameras.add((k[0][0], k[1][1], k[0][2], k[1][2], w, h))
        scales.add(float(info["depth_scale"]))
        colors.append(decode_png((base / frame["rgb_image"]).read_bytes()))
        depths.append(decode_png((base / frame["depth_image"]).read_bytes()))
    if len(cameras) != 1 or len(scales) != 1:
        raise RuntimeError(f"fixture {name}: frames with different cameras or depth scales")
    camera, colors, depths = cameras.pop(), np.stack(colors), np.stack(depths)
    if stride > 1:
        fx_, fy_, cx_, cy_, w, h = camera
        camera = (fx_ / stride, fy_ / stride, cx_ / stride, cy_ / stride, -(-w // stride), -(-h // stride))
        colors = np.ascontiguousarray(colors[:, ::stride, ::stride])
        depths = np.ascontiguousarray(depths[:, ::stride, ::stride])
    return Fixture(name, colors, depths, scales.pop(), camera)
