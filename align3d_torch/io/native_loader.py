"""ctypes bindings for the native frame loader, ``native/loader.cpp`` (the
port's own copy of ``align3d_tpu/io/native_loader.py``).

libpng/libjpeg decode and a C++ worker pool that decodes frames ahead of
the consumer, so the host decodes while the device aligns. The library is
built from the checkout's ``native/loader.cpp`` at first use, never at
import, into ``build/native/`` (the flags of ``native/Makefile``; ``CXX``
picks the compiler, ``g++`` by default), and again whenever the source
changes; only a library built there is loaded. Where it does not build (no
compiler, no libpng or libjpeg headers), :func:`available` is False and
:func:`unavailable_reason` keeps the compiler's message; the dataset
loaders then decode PNG with :mod:`align3d_torch.io.png`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "loader.cpp"
BUILD_DIR = _ROOT / "build" / "native"
LIB_NAME = "liba3d_loader.so"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]
LIBS = ["-lpng", "-ljpeg", "-lpthread"]

_U8P = ctypes.POINTER(ctypes.c_uint8)
_U16P = ctypes.POINTER(ctypes.c_uint16)
_IP = ctypes.POINTER(ctypes.c_int)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None  # why the library is unavailable, once a build failed


def _source_hash(cxx: str) -> str:
    digest = hashlib.sha256(" ".join([cxx, *CXX_FLAGS, *LIBS]).encode())
    digest.update(SOURCE.read_bytes())
    return digest.hexdigest()[:16]


def build() -> Path:
    """Compile ``native/loader.cpp`` unless a library of the current source
    exists. Returns its path; raises RuntimeError with the compiler's
    output when the build fails."""
    cxx = os.environ.get("CXX", "g++")
    lib_path, stamp = BUILD_DIR / LIB_NAME, BUILD_DIR / (LIB_NAME + ".hash")
    want = _source_hash(cxx)
    if lib_path.exists() and stamp.exists() and stamp.read_text() == want:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / LIB_NAME
        try:
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, "-o", str(out), str(SOURCE), *LIBS], capture_output=True, text=True, timeout=300
            )
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"{cxx} did not run: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(out, lib_path)
    stamp.write_text(want)
    return lib_path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except (RuntimeError, OSError) as e:
                _error = str(e)
                return None
            lib.a3d_decode_rgb.restype = ctypes.c_int
            lib.a3d_decode_rgb.argtypes = [ctypes.c_char_p, ctypes.POINTER(_U8P), _IP, _IP]
            lib.a3d_decode_depth_png.restype = ctypes.c_int
            lib.a3d_decode_depth_png.argtypes = [ctypes.c_char_p, ctypes.POINTER(_U16P), _IP, _IP]
            lib.a3d_free.restype = None
            lib.a3d_free.argtypes = [ctypes.c_void_p]
            lib.a3d_loader_create.restype = ctypes.c_void_p
            lib.a3d_loader_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
            ]
            lib.a3d_loader_get.restype = ctypes.c_int
            lib.a3d_loader_get.argtypes = [ctypes.c_void_p, ctypes.c_int, _U8P, ctypes.c_int, _U16P, ctypes.c_int,
                                           _IP, _IP, _IP, _IP]
            lib.a3d_loader_destroy.restype = None
            lib.a3d_loader_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the native library is built and loaded (building it if needed)."""
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """The build's or the load's error when :func:`available` is False."""
    return None if available() else _error


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_error}")
    return lib


def decode_rgb(path: str) -> np.ndarray:
    """Decode a PNG or JPEG into (H, W, 3) u8."""
    lib = _require()
    data, w, h = _U8P(), ctypes.c_int(), ctypes.c_int()
    if lib.a3d_decode_rgb(str(path).encode(), ctypes.byref(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise IOError(f"native rgb decode failed for {path}")
    try:
        return np.ctypeslib.as_array(data, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.a3d_free(data)


def decode_depth(path: str) -> np.ndarray:
    """Decode a grayscale PNG into (H, W) u16 (8-bit samples widened)."""
    lib = _require()
    data, w, h = _U16P(), ctypes.c_int(), ctypes.c_int()
    if lib.a3d_decode_depth_png(str(path).encode(), ctypes.byref(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise IOError(f"native depth decode failed for {path}")
    try:
        return np.ctypeslib.as_array(data, shape=(h.value, w.value)).copy()
    finally:
        lib.a3d_free(data)


class PrefetchLoader:
    """Decode-ahead pipeline over (colour path, depth path) pairs.

    A C++ worker pool of ``n_threads`` decodes up to ``prefetch`` frames
    ahead of the last index asked for; :meth:`get` blocks only until its
    frame is ready, and returns copies the caller owns. Made for the
    sequential access of odometry; :meth:`close` stops the pool.
    """

    def __init__(
        self,
        color_paths: Sequence[str],
        depth_paths: Sequence[str],
        max_width: int = 1920,
        max_height: int = 1080,
        n_threads: int = 4,
        prefetch: int = 8,
    ):
        lib = _require()
        if len(color_paths) != len(depth_paths):
            raise ValueError("color/depth path lists must have equal length")
        self._lib = lib
        self._n = len(color_paths)
        colors = (ctypes.c_char_p * self._n)(*[str(p).encode() for p in color_paths])
        depths = (ctypes.c_char_p * self._n)(*[str(p).encode() for p in depth_paths])
        self._handle = lib.a3d_loader_create(colors, depths, self._n, n_threads, prefetch)  # copies the paths
        self._cbuf = np.empty(max_width * max_height * 3, np.uint8)
        self._dbuf = np.empty(max_width * max_height, np.uint16)

    def __len__(self) -> int:
        return self._n

    def get(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        if not self._handle:
            raise RuntimeError("PrefetchLoader is closed")
        cw, ch, dw, dh = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = self._lib.a3d_loader_get(
            self._handle, idx,
            self._cbuf.ctypes.data_as(_U8P), self._cbuf.size,
            self._dbuf.ctypes.data_as(_U16P), self._dbuf.size,
            ctypes.byref(cw), ctypes.byref(ch), ctypes.byref(dw), ctypes.byref(dh),
        )
        if rc != 0:
            raise IOError(f"native loader_get({idx}) failed with code {rc}")
        color = self._cbuf[: ch.value * cw.value * 3].reshape(ch.value, cw.value, 3).copy()
        depth = self._dbuf[: dh.value * dw.value].reshape(dh.value, dw.value).copy()
        return color, depth

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.a3d_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
