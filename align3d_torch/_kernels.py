"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, loaded with ``ctypes``.
The build runs at first use, never at import, into ``build/kernels/`` of the
checkout, and runs again whenever the sources' hash changes. Set
``CUDA_HOME`` when ``nvcc`` is neither on ``PATH`` nor under
``/usr/local/cuda``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
LIB_NAME = "libalign3d_kernels.so"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points and their argument types; each returns cudaGetLastError().
_SIGNATURES = {
    "a3d_icp_step": [
        _P, _P, _P, _P, _P, _P, _P,  # rot, trans, points, mask, intensity, geo, taps
        _I, _I, _I, _I,  # batch, n, h, w
        _F, _F, _F, _F,  # fx, fy, cx, cy
        _F, _F, _F, _F,  # max_dist^2, max_angle, max_color^2, huber_delta
        _P, _I, _P, _P,  # partials, blocks per pair, out, stream
    ],
    "a3d_bilateral_splat": [
        _P, _I, _F, _F,  # image, w, color_min, 1/sigma_color
        _P, _P, _I, _P, _P, _I,  # row window idx/wt, taps; col window idx/wt, taps
        _I, _I, _I, _P, _P,  # gh, gw, gd, out, stream
    ],
    "a3d_bilateral_slice": [
        _P, _P, _I, _I, _I, _I, _F, _F,  # value grid, image, h, w, gw, gd, color_min, 1/sigma_color
        _P, _P, _P, _P, _P, _P,  # y0, y1, ya, x0, x1, xa
        _P, _P,  # out, stream
    ],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def source_hash() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library of the current sources exists.
    Returns the library path."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".hash")
    want = source_hash()
    if lib_path.exists() and stamp.exists() and stamp.read_text() == want:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / LIB_NAME
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out)]
        cmd += [str(p) for p in _sources()]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        if verbose:
            print(proc.stderr, end="")
        os.replace(out, lib_path)
    stamp.write_text(want)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = loaded
    return _lib


def check(status: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status}")
