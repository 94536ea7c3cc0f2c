"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` per file, all started together, and the objects are linked
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

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
LIB_NAME = "libalign3d_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

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
        _P, _P, _I, _I, _I, _F,  # images, color_min per frame, batch, h, w, 1/sigma_color
        _P, _P, _I, _P, _P, _I,  # row window idx/wt, taps; col window idx/wt, taps
        _I, _I, _I, _P, _P,  # gh, gw, gd, out, stream
    ],
    "a3d_bilateral_slice": [
        _P, _P, _P, _I, _I, _I,  # grids, images, color_min per frame, batch, h, w
        _I, _I, _I, _F,  # gh, gw, gd, 1/sigma_color
        _P, _P, _P, _P, _P, _P,  # y0, y1, ya, x0, x1, xa
        _P, _P,  # out, stream
    ],
    "a3d_nn_banded": [
        _P, _P, _P,  # planes, queries, band starts
        _I, _I, _I, _I,  # query blocks, DB tiles, tiles per band, payload
        _P, _P, _P, _P,  # score, position, payload, stream
    ],
    "a3d_fma_peak": [_P, _P, _I, _I, _P],  # x, out, n, steps, stream
    "a3d_gather_lane": [_P, _P, _P, _I, _I, _P],  # x, idx, out, rows, steps, stream
    "a3d_gather_table": [_P, ctypes.c_uint, _P, _P, _I, _I, _P],  # table, m, x, out, n, steps, stream
    "a3d_mesh_normals": [
        _P, _P, _I,  # points, faces, faces count
        _P, _P, _I, _I,  # incidence table, counts, vertices, degree
        _P, _P, _P,  # face-normal buffer, out, stream
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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]
            jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for obj, proc in jobs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{obj.stem}.cu ({proc.returncode}):\n{stdout}\n{stderr}")
            elif verbose:
                print(stderr, end="")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        out = Path(tmp) / LIB_NAME
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(out), *(str(obj) for obj, _ in jobs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
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


def check_tensor(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype, device: torch.device) -> None:
    """Raise unless ``t`` is what a kernel takes: device, dtype, shape, contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
