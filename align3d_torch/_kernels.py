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
PTXAS_LOG = "ptxas.log"  # the compiler's -Xptxas -v report of the library's build

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
# Flags of one source only. The exact and the banded ICP steps, the band
# prediction, the GN update and the pyramid round every product and sum on
# their own, as their plain twins do, so that the association and the gates
# decide as the twin's do, the bases are the twin's bits, the merged systems
# and residuals too, and the pyramid is bitwise the twin's.
FILE_FLAGS = {"icp_step.cu": ["-fmad=false"], "icp_banded.cu": ["-fmad=false"], "band_predict.cu": ["-fmad=false"],
              "gn_update.cu": ["-fmad=false"], "pyramid.cu": ["-fmad=false"]}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points and their argument types; each returns cudaGetLastError().
_SIGNATURES = {
    "a3d_icp_step": [
        _P, _P, _P, _P, _P, _P, _P,  # rot, trans, points, mask, intensity, geo, intensity map
        _I, _I, _I, _I,  # batch, n, h, w
        _F, _F, _F, _F,  # fx, fy, cx, cy
        _F, _F, _F, _F,  # max_dist^2, max_angle, max_color^2, huber_delta
        _P, _I, _P, _P, _P,  # partials, blocks per pair, arrival counters, out, stream
    ],
    "a3d_icp_banded": [
        _I, _P, _P, _P, _P, _P, _P, _P,  # variant, rot, trans, chunk_base, dy_base, dx_base, source, target
        _I, _I, _I, _I, _I, _I,  # batch, nchunks, groups, h, w, band radius
        _F, _F, _F, _F, _F, _F,  # fx, fy, cx, cy, f32(1/fx), f32(1/fy)
        _F, _F, _F, _F,  # max_dist^2, f32(cos(max_angle)), max_color^2, huber_delta (0: off)
        _P, _P, _P, _P, _P,  # partials, arrival counters, out, stats (or null), stream
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
        _I, _P, _P,  # form (b) (normalize, int32 out) or (a), out, stream
    ],
    "a3d_nn_banded": [
        _P, _P, _P,  # planes, queries, band starts
        _I, _I, _I, _I,  # query blocks, DB tiles, tiles per band, payload
        _P, _P, _P, _P,  # score, position, payload, stream
    ],
    "a3d_fma_peak": [_P, _P, _I, _I, _P],  # x, out, n, steps, stream
    "a3d_gather_lane": [_P, _P, _P, _I, _I, _P],  # x, idx, out, rows, steps, stream
    "a3d_gather_table": [_P, ctypes.c_uint, _P, _P, _I, _I, _P],  # table, m, x, out, n, steps, stream
    "a3d_mesh_normals": [_P, _P, _P, _I, _I, _P, _P],  # points, (D, N, 2) corner table, counts, N, D, out, stream
    "a3d_column_mean": [_P, _P, _I, _P, _P],  # (sum N, 3) points, (M + 1,) int64 offsets, M, (M, 3) out, stream
    "a3d_source_centroids": [
        _P, _I, _I, _I,  # source pack, batch, nchunks, groups
        _F, _F, _F, _F,  # cx, cy, f32(1/fx), f32(1/fy)
        _P, _P, _P, _P, _P,  # pbar, rowbar, colbar, cnt, stream
    ],
    "a3d_gn_update": [
        _P, _P, ctypes.c_longlong, _I,  # geometric and colour 8x8 blocks, pair stride (floats), batch
        _F, _F, _F, _F,  # f32(w1 * w1), f32(w2 * w2), w1, w2
        _P, _P, _P, _P, _P, _P,  # rot, trans, best_res, best_rot, best_trans (in place), stream
    ],
    "a3d_pyramid_base": [
        _P, _P, _P, _F, _I, _I, _I,  # depth, colour, scales (or null), scale, batch, h, w
        _F, _F, _F, _F,  # fx, fy, cx, cy
        _P, _P, _P, _P, _P, _P,  # points, mask, normals, luma, intensity map (the last three may be null), stream
    ],
    "a3d_pyramid_down": [
        _P, _P, _P, _P, _I, _I, _I, _I, _I,  # points, normals (or null), mask, colours, batch, h, w, dh, dw
        _F, _F, _I, _I, ctypes.POINTER(_F),  # f32(h / dh), f32(w / dw), first tap offset, taps, weights
        _P, _P, _P, _P, _P, _P, _P,  # points, normals, mask, colours, luma, intensity map, stream
    ],
    "a3d_predict_bases": [
        _P, _P, _P, _P, _P, _P,  # rot, trans, pbar, rowbar, colbar, cnt
        _I, _I, _I, _F, _F, _F, _F, _I,  # batch, nchunks, groups, fx, fy, cx, cy, largest band start
        _P, _P, _P, _P,  # chunk_base, dy_base, dx_base, stream
    ],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def source_hash() -> str:
    digest = hashlib.sha256((" ".join(NVCC_FLAGS) + repr(sorted(FILE_FLAGS.items()))).encode())
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
            cmd = [nvcc, *NVCC_FLAGS, *FILE_FLAGS.get(src.name, []), "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]
            jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed, reports = [], []
        for obj, proc in jobs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{obj.stem}.cu ({proc.returncode}):\n{stdout}\n{stderr}")
            reports.append(stderr)
            if verbose:
                print(stderr, end="")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        out = Path(tmp) / LIB_NAME
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(out), *(str(obj) for obj, _ in jobs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
        os.replace(out, lib_path)
    (BUILD_DIR / PTXAS_LOG).write_text("".join(reports))
    stamp.write_text(want)
    return lib_path


def ptxas_report(kernel: str) -> list[str]:
    """The ``-Xptxas -v`` lines of each built entry function whose (mangled)
    name contains ``kernel``: registers, shared memory, stack and spills."""
    log = BUILD_DIR / PTXAS_LOG
    lines = log.read_text().splitlines() if log.exists() else []
    out, keep = [], False
    for line in lines:
        if "Compiling entry function" in line:
            keep = kernel in line
        if keep:
            out.append(" ".join(line.replace("ptxas info    :", "").split()))
    return out


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
