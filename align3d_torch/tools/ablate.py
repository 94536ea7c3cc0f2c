"""Design comparisons of the port's kernels on the card.

    python -m align3d_torch.tools.ablate

Needs a CUDA device and ``nvcc`` (found as the kernel build finds it) and
fails without them. Prints one JSON line with the card's name and power
limit and four comparisons, each made in this one process, so that their
times compare:

* **K2's exact path** (``splat_exact``). ``csrc/bilateral.cu`` is built
  twice into ``build/ablate/``: as the kernel library builds it, and with
  ``-DA3D_SPLAT_EXACT=0``, which sends every chunk of taps through the
  ordered loop. Both are held bitwise against ``_splat_plain`` and timed at
  the shapes of the two paths that launch K2: one sample1 frame (the
  odometry path, grid 2 x 111 x 146 x 96) and the 65 frames of the
  throughput series at gd 131, in the order exact, ordered, ordered, exact.
* **The intensity-tap packs** (``tap_packs``): the device time of
  ``pack_intensity_taps`` over the 64 target maps of the throughput series
  at each pyramid level, the packs the 64-pair step built before K1 read
  its taps from the map.
* **The slice composition K3's form (b) replaces** (``slice_composition``):
  on the filter paths the blurred grid went through ``_normalize``, K3's
  form (a) and a cast to int32; form (b) does all three in one launch. Each
  part, the three as one call, and form (b) are timed on the same blurred
  grids, at one sample1 frame (the odometry path, gd 96) and at the 65
  frames of the throughput series (gd 131), form (b) before and after the
  composition; form (b) is held bitwise against the composition.
* **K3's pixels per thread** (``slice_pixels``). ``csrc/bilateral.cu`` is
  built with 1, 2 and 4 pixels a thread in both forms
  (``-DA3D_SLICE_PIXELS_A`` / ``_B``; the library keeps 4 for form (a) and
  1 for form (b)); each build's two forms are held bitwise against their
  plain twins and timed at one sample1 frame and at 65 frames, in the order
  4, 1, 2, 2, 1, 4.

Each time is given twice: device ms per call from ``torch.profiler``
(``tools/roofline.py::device_ms``), and ms per call of back-to-back calls
between one CUDA event pair.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from align3d_torch import _kernels

BUILD = _kernels.BUILD_DIR.parent / "ablate"
CALLS = {"frame": 50, "series": 10}  # calls per timing at each shape


def build_bilateral(variants: dict[str, dict[str, int]]) -> dict[str, ctypes.CDLL]:
    """``bilateral.cu`` built once per variant, each with its -D macros, all
    ``nvcc`` started together; name -> the loaded library, its splat and
    slice entry points typed."""
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, defines in variants.items():
        out = BUILD / f"libbilateral_{name}.so"
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", *(f"-D{k}={v}" for k, v in defines.items()),
               "-o", str(out), str(_kernels._CSRC / "bilateral.cu")]
        jobs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (out, proc) in jobs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n{stdout}\n{stderr}")
        lib = ctypes.CDLL(str(out))
        for entry in ("a3d_bilateral_splat", "a3d_bilateral_slice"):
            fn = getattr(lib, entry)
            fn.argtypes = _kernels._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def splat_with(fn, frames: torch.Tensor, cmin: torch.Tensor, grid_shape, sigma_space: float,
               sigma_color: float) -> torch.Tensor:
    """``ops.bilateral._splat`` of (B, H, W) frames through the entry point ``fn``."""
    from align3d_torch.ops import bilateral as bil

    out = torch.empty((frames.shape[0], 2, *grid_shape), dtype=torch.float32, device=frames.device)
    bil._splat_launch(fn, frames, cmin, grid_shape, sigma_space, sigma_color, out)
    return out


def splat_exact(device) -> dict:
    """K2 with and without its exact path, at one frame and at 65 frames."""
    from align3d_torch.ops import bilateral as bil
    from align3d_torch.tools.roofline import device_ms, time_ms
    from align3d_torch.tools.series import real_frames

    filt = bil.BilateralFilter()
    real = real_frames()
    series = torch.from_numpy(real.depths.astype(np.int32)).to(device)
    one = series[:1].contiguous()
    one_min, one_shape, _ = bil.grid_geometry(one[0], filt.sigma_space, filt.sigma_color, filt.pad_depth_to)
    smin, smax = bil.nonzero_min_max(series)
    gd = max(bil.true_depth(lo, hi, filt.sigma_color) for lo, hi in zip(smin.tolist(), smax.tolist()))
    shapes = {"frame": (one, one_min.reshape(1), one_shape),
              "series": (series, smin, (*bil._grid_dims(*series.shape[-2:], filt.sigma_space), gd))}
    libs = build_bilateral({"exact": {"A3D_SPLAT_EXACT": 1}, "ordered": {"A3D_SPLAT_EXACT": 0}})
    variants = {name: lib.a3d_bilateral_splat for name, lib in libs.items()}
    out = {}
    for label, (frames, cmin, shape) in shapes.items():
        args = (frames, cmin, shape, filt.sigma_space, filt.sigma_color)
        ref = bil._splat_plain(*args)
        row = {"frames": frames.shape[0], "grid": [2, *shape]}
        for name, fn in variants.items():
            row[f"{name}_bitwise"] = torch.equal(splat_with(fn, *args), ref)
        del ref
        for name in ("exact", "ordered", "ordered", "exact"):
            fn = variants[name]
            row.setdefault(f"{name}_ms", []).append(device_ms(lambda: splat_with(fn, *args), CALLS[label],
                                                              "bilateral_splat")[0])
            row.setdefault(f"{name}_event_ms", []).append(time_ms(lambda: splat_with(fn, *args), reps=CALLS[label]))
        if not (row["exact_bitwise"] and row["ordered_bitwise"]):
            raise AssertionError(f"a K2 build differs from its plain twin at the {label} shape")
        out[label] = row
    return out


def tap_packs(device) -> dict:
    """Device ms of the 64 pairs' intensity-tap packs, per pyramid level."""
    from align3d_torch.ops.target_pack import pack_intensity_taps
    from align3d_torch.parallel.batch import build_pyramids_batched
    from align3d_torch.tools.roofline import device_ms, time_ms
    from align3d_torch.tools.series import real_frames

    real = real_frames()
    pyramid = build_pyramids_batched(
        real.camera, torch.from_numpy(real.depth_scales).to(device), torch.from_numpy(real.colors).to(device),
        torch.from_numpy(real.depths.astype(np.int32)).to(device))
    maps = [lv.frames(slice(None, -1)).intensity_map for lv in pyramid]
    return {"pairs": maps[0].shape[0],
            "device_ms_by_level": [device_ms(lambda m=m: pack_intensity_taps(m), 5)[0] for m in maps],
            "event_ms_by_level": [time_ms(lambda m=m: pack_intensity_taps(m), reps=5) for m in maps],
            "bytes_written_by_level": [m.shape[0] * (m.shape[1] - 2) * (m.shape[2] - 2) * 12 * 4 for m in maps]}


def slice_composition(device) -> dict:
    """Device ms of ``_normalize``, K3's form (a) and the cast, alone and as
    one call, against K3's form (b), at one frame and at 65 frames."""
    from align3d_torch.ops import bilateral as bil
    from align3d_torch.tools.roofline import device_ms, time_ms
    from align3d_torch.tools.series import real_frames

    filt = bil.BilateralFilter()
    real = real_frames()
    series = torch.from_numpy(real.depths.astype(np.int32)).to(device)
    one = series[0].contiguous()
    grid = bil.BilateralGrid.from_image(one, filt.sigma_space, filt.sigma_color, filt.pad_depth_to).convolve()
    smin, smax = bil.nonzero_min_max(series)
    gd = max(bil.true_depth(lo, hi, filt.sigma_color) for lo, hi in zip(smin.tolist(), smax.tolist()))
    shape = (*bil._grid_dims(*series.shape[-2:], filt.sigma_space), gd)
    blurred = bil._blur(bil._splat(series, smin, shape, filt.sigma_space, filt.sigma_color), gd)
    shapes = {"frame": (grid.data_cm, one, grid.color_min), "series": (blurred, series, smin)}
    out = {}
    for label, (grids, images, cmin) in shapes.items():
        args = (images, cmin, filt.sigma_space, filt.sigma_color)
        norm = bil._normalize(grids)
        sliced = bil._slice(norm, *args)
        calls = {
            "normalize": (lambda: bil._normalize(grids), None),
            "slice_a": (lambda: bil._slice(norm, *args), "bilateral_slice"),
            "cast": (lambda: sliced.to(torch.int32), None),
            "composition": (lambda: bil._slice(bil._normalize(grids), *args).to(torch.int32), None),
        }
        fused = (lambda: bil._normalize_slice(grids, *args), "bilateral_slice")
        row = {"frames": images.reshape(-1, *images.shape[-2:]).shape[0], "grid": list(grids.shape[-4:]),
               "bitwise": torch.equal(fused[0](), sliced.to(torch.int32))}
        for name, (fn, kernel) in (("fused", fused), *calls.items(), ("fused", fused)):
            row.setdefault(f"{name}_ms", []).append(device_ms(fn, CALLS[label], kernel)[0])
            row.setdefault(f"{name}_event_ms", []).append(time_ms(fn, reps=CALLS[label]))
        if not row["bitwise"]:
            raise AssertionError(f"K3's form (b) differs from the composition at the {label} shape")
        out[label] = row
        del norm, sliced
    return out


def slice_pixels(device) -> dict:
    """K3 built with 1, 2 and 4 pixels a thread: both forms at one frame and
    at 65 frames, bitwise against their twins."""
    from align3d_torch.ops import bilateral as bil
    from align3d_torch.tools.roofline import device_ms
    from align3d_torch.tools.series import real_frames

    filt = bil.BilateralFilter()
    real = real_frames()
    series = torch.from_numpy(real.depths.astype(np.int32)).to(device)
    one = series[0].contiguous()
    grid = bil.BilateralGrid.from_image(one, filt.sigma_space, filt.sigma_color, filt.pad_depth_to).convolve()
    smin, smax = bil.nonzero_min_max(series)
    gd = max(bil.true_depth(lo, hi, filt.sigma_color) for lo, hi in zip(smin.tolist(), smax.tolist()))
    shape = (*bil._grid_dims(*series.shape[-2:], filt.sigma_space), gd)
    blurred = bil._blur(bil._splat(series, smin, shape, filt.sigma_space, filt.sigma_color), gd)
    libs = build_bilateral({f"pixels{p}": {"A3D_SLICE_PIXELS_A": p, "A3D_SLICE_PIXELS_B": p} for p in (1, 2, 4)})
    out = {}
    for label, (grids, images, cmin) in {"frame": (grid.data_cm, one, grid.color_min),
                                         "series": (blurred, series, smin)}.items():
        args = (images, cmin, filt.sigma_space, filt.sigma_color)
        norm = bil._normalize(grids)
        forms = {"a": (norm, False), "b": (grids, True)}
        refs = {"a": bil._slice_plain(norm, *args), "b": bil._normalize_slice_plain(grids, *args)}
        row = {}
        for name in ("pixels4", "pixels1", "pixels2", "pixels2", "pixels1", "pixels4"):
            entry = libs[name].a3d_bilateral_slice
            for form, (g, fused) in forms.items():
                def call(g=g, fused=fused):
                    return bil._slice_launch(g, *args, fused=fused, entry=entry)

                key = f"{name}_{form}"
                row.setdefault(f"{key}_bitwise", torch.equal(call(), refs[form]))
                row.setdefault(f"{key}_ms", []).append(device_ms(call, CALLS[label], "bilateral_slice")[0])
        if not all(v for k, v in row.items() if k.endswith("_bitwise")):
            raise AssertionError(f"a K3 build differs from its plain twin at the {label} shape")
        out[label] = row
        del norm, refs
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: the ablation tool needs a CUDA device", file=sys.stderr)
        return 1
    from align3d_torch.tools.roofline import card

    device = torch.device("cuda")
    print(json.dumps({"ablate": {"card": card(), "splat_exact": splat_exact(device), "tap_packs": tap_packs(device),
                                 "slice_composition": slice_composition(device),
                                 "slice_pixels": slice_pixels(device)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
