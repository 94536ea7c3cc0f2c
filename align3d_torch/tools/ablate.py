"""Design comparisons of the port's kernels on the card.

    python -m align3d_torch.tools.ablate

Needs a CUDA device and ``nvcc`` (found as the kernel build finds it) and
fails without them. Prints one JSON line with the card's name and power
limit and two comparisons, each made in this one process, so that their
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


def build_splat(exact: int):
    """K2's C entry point from ``bilateral.cu`` built with A3D_SPLAT_EXACT=exact."""
    BUILD.mkdir(parents=True, exist_ok=True)
    out = BUILD / f"libsplat_exact{exact}.so"
    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", f"-DA3D_SPLAT_EXACT={exact}",
           "-o", str(out), str(_kernels._CSRC / "bilateral.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    fn = ctypes.CDLL(str(out)).a3d_bilateral_splat
    fn.argtypes = _kernels._SIGNATURES["a3d_bilateral_splat"]
    fn.restype = ctypes.c_int
    return fn


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
    variants = {"exact": build_splat(1), "ordered": build_splat(0)}
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


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: the ablation tool needs a CUDA device", file=sys.stderr)
        return 1
    from align3d_torch.tools.roofline import card

    device = torch.device("cuda")
    print(json.dumps({"ablate": {"card": card(), "splat_exact": splat_exact(device), "tap_packs": tap_packs(device)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
