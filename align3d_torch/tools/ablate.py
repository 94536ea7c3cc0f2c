"""Design comparisons of the port's kernels on the card.

    python -m align3d_torch.tools.ablate

    python -m align3d_torch.tools.ablate mesh_designs mesh_host table_gather   # only these

Needs a CUDA device and ``nvcc`` (found as the kernel build finds it) and
fails without them. Prints one JSON line with the card's name and power
limit and the comparisons below (all of them, or those named on the command
line), each made in this one process, so that their times compare:

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
* **K5's designs** (``mesh_designs``). ``csrc/mesh.cu`` is built with the
  -D macros of ``MESH_VARIANTS``: the library's design (one launch over the
  corner table) at 1, 2 and 4 slots in flight and 128 or 256 threads a
  block; the earlier two launches through a face buffer; one cooperative
  launch (face pass, grid barrier, vertex pass, its face buffer allocated
  once); and one launch over the face-id incidence table, a thread a
  vertex recomputing its faces at 12 loads a face (design 3). Each is held
  bitwise (the sign of zero included, NaN at the same vertices) against
  ``vertex_normals_plain`` and timed on the teapot and the grid meshes of
  204,800 and 3,276,800 faces, in ``MESH_VARIANTS``' order and then back;
  beside the profiler's and the CUDA events' times, ``graph_ms`` replays
  the calls from one CUDA graph, which takes the host out of a call that
  is shorter than its dispatch (not for the cooperative launch).
* **K5's host cost** (``mesh_host``): host µs per call, back to back, of
  ``MeshNormals.__call__`` (the topology checked at construction), of the
  free ``vertex_normals`` (every tensor checked), and of the earlier wrapper
  (four checks, a face buffer and the output allocated, a 10-argument
  ctypes call into the two-launch build), on the 204,800-face grid.
* **P2's table mode** (``table_gather``). ``csrc/roofline.cu`` is built with
  ``-DA3D_TABLE_ILP`` x ``-DA3D_TABLE_U`` at 4 x 16 (the library's), 8 x 8
  and 16 x 4; 4 x 16 with ``__launch_bounds__``' minimum of 8 blocks an SM
  (``-DA3D_TABLE_MIN_BLOCKS``); 4 x 16 reading the whole 32-byte sector of
  each index (``-DA3D_TABLE_SECTOR``, another function on the same index
  stream); and the library's kernel with ``cudaLimitMaxL2FetchGranularity``
  at 32 bytes against the default, set and restored around the launches.
  Each build is held bitwise against its twin (the sector build against the
  twin of a table of sector sums) and timed in the l2 and hbm modes of
  ``tools/roofline.py``, in order and then in reverse; gathers/s and the
  share of the hbm bound at 32 bytes a gather.
* **K7's and K8's split** (``banded_sections``). ``csrc/icp_banded.cu`` is
  built with ``-DA3D_BANDED_SKIP_REDUCE=1`` (no reduction of the stack: its
  bits are xor-ed into one word that a store depends on, so all that feeds
  the stack is still computed; the sums are zeros), ``-DA3D_BANDED_SKIP_GATHER=1``
  (no target gather: opaque words in place of the loads), both, and
  neither (``BANDED_VARIANTS``); the full build is held bitwise against the
  library's kernel. Each is timed at 640x480, level 0, on the first real
  pair (B = 1) and on the 64 real pairs (B = 64), in order and then back;
  ``reduce_ms`` and ``gather_ms`` are what the reduction and the gathers
  add to the full build, beside the bound.
* **K9 and K10, the band prediction** (``band_prediction``): each kernel,
  its twin and, for K9, the one PyTorch call of the same sums, at B = 1 and
  B = 64 (device ms, ms a call, host ms a call); with ``A3D_BAND_BEFORE``
  pointing at an earlier ``ops/icp_pallas_v3.py`` its functions beside;
  and the device activities of one ``pallas_v4`` align's GN loop and
  prepack at B = 64 on the kernels and on the twins (or the earlier code).
* **K11, the GN update** (``gn_update``): the kernel and its twin on the
  blocks of K1 and of K8 at B = 1 and B = 64 (device ms, ms a call, host ms
  a call), and the device activities and host ms of an exact align of one
  pair and a ``pallas_v4`` align of 64 pairs, with K11 and with the twin.

Each time is given twice: device ms per call from ``torch.profiler``
(``tools/roofline.py::device_ms``), and ms per call of back-to-back calls
between one CUDA event pair.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from align3d_torch import _kernels

BUILD = _kernels.BUILD_DIR.parent / "ablate"
CALLS = {"frame": 50, "series": 10}  # calls per timing at each shape
_P, _I = ctypes.c_void_p, ctypes.c_int
#: K5's entry with a face buffer (designs 0 and 2): points, faces, F, table,
#: counts, N, D, face buffer, out, stream.
MESH_BUFFERED = [_P, _P, _I, _P, _P, _I, _I, _P, _P, _P]


def build_variants(source: str, variants: dict[str, dict[str, int]], entries) -> dict[str, ctypes.CDLL]:
    """``csrc/<source>`` built once per variant, each with its -D macros and
    the library's own flags for that file (``_kernels.FILE_FLAGS``), all
    ``nvcc`` started together; name -> the loaded library with the entry
    points ``entries(name)`` (entry name -> argtypes) typed."""
    BUILD.mkdir(parents=True, exist_ok=True)
    stem = source.rsplit(".", 1)[0]
    jobs = {}
    for name, defines in variants.items():
        out = BUILD / f"lib{stem}_{name}.so"
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, *_kernels.FILE_FLAGS.get(source, []), "-shared",
               *(f"-D{k}={v}" for k, v in defines.items()),
               "-o", str(out), str(_kernels._CSRC / source)]
        jobs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (out, proc) in jobs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n{stdout}\n{stderr}")
        lib = ctypes.CDLL(str(out))
        for entry, argtypes in entries(name).items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def build_bilateral(variants: dict[str, dict[str, int]]) -> dict[str, ctypes.CDLL]:
    """``bilateral.cu`` per variant, its splat and slice entry points typed."""
    return build_variants("bilateral.cu", variants, lambda _: {
        e: _kernels.ENTRIES[e] for e in ("a3d_bilateral_splat", "a3d_bilateral_slice")})


def grid_mesh(side: int, freq: float = 0.1) -> tuple[np.ndarray, np.ndarray]:
    """benches/bench_mesh.py's height-field mesh: (side + 1)^2 vertices,
    2 side^2 faces (side 320: 204,800 faces; side 1280: 3,276,800)."""
    ys, xs = np.meshgrid(np.arange(side + 1), np.arange(side + 1), indexing="ij")
    zs = np.sin(xs * freq) * np.cos(ys * freq)
    pts = np.stack([xs, ys, zs], axis=-1).reshape(-1, 3).astype(np.float32)
    faces = []
    for r in range(side):
        base, a = r * (side + 1), np.arange(side)
        faces.append(np.stack([base + a, base + a + 1, base + side + 1 + a], 1))
        faces.append(np.stack([base + a + 1, base + side + 2 + a, base + side + 1 + a], 1))
    return pts, np.concatenate(faces).astype(np.int32)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, the sign of zero included, NaN at the same places."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def splat_with(library, frames: torch.Tensor, cmin: torch.Tensor, grid_shape, sigma_space: float,
               sigma_color: float) -> torch.Tensor:
    """``ops.bilateral._splat`` of (B, H, W) frames through the build ``library``."""
    from align3d_torch.ops import bilateral as bil

    out = torch.empty((frames.shape[0], 2, *grid_shape), dtype=torch.float32, device=frames.device)
    bil._splat_launch(frames, cmin, grid_shape, sigma_space, sigma_color, out, library=library)
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
    out = {}
    for label, (frames, cmin, shape) in shapes.items():
        args = (frames, cmin, shape, filt.sigma_space, filt.sigma_color)
        ref = bil._splat_plain(*args)
        row = {"frames": frames.shape[0], "grid": [2, *shape]}
        for name, library in libs.items():
            row[f"{name}_bitwise"] = torch.equal(splat_with(library, *args), ref)
        del ref
        for name in ("exact", "ordered", "ordered", "exact"):
            library = libs[name]
            row.setdefault(f"{name}_ms", []).append(device_ms(lambda: splat_with(library, *args), CALLS[label],
                                                              "bilateral_splat")[0])
            row.setdefault(f"{name}_event_ms", []).append(time_ms(lambda: splat_with(library, *args),
                                                                  reps=CALLS[label]))
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
            for form, (g, fused) in forms.items():
                def call(g=g, fused=fused, library=libs[name]):
                    return bil._slice_launch(g, *args, fused=fused, library=library)

                key = f"{name}_{form}"
                row.setdefault(f"{key}_bitwise", torch.equal(call(), refs[form]))
                row.setdefault(f"{key}_ms", []).append(device_ms(call, CALLS[label], "bilateral_slice")[0])
        if not all(v for k, v in row.items() if k.endswith("_bitwise")):
            raise AssertionError(f"a K3 build differs from its plain twin at the {label} shape")
        out[label] = row
        del norm, refs
    return out


def mesh_inputs(device) -> dict:
    """K5's shapes, the teapot and the grid meshes of 204,800 and 3,276,800
    faces: name -> (``MeshNormals`` on ``device``, its points, the faces,
    the slot-major (D, N) face-id incidence table), tensors on ``device``."""
    from align3d_torch.io import read_ply
    from align3d_torch.ops.mesh import MeshNormals, incidence

    teapot = read_ply(Path(__file__).resolve().parents[2] / "tests" / "data" / "teapot.ply")
    meshes = {"teapot": (teapot.points, teapot.faces.astype(np.int32)), "grid320": grid_mesh(320),
              "grid1280": grid_mesh(1280)}
    out = {}
    for name, (pts, faces) in meshes.items():
        ids = incidence(faces, pts.shape[0])[0].astype(np.int32)
        out[name] = (MeshNormals(faces, pts.shape[0], device=device), torch.from_numpy(pts).to(device),
                     torch.from_numpy(faces).to(device), torch.from_numpy(ids).to(device))
    return out


#: K5's builds: the library's (design 1, the corner table) at 1, 2 (its
#: own) and 4 slots in flight and at 256 threads a block; the earlier two
#: launches and the cooperative launch (256 threads a block, as before); one
#: thread a vertex recomputing its faces from the face-id table (2 slots at
#: 128 threads, 4 at 256).
MESH_VARIANTS = {
    "two_launch": {"A3D_MESH_DESIGN": 0, "A3D_MESH_THREADS": 256},
    "corners_2": {"A3D_MESH_DESIGN": 1},
    "cooperative": {"A3D_MESH_DESIGN": 2, "A3D_MESH_THREADS": 256},
    "faces_2": {"A3D_MESH_DESIGN": 3, "A3D_MESH_SLOTS": 2},
    "faces_4_t256": {"A3D_MESH_DESIGN": 3, "A3D_MESH_SLOTS": 4, "A3D_MESH_THREADS": 256},
    "corners_1": {"A3D_MESH_DESIGN": 1, "A3D_MESH_SLOTS": 1},
    "corners_4": {"A3D_MESH_DESIGN": 1, "A3D_MESH_SLOTS": 4},
    "corners_2_t256": {"A3D_MESH_DESIGN": 1, "A3D_MESH_THREADS": 256},
}


def _mesh_entry_types(name: str) -> dict:
    design = MESH_VARIANTS[name]["A3D_MESH_DESIGN"]
    if design == 1:
        return {"a3d_mesh_normals": _kernels.ENTRIES["a3d_mesh_normals"]}
    return {"a3d_mesh_normals": MESH_BUFFERED if design in (0, 2) else MESH_BUFFERED[:7] + MESH_BUFFERED[8:]}


def graph_ms(fn, calls: int) -> float:
    """Device ms per call of ``fn``, without the host: ``calls`` calls
    captured in one CUDA graph, replayed between CUDA events (the gaps
    between the graph's kernels included)."""
    from align3d_torch.tools.roofline import time_ms

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = time_ms(graph.replay, reps=5) / calls
    del graph
    return ms


def mesh_designs(device) -> dict:
    """K5's designs against each other (see the module docstring)."""
    from align3d_torch.ops.mesh import vertex_normals_plain
    from align3d_torch.tools.roofline import device_ms, time_ms

    libs = build_variants("mesh.cu", MESH_VARIANTS, _mesh_entry_types)
    out = {}
    for label, (ev, points, faces, ids) in mesh_inputs(device).items():
        n, f, d = ev.n_vertices, faces.shape[0], ev.degree
        row_major = ids.t().contiguous()
        face_buf = torch.empty((f + 1, 3), dtype=torch.float32, device=device)  # once per topology
        def call(name):
            stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)  # the capture's, in graph_ms
            res = torch.empty((n, 3), dtype=torch.float32, device=device)
            design, entry = MESH_VARIANTS[name]["A3D_MESH_DESIGN"], libs[name].a3d_mesh_normals
            if design == 1:
                args = (points.data_ptr(), ev.table.data_ptr(), ev.counts.data_ptr(), n, d)
            else:
                table = row_major if design == 0 else ids
                args = (points.data_ptr(), faces.data_ptr(), f, table.data_ptr(), ev.counts.data_ptr(), n, d,
                        *((face_buf.data_ptr(),) if design in (0, 2) else ()))
            _kernels.check(entry(*args, res.data_ptr(), stream), f"a3d_mesh_normals ({name})")
            return res

        ref = vertex_normals_plain(points, ev.table, ev.counts)
        row = {"faces": f, "vertices": n, "degree": d}
        calls = CALLS["frame"] if f < 1_000_000 else CALLS["series"]
        order = list(MESH_VARIANTS)
        for name in order + order[::-1]:
            fn = lambda name=name: call(name)  # noqa: E731
            row.setdefault(f"{name}_bitwise", same_bits(fn(), ref))
            ms, acts = device_ms(fn, calls)
            row.setdefault(f"{name}_ms", []).append(ms)
            row.setdefault(f"{name}_activities", []).append(len(acts))
            row.setdefault(f"{name}_event_ms", []).append(time_ms(fn, reps=calls))
            if MESH_VARIANTS[name]["A3D_MESH_DESIGN"] != 2:  # a cooperative launch is not captured
                row.setdefault(f"{name}_graph_ms", []).append(graph_ms(fn, calls))
        if not all(v for k, v in row.items() if k.endswith("_bitwise")):
            raise AssertionError(f"a K5 build differs from its plain twin on the {label} mesh")
        out[label] = row
        del ref, face_buf, row_major
    return out


def mesh_host(device, calls: int = 2000) -> dict:
    """Host µs per K5 call, back to back, through three wrappers on the
    204,800-face grid: ``MeshNormals.__call__``, the free
    ``vertex_normals``, and the earlier wrapper around the two-launch build."""
    import time

    from align3d_torch.ops import mesh

    lib = build_variants("mesh.cu", {"two_launch": MESH_VARIANTS["two_launch"]}, _mesh_entry_types)["two_launch"]
    ev, points, faces, ids = mesh_inputs(device)["grid320"]
    row_major = ids.t().contiguous()

    def parent(points=points, faces=faces, table=row_major, counts=ev.counts):
        dev = points.device
        n, f, d = points.shape[0], faces.shape[0], table.shape[1]
        _kernels.check_tensor(points, "points", (n, 3), torch.float32, dev)
        _kernels.check_tensor(faces, "faces", (f, 3), torch.int32, dev)
        _kernels.check_tensor(table, "table", (n, d), torch.int32, dev)
        _kernels.check_tensor(counts, "counts", (n,), torch.float32, dev)
        face_buf = torch.empty((f + 1, 3), dtype=torch.float32, device=dev)
        res = torch.empty((n, 3), dtype=torch.float32, device=dev)
        _kernels.check(lib.a3d_mesh_normals(
            points.data_ptr(), faces.data_ptr(), f, table.data_ptr(), counts.data_ptr(), n, d,
            face_buf.data_ptr(), res.data_ptr(), ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)),
            "a3d_mesh_normals")
        return res

    wrappers = {"mesh_normals_call": lambda: ev(points),
                "vertex_normals": lambda: mesh.vertex_normals(points, ev.table, ev.counts),
                "two_launch_wrapper": parent}
    out = {"faces": faces.shape[0], "calls": calls}
    for name in ("two_launch_wrapper", "mesh_normals_call", "vertex_normals", "vertex_normals", "mesh_normals_call",
                 "two_launch_wrapper"):
        fn = wrappers[name]
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        out.setdefault(f"{name}_host_us", []).append(host / calls * 1e6)
    return out


def table_gather(device) -> dict:
    """P2's table mode, built and run several ways (see the module docstring)."""
    from align3d_torch.tools import roofline as rl

    variants = {"ilp4_u16": {}, "ilp8_u8": {"A3D_TABLE_ILP": 8, "A3D_TABLE_U": 8},
                "ilp16_u4": {"A3D_TABLE_ILP": 16, "A3D_TABLE_U": 4},
                "ilp4_u16_min8": {"A3D_TABLE_MIN_BLOCKS": 8}, "sector32": {"A3D_TABLE_SECTOR": 1},
                "l2fetch": {"A3D_ABLATE_L2_FETCH": 1}}
    chains = {"ilp8_u8": (8, 8), "ilp16_u4": (16, 4)}
    libs = build_variants("roofline.cu", variants, lambda name: {
        "a3d_gather_table": _kernels.ENTRIES["a3d_gather_table"],
        **({"a3d_l2_fetch_granularity": [_I, ctypes.POINTER(_I)]} if name == "l2fetch" else {})})
    p = rl.Probes(device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)

    def run(name, table, steps):
        res = torch.empty_like(p.table_x)
        _kernels.check(libs[name].a3d_gather_table(table.data_ptr(), table.numel(), p.table_x.data_ptr(),
                                                   res.data_ptr(), p.table_n, steps, stream), "a3d_gather_table")
        return res

    def granularity(nbytes: int) -> int:
        old = _I(0)
        _kernels.check(libs["l2fetch"].a3d_l2_fetch_granularity(nbytes, ctypes.byref(old)),
                       "a3d_l2_fetch_granularity")
        return old.value

    out = {"bitwise": {}}
    for name in variants:
        table = p.tables["hbm"]
        if name == "sector32":  # the twin of a table whose every entry is its sector's sum (int32 wraps)
            sums = table.view(-1, 8).to(torch.int64).sum(1).repeat_interleave(8)
            table = (((sums & 0xFFFFFFFF) + 2**31) % 2**32 - 2**31).to(torch.int32)
            del sums
        ref = rl.table_gather_plain(table, p.table_x, 1, *chains.get(name, (rl.TABLE_ILP, rl.TABLE_U)))
        del table
        out["bitwise"][name] = torch.equal(run(name, p.tables["hbm"], 1), ref)
    if not all(out["bitwise"].values()):
        raise AssertionError(f"a P2 build differs from its twin: {out['bitwise']}")
    default = granularity(32)
    granularity(default)
    out["l2_fetch_granularity_default"] = default
    order = [*variants, "l2fetch_32"]
    for mode, table in p.tables.items():
        steps = rl.TABLE_STEPS[mode]
        gathers = p.table_n * rl.TABLE_ILP * rl.TABLE_U * steps
        row = {"gathers": gathers, "table_bytes": table.numel() * 4}
        for name in order + order[::-1]:
            if name == "l2fetch_32":
                granularity(32)
            try:
                ms = rl.time_ms(lambda n=name.removesuffix("_32"), t=table, s=steps: run(n, t, s))
            finally:
                if name == "l2fetch_32":
                    granularity(default)
            row.setdefault(f"{name}_ms", []).append(ms)
            row.setdefault(f"{name}_gathers_per_s", []).append(gathers / ms * 1e3)
            if mode == "hbm":
                row.setdefault(f"{name}_share_of_bound", []).append(rl.table_bound_ms(gathers) / ms)
        if mode == "hbm":
            row["bound_ms"] = rl.table_bound_ms(gathers)
        out[mode] = row
    del p
    return out


#: ``icp_banded.cu``'s builds for the split of K7's and K8's time: the
#: library's, without the stack's reduction, without the target gathers, and
#: without both.
BANDED_VARIANTS = {"full": {}, "no_reduce": {"A3D_BANDED_SKIP_REDUCE": 1},
                   "no_gather": {"A3D_BANDED_SKIP_GATHER": 1},
                   "neither": {"A3D_BANDED_SKIP_REDUCE": 1, "A3D_BANDED_SKIP_GATHER": 1}}
BANDED_TWIST = [0.004, -0.002, 0.003, 0.002, -0.003, 0.001]  # the pose the steps are taken at (chip_smoke's)


def banded_inputs(device, batch: int = 64) -> dict:
    """K7's and K8's arguments at 640x480, level 0 (``default_tpu``'s band
    radius there), pose ``BANDED_TWIST``, the bands predicted from the source
    centroids: "batch64", the ``batch`` real pairs, and "batch1", the first of
    them (sample1 frames 0 <- 1). Keys "K7" / "K8" -> shape -> arguments."""
    from align3d_torch.icp.params import MsIcpParams
    from align3d_torch.ops import icp_pallas_v3 as k3
    from align3d_torch.ops import icp_pallas_v4 as k4
    from align3d_torch.se3 import Transform
    from align3d_torch.tools.series import real_pairs

    sources, targets = real_pairs(batch, device)
    h, w = targets.height, targets.width
    pose = Transform.exp(torch.tensor(BANDED_TWIST, device=device))
    rot = pose.rotation.expand(batch, 3, 3).contiguous()
    trans = pose.translation.expand(batch, 3).contiguous()
    sp = k3.pack_source(sources.points.reshape(batch, h, w, 3), sources.mask.reshape(batch, h, w),
                        sources.intensities.reshape(batch, h, w))
    bases = k3.predict_bases_centroid_batched(rot, trans, k3.source_centroids_batched(sp, targets.intrinsics),
                                              targets.intrinsics, sp.shape[1] * k3.CHUNK)
    params = k3.params_to_tuple(MsIcpParams.default_tpu("pallas")[0])
    out = {}
    for key, mod in (("K7", k3), ("K8", k4)):
        tp = mod.pack_target(targets.points.reshape(batch, h, w, 3), targets.normals.reshape(batch, h, w, 3),
                             targets.mask.reshape(batch, h, w), targets.intensity_map.reshape(batch, h + 2, w + 2))
        full = (rot, trans, *bases, sp, tp)
        out[key] = {"batch1": (*(a[:1].contiguous() for a in full), targets.intrinsics, h, w, params),
                    "batch64": (*full, targets.intrinsics, h, w, params)}
    return out


def banded_sections(device) -> dict:
    """K7 and K8 built with and without the stack's reduction and the target
    gathers (``BANDED_VARIANTS``): device ms of each at 640x480, B = 1 and
    B = 64, in the order of ``BANDED_VARIANTS`` and back; the full build held
    bitwise against the library's kernel; the bound and its share."""
    from align3d_torch.ops import icp_pallas_v3 as k3
    from align3d_torch.ops import icp_pallas_v4 as k4
    from align3d_torch.tools import roofline as rl

    libs = build_variants("icp_banded.cu", BANDED_VARIANTS,
                          lambda _: {"a3d_icp_banded": _kernels.ENTRIES["a3d_icp_banded"]})
    kinds = {"K7": (0, True, k3.NCH, torch.float32, k3.icp_step_pallas_batched),
             "K8": (1, False, k4.NCH, torch.int32, k4.icp_step_pallas_batched)}
    out = {}
    for key, shapes in banded_inputs(device).items():
        variant, stats, nch, dtype, wrapper = kinds[key]
        out[key] = {}
        for shape, args in shapes.items():
            def call(name, args=args):
                return k3.launch(variant, *args, stats, nch, dtype, library=libs[name])

            lib_out = wrapper(*args, **({"emit_stats": True} if stats else {}))
            full = call("full")
            if not all(torch.equal(a, b) for a, b in zip(full, lib_out) if a is not None):
                raise AssertionError(f"{key} {shape}: the ablation's full build differs from the library's kernel")
            nbytes = rl.banded_step_bytes(args[5], args[6], stats)
            bound_ms = max(nbytes / rl.PEAK_HBM_BYTES, rl.banded_step_flops(args[5]) / rl.PEAK_F32_FLOPS) * 1e3
            row = {"pairs": args[0].shape[0], "bound_ms": bound_ms, "bound_bytes": nbytes}
            order, calls = list(BANDED_VARIANTS), CALLS["frame"] if shape == "batch1" else CALLS["series"]
            for name in order + order[::-1]:
                row.setdefault(f"{name}_ms", []).append(
                    rl.device_ms(lambda name=name: call(name), calls, "icp_banded_kernel")[0])
            mean = {name: sum(row[f"{name}_ms"]) / 2 for name in order}
            row["share_of_bound"] = bound_ms / mean["full"]
            row["reduce_ms"] = mean["full"] - mean["no_reduce"]  # what the stack's reduction adds
            row["gather_ms"] = mean["full"] - mean["no_gather"]  # what the target gathers add
            out[key][shape] = row
        del shapes
    return out


#: Set to the path of an earlier ``ops/icp_pallas_v3.py`` (a parent's
#: checkout) to time its band prediction beside the kernels in
#: ``band_prediction``.
BAND_BEFORE_ENV = "A3D_BAND_BEFORE"


def _module_at(path: str):
    """The module at ``path``, loaded under another name (its imports resolve
    to this checkout's package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("band_prediction_before", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host_ms(fn, runs: int) -> list[float]:
    """Host ms of ``runs`` calls of ``fn``, each ended by a synchronise."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _events_ms(fn, calls: int) -> float:
    """ms a call of ``calls`` back-to-back calls between one CUDA event pair."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _activities(fn, names: dict) -> dict:
    """The device activities of one call of ``fn``: their count, and the
    launches of each kernel of ``names`` (key -> symbol)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    acts = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"activities": len(acts), **{key: sum(sym in name for name in acts) for key, sym in names.items()}}


def band_prediction(device) -> dict:
    """K9 (``source_centroids_batched``) and K10
    (``predict_bases_centroid_batched``) at 640x480, level 0, on the first
    real pair (B = 1) and the 64 real pairs (B = 64), the pose
    ``BANDED_TWIST``: held against their twins (K9 bitwise, NaN in the same
    places; K10's int32 outputs equal); device ms a launch and ms a call of
    back-to-back calls of each kernel, its twin and, for K9, the one PyTorch
    call of the same sums (``reshape(...).sum`` of the six channels: not
    XLA's order); host ms a call (median of 20 for the kernels, 5 for the
    twins and the earlier code), each ended by a synchronise; the bound.
    With ``A3D_BAND_BEFORE`` set, the earlier module's functions are timed
    beside. Then one ``pallas_v4`` align of the 64 pairs, 10 GN iterations:
    the device activities of its GN loop and of its prepack, with K8's,
    K9's and K10's launches, on the kernels and on the twins (or the
    earlier code), timed in the order kernels, twins, twins, kernels."""
    import os

    from align3d_torch.icp import image_icp as ii
    from align3d_torch.icp.params import IcpParams
    from align3d_torch.ops import icp_pallas_v3 as k3
    from align3d_torch.se3 import Transform
    from align3d_torch.tools import roofline as rl
    from align3d_torch.tools.series import real_pairs

    before_path = os.environ.get(BAND_BEFORE_ENV)
    before = _module_at(before_path) if before_path else None
    sources, targets = real_pairs(64, device)
    h, w, intr, pairs = targets.height, targets.width, targets.intrinsics, sources.points.shape[0]
    sp64 = k3.pack_source(sources.points.reshape(pairs, h, w, 3), sources.mask.reshape(pairs, h, w),
                          sources.intensities.reshape(pairs, h, w))
    pose = Transform.exp(torch.tensor(BANDED_TWIST, device=device))
    nchunks, g = sp64.shape[1], sp64.shape[3] // k3.CHUNK
    hp = nchunks * k3.CHUNK
    out = {"before": before_path, "shapes": {}}
    for shape, b in (("batch1", 1), ("batch64", pairs)):
        sp = sp64[:b].contiguous()
        rot, trans = pose.rotation.expand(b, 3, 3).contiguous(), pose.translation.expand(b, 3).contiguous()
        calls = CALLS["frame"] if b == 1 else CALLS["series"]
        centroids = k3.source_centroids_batched(sp, intr)
        twin = k3.source_centroids_plain(sp, intr)
        if not all(same_bits(x, y) for x, y in zip(centroids, twin)):
            raise AssertionError(f"K9 {shape} differs from its twin")
        bases = k3.predict_bases_centroid_batched(rot, trans, centroids, intr, hp)
        if not all(torch.equal(x, y) for x, y in zip(bases, k3.predict_bases_centroid_plain(rot, trans, centroids,
                                                                                              intr, hp))):
            raise AssertionError(f"K10 {shape} differs from its twin")
        z = sp[:, :, 0]
        row, col = k3._pixel_grid(nchunks, z.shape[2], device)
        dirx, diry = k3._rays(row, col, intr)
        m = (z > 0).to(torch.float32)
        channels = torch.stack([m, dirx * z, diry * z, z, row * m, col * m]).reshape(6, b, nchunks, g, k3.CHUNK, 128)
        library = channels.sum(dim=(-2, -1))
        fns = {"k9": lambda: k3.source_centroids_batched(sp, intr),
               "k9_plain": lambda: k3.source_centroids_plain(sp, intr),
               "k9_library": lambda: channels.sum(dim=(-2, -1)),
               "k10": lambda: k3.predict_bases_centroid_batched(rot, trans, centroids, intr, hp),
               "k10_plain": lambda: k3.predict_bases_centroid_plain(rot, trans, centroids, intr, hp)}
        if before is not None:
            fns["k9_before"] = lambda: before.source_centroids_batched(sp, intr)
            fns["k10_before"] = lambda: before.predict_bases_centroid_batched(rot, trans, centroids, intr, hp)
        kernels = {"k9": "source_centroids_kernel", "k10": "predict_bases_kernel"}
        safe = torch.clamp(library[0], min=1.0)
        library_means = (torch.stack([library[1], library[2], library[3]], dim=-1) / safe[..., None],
                         library[4] / safe, library[5] / safe, library[0])
        row_out = {"pairs": b,
                   "k9_library_max_abs_diff": max(float((x - y).abs().max()) for x, y in zip(library_means, centroids)),
                   "k9_bound_bytes": rl.centroids_bytes(sp), "k9_bound_flops": rl.centroids_flops(sp),
                   "k10_bound_bytes": rl.predict_bytes(b, nchunks, g),
                   "k10_bound_flops": rl.predict_flops(b, nchunks, g)}
        for key in ("k9", "k10"):
            row_out[f"{key}_bound_ms"] = max(row_out[f"{key}_bound_bytes"] / rl.PEAK_HBM_BYTES,
                                             row_out[f"{key}_bound_flops"] / rl.PEAK_F32_FLOPS) * 1e3
        for name, fn in fns.items():
            cheap = name in kernels or name == "k9_library"
            ms, acts = rl.device_ms(fn, calls if cheap else 2, kernels.get(name))
            row_out[f"{name}_ms"] = ms
            row_out[f"{name}_activities_a_call"] = len(acts) / (calls if cheap else 2)
            row_out[f"{name}_call_ms"] = _events_ms(fn, calls if cheap else 2)
            row_out[f"{name}_host_ms"] = sorted(_host_ms(fn, 20 if name in kernels else 5))
        out["shapes"][shape] = row_out
        del channels, library, library_means

    # One pallas_v4 align of the 64 pairs: its GN loop and its prepack, on the
    # kernels and on the twins (or the earlier code) patched in.
    flat = (sources.points.reshape(pairs, -1, 3), sources.mask.reshape(pairs, -1),
            sources.intensities.reshape(pairs, -1), targets.points.reshape(pairs, -1, 3),
            targets.mask.reshape(pairs, -1), targets.normals.reshape(pairs, -1, 3), targets.intensity_map)
    params = IcpParams(max_iterations=10, engine="pallas_v4")
    ident = Transform.identity((pairs,), device=device)
    names = {"k8": "icp_banded_kernel<true>", "k9": "source_centroids_kernel", "k10": "predict_bases_kernel"}
    alt = before or k3
    plain = {"source_centroids_batched": getattr(alt, "source_centroids_batched" if before else "source_centroids_plain"),
             "predict_bases_centroid_batched": getattr(alt, "predict_bases_centroid_batched" if before
                                                       else "predict_bases_centroid_plain")}
    kept = {name: getattr(k3, name) for name in plain}
    aligns = out["align_pallas_v4_batch64"] = {}
    alt = "before" if before else "plain"
    for label in ("kernels", alt, alt, "kernels"):  # the host's drift falls on both alike
        for name, fn in (plain if label == alt else {}).items():
            setattr(k3, name, fn)
        try:
            packed = ii.prepack_v4_batched(*flat, intr)

            def loop():  # eager: a graph's replay would not call the functions patched in
                return ii._v4_loop(ident.rotation, ident.translation, *packed[:2], *packed[2], *packed[3:], intr,
                                   params)

            if label not in aligns:
                acts = _activities(loop, names)
                aligns[label] = {"gn_loop": acts, "activities_per_iteration": acts["activities"] / params.max_iterations,
                                 "prepack": _activities(lambda: ii.prepack_v4_batched(*flat, intr), names),
                                 "gn_loop_host_ms": []}
            aligns[label]["gn_loop_host_ms"] += _host_ms(loop, 5)
        finally:
            for name, fn in kept.items():
                setattr(k3, name, fn)
    for row in aligns.values():
        row["gn_loop_host_ms"].sort()
    return out


#: K11's bytes a pair: the 29 floats it reads of each block, the state it
#: reads (pose, best residual: 13 floats) and writes (pose, best pose and
#: residual: 25 floats).
GN_UPDATE_BYTES = (2 * 29 + 13 + 25) * 4


def gn_update(device) -> dict:
    """K11 (``optim/gauss_newton.py::gn_update``) on the blocks of K1 and of
    K8 at 640x480, level 0, pose ``BANDED_TWIST``: the first real pair
    (B = 1) and the 64 real pairs (B = 64). Device ms a launch, ms a call of
    back-to-back calls and host ms a call (median of 20, each ended by a
    synchronise) of the kernel and of its twin on the card (the PyTorch ops
    it replaces), the twin's device activities a call, the bytes. Then one
    exact-engine align of the first pair and one ``pallas_v4`` align of the
    64 pairs, 10 GN iterations each: the device activities of the GN loop
    and its host ms, with K11 and with the twin patched in, in the order
    kernel, twin, twin, kernel."""
    from align3d_torch.icp import image_icp as ii
    from align3d_torch.icp.params import IcpParams
    from align3d_torch.ops import icp_fused
    from align3d_torch.ops import icp_pallas_v3 as k3
    from align3d_torch.ops import icp_pallas_v4 as k4
    from align3d_torch.optim import gauss_newton as gn
    from align3d_torch.se3 import Transform
    from align3d_torch.tools import roofline as rl
    from align3d_torch.tools.series import real_pairs

    sources, targets = real_pairs(64, device)
    intr, pairs = targets.intrinsics, sources.points.shape[0]
    flat = (sources.points.reshape(pairs, -1, 3), sources.mask.reshape(pairs, -1),
            sources.intensities.reshape(pairs, -1), targets.points.reshape(pairs, -1, 3),
            targets.mask.reshape(pairs, -1), targets.normals.reshape(pairs, -1, 3), targets.intensity_map)
    pose = Transform.exp(torch.tensor(BANDED_TWIST, device=device))
    engines = {"k1": IcpParams(max_iterations=10), "k8": IcpParams(max_iterations=10, engine="pallas_v4")}
    out = {"bytes_a_pair": GN_UPDATE_BYTES, "shapes": {}}
    for shape, b in (("batch1", 1), ("batch64", pairs)):
        rot, trans = pose.rotation.expand(b, 3, 3), pose.translation.expand(b, 3)
        calls = CALLS["frame"] if b == 1 else CALLS["series"]
        part = [t[:b] for t in flat]
        for engine, params in engines.items():
            if engine == "k1":
                packed = ii.prepack_batched(*part)
                aug = icp_fused.icp_step_fused(rot.contiguous(), trans.contiguous(), *packed, intr, params)
                blocks = aug[:, 0], aug[:, 1]
            else:
                sp, tp, centroids, h, w = ii.prepack_v4_batched(*part, intr)
                bases = k3.predict_bases_centroid_batched(rot.contiguous(), trans.contiguous(), centroids, intr,
                                                          sp.shape[1] * k3.CHUNK)
                blocks = k4.icp_step_pallas_batched(rot.contiguous(), trans.contiguous(), *bases, sp, tp, intr, h, w,
                                                    k3.params_to_tuple(params))[:2]
            w1, w2 = float(np.float32(params.weight)), float(np.float32(params.color_weight))
            state, twin = gn.GNState.start(rot, trans), gn.GNState.start(rot, trans)
            fns = {"k11": lambda: gn.gn_update(*blocks, w1, w2, state),
                   "k11_plain": lambda: gn.gn_update_plain(*blocks, w1, w2, twin)}
            row = {"pairs": b, "bytes": b * GN_UPDATE_BYTES,
                   "bound_ms": b * GN_UPDATE_BYTES / rl.PEAK_HBM_BYTES * 1e3}
            for name, fn in fns.items():
                ms, acts = rl.device_ms(fn, calls, "gn_update_kernel" if name == "k11" else None)
                row[f"{name}_ms"] = ms
                row[f"{name}_activities_a_call"] = len(acts) / calls
                row[f"{name}_call_ms"] = _events_ms(fn, calls)
                row[f"{name}_host_ms"] = sorted(_host_ms(fn, 20))[10]
            out["shapes"][f"{engine}_{shape}"] = row

    aligns = out["align_gn_loop"] = {}
    names = {"k1": "icp_step_kernel", "k8": "icp_banded_kernel<true>", "k11": "gn_update_kernel"}
    for engine, b in (("k1", 1), ("k8", pairs)):
        params, part = engines[engine], [t[:b] for t in flat]
        ident = Transform.identity((b,), device=device)
        if engine == "k1":
            packed = ii.prepack_batched(*part)

            def loop():  # eager: a graph's replay would not call the gn_update patched in
                return ii._exact_loop(ident.rotation, ident.translation, *packed, intr, params)
        else:
            packed = ii.prepack_v4_batched(*part, intr)

            def loop():
                return ii._v4_loop(ident.rotation, ident.translation, *packed[:2], *packed[2], *packed[3:], intr,
                                   params)
        rows = aligns[f"{engine}_batch{b}"] = {}
        for label in ("kernel", "twin", "twin", "kernel"):  # the host's drift falls on both alike
            ii.gn_update = gn.gn_update_plain if label == "twin" else gn.gn_update
            try:
                if label not in rows:
                    acts = _activities(loop, names)
                    rows[label] = {"gn_loop": acts, "gn_loop_host_ms": [],
                                   "activities_per_iteration": acts["activities"] / params.max_iterations}
                rows[label]["gn_loop_host_ms"] += _host_ms(loop, 5)
            finally:
                ii.gn_update = gn.gn_update
        for row in rows.values():
            row["gn_loop_host_ms"].sort()
    return out


SECTIONS = {"splat_exact": splat_exact, "tap_packs": tap_packs, "slice_composition": slice_composition,
            "slice_pixels": slice_pixels, "mesh_designs": mesh_designs, "mesh_host": mesh_host,
            "table_gather": table_gather, "banded_sections": banded_sections, "band_prediction": band_prediction,
            "gn_update": gn_update}


def main(argv: list[str] | None = None) -> int:
    names = sys.argv[1:] if argv is None else argv
    unknown = [n for n in names if n not in SECTIONS]
    if unknown:
        print(f"FAIL: unknown comparisons {unknown}; choose from {list(SECTIONS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: the ablation tool needs a CUDA device", file=sys.stderr)
        return 1
    from align3d_torch.tools.roofline import card

    device = torch.device("cuda")
    result = {"card": card()}
    for name in names or SECTIONS:
        result[name] = SECTIONS[name](device)
    print(json.dumps({"ablate": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
