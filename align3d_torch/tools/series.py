"""The real RGB-D series of the throughput path, built from the in-repo
SlamTb fixtures with the port's own loader (no JAX).

Copies of the JAX package's helpers, by the same recipes:

* :func:`real_frames` — ``benches/bench_odometry.py::_real_frames``: 65
  sample1 frames, forward, then back (palindrome), then wrapped: 64 adjacent
  pairs, the batch of the throughput configuration;
* :func:`mixed_frames` — ``_mixed_frames``: sample1 then sample2 (forward
  and back) then sample1 again, so the bilateral filter needs grids of very
  different depth (sample1 ~70-140 channels, sample2 ~750);
* :func:`bucket_plan` — ``_bucket_plan``: the depth-bucket plan of a numpy
  depth series, from each frame's nonzero minimum and maximum;
* :func:`real_pairs` — ``bench.py::_real_pairs``: level-0 range images of
  distinct real (source, target) pairs, forward then reversed over sample1
  + sample2.

A series keeps, per frame, its fixture and index, its depth scale and its
ground-truth pose, so a pair's relative pose can be checked. The JAX
helpers give sample2's frames sample1's depth scale; here each frame keeps
its own, so the sample2 pairs of the mixed series are metric.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from align3d_torch import config
from align3d_torch.camera import CameraIntrinsics
from align3d_torch.io.datasets import SlamTbDataset
from align3d_torch.ops.bilateral import plan_depth_buckets
from align3d_torch.range_image import RangeImage, build_pyramid_impl
from align3d_torch.se3 import Transform, stack

#: The fixture tree: the repository's ``tests/data`` unless ``ALIGN3D_REF_DATA`` names another.
DATA = Path(config.REF_DATA_DIR)
SERIES_FRAMES = 65


@dataclasses.dataclass
class Series:
    colors: np.ndarray  # (N, H, W, 3) u8
    depths: np.ndarray  # (N, H, W) u16
    camera: CameraIntrinsics
    depth_scales: np.ndarray  # (N,) f32
    frames: list  # (fixture name, index) per frame
    camera_to_world: Transform  # (N,) ground truth, CPU

    def __len__(self) -> int:
        return len(self.frames)

    def relative_ground_truth(self) -> Transform:
        """Ground truth of each adjacent pair i -> i + 1: frame i + 1 seen
        from frame i, (N - 1,)."""
        pose = self.camera_to_world
        return pose[:-1].inverse() @ pose[1:]

    def true_pairs(self) -> np.ndarray:
        """Adjacent pairs whose frames are neighbours in one fixture."""
        return np.array(
            [a[0] == b[0] and abs(a[1] - b[1]) == 1 for a, b in zip(self.frames[:-1], self.frames[1:])]
        )


def _load(name: str) -> tuple[SlamTbDataset, list]:
    ds = SlamTbDataset.load(str(DATA / "rgbd" / name))
    return ds, [ds.get(i) for i in range(len(ds))]


def _series(picked: list) -> Series:
    """``picked``: (name, index, RgbdFrame) per frame of the series."""
    return Series(
        colors=np.stack([f.image.color for _, _, f in picked]),
        depths=np.stack([f.image.depth for _, _, f in picked]),
        camera=picked[0][2].camera,
        depth_scales=np.array([f.image.depth_scale for _, _, f in picked], np.float32),
        frames=[(name, i) for name, i, _ in picked],
        camera_to_world=stack([f.camera_to_world for _, _, f in picked]),
    )


def real_frames(n: int = SERIES_FRAMES) -> Series:
    """sample1 forward, then back, then wrapped to ``n`` frames (65: 64 pairs)."""
    _, base = _load("sample1")
    picked = [("sample1", i, f) for i, f in enumerate(base)]
    picked = picked + picked[-2::-1]
    return _series((picked + picked[: n - len(picked)])[:n])


def mixed_frames(n: int = SERIES_FRAMES) -> Series:
    """sample1, sample2 forward and back, then sample1 again, ``n`` frames."""
    _, f1 = _load("sample1")
    _, f2 = _load("sample2")
    s1 = [("sample1", i, f) for i, f in enumerate(f1)]
    s2 = [("sample2", i, f) for i, f in enumerate(f2)]
    picked = s1 + s2 + s2[-2::-1]
    return _series((picked + s1[: n - len(picked)])[:n])


def bucket_plan(depths: np.ndarray, filt, quantum: int = 16) -> list:
    """The depth-bucket plan of an (N, H, W) numpy depth series."""
    nz = np.where(depths > 0, depths, np.uint16(65535))
    cmin = nz.reshape(len(depths), -1).min(axis=1)
    cmax = depths.reshape(len(depths), -1).max(axis=1)
    return plan_depth_buckets(cmin, cmax, filt.sigma_color, quantum=quantum)


def real_pairs(batch: int, device) -> tuple[RangeImage, RangeImage]:
    """(sources, targets): level-0 range images of ``batch`` distinct real
    pairs, batched on ``device``: sample1 + sample2 frames, pairs (i + 1 ->
    i) forward, then (i -> i + 1) reversed, as ``bench.py`` takes them. Only
    the frames the pairs use are decoded and built (each frame's images are
    its own, whatever else is in the batch)."""
    datasets = {name: SlamTbDataset.load(str(DATA / "rgbd" / name)) for name in ("sample1", "sample2")}
    order = [(name, i) for name, ds in datasets.items() for i in range(len(ds))]
    n = len(order)
    src = list(range(1, n)) + list(range(0, n - 1))
    tgt = list(range(0, n - 1)) + list(range(1, n))
    if len(src) < batch:
        raise RuntimeError(f"only {len(src)} distinct pairs available")
    src, tgt = src[:batch], tgt[:batch]
    used = sorted(set(src) | set(tgt))
    series = _series([(*order[k], datasets[order[k][0]].get(order[k][1])) for k in used])
    at = {k: j for j, k in enumerate(used)}
    images = build_pyramid_impl(
        True, True, 1, 1.0, series.camera, torch.from_numpy(series.depth_scales),
        torch.from_numpy(series.colors).to(device), torch.from_numpy(series.depths.astype(np.int32)).to(device),
    )[0]
    return (images.frames(torch.tensor([at[k] for k in src], device=images.device)),
            images.frames(torch.tensor([at[k] for k in tgt], device=images.device)))
