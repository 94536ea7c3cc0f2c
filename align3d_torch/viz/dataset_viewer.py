"""One-shot dataset preview renders + animated fly-throughs for the CLI
``viewer`` subcommand and the odometry ``--show`` flag (port of
``align3d_tpu/viz/dataset_viewer.py``).

Functional parity with the reference's interactive ``RgbdDatasetViewer``
(``src/viz/rgbd_dataset_viewer.rs:37-57``): the same scene through the same
spherical-fit camera math, rendered on ``device`` (the card unless the
caller asks for the CPU) into a PNG or an animated GIF orbit.

The GIF is :mod:`align3d_torch.io.gif`'s: one fixed 3-3-2 palette, each
channel to its nearest level, so every decoded pixel is within half a
palette step of the render, at most (18, 18, 42) in red, green and blue
(``gif.BOUND``). The JAX package writes its GIF through PIL's adaptive
palette, so the two files' pixels differ within that bound.
"""

from __future__ import annotations

import math

import numpy as np

from align3d_torch.io import gif
from align3d_torch.viz.viewers import RgbdDatasetViewer


def trajectory_polyline(trajectory, samples_per_edge: int = 24) -> np.ndarray:
    """Dense (N, 3) points tracing the trajectory's camera centers — an
    overlay the reference's viewer lacks (beyond-parity). Host numpy, as
    in the JAX package."""
    centers = trajectory.camera_to_world.translation.detach().cpu().numpy().astype(np.float32).reshape(-1, 3)
    if len(centers) < 2:
        return centers.reshape(-1, 3)
    segs = []
    for a, b in zip(centers[:-1], centers[1:]):
        t = np.linspace(0.0, 1.0, samples_per_edge, endpoint=False)[:, None]
        segs.append(a[None] * (1.0 - t) + b[None] * t)
    segs.append(centers[-1:])
    return np.concatenate(segs, axis=0)


def _add_trajectory_overlay(viewer, trajectory) -> None:
    if trajectory is None or len(trajectory) == 0:
        return
    line = trajectory_polyline(trajectory)
    colors = np.broadcast_to(
        np.array([255, 64, 32], np.uint8), (len(line), 3)
    ).copy()
    viewer.viewer.add(line, colors=colors)


def posed_viewer(fmt, path, max_frames, width, height, trajectory, device) -> RgbdDatasetViewer:
    from align3d_torch.io.datasets import load_dataset

    dataset = load_dataset(fmt, path)
    viewer = RgbdDatasetViewer(dataset, width=width, height=height, device=device)
    viewer.build_scene(max_frames=max_frames, stride=1, trajectory=trajectory)
    _add_trajectory_overlay(
        viewer, trajectory if trajectory is not None else dataset.trajectory()
    )
    return viewer


def render_dataset_preview(
    fmt: str,
    path: str,
    output: str,
    max_frames: int | None = None,
    width: int = 640,
    height: int = 480,
    trajectory=None,
    device="cuda",
) -> str:
    """Load a dataset, pose every frame's point cloud by its trajectory
    (``trajectory`` overrides the dataset's own — the odometry ``--show``
    path), overlay the trajectory polyline, and render a single fitted view
    to ``output`` (PNG)."""
    viewer = posed_viewer(fmt, path, max_frames, width, height, trajectory, device)
    img = viewer.viewer.render_frame()
    img.save_png(output)
    return output


def flythrough_views(n_views: int) -> list[tuple[float, float]]:
    """(azimuth, elevation) of each view of the orbit."""
    return [(2.0 * math.pi * k / n_views, 0.35 * math.sin(2.0 * math.pi * k / n_views)) for k in range(n_views)]


def render_dataset_flythrough(
    fmt: str,
    path: str,
    output: str,
    max_frames: int | None = None,
    width: int = 480,
    height: int = 360,
    n_views: int = 24,
    trajectory=None,
    ms_per_frame: int = 120,
    device="cuda",
) -> str:
    """Animated orbit of the reconstructed scene (a GIF) with the
    trajectory polyline overlaid — the headless stand-in for the reference's
    interactive event loop (``window.rs:145-385``): each GIF frame is one
    step of the orbiting camera controller."""
    viewer = posed_viewer(fmt, path, max_frames, width, height, trajectory, device)
    frames = []
    for az, el in flythrough_views(n_views):
        img = viewer.viewer.render_frame(azimuth=az, elevation=el)
        frames.append(img.color[..., :3].cpu().numpy())
    gif.write(output, frames, ms_per_frame=ms_per_frame)
    return output
