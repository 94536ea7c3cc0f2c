"""Headless viewers (port of ``align3d_tpu/viz/viewers.py``; reference
``src/viz/geoviewer.rs``, ``src/viz/rgbd_dataset_viewer.rs``).

The reference viewers open an interactive Vulkan window; these render the
same scenes headlessly to PNG frames, on ``device`` (the card unless the
caller asks for the CPU). Framing uses the reference's spherical fit so the
compositions match.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from align3d_torch.viz.render import OffscreenRenderer, on_device
from align3d_torch.viz.scene import Node, Scene
from align3d_torch.viz.virtual_camera import VirtualCameraSphericalBuilder


class GeoViewer:
    """Accumulate geometries, render orbit frames (geoviewer.rs:7-67)."""

    def __init__(self, width: int = 640, height: int = 480, device="cuda"):
        self.scene = Scene()
        self.renderer = OffscreenRenderer(width, height, device=device)

    @property
    def device(self) -> torch.device:
        return self.renderer.device

    def add(self, points, colors=None, faces=None, normals=None, transform=None) -> Node:
        """Host arrays are uploaded to the viewer's device; tensors must be
        on it already."""
        node = Node(
            points=on_device(points, np.float32, self.device).reshape(-1, 3),
            colors=None if colors is None else on_device(colors, np.uint8, self.device).reshape(-1, 3),
            faces=None if faces is None else on_device(faces, np.int64, self.device).reshape(-1, 3),
            normals=None if normals is None else on_device(normals, np.float32, self.device),
        )
        if transform is not None:
            node.transform = np.asarray(transform, np.float32)
        return self.scene.add(node)

    def add_geometry(self, geometry) -> Node:
        """Add an io.Geometry (points/colors/faces/normals)."""
        return self.add(
            geometry.points,
            colors=geometry.colors,
            faces=geometry.faces,
            normals=geometry.normals,
        )

    def toggle_visibility(self, index: int) -> None:
        """Number-key visibility toggles (geoviewer.rs:50-67)."""
        self.scene.nodes[index].visible = not self.scene.nodes[index].visible

    def render_frame(self, azimuth: float = 0.0, elevation: float = 0.0):
        sphere = self.scene.bounding_sphere()
        builder = VirtualCameraSphericalBuilder.fit(sphere, math.pi / 2.0)
        builder.azimuth = azimuth
        builder.elevation = elevation
        builder.aspect_ratio = self.renderer.width / self.renderer.height
        camera = builder.build()
        return self.scene.render(self.renderer, camera)

    def show(self, port: int = 8700) -> None:
        """Interactive window equivalent (geoviewer.rs ``run``): serve the
        scene at http://127.0.0.1:<port>/ with WASD fly, drag orbit and
        number-key visibility toggles."""
        from align3d_torch.viz.interactive import InteractiveViewer

        InteractiveViewer(
            self.scene, self.renderer.width, self.renderer.height, device=self.device
        ).run(port=port)

    def run(self, out_dir, n_frames: int = 8) -> list[str]:
        """Render an orbit of ``n_frames`` PNGs (the headless "event loop")."""
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for k in range(n_frames):
            img = self.render_frame(azimuth=2.0 * math.pi * k / n_frames)
            path = os.path.join(out_dir, f"frame_{k:03d}.png")
            img.save_png(path)
            paths.append(path)
        return paths


class RgbdDatasetViewer:
    """One posed point cloud per dataset frame (rgbd_dataset_viewer.rs:9-57),
    backprojected and masked on ``device``."""

    def __init__(self, dataset, width: int = 640, height: int = 480, device="cuda"):
        self.dataset = dataset
        self.viewer = GeoViewer(width, height, device=device)

    def build_scene(
        self, max_frames: int | None = None, stride: int = 1, trajectory=None
    ) -> Scene:
        """``trajectory`` overrides the dataset's own poses (used by the
        odometry CLI's ``--show`` to render the ESTIMATED trajectory)."""
        from align3d_torch.range_image import RangeImage

        traj = trajectory if trajectory is not None else self.dataset.trajectory()
        n = len(self.dataset)
        if max_frames is not None:
            n = min(n, max_frames * stride)
        for i in range(0, n, stride):
            frame = self.dataset.get(i)
            ri = RangeImage.from_frame(frame, self.viewer.device).with_intensity()
            mask = ri.mask.reshape(-1)
            transform = np.eye(4, dtype=np.float32)
            if traj is not None and i < len(traj):
                transform = traj[i].to_matrix4().to(torch.float32).cpu().numpy()
            self.viewer.add(
                ri.points.reshape(-1, 3)[mask], colors=ri.colors.reshape(-1, 3)[mask], transform=transform
            )
        return self.viewer.scene

    def run(self, out_dir, max_frames: int | None = 8, n_views: int = 4) -> list[str]:
        self.build_scene(max_frames=max_frames)
        return self.viewer.run(out_dir, n_frames=n_views)

    def show(self, max_frames: int | None = 8, port: int = 8700) -> None:
        """Interactive window equivalent (reference
        rgbd_dataset_viewer.rs ``run`` -> Window event loop): serve the
        scene at http://127.0.0.1:<port>/ with WASD/orbit/toggles."""
        from align3d_torch.viz.interactive import InteractiveViewer

        self.build_scene(max_frames=max_frames)
        InteractiveViewer(
            self.viewer.scene,
            self.viewer.renderer.width,
            self.viewer.renderer.height,
            device=self.viewer.device,
        ).run(port=port)
