"""Headless visualization (port of ``align3d_tpu/viz``; counterpart of the
reference ``src/viz``).

The same capabilities as the JAX package — software rendering to PNG/GIF
and an interactive localhost viewer, with the reference's camera math
(virtual camera, spherical fit, perspective frustum) reproduced exactly so
fit-to-scene framing matches — with the geometry, the z-buffers and the
raster as tensors on a device, the card unless the caller asks for the CPU.

Components:
* :mod:`sphere` — bounding spheres (viz/sphere3d.rs)
* :mod:`virtual_camera` — look-at camera + spherical builder + perspective
  projection (viz/virtual_camera.rs, viz/virtual_projection.rs)
* :mod:`render` — z-buffered point-splat and triangle rasterizer on tensors
* :mod:`scene` — node/scene graph (viz/node.rs, viz/scene.rs)
* :mod:`viewers` — GeoViewer / RgbdDatasetViewer equivalents that write
  PNG frames (viz/geoviewer.rs, viz/rgbd_dataset_viewer.rs)
* :mod:`interactive` — the windowed event loop as a localhost web app:
  WASD fly, drag orbit, number-key toggles, quit (viz/window.rs:145-385,
  viz/controllers/virtual_camera_controller.rs:56-98)
* :mod:`manager` — the device the renderers and viewers work on
  (viz/manager.rs:22-99 analog)
"""

from align3d_torch.viz.manager import Manager
from align3d_torch.viz.render import OffscreenRenderer
from align3d_torch.viz.scene import Node, Scene
from align3d_torch.viz.sphere import Sphere3D
from align3d_torch.viz.virtual_camera import (
    PerspectiveProjection,
    VirtualCamera,
    VirtualCameraSphericalBuilder,
)

__all__ = [
    "Manager",
    "Node",
    "OffscreenRenderer",
    "PerspectiveProjection",
    "Scene",
    "Sphere3D",
    "VirtualCamera",
    "VirtualCameraSphericalBuilder",
]
