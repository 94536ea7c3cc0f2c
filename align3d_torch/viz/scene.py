"""Scene graph (port of ``align3d_tpu/viz/scene.py``; reference
``src/viz/node.rs``, ``src/viz/scene.rs``).

A ``Node`` pairs a geometry (tensors on one device) with a pose (a host
numpy 4x4, camera math) and visibility; a ``Scene`` composes nodes and
their bounding spheres. Rendering walks the nodes and dispatches to the
rasterizer on the renderer's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from align3d_torch.viz.render import OffscreenRenderer, RenderImage, _fma_rows
from align3d_torch.viz.sphere import Sphere3D
from align3d_torch.viz.virtual_camera import VirtualCamera


@dataclasses.dataclass
class Node:
    """Renderable node (node.rs:117-129 properties)."""

    points: torch.Tensor  # (N, 3) f32 world/local
    colors: torch.Tensor | None = None  # (N, 3) u8
    faces: torch.Tensor | None = None  # (F, 3) int64 -> mesh node
    normals: torch.Tensor | None = None
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )
    visible: bool = True
    point_radius_px: int = 1
    # The K5 evaluator of ``faces`` (its corner table on the device), built
    # at the first render without ``normals`` and kept while ``faces`` is
    # the same tensor, unmodified, and the points keep their count and device.
    _normals_of: tuple | None = dataclasses.field(default=None, repr=False, compare=False)
    # The fitted sphere of the world points, kept while ``points`` is the
    # same tensor, unmodified, and ``transform`` holds the same values.
    _sphere_of: tuple | None = dataclasses.field(default=None, repr=False, compare=False)

    def world_points(self) -> torch.Tensor:
        pts = self.points.reshape(-1, 3).to(torch.float32)
        transform = torch.from_numpy(np.asarray(self.transform, np.float32)).to(pts.device)
        # numpy's pts @ R.T + t.
        return _fma_rows(transform[:3, :3].to(torch.float64), pts).T.contiguous() + transform[:3, 3]

    def _sphere_key(self) -> tuple:
        return self.points._version, np.asarray(self.transform, np.float32).tobytes()

    def kept_sphere(self) -> Sphere3D | None:
        """The fitted sphere, if it was fitted to the points and transform
        the node holds now."""
        kept = self._sphere_of
        if kept is None or kept[0] is not self.points or kept[1] != self._sphere_key():
            return None
        return kept[2]

    def keep_sphere(self, sphere: Sphere3D) -> None:
        self._sphere_of = (self.points, self._sphere_key(), sphere)

    def bounding_sphere(self) -> Sphere3D:
        if self.kept_sphere() is None:
            self.keep_sphere(Sphere3D.from_points(self.world_points()))
        return self.kept_sphere()

    def vertex_normals(self, world: torch.Tensor) -> torch.Tensor:
        """The mesh's vertex normals at ``world`` (its world points): the
        given ``normals``, or one K5 launch over the kept corner table."""
        if self.normals is not None:
            return self.normals
        from align3d_torch.ops.mesh import MeshNormals

        key = (self.faces._version, world.shape[0], world.device)
        kept = self._normals_of
        if kept is None or kept[0] is not self.faces or kept[1] != key:
            kept = self._normals_of = (self.faces, key, MeshNormals(self.faces, world.shape[0], device=world.device))
        return kept[2](world)


class Scene:
    """Node list + composed bounding sphere (scene.rs:12-71)."""

    def __init__(self) -> None:
        self.nodes: list[Node] = []

    def add(self, node: Node) -> Node:
        self.nodes.append(node)
        return node

    def bounding_sphere(self) -> Sphere3D:
        """The union of the visible nodes' spheres; the nodes with no kept
        fit are fitted together (on the card: one K6 launch)."""
        visible = [node for node in self.nodes if node.visible]
        stale = [node for node in visible if node.kept_sphere() is None]
        for node, fit in zip(stale, Sphere3D.fit_many([node.world_points() for node in stale])):
            node.keep_sphere(fit)
        sphere = Sphere3D.empty()
        for node in visible:
            sphere = sphere.union(node.kept_sphere())
        return sphere

    def render(
        self,
        renderer: OffscreenRenderer,
        camera: VirtualCamera,
        target: RenderImage | None = None,
    ) -> RenderImage:
        target = target or renderer.new_target()
        for node in self.nodes:
            if not node.visible:
                continue
            pts = node.world_points()
            if node.faces is not None:
                renderer.render_mesh(
                    target, camera, pts, node.faces, normals=node.vertex_normals(pts)
                )
            else:
                renderer.render_points(
                    target,
                    camera,
                    pts,
                    colors=node.colors,
                    radius_px=node.point_radius_px,
                )
        return target
