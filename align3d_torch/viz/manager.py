"""Device/render-context bootstrap (port of ``align3d_tpu/viz/manager.py``)
— the reference ``Manager`` equivalent.

The reference's ``Manager`` (``src/viz/manager.rs:22-99``) owns the Vulkan
instance, picks the physical device and hands queues to every
window/renderer. Here it holds the ``torch.device`` the renderers and
viewers it constructs work on. :meth:`Manager.default` is the card,
``cuda:0``, and raises without CUDA: unlike the JAX package's tpu > gpu >
cpu pick it never falls back to the CPU. A caller that wants the CPU
constructs ``Manager(torch.device("cpu"))``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Manager:
    """Backend bootstrap; construct once, hand to viewers (manager.rs:22-46)."""

    device: torch.device

    @classmethod
    def default(cls) -> "Manager":
        """The first CUDA device (manager.rs ``Default``)."""
        if not torch.cuda.is_available():
            raise RuntimeError("Manager.default(): CUDA is not available "
                               "(construct Manager(torch.device('cpu')) for the CPU path)")
        return cls(device=torch.device("cuda", 0))

    @property
    def device_name(self) -> str:
        return f"{self.device.type}:{self.device.index or 0}"

    def renderer(self, width: int = 640, height: int = 480):
        from align3d_torch.viz.render import OffscreenRenderer

        return OffscreenRenderer(width, height, device=self.device)

    def geo_viewer(self, width: int = 640, height: int = 480):
        from align3d_torch.viz.viewers import GeoViewer

        return GeoViewer(width, height, device=self.device)

    def dataset_viewer(self, dataset, width: int = 640, height: int = 480):
        from align3d_torch.viz.viewers import RgbdDatasetViewer

        return RgbdDatasetViewer(dataset, width, height, device=self.device)
