"""Dataset errors + subset wrapper (port of ``align3d_tpu/io/datasets/core.py``).

A dataset has ``__len__``, ``get(index) -> RgbdFrame`` and
``trajectory() -> Trajectory | None`` (reference trait
``src/io/dataset/core.rs:47-53``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from align3d_torch.image import RgbdFrame
from align3d_torch.trajectory import Trajectory


class DatasetError(Exception):
    pass


class SubsetDataset:
    """Index-remapping wrapper with trajectory re-indexing (core.rs:55-93)."""

    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def get(self, index: int) -> RgbdFrame:
        return self.dataset.get(self.indices[index])

    def trajectory(self) -> Trajectory | None:
        orig = self.dataset.trajectory()
        if orig is None:
            return None
        poses = [orig.camera_to_world[i] for i in self.indices]
        return Trajectory.from_list(poses, np.arange(len(poses), dtype=np.float32))
