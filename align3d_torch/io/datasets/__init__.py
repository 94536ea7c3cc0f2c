"""RGB-D dataset loaders (port of ``align3d_tpu/io/datasets``; reference
``src/io/dataset/``)."""

from align3d_torch.io.datasets.core import DatasetError, RgbdDataset, SubsetDataset
from align3d_torch.io.datasets.indoor_lidar import IndoorLidarDataset
from align3d_torch.io.datasets.slamtb import SlamTbDataset
from align3d_torch.io.datasets.tum import TumRgbdDataset

__all__ = [
    "RgbdDataset",
    "SubsetDataset",
    "DatasetError",
    "SlamTbDataset",
    "TumRgbdDataset",
    "IndoorLidarDataset",
    "load_dataset",
]


def load_dataset(fmt: str, path: str) -> RgbdDataset:
    """Format dispatcher (reference ``examples/src/lib.rs:6``)."""
    if fmt == "ilrgbd":
        return IndoorLidarDataset.load(path)
    if fmt == "tum":
        return TumRgbdDataset.load(path)
    if fmt == "slamtb":
        return SlamTbDataset.load(path)
    raise ValueError(f"Invalid dataset format: {fmt}")
