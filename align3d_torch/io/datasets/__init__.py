"""RGB-D dataset loaders (port of ``align3d_tpu/io/datasets``; SlamTb only so far)."""

from align3d_torch.io.datasets.core import DatasetError, SubsetDataset
from align3d_torch.io.datasets.slamtb import SlamTbDataset

__all__ = ["SubsetDataset", "DatasetError", "SlamTbDataset", "load_dataset"]


def load_dataset(fmt: str, path: str):
    """Format dispatcher (reference ``examples/src/lib.rs:6``)."""
    if fmt == "slamtb":
        return SlamTbDataset.load(path)
    if fmt in ("tum", "ilrgbd"):
        raise ValueError(
            f"dataset format {fmt!r} is not ported yet (ROADMAP Queue 1, item 10: "
            "host I/O, checkpoint and CLI); align3d_torch reads slamtb"
        )
    raise ValueError(f"Invalid dataset format: {fmt}")
