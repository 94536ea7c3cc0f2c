"""Host-side I/O (port of ``align3d_tpu/io``): PNG frames, the native frame
loader, dataset loaders, and PLY/OFF geometry."""

from align3d_torch.io.geometry import Geometry
from align3d_torch.io.off import OffError, read_off
from align3d_torch.io.ply import PlyError, read_ply, write_ply

__all__ = ["Geometry", "OffError", "PlyError", "read_off", "read_ply", "write_ply"]
