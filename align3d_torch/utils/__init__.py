"""Utilities: profiling (port of ``align3d_tpu/utils``)."""

from align3d_torch.utils.profiling import StageTimer, trace

__all__ = ["StageTimer", "trace"]
