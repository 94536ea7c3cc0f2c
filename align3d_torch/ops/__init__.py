"""Tensor operators and the CUDA kernels' wrappers (port of ``align3d_tpu/ops``)."""
