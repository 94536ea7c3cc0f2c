"""Optimization utilities (port of ``align3d_tpu/optim``)."""
