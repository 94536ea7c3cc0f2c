"""Batching of frame pairs (port of ``align3d_tpu/parallel``), on one device."""
