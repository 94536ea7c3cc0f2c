"""Host-side I/O (port of ``align3d_tpu/io``: PNG frames and dataset loaders)."""
