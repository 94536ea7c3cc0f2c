"""RGB-D ICP (port of ``align3d_tpu/icp``, image ICP only)."""
