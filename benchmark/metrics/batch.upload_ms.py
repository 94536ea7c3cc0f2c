"""``batch.upload_ms``: host ms a frame in the program's ``batch.upload``
spans (``odometry_step``'s ``frame_inputs`` and ``frame_scales``,
``align3d_torch/utils/profiling.py``) recorded in the profiled slice, over
the ``batch.step`` spans there times the pairs a step aligns. None where
the program records no spans."""


def read(ctx):
    from align3d_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    closed = [s for s in (spans() if spans else []) if s.end is not None]
    steps = sum(1 for s in closed if s.name == "batch.step")
    upload_ns = sum(s.end - s.start for s in closed if s.name == "batch.upload")
    return upload_ns / (steps * ctx.frames_per_unit) / 1e6 if steps else None
