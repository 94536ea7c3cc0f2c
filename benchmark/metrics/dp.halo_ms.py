"""``dp.halo_ms``: rank 0's host ms a frame in the sequence path's
``StageTimer`` stage ``halo`` (``odometry_sequence_parallel``'s all-gather
of every rank's last frame, ended by its synchronise), over the traced
run's steps outside the profiled slice, divided by the pairs a step aligns
on all ranks."""


def read(ctx):
    spans = ctx.spans.get("halo")
    return sum(spans) / (len(spans) * ctx.frames_per_unit) * 1e3 if spans else None
