"""``dp.sync_ms``: rank 0's host ms a frame in the sequence path's
``StageTimer`` stage ``gather`` (``odometry_sequence_parallel``'s pose
all-gather, ended by its synchronise): the gather and the wait for the
slowest rank, over the traced run's steps outside the profiled slice,
divided by the pairs a step aligns on all ranks."""


def read(ctx):
    spans = ctx.spans.get("gather")
    return sum(spans) / (len(spans) * ctx.frames_per_unit) * 1e3 if spans else None
