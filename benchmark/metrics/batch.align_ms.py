"""``batch.align_ms``: host ms a frame of ``odometry_step``'s ``StageTimer``
stage ``align`` (ended by its synchronise), over the traced run's steps outside
the profiled slice, divided by the pairs a step aligns."""


def read(ctx):
    spans = ctx.spans.get("align")
    return sum(spans) / (len(spans) * ctx.frames_per_unit) * 1e3 if spans else None
