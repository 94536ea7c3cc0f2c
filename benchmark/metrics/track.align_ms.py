"""``track.align_ms``: host ms a frame of ``MultiscaleAlign.align`` (it ends
in the program's own per-level synchronise), over the traced run's frames
outside the profiled slice."""


def read(ctx):
    spans = ctx.spans.get("align")
    return sum(spans) / len(spans) * 1e3 if spans else None
