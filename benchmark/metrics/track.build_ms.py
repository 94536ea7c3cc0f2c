"""``track.build_ms``: host ms a frame of ``RangeImageBuilder.build`` (upload,
filter, pyramid), the harness's span ended by a synchronise, over the
traced run's frames outside the profiled slice."""


def read(ctx):
    spans = ctx.spans.get("build")
    return sum(spans) / len(spans) * 1e3 if spans else None
