"""The device's idle share over the profiled slice of live steps and the
waits between them: 1 minus the union of its activities' intervals (CUDA
activity only) over the slice's host length, in %."""


def read(ctx):
    trace = ctx.trace or {}
    if not trace.get("window_s") or "busy_s" not in trace:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
