"""``live.step_ms``: the mean host length, in ms, of the program's
``live.step`` spans (``align3d_torch/live.py``: one ``LiveOdometry.step``,
upload to the poses on the host) recorded in the profiled slice. None
where the program records no such span."""


def read(ctx):
    from align3d_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    lengths = [s.end - s.start for s in (spans() if spans else []) if s.name == "live.step" and s.end is not None]
    return sum(lengths) / len(lengths) / 1e6 if lengths else None
