"""``gn.iter_us.batch``: the mean host length, in us, of the program's
``gn.iter`` spans (``align3d_torch/utils/profiling.py``) recorded in the
profiled slice: the host's cost of putting one Gauss-Newton iteration of
a step's 64 pairs on the card. None where the program records no spans."""


def read(ctx):
    from align3d_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    lengths = [s.end - s.start for s in (spans() if spans else []) if s.name == "gn.iter" and s.end is not None]
    return sum(lengths) / len(lengths) / 1e3 if lengths else None
