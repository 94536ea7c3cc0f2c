"""``live.drop_share``: the frames the live server dropped (a newer frame
of the stream arrived while it waited) over the frames pushed to it, in %,
from the program's counter ``align3d_torch.live.counts()`` (over the run:
set-up's frames too). None where the program has no such counter or
received nothing."""


def read(ctx):
    try:
        from align3d_torch import live
    except ImportError:
        return None
    counts = getattr(live, "counts", lambda: {})()
    arrived = counts.get("arrived", 0)
    return 100.0 * counts["dropped"] / arrived if arrived else None
