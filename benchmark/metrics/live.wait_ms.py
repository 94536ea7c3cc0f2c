"""``live.wait_ms``: the mean wait, in ms, of a tracked frame, from its
arrival to the start of the step that took it, from the program's counter
``align3d_torch.live.counts()`` (over the run: set-up's few steps too).
The driver hands ``LiveOdometry.push`` each window frame's scheduled
arrival on the sensor's clock, so the wait holds the time the frame queued
behind the steps before it. None where the program has no such counter or
tracked nothing."""


def read(ctx):
    try:
        from align3d_torch import live
    except ImportError:
        return None
    counts = getattr(live, "counts", lambda: {})()
    tracked = counts.get("tracked", 0)
    return counts["wait_s"] / tracked * 1e3 if tracked else None
