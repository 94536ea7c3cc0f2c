"""``icp.wait_ms.track``: host ms a frame in the program's
``icp.level_wait`` spans (``ImageIcp.align``'s read of a level's residual,
``align3d_torch/utils/profiling.py``) recorded in the profiled slice, over
the root ``icp.align`` spans there (one a frame): how far the device trails
the host at each level's end. None where the program records no spans."""


def read(ctx):
    from align3d_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    closed = [s for s in (spans() if spans else []) if s.end is not None]
    aligns = sum(1 for s in closed if s.name == "icp.align" and s.parent < 0)
    wait_ns = sum(s.end - s.start for s in closed if s.name == "icp.level_wait")
    return wait_ns / aligns / 1e6 if aligns else None
