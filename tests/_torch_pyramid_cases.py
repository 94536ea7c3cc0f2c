"""Inputs shared by the pyramid's CPU tests and its kernels' tests on the card
(JAX-free: the card's machine has no JAX)."""

import numpy as np


def window_rows(n: int, dst: int) -> np.ndarray:
    """The finer rows (or columns) the 2x2 windows of a ``dst``-long axis read
    from an ``n``-long one: trunc(f32(v) * f32(n / dst)) and the next,
    clamped, as ``ops/resize.py::_window_taps`` and K13 pick them."""
    start = (np.arange(dst, dtype=np.float32) * np.float32(n / dst)).astype(np.int64)
    return np.minimum(np.stack([start, start + 1], axis=-1), n - 1)


def level2_blind_depth(h: int, w: int, value: int = 1500) -> np.ndarray:
    """An (h, w) int32 depth frame whose level 1 has valid pixels but whose
    level 2 has none: valid only on the level-0 rows of a level-1 row that
    no level-2 window reads (odd sizes skip rows)."""
    h1 = h // 2
    read = set(window_rows(h1, h1 // 2).ravel().tolist())
    unread = sorted(set(range(h1)) - read)
    if not unread:
        raise ValueError(f"every level-1 row of a {h}x{w} frame is read by level 2")
    depth = np.zeros((h, w), np.int32)
    depth[window_rows(h, h1)[unread[-1]]] = value
    return depth
