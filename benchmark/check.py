"""The numbers that decide ``correct``: what the timed path produced against
the reference, each a worst case over the sample, each held to its cell's
limit (``cells/<cell>.json``)."""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

#: The numbers, in the order they are printed.
NAMES = ("depth_maxabs", "points_maxabs_m", "normals_maxabs", "intensity_maxabs", "pose_rot_rad", "pose_trans_m",
         "traj_maxabs")


class Numbers:
    """Running worst cases of the compared quantities."""

    def __init__(self):
        self.values = {name: 0.0 for name in NAMES}
        self.pairs: list[tuple[int, float, float]] = []  # (pair, angle, distance) of the last poses compared

    def worst(self, name: str, value: float) -> None:
        if math.isnan(value):
            value = math.inf
        self.values[name] = max(self.values[name], float(value))

    def maxabs(self, name: str, program: torch.Tensor, reference: torch.Tensor) -> None:
        """The largest |program - reference|; a NaN on one side only is
        infinite, NaN on both sides agrees."""
        a = program.to(reference.device, torch.float64)
        b = reference.to(torch.float64)
        if a.shape != b.shape:
            self.worst(name, math.inf)
            return
        both = torch.isnan(a) & torch.isnan(b)
        d = torch.where(both, 0.0, torch.abs(a - b))
        self.worst(name, float(torch.nan_to_num(d, nan=math.inf).max()) if d.numel() else 0.0)

    def pose(self, program: tuple, reference: tuple) -> None:
        """Relative poses (R (B, 3, 3), t (B, 3)): the largest rotation angle
        between the two and the largest translation distance."""
        rp, tp = (x.to(torch.float64).cpu() for x in program)
        rr, tr = (x.to(torch.float64).cpu() for x in reference)
        # The angle of R_p R_r^T from its chordal distance, accurate near 0.
        chord = torch.linalg.norm((rp - rr).reshape(rp.shape[0], -1), dim=-1)
        angle = 2.0 * torch.asin(torch.clamp(chord / (2.0 * math.sqrt(2.0)), max=1.0))
        dist = torch.linalg.norm(tp - tr, dim=-1)
        self.pairs = [(i, float(a), float(d)) for i, (a, d) in enumerate(zip(angle.tolist(), dist.tolist()))]
        self.worst("pose_rot_rad", float(torch.nan_to_num(angle, nan=math.inf).max()))
        self.worst("pose_trans_m", float(torch.nan_to_num(dist, nan=math.inf).max()))


def compose64(a: tuple, b: tuple) -> tuple[np.ndarray, np.ndarray]:
    """``a @ b`` of (R, t) poses in float64 numpy."""
    return a[0] @ b[0], np.einsum("...ij,...j->...i", a[0], b[1]) + a[1]


def chain_gap(relative: tuple, absolute: tuple, start: tuple) -> float:
    """How far each absolute pose P_k lies from rel_k @ P_(k-1) composed in
    float64 from the program's own relative poses (P_-1 = ``start``): the
    largest entry of the difference, over R and t. ``relative`` and
    ``absolute`` are (R (N, 3, 3), t (N, 3)) host arrays."""
    rel_r, rel_t = (np.asarray(x, np.float64) for x in relative)
    abs_r, abs_t = (np.asarray(x, np.float64) for x in absolute)
    prev_r = np.concatenate([np.asarray(start[0], np.float64)[None], abs_r[:-1]])
    prev_t = np.concatenate([np.asarray(start[1], np.float64)[None], abs_t[:-1]])
    want_r, want_t = compose64((rel_r, rel_t), (prev_r, prev_t))
    gap = max(np.abs(abs_r - want_r).max(initial=0.0), np.abs(abs_t - want_t).max(initial=0.0))
    return math.inf if not np.isfinite(gap) else float(gap)


def scan_gap(relative: tuple, absolute: tuple) -> float:
    """The batched path's scan: P_0 = identity, P_i = rel_i @ ... @ rel_1,
    each P_i held to rel_i @ P_(i-1) of the program's own poses."""
    abs_r, abs_t = (np.asarray(x, np.float64) for x in absolute)
    start_gap = max(np.abs(abs_r[0] - np.eye(3)).max(), np.abs(abs_t[0]).max())
    return max(float(start_gap), chain_gap(relative, (abs_r[1:], abs_t[1:]), (abs_r[0], abs_t[0])))


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(all within their limits, {name: {"value", "limit"}}); a number
    without a limit fails."""
    checks, ok = {}, True
    for name in NAMES:
        value, limit = values[name], limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not value <= limit:
            ok = False
    return ok, checks


def print_checks(checks: dict) -> None:
    """Each number beside its limit, as the last lines on standard error."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()


def compare(numbers: Numbers, program: dict, reference: dict) -> None:
    """Hold one sampled unit's outputs (filtered depth, each pyramid level's
    points, normals and intensity map, the pairs' relative poses) to the
    reference's."""
    numbers.maxabs("depth_maxabs", program["depth"], reference["depth"])
    for lp, lr in zip(program["pyramid"], reference["pyramid"], strict=True):
        numbers.maxabs("points_maxabs_m", lp["points"], lr["points"])
        numbers.maxabs("normals_maxabs", lp["normals"], lr["normals"])
        numbers.maxabs("intensity_maxabs", lp["intensity_map"], lr["intensity_map"])
    numbers.pose(program["rel"], reference["rel"])
