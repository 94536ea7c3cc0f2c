"""The reference's whole path for a run of consecutive frames: each frame's
filtered depth and pyramid worked out again from its raw arrays, then the
relative pose of each adjacent pair (frame i as source, frame i - 1 as
target), all on the device given, in blocks of the frames asked for."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import Precision, icp, preprocess


def frame_tensors(fixtures: dict, key: tuple, device) -> tuple:
    """(colour (H, W, 3) u8, depth (H, W) int32, depth scale, (fx, fy, cx, cy))
    of one raw fixture frame on ``device``."""
    fx = fixtures[key[0]]
    color = torch.from_numpy(np.ascontiguousarray(fx.colors[key[1]])).to(device)
    depth = torch.from_numpy(fx.depths[key[1]].astype(np.int32)).to(device)
    return color, depth, fx.depth_scale, tuple(fx.camera[:4])


def outputs(config: dict, fixtures: dict, keys: list, prec: Precision, device) -> dict:
    """{"depth": (F, H, W), "pyramid": [level dicts with a leading F axis],
    "rel": (R (F-1, 3, 3), t (F-1, 3))} of the frames ``keys``."""
    filt = config["bilateral_filter"]
    holes = config["filter_span"] == "holes"
    depths, pyramids = [], []
    for key in keys:
        color, depth, scale, camera = frame_tensors(fixtures, key, device)
        depth = preprocess.bilateral_filter(depth, filt["sigma_space"], filt["sigma_color"], holes, prec)
        depths.append(depth)
        pyramids.append(preprocess.pyramid(color, depth, scale, camera, config["pyramid_levels"],
                                           config["blur_sigma"], prec))
    rel = icp.multiscale_align(pyramids[1:], pyramids[:-1], config["levels"], prec)
    levels = [{k: torch.stack([p[i][k] for p in pyramids]) for k in ("points", "mask", "normals", "intensity_map")}
              for i in range(len(pyramids[0]))]
    return {"depth": torch.stack(depths), "pyramid": levels, "rel": rel}
