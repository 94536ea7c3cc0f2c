"""Huber weighting of the port's image ICP helps on outlier-corrupted depth.

sample2 frame 1 <- frame 0 with the port's multiscale align on the CPU (the
plain twin of K1), ground truth from the dataset. 30% of frame 1's 16 x 16
pixel blocks, drawn by a seeded numpy generator, are pushed 3-8 cm farther
(one offset per block, so the blocks stay locally planar: their normals
pass the angle gate and their residuals bias the pose). Measured on this
input: without Huber 8.2e-4 rad / 5.4e-3 m from ground truth, with
``huber_delta`` 0.004 m (the value the port's Huber parity tests use)
3.4e-4 rad / 6.7e-4 m; the clean pair 1.7e-4 rad / 3.5e-4 m. Other seeds
and shares of 25-30% gave the same picture (6-10x lower in translation,
about 2.3x in angle).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
from _torch_cpu import one_thread  # noqa: F401  (the module's one-thread fixture)

from align3d_torch.icp.multiscale import MultiscaleAlign
from align3d_torch.icp.params import MsIcpParams
from align3d_torch.io.datasets import SlamTbDataset
from align3d_torch.metrics import TransformMetrics
from align3d_torch.range_image import RangeImageBuilder

SHARE, BLOCK = 0.3, 16  # share of 16 x 16 blocks made outliers
OFFSET_M = (0.03, 0.08)  # how much farther, per block
HUBER_DELTA = 0.004  # m (tests/test_torch_icp.py's Huber case)


def _corrupt(frame, seed=0):
    rng = np.random.default_rng(seed)
    depth = frame.image.depth.astype(np.float64)
    h, w = depth.shape
    blocks = [(r, c) for r in range(0, h, BLOCK) for c in range(0, w, BLOCK)]
    for i in rng.choice(len(blocks), int(SHARE * len(blocks)), replace=False):
        r, c = blocks[i]
        patch = depth[r:r + BLOCK, c:c + BLOCK]
        patch[patch > 0] += rng.uniform(*OFFSET_M) / frame.image.depth_scale
    image = dataclasses.replace(frame.image, depth=np.clip(depth, 0, 65535).astype(frame.image.depth.dtype))
    return dataclasses.replace(frame, image=image)


@pytest.fixture(scope="module")
def errors():
    """(angle rad, translation m) from ground truth: clean, corrupted without
    Huber, corrupted with Huber."""
    ds = SlamTbDataset.load(str(Path(__file__).resolve().parent / "data" / "rgbd" / "sample2"))
    gt = ds.trajectory().get_relative_transform(1, 0)
    builder = RangeImageBuilder()
    target = builder.build(ds.get(0), "cpu")
    clean, corrupted = builder.build(ds.get(1), "cpu"), builder.build(_corrupt(ds.get(1)), "cpu")
    huber = MsIcpParams.default().customize(lambda i, p: p.replace(huber_delta=HUBER_DELTA))
    out = {}
    for name, params, source in (("clean", MsIcpParams.default(), clean),
                                 ("plain", MsIcpParams.default(), corrupted), ("huber", huber, corrupted)):
        m = TransformMetrics.new(MultiscaleAlign(params, target).align(source), gt)
        out[name] = (float(m.angle), float(m.translation))
    return out


def test_outliers_hurt_without_huber(errors):
    assert errors["plain"][1] > 5 * errors["clean"][1], errors
    assert errors["plain"][0] > 2 * errors["clean"][0], errors


def test_huber_lowers_the_pose_error_on_outliers(errors):
    # Margins: measured 8.1x lower in translation and 2.5x in angle.
    assert errors["huber"][1] < 0.5 * errors["plain"][1], errors
    assert errors["huber"][0] < 0.7 * errors["plain"][0], errors
