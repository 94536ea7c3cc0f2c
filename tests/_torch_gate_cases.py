"""Inputs that put a normal-angle gate exactly on its threshold, for the
gate-boundary tests of the port (tests/test_torch_gates.py on the CPU
against JAX; tests/test_torch_kernels_cuda.py for K1 on the card).

Both ICP gates compare |arccos(dot)| with f32(max_normal_angle). Image ICP
rejects at angle >= threshold, point-cloud ICP at angle > threshold, and
both keep a NaN angle, which a dot product outside [-1, 1] gives. Few
float32 angles are the arccos of a float32, so the threshold is built from
the cosine: ``c`` is the float32 cosine of a nominal angle, and the
threshold is arccos(c) as the implementation under test rounds it (each
test checks that the others land on the same value). Every dot product is
exact: the target normal is (0, 0, 1), so the dot is the other vector's
z component.
"""

import math

import numpy as np

NOMINAL = math.pi / 10  # MsIcpParams.default()'s max_normal_angle
COSINE = np.float32(math.cos(NOMINAL))


def dot_cases(c=COSINE) -> dict:
    """The dot products of the cases: on the threshold, one float32 step
    inside (a larger cosine, a smaller angle), one step outside, and NaN."""
    c = np.float32(c)
    return {"at": c, "inside": np.nextafter(c, np.float32(2)), "outside": np.nextafter(c, np.float32(-2)),
            "nan": np.float32(1.5)}


IMAGE_KEEPS = {"at": False, "inside": True, "outside": False, "nan": True}  # angle >= threshold rejects
PCL_KEEPS = {"at": True, "inside": True, "outside": False, "nan": True}  # angle > threshold rejects

# The image ICP case: a 4 x 4 source with one valid pixel at (0, 0, dot),
# which projects (fx = fy = 2, cx = 2, cy = 1) onto target pixel (v 1, u 2),
# whose point is (0, 0, 1.2) and whose normal is (0, 0, 1). The dot product
# of the gate is then the source point's z.
H, W = 4, 4
INTRINSICS = {"fx": 2.0, "fy": 2.0, "cx": 2.0, "cy": 1.0}
SOURCE_PIXEL, TARGET_PIXEL = 5, 1 * W + 2


def image_inputs(dot) -> dict:
    """numpy arrays of one image ICP step at the identity pose."""
    rng = np.random.default_rng(6)
    src = np.zeros((H * W, 3), np.float32)
    src[SOURCE_PIXEL] = (0.0, 0.0, dot)
    src_mask = np.zeros(H * W, bool)
    src_mask[SOURCE_PIXEL] = True
    tgt = np.zeros((H, W, 3), np.float32)
    tgt.reshape(-1, 3)[TARGET_PIXEL] = (0.0, 0.0, 1.2)
    nrm = np.zeros((H, W, 3), np.float32)
    nrm[..., 2] = 1.0
    tgt_mask = np.zeros((H, W), bool)
    tgt_mask.reshape(-1)[TARGET_PIXEL] = True
    return {"points": src, "mask": src_mask, "intensity": rng.integers(0, 256, H * W).astype(np.uint8),
            "target_points": tgt, "target_normals": nrm, "target_mask": tgt_mask,
            "intensity_map": rng.random((H + 2, W + 2)).astype(np.float32)}
