"""ICP parameter sets (port of ``align3d_tpu/icp/params.py``; reference
``src/icp/icp_params.rs``). The defaults produced the published accuracy and
are kept exactly."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator


@dataclasses.dataclass(frozen=True)
class IcpParams:
    """Per-level knobs (icp_params.rs:8-43).

    ``engine`` picks the GN step, as in the JAX package: ``"xla"`` associates
    exactly at the projected pixel (kernel K1, ``ops/icp_fused.py``);
    ``"pallas"`` and ``"pallas_v4"`` associate inside a predicted band of
    ``2 * band_radius + 1`` candidate rows and two lane groups per 16-row
    chunk and 128-column group, dropping the pixels whose correspondence
    falls outside it (kernels K7 and K8, ``ops/icp_pallas_v3.py`` and
    ``ops/icp_pallas_v4.py``; v4 also rounds normals and its reduction stack
    to bf16). Each runs its CUDA kernel on a CUDA tensor and its plain
    PyTorch twin on a CPU tensor.
    """

    max_iterations: int = 15
    weight: float = 1.0
    color_weight: float = 0.1
    max_point_to_plane_distance: float = 0.1
    max_distance: float = 0.5
    max_normal_angle: float = math.radians(18.0)
    max_color_distance: float = 0.25
    huber_delta: float | None = None  # Huber IRLS weighting; off by default
    engine: str = "xla"
    # Banded engines only: the candidate-row radius around the predicted row.
    band_radius: int = 1

    def replace(self, **kw) -> "IcpParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class MsIcpParams:
    """Per-pyramid-level parameter list, fine -> coarse (icp_params.rs:59-134)."""

    pyramid: tuple[IcpParams, ...]

    @classmethod
    def repeat(cls, levels: int, params: IcpParams) -> "MsIcpParams":
        return cls(tuple(params for _ in range(levels)))

    def customize(self, fn: Callable[[int, IcpParams], IcpParams]) -> "MsIcpParams":
        return MsIcpParams(tuple(fn(i, p) for i, p in enumerate(self.pyramid)))

    @classmethod
    def default(cls) -> "MsIcpParams":
        """3 levels; weight 1.0, color_weight 1.0, max_normal_angle pi/10,
        max_color_distance 2.75, max_distance 0.5; iterations 20/20/30
        fine -> coarse (icp_params.rs:112-134)."""
        base = IcpParams(
            weight=1.0,
            color_weight=1.0,
            max_normal_angle=math.pi / 10.0,
            max_color_distance=2.75,
            max_distance=0.5,
        )
        iters = {0: 20, 1: 20, 2: 30}
        return cls.repeat(3, base).customize(
            lambda i, p: p.replace(max_iterations=iters.get(i, p.max_iterations))
        )

    @classmethod
    def default_tpu(cls, engine: str = "pallas", coarse_exact: bool = False) -> "MsIcpParams":
        """The defaults with a banded engine (``"pallas"`` or ``"pallas_v4"``)
        at every level. The coarsest level takes the bulk inter-frame motion,
        so its band radius is 2; the finer levels keep 1. A banded level
        drops correspondences beyond its band, so for fast motion
        ``coarse_exact=True`` keeps the exact engine (``"xla"``) at the
        coarsest level and the banded one on the finer levels."""
        base = cls.default()
        n = len(base)
        return base.customize(
            lambda i, p: p.replace(
                engine="xla" if (coarse_exact and i == n - 1) else engine,
                band_radius=2 if i == n - 1 else 1,
            )
        )

    def __len__(self) -> int:
        return len(self.pyramid)

    def __getitem__(self, i: int) -> IcpParams:
        return self.pyramid[i]

    def __iter__(self) -> Iterator[IcpParams]:
        return iter(self.pyramid)
