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

    ``engine`` is kept so command lines carry over from the JAX package
    unchanged. On the port every engine name runs the same GN step: the
    fused CUDA kernel on a CUDA tensor (exact association at the projected
    pixel, which the TPU's banded engines approximate inside their band),
    its plain-PyTorch twin on the CPU.
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
    def default_tpu(cls, engine: str = "pallas") -> "MsIcpParams":
        """The defaults with ``engine`` at every level. On the port it
        computes what :meth:`default` computes (see :class:`IcpParams`)."""
        return cls.default().customize(lambda i, p: p.replace(engine=engine))

    def __len__(self) -> int:
        return len(self.pyramid)

    def __getitem__(self, i: int) -> IcpParams:
        return self.pyramid[i]

    def __iter__(self) -> Iterator[IcpParams]:
        return iter(self.pyramid)
