"""The plain reference of the benchmark: plain PyTorch, no kernel, no cache,
no batching trick, written from the published semantics (the Rust
``align3d``'s ``bilateral/``, ``range_image/`` and ``icp/``) after the
port's plain twins, and never importing the port.

Every function takes a :class:`Precision`. ``Precision()`` computes as the
configurations state (float32; the 6x6 solve in float64).
``Precision(lowp=True)`` is the correctness control: the same code with each
float32 stage's result rounded to bfloat16 and the solve in float32, the
step down that a later change might be tempted to take.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    lowp: bool = False

    def round(self, x: torch.Tensor) -> torch.Tensor:
        """A float32 stage's result as stored: itself, or rounded to bf16."""
        return x.to(torch.bfloat16).to(torch.float32) if self.lowp else x

    @property
    def solve(self) -> torch.dtype:
        return torch.float32 if self.lowp else torch.float64


FULL = Precision()
CONTROL = Precision(lowp=True)
