"""Problem-domain geometry: physical extents, periodicity, cell sizes.

JAX analog of AMReX ``Geometry`` as used by the reference tools
(e.g. /root/reference/Src/grad.cpp:151-159: RealBox + periodicity + coord).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from .box import Box


@dataclasses.dataclass(frozen=True)
class Geometry:
    domain: Box                      # index-space domain at this level
    prob_lo: Tuple[float, ...]
    prob_hi: Tuple[float, ...]
    is_periodic: Tuple[bool, ...]
    coord_sys: int = 0               # 0 = cartesian

    def __post_init__(self):
        object.__setattr__(self, "prob_lo", tuple(float(x) for x in self.prob_lo))
        object.__setattr__(self, "prob_hi", tuple(float(x) for x in self.prob_hi))
        object.__setattr__(self, "is_periodic", tuple(bool(x) for x in self.is_periodic))

    @property
    def ndim(self) -> int:
        return self.domain.ndim

    @property
    def dx(self) -> Tuple[float, ...]:
        return tuple(
            (hi - lo) / n
            for lo, hi, n in zip(self.prob_lo, self.prob_hi, self.domain.shape)
        )

    def cell_center(self, iv: Sequence[int]) -> Tuple[float, ...]:
        dx = self.dx
        return tuple(
            self.prob_lo[d] + (iv[d] - self.domain.lo[d] + 0.5) * dx[d]
            for d in range(self.ndim)
        )

    def refine(self, ratio) -> "Geometry":
        return Geometry(
            self.domain.refine(ratio), self.prob_lo, self.prob_hi, self.is_periodic,
            self.coord_sys,
        )

    def coarsen(self, ratio) -> "Geometry":
        return Geometry(
            self.domain.coarsen(ratio), self.prob_lo, self.prob_hi, self.is_periodic,
            self.coord_sys,
        )

    def cell_volume(self) -> float:
        return float(np.prod(self.dx))
