"""Step-size schedules.

The paper (eq. 11) uses ``s_t = alpha / (1 + beta * t^1.5)`` where ``t`` is
the number of updates already performed on the particular (i, j) pair.
Since every rating is touched exactly once per epoch in NOMAD/DSGD, ``t``
equals the epoch index, which is how we key it.

DSGD/DSGD++ in the paper use the *bold driver* heuristic instead; we provide
it for the baselines.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PowerSchedule:
    """Eq. (11):  s_t = alpha / (1 + beta * t^{1.5})."""
    alpha: float = 0.012
    beta: float = 0.05

    def __call__(self, t) -> float:
        return self.alpha / (1.0 + self.beta * (t ** 1.5))

    def values(self, start: int, count: int) -> np.ndarray:
        """Step sizes for epochs ``start .. start + count - 1`` as one
        float64 array — the whole-run evaluation the fused training
        driver precomputes on the host.

        Each entry is ``self(t)`` for the integer epoch index, evaluated
        exactly as the per-epoch loop path evaluates it, so the fused
        driver's learning-rate array is bitwise-identical to the loop
        path by construction (no re-derivation of the power law in
        vectorized float arithmetic, whose ``pow`` could round
        differently).
        """
        return np.asarray([self(start + i) for i in range(int(count))],
                          dtype=np.float64)


@dataclasses.dataclass
class BoldDriver:
    """Bold-driver schedule used by DSGD [Gemulla et al., 2011].

    Grows the step size by ``grow`` while the objective decreases and
    shrinks it by ``shrink`` when it increases.
    """
    lr: float = 0.012
    grow: float = 1.05
    shrink: float = 0.5
    _last_obj: float = float("inf")

    def update(self, obj: float) -> float:
        if obj <= self._last_obj:
            self.lr *= self.grow
        else:
            self.lr *= self.shrink
        self._last_obj = obj
        return self.lr
