"""Straggler detection & mitigation policy.

The paper's §3.3 mitigation is *routing*: send nomadic items to short
queues.  At SPMD scale the equivalent knobs are (a) nnz-balanced block
construction (static, core.partition) and (b) detecting persistently slow
hosts and ejecting them (turning a straggler into a failure handled by
runtime.elastic — the standard play at 1000+ nodes, where a 5%-slow host
taxes every bulk-synchronous step).

``StragglerMonitor`` implements the detection policy on per-step,
per-worker timing streams with an EWMA baseline; the discrete-event
simulator provides the timing streams in tests/benchmarks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class StragglerMonitor:
    n_workers: int
    threshold: float = 1.5      # flag when worker EWMA > threshold x median
    decay: float = 0.9
    min_steps: int = 5

    def __post_init__(self):
        self.ewma = np.zeros(self.n_workers)
        self.steps = 0

    def update(self, step_times: np.ndarray) -> List[int]:
        """Feed per-worker durations for one step; returns workers to
        eject (persistently slow).  At most ``(n_workers - 1) // 2``
        workers are ever flagged — ejection turns a straggler into a
        failure, and a monitor must never amputate half the cluster on
        a noisy median (at ``p=2`` the median *is* the mean of both
        workers, so the test can flag a healthy worker; the cap makes
        ejection impossible there)."""
        step_times = np.asarray(step_times, dtype=float)
        if self.steps == 0:
            self.ewma = step_times.copy()
        else:
            self.ewma = self.decay * self.ewma + \
                (1 - self.decay) * step_times
        self.steps += 1
        if self.steps < self.min_steps:
            return []
        med = np.median(self.ewma)
        flagged = np.flatnonzero(self.ewma > self.threshold * med)
        max_eject = (self.n_workers - 1) // 2
        if len(flagged) > max_eject:
            # keep only the very slowest — losing quorum is worse than
            # tolerating a straggler
            worst = flagged[np.argsort(-self.ewma[flagged],
                                       kind="stable")[:max_eject]]
            flagged = np.sort(worst)
        return [int(i) for i in flagged]

    def speed_estimates(self) -> np.ndarray:
        """Relative per-worker speed (median worker = 1.0, a 2x-slow
        straggler = 0.5): the inverse EWMA step time.  This is the live
        signal ``OwnershipSchedule.balanced`` consumes as load weights —
        scale each worker's per-cell nnz by ``1 / speed`` so the
        queue-aware router sends less work through slow workers."""
        if self.steps == 0:
            return np.ones(self.n_workers)
        med = max(float(np.median(self.ewma)), 1e-12)
        return med / np.maximum(self.ewma, 1e-12)

    def utilization_penalty(self, step_times: np.ndarray) -> float:
        """Fraction of compute wasted at a bulk barrier this step (the
        curse of the last reducer, quantified)."""
        return float(1.0 - step_times.mean() / max(step_times.max(), 1e-12))
