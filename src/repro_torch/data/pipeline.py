"""Deterministic, resumable rating streams.

:class:`RatingArrivalStream` — the streaming matrix-completion workload:
an initial rating snapshot plus a replayable script of arrival batches
(new ratings, and optionally new users/items per batch), all drawn from
one fixed ground-truth factor pair so the stream stays a coherent
low-rank problem as it grows.  Batch ``t`` is a pure function of
``(seed, t)``, so resume-after-failure recomputes instead of
checkpointing pipeline state.  Feeds
``repro_torch.api.StreamingSession`` / ``partial_fit``; numpy only, the
JAX package's draws bit for bit.  (That module's ``TokenPipeline`` and
``lm_input_specs`` are ROADMAP.md Queue 1 item 17.)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class RatingArrivalStream:
    """Replayable arrival script for streaming matrix completion.

    A fixed ground-truth factor pair at the *final* dimensions
    ``(m0 + batches * m_growth, n0 + batches * n_growth)`` is drawn once
    from ``seed``; the initial snapshot and every arrival batch sample
    ratings from it (with observation noise), restricted to the rows and
    columns that exist at that point of the stream.  ``batch_at(t)`` is a
    pure function of ``(seed, t)`` — replaying the stream, or resuming it
    mid-way, regenerates identical batches.

        >>> stream = RatingArrivalStream(m0=500, n0=200, nnz0=20_000)
        >>> sess = api.StreamingSession(stream.initial_problem(), cfg)
        >>> sess.fit()
        >>> for batch in stream:
        ...     sess.arrive(**batch)
    """
    m0: int
    n0: int
    nnz0: int                  # ratings in the initial snapshot
    batches: int = 8           # arrival batches after the snapshot
    nnz_batch: int = 2000      # new ratings per batch
    m_growth: int = 0          # new users per batch
    n_growth: int = 0          # new items per batch
    k: int = 16
    seed: int = 0
    noise: float = 0.05
    test_frac: float = 0.1     # held-out fraction drawn alongside each batch

    def __post_init__(self):
        if self.m0 < 1 or self.n0 < 1 or self.nnz0 < 1:
            raise ValueError("m0, n0 and nnz0 must be >= 1")
        if min(self.batches, self.nnz_batch, self.m_growth,
               self.n_growth) < 0:
            raise ValueError("batches/nnz_batch/m_growth/n_growth "
                             "must be >= 0")
        self._truth_cache = None

    # -------------------------------------------------------------- #
    @property
    def m_final(self) -> int:
        return self.m0 + self.batches * self.m_growth

    @property
    def n_final(self) -> int:
        return self.n0 + self.batches * self.n_growth

    def dims_at(self, t: int):
        """(m, n) after batch ``t`` has arrived (t = -1: the snapshot)."""
        return (self.m0 + (t + 1) * self.m_growth,
                self.n0 + (t + 1) * self.n_growth)

    def _truth(self):
        if self._truth_cache is None:
            rng = np.random.default_rng((self.seed, 0x57EA))
            scale = 1.0 / np.sqrt(self.k)
            self._truth_cache = (
                rng.standard_normal((self.m_final, self.k)) * scale,
                rng.standard_normal((self.n_final, self.k)) * scale)
        return self._truth_cache

    def _draw(self, rng, count: int, m_hi: int, n_hi: int):
        Wt, Ht = self._truth()
        rows = rng.integers(0, m_hi, count)
        cols = rng.integers(0, n_hi, count)
        vals = (np.sum(Wt[rows] * Ht[cols], axis=-1)
                + self.noise * rng.standard_normal(count))
        return rows, cols, vals

    # -------------------------------------------------------------- #
    def initial_problem(self):
        """The base :class:`repro_torch.api.MCProblem` (dims ``m0 x n0``)."""
        from ..api import MCProblem
        rng = np.random.default_rng((self.seed, 0x54A7))
        rows, cols, vals = self._draw(rng, self.nnz0, self.m0, self.n0)
        ntest = int(self.nnz0 * self.test_frac)
        test = (self._draw(rng, ntest, self.m0, self.n0)
                if ntest else None)
        return MCProblem(rows=rows, cols=cols, vals=vals, m=self.m0,
                         n=self.n0, test=test)

    def batch_at(self, t: int) -> Dict[str, np.ndarray]:
        """Arrival batch ``t`` (kwargs for ``StreamingSession.arrive`` /
        ``MCProblem.extend``), recomputable from ``(seed, t)`` alone."""
        if not 0 <= t < self.batches:
            raise IndexError(f"batch {t} not in [0, {self.batches})")
        rng = np.random.default_rng((self.seed, t, 0xA221))
        m_hi, n_hi = self.dims_at(t)
        rows, cols, vals = self._draw(rng, self.nnz_batch, m_hi, n_hi)
        out = dict(rows=rows, cols=cols, vals=vals,
                   m_new=self.m_growth, n_new=self.n_growth)
        ntest = int(self.nnz_batch * self.test_frac)
        if ntest:
            out["test"] = self._draw(rng, ntest, m_hi, n_hi)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for t in range(self.batches):
            yield self.batch_at(t)
