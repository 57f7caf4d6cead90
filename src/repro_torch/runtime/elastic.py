"""Elastic scaling & failure recovery control plane.

NOMAD's ownership model makes the matrix-completion engine naturally
elastic: item blocks are *already* mobile, so losing worker q means
(a) its queued nomadic blocks are re-enqueued to survivors and (b) its
row shard is re-assigned — no global re-shard of the other p-1 workers.
``replan_on_failure`` computes the new assignment; the discrete-event
simulator (core.async_sim) executes the same policy in-line, and the SPMD
engine re-packs with the surviving worker count and restores factors from
the last checkpoint.

For the LM stack the policy is the standard one at 1000+ node scale:
shrink the data axis to the surviving multiple of the model-group size,
restore from the latest committed checkpoint (checkpoint/ is atomic), and
continue — the deterministic data pipeline (data/pipeline.py) replays
from the restored step so no batch is skipped or duplicated.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import schedule


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    time: float
    worker: int


@dataclasses.dataclass
class ElasticPlan:
    """Assignment of row shards and nomadic item blocks to live workers."""
    n_workers: int
    alive: np.ndarray                 # (p,) bool
    row_owner: np.ndarray             # (m,) -> worker id
    block_owner: np.ndarray           # (n_blocks,) -> worker id

    def live_workers(self) -> np.ndarray:
        return np.flatnonzero(self.alive)


def initial_plan(p: int, row_owner: np.ndarray, n_blocks: int,
                 seed: int = 0) -> ElasticPlan:
    rng = np.random.default_rng(seed)
    return ElasticPlan(
        n_workers=p, alive=np.ones(p, dtype=bool),
        row_owner=row_owner.copy(),
        block_owner=rng.integers(0, p, n_blocks).astype(np.int64))


def replan_on_failure(plan: ElasticPlan, failed: Sequence[int],
                      row_weights: Optional[np.ndarray] = None,
                      seed: int = 0) -> ElasticPlan:
    """Re-assign the failed workers' rows and nomadic blocks to survivors,
    balancing by row weight (rating counts).  O(moved items), not O(all)."""
    alive = plan.alive.copy()
    for f in failed:
        alive[f] = False
    live = np.flatnonzero(alive)
    if len(live) == 0:
        raise RuntimeError("no survivors")
    rng = np.random.default_rng(seed)

    row_owner = plan.row_owner.copy()
    dead_rows = np.flatnonzero(~alive[row_owner])
    if len(dead_rows):
        w = (row_weights[dead_rows] if row_weights is not None
             else np.ones(len(dead_rows)))
        # current live loads — without weights every row still counts 1,
        # so the greedy fill sees the survivors' true populations instead
        # of an all-zero array (which dogpiles the moved rows onto
        # whichever worker sorts first)
        load = np.bincount(
            row_owner, weights=row_weights,
            minlength=plan.n_workers).astype(np.float64)
        load[~alive] = np.inf
        row_owner[dead_rows] = schedule.greedy_fill(load, w, pad=0.0)

    block_owner = plan.block_owner.copy()
    dead_blocks = np.flatnonzero(~alive[block_owner])
    block_owner[dead_blocks] = rng.choice(live, size=len(dead_blocks))

    return ElasticPlan(n_workers=plan.n_workers, alive=alive,
                       row_owner=row_owner, block_owner=block_owner)


def shrink_data_axis(n_data: int, n_failed_hosts: int,
                     model_size: int) -> int:
    """LM-stack policy: the new data-parallel degree after losing hosts —
    largest value <= (n_data - failed) that keeps the global batch
    divisible (we require only >= 1)."""
    return max(1, n_data - n_failed_hosts)
