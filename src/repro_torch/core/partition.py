"""Partitioning and block packing for NOMAD.

The paper splits users into ``p`` disjoint sets (footnote 1 recommends
balancing by number of ratings, which we implement) and treats item columns
as nomadic.  For the SPMD engine we pre-pack the ratings into a ``p x p``
grid of cells — cell ``(q, b)`` holds the ratings with row-owner ``q`` and
item-block ``b`` — padded to a common ``max_nnz`` so a ``lax.scan`` over
schedule steps can index them.  Fine-grained nnz-balanced construction of
the *item blocks* is the static SPMD equivalent of the paper's dynamic
queue-length load balancing (§3.3): every (worker, block) cell carries
approximately equal work.

Cells are laid out in *execution order* ``[worker, step]`` for an
:class:`~repro_torch.core.schedule.OwnershipSchedule` (DESIGN.md §8): slot
``(q, s)`` holds the cell the schedule activates on worker ``q`` at step
``s`` — for the default ring schedule that is cell ``(q, (q - s) mod p)``,
reproducing the historical ``[worker, ring_step]`` layout bit for bit;
for a general schedule idle slots are empty (all-False mask) and the
step dimension is ``schedule.n_steps >= p``.

Within a cell, ratings are stored in *wave-major* order (see DESIGN.md §3):
a greedy coloring groups the cell's ratings into waves — maximal batches in
which no two ratings share a row or a column — and the sequential arrays
list wave 0's ratings first, then wave 1's, and so on.  Because ratings
inside a wave touch pairwise-disjoint factor vectors, executing a wave as
one vectorized batch is exactly equivalent to executing it sequentially,
so the wave-vectorized kernels and the sequential oracle realize the *same*
serial ordering (``ring_order``).  This is the CYCLADES-style conflict-free
batching (Pan et al., 2016) applied to NOMAD's per-cell update stream.

With ``sub_blocks > 1`` the cell's ratings are additionally pre-partitioned
by item sub-block (sub-block-major, then wave-major within a sub-block) so
the SPMD engine's pipelined permutes touch each rating exactly once.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import pickle
from typing import Optional, Tuple, Union

import numpy as np

from .schedule import (OwnershipSchedule, TransitionSchedule, greedy_fill,
                       greedy_two_resource_color)


def balanced_assign(weights: np.ndarray, p: int) -> np.ndarray:
    """Greedy longest-processing-time assignment of items to ``p`` bins.

    Returns ``assign`` with ``assign[i]`` = bin of item ``i``.  Items with
    larger ``weights`` are placed first into the currently lightest bin,
    giving a 4/3-approximate makespan — ample for load balancing.
    """
    load = np.zeros(p, dtype=np.int64)
    # +1 pad so zero-degree items spread too (schedule.greedy_fill is the
    # shared LPT recurrence — also behind extend_assign and the elastic
    # transition compiler)
    return greedy_fill(load, np.asarray(weights, dtype=np.int64)
                       ).astype(np.int32)


def contiguous_assign(count: int, p: int) -> np.ndarray:
    """Round-robin-free contiguous split (used when determinism across
    engines matters more than balance)."""
    sizes = np.full(p, count // p, dtype=np.int64)
    sizes[: count % p] += 1
    return np.repeat(np.arange(p, dtype=np.int32), sizes)


def extend_assign(assign: np.ndarray, weights: np.ndarray,
                  new_weights: np.ndarray, p: int) -> np.ndarray:
    """Continue :func:`balanced_assign` without disturbing placed items.

    ``assign``/``weights`` describe the items already assigned (pass the
    items' *current* weights, which may have grown since placement, so the
    bin loads new items see are the true ones); ``new_weights`` are the
    appended items, placed heaviest-first into the lightest bin exactly as
    :func:`balanced_assign` would.  The returned array is
    ``concat(assign, new_assign)`` — existing entries are never moved.
    This stickiness is what lets :func:`repack_delta` leave every cell
    that received no new ratings byte-for-byte untouched.
    """
    assign = np.asarray(assign, dtype=np.int32)
    weights = np.asarray(weights, dtype=np.int64)
    new_weights = np.asarray(new_weights, dtype=np.int64)
    load = np.bincount(assign, weights=weights + 1,
                       minlength=p).astype(np.int64)
    return np.concatenate(
        [assign, greedy_fill(load, new_weights).astype(np.int32)])


def extend_assignments(br: "BlockedRatings", ext_rows: np.ndarray,
                       ext_cols: np.ndarray, m: int, n: int):
    """Sticky extended ``(row_owner, col_block)`` for the extended COO:
    existing rows/cols keep ``br``'s bins (weighted by their *extended*
    rating counts), appended ones are placed by :func:`extend_assign`.
    The single source of the stickiness rule — used by both
    :func:`repack_delta` and the from-scratch fallback for pipelined
    (``sub_blocks > 1``) layouts."""
    ext_row_cnt = np.bincount(ext_rows, minlength=m)
    ext_col_cnt = np.bincount(ext_cols, minlength=n)
    row_owner = extend_assign(br.row_owner, ext_row_cnt[: br.m],
                              ext_row_cnt[br.m:], br.p)
    col_block = extend_assign(br.col_block, ext_col_cnt[: br.n],
                              ext_col_cnt[br.n:], br.p)
    return row_owner, col_block


def _validate_assign(assign, count: int, p: int, what: str) -> np.ndarray:
    a = np.asarray(assign, dtype=np.int32)
    if a.shape != (count,):
        raise ValueError(
            f"{what} must have shape ({count},), got {a.shape}")
    if len(a) and (a.min() < 0 or a.max() >= p):
        raise ValueError(f"{what} values must lie in [0, {p})")
    return a


def sub_block_starts(n_local: int, sub_blocks: int) -> np.ndarray:
    """Col boundaries of the item sub-blocks within one H block —
    the single source of truth shared by :func:`pack`, the SPMD engine
    and the dry-run shape model."""
    sb = max(1, n_local // sub_blocks)
    starts = np.minimum(np.arange(sub_blocks + 1) * sb, n_local)
    starts[-1] = n_local
    return starts


def greedy_wave_color(rloc: np.ndarray, cloc: np.ndarray) -> np.ndarray:
    """Assign each rating a *wave* index such that no two ratings in the
    same wave share a row or a column.

    Ratings are processed in the given order; rating ``t`` is placed in
    wave ``max(next_wave[row_t], next_wave[col_t])``, which (a) yields
    conflict-free waves and (b) preserves the relative order of any two
    *conflicting* ratings — the property the serial-equivalence argument
    needs (DESIGN.md §3).  The number of waves equals the length of the
    longest alternating row/col conflict chain, which is at most
    ``max_row_degree + max_col_degree - 1`` and typically close to
    ``max(max_row_degree, max_col_degree)``.

    Cost note: this is an O(nnz) pure-Python loop (the recurrence is
    inherently sequential), ~1 us/rating — negligible below ~10M ratings
    but minutes of one-time pack cost at full Netflix scale.  For short
    runs on huge data either pack with ``waves=False`` (sequential
    impls) or amortize the pack across many epochs / a saved packing.

    The recurrence itself is ``schedule.greedy_two_resource_color`` —
    the same coloring the schedule IR applies one level up, to cell
    visits (workers x blocks).
    """
    if len(rloc) == 0:
        return np.empty(0, dtype=np.int64)
    return greedy_two_resource_color(rloc, cloc, int(rloc.max()) + 1,
                                     int(cloc.max()) + 1)


def pack_cell_waves(
    rloc: np.ndarray,
    cloc: np.ndarray,
    vals: np.ndarray,
    *,
    wave_width: Optional[int] = None,
    n_waves: Optional[int] = None,
    width_multiple: int = 8,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
           np.ndarray]:
    """Wave-pack one cell's ratings into a padded dense layout.

    Returns ``(order, wrows, wcols, wvals, wmask, wgid)`` where ``order``
    is the wave-major permutation of the input ratings (the cell's serial
    ordering) and the ``w*`` arrays have shape ``(n_waves, wave_width)``.
    ``wgid[w, t]`` indexes into the *input* arrays (-1 padding).  Within a
    wave no row or column repeats, so the wave may be applied as one
    vectorized batch with results identical to sequential execution.
    """
    rloc = np.asarray(rloc, dtype=np.int64)
    cloc = np.asarray(cloc, dtype=np.int64)
    wave = greedy_wave_color(rloc, cloc)
    nw_real = int(wave.max()) + 1 if len(wave) else 1
    counts = np.bincount(wave, minlength=nw_real)
    width_real = int(counts.max()) if len(wave) else 1
    if wave_width is None:
        wave_width = -(-width_real // width_multiple) * width_multiple
    if width_real > wave_width:
        raise ValueError(
            f"wave_width={wave_width} < largest wave ({width_real})")
    if n_waves is None:
        n_waves = nw_real
    if nw_real > n_waves:
        raise ValueError(f"n_waves={n_waves} < required waves ({nw_real})")

    order = np.argsort(wave, kind="stable")
    # slot of each rating inside its wave
    slot = np.empty(len(wave), dtype=np.int64)
    off = np.concatenate([[0], np.cumsum(counts)])
    for w in range(nw_real):
        slot[order[off[w]: off[w + 1]]] = np.arange(counts[w])

    wrows = np.zeros((n_waves, wave_width), dtype=np.int32)
    wcols = np.zeros((n_waves, wave_width), dtype=np.int32)
    wvals = np.zeros((n_waves, wave_width), dtype=np.float32)
    wmask = np.zeros((n_waves, wave_width), dtype=bool)
    wgid = np.full((n_waves, wave_width), -1, dtype=np.int64)
    wrows[wave, slot] = rloc
    wcols[wave, slot] = cloc
    wvals[wave, slot] = np.asarray(vals, dtype=np.float32)
    wmask[wave, slot] = True
    wgid[wave, slot] = np.arange(len(wave))
    return order, wrows, wcols, wvals, wmask, wgid


#: the padded wave arrays of a wave packing, in :func:`padded_waves`' order
PADDED_WAVES = ("wave_rows", "wave_cols", "wave_vals", "wave_mask",
                "wave_gid")


class _PaddedWave:
    """A padded wave array of :class:`BlockedRatings`, built with the
    other four from the flat lists and ``wave_cnt`` when first read and
    kept from then on (``None`` for a packing without waves).  It cannot
    be assigned: the flat lists are the one copy of the ratings."""

    def __set_name__(self, owner, name):
        self.index = PADDED_WAVES.index(name)

    def __get__(self, br, owner=None):
        if br is None or br.wave_cnt is None:
            return None
        built = br.__dict__.get("_padded_waves")
        if built is None:
            built = br.__dict__["_padded_waves"] = padded_waves(br)
        return built[self.index]

    def __set__(self, br, value):
        # the dataclass __init__ passes the field default, this object
        if not (value is None or value is self):
            raise AttributeError("the padded wave arrays are built from "
                                 "the flat lists; they cannot be set")


def _padded_field():
    return dataclasses.field(default=_PaddedWave(), repr=False,
                             compare=False)


@dataclasses.dataclass
class BlockedRatings:
    """Ratings packed for the SPMD engine.  All arrays are numpy.

    Cells are laid out in execution order for :attr:`schedule`:
    ``rows/cols/vals/mask[q, s]`` hold the cell worker ``q`` executes at
    step ``s`` — cell ``(q, schedule.table[s, q])`` when
    ``schedule.active[s, q]``, an empty slot otherwise.  The step
    dimension is ``schedule.n_steps``.  For the default ring schedule
    (block ``b`` starts on worker ``b``, moves to ``b+1 (mod p)`` every
    step) this is exactly the historical ``[worker, ring_step]`` layout:
    cell ``(q, (q - s) mod p)`` at slot ``(q, s)``, ``n_steps == p``.
    """
    p: int
    m: int
    n: int
    m_local: int              # padded rows per worker shard
    n_local: int              # padded cols per item block
    max_nnz: int              # padded ratings per cell
    row_owner: np.ndarray     # (m,) -> worker
    row_local: np.ndarray     # (m,) -> local row index
    col_block: np.ndarray     # (n,) -> item block
    col_local: np.ndarray     # (n,) -> local col index
    row_of: np.ndarray        # (p, m_local) -> global row (or -1 pad)
    col_of: np.ndarray        # (p, n_local) -> global col (or -1 pad)
    rows: np.ndarray          # (p, n_steps, max_nnz) int32, local row idx
    cols: np.ndarray          # (p, n_steps, max_nnz) int32, local col idx
    vals: np.ndarray          # (p, n_steps, max_nnz) float32
    mask: np.ndarray          # (p, n_steps, max_nnz) bool
    nnz_cell: np.ndarray      # (p, n_steps) ints, [q, s] = real nnz of cell

    @property
    def n_steps(self) -> int:
        return self.rows.shape[1]

    def block_at(self, q: int, step: int) -> int:
        """Item block held by worker ``q`` at ``step`` (parked or
        active)."""
        if self.schedule is None:
            return (q - step) % self.p
        return self.schedule.block_at(q, step)

    def schedule_order(self) -> np.ndarray:
        """Serial-equivalent update ordering of one epoch — the schedule
        IR's serial witness.

        Returns an int64 array of *global rating ids* (indices into the
        original COO arrays used at pack time) in an order that is an
        exact linearization of the scheduled execution: for each step,
        the per-cell sequences of all active workers are concatenated
        (any interleaving is equivalent — a step's cells touch
        pairwise-disjoint row shards and item blocks, the generalized
        diagonal invariant).
        """
        return np.concatenate(
            [self.gid[q, s, : self.nnz_cell[q, s]]
             for s in range(self.n_steps) for q in range(self.p)]
        )

    def ring_order(self) -> np.ndarray:
        """Alias of :meth:`schedule_order` (the name predates the
        schedule IR; for a ring packing they are the same object)."""
        return self.schedule_order()

    # the OwnershipSchedule the cells are laid out for (set by pack())
    schedule: Optional[OwnershipSchedule] = None

    # filled by pack(); (p, n_steps, max_nnz) global rating ids, -1 pad
    gid: np.ndarray = None

    # --- wave layout (DESIGN.md §3); filled by pack(..., waves=True) ---
    # Cell (q, s)'s ratings regrouped into conflict-free waves: within
    # wave_rows[q, s, w] no local row index repeats, likewise columns.
    # The sequential arrays above are stored wave-major, so executing the
    # waves in order is the SAME serial linearization as rows/cols/....
    # Only wave_cnt is stored: the five padded arrays are built from the
    # flat lists and wave_cnt when first read (padded_waves), since at
    # full Netflix they would be ~10^10 slots, nearly all padding.
    n_waves: int = 0          # padded wave count per cell
    wave_width: int = 0       # padded ratings per wave
    # each (p, n_steps, n_waves, wave_width): int32, int32, f32, bool,
    # int64 (-1 pad)
    wave_rows: np.ndarray = _padded_field()
    wave_cols: np.ndarray = _padded_field()
    wave_vals: np.ndarray = _padded_field()
    wave_mask: np.ndarray = _padded_field()
    wave_gid: np.ndarray = _padded_field()
    wave_cnt: np.ndarray = None    # (p, n_steps, n_waves) real wave sizes

    # --- sub-block pre-partition (SPMD pipelining); sub_blocks > 1 only ---
    # Cell ratings split by item sub-block with cols already localized to
    # the sub-block (c - sub_starts[s]); replaces the seed's masked
    # full-list re-scan per sub-block (which multiplied epoch cost).
    sub_blocks: int = 1
    sub_starts: np.ndarray = None  # (sub_blocks + 1,) col boundaries
    sub_rows: np.ndarray = None    # (p, n_steps, sub_blocks, sub_max) int32
    sub_cols: np.ndarray = None    # (p, n_steps, sub_blocks, sub_max) int32
    sub_vals: np.ndarray = None    # (p, n_steps, sub_blocks, sub_max) f32
    sub_mask: np.ndarray = None    # (p, n_steps, sub_blocks, sub_max) bool
    sub_nnz: np.ndarray = None     # (p, n_steps, sub_blocks) real counts


def padded_waves(br: BlockedRatings, steps: Union[int, slice] = slice(None),
                 waves: slice = slice(None), *,
                 workers: Union[int, slice] = slice(None)
                 ) -> Tuple[np.ndarray, ...]:
    """The padded wave layout of ``br`` — ``(wave_rows, wave_cols,
    wave_vals, wave_mask, wave_gid)`` — or a window of it, built from the
    flat wave-major lists and ``wave_cnt``.

    The result is ``a[workers, steps, waves]`` of each whole-layout array
    ``a`` (shape ``(p, n_steps, n_waves, wave_width)``), byte for byte
    what the JAX package's ``pack`` stores, but only the window is built:
    wave ``w`` of cell ``(q, s)`` is the ``wave_cnt[q, s, w]`` ratings of
    the flat lists after those of its earlier waves, in lanes ``0 ..
    wave_cnt - 1``; the other lanes are padding (0, masked, gid -1)."""
    if br.wave_cnt is None:
        raise ValueError("padded_waves needs a packing with waves=True")
    if not isinstance(waves, slice):
        raise TypeError(f"waves must be a slice, got {type(waves).__name__}")
    cells = br.wave_cnt[workers, steps]
    cnt = cells[..., waves]
    # each wave's first rating in its cell's flat lists
    start = (np.cumsum(cells, axis=-1) - cells)[..., waves]
    mask = np.arange(br.wave_width) < cnt[..., None]
    at = np.nonzero(mask)
    # the (worker, step, position) in the flat lists of each rating
    cell, d = [], 0
    for axis, sel in ((br.p, workers), (br.n_steps, steps)):
        of = np.arange(axis)[sel]
        if np.ndim(of):
            of, d = of[at[d]], d + 1
        cell.append(of)
    cell.append(start[at[:-1]] + at[-1])
    out = []
    for flat, fill in ((br.rows, 0), (br.cols, 0), (br.vals, 0),
                       (br.mask, False), (br.gid, -1)):
        a = np.full(mask.shape, fill, dtype=flat.dtype)
        a[at] = flat[tuple(cell)]
        out.append(a)
    return tuple(out)


def _cell_order(rows: np.ndarray, cols: np.ndarray, cell: np.ndarray,
                m: int, n: int, cells: int) -> np.ndarray:
    """The permutation ``np.lexsort((rows, cols, cell))``: ratings by
    cell, then column, then row, ties in input order.  One stable sort of
    a combined int64 key when ``cells * n * m`` fits (the lexsort's three
    passes are most of a pack without waves), the lexsort otherwise."""
    if int(cells) * int(n) * int(m) >= 2 ** 63:
        return np.lexsort((rows, cols, cell))
    key = (cell.astype(np.int64) * n + cols) * m + rows
    return np.argsort(key, kind="stable")


def _localize(row_owner: np.ndarray, col_block: np.ndarray, m: int, n: int,
              p: int):
    """Local indices + inverse maps for a given assignment.  Within a bin,
    local indices follow ascending global id — so appending new rows/cols
    (whose global ids are larger than every existing one) never renumbers
    an existing row or column, the invariant :func:`repack_delta` relies
    on."""
    m_local = int(np.max(np.bincount(row_owner, minlength=p)))
    n_local = int(np.max(np.bincount(col_block, minlength=p)))
    row_local = np.zeros(m, dtype=np.int64)
    col_local = np.zeros(n, dtype=np.int64)
    row_of = np.full((p, m_local), -1, dtype=np.int64)
    col_of = np.full((p, n_local), -1, dtype=np.int64)
    for q in range(p):
        rws = np.flatnonzero(row_owner == q)
        row_local[rws] = np.arange(len(rws))
        row_of[q, : len(rws)] = rws
        cls = np.flatnonzero(col_block == q)
        col_local[cls] = np.arange(len(cls))
        col_of[q, : len(cls)] = cls
    return m_local, n_local, row_local, col_local, row_of, col_of


#: ratings from which :func:`_order_cells` colors the cells in forked
#: processes, one per CPU (the coloring is a Python loop, ~1 us a rating,
#: and one cell's does not depend on another's)
COLOR_PROCESSES_FROM = 1 << 22

#: a coloring worker's segments, inherited from its parent at the fork
_SEGMENTS: list = []


def _color_init(segs) -> None:
    global _SEGMENTS
    _SEGMENTS = segs


def _color_one(i: int) -> np.ndarray:
    return greedy_wave_color(*_SEGMENTS[i])


def _color_segments(segs) -> list:
    """:func:`greedy_wave_color` of each ``(rloc, cloc)`` of ``segs``: in
    worker processes, one per CPU, from :data:`COLOR_PROCESSES_FROM`
    ratings in all, else here.  The same colors either way.

    The workers are forked although the caller may run threads (torch's,
    a sampler's): they run only this loop and numpy's list conversions,
    take no lock another thread could hold, and return by pipe.  Forked,
    they read the segments in place (at full Netflix 1.4 GB that a spawned
    worker would unpickle, after importing the caller's ``__main__``)."""
    procs = min(len(os.sched_getaffinity(0)), len(segs))
    if procs < 2 or sum(len(r) for r, _ in segs) < COLOR_PROCESSES_FROM:
        return [greedy_wave_color(r, c) for r, c in segs]
    # longest first, so that the last to finish starts early
    order = sorted(range(len(segs)), key=lambda i: -len(segs[i][0]))
    with mp.get_context("fork").Pool(procs, _color_init, (segs,)) as pool:
        done = pool.map(_color_one, order, chunksize=1)
    out = [None] * len(segs)
    for i, w in zip(order, done):
        out[i] = w
    return out


def _order_cells(jobs, *, waves: bool, sub_blocks: int, sb: int) -> list:
    """Order cells' ratings — each job's ``(ids, rloc, cloc)`` already
    (col, row, gid)-sorted — into their final serial sequences:
    sub-block-major, wave-major within a sub-block.  Returns one ``(ids,
    rloc, cloc, wave, sid)`` per job; ``wave`` is ``None`` when waves are
    off.  Shared by :func:`pack`, :func:`repack_delta` and
    :func:`repack_transition` so all emit identical cell sequences by
    construction; the cells' colorings run together
    (:func:`_color_segments`)."""
    cells, segs = [], []
    for ids, rloc, cloc in jobs:
        sid = np.minimum(cloc // sb, sub_blocks - 1)
        if sub_blocks > 1:
            # sub-block-major, preserving (col, row) order within
            sub_sort = np.argsort(sid, kind="stable")
            ids, rloc, cloc, sid = (a[sub_sort]
                                    for a in (ids, rloc, cloc, sid))
        # each sub-block's ratings are now one run of the arrays
        ends = np.searchsorted(sid, np.arange(sub_blocks + 1)).tolist()
        parts = [slice(a, b) for a, b in zip(ends, ends[1:]) if b > a]
        cells.append((ids, rloc, cloc, sid, parts))
        if waves:
            segs.extend((rloc[seg], cloc[seg]) for seg in parts)
    if not waves:
        return [(ids, rloc, cloc, None, sid)
                for ids, rloc, cloc, sid, _ in cells]
    colors = iter(_color_segments(segs))
    out = []
    for ids, rloc, cloc, sid, parts in cells:
        # wave-color each sub-block independently; offset so wave indices
        # are globally ordered sub-block-major
        wave = np.zeros(len(ids), dtype=np.int64)
        off = 0
        for seg in parts:
            wseg = next(colors)
            wave[seg] = wseg + off
            off += int(wseg.max()) + 1
        # serial order inside the cell = wave-major (stable)
        worder = np.argsort(wave, kind="stable")
        out.append(tuple(a[worder] for a in (ids, rloc, cloc, wave, sid)))
    return out


def _empty_cell(waves: bool):
    """The (ids, rloc, cloc, wave, sid) entry of an idle ``[worker, step]``
    slot (a general schedule's parked steps)."""
    e = np.empty(0, dtype=np.int64)
    return e, e, e, (e if waves else None), e


def _fill_layouts(cell_info, vals_f, *, p, m, n, m_local, n_local,
                  row_owner, row_local, col_block, col_local, row_of,
                  col_of, waves, wave_width, sub_blocks,
                  sub_starts, schedule) -> BlockedRatings:
    """Compute padded dims from ordered cell sequences and fill every
    layout.  ``cell_info[q][s] = (ids, rloc, cloc, wave, sid)`` in final
    serial order (from :func:`_order_cells` or copied verbatim from an old
    packing by :func:`repack_delta`), with ``s`` ranging over
    ``schedule.n_steps`` execution steps (idle slots hold empty
    entries)."""
    n_steps = schedule.n_steps
    max_nnz = 1
    n_waves = 1
    max_wave_sz = 1
    sub_max = 1
    for q in range(p):
        for s in range(n_steps):
            ids, rloc, cloc, wave, sid = cell_info[q][s]
            if len(ids) == 0:
                continue
            max_nnz = max(max_nnz, len(ids))
            if waves:
                n_waves = max(n_waves, int(wave.max()) + 1)
                max_wave_sz = max(
                    max_wave_sz, int(np.bincount(wave, minlength=1).max()))
            sub_max = max(sub_max, int(np.bincount(
                sid, minlength=sub_blocks).max()))

    if wave_width is None:
        wave_width = -(-max_wave_sz // 8) * 8   # multiple of 8 (VPU sublane)
    elif wave_width < max_wave_sz:
        raise ValueError(
            f"wave_width={wave_width} < largest wave ({max_wave_sz})")

    R = np.zeros((p, n_steps, max_nnz), dtype=np.int32)
    C = np.zeros((p, n_steps, max_nnz), dtype=np.int32)
    V = np.zeros((p, n_steps, max_nnz), dtype=np.float32)
    M = np.zeros((p, n_steps, max_nnz), dtype=bool)
    G = np.full((p, n_steps, max_nnz), -1, dtype=np.int64)
    nnz_cell = np.zeros((p, n_steps), dtype=np.int64)

    if waves:
        Wcnt = np.zeros((p, n_steps, n_waves), dtype=np.int64)
    if sub_blocks > 1:
        SR = np.zeros((p, n_steps, sub_blocks, sub_max), dtype=np.int32)
        SC = np.zeros((p, n_steps, sub_blocks, sub_max), dtype=np.int32)
        SV = np.zeros((p, n_steps, sub_blocks, sub_max), dtype=np.float32)
        SM = np.zeros((p, n_steps, sub_blocks, sub_max), dtype=bool)
        Snnz = np.zeros((p, n_steps, sub_blocks), dtype=np.int64)

    for q in range(p):
        for s in range(n_steps):
            ids, rloc, cloc, wave, sid = cell_info[q][s]
            cnt = len(ids)
            R[q, s, :cnt] = rloc
            C[q, s, :cnt] = cloc
            V[q, s, :cnt] = vals_f[ids]
            M[q, s, :cnt] = True
            G[q, s, :cnt] = ids
            nnz_cell[q, s] = cnt
            if cnt == 0:
                continue
            if waves:
                # ratings are wave-major: wave w is the next wcnt[w] of
                # the flat lists, which is all padded_waves needs
                Wcnt[q, s] = np.bincount(wave, minlength=n_waves)
            if sub_blocks > 1:
                for sbi in range(sub_blocks):
                    seg = np.flatnonzero(sid == sbi)
                    scnt = len(seg)
                    SR[q, s, sbi, :scnt] = rloc[seg]
                    SC[q, s, sbi, :scnt] = cloc[seg] - sub_starts[sbi]
                    SV[q, s, sbi, :scnt] = vals_f[ids[seg]]
                    SM[q, s, sbi, :scnt] = True
                    Snnz[q, s, sbi] = scnt

    br = BlockedRatings(
        p=p, m=m, n=n, m_local=m_local, n_local=n_local, max_nnz=max_nnz,
        row_owner=row_owner, row_local=row_local,
        col_block=col_block, col_local=col_local,
        row_of=row_of, col_of=col_of,
        rows=R, cols=C, vals=V, mask=M, nnz_cell=nnz_cell,
        schedule=schedule,
    )
    br.gid = G
    if waves:
        br.n_waves = n_waves
        br.wave_width = wave_width
        br.wave_cnt = Wcnt
    br.sub_blocks = sub_blocks
    br.sub_starts = sub_starts
    if sub_blocks > 1:
        br.sub_rows, br.sub_cols = SR, SC
        br.sub_vals, br.sub_mask, br.sub_nnz = SV, SM, Snnz
    return br


def pack(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    m: int,
    n: int,
    p: int,
    balanced: bool = True,
    waves: bool = True,
    wave_width: Optional[int] = None,
    sub_blocks: int = 1,
    row_owner: Optional[np.ndarray] = None,
    col_block: Optional[np.ndarray] = None,
    schedule: Union[str, OwnershipSchedule, None] = None,
    schedule_seed: int = 0,
) -> BlockedRatings:
    """Pack COO ratings into the schedule-ordered block structure.

    ``waves=True`` additionally emits the conflict-free wave layout (and
    stores the sequential arrays wave-major so both executions share one
    serial ordering): ``wave_cnt``, from which :func:`padded_waves`
    builds the padded arrays, whole or a window, when they are read.  ``sub_blocks > 1`` pre-partitions every cell by
    item sub-block for the SPMD pipelined engine; the cell-level order
    becomes sub-block-major with waves colored per sub-block, which is
    exactly the order the pipelined engine executes.

    ``row_owner``/``col_block`` override the computed assignment with an
    explicit worker/block map (values in ``[0, p)``); the streaming layer
    uses this to pin the extended problem to the *sticky* assignment an
    incremental :func:`repack_delta` keeps, which is what makes the
    incremental and from-scratch packings comparable bit for bit.

    ``schedule`` selects the ownership-transfer order the cells are laid
    out for: ``None``/``"ring"`` (the canonical rotation — byte-identical
    to the historical packing), ``"random"`` (Alg. 1 line 22 routing
    compiled to conflict-free steps), ``"balanced"`` (§3.3 queue-aware
    routing, fed the per-cell nnz as load weights), or an explicit
    :class:`~repro_torch.core.schedule.OwnershipSchedule` (e.g. one compiled
    from a simulator run by ``OwnershipSchedule.from_sim_log``).
    ``schedule_seed`` seeds the random/balanced constructors.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals_f = np.asarray(vals, dtype=np.float32)

    row_cnt = np.bincount(rows, minlength=m)
    col_cnt = np.bincount(cols, minlength=n)
    if row_owner is not None:
        row_owner = _validate_assign(row_owner, m, p, "row_owner")
    elif balanced:
        row_owner = balanced_assign(row_cnt, p)
    else:
        row_owner = contiguous_assign(m, p)
    if col_block is not None:
        col_block = _validate_assign(col_block, n, p, "col_block")
    elif balanced:
        col_block = balanced_assign(col_cnt, p)
    else:
        col_block = contiguous_assign(n, p)

    m_local, n_local, row_local, col_local, row_of, col_of = _localize(
        row_owner, col_block, m, n, p)

    if sub_blocks < 1:
        raise ValueError("sub_blocks must be >= 1")
    if sub_blocks > 1 and n_local // sub_blocks == 0:
        raise ValueError(f"sub_blocks={sub_blocks} > n_local={n_local}")
    sub_starts = sub_block_starts(n_local, sub_blocks)
    sb = max(1, n_local // sub_blocks)

    # assign each rating to its cell; sort within cell by (col, row)
    cell_q = row_owner[rows]
    cell_b = col_block[cols]
    cell_id = cell_q.astype(np.int64) * p + cell_b
    order = _cell_order(rows, cols, cell_id, m, n, p * p)
    counts = np.bincount(cell_id[order], minlength=p * p).reshape(p, p)

    # resolve the schedule spec now that per-cell loads are known (the
    # balanced constructor spreads by nnz_cell)
    sched = OwnershipSchedule.resolve(schedule, p, seed=schedule_seed,
                                      loads=counts)

    # ---- pass 1: per cell, order ratings (sub-block-major, wave-major) --
    # cell_info[q][s] = (ids, rloc, cloc, wave, sid) in final serial order
    starts = np.concatenate([[0], np.cumsum(counts.reshape(-1))])
    cell_info = [[_empty_cell(waves)] * sched.n_steps for _ in range(p)]
    slots, jobs = [], []
    for q in range(p):
        for b in range(p):
            lo, hi = starts[q * p + b], starts[q * p + b + 1]
            ids = order[lo:hi]
            # the step at which q executes b
            slots.append((q, int(sched.step_of[q, b])))
            jobs.append((ids, row_local[rows[ids]], col_local[cols[ids]]))
    for (q, s), info in zip(slots, _order_cells(
            jobs, waves=waves, sub_blocks=sub_blocks, sb=sb)):
        cell_info[q][s] = info

    # ---- pass 2: compute padded dims and fill the layouts --------------
    return _fill_layouts(
        cell_info, vals_f, p=p, m=m, n=n, m_local=m_local,
        n_local=n_local, row_owner=row_owner, row_local=row_local,
        col_block=col_block, col_local=col_local, row_of=row_of,
        col_of=col_of, waves=waves, wave_width=wave_width,
        sub_blocks=sub_blocks, sub_starts=sub_starts, schedule=sched)


def repack_delta(
    br: BlockedRatings,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    new_rows: np.ndarray,
    new_cols: np.ndarray,
    new_vals: np.ndarray,
    m: int,
    n: int,
    *,
    wave_width: Optional[int] = None,
) -> BlockedRatings:
    """Incrementally re-pack after ratings / rows / columns arrive.

    ``br`` is the packing of the base problem (``rows/cols/vals`` over
    ``br.m x br.n``); the extended problem appends ``new_*`` (COO indices
    over the extended ``m x n``, with new rows/cols occupying ids
    ``br.m.. m-1`` / ``br.n.. n-1``).  Ownership is *sticky*: existing
    row/col assignments are kept and new ones placed by
    :func:`extend_assign`, so only cells that actually receive new
    ratings are re-sorted and re-wave-colored — the O(nnz_cell) greedy
    coloring runs on the delta's cells only, and every other cell's
    serial sequence is copied from ``br`` verbatim (its local indices
    cannot move because new global ids sort after all existing ones).

    The result is bitwise-identical — same serial linearization
    (``schedule_order``) *and* same padded layouts — to a from-scratch
    ``pack(ext_rows, ext_cols, ext_vals, m, n, p,
    row_owner=out.row_owner, col_block=out.col_block,
    schedule=br.schedule)``: both paths order affected cells with
    :func:`_order_cells` on identical inputs, lay them out at the same
    (sticky) schedule steps, and fill through :func:`_fill_layouts`.
    Property-tested in ``tests/test_streaming.py``.
    """
    if br.sub_blocks != 1:
        raise NotImplementedError(
            "repack_delta requires sub_blocks == 1 (sub-block boundaries "
            "shift when n_local grows, which would reorder every cell); "
            "re-pack from scratch for the pipelined SPMD layout")
    p = br.p
    waves = br.wave_cnt is not None
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    new_rows = np.asarray(new_rows, dtype=np.int64)
    new_cols = np.asarray(new_cols, dtype=np.int64)
    if m < br.m or n < br.n:
        raise ValueError(
            f"extended shape ({m}, {n}) smaller than base "
            f"({br.m}, {br.n})")
    if len(rows) != int(br.mask.sum()):
        raise ValueError(
            f"base COO has {len(rows)} ratings but br was packed from "
            f"{int(br.mask.sum())}")
    if len(new_rows) and (new_rows.min() < 0 or new_rows.max() >= m
                          or new_cols.min() < 0 or new_cols.max() >= n):
        raise ValueError(
            f"new rating indices out of range for extended shape "
            f"({m}, {n})")

    ext_rows = np.concatenate([rows, new_rows])
    ext_cols = np.concatenate([cols, new_cols])
    vals_f = np.concatenate([
        np.asarray(vals, dtype=np.float32),
        np.asarray(new_vals, dtype=np.float32)])

    row_owner, col_block = extend_assignments(br, ext_rows, ext_cols, m, n)
    m_local, n_local, row_local, col_local, row_of, col_of = _localize(
        row_owner, col_block, m, n, p)
    sub_starts = sub_block_starts(n_local, 1)
    sb = max(1, n_local)

    # group the new ratings by cell
    base_nnz = len(rows)
    new_gid = base_nnz + np.arange(len(new_rows), dtype=np.int64)
    new_cell = (row_owner[new_rows].astype(np.int64) * p
                + col_block[new_cols])
    by_cell = {}
    grp = np.argsort(new_cell, kind="stable")
    bounds = np.flatnonzero(np.diff(new_cell[grp])) + 1
    for seg in np.split(grp, bounds):
        if len(seg):
            by_cell[int(new_cell[seg[0]])] = new_gid[seg]

    # the schedule is sticky too: the extended packing executes the same
    # ownership-transfer order as the base (it only depends on p)
    sched = br.schedule or OwnershipSchedule.ring(p)
    cell_info = [[_empty_cell(waves)] * sched.n_steps for _ in range(p)]
    slots, jobs = [], []
    for q in range(p):
        for b in range(p):
            s = int(sched.step_of[q, b])
            cnt = int(br.nnz_cell[q, s])
            old_ids = br.gid[q, s, :cnt]
            fresh = by_cell.get(q * p + b)
            if fresh is None:
                # untouched cell: reuse the stored serial sequence (and
                # its wave coloring) verbatim — this is the saved work
                rloc = br.rows[q, s, :cnt].astype(np.int64)
                cloc = br.cols[q, s, :cnt].astype(np.int64)
                wave = (np.repeat(np.arange(br.n_waves, dtype=np.int64),
                                  br.wave_cnt[q, s]) if waves else None)
                sid = np.zeros(cnt, dtype=np.int64)
                cell_info[q][s] = (old_ids, rloc, cloc, wave, sid)
            else:
                # affected cell: merge into (col, row, gid) order — the
                # exact per-cell order pack()'s global sort yields —
                # then re-color from scratch
                ids = np.concatenate([old_ids, fresh])
                perm = np.lexsort((ids, ext_rows[ids], ext_cols[ids]))
                ids = ids[perm]
                slots.append((q, s))
                jobs.append((ids, row_local[ext_rows[ids]],
                             col_local[ext_cols[ids]]))
    for (q, s), info in zip(slots, _order_cells(jobs, waves=waves,
                                                sub_blocks=1, sb=sb)):
        cell_info[q][s] = info

    return _fill_layouts(
        cell_info, vals_f, p=p, m=m, n=n, m_local=m_local,
        n_local=n_local, row_owner=row_owner, row_local=row_local,
        col_block=col_block, col_local=col_local, row_of=row_of,
        col_of=col_of, waves=waves, wave_width=wave_width, sub_blocks=1,
        sub_starts=sub_starts, schedule=sched)


def repack_transition(
    br: BlockedRatings,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    tr: TransitionSchedule,
    *,
    schedule: Union[str, OwnershipSchedule, None] = None,
    schedule_seed: int = 0,
    wave_width: Optional[int] = None,
) -> BlockedRatings:
    """Re-pack for a new worker set along a compiled
    :class:`~repro_torch.core.schedule.TransitionSchedule` (workers leaving,
    dying, or joining — the rating set is unchanged).

    The transition analogue of :func:`repack_delta`: a cell whose two
    endpoints both survive and that neither gains nor loses a single
    rating keeps its serial sequence *and* wave coloring verbatim —
    only its local indices are relabeled (vectorized; the greedy wave
    coloring depends only on the within-cell equality pattern of the
    labels, which an injective relabel preserves).  The O(nnz_cell)
    Python-loop re-coloring runs only on cells touched by
    ``tr.moved_rows`` / ``tr.moved_cols``, so repack cost scales with
    the migrated data, not the total nnz — NOMAD's decentralized-
    recovery claim at the packing layer.

    ``schedule`` resolves a fresh ownership schedule for ``tr.p_new``
    workers (a name from ``SCHEDULE_NAMES``, an explicit schedule of the
    right ``p``, or ``None`` = keep the base schedule's *name*).  The
    result is bitwise-identical to a from-scratch ``pack(rows, cols,
    vals, m, n, tr.p_new, row_owner=tr.row_owner,
    col_block=tr.col_block, schedule=<same resolved schedule>)`` — both
    order affected cells with :func:`_order_cells` on identical inputs
    and fill through :func:`_fill_layouts`.
    """
    if br.sub_blocks != 1:
        raise NotImplementedError(
            "repack_transition requires sub_blocks == 1 (sub-block "
            "boundaries shift when n_local changes); re-pack from "
            "scratch for the pipelined SPMD layout")
    if tr.p_old != br.p:
        raise ValueError(f"transition is for p_old={tr.p_old}, "
                         f"but the packing has p={br.p}")
    if not (np.array_equal(tr.row_owner_old, br.row_owner)
            and np.array_equal(tr.col_block_old, br.col_block)):
        raise ValueError("transition was compiled against a different "
                         "base assignment than this packing's")
    p_new = tr.p_new
    m, n = br.m, br.n
    waves = br.wave_cnt is not None
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals_f = np.asarray(vals, dtype=np.float32)
    if len(rows) != int(br.mask.sum()):
        raise ValueError(
            f"COO has {len(rows)} ratings but br was packed from "
            f"{int(br.mask.sum())}")

    row_owner = tr.row_owner.astype(np.int32)
    col_block = tr.col_block.astype(np.int32)
    m_local, n_local, row_local, col_local, row_of, col_of = _localize(
        row_owner, col_block, m, n, p_new)
    sub_starts = sub_block_starts(n_local, 1)
    sb = max(1, n_local)

    # which new cells can copy their old counterpart verbatim?  exactly
    # those with a surviving (worker, block) pair that neither gain a
    # moved-in rating nor lose a moved-out one
    row_moved = np.zeros(m, dtype=bool)
    row_moved[tr.moved_rows] = True
    col_moved = np.zeros(n, dtype=bool)
    col_moved[tr.moved_cols] = True
    moved = row_moved[rows] | col_moved[cols]
    q_new = row_owner[rows].astype(np.int64)
    b_new = col_block[cols].astype(np.int64)
    cell_new = q_new * p_new + b_new
    gained = np.bincount(cell_new[moved], minlength=p_new * p_new
                         ).reshape(p_new, p_new)
    cell_old = (br.row_owner[rows].astype(np.int64) * br.p
                + br.col_block[cols])
    lost = np.bincount(cell_old[moved], minlength=br.p * br.p
                       ).reshape(br.p, br.p)
    counts = np.bincount(cell_new, minlength=p_new * p_new
                         ).reshape(p_new, p_new)

    sched = OwnershipSchedule.resolve(
        schedule if schedule is not None
        else (br.schedule.name if br.schedule is not None
              and br.schedule.name in ("ring", "random", "balanced")
              else None),
        p_new, seed=schedule_seed, loads=counts)
    old_sched = br.schedule or OwnershipSchedule.ring(br.p)

    # group the moved ratings' cells for the re-sort path
    affected_order = _cell_order(rows, cols, cell_new, m, n, p_new * p_new)
    affected_cell = cell_new[affected_order]

    cell_info = [[_empty_cell(waves)] * sched.n_steps for _ in range(p_new)]
    slots, jobs = [], []
    for q in range(p_new):
        for b in range(p_new):
            s = int(sched.step_of[q, b])
            qo, bo = int(tr.old_of_new[q]), int(tr.old_of_new[b])
            copyable = (qo >= 0 and bo >= 0 and gained[q, b] == 0
                        and lost[qo, bo] == 0)
            if copyable:
                so = int(old_sched.step_of[qo, bo])
                cnt = int(br.nnz_cell[qo, so])
                ids = br.gid[qo, so, :cnt]
                # the serial sequence and coloring carry over; only the
                # local labels change (injective relabel within the cell)
                wave = (np.repeat(np.arange(br.n_waves, dtype=np.int64),
                                  br.wave_cnt[qo, so]) if waves else None)
                cell_info[q][s] = (ids, row_local[rows[ids]],
                                   col_local[cols[ids]], wave,
                                   np.zeros(cnt, dtype=np.int64))
            else:
                sel = affected_order[np.searchsorted(
                    affected_cell, q * p_new + b):]
                ids = sel[:int(counts[q, b])]
                slots.append((q, s))
                jobs.append((ids, row_local[rows[ids]],
                             col_local[cols[ids]]))
    for (q, s), info in zip(slots, _order_cells(jobs, waves=waves,
                                                sub_blocks=1, sb=sb)):
        cell_info[q][s] = info

    return _fill_layouts(
        cell_info, vals_f, p=p_new, m=m, n=n, m_local=m_local,
        n_local=n_local, row_owner=row_owner, row_local=row_local,
        col_block=col_block, col_local=col_local, row_of=row_of,
        col_of=col_of, waves=waves, wave_width=wave_width, sub_blocks=1,
        sub_starts=sub_starts, schedule=sched)


def epoch_stream(br: BlockedRatings) -> Tuple[np.ndarray, ...]:
    """Flatten one schedule epoch into a dense stream of conflict-free
    ``p``-wide update slots over *globally flat* factor indices — the
    layout the fused local driver scans (DESIGN.md §9).

    The step-scan executor pads every cell to the global ``max_nnz`` /
    ``n_waves``, so its per-epoch trip count is ``n_steps x global_max``
    — and on skewed (Netflix-shaped) data a hot item column puts a
    ~max_nnz-long serial conflict chain in *every* step, making almost
    all of those iterations masked padding.  It also physically moves
    the H blocks between workers (a gather per step) even though on a
    single device "ownership" is just an index range.

    The stream removes both:

    * indices are globalized against the *home* placement —
      ``owner * m_local + row_local`` / ``block * n_local + col_local``
      into the flattened ``(p * m_local, k)`` / ``(p * n_local, k)``
      factor arrays — so no block ever moves and no entry/per-step
      permutation exists at all;
    * slot ``t`` of step ``s`` holds each worker's ``t``-th rating of
      its step-``s`` cell, with per-step trip counts
      ``L_s = max_q nnz_cell(q, s)``: the scan runs
      ``sum_s L_s`` slots, each an up-to-``p``-wide conflict-free batch
      (a step's active cells touch pairwise-disjoint row shards and
      item blocks — the generalized-diagonal invariant — so the batch
      is exactly a sequential execution of its entries).

    Executing slots in order realizes the exact packed serial
    linearization (``schedule_order``): within a cell ratings stay in
    their stored wave-major order, concurrent cells are disjoint, and
    steps complete in sequence.  Masked padding slots are exact no-ops,
    so the stream is bitwise-identical to both the sequential and the
    wave-batched step-scan executors (asserted in tests/test_driver.py).

    Returns ``(rows, cols, vals, mask)`` of shape ``(sum_s L_s, p)``
    with int32 global flat indices.
    """
    p = br.p
    real = br.nnz_cell                                 # (p, n_steps)
    # >= 1 so a fully-idle step still holds one (all-masked) slot
    L = np.maximum(real.max(axis=0), 1).astype(np.int64)
    total = int(L.sum())
    R = np.zeros((total, p), dtype=np.int32)
    C = np.zeros((total, p), dtype=np.int32)
    V = np.zeros((total, p), dtype=np.float32)
    M = np.zeros((total, p), dtype=bool)
    off = 0
    for s in range(br.n_steps):
        ls = int(L[s])
        for q in range(p):
            b = br.block_at(q, s)
            cnt = int(real[q, s])
            R[off:off + cnt, q] = (q * br.m_local
                                   + br.rows[q, s, :cnt])
            C[off:off + cnt, q] = (b * br.n_local
                                   + br.cols[q, s, :cnt])
            V[off:off + cnt, q] = br.vals[q, s, :cnt]
            M[off:off + cnt, q] = br.mask[q, s, :cnt]
        off += ls
    return R, C, V, M


def step_major_cells(arrays) -> Tuple[np.ndarray, ...]:
    """Transpose packed cell arrays from the canonical ``[worker, step,
    ...]`` layout to contiguous ``[step, worker, ...]``.

    The canonical layout is worker-major because the SPMD engine shards
    the leading axis over the device mesh; the local executor instead
    ``lax.scan``s over *steps*, which needs the step axis leading.  The
    seed transposed inside the jitted epoch (``jnp.swapaxes`` per
    dispatch — a real copy of every rating array, every epoch);
    ``NomadRingEngine._load_pack`` now pays this transpose exactly once,
    here, at pack-load time.
    """
    return tuple(np.ascontiguousarray(np.swapaxes(np.asarray(a), 0, 1))
                 for a in arrays)


def save_pack(br: BlockedRatings, path: str, *, ids: bool = False
              ) -> None:
    """Write what the engine reads of ``br`` to the directory ``path``:
    each array as ``<field>.npy`` (worker-major, so one worker's cells
    are one contiguous piece of each file), the sizes and the schedule in
    ``meta.pkl``.  Not written: the padded wave arrays (built from the
    rest when read) and, unless ``ids``, ``gid`` (the ratings' global
    ids, which :meth:`BlockedRatings.schedule_order`,
    :func:`repack_delta` and :func:`repack_transition` read)."""
    os.makedirs(path, exist_ok=True)
    meta = {}
    for f in dataclasses.fields(br):
        if f.name in PADDED_WAVES or (f.name == "gid" and not ids):
            continue
        val = getattr(br, f.name)
        if isinstance(val, np.ndarray):
            np.save(os.path.join(path, f.name + ".npy"), val)
        else:
            meta[f.name] = val
    with open(os.path.join(path, "meta.pkl"), "wb") as fh:
        pickle.dump(meta, fh)


def load_pack(path: str) -> BlockedRatings:
    """The packing :func:`save_pack` wrote to ``path``, its arrays mapped
    read-only (``np.load(mmap_mode="r")``): a process reads only the
    pages it touches, such as one SPMD rank's cells."""
    with open(os.path.join(path, "meta.pkl"), "rb") as fh:
        fields = pickle.load(fh)
    for name in os.listdir(path):
        if name.endswith(".npy"):
            fields[name[:-4]] = np.load(os.path.join(path, name),
                                        mmap_mode="r")
    return BlockedRatings(**fields)


def shard_factors(W: np.ndarray, H: np.ndarray, br: BlockedRatings
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Scatter global (m,k)/(n,k) factors into (p, m_local, k)/(p, n_local, k)
    shard layouts (zero padding rows)."""
    k = W.shape[1]
    Ws = np.zeros((br.p, br.m_local, k), dtype=W.dtype)
    Hs = np.zeros((br.p, br.n_local, k), dtype=H.dtype)
    for q in range(br.p):
        valid = br.row_of[q] >= 0
        Ws[q, : valid.sum()] = W[br.row_of[q][valid]]
        validc = br.col_of[q] >= 0
        Hs[q, : validc.sum()] = H[br.col_of[q][validc]]
    return Ws, Hs


def unshard_factors(Ws: np.ndarray, Hs: np.ndarray, br: BlockedRatings
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`shard_factors`."""
    k = Ws.shape[-1]
    W = np.zeros((br.m, k), dtype=Ws.dtype)
    H = np.zeros((br.n, k), dtype=Hs.dtype)
    for q in range(br.p):
        valid = br.row_of[q] >= 0
        W[br.row_of[q][valid]] = Ws[q, : valid.sum()]
        validc = br.col_of[q] >= 0
        H[br.col_of[q][validc]] = Hs[q, : validc.sum()]
    return W, H
