"""Ownership-transfer schedules — "which execution order" as data.

NOMAD's defining feature is *decentralized ownership transfer*: item
blocks hop between workers, by uniform-random routing (Algorithm 1 line
22) or queue-aware load balancing (§3.3).  The deployable SPMD engine
historically realized exactly one schedule — the bulk-synchronous ring
rotation — while the paper-faithful routing lived only in the
discrete-event simulator, with no shared representation.

:class:`OwnershipSchedule` is that shared representation: a validated
``(n_steps, p)`` table of block locations plus an activity mask.  Its
invariant is the *generalized diagonal* of DESIGN.md §2: every table row
is a permutation of the ``p`` item blocks, so the cells active at any
step touch pairwise-disjoint row shards and pairwise-disjoint item
blocks — the CYCLADES-style conflict-free grouping (Pan et al., 2016)
under which any interleaving of a step's cell update sequences is
exactly serializable.  Coverage requires every ``(worker, block)`` cell
to be active exactly once, so one schedule = one epoch-equivalent: each
rating is applied exactly once, with :meth:`serial_cells` /
``BlockedRatings.schedule_order()`` as the serial witness (the
generalization of ``ring_order()``).

Arbitrary routing is *compiled* into this form: a routing policy emits a
time-ordered list of cell visits, and :func:`compile_visits` greedy-colors
them into conflict-free steps with the same recurrence as
``partition.greedy_wave_color`` — one level up (cells instead of
ratings).  The coloring preserves the relative order of any two
conflicting visits, so the compiled schedule is a faithful conflict-free
linearization of the routing.  Constructors:

* :meth:`OwnershipSchedule.ring`      — the canonical rotation; bitwise-
  preserves the engine's historical behavior.
* :meth:`OwnershipSchedule.random`    — Algorithm 1 line 22: every block
  visits the workers in a uniform-random order.
* :meth:`OwnershipSchedule.balanced`  — §3.3 queue-aware: blocks pick the
  worker with the earliest finish time for their next visit (optionally
  weighted by per-cell rating loads).
* :meth:`OwnershipSchedule.from_sim_log` — compiles an async-simulator
  run (its recorded item visits) into a schedule the real engine
  *replays*, bridging predicted virtual-time behavior and actual device
  execution.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["OwnershipSchedule", "TransitionSchedule", "compile_visits",
           "compile_transition", "greedy_fill",
           "greedy_two_resource_color", "SCHEDULE_NAMES"]

#: schedule specs accepted by ``pack(..., schedule=...)`` / ``NomadConfig``
SCHEDULE_NAMES: Tuple[str, ...] = ("ring", "random", "balanced")


def greedy_two_resource_color(a: np.ndarray, b: np.ndarray,
                              n_a: int, n_b: int) -> np.ndarray:
    """Greedy conflict-free coloring of a sequence of items each
    claiming two resources: item ``t`` (resources ``a[t]``, ``b[t]``)
    lands in color ``max(next[a_t], next[b_t])``.

    The single recurrence behind both conflict-free levels of the repo:
    ``partition.greedy_wave_color`` applies it to ratings (rows x cols,
    DESIGN.md §3) and :func:`compile_visits` to cell visits (workers x
    blocks, §8).  Conflict-free by construction, and order-preserving
    for any two items that share a resource — the property both
    serializability arguments need.  O(len) pure-Python (the recurrence
    is inherently sequential), over Python lists: indexing numpy scalars
    costs ~2.5x as much per item, which at full Netflix (89 M ratings) is
    minutes of ``pack``.
    """
    next_a = [0] * n_a
    next_b = [0] * n_b
    colors = [0] * len(a)
    for t, (x, y) in enumerate(zip(np.asarray(a).tolist(),
                                   np.asarray(b).tolist())):
        c = next_a[x]
        d = next_b[y]
        if d > c:
            c = d
        colors[t] = c
        next_a[x] = next_b[y] = c + 1
    return np.array(colors, dtype=np.int64)


def greedy_fill(load: np.ndarray, weights: np.ndarray, *,
                pad: float = 1.0) -> np.ndarray:
    """Longest-processing-time greedy bin assignment: place items
    heaviest-first, each into the currently-lightest bin, mutating
    ``load`` in place (``load[b] += weights[i] + pad`` on placement) and
    returning the chosen bin per item.

    The single recurrence behind the repo's *sticky* load balancing:
    ``partition.extend_assign`` applies it to new rows/columns joining an
    existing packing, ``runtime.elastic.replan_on_failure`` to a dead
    worker's rows joining the survivors (dead bins pre-loaded with
    ``inf``), and :func:`compile_transition` to both directions of an
    elastic resize.  ``pad`` keeps zero-weight items spreading round-robin
    instead of dogpiling one bin.
    """
    load = np.asarray(load)
    weights = np.asarray(weights)
    # a heap of (load, bin): a numpy argmin and scalar update per item
    # cost ~10 us, which at full Netflix's 2.65 M rows is half a minute
    # of ``pack``.  Its least entry is ``argmin``'s choice (the first
    # lightest bin); each sum is taken in float64 and rounded to
    # ``load``'s dtype, as numpy's in-place add does.
    heap = [(float(x), b) for b, x in enumerate(load.tolist())]
    heapq.heapify(heap)
    w = weights.tolist()
    typ = load.dtype.type
    assign = [0] * len(w)
    for i in np.argsort(-weights, kind="stable").tolist():
        cur, b = heap[0]
        assign[i] = b
        heapq.heapreplace(heap, (float(typ(cur + (w[i] + pad))), b))
    for cur, b in heap:
        load[b] = cur
    return np.array(assign, dtype=np.int64)


def compile_visits(p: int,
                   visits: Sequence[Tuple[int, int]],
                   name: str = "custom") -> "OwnershipSchedule":
    """Compile a time-ordered ``(worker, block)`` visit list — one entry
    per cell, covering all ``p**2`` cells — into an
    :class:`OwnershipSchedule`.

    Active visits are placed by :func:`_color_visits`; between their
    active steps, blocks *park*: a parked block stays on its current
    worker when that worker is idle, otherwise it moves to a free one, so
    every step's row remains a full permutation (each worker buffers
    exactly one block at all times — the layout the engine's ``(p,
    n_local, k)`` nomadic shards require).
    """
    visits = list(visits)
    if len(visits) != p * p:
        raise ValueError(
            f"need exactly one visit per cell ({p * p}), got {len(visits)}")
    workers = np.asarray([q for q, _ in visits], dtype=np.int64)
    blocks = np.asarray([b for _, b in visits], dtype=np.int64)
    steps = greedy_two_resource_color(workers, blocks, p, p)
    n_steps = int(steps.max()) + 1 if len(steps) else 0
    n_steps = max(n_steps, 1)

    active = np.zeros((n_steps, p), dtype=bool)
    want = np.full((n_steps, p), -1, dtype=np.int32)
    for t in range(len(visits)):
        s = steps[t]
        if want[s, workers[t]] >= 0:          # cannot happen post-coloring
            raise AssertionError("coloring produced a worker conflict")
        want[s, workers[t]] = blocks[t]
        active[s, workers[t]] = True

    # park inactive blocks so each row is a full permutation, moving a
    # block only when its worker is claimed by an active visit
    table = np.empty((n_steps, p), dtype=np.int32)
    pos = np.arange(p, dtype=np.int32)        # pos[b] = worker (home start)
    for s in range(n_steps):
        row = want[s].copy()
        taken = set(int(b) for b in row[row >= 0])
        free = [q for q in range(p) if row[q] < 0]
        free_set = set(free)
        homeless = []
        for b in range(p):
            if b in taken:
                continue
            if int(pos[b]) in free_set:
                row[pos[b]] = b
                free_set.discard(int(pos[b]))
            else:
                homeless.append(b)
        for b, q in zip(homeless, sorted(free_set)):
            row[q] = b
        table[s] = row
        pos[row] = np.arange(p, dtype=np.int32)
    return OwnershipSchedule(p=p, table=table, active=active, name=name)


@dataclasses.dataclass(frozen=True, eq=False)
class OwnershipSchedule:
    """A complete, conflict-free ownership-transfer schedule.

    ``table[s, q]``  — the item block worker ``q`` holds during step ``s``
                       (every row is a permutation of ``range(p)``: the
                       generalized diagonal invariant).
    ``active[s, q]`` — whether worker ``q`` applies its held cell's
                       ratings at step ``s`` (inactive = the block is
                       merely parked in the worker's buffer).

    Coverage invariant: each of the ``p**2`` ``(worker, block)`` cells is
    active exactly once, so the schedule is one epoch-equivalent.  Blocks
    start at home (block ``b`` on worker ``b``) *before* step 0 — the
    engine inserts an entry permutation when ``table[0]`` is not the
    identity — and the transition after the last step returns every block
    home, so factors/eval code that assumes home placement at epoch
    boundaries holds for every schedule.
    """
    p: int
    table: np.ndarray
    active: np.ndarray
    name: str = "custom"

    def __post_init__(self):
        p = self.p
        if p < 1:
            raise ValueError(f"p must be >= 1, got {p}")
        # np.array copies, so freezing below never flips a caller-owned
        # array to read-only through an alias
        table = np.array(self.table, dtype=np.int32, order="C")
        if table.ndim != 2 or table.shape[1] != p:
            raise ValueError(
                f"table must have shape (n_steps, {p}), got {table.shape}")
        active = np.array(self.active, dtype=bool, order="C")
        if active.shape != table.shape:
            raise ValueError(
                f"active shape {active.shape} != table shape {table.shape}")
        ident = np.arange(p, dtype=np.int32)
        if not np.array_equal(np.sort(table, axis=1),
                              np.broadcast_to(ident, table.shape)):
            raise ValueError(
                "every table row must be a permutation of range(p) — the "
                "per-step cells must touch pairwise-disjoint row shards "
                "and item blocks (generalized diagonal invariant)")
        cells = (np.repeat(ident[None, :], len(table), axis=0)[active]
                 .astype(np.int64) * p + table[active])
        if len(cells) != p * p or len(np.unique(cells)) != p * p:
            raise ValueError(
                "active cells must cover every (worker, block) pair "
                f"exactly once: got {len(cells)} active visits over "
                f"{len(np.unique(cells))} distinct cells, want {p * p}")
        table.flags.writeable = False
        active.flags.writeable = False
        object.__setattr__(self, "table", table)
        object.__setattr__(self, "active", active)
        # step_of[q, b] = the step at which cell (q, b) is active
        step_of = np.empty((p, p), dtype=np.int64)
        steps = np.repeat(np.arange(len(table), dtype=np.int64)[:, None],
                          p, axis=1)[self.active]
        workers = np.repeat(ident[None, :], len(table), axis=0)[self.active]
        step_of[workers, table[self.active]] = steps
        step_of.flags.writeable = False
        object.__setattr__(self, "_step_of", step_of)

    # ------------------------------------------------------------------ #
    @property
    def n_steps(self) -> int:
        return self.table.shape[0]

    @property
    def step_of(self) -> np.ndarray:
        """(p, p) map: ``step_of[q, b]`` = step at which worker ``q``
        executes block ``b`` — the generalization of the ring's
        ``s = (q - b) mod p`` that ``pack`` lays cells out by."""
        return self._step_of

    def block_at(self, q: int, step: int) -> int:
        """Block held by worker ``q`` at ``step`` (parked or active)."""
        return int(self.table[step, q])

    @property
    def is_ring(self) -> bool:
        """True when this is exactly the canonical ring rotation (the
        engine keeps its historical scan-over-steps + fixed-shift
        collective for it, bitwise-preserving pre-IR behavior)."""
        if self.n_steps != self.p or not self.active.all():
            return False
        q = np.arange(self.p, dtype=np.int64)
        ring = (q[None, :] - np.arange(self.p)[:, None]) % self.p
        return np.array_equal(self.table, ring)

    def serial_cells(self) -> List[Tuple[int, int, int]]:
        """The serial witness at cell granularity: active ``(step,
        worker, block)`` triples in step-major, worker-minor order —
        concatenating the cells' rating sequences in this order is the
        linearization every executor realizes
        (``BlockedRatings.schedule_order()``)."""
        out = []
        for s in range(self.n_steps):
            for q in range(self.p):
                if self.active[s, q]:
                    out.append((s, q, int(self.table[s, q])))
        return out

    # ------------------------------------------------------------------ #
    # Permutation plumbing for the executors                              #
    # ------------------------------------------------------------------ #
    def entry_sources(self) -> Optional[np.ndarray]:
        """Gather indices for the pre-epoch permutation from the home
        placement to ``table[0]`` (``H_new[q] = H_home[src[q]]``), or
        ``None`` when ``table[0]`` is already the identity (ring)."""
        t0 = self.table[0].astype(np.int32)
        if np.array_equal(t0, np.arange(self.p, dtype=np.int32)):
            return None
        return t0.copy()

    def perm_sources(self) -> np.ndarray:
        """(n_steps, p) gather indices for the permutation *after* each
        step: ``H_next[q] = H_cur[src[s, q]]``.  Row ``n_steps - 1``
        returns every block home (block ``b`` to worker ``b``), so an
        epoch always ends in the home placement.  For the ring every row
        is the ``+1`` shift (``src[q] = (q - 1) mod p``) — exactly the
        historical ``jnp.roll(Hs, 1)``."""
        p = self.p
        src = np.empty((self.n_steps, p), dtype=np.int32)
        ident = np.arange(p, dtype=np.int32)
        for s in range(self.n_steps):
            inv = np.empty(p, dtype=np.int32)     # inv[b] = worker holding b
            inv[self.table[s]] = ident
            nxt = self.table[s + 1] if s + 1 < self.n_steps else ident
            src[s] = inv[nxt]
        return src

    def ppermute_pairs(self) -> List[List[Tuple[int, int]]]:
        """``perm_sources`` as ``lax.ppermute`` ``(source, dest)`` pairs,
        one list per step transition."""
        src = self.perm_sources()
        return [[(int(src[s, q]), q) for q in range(self.p)]
                for s in range(self.n_steps)]

    # ------------------------------------------------------------------ #
    # Constructors                                                        #
    # ------------------------------------------------------------------ #
    @classmethod
    def ring(cls, p: int) -> "OwnershipSchedule":
        """The canonical rotation: block ``b`` starts on worker ``b`` and
        moves to ``b + 1 (mod p)`` after every step; ``n_steps == p`` and
        every cell is active (DESIGN.md §2)."""
        q = np.arange(p, dtype=np.int64)
        table = (q[None, :] - q[:, None]) % p
        return cls(p=p, table=table, active=np.ones((p, p), dtype=bool),
                   name="ring")

    @classmethod
    def from_visits(cls, p: int, visits: Sequence[Tuple[int, int]],
                    name: str = "custom") -> "OwnershipSchedule":
        """Compile an arbitrary time-ordered cell-visit list (see
        :func:`compile_visits`)."""
        return compile_visits(p, visits, name=name)

    @classmethod
    def random(cls, p: int, seed: int = 0) -> "OwnershipSchedule":
        """Algorithm 1 line 22 routing, compiled: every block visits the
        ``p`` workers in an independent uniform-random order; visit ``v``
        of each block belongs to virtual round ``v``, with a random
        interleaving of blocks inside a round standing in for the
        asynchronous arrival order.  Conflicting visits are pushed to
        later steps by the coloring, so ``n_steps >= p`` with the excess
        measuring the routing's queueing collisions."""
        rng = np.random.default_rng((int(seed), p, 0x5EED))
        tours = [rng.permutation(p) for _ in range(p)]
        visits = []
        for v in range(p):
            for b in rng.permutation(p):
                visits.append((int(tours[b][v]), int(b)))
        return compile_visits(p, visits, name="random")

    @classmethod
    def balanced(cls, p: int, seed: int = 0,
                 loads: Optional[np.ndarray] = None) -> "OwnershipSchedule":
        """§3.3 queue-aware routing, compiled: blocks repeatedly pick,
        among their not-yet-visited workers, the one with the earliest
        finish time for the visit (ties broken by a seeded shuffle), with
        per-cell durations from ``loads[q, b]`` (e.g. the packed
        ``nnz_cell`` — ``pack(..., schedule='balanced')`` wires that in)
        so heavily-loaded cells spread instead of queueing up on one
        straggling worker."""
        rng = np.random.default_rng((int(seed), p, 0xBA1A))
        if loads is None:
            loads = np.ones((p, p), dtype=np.float64)
        else:
            loads = np.asarray(loads, dtype=np.float64)
            if loads.shape != (p, p):
                raise ValueError(
                    f"loads must have shape ({p}, {p}), got {loads.shape}")
            loads = loads + 1.0                  # zero-load cells still cost
        t_block = np.zeros(p)
        t_worker = np.zeros(p)
        unvisited = [list(range(p)) for _ in range(p)]
        visits = []                              # (start, tie, worker, block)
        for _ in range(p * p):
            b = int(np.argmin(t_block))
            cand = unvisited[b]
            start = np.maximum(t_block[b], t_worker[cand])
            finish = start + loads[cand, b]
            best = np.flatnonzero(finish == finish.min())
            q = cand[int(rng.choice(best))]
            s = max(t_block[b], t_worker[q])
            f = s + loads[q, b]
            visits.append((s, len(visits), q, b))
            t_worker[q] = f
            t_block[b] = f
            cand.remove(q)
            if not cand:
                t_block[b] = np.inf
        visits.sort()
        return compile_visits(p, [(q, b) for _, _, q, b in visits],
                              name="balanced")

    @classmethod
    def topology_aware(cls, p: int, seed: int = 0,
                       loads: Optional[np.ndarray] = None,
                       net=None, *,
                       block_size: float = 1.0) -> "OwnershipSchedule":
        """Locality-aware earliest-finish routing (DESIGN.md §12): like
        :meth:`balanced`, but every candidate hop is priced by a
        :class:`~repro_torch.core.topology.NetworkModel` — the block's next
        visit can only start once the block has physically *arrived*
        from its current worker, so on a hierarchical mesh blocks sweep
        the workers of one node before paying an inter-node hop, instead
        of ping-ponging across the slow links the way topology-blind
        routing does.

        Candidates are priced with :meth:`~repro_torch.core.topology.
        NetworkState.peek` (no occupancy committed) and only the chosen
        hop with :meth:`~repro_torch.core.topology.NetworkState.send`, so link
        contention between blocks is modeled exactly as the simulator
        models it.  ``block_size`` is the transfer size of one block in
        the model's units (size the hops so transfer and compute costs
        are comparable — e.g. ``k * n / p`` when ``loads`` are nnz
        counts and ``a = 1``).  ``net=None`` degrades to free transfers
        (pure earliest-finish, the :meth:`balanced` objective)."""
        rng = np.random.default_rng((int(seed), p, 0x4E70))
        if loads is None:
            loads = np.ones((p, p), dtype=np.float64)
        else:
            loads = np.asarray(loads, dtype=np.float64)
            if loads.shape != (p, p):
                raise ValueError(
                    f"loads must have shape ({p}, {p}), got {loads.shape}")
            loads = loads + 1.0                  # zero-load cells still cost
        if net is None:
            from .topology import UniformTopology
            net = UniformTopology(c=0.0)
        state = net.state()
        t_block = np.zeros(p)
        t_worker = np.zeros(p)
        where = np.arange(p, dtype=np.int64)     # current worker of block b
        unvisited = [list(range(p)) for _ in range(p)]
        visits = []                              # (start, tie, worker, block)
        for _ in range(p * p):
            b = int(np.argmin(t_block))
            cand = unvisited[b]
            src = int(where[b])
            finish = np.empty(len(cand))
            for i, q in enumerate(cand):
                arr = (t_block[b] if q == src
                       else state.peek(src, q, block_size, t_block[b]))
                finish[i] = max(arr, t_worker[q]) + loads[q, b]
            best = np.flatnonzero(finish == finish.min())
            q = cand[int(rng.choice(best))]
            arr = (t_block[b] if q == src
                   else state.send(src, q, block_size, t_block[b]))
            s = max(arr, t_worker[q])
            f = s + loads[q, b]
            visits.append((s, len(visits), q, b))
            t_worker[q] = f
            t_block[b] = f
            where[b] = q
            cand.remove(q)
            if not cand:
                t_block[b] = np.inf
        visits.sort()
        return compile_visits(p, [(q, b) for _, _, q, b in visits],
                              name="topology")

    @classmethod
    def from_sim_log(cls, sim_result, col_block: np.ndarray,
                     p: Optional[int] = None) -> "OwnershipSchedule":
        """Compile a discrete-event simulator run into a replayable
        schedule: cell ``(q, b)`` is visited at the virtual time worker
        ``q`` first started processing any item of block ``b``
        (``SimResult.visit_log``); cells the simulated run never reached
        (short runs, post-failure orphans) are appended afterwards in
        ``(q, b)`` order so the schedule stays a complete
        epoch-equivalent.  Replaying it on the JAX engine executes the
        simulator's observed ownership-transfer order under the engine's
        conflict-free-step semantics — each rating applied exactly once,
        with ``schedule_order()`` as the serial witness."""
        col_block = np.asarray(col_block, dtype=np.int64)
        if p is None:
            p = len(sim_result.busy_time)
        if len(col_block) and (col_block.min() < 0 or col_block.max() >= p):
            raise ValueError(f"col_block values must lie in [0, {p})")
        first = np.full((p, p), np.inf)
        first_seq = np.full((p, p), np.iinfo(np.int64).max, dtype=np.int64)
        for idx, (t, q, j) in enumerate(sim_result.visit_log):
            b = int(col_block[j])
            if t < first[q, b]:
                first[q, b] = t
                first_seq[q, b] = idx
        seen = []
        unseen = []
        for q in range(p):
            for b in range(p):
                if np.isfinite(first[q, b]):
                    seen.append((first[q, b], int(first_seq[q, b]), q, b))
                else:
                    unseen.append((q, b))
        seen.sort()
        visits = [(q, b) for _, _, q, b in seen] + unseen
        return compile_visits(p, visits, name="sim_replay")

    @classmethod
    def resolve(cls, spec: Union[str, "OwnershipSchedule", None], p: int, *,
                seed: int = 0,
                loads: Optional[np.ndarray] = None) -> "OwnershipSchedule":
        """Turn a schedule *spec* (a name from :data:`SCHEDULE_NAMES`, an
        :class:`OwnershipSchedule`, or ``None`` = ring) into a concrete
        schedule for ``p`` workers.  ``loads`` feeds :meth:`balanced`."""
        if spec is None:
            return cls.ring(p)
        if isinstance(spec, OwnershipSchedule):
            if spec.p != p:
                raise ValueError(
                    f"schedule is for p={spec.p}, but p={p} requested")
            return spec
        if isinstance(spec, str):
            if spec == "ring":
                return cls.ring(p)
            if spec == "random":
                return cls.random(p, seed=seed)
            if spec == "balanced":
                return cls.balanced(p, seed=seed, loads=loads)
            raise ValueError(
                f"schedule={spec!r} not in {SCHEDULE_NAMES} (or pass an "
                "OwnershipSchedule)")
        raise TypeError(
            f"cannot resolve {type(spec).__name__} to an OwnershipSchedule")

    # ------------------------------------------------------------------ #
    def __eq__(self, other) -> bool:
        if not isinstance(other, OwnershipSchedule):
            return NotImplemented
        return (self.p == other.p
                and np.array_equal(self.table, other.table)
                and np.array_equal(self.active, other.active))

    def __hash__(self) -> int:
        return hash((self.p, self.table.tobytes(), self.active.tobytes()))

    def __repr__(self) -> str:
        return (f"OwnershipSchedule(name={self.name!r}, p={self.p}, "
                f"n_steps={self.n_steps}, "
                f"active={int(self.active.sum())}/{self.active.size})")


# --------------------------------------------------------------------- #
# Elastic transitions: resize / failure as a compiled migration plan     #
# --------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True, eq=False)
class TransitionSchedule:
    """A compiled worker-set transition: the migration plan that takes a
    packing for ``p_old`` workers to one for ``p_new`` workers when
    workers leave, die, or join between (or within) fused blocks.

    NOMAD's decentralized ownership transfer means a transition costs
    only the migration of the *changed* shards (dead workers' rows and
    blocks, joiners' stolen share) — never a cluster-wide re-shard.  The
    plan is pure data, mirroring :class:`OwnershipSchedule`:

    ``new_of_old[q]``  — new slot of old worker ``q`` (``-1``: left/died).
                         Survivors compact in old-id order, so relative
                         worker order — and hence every surviving shard's
                         content — is preserved.
    ``old_of_new[q]``  — inverse map (``-1``: a fresh joiner's slot).
    ``row_owner``      — post-transition row-shard assignment ``(m,)``
                         in *new* worker ids.
    ``col_block``      — post-transition item-block assignment ``(n,)``.
    ``moved_rows`` / ``moved_cols`` — exactly the indices whose owning
                         worker actually changed; everything else is
                         bitwise-untouched by :func:`~repro_torch.core.partition.
                         repack_transition`.

    :meth:`transfer_steps` colors the per-(source, destination) shard
    moves into conflict-free migration rounds with the same
    :func:`greedy_two_resource_color` recurrence the ownership schedules
    use — each round's transfers touch pairwise-disjoint senders and
    receivers, so any interleaving within a round is exactly
    serializable (the transition-level generalized diagonal).
    """
    p_old: int
    p_new: int
    new_of_old: np.ndarray
    old_of_new: np.ndarray
    row_owner_old: np.ndarray
    col_block_old: np.ndarray
    row_owner: np.ndarray
    col_block: np.ndarray
    moved_rows: np.ndarray
    moved_cols: np.ndarray
    name: str = "transition"

    def __post_init__(self):
        if self.p_old < 1 or self.p_new < 1:
            raise ValueError(
                f"need p_old, p_new >= 1, got {self.p_old}, {self.p_new}")
        arrays = {}
        for field in ("new_of_old", "old_of_new", "row_owner_old",
                      "col_block_old", "row_owner", "col_block",
                      "moved_rows", "moved_cols"):
            a = np.array(getattr(self, field), dtype=np.int64, order="C")
            a.flags.writeable = False
            arrays[field] = a
            object.__setattr__(self, field, a)
        if arrays["new_of_old"].shape != (self.p_old,):
            raise ValueError("new_of_old must have shape (p_old,)")
        if arrays["old_of_new"].shape != (self.p_new,):
            raise ValueError("old_of_new must have shape (p_new,)")
        live = arrays["new_of_old"][arrays["new_of_old"] >= 0]
        if len(np.unique(live)) != len(live) or (
                len(live) and live.max() >= self.p_new):
            raise ValueError("new_of_old must map survivors injectively "
                             "into range(p_new)")
        src = arrays["old_of_new"]
        for q in range(self.p_new):
            if src[q] >= 0 and arrays["new_of_old"][src[q]] != q:
                raise ValueError("old_of_new is not the inverse of "
                                 "new_of_old")
        for field in ("row_owner", "col_block"):
            a = arrays[field]
            if len(a) and (a.min() < 0 or a.max() >= self.p_new):
                raise ValueError(
                    f"{field} values must lie in [0, {self.p_new})")
        if arrays["row_owner_old"].shape != arrays["row_owner"].shape:
            raise ValueError("row_owner_old must align with row_owner")
        if arrays["col_block_old"].shape != arrays["col_block"].shape:
            raise ValueError("col_block_old must align with col_block")

    # ------------------------------------------------------------------ #
    @property
    def survivors(self) -> np.ndarray:
        """Old ids of the workers present on both sides."""
        return np.flatnonzero(self.new_of_old >= 0)

    @property
    def n_moved(self) -> int:
        return len(self.moved_rows) + len(self.moved_cols)

    def is_identity(self) -> bool:
        return (self.p_old == self.p_new and self.n_moved == 0
                and np.array_equal(self.new_of_old,
                                   np.arange(self.p_old)))

    def transfers(self) -> List[Tuple[int, int, str, np.ndarray]]:
        """The shard moves, bundled per edge: ``(src_old, dst_new, kind,
        ids)`` with ``kind`` in ``{"rows", "cols"}``.  ``src_old`` is the
        *old* id of the worker that held the shard (for a dead worker the
        transfer is a recovery — the data comes from the last checkpoint
        rather than the lost peer; for a live one it is a peer-to-peer
        send).  Deterministic order: rows before cols, then (src, dst)."""
        out = []
        for kind, moved, owner_new in (("rows", self.moved_rows,
                                        self.row_owner),
                                       ("cols", self.moved_cols,
                                        self.col_block)):
            if not len(moved):
                continue
            src = np.asarray(self._moved_src(kind), dtype=np.int64)
            dst = owner_new[moved]
            order = np.lexsort((moved, dst, src))
            edges = src[order] * self.p_new + dst[order]
            starts = np.flatnonzero(np.r_[True, np.diff(edges) != 0])
            bounds = np.r_[starts, len(edges)]
            for i, s in enumerate(starts):
                ids = moved[order][s:bounds[i + 1]]
                out.append((int(src[order][s]), int(dst[order][s]), kind,
                            ids))
        return out

    def transfer_steps(self) -> List[List[Tuple[int, int, str, np.ndarray]]]:
        """:meth:`transfers` colored into conflict-free migration rounds:
        within a round no worker sends or receives twice, so transfers in
        a round can run concurrently and any interleaving is exactly
        serializable.  Round count (not shard sizes) is the transition's
        critical-path length."""
        tr = self.transfers()
        if not tr:
            return []
        # a dead source is the checkpoint store, modeled as one extra
        # sender slot per dead worker (recoveries of distinct dead
        # workers do not serialize against each other's peers)
        src = np.asarray([t[0] for t in tr], dtype=np.int64)
        dst = np.asarray([t[1] for t in tr], dtype=np.int64)
        steps = greedy_two_resource_color(src, dst, self.p_old, self.p_new)
        out: List[List[Tuple[int, int, str, np.ndarray]]] = [
            [] for _ in range(int(steps.max()) + 1)]
        for t, s in zip(tr, steps):
            out[s].append(t)
        return out

    # ------------------------------------------------------------------ #
    def _moved_src(self, kind: str) -> np.ndarray:
        if kind == "rows":
            return self.row_owner_old[self.moved_rows]
        return self.col_block_old[self.moved_cols]

    @classmethod
    def identity(cls, p: int, row_owner: np.ndarray,
                 col_block: np.ndarray) -> "TransitionSchedule":
        """The no-op transition (same workers, same assignment): lets a
        pure schedule change — e.g. straggler-adaptive re-routing —
        travel the same relayout path as a resize."""
        ident = np.arange(p, dtype=np.int64)
        row_owner = np.asarray(row_owner, dtype=np.int64)
        col_block = np.asarray(col_block, dtype=np.int64)
        return cls(p_old=p, p_new=p, new_of_old=ident, old_of_new=ident,
                   row_owner_old=row_owner, col_block_old=col_block,
                   row_owner=row_owner, col_block=col_block,
                   moved_rows=np.empty(0, np.int64),
                   moved_cols=np.empty(0, np.int64), name="identity")

    def __repr__(self) -> str:
        return (f"TransitionSchedule(name={self.name!r}, "
                f"p={self.p_old}->{self.p_new}, "
                f"moved_rows={len(self.moved_rows)}, "
                f"moved_cols={len(self.moved_cols)})")


def compile_transition(p: int, row_owner: np.ndarray,
                       col_block: np.ndarray, *,
                       alive: Optional[np.ndarray] = None,
                       join: int = 0,
                       row_weights: Optional[np.ndarray] = None,
                       col_weights: Optional[np.ndarray] = None,
                       spread: str = "balance",
                       name: str = "transition") -> TransitionSchedule:
    """Compile a worker-set change into a :class:`TransitionSchedule`.

    ``alive`` marks which of the ``p`` current workers survive (default
    all); ``join`` appends that many fresh workers.  Survivors keep their
    rows and blocks (compacted into ``0..n_live-1`` in old-id order, so
    shard contents are untouched).

    ``spread`` picks the recovery/rebalance policy for everything that
    *must* or *should* move:

    * ``"balance"`` — dead workers' rows/blocks are placed heaviest-first
      onto the lightest bin via :func:`greedy_fill` (the same sticky
      recurrence as ``partition.extend_assign``), and joiners steal the
      largest items from the heaviest bins until they reach the ideal
      share.  Best post-transition throughput; touches many cells.
    * ``"minimal"`` — the paper's fast-recovery shape: all orphans land
      on the single lightest bin and each joiner steals from the single
      heaviest donor only.  The affected cells stay ``O(p)`` out of
      ``p**2`` (one worker row + one block column per move group), so
      ``partition.repack_transition`` re-colors a ``~1/p`` slice of the
      data instead of all of it — recovery cost scales with the moved
      shard, not total nnz.  Rebalance later with a ``"balance"``
      identity-resize once the cluster is stable.
    """
    if spread not in ("balance", "minimal"):
        raise ValueError(f"spread must be 'balance' or 'minimal', "
                         f"got {spread!r}")
    row_owner = np.asarray(row_owner, dtype=np.int64)
    col_block = np.asarray(col_block, dtype=np.int64)
    if alive is None:
        alive = np.ones(p, dtype=bool)
    alive = np.asarray(alive, dtype=bool)
    if alive.shape != (p,):
        raise ValueError(f"alive must have shape ({p},), got {alive.shape}")
    join = int(join)
    n_live = int(alive.sum())
    p_new = n_live + join
    if p_new < 1:
        raise ValueError("transition would leave zero workers")

    new_of_old = np.full(p, -1, dtype=np.int64)
    new_of_old[alive] = np.arange(n_live, dtype=np.int64)
    old_of_new = np.full(p_new, -1, dtype=np.int64)
    old_of_new[:n_live] = np.flatnonzero(alive)

    def _reassign(owner_old, weights):
        n_items = len(owner_old)
        w = (np.ones(n_items, dtype=np.float64) if weights is None
             else np.asarray(weights, dtype=np.float64))
        if w.shape != (n_items,):
            raise ValueError("weights must align with the assignment")
        owner = np.full(n_items, -1, dtype=np.int64)
        keep = alive[owner_old]
        owner[keep] = new_of_old[owner_old[keep]]
        load = np.zeros(p_new, dtype=np.float64)
        np.add.at(load, owner[keep], w[keep] + 1.0)
        # orphans (dead workers' items) go heaviest-first onto the
        # lightest bin — joiners start empty, so they naturally absorb
        # orphans first (greedy_fill mutates ``load`` in place); in
        # minimal-motion mode they all land on one bin instead
        orphans = np.flatnonzero(~keep)
        if len(orphans):
            if spread == "minimal":
                tgt = int(np.argmin(load))
                owner[orphans] = tgt
                load[tgt] += w[orphans].sum() + len(orphans)
            else:
                owner[orphans] = greedy_fill(load, w[orphans])
        # joiners still under the ideal share steal the largest
        # still-improving item from the heaviest bin (in minimal-motion
        # mode: from one fixed donor per joiner)
        share = load.sum() / p_new
        for q in range(n_live, p_new):
            fixed_donor = int(np.argmax(load)) if spread == "minimal" \
                else None
            while load[q] < share:
                donor = fixed_donor if fixed_donor is not None \
                    else int(np.argmax(load))
                gap = load[donor] - load[q]
                cand = np.flatnonzero(owner == donor)
                fits = cand[w[cand] + 1.0 < gap]
                if donor == q or not len(fits):
                    break
                take = fits[int(np.argmax(w[fits]))]
                owner[take] = q
                load[donor] -= w[take] + 1.0
                load[q] += w[take] + 1.0
        return owner

    row_new = _reassign(row_owner, row_weights)
    col_new = _reassign(col_block, col_weights)
    moved_rows = np.flatnonzero(
        ~alive[row_owner] | (new_of_old[row_owner] != row_new))
    moved_cols = np.flatnonzero(
        ~alive[col_block] | (new_of_old[col_block] != col_new))
    return TransitionSchedule(
        p_old=p, p_new=p_new, new_of_old=new_of_old, old_of_new=old_of_new,
        row_owner_old=row_owner, col_block_old=col_block,
        row_owner=row_new, col_block=col_new, moved_rows=moved_rows,
        moved_cols=moved_cols, name=name)
