"""Network topology / communication-cost models (DESIGN.md §12).

The paper's §3.2 cost model prices shipping one nomadic ``(j, h_j)``
pair at a flat ``c * k`` — free of *where* the two workers sit.  Its
§3.3 analysis and the HPC-cluster experiments (§5.2) live on machines
where that is false: intra-node transfers ride a shared-memory or
NVLink-class fabric while inter-node transfers cross a commodity
network an order of magnitude slower, and concurrent transfers contend
for the same links.  This module makes the simulator's network a real
object:

* :class:`UniformTopology` — the pluggable flat fallback.  One hop
  costs ``c * size`` with no contention; with ``size = k`` this is
  bit-for-bit the historical ``c * k`` (same floats, same
  multiplication), so ``SimConfig(topology=UniformTopology(c))`` and
  ``topology=None`` are interchangeable.
* :class:`HierarchicalMesh` — a 2-level mesh: ``p`` workers grouped
  into nodes.  Intra-node transfers pay ``intra_latency +
  size / intra_bw`` and occupy only the two endpoints' NICs; inter-node
  transfers pay ``inter_latency + size / inter_bw`` and additionally
  occupy both nodes' shared uplinks, so concurrent cross-node transfers
  through the same node *serialize* (link contention in virtual time).

Cost rule (all models): a transfer departing at ``t`` over links
``L_1..L_r`` with bottleneck bandwidth ``bw`` starts when every link is
free — ``start = max(t, busy[L_1], ..., busy[L_r])`` — occupies the
links for ``size / bw``, and arrives at ``start + size / bw +
latency``.  Occupancy is mutable per-run state: :meth:`NetworkModel.
state` returns a fresh :class:`NetworkState` whose :meth:`~NetworkState.
send` commits occupancy and :meth:`~NetworkState.peek` prices a
candidate transfer without committing — the hook
:meth:`~repro_torch.core.schedule.OwnershipSchedule.topology_aware` uses to
compare candidate hops before choosing one.

:func:`schedule_makespan` closes the loop the other way: it prices a
*compiled* :class:`~repro_torch.core.schedule.OwnershipSchedule` under a
model (per-step barrier semantics, matching the SPMD engine's lockstep
conflict-free steps), so simulated wall-clock for ring vs. balanced vs.
topology-aware schedules is comparable on the same physical network.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["NetworkModel", "NetworkState", "UniformTopology",
           "HierarchicalMesh", "schedule_makespan"]


class NetworkState:
    """Mutable per-run link occupancy.  One instance per simulation run
    (virtual clocks must not leak across runs); created by
    :meth:`NetworkModel.state`."""

    def __init__(self, model: "NetworkModel"):
        self.model = model
        self._busy: Dict[Tuple[str, int], float] = {}

    # ------------------------------------------------------------------ #
    def peek(self, src: int, dst: int, size: float, t: float) -> float:
        """Arrival time of a ``size``-unit transfer ``src -> dst``
        departing at ``t``, *without* committing link occupancy."""
        arrive, _ = self._price(src, dst, size, t)
        return arrive

    def send(self, src: int, dst: int, size: float, t: float) -> float:
        """Like :meth:`peek`, but commits the occupancy: the used links
        are busy until the transfer clears them."""
        arrive, done = self._price(src, dst, size, t)
        for link in self.model.links(src, dst):
            self._busy[link] = done
        return arrive

    # ------------------------------------------------------------------ #
    def _price(self, src: int, dst: int, size: float,
               t: float) -> Tuple[float, float]:
        model = self.model
        links = model.links(src, dst)
        lat, bw = model.edge(src, dst)
        if not links:                       # uncontended (uniform model)
            return t + lat + size * bw, t
        start = t
        for link in links:
            b = self._busy.get(link, 0.0)
            if b > start:
                start = b
        done = start + size * bw
        return done + lat, done


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    """Base class: a static description of the physical network.  Cost
    and routing are exposed through two pure methods —

    ``edge(src, dst)``  -> ``(latency, inv_bandwidth)`` for the path,
    ``links(src, dst)`` -> the shared-resource link ids the transfer
                           occupies (empty = contention-free path)

    — and the per-run mutable occupancy lives in :class:`NetworkState`
    (:meth:`state`).  Frozen so configs embedding a model stay hashable
    and reusable across runs."""

    def edge(self, src: int, dst: int) -> Tuple[float, float]:
        raise NotImplementedError

    def links(self, src: int, dst: int) -> Tuple[Tuple[str, int], ...]:
        raise NotImplementedError

    def state(self) -> NetworkState:
        return NetworkState(self)


@dataclasses.dataclass(frozen=True)
class UniformTopology(NetworkModel):
    """The flat §3.2 model as a pluggable object: every hop costs
    ``c * size``, no latency split, no contention.  With ``size = k``
    (one item vector) the price is the exact expression the simulator
    historically computed — ``SimConfig(topology=UniformTopology(c))``
    is bitwise-identical to ``topology=None``."""
    c: float = 20.0

    def __post_init__(self):
        if self.c < 0:
            raise ValueError(f"c must be >= 0, got {self.c}")

    def edge(self, src: int, dst: int) -> Tuple[float, float]:
        # modeled as pure bandwidth cost so arrive = t + c * size exactly
        return 0.0, self.c

    def links(self, src: int, dst: int) -> Tuple[Tuple[str, int], ...]:
        return ()


@dataclasses.dataclass(frozen=True)
class HierarchicalMesh(NetworkModel):
    """Two-level hierarchical mesh: ``p`` workers grouped into nodes
    (``node_of[q] = q // workers_per_node`` unless an explicit grouping
    is given).

    * **intra-node** ``src -> dst`` (same node): cost ``intra_latency +
      size * intra_cost``; occupies the sender's NIC-tx and the
      receiver's NIC-rx (two workers exchanging concurrently contend
      only on their own endpoints).
    * **inter-node**: cost ``inter_latency + size * inter_cost``;
      additionally occupies the source node's **uplink** and the
      destination node's **downlink** — the shared resources.  Multiple
      concurrent transfers leaving (or entering) one node serialize on
      that link, in virtual time, in send order.

    Costs are *inverse bandwidths* (time per size unit), so the flat
    model's ``c`` and a mesh's ``inter_cost`` are directly comparable;
    the paper's HPC/commodity split is ``intra_cost << inter_cost``.
    """
    p: int
    workers_per_node: int = 4
    intra_latency: float = 0.0
    inter_latency: float = 0.0
    intra_cost: float = 2.0        # inverse bandwidth, time per size unit
    inter_cost: float = 20.0
    node_of: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.p < 1:
            raise ValueError(f"p must be >= 1, got {self.p}")
        if self.workers_per_node < 1:
            raise ValueError(f"workers_per_node must be >= 1, got "
                             f"{self.workers_per_node}")
        for f in ("intra_latency", "inter_latency", "intra_cost",
                  "inter_cost"):
            if getattr(self, f) < 0:
                raise ValueError(f"{f} must be >= 0")
        if self.node_of is None:
            nodes = tuple(q // self.workers_per_node
                          for q in range(self.p))
        else:
            nodes = tuple(int(x) for x in self.node_of)
            if len(nodes) != self.p:
                raise ValueError(
                    f"node_of has {len(nodes)} entries for p={self.p}")
            if nodes and min(nodes) < 0:
                raise ValueError("node_of entries must be >= 0")
        object.__setattr__(self, "node_of", nodes)

    @property
    def n_nodes(self) -> int:
        return max(self.node_of) + 1 if self.node_of else 0

    def same_node(self, src: int, dst: int) -> bool:
        return self.node_of[src] == self.node_of[dst]

    def edge(self, src: int, dst: int) -> Tuple[float, float]:
        if self.same_node(src, dst):
            return self.intra_latency, self.intra_cost
        return self.inter_latency, self.inter_cost

    def links(self, src: int, dst: int) -> Tuple[Tuple[str, int], ...]:
        if src == dst:
            return ()
        out = (("tx", src), ("rx", dst))
        if not self.same_node(src, dst):
            out += (("up", self.node_of[src]), ("down", self.node_of[dst]))
        return out


# --------------------------------------------------------------------- #
# Pricing a compiled schedule: simulated wall-clock under a topology     #
# --------------------------------------------------------------------- #

def schedule_makespan(schedule, loads: np.ndarray,
                      net: Optional[NetworkModel] = None, *,
                      a: float = 1.0, block_size: float = 1.0,
                      speed: Optional[np.ndarray] = None) -> float:
    """Virtual-time makespan of executing a compiled
    :class:`~repro_torch.core.schedule.OwnershipSchedule` on a physical
    network — the engine-faithful cost: conflict-free steps run in
    lockstep (the SPMD executor's barrier), each active cell ``(q, b)``
    costs ``a * loads[q, b] / speed[q]`` of compute, and between steps
    every block that changes workers is one ``block_size`` transfer
    priced (with contention) by ``net``.

    ``net=None`` prices transfers at zero — pure compute critical path,
    i.e. the padded-step cost the engine benches already measure.  This
    is the number ``benchmarks/schedule_bench.py`` compares across ring
    / balanced / topology-aware on the same mesh.
    """
    p = schedule.p
    loads = np.asarray(loads, dtype=np.float64)
    if loads.shape != (p, p):
        raise ValueError(f"loads must have shape ({p}, {p}), "
                         f"got {loads.shape}")
    speed = (np.ones(p) if speed is None
             else np.asarray(speed, dtype=np.float64))
    if speed.shape != (p,):
        raise ValueError(f"speed must have shape ({p},), got {speed.shape}")
    state = net.state() if net is not None else None

    t = 0.0
    prev = np.arange(p, dtype=np.int64)       # prev[q] = block held by q
    for s in range(schedule.n_steps):
        row = schedule.table[s]
        # transfers into this step's placement (entry permute for s=0)
        if state is not None:
            inv = np.empty(p, dtype=np.int64)
            inv[prev] = np.arange(p)          # inv[b] = worker holding b
            arrive = t
            for q in range(p):
                b = int(row[q])
                src = int(inv[b])
                if src != q:
                    arrive = max(arrive,
                                 state.send(src, q, block_size, t))
            t = arrive
        # lockstep compute: the step ends when its slowest cell does
        dur = 0.0
        for q in range(p):
            if schedule.active[s, q]:
                d = a * float(loads[q, int(row[q])]) / speed[q]
                if d > dur:
                    dur = d
        t += dur
        prev = row.astype(np.int64)
    # exit transfers: every block returns home (epoch boundary invariant)
    if state is not None:
        arrive = t
        for b in range(p):
            src = int(np.flatnonzero(prev == b)[0])
            if src != b:
                arrive = max(arrive, state.send(src, b, block_size, t))
        t = arrive
    return t
