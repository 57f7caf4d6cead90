"""Discrete-event simulator of NOMAD's Algorithm 1.

This is the *paper-faithful* implementation: per-worker concurrent queues,
uniform-random (or §3.3 queue-aware) recipient choice, fully asynchronous
decentralized execution, owner-computes, lock-free.  Because one CPU core
cannot demonstrate 30-thread wall-clock scaling, we simulate virtual time
with the paper's own cost model (§3.2): processing the ratings of one item
on one worker costs ``a * k`` per rating, shipping an ``(j, h_j)`` pair
costs ``c * k``.  The numerical updates are executed for real (numpy
float64), so convergence curves are genuine; only the clock is virtual.

The simulator also supports:
  * stragglers   — per-worker speed multipliers (§3.3 motivation),
  * failures     — workers dying at given virtual times; their queued
                   nomadic items and their row-ownership are re-assigned to
                   survivors (the NOMAD elasticity story),
  * DSGD mode    — bulk-synchronous block rotation with barriers, used to
                   demonstrate the curse of the last reducer (Fig. 8/11),
  * DSGD++ mode  — 2p partitions with communication overlap [25].

Every SGD update is logged as (start_time, seq, rating_id) segments so the
executed schedule can be *replayed serially* and compared bitwise — the
serializability property test.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .objective import sgd_pair_update, rmse_np
from .stepsize import PowerSchedule
from .topology import NetworkModel


@dataclasses.dataclass
class SimConfig:
    """Internal knob record for the simulators below.  The public front
    door is ``repro_torch.api.AsyncSimConfig`` + ``solve`` (mode='nomad' /
    'dsgd' / 'dsgd++'), which builds one of these via
    ``AsyncSimConfig.to_sim_config``."""
    p: int = 4                    # number of workers
    k: int = 16                   # latent dimension
    lam: float = 0.05
    schedule: PowerSchedule = dataclasses.field(default_factory=PowerSchedule)
    a: float = 1.0                # per-rating processing cost (x k)
    c: float = 20.0               # per-item communication latency (x k)
    epochs: float = 4.0           # stop after ~epochs * nnz updates
    load_balance: bool = False    # §3.3 queue-aware routing
    speed: Optional[np.ndarray] = None   # per-worker speed multiplier
    failures: Tuple[Tuple[float, int], ...] = ()  # (time, worker) events
    #: worker rejoin events, the dual of ``failures``: at (time, worker)
    #: a previously-failed worker comes back alive, steals a balanced
    #: share of rows from the most-loaded survivor (stable segment
    #: splits, so the start-time linearization — and serializability —
    #: is preserved) and re-enters the routing pool.
    rejoins: Tuple[Tuple[float, int], ...] = ()
    seed: int = 0
    record_every: float = 0.5     # RMSE trace granularity, in epochs
    #: rating-arrival events: (virtual_time, rating ids) batches.  Listed
    #: ratings are invisible until their batch's time — they then join
    #: their owner's per-item segments and are picked up the next time
    #: the nomadic item visits (streaming workload, NOMAD only).
    arrivals: Tuple[Tuple[float, Tuple[int, ...]], ...] = ()
    #: physical network model (DESIGN.md §12).  ``None`` keeps the flat
    #: §3.2 pricing — every hop costs exactly ``c * k``, bitwise the
    #: historical behavior.  A :class:`~repro_torch.core.topology.NetworkModel`
    #: prices every item transfer (NOMAD ``"arrive"`` events, DSGD block
    #: shipments) by source/destination placement, with per-link
    #: contention tracked in virtual time.
    topology: Optional[NetworkModel] = None
    #: integrity transport (DESIGN.md §14).  ``None`` ships nomadic
    #: items over the historical perfect channel — the zero-cost path,
    #: bitwise-identical event structure.  A
    #: :class:`~repro_torch.runtime.transport.TransportConfig` seals every
    #: transfer in a sequence-numbered CRC32 envelope; without
    #: ``link_faults`` the channel stays perfect (delivery events are
    #: the historical ones — still bitwise), with ``link_faults`` the
    #: full at-least-once machinery runs (acknowledgement hops,
    #: exponential-backoff retransmits, receiver dedup — NOMAD mode
    #: only).
    transport: Optional["TransportConfig"] = None  # noqa: F821
    #: :class:`~repro_torch.runtime.chaos.DegradedLink` message-fault model
    #: (scripted + seeded drop/duplicate/reorder/corrupt/delay).
    #: Requires (or implies) ``transport``; every fault script still
    #: yields an exactly-serializable history — property-tested in
    #: tests/test_transport.py.
    link_faults: Optional["DegradedLink"] = None   # noqa: F821


@dataclasses.dataclass
class SimResult:
    W: np.ndarray
    H: np.ndarray
    update_log: List[Tuple[float, int]]   # (start_time, rating_id) in exec order
    n_updates: int
    sim_time: float
    busy_time: np.ndarray                 # per worker
    trace: List[Tuple[float, int, float]]  # (time, n_updates, test RMSE)
    throughput: float                     # updates / worker / unit time
    #: (start_time, worker, item) per completed segment — the observed
    #: ownership transfers; ``OwnershipSchedule.from_sim_log`` compiles
    #: these into a schedule the real engine replays (NOMAD mode only)
    visit_log: List[Tuple[float, int, int]] = dataclasses.field(
        default_factory=list)
    #: integrity-transport counters (``TransportStats.as_dict()``) when
    #: ``SimConfig.transport`` is set; ``None`` on the legacy channel
    transport: Optional[Dict[str, int]] = None


class NomadSimulator:
    """Event-driven NOMAD (Algorithm 1) with virtual time."""

    def __init__(self, cfg: SimConfig, m: int, n: int,
                 rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 W0: np.ndarray, H0: np.ndarray,
                 test: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None):
        self.cfg = cfg
        self.m, self.n = m, n
        self.rows = np.asarray(rows)
        self.cols = np.asarray(cols)
        self.vals = np.asarray(vals, dtype=np.float64)
        self.W = np.array(W0, dtype=np.float64, copy=True)
        self.H = np.array(H0, dtype=np.float64, copy=True)
        self.test = test
        p = cfg.p
        rng = np.random.default_rng(cfg.seed)
        self.rng = rng

        # static row partition (balanced by rating count, footnote 1)
        from .partition import balanced_assign
        row_cnt = np.bincount(self.rows, minlength=m)
        self.row_owner = balanced_assign(row_cnt, p)

        # rating-arrival schedule: listed ratings start invisible
        self._arrivals = []
        pending = np.zeros(len(self.rows), dtype=bool)
        for t_arr, ids in cfg.arrivals:
            ids = np.asarray(ids, dtype=np.int64)
            if t_arr < 0:
                raise ValueError(f"arrival time must be >= 0, got {t_arr}")
            if len(ids) and (ids.min() < 0 or ids.max() >= len(self.rows)):
                raise ValueError("arrival rating ids out of range")
            if pending[ids].any() or len(np.unique(ids)) != len(ids):
                raise ValueError("a rating may only arrive once")
            pending[ids] = True
            self._arrivals.append((float(t_arr), ids))

        # per (worker, item): list of rating ids, ordered  (\bar\Omega_j^{(q)})
        self.cell: Dict[Tuple[int, int], np.ndarray] = {}
        owner_of_rating = self.row_owner[self.rows]
        active = np.flatnonzero(~pending)
        order = active[np.lexsort((self.rows[active], self.cols[active],
                                   owner_of_rating[active]))]
        key = owner_of_rating[order].astype(np.int64) * n + self.cols[order]
        bounds = np.flatnonzero(np.diff(key)) + 1
        for seg in np.split(order, bounds):
            if len(seg):
                q = int(owner_of_rating[seg[0]])
                j = int(self.cols[seg[0]])
                self.cell[(q, j)] = seg

        # per-pair update counters for the step-size schedule (eq. 11)
        self.pair_t = np.zeros(len(self.rows), dtype=np.int64)
        self.speed = (np.ones(p) if cfg.speed is None
                      else np.asarray(cfg.speed, dtype=np.float64))

    # ------------------------------------------------------------------ #
    def run(self) -> SimResult:
        cfg = self.cfg
        p = cfg.p
        rng = self.rng
        k = self.W.shape[1]
        nnz = len(self.rows)
        target_updates = int(cfg.epochs * nnz)

        # communication pricing: flat c*k when no topology (the exact
        # historical expression — bitwise fallback), else the network
        # model with per-link contention tracked in virtual time
        net_state = (None if cfg.topology is None
                     else cfg.topology.state())

        def ship(src: int, dst: int, t: float) -> float:
            if net_state is None:
                return t + cfg.c * k
            return net_state.send(src, dst, k, t)

        # initial random assignment of items to queues (Alg. 1 lines 7-10)
        queues: List[deque] = [deque() for _ in range(p)]
        for j in range(self.n):
            queues[int(rng.integers(p))].append(j)

        alive = np.ones(p, dtype=bool)
        clock = np.zeros(p)            # per-worker virtual clocks
        busy = np.zeros(p)
        heap: List[Tuple[float, int, str, int, int]] = []  # (t, seq, kind, j, q)
        seq = 0

        # ------------------------------------------------------------- #
        # integrity transport (DESIGN.md §14).  Three channel modes:
        #   tcfg None              — the historical perfect channel; the
        #                            exact legacy event pushes (bitwise).
        #   tcfg set, link None    — every transfer sealed in a CRC32
        #                            envelope and verified at delivery,
        #                            but the delivery event is still the
        #                            single historical "arrive" (same
        #                            time, same seq draw) — results stay
        #                            bitwise-identical to tcfg None.
        #   link set               — full at-least-once machinery: each
        #                            transfer becomes a tracked message
        #                            with "xmit" (delivery attempt),
        #                            "ack" and "retx" (timer) events, all
        #                            hops priced through ship(); faults
        #                            drawn from link_state; the
        #                            ItemLedger's (item, version) dedup
        #                            keeps circulation exactly-once.
        # ------------------------------------------------------------- #
        tcfg, link = cfg.transport, cfg.link_faults
        if link is not None and tcfg is None:
            from ..runtime.transport import TransportConfig
            tcfg = TransportConfig()
        ledger = None
        link_state = None
        inline_env: Dict[int, object] = {}
        evt_env: Dict[int, object] = {}
        msgs: Dict[int, dict] = {}
        next_msg = [0]
        if tcfg is not None:
            from ..runtime import transport as _tp
            timeout = (tcfg.timeout if tcfg.timeout is not None
                       else tcfg.timeout_hops * cfg.c * k)
            ledger = _tp.ItemLedger(self.n)
            if link is not None:
                link_state = link.state(cfg.seed)
                # transport internals never touch self.rng, so enabling
                # faults cannot perturb the routing draw sequence
                tx_rng = np.random.default_rng((cfg.seed, 0x7417))

        def deliver(jj: int, dq: int, t: float):
            """Item jj joins dq's queue — the post-accept half of the
            historical "arrive" handling."""
            was_idle = dq not in self._pending
            queues[dq].append(jj)
            if was_idle:
                start_next(dq, max(t, clock[dq]))

        def push_evt(t_e: float, kind_e: str, mid: int, q_e: int,
                     env=None):
            nonlocal seq
            seq += 1
            if env is not None:
                evt_env[seq] = env
            heapq.heappush(heap, (t_e, seq, kind_e, mid, q_e))

        def transmit(mid: int, t: float):
            """One wire attempt for message mid: draw link faults, price
            the hop, arm the retransmission timer."""
            m = msgs[mid]
            m["attempts"] += 1
            st = ledger.stats
            st.transmissions += 1
            env = _tp.seal(m["src"], m["dst"], mid,
                           _tp.encode_item(m["j"], m["ver"]))
            t_d = ship(m["src"], m["dst"], t)
            hop = max(t_d - t, 1e-9)
            faults = ([] if m["reliable"]
                      else link_state.draw(m["src"], m["dst"], t))
            kinds = {kd for kd, _ in faults}
            # a held (reordered) predecessor is released onto the wire
            # just behind this transit of its link
            lk = (m["src"], m["dst"])
            held = link_state.held.pop(lk, None)
            t_arr = t_d
            for kd, factor in faults:
                if kd == "delay":
                    t_arr += factor * hop
            if "corrupt" in kinds:
                env = env.corrupted(
                    int(tx_rng.integers(8 * len(env.payload))))
            if "drop" in kinds:
                st.dropped += 1
            elif "reorder" in kinds:
                # hold this copy until the next message transits the
                # same link — the receiver then observes genuinely
                # inverted send order
                link_state.held[lk] = (mid, m["dst"], env, t_arr)
            else:
                push_evt(t_arr, "xmit", mid, m["dst"], env)
                if "dup" in kinds:
                    push_evt(t_arr, "xmit", mid, m["dst"], env)
            if held is not None:
                hmid, hdst, henv, h_arr = held
                push_evt(max(t_d, h_arr) + 1e-9, "xmit", hmid, hdst,
                         henv)
            # at-least-once: the timer always arms, exponential backoff
            push_evt(t + tcfg.retry_delay(timeout, m["attempts"]),
                     "retx", mid, m["src"])

        def send_item(src: int, dst: int, jj: int, t: float,
                      reliable: bool = False):
            """Route item jj src→dst over the configured channel."""
            nonlocal seq
            if tcfg is None:
                seq += 1
                heapq.heappush(heap, (ship(src, dst, t), seq, "arrive",
                                      jj, dst))
                return
            if link_state is None:
                # envelope-only path: seal + verify, perfect link — the
                # one delivery event is the historical one
                ver = ledger.launch(jj)
                ledger.stats.transmissions += 1
                seq += 1
                inline_env[seq] = _tp.seal(src, dst, seq,
                                           _tp.encode_item(jj, ver))
                heapq.heappush(heap, (ship(src, dst, t), seq, "arrive",
                                      jj, dst))
                return
            ver = ledger.launch(jj)
            next_msg[0] += 1
            mid = next_msg[0]
            msgs[mid] = dict(j=jj, ver=ver, src=src, dst=dst,
                             attempts=0, acked=False, reliable=reliable)
            transmit(mid, t)

        # prime: every worker starts working on its queue head at t=0
        # events: ('finish', j, q) worker q finished processing item j
        #         ('arrive', j, q) item j arrives at worker q's queue
        def start_next(q: int, t: float):
            nonlocal seq
            if not alive[q] or not queues[q]:
                return
            j = queues[q].popleft()
            seg = self.cell.get((q, j))
            nseg = 0 if seg is None else len(seg)
            dur = (cfg.a * k * max(nseg, 1)) / self.speed[q]
            seq += 1
            heapq.heappush(heap, (t + dur, seq, "finish", j, q))
            # capture the rating segment AT START: a failure may merge a
            # dead worker's ratings into this cell mid-flight, and those
            # must only take effect for segments started after the merge
            # (otherwise the start-time linearization is violated).
            self._pending[q] = (j, t, seg)

        self._pending: Dict[int, Tuple[int, float, object]] = {}
        for q in range(p):
            start_next(q, 0.0)

        # schedule the rating-arrival batches
        # events: ('ratings', bi, _) batch bi of cfg.arrivals lands
        for bi, (t_arr, _) in enumerate(self._arrivals):
            seq += 1
            heapq.heappush(heap, (t_arr, seq, "ratings", bi, 0))

        # merged lifecycle stream: failures and rejoins in time order
        # (a failure at the same instant as a rejoin applies first)
        life_iter = iter(sorted(
            [(float(ft), 0, int(fq)) for ft, fq in cfg.failures]
            + [(float(rt), 1, int(rq)) for rt, rq in cfg.rejoins]))
        next_life = next(life_iter, None)

        update_log: List[Tuple[float, int]] = []
        visit_log: List[Tuple[float, int, int]] = []
        trace: List[Tuple[float, int, float]] = []
        n_updates = 0
        # clamp the trace interval to >= 1 update: record_every * nnz < 1
        # used to floor to 0 and record on every finish event
        rec_interval = max(1, int(cfg.record_every * nnz))
        record_at = rec_interval
        sim_time = 0.0
        # time-weighted alive-worker integral for the throughput
        # denominator: a worker dead 90% of the run must not count like
        # one that died at the end
        alive_integral = 0.0
        life_t = 0.0
        n_life = 0

        while heap and n_updates < target_updates:
            t, eseq, kind, j, q = heapq.heappop(heap)
            sim_time = t

            # lifecycle injection (failures and rejoins)
            while next_life is not None and next_life[0] <= t:
                ft, lkind, fq = next_life
                if lkind == 0 and alive[fq] and alive.sum() > 1:
                    alive_integral += alive.sum() * (ft - life_t)
                    life_t = ft
                    n_life += 1
                    alive[fq] = False
                    survivors = np.flatnonzero(alive)
                    # re-enqueue this worker's nomadic items to survivors
                    for item in queues[fq]:
                        tgt = int(rng.choice(survivors))
                        send_item(fq, tgt, item, ft)
                    queues[fq].clear()
                    if fq in self._pending:   # in-flight item is lost & resent
                        item, _, _ = self._pending.pop(fq)
                        tgt = int(rng.choice(survivors))
                        send_item(fq, tgt, item, ft)
                    # row ownership moves to a survivor (elastic re-shard)
                    heir = int(survivors[0])
                    moved = np.flatnonzero(self.row_owner == fq)
                    self.row_owner[moved] = heir
                    for key in [key for key in self.cell if key[0] == fq]:
                        seg = self.cell.pop(key)
                        dst = (heir, key[1])
                        self.cell[dst] = (np.concatenate([self.cell[dst], seg])
                                          if dst in self.cell else seg)
                elif lkind == 1 and not alive[fq]:
                    # rejoin: the worker comes back empty-handed and
                    # steals a balanced share of rows from the heaviest
                    # survivors.  Cell segments split stably (relative
                    # rating order preserved) and in-flight segments
                    # captured their list at start, so the start-time
                    # linearization — and serializability — survives.
                    alive_integral += alive.sum() * (ft - life_t)
                    life_t = ft
                    n_life += 1
                    alive[fq] = True
                    clock[fq] = max(clock[fq], ft)
                    row_cnt = np.bincount(self.rows,
                                          minlength=self.m).astype(float)
                    load = np.zeros(p)
                    np.add.at(load, self.row_owner, row_cnt)
                    load[~alive] = -np.inf
                    share = load[alive].sum() / alive.sum()
                    moved_mask = np.zeros(self.m, dtype=bool)
                    donors = set()
                    while load[fq] < share:
                        donor = int(np.argmax(load))
                        if donor == fq:
                            break
                        cand = np.flatnonzero(
                            (self.row_owner == donor) & ~moved_mask)
                        gap = load[donor] - load[fq]
                        fits = cand[row_cnt[cand] + 1.0 < gap]
                        if not len(fits):
                            break
                        r = fits[int(np.argmax(row_cnt[fits]))]
                        moved_mask[r] = True
                        donors.add(donor)
                        self.row_owner[r] = fq
                        load[donor] -= row_cnt[r] + 1.0
                        load[fq] += row_cnt[r] + 1.0
                    for donor in donors:
                        for key in [key for key in self.cell
                                    if key[0] == donor]:
                            seg = self.cell[key]
                            take = moved_mask[self.rows[seg]]
                            if not take.any():
                                continue
                            give, keep = seg[take], seg[~take]
                            if len(keep):
                                self.cell[key] = keep
                            else:
                                del self.cell[key]
                            dst = (fq, key[1])
                            self.cell[dst] = (
                                np.concatenate([self.cell[dst], give])
                                if dst in self.cell else give)
                next_life = next(life_iter, None)

            if kind == "ratings":
                # merge the batch into its owner-item segments.  Segments
                # already in flight captured their rating list at start,
                # so the new ratings only take effect for segments that
                # start after this instant — the start-time linearization
                # (and with it serializability) is preserved.
                for g in self._arrivals[j][1]:
                    qg = int(self.row_owner[self.rows[g]])
                    jj = int(self.cols[g])
                    seg = self.cell.get((qg, jj))
                    self.cell[(qg, jj)] = (
                        np.asarray([g], dtype=np.int64) if seg is None
                        else np.concatenate([seg, [g]]))
                continue

            if kind in ("xmit", "ack", "retx"):
                # full-machinery transport events (link_faults active);
                # j is the message id here, q its addressee
                m = msgs[j]
                st = ledger.stats
                if kind == "ack":
                    m["acked"] = True
                elif kind == "retx":
                    if not (m["acked"]
                            or ledger.delivered(m["j"], m["ver"])
                            or m["ver"] < ledger.version(m["j"])):
                        live = np.flatnonzero(alive)
                        if m["attempts"] > tcfg.max_retries:
                            # retry budget exhausted: reliable re-routed
                            # delivery — an adversarial drop script can
                            # delay an item but never starve it out of
                            # circulation
                            st.reroutes += 1
                            send_item(m["src"] if alive[m["src"]]
                                      else int(live[0]),
                                      int(tx_rng.choice(live)),
                                      m["j"], t, reliable=True)
                        elif not alive[m["src"]] or not alive[m["dst"]]:
                            # an endpoint died: open a fresh transfer
                            # (version bump) between live workers — any
                            # late copy of this one is now stale and the
                            # ledger discards it, so the item can never
                            # enter circulation twice
                            st.reroutes += 1
                            send_item(m["src"] if alive[m["src"]]
                                      else int(live[0]),
                                      int(tx_rng.choice(live)),
                                      m["j"], t)
                        else:
                            st.retransmits += 1
                            transmit(j, t)
                else:  # xmit: one delivery attempt lands at its dst
                    env = evt_env.pop(eseq)
                    if alive[q]:
                        if not env.verify():
                            # checksum failure == drop; the sender's
                            # retransmission timer covers it
                            st.corrupt += 1
                        else:
                            jj, ver = _tp.decode_item(env.payload)
                            if ledger.accept(jj, ver):
                                push_evt(ship(q, m["src"], t), "ack",
                                         j, m["src"])
                                deliver(jj, q, t)
                continue

            if not alive[q]:
                if kind == "arrive":
                    # the delivery raced a failure: the message was in
                    # the heap when its addressee died, so the failure
                    # handler (which re-routes queued and in-flight-
                    # compute items) never saw it.  Dropping it would
                    # permanently remove item j from circulation and
                    # starve H[j] until a rejoin — forward it to a live
                    # survivor with one more priced hop instead.  Only
                    # the arrival time moves, so the start-time
                    # linearization (and serializability) is preserved.
                    inline_env.pop(eseq, None)   # re-sealed on forward
                    live = np.flatnonzero(alive)
                    tgt = int(rng.choice(live))
                    send_item(q, tgt, j, t)
                continue

            if kind == "arrive":
                env = inline_env.pop(eseq, None)
                if env is not None:
                    # envelope-only path: verify at delivery (perfect
                    # link, so failure is impossible — the check prices
                    # the CRC and keeps the ledger's books honest)
                    if env.verify():
                        ledger.accept(*_tp.decode_item(env.payload))
                    else:  # pragma: no cover - no corruption source
                        ledger.stats.corrupt += 1
                        continue
                deliver(j, q, t)
            else:  # finish
                if q not in self._pending or self._pending[q][0] != j:
                    continue  # stale event (e.g. re-routed at failure)
                _, t_start, seg = self._pending.pop(q)
                visit_log.append((t_start, q, j))
                if seg is not None:
                    # owner-computes: sequential SGD on \bar\Omega_j^{(q)}
                    lam = cfg.lam
                    for g in seg:
                        i = int(self.rows[g])
                        lr = cfg.schedule(self.pair_t[g])
                        self.pair_t[g] += 1
                        self.W[i], self.H[j] = sgd_pair_update(
                            self.W[i], self.H[j], self.vals[g], lr, lam)
                        update_log.append((t_start, g))
                        n_updates += 1
                busy[q] += t - t_start
                clock[q] = t
                # route the nomadic pair (Alg.1 line 22, or §3.3 balanced)
                live = np.flatnonzero(alive)
                if cfg.load_balance:
                    qlen = np.array([len(queues[x]) + (x in self._pending)
                                     for x in live], dtype=np.float64)
                    w = 1.0 / (1.0 + qlen) ** 2
                    dest = int(rng.choice(live, p=w / w.sum()))
                else:
                    dest = int(rng.choice(live))
                send_item(q, dest, j, t)
                start_next(q, t)

                if self.test is not None and n_updates >= record_at:
                    record_at += rec_interval
                    trace.append((t, n_updates,
                                  rmse_np(self.W, self.H, *self.test)))

        # a run shorter than one record interval — or one whose last
        # updates landed after the last recorded entry — must still
        # report its final RMSE (consumers read trace[-1] /
        # FitResult.rmse[-1]); mirrors the simulate_dsgd guard
        if self.test is not None and (not trace
                                      or trace[-1][1] != n_updates):
            trace.append((sim_time, n_updates,
                          rmse_np(self.W, self.H, *self.test)))

        total_time = max(sim_time, 1e-12)
        if n_life == 0:
            # no lifecycle event ever applied: the historical constant
            # denominator is already exact (and bitwise-preserved)
            avg_alive = float(max(1, int(alive.sum())))
        else:
            alive_integral += alive.sum() * max(0.0, sim_time - life_t)
            avg_alive = max(alive_integral / total_time, 1e-12)
        thpt = n_updates / (total_time * avg_alive)
        return SimResult(W=self.W, H=self.H, update_log=update_log,
                         n_updates=n_updates, sim_time=sim_time,
                         busy_time=busy, trace=trace, throughput=thpt,
                         visit_log=visit_log,
                         transport=(None if ledger is None
                                    else ledger.stats.as_dict()))


# ---------------------------------------------------------------------- #
# Bulk-synchronous DSGD / DSGD++ simulators (baselines for Fig. 8/11/12). #
# ---------------------------------------------------------------------- #

def simulate_dsgd(cfg: SimConfig, m: int, n: int, rows, cols, vals,
                  W0, H0, test=None, overlap: bool = False) -> SimResult:
    """DSGD [12]: p x p blocks, bulk synchronization between sub-epochs.
    ``overlap=True`` gives DSGD++ [25]: communication of the *next* block
    overlaps with compute, but the barrier (last-reducer wait) remains.
    """
    from .partition import pack
    p, k = cfg.p, cfg.k
    rows = np.asarray(rows); cols = np.asarray(cols)
    vals = np.asarray(vals, dtype=np.float64)
    br = pack(rows, cols, vals, m, n, p, balanced=True, waves=False)
    W = np.array(W0, np.float64, copy=True)
    H = np.array(H0, np.float64, copy=True)
    speed = np.ones(p) if cfg.speed is None else np.asarray(cfg.speed)
    rng = np.random.default_rng(cfg.seed)

    nnz = len(rows)
    pair_t = np.zeros(nnz, dtype=np.int64)
    # topology pricing of the per-sub-epoch block shipment: worker q
    # ships its whole block (n_local item vectors) to q+1 mod p, all
    # departing together, contending for shared links; None keeps the
    # flat c * k * n_local barrier (bitwise the historical expression)
    net_state = None if cfg.topology is None else cfg.topology.state()
    t_sim = 0.0
    n_updates = 0
    busy = np.zeros(p)
    trace: List[Tuple[float, int, float]] = []
    update_log: List[Tuple[float, int]] = []
    target = int(cfg.epochs * nnz)
    # trace granularity honors cfg.record_every (in epochs), mirroring
    # NomadSimulator — recording after *every* sub-epoch was O(p * epochs)
    # full test-RMSE evaluations and bloated traces at large p
    record_at = int(cfg.record_every * nnz)

    while n_updates < target:
        for s in range(p):          # one sub-epoch = one diagonal of blocks
            durs = np.zeros(p)
            for q in range(p):
                ids = br.gid[q, s, : br.nnz_cell[q, s]]
                for g in ids:
                    i, j = int(rows[g]), int(cols[g])
                    lr = cfg.schedule(pair_t[g]); pair_t[g] += 1
                    W[i], H[j] = sgd_pair_update(W[i], H[j], vals[g], lr,
                                                 cfg.lam)
                    update_log.append((t_sim, g))
                durs[q] = cfg.a * k * max(len(ids), 1) / speed[q]
                n_updates += len(ids)
            busy += durs
            # each worker ships one whole block (n/p item vectors) per
            # sub-epoch; DSGD++ overlaps that transfer with compute
            durs_max = float(durs.max())
            if net_state is None:
                comm = cfg.c * k * br.n_local
            else:
                depart = t_sim if overlap else t_sim + durs_max
                comm = 0.0
                for q in range(p):
                    arr = net_state.send(q, (q + 1) % p, k * br.n_local,
                                         depart)
                    comm = max(comm, arr - depart)
            step_time = (max(durs_max, comm) if overlap
                         else durs_max + comm)
            t_sim += step_time   # barrier: everyone waits for the slowest
            if test is not None and n_updates >= record_at:
                record_at += int(cfg.record_every * nnz)
                trace.append((t_sim, n_updates, rmse_np(W, H, *test)))
            if n_updates >= target:
                break

    # a run shorter than one record interval must still report its final
    # RMSE (consumers read trace[-1] / FitResult.rmse[-1])
    if test is not None and (not trace or trace[-1][1] != n_updates):
        trace.append((t_sim, n_updates, rmse_np(W, H, *test)))

    thpt = n_updates / (max(t_sim, 1e-12) * p)
    return SimResult(W=W, H=H, update_log=update_log, n_updates=n_updates,
                     sim_time=t_sim, busy_time=busy, trace=trace,
                     throughput=thpt)
