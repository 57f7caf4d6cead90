"""Fault-injection harness: scripted or seeded worker kills, slowdowns,
departures and (re)joins driving a live
:class:`~repro_torch.api.StreamingSession`.

The JAX package's ``runtime/chaos.py``, copied: a :func:`seeded_script`
of chaos events replayed against the engine must leave every surviving
shard bitwise-untouched and the training history exactly serializable.
One change: the ``nan`` event writes its NaN in place into the live
factor tensor on the engine's device, so the next round's divergence
sentinel (``NomadRingEngine.last_finite``) trips.

Worker speeds are virtual: a ``slow`` event scales a worker's simulated
step time, the harness synthesizes per-round timing vectors from the
packed per-worker loads, and those feed the session's
:class:`~repro_torch.runtime.straggler.StragglerMonitor` — so the
detection / eject / schedule-adaptation policies run against
reproducible inputs without needing an actually-slow host.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

ACTIONS = ("kill", "leave", "join", "slow", "heal", "bitflip", "nan")

#: link-level fault kinds the :class:`DegradedLink` model injects into
#: the simulator's checksummed transport
LINK_KINDS = ("drop", "dup", "reorder", "corrupt", "delay")


# --------------------------------------------------------------------- #
# Link-fault model (consumed by core.async_sim's transport layer)        #
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class LinkEvent:
    """One scripted link degradation: during virtual time
    ``[t0, t1)``, messages on matching links suffer ``kind`` with
    probability ``prob``.  ``src``/``dst`` of ``-1`` match any endpoint;
    ``factor`` scales the extra latency for ``delay``."""
    kind: str
    t0: float = 0.0
    t1: float = math.inf
    prob: float = 1.0
    factor: float = 4.0
    src: int = -1
    dst: int = -1

    def __post_init__(self):
        if self.kind not in LINK_KINDS:
            raise ValueError(f"kind={self.kind!r} not in {LINK_KINDS}")
        if not (self.t0 >= 0 and self.t1 > self.t0):
            raise ValueError(
                f"need 0 <= t0 < t1, got [{self.t0}, {self.t1})")
        if not (0.0 < self.prob <= 1.0):
            raise ValueError(f"prob must be in (0, 1], got {self.prob}")
        if self.factor <= 0:
            raise ValueError(f"factor must be > 0, got {self.factor}")

    def matches(self, src: int, dst: int, t: float) -> bool:
        return (self.t0 <= t < self.t1
                and self.src in (-1, src) and self.dst in (-1, dst))


class DegradedLink:
    """Scripted + seeded message-fault model for the nomadic transport.

    Two layers compose: a tuple of :class:`LinkEvent` windows (the
    scripted chaos — "drop everything on link 0→2 between t=50 and
    t=90") and background seeded rates (every message everywhere flips a
    coin per fault kind).  The model is *stateless config*; the
    simulator materializes per-run state (an RNG stream independent of
    the routing RNG, and the per-link hold slot the ``reorder`` kind
    uses) via :meth:`state`, mirroring ``NetworkModel.state()``.

    ``reorder`` is realized as holding the message back until the next
    message transits the same link, then releasing it to land just
    after — i.e. the receiver observes genuinely inverted send order,
    which is what the dedup/idempotency layer must survive.  A held
    message with no follower is re-covered by the sender's
    retransmission timer.
    """

    def __init__(self, events: Sequence[LinkEvent] = (), *,
                 drop: float = 0.0, dup: float = 0.0,
                 reorder: float = 0.0, corrupt: float = 0.0,
                 delay: float = 0.0, delay_factor: float = 4.0):
        self.events = tuple(events)
        for ev in self.events:
            if not isinstance(ev, LinkEvent):
                raise TypeError(f"events must be LinkEvent, got "
                                f"{type(ev).__name__}")
        rates = dict(drop=drop, dup=dup, reorder=reorder,
                     corrupt=corrupt, delay=delay)
        for name, r in rates.items():
            if not (0.0 <= r < 1.0):
                raise ValueError(
                    f"{name} rate must be in [0, 1), got {r}")
        if delay_factor <= 0:
            raise ValueError(
                f"delay_factor must be > 0, got {delay_factor}")
        self.rates = rates
        self.delay_factor = float(delay_factor)

    def state(self, seed: int = 0) -> "_LinkState":
        return _LinkState(self, seed)


class _LinkState:
    """Per-run fault-drawing state for one :class:`DegradedLink`."""

    def __init__(self, link: DegradedLink, seed: int):
        self.link = link
        # independent stream: fault draws must not perturb the routing
        # RNG (so the *decisions* of a degraded run stay comparable)
        self.rng = np.random.default_rng((seed, 0x11F0))
        #: per-(src, dst) held message awaiting a follower (reorder)
        self.held: dict = {}

    def draw(self, src: int, dst: int, t: float) -> List[Tuple[str, float]]:
        """Fault kinds afflicting one transmission departing at ``t``:
        ``(kind, factor)`` pairs, scripted windows first then background
        rates (at most one occurrence of each kind per message)."""
        out = []
        seen = set()
        for ev in self.link.events:
            if ev.kind not in seen and ev.matches(src, dst, t) \
                    and (ev.prob >= 1.0 or self.rng.random() < ev.prob):
                out.append((ev.kind, ev.factor))
                seen.add(ev.kind)
        for kind, rate in self.link.rates.items():
            if rate > 0.0 and kind not in seen \
                    and self.rng.random() < rate:
                out.append((kind, self.link.delay_factor))
                seen.add(kind)
        return out


def seeded_link_script(seed: int, horizon: float, *, n_events: int = 6,
                       p: int = 4,
                       max_prob: float = 0.8) -> List[LinkEvent]:
    """A reproducible scripted link-chaos scenario: ``n_events`` fault
    windows over ``[0, horizon)`` with seeded kind, endpoints (possibly
    wildcard), window and probability — the scripted half of the
    transport property tests (the background-rate half is seeded
    directly on :class:`DegradedLink`)."""
    if horizon <= 0:
        raise ValueError(f"horizon must be > 0, got {horizon}")
    rng = np.random.default_rng((seed, 0x5E9D))
    events = []
    for _ in range(int(n_events)):
        kind = LINK_KINDS[int(rng.integers(len(LINK_KINDS)))]
        t0 = float(rng.uniform(0, horizon * 0.8))
        t1 = t0 + float(rng.uniform(horizon * 0.05, horizon * 0.4))
        events.append(LinkEvent(
            kind=kind, t0=t0, t1=t1,
            prob=float(rng.uniform(0.2, max_prob)),
            factor=float(rng.uniform(1.5, 6.0)),
            src=int(rng.integers(-1, p)), dst=int(rng.integers(-1, p))))
    return events


def bitflip_checkpoint(ckpt_dir: str, *, seed: int = 0,
                       step: Optional[int] = None) -> Optional[int]:
    """Corrupt the newest (or given) *committed* checkpoint: flip one
    byte in the middle of its ``shard_0.npz`` payload, in place.  The
    integrity layer must quarantine the step on the next restore and
    fall back to the previous verified one — this is the injection the
    chaos harness's ``bitflip`` event and the robustness tests use.
    Returns the corrupted step, or ``None`` when nothing committed
    exists."""
    from ..checkpoint.checkpoint import latest_step
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "shard_0.npz")
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        # flip inside the payload body: clear of the zip local-file
        # header so np.load still *reads* — the per-array CRC manifest,
        # not a zip parse error, is what must catch it
        off = int(np.random.default_rng((seed, 0xB17F)).integers(
            size // 4, max(size // 4 + 1, size - 64)))
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0x40]))
    return step


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scripted fault, applied before the given round's training.

    ``worker == -1`` lets the harness pick a live worker (seeded).
    ``factor`` is the slowdown multiplier for ``slow`` (a 2.0 makes the
    worker's virtual steps twice as long until a ``heal``).

    Two integrity-fault kinds ride the same script format (no worker):
    ``bitflip`` corrupts the newest committed checkpoint in place
    (:func:`bitflip_checkpoint` — the next ``kill`` recovery must
    quarantine it and boot from the previous verified step), and
    ``nan`` pokes a NaN into the live factor shards (the divergence
    sentinel must trip and the session's
    :class:`~repro_torch.api.DivergencePolicy` roll the round back)."""
    round: int
    action: str
    worker: int = -1
    factor: float = 2.0

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"action={self.action!r} not in {ACTIONS}")
        if self.round < 0:
            raise ValueError(f"round must be >= 0, got {self.round}")
        if self.action == "slow" and self.factor <= 1.0:
            raise ValueError(
                f"slow factor must be > 1, got {self.factor}")


def seeded_script(seed: int, rounds: int, p0: int, *,
                  kill_prob: float = 0.1, leave_prob: float = 0.1,
                  join_prob: float = 0.15, slow_prob: float = 0.15,
                  bitflip_prob: float = 0.0, nan_prob: float = 0.0,
                  p_min: int = 2,
                  p_max: Optional[int] = None) -> List[ChaosEvent]:
    """A reproducible chaos script: per round, at most one lifecycle
    event drawn from the given probabilities, with the worker-count
    walk clamped to ``[p_min, p_max]`` (departures are suppressed at the
    floor, joins at the ceiling) so every generated script is runnable.
    Slow workers are eventually healed (a follow-up ``heal`` is queued
    2-4 rounds later when it fits).

    ``bitflip_prob``/``nan_prob`` mix in the integrity faults (default
    0, which keeps historical scripts bitwise-identical for any given
    seed — the extra draws only happen when a rate is nonzero)."""
    if p0 < p_min:
        raise ValueError(f"p0={p0} below p_min={p_min}")
    p_max = p_max if p_max is not None else 2 * p0
    rng = np.random.default_rng(seed)
    events: List[ChaosEvent] = []
    p = p0
    for r in range(rounds):
        u = rng.random()
        if u < kill_prob and p > p_min:
            events.append(ChaosEvent(r, "kill",
                                     int(rng.integers(p))))
            p -= 1
        elif u < kill_prob + leave_prob and p > p_min:
            events.append(ChaosEvent(r, "leave",
                                     int(rng.integers(p))))
            p -= 1
        elif u < kill_prob + leave_prob + join_prob and p < p_max:
            events.append(ChaosEvent(r, "join"))
            p += 1
        elif u < kill_prob + leave_prob + join_prob + slow_prob:
            events.append(ChaosEvent(
                r, "slow", int(rng.integers(p)),
                factor=float(1.5 + 2.0 * rng.random())))
            heal_at = r + 2 + int(rng.integers(3))
            if heal_at < rounds:
                events.append(ChaosEvent(heal_at, "heal", -1))
        elif bitflip_prob > 0.0 or nan_prob > 0.0:
            base = kill_prob + leave_prob + join_prob + slow_prob
            if u < base + bitflip_prob:
                events.append(ChaosEvent(r, "bitflip"))
            elif u < base + bitflip_prob + nan_prob:
                events.append(ChaosEvent(r, "nan"))
    return events


@dataclasses.dataclass
class ChaosRecovery:
    """What one lifecycle event cost: wall-clock recovery time plus the
    compiled transition's migration footprint (the repack-scales-with-
    moved-shards evidence)."""
    round: int
    action: str
    worker: int
    p_before: int
    p_after: int
    recovery_s: float
    moved_rows: int
    moved_cols: int
    n_transfers: int
    n_transfer_steps: int


@dataclasses.dataclass
class ChaosReport:
    rounds: int
    recoveries: List[ChaosRecovery]
    skipped: List[ChaosEvent]
    rmse: List[float]
    p_final: int

    @property
    def total_recovery_s(self) -> float:
        return float(sum(r.recovery_s for r in self.recoveries))


class ChaosHarness:
    """Drive a streaming session through a chaos script.

    Each round applies that round's events (worker kills route through
    ``session.kill`` — checkpoint restore + replay; departures and joins
    through ``session.resize``), runs ``epochs_per_round`` epochs, and —
    when the session has a straggler monitor — feeds it virtual
    per-worker step timings derived from the packed loads and the
    current slowdown multipliers.

    ``mesh_factory`` (optional, ``p -> McMesh | None``) re-targets the
    SPMD executor onto a mesh of the new worker count at every kill,
    leave or join; by default the engine keeps its current mesh or
    device.  On a mesh every rank of the launch runs the harness alike
    (the factory is called on every rank, e.g.
    ``launch.mesh.make_mc_mesh``): a ``nan`` is written into the shard of
    the rank that holds worker 0 and a ``bitflip`` by the session's lead
    rank, and the divergence sentinel is AND-reduced over the ranks, so a
    rollback happens on every rank or on none.
    """

    def __init__(self, session, events: Sequence[ChaosEvent], *,
                 epochs_per_round: int = 1, seed: int = 0,
                 mesh_factory=None):
        self.session = session
        self.events = sorted(events, key=lambda e: (e.round, e.action))
        self.epochs_per_round = int(epochs_per_round)
        self.mesh_factory = mesh_factory
        self._rng = np.random.default_rng(seed)
        self.speed = np.ones(session.config.p, dtype=np.float64)

    # ----------------------------------------------------------------- #
    def _pick_worker(self, ev: ChaosEvent) -> int:
        p = self.session.config.p
        if ev.worker >= 0:
            if ev.worker >= p:
                raise ValueError(
                    f"event {ev} targets worker {ev.worker} but p={p}")
            return ev.worker
        if ev.action == "heal":
            slow = np.flatnonzero(self.speed < 1.0)
            return int(slow[0]) if len(slow) else 0
        return int(self._rng.integers(p))

    def _remap_speed(self, tr):
        old = np.asarray(tr.old_of_new)
        new = np.ones(tr.p_new, dtype=np.float64)
        live = old >= 0
        new[live] = self.speed[old[live]]
        self.speed = new

    def step_times(self) -> np.ndarray:
        """Virtual per-worker step durations for one epoch: each
        worker's packed nnz (the work it serially applies over the
        schedule) divided by its current speed."""
        br = self.session._ensure_engine().br
        load = br.nnz_cell.sum(axis=1).astype(np.float64) + 1.0
        return load / (load.mean() * self.speed)

    def _apply(self, ev: ChaosEvent, out: ChaosReport):
        sess = self.session
        p = sess.config.p
        if ev.action in ("kill", "leave") and p <= 1:
            out.skipped.append(ev)
            return
        if ev.action == "slow":
            self.speed[self._pick_worker(ev)] /= ev.factor
            return
        if ev.action == "heal":
            self.speed[self._pick_worker(ev)] = 1.0
            return
        if ev.action == "bitflip":
            # corrupt the newest committed checkpoint in place; the next
            # kill-recovery must quarantine it and fall back to the
            # previous verified step (tentpole b); on a mesh its lead
            # rank flips and every rank learns the step
            flipped = None
            if sess.faults is not None:
                launch = sess._launch

                def flip():
                    return bitflip_checkpoint(sess.faults.checkpoint_dir,
                                              seed=ev.round)
                flipped = flip() if launch is None else launch.on_lead(flip)
            if flipped is None:
                out.skipped.append(ev)
            return
        if ev.action == "nan":
            # write a NaN in place into the live factor shards: the
            # sentinel must trip on the next round and the session's
            # DivergencePolicy roll back to the last good factors
            eng = sess._ensure_engine()
            if eng.mesh is None or eng.mesh.rank == 0:
                eng.Ws[0, 0, 0] = float("nan")
            return
        p_next = p - 1 if ev.action in ("kill", "leave") else p + 1
        kw = {} if self.mesh_factory is None else \
            {"mesh": self.mesh_factory(p_next)}
        t0 = time.perf_counter()
        if ev.action == "kill":
            w = self._pick_worker(ev)
            tr = sess.kill(w, **kw)
        elif ev.action == "leave":
            w = self._pick_worker(ev)
            tr = sess.resize(leave=(w,), **kw)
        else:                                   # join
            w = p
            tr = sess.resize(join=1, **kw)
        dt = time.perf_counter() - t0
        self._remap_speed(tr)
        out.recoveries.append(ChaosRecovery(
            round=ev.round, action=ev.action, worker=w,
            p_before=tr.p_old, p_after=tr.p_new, recovery_s=dt,
            moved_rows=len(tr.moved_rows), moved_cols=len(tr.moved_cols),
            n_transfers=len(tr.transfers()),
            n_transfer_steps=len(tr.transfer_steps())))

    # ----------------------------------------------------------------- #
    def run(self, rounds: Optional[int] = None) -> ChaosReport:
        rounds = rounds if rounds is not None else (
            max((e.round for e in self.events), default=-1) + 1)
        report = ChaosReport(rounds=rounds, recoveries=[], skipped=[],
                             rmse=[], p_final=self.session.config.p)
        i = 0
        for r in range(rounds):
            while i < len(self.events) and self.events[i].round <= r:
                self._apply(self.events[i], report)
                i += 1
            res = self.session.fit(epochs=self.epochs_per_round)
            if len(res.trace_rmse):
                report.rmse.append(float(res.trace_rmse[-1]))
            if self.session._monitor is not None:
                flagged = self.session.observe_step_times(self.step_times())
                if self.session.config.p != len(self.speed):
                    # the monitor ejected: drop the flagged workers'
                    # speed entries (survivors keep old-id order)
                    self.speed = np.delete(self.speed, flagged)
        report.p_final = self.session.config.p
        return report
