"""One front door for matrix completion: problem + config -> result.

The port's subset of the JAX package's API, same names and fields:

* :class:`MCProblem`    — immutable dataset container (COO train + held-out
                          test/val, sizes, dtype) that owns *packing*:
                          ``problem.packed(p, waves=..., sub_blocks=...)``
                          memoizes the ``BlockedRatings``.
* :class:`SolverConfig` — frozen per-solver hyperparameter records
                          (:class:`NomadConfig`, :class:`DsgdConfig`,
                          :class:`CcdConfig`, :class:`AlsConfig`,
                          :class:`HogwildConfig`); invalid combinations
                          fail at construction.
* :class:`AsyncSimConfig` — the discrete-event simulator of Algorithm 1
                          (host, float64); ``emit_schedule`` compiles
                          its run into an ``OwnershipSchedule`` the
                          engine replays.
* :class:`FitResult`    — factors, per-epoch trace as arrays, wall time,
                          and the exact config; pass one back as
                          ``warm_start=`` to resume.
* :class:`ProblemDelta` — an arrival batch (``problem.extend(...)``),
                          consumed by :func:`partial_fit` and
                          :class:`StreamingSession`.
* :class:`FaultPolicy` / :class:`DivergencePolicy` — checkpointed,
                          resumable runs (``solve(..., faults=)``), kill
                          recovery and divergence rollback.

``solve(problem, config, *, device=None)`` dispatches through the
``@register_solver`` registry; ``device=None`` means ``"cuda"`` and
raises ``RuntimeError`` where CUDA is unavailable.  :func:`partial_fit`
and :class:`StreamingSession` take ``device=`` the same way.

    >>> from repro_torch import api
    >>> problem = api.MCProblem.synthetic(m=2000, n=400, nnz=80_000, k=16)
    >>> res = api.solve(problem, api.NomadConfig(k=16, p=8,
    ...                                          kernel="wave_pallas"))
    >>> res.rmse[-1], res.wall_time

NOMAD, every baseline of the paper (DSGD, CCD++, ALS, Hogwild,
:mod:`repro_torch.core.baselines`) and the simulator run through this one
call.  NOMAD, DSGD and Hogwild stream; CCD++, ALS and the simulator
refuse ``partial_fit`` with ``NotImplementedError``, as in the JAX
package.  ``mesh=`` (a :class:`repro_torch.launch.mesh.McMesh`) runs
NOMAD's SPMD executor, one process per worker, in ``solve`` (with or
without ``faults=``), ``partial_fit`` and :class:`StreamingSession`,
whose ``resize``/``kill`` move it onto a new mesh; the other solvers
accept the mesh and ignore it, as in the JAX package.  Every rank of the
launch makes the same calls and gets the same results, bitwise those of
one device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import shutil
import tempfile
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple, Type, Union

import numpy as np
import torch

from ._device import resolve_device
from .core import partition as part
from .core.schedule import (OwnershipSchedule, SCHEDULE_NAMES,
                            TransitionSchedule, compile_transition)
from .core.stepsize import PowerSchedule
from .core.topology import NetworkModel
from .kernels.policy import KernelPolicy
from .runtime.chaos import DegradedLink
from .runtime.transport import TransportConfig

__all__ = [
    "MCProblem", "ProblemDelta", "SolverConfig", "NomadConfig",
    "DsgdConfig", "CcdConfig", "AlsConfig", "HogwildConfig",
    "AsyncSimConfig", "FitResult", "KernelPolicy", "OwnershipSchedule", "TransitionSchedule",
    "FaultPolicy", "DivergencePolicy", "DivergenceError", "solve",
    "register_solver", "solver_names", "config_for", "partial_fit",
    "register_partial_fit", "supports_partial_fit",
    "streaming_solver_names", "StreamingSession",
]

# ---------------------------------------------------------------------- #
# Problem container                                                       #
# ---------------------------------------------------------------------- #

def _frozen_coo(rows, cols, vals) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    # preserve incoming index/value dtypes; only non-numeric inputs are
    # promoted to the canonical wide types
    r = np.array(rows, copy=True)
    c = np.array(cols, copy=True)
    v = np.array(vals, copy=True)
    if r.dtype.kind not in "iu":
        r = r.astype(np.int64)
    if c.dtype.kind not in "iu":
        c = c.astype(np.int64)
    if v.dtype.kind != "f":
        v = v.astype(np.float64)
    if not (len(r) == len(c) == len(v)):
        raise ValueError("rows/cols/vals length mismatch: "
                         f"{len(r)}/{len(c)}/{len(v)}")
    for a in (r, c, v):
        a.flags.writeable = False
    return r, c, v


@dataclasses.dataclass(frozen=True, eq=False)
class MCProblem:
    """Immutable matrix-completion dataset (COO train / val / test).

    Owns packing: :meth:`packed` memoizes the blocked layouts per
    ``(p, balanced, waves, wave_width, sub_blocks, schedule)`` so every
    solver shares one pack instead of re-running the O(nnz) coloring.
    """
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    m: int
    n: int
    test: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    val: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    dtype: Any = np.float32
    #: optional explicit partition maps (row -> worker, col -> item block)
    #: honored by :meth:`packed`; the streaming layer pins these to the
    #: sticky assignment an incremental re-pack keeps, so a batch refit of
    #: an extended problem executes the identical serial order
    row_assign: Optional[np.ndarray] = None
    col_assign: Optional[np.ndarray] = None
    #: optional pinned ownership schedule: when set, :meth:`packed` lays
    #: out for exactly this schedule regardless of the spec it is called
    #: with (keeps a streaming chain and its batch comparators on one
    #: schedule)
    schedule_pin: Optional[OwnershipSchedule] = None

    def __post_init__(self):
        r, c, v = _frozen_coo(self.rows, self.cols, self.vals)
        object.__setattr__(self, "rows", r)
        object.__setattr__(self, "cols", c)
        object.__setattr__(self, "vals", v)
        self._check_bounds("train", r, c)
        for name in ("test", "val"):
            split = getattr(self, name)
            if split is not None:
                split = _frozen_coo(*split)
                self._check_bounds(name, split[0], split[1])
                object.__setattr__(self, name, split)
        for name, count in (("row_assign", self.m), ("col_assign", self.n)):
            assign = getattr(self, name)
            if assign is not None:
                assign = np.array(assign, dtype=np.int32, copy=True)
                if assign.shape != (count,):
                    raise ValueError(
                        f"{name} must have shape ({count},), got "
                        f"{assign.shape}")
                assign.flags.writeable = False
                object.__setattr__(self, name, assign)
        if self.schedule_pin is not None and not isinstance(
                self.schedule_pin, OwnershipSchedule):
            raise TypeError(
                f"schedule_pin must be an OwnershipSchedule, got "
                f"{type(self.schedule_pin).__name__}")
        object.__setattr__(self, "_pack_cache", {})

    def _check_bounds(self, which, r, c):
        # out-of-range indices would index the wrong factor rows: fail
        # here, at construction
        if len(r) and (r.min() < 0 or c.min() < 0
                       or r.max() >= self.m or c.max() >= self.n):
            raise ValueError(
                f"{which} rating indices out of range for matrix shape "
                f"({self.m}, {self.n})")

    # -------------------------------------------------------------- #
    @property
    def nnz(self) -> int:
        return len(self.rows)

    @property
    def train(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.rows, self.cols, self.vals

    @staticmethod
    def _pack_key(p, balanced, waves, wave_width, sub_blocks,
                  schedule=None, schedule_seed=0):
        """The memo-cache key of :meth:`packed`.  Equivalent ring specs
        (``None``, ``"ring"``, an explicit ring schedule) normalize to
        one key so the default packing is never computed twice."""
        if schedule is None:
            schedule = "ring"
        elif isinstance(schedule, OwnershipSchedule):
            if schedule.is_ring:
                schedule = "ring"
            else:
                schedule_seed = 0   # seed only feeds the named specs
        if schedule == "ring":
            schedule_seed = 0
        return (p, balanced, waves, wave_width, sub_blocks,
                schedule, schedule_seed)

    def packed(self, p: int, *, balanced: bool = True, waves: bool = False,
               wave_width: Optional[int] = None, sub_blocks: int = 1,
               schedule: Union[str, OwnershipSchedule, None] = None,
               schedule_seed: int = 0) -> part.BlockedRatings:
        """Memoized ``partition.pack`` of the training ratings.

        ``schedule`` selects the ownership-transfer order the cells are
        laid out for (``None``/``"ring"``/``"random"``/``"balanced"`` or
        an explicit ``OwnershipSchedule``).  A :attr:`schedule_pin`
        overrides it."""
        if self.schedule_pin is not None:
            schedule = self.schedule_pin
        key = self._pack_key(p, balanced, waves, wave_width, sub_blocks,
                             schedule, schedule_seed)
        cache = self._pack_cache
        if key not in cache:
            cache[key] = part.pack(
                self.rows, self.cols, self.vals, self.m, self.n, p,
                balanced=balanced, waves=waves, wave_width=wave_width,
                sub_blocks=sub_blocks, row_owner=self.row_assign,
                col_block=self.col_assign, schedule=schedule,
                schedule_seed=schedule_seed)
        return cache[key]

    def extend(self, rows=(), cols=(), vals=(), *, m_new: int = 0,
               n_new: int = 0, test=None) -> "ProblemDelta":
        """Describe an arrival batch: new ratings (COO over the *extended*
        ``(m + m_new, n + n_new)`` index space) and/or new rows/columns.
        Returns a cheap :class:`ProblemDelta` view — nothing is copied or
        re-packed until a solver consumes it (``partial_fit`` /
        ``StreamingSession``) or :meth:`ProblemDelta.extended`
        materializes the concatenated problem.  ``test`` optionally
        appends held-out ratings for the new index space."""
        return ProblemDelta(base=self, rows=rows, cols=cols, vals=vals,
                            m_new=m_new, n_new=n_new, test=test)

    # -------------------------------------------------------------- #
    @classmethod
    def from_coo(cls, rows, cols, vals, m: int, n: int, *,
                 test=None, val=None, dtype=np.float32) -> "MCProblem":
        return cls(rows=rows, cols=cols, vals=vals, m=m, n=n, test=test,
                   val=val, dtype=dtype)

    @classmethod
    def synthetic(cls, m: int, n: int, nnz: int, k: int = 16, *,
                  seed: int = 0, noise: float = 0.05,
                  test_frac: float = 0.1,
                  split_seed: int = 0) -> "MCProblem":
        """Netflix-shaped synthetic problem with a held-out test split."""
        from .data.synthetic import synthetic_ratings, train_test_split
        rows, cols, vals, _, _ = synthetic_ratings(
            m, n, nnz, k=k, seed=seed, noise=noise)
        if test_frac > 0:
            train, test = train_test_split(rows, cols, vals,
                                           test_frac=test_frac,
                                           seed=split_seed)
            return cls(rows=train[0], cols=train[1], vals=train[2],
                       m=m, n=n, test=test)
        return cls(rows=rows, cols=cols, vals=vals, m=m, n=n)


# ---------------------------------------------------------------------- #
# Streaming deltas                                                        #
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True, eq=False)
class ProblemDelta:
    """An arrival batch against a base :class:`MCProblem`: ``m_new`` /
    ``n_new`` appended rows/columns plus new COO ratings indexed in the
    *extended* ``(base.m + m_new, base.n + n_new)`` space.

    This is the unit ``partial_fit`` consumes.  It stays a view — the
    concatenated problem is only materialized by :meth:`extended` (and
    memoized), and the incremental re-pack never materializes it at all.
    """
    base: MCProblem
    rows: np.ndarray = ()
    cols: np.ndarray = ()
    vals: np.ndarray = ()
    m_new: int = 0
    n_new: int = 0
    #: extra held-out ratings appended to ``base.test``
    test: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None

    def __post_init__(self):
        if not isinstance(self.base, MCProblem):
            raise TypeError(
                f"base must be MCProblem, got {type(self.base).__name__}")
        if self.m_new < 0 or self.n_new < 0:
            raise ValueError(
                f"m_new/n_new must be >= 0, got {self.m_new}/{self.n_new}")
        r, c, v = _frozen_coo(self.rows, self.cols, self.vals)
        object.__setattr__(self, "rows", r)
        object.__setattr__(self, "cols", c)
        object.__setattr__(self, "vals", v)
        self._check_bounds("delta train", r, c)
        if self.test is not None:
            split = _frozen_coo(*self.test)
            self._check_bounds("delta test", split[0], split[1])
            object.__setattr__(self, "test", split)
        if self.nnz == 0 and self.m_new == 0 and self.n_new == 0 \
                and self.test is None:
            raise ValueError("empty delta: no new ratings, rows, columns "
                             "or test ratings")
        object.__setattr__(self, "_ext_cache", {})

    def _check_bounds(self, which, r, c):
        if len(r) and (r.min() < 0 or c.min() < 0
                       or r.max() >= self.m or c.max() >= self.n):
            raise ValueError(
                f"{which} rating indices out of range for extended shape "
                f"({self.m}, {self.n})")

    # -------------------------------------------------------------- #
    @property
    def m(self) -> int:
        return self.base.m + self.m_new

    @property
    def n(self) -> int:
        return self.base.n + self.n_new

    @property
    def nnz(self) -> int:
        return len(self.rows)

    @property
    def merged_test(self):
        """``base.test`` with the delta's extra held-out ratings appended
        (or whichever of the two exists)."""
        if self.test is None:
            return self.base.test
        if self.base.test is None:
            return self.test
        return tuple(np.concatenate([a, b])
                     for a, b in zip(self.base.test, self.test))

    def extended(self, *, row_assign=None, col_assign=None,
                 schedule_pin=None) -> MCProblem:
        """Materialize the concatenated problem (the default call is
        memoized; pinned builds are not).  ``row_assign``/``col_assign``
        pin an explicit partition and ``schedule_pin`` an explicit
        ownership schedule — the streaming layer passes the sticky
        assignment and schedule from the incremental re-pack so a batch
        ``solve`` of this problem runs the identical serial order."""
        plain = (row_assign is None and col_assign is None
                 and schedule_pin is None)
        if plain and "ext" in self._ext_cache:
            return self._ext_cache["ext"]
        prob = MCProblem(
            rows=np.concatenate([self.base.rows, self.rows]),
            cols=np.concatenate([self.base.cols, self.cols]),
            vals=np.concatenate([self.base.vals, self.vals]),
            m=self.m, n=self.n, test=self.merged_test,
            val=self.base.val, dtype=self.base.dtype,
            row_assign=row_assign, col_assign=col_assign,
            schedule_pin=schedule_pin)
        if plain:
            self._ext_cache["ext"] = prob
        return prob


# ---------------------------------------------------------------------- #
# Solver configs                                                          #
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Hyperparameters shared by every solver.  Frozen: validation happens
    once, at construction.  ``stepsize`` is the per-epoch SGD step-size
    schedule, eq. (11) (a ``PowerSchedule`` passed as ``schedule=`` still
    works, with a ``DeprecationWarning``)."""
    k: int = 16
    lam: float = 0.05
    epochs: float = 10
    seed: int = 0
    stepsize: Optional[PowerSchedule] = None
    #: deprecated alias of ``stepsize`` (accepts a ``PowerSchedule``
    #: only); :class:`NomadConfig` re-purposes the field as the
    #: ownership-transfer schedule spec
    schedule: Any = None

    #: epoch-based solvers require integral epochs; only the simulator
    #: (virtual time) can stop mid-epoch
    _fractional_epochs = False
    #: NomadConfig flips this: its ``schedule`` field selects the
    #: OwnershipSchedule instead of erroring on leftover values
    _schedule_is_ownership = False

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.epochs < 0:
            raise ValueError(f"epochs must be >= 0, got {self.epochs}")
        if not self._fractional_epochs and self.epochs != int(self.epochs):
            raise ValueError(
                f"epochs must be integral for {type(self).__name__}, got "
                f"{self.epochs} (fractional epochs exist only for "
                "AsyncSimConfig)")
        if isinstance(self.schedule, PowerSchedule):
            # the warning points at the caller: above this frame sit one
            # super().__post_init__ frame per overriding subclass, then
            # the dataclass-generated __init__
            depth = sum(1 for klass in type(self).__mro__
                        if "__post_init__" in vars(klass)
                        and klass is not SolverConfig)
            warnings.warn(
                f"{type(self).__name__}(schedule=PowerSchedule(...)) is "
                "deprecated; the step-size schedule is now `stepsize=`"
                + (" (`schedule=` selects the ownership-transfer order)"
                   if self._schedule_is_ownership else ""),
                DeprecationWarning, stacklevel=3 + depth)
            if self.stepsize is not None:
                raise ValueError(
                    "both stepsize= and a PowerSchedule passed as "
                    "schedule=; use stepsize= only")
            object.__setattr__(self, "stepsize", self.schedule)
            object.__setattr__(
                self, "schedule",
                type(self).__dataclass_fields__["schedule"].default)
        elif self.schedule is not None and not self._schedule_is_ownership:
            raise ValueError(
                f"{type(self).__name__} has no ownership schedule; "
                "schedule= accepts only a legacy PowerSchedule (the "
                "step-size schedule, now spelled stepsize=)")

    def make_stepsize(self) -> PowerSchedule:
        return self.stepsize or PowerSchedule()


@dataclasses.dataclass(frozen=True)
class NomadConfig(SolverConfig):
    """NOMAD engine.  ``kernel`` is a :class:`KernelPolicy` or a legacy
    impl string (``"wave_pallas"`` is the CUDA wave kernel, one launch
    per schedule step); ``sub_blocks`` and ``dtype_policy``
    (``'fp32'``/``'bf16'``/``'fp16'`` factor storage with fp32
    accumulation) merge into the policy.

    ``schedule`` selects the ownership-transfer order: ``"ring"``,
    ``"random"`` (``schedule_seed`` seeds it), ``"balanced"``, or an
    explicit :class:`OwnershipSchedule`.

    ``dispatch`` selects the training driver: ``"fused"`` (default)
    syncs with the host once per ``fuse_epochs`` block (``None`` = all
    epochs in one), ``"loop"`` once per epoch.  Both record the held-out
    RMSE every ``record_every`` epochs (plus always the final one) and
    are bitwise-identical in W, H and trace."""
    p: int = 4
    kernel: Union[str, KernelPolicy] = "xla"
    balanced: bool = True
    sub_blocks: int = 1
    dtype_policy: str = "fp32"
    schedule: Union[str, OwnershipSchedule] = "ring"
    schedule_seed: int = 0
    dispatch: str = "fused"
    fuse_epochs: Optional[int] = None
    record_every: int = 1

    _schedule_is_ownership = True

    def __post_init__(self):
        super().__post_init__()   # legacy PowerSchedule-as-schedule shim
        if self.p < 1:
            raise ValueError(f"p must be >= 1, got {self.p}")
        if self.dispatch not in ("fused", "loop"):
            raise ValueError(
                f"dispatch={self.dispatch!r} not in ('fused', 'loop')")
        if self.fuse_epochs is not None and self.fuse_epochs < 1:
            raise ValueError(
                f"fuse_epochs must be >= 1 (or None for one block), "
                f"got {self.fuse_epochs}")
        if self.record_every < 1:
            raise ValueError(
                f"record_every must be >= 1, got {self.record_every}")
        if self.schedule is None:  # None == ring everywhere (resolve/pack)
            object.__setattr__(self, "schedule", "ring")
        if isinstance(self.schedule, OwnershipSchedule):
            if self.schedule.p != self.p:
                raise ValueError(
                    f"schedule is for p={self.schedule.p}, but config has "
                    f"p={self.p}")
        elif self.schedule not in SCHEDULE_NAMES:
            raise ValueError(
                f"schedule={self.schedule!r} not in {SCHEDULE_NAMES} (or "
                "pass an OwnershipSchedule)")
        # coercion validates impl x sub_blocks x dtype_policy at
        # construction time (and mirrors any merged/downgraded value
        # back onto the flat config fields)
        object.__setattr__(self, "kernel",
                           KernelPolicy.coerce(
                               self.kernel, sub_blocks=self.sub_blocks,
                               dtype_policy=self.dtype_policy))
        object.__setattr__(self, "sub_blocks", self.kernel.sub_blocks)
        object.__setattr__(self, "dtype_policy", self.kernel.dtype_policy)


@dataclasses.dataclass(frozen=True)
class DsgdConfig(SolverConfig):
    """Bulk-synchronous DSGD [Gemulla et al., 2011]."""
    p: int = 4

    def __post_init__(self):
        super().__post_init__()
        if self.p < 1:
            raise ValueError(f"p must be >= 1, got {self.p}")


@dataclasses.dataclass(frozen=True)
class CcdConfig(SolverConfig):
    """CCD++ [Yu et al., 2012] feature-wise coordinate descent."""
    inner: int = 3

    def __post_init__(self):
        super().__post_init__()
        if self.inner < 1:
            raise ValueError(f"inner must be >= 1, got {self.inner}")


@dataclasses.dataclass(frozen=True)
class AlsConfig(SolverConfig):
    """Exact alternating least squares [Zhou et al., 2008]."""


@dataclasses.dataclass(frozen=True)
class HogwildConfig(SolverConfig):
    """Lock-free racing minibatch SGD [Recht et al., 2011] — the
    non-serializable contrast class."""
    batch: int = 256

    def __post_init__(self):
        super().__post_init__()
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")


@dataclasses.dataclass(frozen=True)
class AsyncSimConfig(SolverConfig):
    """Discrete-event simulator of Algorithm 1 (virtual time, real
    float64 numerics).  ``mode`` selects NOMAD, bulk-synchronous DSGD, or
    DSGD++ with communication overlap; ``epochs`` may be fractional."""
    p: int = 4
    a: float = 1.0                 # per-rating processing cost (x k)
    c: float = 20.0                # per-item communication latency (x k)
    mode: str = "nomad"            # 'nomad' | 'dsgd' | 'dsgd++'
    _fractional_epochs = True
    load_balance: bool = False
    speed: Optional[Tuple[float, ...]] = None
    failures: Tuple[Tuple[float, int], ...] = ()
    #: worker rejoin events ``((virtual_time, worker), ...)`` — the dual
    #: of ``failures``: a previously-failed worker comes back, steals a
    #: balanced share of rows, and re-enters the routing pool (the full
    #: elastic lifecycle; NOMAD mode only)
    rejoins: Tuple[Tuple[float, int], ...] = ()
    record_every: float = 0.5
    #: rating-arrival events ``((virtual_time, (rating ids...)), ...)``:
    #: the listed training ratings stay invisible until their batch's
    #: virtual time (streaming workload; NOMAD mode only)
    arrivals: Tuple[Tuple[float, Tuple[int, ...]], ...] = ()
    #: compile the simulated run's ownership transfers into a replayable
    #: ``OwnershipSchedule`` (``FitResult.extras["schedule"]``; NOMAD
    #: mode only) — feed it back as ``NomadConfig(schedule=...)`` to
    #: replay the predicted routing on the real engine
    emit_schedule: bool = False
    #: physical network model (DESIGN.md §12): ``None`` keeps the flat
    #: §3.2 ``c * k`` pricing bitwise; a
    #: :class:`~repro_torch.core.topology.NetworkModel` (e.g.
    #: :class:`~repro_torch.core.topology.HierarchicalMesh`) prices every item
    #: transfer by placement, with link contention in virtual time —
    #: for NOMAD every ``"arrive"`` hop, for DSGD/DSGD++ the per-sub-
    #: epoch block-shipment barrier
    topology: Optional[NetworkModel] = None
    #: integrity transport (DESIGN.md §14): ``None`` ships nomadic items
    #: over the historical perfect channel (the zero-cost path — results
    #: stay bitwise).  A :class:`~repro_torch.runtime.transport.TransportConfig`
    #: seals every ownership transfer in a sequence-numbered CRC32
    #: envelope; counters land in ``FitResult.extras["transport"]``.
    #: Without ``link_faults`` results are *still* bitwise-identical to
    #: ``transport=None`` — asserted in tests/test_transport.py.
    transport: Optional[TransportConfig] = None
    #: :class:`~repro_torch.runtime.chaos.DegradedLink` message-fault model
    #: (drop / duplicate / reorder / corrupt / delay, scripted windows +
    #: seeded background rates; NOMAD mode only).  Implies ``transport``:
    #: the full at-least-once machinery runs — acknowledgement hops,
    #: exponential-backoff retransmits, receiver-side dedup — and every
    #: fault script still yields an exactly-serializable history.
    link_faults: Optional[DegradedLink] = None

    def __post_init__(self):
        super().__post_init__()
        if self.p < 1:
            raise ValueError(f"p must be >= 1, got {self.p}")
        if self.transport is not None and not isinstance(
                self.transport, TransportConfig):
            raise TypeError(
                f"transport must be a TransportConfig, got "
                f"{type(self.transport).__name__}")
        if self.link_faults is not None:
            if not isinstance(self.link_faults, DegradedLink):
                raise TypeError(
                    f"link_faults must be a DegradedLink, got "
                    f"{type(self.link_faults).__name__}")
            if self.mode != "nomad":
                raise ValueError(
                    "link_faults are only simulated for mode='nomad' "
                    "(the bulk-synchronous baselines ship whole blocks "
                    "at barriers)")
        if self.topology is not None:
            if not isinstance(self.topology, NetworkModel):
                raise TypeError(
                    f"topology must be a NetworkModel, got "
                    f"{type(self.topology).__name__}")
            t_p = getattr(self.topology, "p", None)
            if t_p is not None and t_p != self.p:
                raise ValueError(
                    f"topology is for p={t_p}, but config has p={self.p}")
        if self.emit_schedule and self.mode != "nomad":
            raise ValueError(
                "emit_schedule requires mode='nomad' (the bulk-"
                "synchronous baselines already execute a fixed schedule)")
        if self.mode not in ("nomad", "dsgd", "dsgd++"):
            raise ValueError(
                f"mode={self.mode!r} not in ('nomad', 'dsgd', 'dsgd++')")
        if self.speed is not None:
            object.__setattr__(self, "speed", tuple(float(s)
                                                    for s in self.speed))
            if len(self.speed) != self.p:
                raise ValueError(
                    f"speed has {len(self.speed)} entries for p={self.p}")
        if self.rejoins:
            if self.mode != "nomad":
                raise ValueError(
                    "rejoins are only simulated for mode='nomad' (the "
                    "bulk-synchronous baselines have no elastic "
                    "lifecycle)")
            object.__setattr__(self, "rejoins", tuple(
                (float(t), int(q)) for t, q in self.rejoins))
            if any(t < 0 for t, _ in self.rejoins):
                raise ValueError("rejoin times must be >= 0")
            if any(q < 0 or q >= self.p for _, q in self.rejoins):
                raise ValueError(f"rejoin workers must lie in [0, {self.p})")
        if self.arrivals:
            if self.mode != "nomad":
                raise ValueError(
                    "arrivals are only simulated for mode='nomad' (the "
                    "bulk-synchronous baselines re-pack per epoch)")
            object.__setattr__(self, "arrivals", tuple(
                (float(t), tuple(int(g) for g in ids))
                for t, ids in self.arrivals))
            if any(t < 0 for t, _ in self.arrivals):
                raise ValueError("arrival times must be >= 0")

    def to_sim_config(self):
        from .core.async_sim import SimConfig
        return SimConfig(
            p=self.p, k=self.k, lam=self.lam,
            schedule=self.make_stepsize(), a=self.a, c=self.c,
            epochs=float(self.epochs), load_balance=self.load_balance,
            speed=(None if self.speed is None
                   else np.asarray(self.speed, dtype=np.float64)),
            failures=self.failures, rejoins=self.rejoins, seed=self.seed,
            record_every=self.record_every, arrivals=self.arrivals,
            topology=self.topology, transport=self.transport,
            link_faults=self.link_faults)


# ---------------------------------------------------------------------- #
# Fault tolerance policy                                                  #
# ---------------------------------------------------------------------- #

class DivergenceError(RuntimeError):
    """A run kept diverging after exhausting
    :attr:`DivergencePolicy.max_rollbacks` rollback/backoff retries."""


@dataclasses.dataclass(frozen=True)
class DivergencePolicy:
    """Quarantine-and-retry for numerically diverged runs.  The fused
    driver's on-device sentinel (``NomadRingEngine.last_finite``, in
    ``FitResult.extras["divergence"]["finite"]``) trips on any
    non-finite factor entry; ``spike_factor`` additionally trips when a
    block's final held-out RMSE exceeds ``spike_factor`` × the last good
    block's.  On trip: roll back to the last good state (checkpoint /
    session round), multiply the step-size schedule's ``alpha`` by
    ``backoff``, and retry — up to ``max_rollbacks`` times, then raise
    :class:`DivergenceError`.

    Detection is deterministic (same factors, same schedule → same
    trip), so a crash-resumed run replays the same rollbacks and lands
    on the same state."""
    max_rollbacks: int = 2
    backoff: float = 0.5
    spike_factor: Optional[float] = None

    def __post_init__(self):
        if self.max_rollbacks < 1:
            raise ValueError(
                f"max_rollbacks must be >= 1, got {self.max_rollbacks}")
        if not (0.0 < self.backoff < 1.0):
            raise ValueError(
                f"backoff must be in (0, 1), got {self.backoff}")
        if self.spike_factor is not None and self.spike_factor <= 1.0:
            raise ValueError(
                f"spike_factor must be > 1, got {self.spike_factor}")

    def tripped(self, result: "FitResult",
                ref_rmse: Optional[float]) -> bool:
        """Did ``result`` diverge relative to the last good RMSE?"""
        div = result.extras.get("divergence", {})
        if not div.get("finite", True):
            return True
        if (self.spike_factor is not None and ref_rmse is not None
                and len(result.trace_rmse)
                and np.isfinite(ref_rmse)):
            last = float(result.trace_rmse[-1])
            if not np.isfinite(last) \
                    or last > self.spike_factor * ref_rmse:
                return True
        return False

    def backed_off(self, config: "SolverConfig",
                   rollbacks: int) -> "SolverConfig":
        """``config`` with the step-size alpha scaled by
        ``backoff ** rollbacks``."""
        if rollbacks == 0:
            return config
        sched = config.make_stepsize()
        return dataclasses.replace(
            config, stepsize=dataclasses.replace(
                sched, alpha=sched.alpha * self.backoff ** rollbacks))


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """How a run survives worker failures.

    Passed as ``solve(..., faults=)`` — chunk the run into
    ``checkpoint_every``-epoch blocks, atomically checkpoint after each,
    and transparently resume from the last committed block after a crash
    (bitwise-identical to the uninterrupted run: fused block boundaries
    are exact resume points) — or as ``StreamingSession(..., faults=)``,
    where it additionally enables :meth:`StreamingSession.kill` (recover
    dead workers from the last checkpoint + round replay) and the
    live straggler policy (:meth:`StreamingSession.observe_step_times`).
    """
    #: checkpoint directory (created on first save)
    checkpoint_dir: str
    #: epochs (``solve``) / session rounds between checkpoints
    checkpoint_every: int = 1
    #: committed checkpoints retained (older ones are GC'd)
    keep: int = 3
    #: resume from the latest committed checkpoint when one exists
    resume: bool = True
    #: feed ``observe_step_times`` into a :class:`StragglerMonitor`
    monitor: bool = False
    #: monitor flag threshold (x median EWMA step time)
    threshold: float = 1.5
    #: gracefully resize flagged stragglers out of the cluster
    eject: bool = False
    #: re-route the ownership schedule by live speed estimates
    #: (``OwnershipSchedule.balanced`` weighted by 1/speed)
    adapt_schedule: bool = False
    #: numerical-divergence quarantine: on a tripped
    #: sentinel, roll back to the last good checkpoint / session round,
    #: back the step size off and retry
    divergence: Optional[DivergencePolicy] = None

    def __post_init__(self):
        if not self.checkpoint_dir:
            raise ValueError("FaultPolicy requires a checkpoint_dir")
        if self.divergence is not None and not isinstance(
                self.divergence, DivergencePolicy):
            raise TypeError(
                f"divergence must be a DivergencePolicy, got "
                f"{type(self.divergence).__name__}")
        if self.checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got "
                f"{self.checkpoint_every}")
        if self.keep < 1:
            raise ValueError(f"keep must be >= 1, got {self.keep}")
        if self.threshold <= 1.0:
            raise ValueError(
                f"threshold must be > 1 (x median), got {self.threshold}")


# ---------------------------------------------------------------------- #
# Result                                                                  #
# ---------------------------------------------------------------------- #

@dataclasses.dataclass
class FitResult:
    """What every solver returns: factors, trace arrays, timings, and the
    exact config for reproducibility.  Pass back as ``warm_start=`` to
    resume (the step-size schedule continues from ``epochs_done``, so
    split runs are bitwise-identical to one run)."""
    W: np.ndarray
    H: np.ndarray
    trace_epochs: np.ndarray        # per-record epoch number
    trace_rmse: np.ndarray          # per-record held-out RMSE
    epochs_done: float              # cumulative epochs incl. warm start
    wall_time: float = 0.0
    virtual_time: Optional[float] = None   # simulator virtual clock
    solver: str = ""
    config: Optional[SolverConfig] = None
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def trace(self) -> List[Tuple[Any, float]]:
        """Legacy ``[(epoch, rmse), ...]`` view of the trace arrays."""
        return list(zip(self.trace_epochs.tolist(),
                        self.trace_rmse.tolist()))

    @property
    def rmse(self) -> np.ndarray:
        return self.trace_rmse


def _as_trace_arrays(trace):
    if not trace:
        return np.asarray([], dtype=np.int64), np.asarray([],
                                                          dtype=np.float64)
    epochs = np.asarray([t[0] for t in trace])
    rmses = np.asarray([float(t[-1]) for t in trace], dtype=np.float64)
    return epochs, rmses


# ---------------------------------------------------------------------- #
# Registry                                                                #
# ---------------------------------------------------------------------- #

_SOLVERS: Dict[Type[SolverConfig], Tuple[str, Callable]] = {}
_BY_NAME: Dict[str, Type[SolverConfig]] = {}


def register_solver(name: str, config_cls: Type[SolverConfig]):
    """Register ``fn(problem, config, *, warm_start, verbose, device,
    mesh) -> FitResult`` as the solver for ``config_cls`` (and for lookups by
    ``name``)."""
    def deco(fn):
        if name in _BY_NAME:
            raise ValueError(f"solver {name!r} already registered")
        if config_cls in _SOLVERS:
            raise ValueError(
                f"config type {config_cls.__name__} already registered")
        _SOLVERS[config_cls] = (name, fn)
        _BY_NAME[name] = config_cls
        return fn
    return deco


def solver_names() -> List[str]:
    """Names of all registered solvers."""
    return sorted(_BY_NAME)


def config_for(name: str) -> Type[SolverConfig]:
    """Config class registered under ``name``."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise KeyError(
            f"no solver named {name!r}; available: {solver_names()}"
        ) from None


def _mesh_device(mesh, device):
    """``device``, or the mesh's device when there is a mesh and no
    ``device``; refuses a mesh that is not an ``McMesh``."""
    from .core.nomad import _check_mesh
    _check_mesh(mesh)
    return mesh.device if mesh is not None and device is None else device


def solve(problem: MCProblem, config: SolverConfig, *, mesh=None,
          warm_start: Optional[FitResult] = None,
          verbose: bool = False, faults: Optional["FaultPolicy"] = None,
          device: Optional[Union[str, torch.device]] = None) -> FitResult:
    """Run the solver registered for ``type(config)`` on ``problem``.

    ``warm_start`` — a previous :class:`FitResult` to resume from.
    ``faults``     — a :class:`FaultPolicy`: run in checkpointed blocks
                     and resume from the last committed block after a
                     crash, bitwise-identical to the uninterrupted run
                     (on a mesh too: one rank writes each block,
                     ``faults.checkpoint_dir`` must be seen by every
                     rank).
    ``device``     — where the factors live and the updates run; ``None``
                     means ``"cuda"`` (``RuntimeError`` without CUDA), or
                     the mesh's device when there is a mesh.
    ``mesh``       — a :class:`repro_torch.launch.mesh.McMesh`: NOMAD runs
                     its SPMD executor, one rank per process; every rank
                     calls ``solve`` with the same problem and config and
                     gets the same result, bitwise the one-device run's.
                     The other solvers accept it and ignore it, as the
                     JAX package's do.
    """
    if not isinstance(problem, MCProblem):
        raise TypeError(f"problem must be MCProblem, got "
                        f"{type(problem).__name__}")
    device = resolve_device(_mesh_device(mesh, device))
    if faults is not None:
        if not isinstance(faults, FaultPolicy):
            raise TypeError(f"faults must be FaultPolicy, got "
                            f"{type(faults).__name__}")
        t0 = time.perf_counter()
        result = _solve_faulted(problem, config, warm_start=warm_start,
                                verbose=verbose, faults=faults,
                                device=device, mesh=mesh)
        return _finalize(result, config, t0)
    entry = None
    for cls in type(config).__mro__:
        if cls in _SOLVERS:
            entry = _SOLVERS[cls]
            break
    if entry is None:
        raise KeyError(
            f"no solver registered for {type(config).__name__}; "
            f"available: {solver_names()}")
    _, fn = entry
    t0 = time.perf_counter()
    result = fn(problem, config, warm_start=warm_start, verbose=verbose,
                device=device, mesh=mesh)
    return _finalize(result, config, t0)


def _finalize(result: FitResult, config: SolverConfig,
              t0: float) -> FitResult:
    """Shared result epilogue: stamp wall time, registry solver name and
    the exact config (used by ``solve``, ``partial_fit`` and the
    streaming session)."""
    result.wall_time = time.perf_counter() - t0
    for cls in type(config).__mro__:
        if cls in _SOLVERS:
            result.solver = _SOLVERS[cls][0]
            break
    result.config = config
    return result


def _warm_factors(warm_start: Optional[FitResult], dtype=None):
    if warm_start is None:
        return None, None, 0
    W0 = np.asarray(warm_start.W, dtype=dtype)
    H0 = np.asarray(warm_start.H, dtype=dtype)
    return W0, H0, warm_start.epochs_done


def _solve_faulted(problem: MCProblem, config: SolverConfig, *,
                   warm_start, verbose, faults: FaultPolicy,
                   device, mesh=None) -> FitResult:
    """Fault-tolerant ``solve``: run in ``checkpoint_every``-epoch
    blocks, atomically checkpoint the accumulated result after each, and
    (``resume=True``) pick up from the latest committed block.  Split
    runs warm-start bitwise-exactly, so the recovered run equals the
    uninterrupted one in W, H and trace.  With ``faults.divergence`` a
    block that trips the sentinel is discarded and retried from the last
    good state with a backed-off step size.  On a ``mesh`` every block
    is ``solve(mesh=)`` and the checkpoints are the mesh's
    (``save_fit_result(mesh=)``)."""
    from .checkpoint.checkpoint import (gc_checkpoints, restore_fit_result,
                                        save_fit_result)
    total = config.epochs
    if total != int(total):
        raise ValueError(
            f"faults= requires integral epochs, got {total} (the "
            "simulator has its own failure model: AsyncSimConfig.failures)")
    total = int(total)
    if total == 0:
        return solve(problem, config, warm_start=warm_start,
                     verbose=verbose, device=device, mesh=mesh)
    base = warm_start.epochs_done if warm_start is not None else 0
    warm, done, traces = warm_start, 0, []
    if faults.resume:
        restored, _step = restore_fit_result(faults.checkpoint_dir,
                                             mesh=mesh)
        if restored is not None:
            if restored.config is not None and dataclasses.replace(
                    restored.config, epochs=config.epochs) != config:
                raise ValueError(
                    f"checkpoint in {faults.checkpoint_dir!r} was written "
                    f"by a different config ({restored.config!r}); refuse "
                    "to resume a run it does not belong to")
            done = int(round(restored.epochs_done - base))
            if done < 0 or done > total:
                raise ValueError(
                    f"checkpoint has {restored.epochs_done} epochs done "
                    f"but this run spans [{base}, {base + total}]")
            warm = restored
            traces.append((restored.trace_epochs, restored.trace_rmse))
    res = warm
    div = faults.divergence
    rollbacks = 0
    n_rollbacks = 0
    ref_rmse = None     # last good block's final held-out RMSE
    if warm is not None and len(warm.trace_rmse):
        ref_rmse = float(warm.trace_rmse[-1])
    while done < total:
        chunk = min(faults.checkpoint_every, total - done)
        cfg_chunk = dataclasses.replace(config, epochs=chunk)
        if div is not None:
            cfg_chunk = div.backed_off(cfg_chunk, rollbacks)
        res = solve(problem, cfg_chunk, warm_start=warm, verbose=verbose,
                    device=device, mesh=mesh)
        if div is not None and div.tripped(res, ref_rmse):
            # divergence quarantine: discard the block, fall back to the
            # last good state (``warm``), back the step size off, retry
            if rollbacks >= div.max_rollbacks:
                raise DivergenceError(
                    f"block at epoch {base + done} still diverged after "
                    f"{rollbacks} rollbacks (alpha backed off to "
                    f"{div.backoff ** rollbacks:g}x)")
            rollbacks += 1
            n_rollbacks += 1
            if verbose:
                print(f"divergence tripped at epoch {base + done}; "
                      f"rolling back (retry {rollbacks})")
            continue
        rollbacks = 0   # a good block re-arms the retry budget
        if len(res.trace_rmse):
            ref_rmse = float(res.trace_rmse[-1])
        done += chunk
        traces.append((res.trace_epochs, res.trace_rmse))
        # the running checkpoint carries the *accumulated* trace so a
        # resumed run's history is the uninterrupted run's history; the
        # stamped config is the caller's (unscaled) one, so a resumed
        # run replays the same (deterministic) rollbacks and the resume
        # check above keeps working
        res = dataclasses.replace(
            res, config=dataclasses.replace(config, epochs=chunk),
            trace_epochs=np.concatenate([t for t, _ in traces]),
            trace_rmse=np.concatenate([r for _, r in traces]))
        if n_rollbacks:
            res.extras["divergence"] = dict(
                res.extras.get("divergence", {}), rollbacks=n_rollbacks)
        save_fit_result(faults.checkpoint_dir, done, res, mesh=mesh)
        gc_checkpoints(faults.checkpoint_dir, faults.keep, mesh=mesh)
        warm = res
    return res


# ---------------------------------------------------------------------- #
# Streaming front door: partial_fit                                       #
# ---------------------------------------------------------------------- #

_PARTIAL: Dict[Type[SolverConfig], Callable] = {}


def register_partial_fit(config_cls: Type[SolverConfig]):
    """Register ``fn(result, delta, config, *, verbose, device, mesh) ->
    FitResult`` as the streaming continuation for ``config_cls``."""
    def deco(fn):
        if config_cls in _PARTIAL:
            raise ValueError(
                f"partial_fit for {config_cls.__name__} already registered")
        _PARTIAL[config_cls] = fn
        return fn
    return deco


def supports_partial_fit(config) -> bool:
    """True if ``config`` (an instance, class, or solver name) has a
    registered streaming continuation."""
    if isinstance(config, str):
        config = config_for(config)
    cls = config if isinstance(config, type) else type(config)
    return any(c in _PARTIAL for c in cls.__mro__)


def streaming_solver_names() -> List[str]:
    """Names of registered solvers that support ``partial_fit``."""
    return sorted(n for n in _BY_NAME if supports_partial_fit(n))


def _refuse_non_streaming(config) -> None:
    if not supports_partial_fit(config):
        raise NotImplementedError(
            f"{type(config).__name__} has no partial_fit; streaming "
            f"solvers: {streaming_solver_names()}")


def partial_fit(result: FitResult, delta: ProblemDelta,
                config: Optional[SolverConfig] = None, *, mesh=None,
                verbose: bool = False,
                device: Optional[Union[str, torch.device]] = None
                ) -> FitResult:
    """Continue a fit after an arrival batch: grow the factors for the
    delta's new rows/columns (existing entries bitwise-untouched, new
    rows seeded deterministically), absorb the new ratings, and run
    ``config.epochs`` more epochs with the step-size schedule resumed
    from ``result.epochs_done``.

    ``config`` defaults to ``result.config``.  NOMAD runs the
    incremental path — ``partition.repack_delta`` re-colors only the
    cells the delta touches — and is bitwise-identical to a warm-started
    ``solve`` on the concatenated data under the same (sticky)
    partition.  DSGD and Hogwild grow the factors and re-solve warm on
    the concatenated data; solvers without a streaming continuation
    (CCD++, ALS, the simulator) raise ``NotImplementedError``.

    The returned result's ``extras["problem"]`` is the materialized
    extended :class:`MCProblem` (pinned to the sticky partition) — build
    the next arrival's delta from it to chain batches:
    ``delta2 = res.extras["problem"].extend(...)``.

    ``mesh`` runs NOMAD's round on the SPMD executor (every rank of the
    launch calls ``partial_fit`` alike); DSGD and Hogwild pass it on to
    ``solve``, which ignores it.
    """
    if not isinstance(result, FitResult):
        raise TypeError(
            f"result must be FitResult, got {type(result).__name__}")
    if not isinstance(delta, ProblemDelta):
        raise TypeError(
            f"delta must be ProblemDelta, got {type(delta).__name__}")
    device = _mesh_device(mesh, device)
    if config is None:
        config = result.config
        if config is None:
            raise ValueError(
                "result carries no config; pass partial_fit(..., config=)")
    _refuse_non_streaming(config)
    fn = next(_PARTIAL[c] for c in type(config).__mro__ if c in _PARTIAL)
    device = resolve_device(device)
    t0 = time.perf_counter()
    out = fn(result, delta, config, verbose=verbose, device=device,
             mesh=mesh)
    return _finalize(out, config, t0)


# ---------------------------------------------------------------------- #
# Solver implementations (adapters over core/)                            #
# ---------------------------------------------------------------------- #

def _nomad_engine(br, config: NomadConfig, device, mesh=None):
    from .core.nomad import NomadRingEngine
    return NomadRingEngine(br=br, k=config.k, lam=config.lam,
                           stepsize=config.make_stepsize(),
                           policy=config.kernel, device=device, mesh=mesh)


def _nomad_run(eng, config: NomadConfig, test, start,
               verbose) -> FitResult:
    """Train an initialized engine for ``config.epochs`` starting at
    schedule position ``start`` and package the result."""
    eng.epoch_idx = int(start)      # schedule resumes where it left off
    trace = eng.train(int(config.epochs), test=test, verbose=verbose,
                      record_every=config.record_every,
                      dispatch=config.dispatch,
                      fuse_epochs=config.fuse_epochs)
    W, H = eng.factors()
    epochs, rmses = _as_trace_arrays(trace)
    return FitResult(W=W, H=H, trace_epochs=epochs, trace_rmse=rmses,
                     epochs_done=int(start) + int(config.epochs),
                     extras={"divergence": {"finite": bool(eng.last_finite)}})


def _streaming_repack(base_br, base_problem: MCProblem,
                      delta: ProblemDelta, config: NomadConfig):
    """Extended packing under the sticky partition *and* sticky
    ownership schedule: the incremental delta re-pack when the layout
    supports it, a from-scratch pack pinned to the extended sticky
    assignment otherwise (sub-block boundaries move when n_local grows,
    so the pipelined layout cannot be patched)."""
    if config.kernel.sub_blocks == 1:
        return part.repack_delta(
            base_br, base_problem.rows, base_problem.cols,
            base_problem.vals, delta.rows, delta.cols, delta.vals,
            delta.m, delta.n)
    ext_rows = np.concatenate([base_problem.rows, delta.rows])
    ext_cols = np.concatenate([base_problem.cols, delta.cols])
    row_owner, col_block = part.extend_assignments(
        base_br, ext_rows, ext_cols, delta.m, delta.n)
    return part.pack(
        ext_rows, ext_cols,
        np.concatenate([base_problem.vals, delta.vals]),
        delta.m, delta.n, config.p, waves=config.kernel.wave,
        sub_blocks=config.kernel.sub_blocks, row_owner=row_owner,
        col_block=col_block, schedule=base_br.schedule)


def _pack_once(mesh, build: Callable[[], part.BlockedRatings]
               ) -> part.BlockedRatings:
    """``build()``, a packing every rank of an SPMD launch needs alike.
    On a mesh with a shared directory (``mesh.shared_dir``) only its lead
    rank builds it, writes it there (``partition.save_pack``, the
    ratings' ids included, so that any rank can re-pack it later) and
    keeps it; the others map the files read-only, which the lead removes
    once every rank holds them.  Without one every rank builds it.  The
    bytes are the same either way."""
    if mesh is None or mesh.shared_dir is None:
        return build()
    held = []

    def lead():
        br = build()
        path = tempfile.mkdtemp(prefix="pack_", dir=mesh.shared_dir)
        part.save_pack(br, path, ids=True)
        held.append(br)
        return path

    path = mesh.on_lead(lead)
    br = held[0] if held else part.load_pack(path)
    mesh.barrier()          # mapped everywhere: the names can go
    if mesh.lead:
        shutil.rmtree(path, ignore_errors=True)
    return br


def _seed_pack_cache(prob: MCProblem, br, config: NomadConfig) -> MCProblem:
    """Pre-seed ``prob``'s pack cache with ``br`` (``prob`` is pinned to
    ``br``'s partition and resolved schedule, so ``br`` is exactly what
    its ``packed(...)`` would produce): the next round's pack, or a
    batch ``solve`` of ``prob``, is a cache hit that replays the
    identical serial order instead of an O(total nnz) re-pack of all
    history."""
    policy = config.kernel
    prob._pack_cache[MCProblem._pack_key(
        config.p, config.balanced, policy.wave, None, policy.sub_blocks,
        br.schedule, 0)] = br
    return prob


def _sticky_extended_problem(delta: ProblemDelta, br,
                             config: NomadConfig) -> MCProblem:
    """The delta's extended problem pinned to ``br``'s sticky partition
    *and* sticky (resolved) ownership schedule, pack cache seeded."""
    return _seed_pack_cache(delta.extended(
        row_assign=br.row_owner, col_assign=br.col_block,
        schedule_pin=br.schedule), br, config)


def _nomad_cold_start(problem: MCProblem, config: NomadConfig, device,
                      warm_start, mesh=None):
    """Pack + engine + initial factors (warm, or Algorithm 1's seeded
    init drawn on a CPU ``torch.Generator`` seeded with
    ``config.seed``) — the one cold-start path shared by
    ``_solve_nomad`` and ``StreamingSession`` (the session's
    bitwise==batch guarantee depends on the two never diverging)."""
    from .core.objective import init_factors

    policy = config.kernel
    br = problem.packed(config.p, balanced=config.balanced,
                        waves=policy.wave, sub_blocks=policy.sub_blocks,
                        schedule=config.schedule,
                        schedule_seed=config.schedule_seed)
    eng = _nomad_engine(br, config, device, mesh)
    W0, H0, start = _warm_factors(warm_start, dtype=problem.dtype)
    if W0 is None:
        gen = torch.Generator().manual_seed(int(config.seed))
        W0, H0 = init_factors(gen, problem.m, problem.n, config.k)
        W0, H0 = W0.numpy(), H0.numpy()
    eng.init_factors(W0, H0)
    return eng, start


@register_solver("nomad", NomadConfig)
def _solve_nomad(problem: MCProblem, config: NomadConfig, *,
                 warm_start=None, verbose=False, device=None,
                 mesh=None) -> FitResult:
    eng, start = _nomad_cold_start(problem, config, device, warm_start,
                                   mesh)
    return _nomad_run(eng, config, problem.test, start, verbose)


@register_partial_fit(NomadConfig)
def _partial_fit_nomad(result: FitResult, delta: ProblemDelta,
                       config: NomadConfig, *, verbose=False,
                       device=None, mesh=None) -> FitResult:
    from .core.objective import grow_factors
    policy = config.kernel
    base_br = delta.base.packed(config.p, balanced=config.balanced,
                                waves=policy.wave,
                                sub_blocks=policy.sub_blocks,
                                schedule=config.schedule,
                                schedule_seed=config.schedule_seed)
    br = _streaming_repack(base_br, delta.base, delta, config)
    eng = _nomad_engine(br, config, device, mesh)
    W0, H0 = grow_factors(
        np.asarray(result.W, dtype=delta.base.dtype),
        np.asarray(result.H, dtype=delta.base.dtype),
        delta.m_new, delta.n_new, seed=config.seed)
    eng.init_factors(W0, H0)
    res = _nomad_run(eng, config, delta.merged_test,
                     result.epochs_done, verbose)
    # the extended problem pinned to the sticky partition (pack cache
    # pre-seeded with br): feeding the next delta off this keeps a
    # partial_fit chain on one serial order, and incremental
    res.extras["problem"] = _sticky_extended_problem(delta, br, config)
    return res


@register_partial_fit(DsgdConfig)
def _partial_fit_dsgd(result, delta, config, *, verbose=False, device=None,
                      mesh=None):
    return _partial_refit(result, delta, config, verbose=verbose,
                          device=device, mesh=mesh)


@register_partial_fit(HogwildConfig)
def _partial_fit_hogwild(result, delta, config, *, verbose=False,
                         device=None, mesh=None):
    return _partial_refit(result, delta, config, verbose=verbose,
                          device=device, mesh=mesh)


def _partial_refit(result: FitResult, delta: ProblemDelta,
                   config: SolverConfig, *, verbose=False,
                   device=None, mesh=None) -> FitResult:
    """Generic streaming continuation for solvers without an incremental
    pack: deterministic factor growth + warm-started batch solve on the
    concatenated data."""
    from .core.objective import grow_factors
    W2, H2 = grow_factors(np.asarray(result.W), np.asarray(result.H),
                          delta.m_new, delta.n_new, seed=config.seed)
    warm = dataclasses.replace(result, W=W2, H=H2)
    ext = delta.extended()
    res = solve(ext, config, warm_start=warm, verbose=verbose,
                device=device, mesh=mesh)
    res.extras["problem"] = ext
    return res


def _baseline_result(W, H, trace, start, config) -> FitResult:
    epochs, rmses = _as_trace_arrays(trace)
    return FitResult(W=W, H=H, trace_epochs=epochs, trace_rmse=rmses,
                     epochs_done=int(start) + int(config.epochs))


@register_solver("dsgd", DsgdConfig)
def _solve_dsgd(problem: MCProblem, config: DsgdConfig, *,
                warm_start=None, verbose=False, device=None,
                mesh=None) -> FitResult:
    """DSGD on the problem's memoized ring packing (``waves=False``), each
    sub-epoch one launch of the CUDA kernel's sequential route."""
    from .core import baselines
    W0, H0, start = _warm_factors(warm_start)
    W, H, trace = baselines.dsgd(
        problem.rows, problem.cols, problem.vals, problem.m, problem.n,
        config.k, config.p, lam=config.lam, epochs=int(config.epochs),
        schedule=config.make_stepsize(), seed=config.seed,
        test=problem.test, W0=W0, H0=H0, start_epoch=int(start),
        br=problem.packed(config.p, balanced=True, waves=False),
        device=device)
    return _baseline_result(W, H, trace, start, config)


@register_solver("ccdpp", CcdConfig)
def _solve_ccdpp(problem: MCProblem, config: CcdConfig, *,
                 warm_start=None, verbose=False, device=None,
                mesh=None) -> FitResult:
    from .core import baselines
    W0, H0, start = _warm_factors(warm_start)
    W, H, trace = baselines.ccdpp(
        problem.rows, problem.cols, problem.vals, problem.m, problem.n,
        config.k, lam=config.lam, epochs=int(config.epochs),
        inner=config.inner, seed=config.seed, test=problem.test,
        W0=W0, H0=H0, start_epoch=int(start), device=device)
    return _baseline_result(W, H, trace, start, config)


@register_solver("als", AlsConfig)
def _solve_als(problem: MCProblem, config: AlsConfig, *,
               warm_start=None, verbose=False, device=None,
               mesh=None) -> FitResult:
    from .core import baselines
    W0, H0, start = _warm_factors(warm_start)
    W, H, trace = baselines.als(
        problem.rows, problem.cols, problem.vals, problem.m, problem.n,
        config.k, lam=config.lam, epochs=int(config.epochs),
        seed=config.seed, test=problem.test, W0=W0, H0=H0,
        start_epoch=int(start), device=device)
    return _baseline_result(W, H, trace, start, config)


@register_solver("hogwild", HogwildConfig)
def _solve_hogwild(problem: MCProblem, config: HogwildConfig, *,
                   warm_start=None, verbose=False,
                   device=None, mesh=None) -> FitResult:
    from .core import baselines
    W0, H0, start = _warm_factors(warm_start)
    W, H, trace = baselines.hogwild(
        problem.rows, problem.cols, problem.vals, problem.m, problem.n,
        config.k, lam=config.lam, epochs=int(config.epochs),
        batch=config.batch, schedule=config.make_stepsize(),
        seed=config.seed, test=problem.test, W0=W0, H0=H0,
        start_epoch=int(start), device=device)
    return _baseline_result(W, H, trace, start, config)


@register_solver("async_sim", AsyncSimConfig)
def _solve_async_sim(problem: MCProblem, config: AsyncSimConfig, *,
                     warm_start=None, verbose=False,
                     device=None, mesh=None) -> FitResult:
    """The discrete-event simulator (float64 numpy on the host, bitwise
    the JAX package's for the same inputs and seed); ``device`` is not
    read.  With ``emit_schedule`` the simulated ownership transfers come
    back as ``extras["schedule"]``, an ``OwnershipSchedule`` that
    ``NomadConfig(schedule=...)`` replays on the card."""
    from .core.async_sim import NomadSimulator, simulate_dsgd
    from .core.objective import init_factors_np
    W0, H0, start = _warm_factors(warm_start, dtype=np.float64)
    if W0 is None:
        W0, H0 = init_factors_np(config.seed, problem.m, problem.n,
                                 config.k)
    cfg = config.to_sim_config()
    if config.mode == "nomad":
        res = NomadSimulator(cfg, problem.m, problem.n, problem.rows,
                             problem.cols, problem.vals, W0, H0,
                             test=problem.test).run()
    else:
        res = simulate_dsgd(cfg, problem.m, problem.n, problem.rows,
                            problem.cols, problem.vals, W0, H0,
                            test=problem.test,
                            overlap=config.mode == "dsgd++")
    nnz = max(1, problem.nnz)
    epochs = np.asarray([start + upd / nnz for _, upd, _ in res.trace],
                        dtype=np.float64)
    rmses = np.asarray([r for _, _, r in res.trace], dtype=np.float64)
    extras = {"n_updates": res.n_updates,
              "throughput": res.throughput,
              "busy_time": res.busy_time,
              "trace_virtual_time": np.asarray(
                  [t for t, _, _ in res.trace], dtype=np.float64),
              "update_log": res.update_log}
    if res.transport is not None:
        extras["transport"] = res.transport
    if config.emit_schedule:
        # compile the simulated ownership transfers into a schedule the
        # real engine replays.  The item blocks are the nnz-balanced
        # assignment pack(balanced=True) computes for this problem, so a
        # plain NomadConfig(schedule=extras["schedule"]) replay lines the
        # blocks up with the compiled visits automatically.
        from .core.partition import balanced_assign
        col_cnt = np.bincount(problem.cols, minlength=problem.n)
        col_block = balanced_assign(col_cnt, config.p)
        extras["schedule"] = OwnershipSchedule.from_sim_log(
            res, col_block, p=config.p)
    return FitResult(
        W=res.W, H=res.H, trace_epochs=epochs, trace_rmse=rmses,
        epochs_done=float(start) + res.n_updates / nnz,
        virtual_time=res.sim_time, extras=extras)


# ---------------------------------------------------------------------- #
# Streaming session                                                       #
# ---------------------------------------------------------------------- #

class StreamingSession:
    """Online matrix completion: chain warm-started rounds over a stream
    of arrival batches, on one live engine.

        >>> sess = StreamingSession(problem, NomadConfig(k=16, p=8,
        ...                                             kernel="wave_pallas"))
        >>> sess.fit()                       # cold start on the base data
        >>> for b in stream:                 # e.g. data.RatingArrivalStream
        ...     res = sess.arrive(**b)

    Each ``arrive`` incrementally re-packs only the cells the delta
    touches (``partition.repack_delta``), grows the factor shards
    (``NomadRingEngine.grow`` — old entries bitwise-untouched), and runs
    more epochs with the step-size schedule resumed, so the whole chain
    is bitwise-identical to ``partial_fit`` calls (and to warm-started
    batch refits) without rebuilding the engine or re-coloring untouched
    cells.  A DSGD or Hogwild session chains ``partial_fit`` calls (each
    a warm re-solve on the concatenated data); the elastic calls below
    need a :class:`NomadConfig`.

    The session is also the *elastic* front door: :meth:`resize` changes
    the worker set mid-run (workers leave or join; surviving shards
    migrate bitwise-untouched along a compiled
    :class:`TransitionSchedule`), and — with a :class:`FaultPolicy` —
    :meth:`kill` recovers dead workers from the last committed
    checkpoint plus a deterministic round replay, landing bitwise on the
    state a graceful :meth:`resize` of the same workers reaches.

    ``device`` is where the engine runs, as for :func:`solve` (``None``
    means ``"cuda"``, or the mesh's device).  With ``mesh`` (a
    :class:`repro_torch.launch.mesh.McMesh`) the engine is NOMAD's SPMD
    executor: every rank of the launch builds the session alike and
    makes the same calls in the same order, members of the current mesh
    or not, and every rank's results are bitwise the one-device
    session's.  ``resize(mesh=)`` and ``kill(mesh=)`` move the engine
    onto a mesh of the new worker set (``McMesh.ranks_after`` names its
    ranks within the launch); the replay log keeps each op's mesh.  The
    first mesh's lead rank writes the checkpoints and builds the
    re-packings the others map (its shared directory, when it has one);
    ``faults.checkpoint_dir`` must then be on one file system that every
    rank sees.  :attr:`timings` holds the host-clock seconds of the
    latest of each phase: ``repack_delta``, ``grow``, ``train``,
    ``repack_transition``, ``migrate``, ``checkpoint``, ``restore`` and
    ``replay``.
    """

    def __init__(self, problem: MCProblem, config: SolverConfig, *,
                 mesh=None, verbose: bool = False,
                 faults: Optional[FaultPolicy] = None,
                 warm_start: Optional[FitResult] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if not isinstance(problem, MCProblem):
            raise TypeError(f"problem must be MCProblem, got "
                            f"{type(problem).__name__}")
        device = _mesh_device(mesh, device)
        _refuse_non_streaming(config)
        if faults is not None and not isinstance(faults, FaultPolicy):
            raise TypeError(f"faults must be FaultPolicy, got "
                            f"{type(faults).__name__}")
        if warm_start is not None and not isinstance(warm_start,
                                                    FitResult):
            raise TypeError(f"warm_start must be FitResult, got "
                            f"{type(warm_start).__name__}")
        self.device = resolve_device(device)
        self.problem = problem
        self.config = config
        #: the mesh the engine runs on now (``None``: one device), and
        #: the first mesh, which writes checkpoints and shared packings
        self.mesh = mesh
        self._launch = mesh
        self.verbose = verbose
        self.faults = faults
        #: optional resumed state (e.g. a restored checkpoint): the first
        #: round warm-starts from these factors with the step-size
        #: schedule resumed at ``warm_start.epochs_done``, and a
        #: :meth:`kill` recovery replays on top of the same state
        self._warm0 = warm_start
        self.result: Optional[FitResult] = warm_start
        self.history: List[FitResult] = []
        self.timings: Dict[str, float] = {}
        self._eng = None
        # elastic state: the base problem/config every kill-recovery
        # replays from, the round log (one op per public mutating call),
        # and the original schedule *spec* (re-resolved per worker set)
        self._base_problem = problem
        self._base_config = config
        self._replay_log: List[tuple] = []
        self._replaying = False
        self._schedule_spec = (config.schedule
                               if isinstance(config, NomadConfig) else None)
        # log compaction: the replay log holds rounds
        # [_base_round, _base_round + len(_replay_log)); once every
        # retained committed checkpoint has advanced past a snapshotted
        # round, the session re-bases there and drops the prefix
        self._base_round = 0
        self._base_spec = self._schedule_spec
        self._base_mesh = mesh
        self._base_result: Optional[FitResult] = None
        self._snapshots: dict = {}
        self._monitor = None
        if faults is not None and faults.monitor \
                and isinstance(config, NomadConfig):
            from .runtime.straggler import StragglerMonitor
            self._monitor = StragglerMonitor(config.p,
                                             threshold=faults.threshold)
        # round observers (the serving tier's hot-swap hook): called with
        # each round's FitResult the moment it completes
        self._subscribers: List[Callable[[FitResult], Any]] = []

    @contextlib.contextmanager
    def _timed(self, name: str):
        t0 = time.perf_counter()
        yield
        self.timings[name] = time.perf_counter() - t0

    def _cfg(self, epochs) -> SolverConfig:
        return self.config if epochs is None else dataclasses.replace(
            self.config, epochs=epochs)

    def _finish(self, res: FitResult, t0: float,
                cfg: SolverConfig) -> FitResult:
        res = _finalize(res, cfg, t0)
        self.result = res
        self.history.append(res)
        for cb in tuple(self._subscribers):
            cb(res)
        return res

    def subscribe(self, callback: Callable[[FitResult], Any]):
        """Register a round observer: ``callback(result)`` runs after
        every completed ``fit``/``arrive`` round (including rounds
        re-executed by a :meth:`kill` recovery replay — versions stay
        monotone through recovery).  This is how a
        :class:`repro_torch.serve.FactorStore` hot-swaps live factors out
        of a training session (``store.attach(session)``).  Returns the
        callback for symmetry with :meth:`unsubscribe`."""
        if not callable(callback):
            raise TypeError(f"callback must be callable, got "
                            f"{type(callback).__name__}")
        self._subscribers.append(callback)
        return callback

    def unsubscribe(self, callback) -> None:
        self._subscribers.remove(callback)

    def _ensure_engine(self):
        if self._eng is None:
            self._eng, _ = _nomad_cold_start(self.problem, self.config,
                                             self.device, self.result,
                                             self.mesh)
        return self._eng

    def _require_nomad(self, what: str) -> NomadConfig:
        if not isinstance(self.config, NomadConfig):
            raise NotImplementedError(
                f"{what} requires a NomadConfig session (ownership "
                "transfer is what makes the engine elastic); got "
                f"{type(self.config).__name__}")
        return self.config

    def _nomad_round(self, cfg: NomadConfig, test, start) -> FitResult:
        """One training round under the divergence quarantine
        (``faults.divergence``): capture the pre-round factors, run, and
        if the round trips the sentinel restore them, back off the
        step-size schedule (the engine reads ``eng.stepsize`` afresh
        every round) and retry — up to ``max_rollbacks`` times, then
        :class:`DivergenceError`.  Detection and backoff are
        deterministic (same factors, same schedule → same trip), so a
        :meth:`kill` recovery replay re-executes the identical rollbacks
        and lands on the same state."""
        eng = self._eng

        def run():
            with self._timed("train"):
                return _nomad_run(eng, cfg, test, start, self.verbose)

        div = self.faults.divergence if self.faults is not None else None
        if div is None:
            return run()
        W_prev, H_prev = eng.factors()      # pre-round rollback anchor
        if not (np.isfinite(W_prev).all() and np.isfinite(H_prev).all()):
            # the live engine state itself is corrupt (e.g. the chaos
            # harness's 'nan' injection): anchor on the last completed
            # round's factors instead, when their shapes still match
            r = self.result
            if r is not None \
                    and np.asarray(r.W).shape == W_prev.shape \
                    and np.asarray(r.H).shape == H_prev.shape:
                W_prev, H_prev = np.asarray(r.W), np.asarray(r.H)
        ref = None
        if self.result is not None and len(self.result.trace_rmse):
            ref = float(self.result.trace_rmse[-1])
        rollbacks = 0
        while True:
            sched0 = eng.stepsize
            eng.stepsize = div.backed_off(cfg, rollbacks).make_stepsize()
            try:
                res = run()
            finally:
                eng.stepsize = sched0
            if not div.tripped(res, ref):
                res.extras.setdefault("divergence",
                                      {})["rollbacks"] = rollbacks
                return res
            if rollbacks >= div.max_rollbacks:
                raise DivergenceError(
                    f"streaming round still diverged after {rollbacks} "
                    f"rollback/backoff retries "
                    f"(backoff={div.backoff})")
            rollbacks += 1
            eng.init_factors(
                np.asarray(W_prev, dtype=self.problem.dtype),
                np.asarray(H_prev, dtype=self.problem.dtype))

    def fit(self, epochs=None) -> FitResult:
        """Run ``epochs`` (default ``config.epochs``) on the current data
        — the cold start, or further refinement between arrivals."""
        cfg = self._cfg(epochs)
        t0 = time.perf_counter()
        if isinstance(cfg, NomadConfig):
            self._ensure_engine()
            start = 0 if self.result is None else self.result.epochs_done
            res = self._nomad_round(cfg, self.problem.test, start)
        else:
            res = solve(self.problem, cfg, warm_start=self.result,
                        verbose=self.verbose, device=self.device,
                        mesh=self.mesh)
        res = self._finish(res, t0, cfg)
        self._after_round(("fit", epochs))
        return res

    def _absorb(self, delta: ProblemDelta, cfg: NomadConfig):
        """Layout half of an arrival: incremental re-pack, engine growth,
        and the session problem re-pinned to the sticky extension."""
        eng = self._ensure_engine()
        with self._timed("repack_delta"):
            br = _pack_once(self._launch, lambda: _streaming_repack(
                eng.br, self.problem, delta, cfg))
        with self._timed("grow"):
            eng.grow(br, seed=cfg.seed)
        self.problem = _sticky_extended_problem(delta, br, cfg)

    def arrive(self, rows=(), cols=(), vals=(), *, m_new: int = 0,
               n_new: int = 0, test=None, epochs=None) -> FitResult:
        """Absorb an arrival batch (new ratings / rows / columns) and run
        ``epochs`` more epochs warm-started from the current factors."""
        if self.result is None:
            self.fit()
        cfg = self._cfg(epochs)
        delta = self.problem.extend(rows, cols, vals, m_new=m_new,
                                    n_new=n_new, test=test)
        t0 = time.perf_counter()
        if isinstance(cfg, NomadConfig):
            self._absorb(delta, cfg)
            res = self._nomad_round(cfg, delta.merged_test,
                                    self.result.epochs_done)
        else:
            res = partial_fit(self.result, delta, cfg, verbose=self.verbose,
                              device=self.device, mesh=self.mesh)
            self.problem = delta.extended()
        res = self._finish(res, t0, cfg)
        self._after_round(("arrive", rows, cols, vals, m_new, n_new,
                           test, epochs))
        return res

    # ----------------------------------------------------------------- #
    # Elasticity: resize / kill / straggler policy                       #
    # ----------------------------------------------------------------- #

    def resize(self, p_new: Optional[int] = None, *, leave=(), join: int = 0,
               mesh="keep", spread: str = "balance") -> TransitionSchedule:
        """Change the worker set mid-run: ``leave`` (graceful departures,
        old worker ids), ``join`` (new workers appended), or just a
        target ``p_new`` (shrinks drop the highest-numbered workers).

        Compiles a :class:`TransitionSchedule` weighted by per-row /
        per-column rating counts, re-packs along it (cells whose
        endpoints survive untouched are copied verbatim —
        ``partition.repack_transition``), and migrates the engine:
        surviving factor shards are preserved bit for bit and the
        step-size schedule continues, so the run's history stays exactly
        serializable across the transition.  ``spread="minimal"``
        concentrates moved shards on single donors/targets instead of
        load-spreading them.  ``mesh`` moves the engine
        (``NomadRingEngine.migrate``): ``"keep"``, ``None`` (one device)
        or an ``McMesh`` of the new worker count.  Returns the compiled
        transition."""
        p = self._require_nomad("resize()").p
        leave = tuple(int(q) for q in np.atleast_1d(
            np.asarray(leave, dtype=np.int64)).tolist())
        join = int(join)
        if p_new is not None:
            if leave or join:
                raise ValueError("pass p_new= or leave=/join=, not both")
            if p_new < 1:
                raise ValueError(f"p_new must be >= 1, got {p_new}")
            if p_new < p:
                leave = tuple(range(p_new, p))
            else:
                join = p_new - p
        if any(q < 0 or q >= p for q in leave):
            raise ValueError(f"leave workers must lie in [0, {p})")
        if not (isinstance(mesh, str) and mesh == "keep"):
            from .core.nomad import _check_mesh
            _check_mesh(mesh)
        if len(set(leave)) >= p:
            raise RuntimeError("no survivors")
        eng = self._ensure_engine()
        alive = np.ones(p, dtype=bool)
        alive[list(leave)] = False
        tr = compile_transition(
            p, eng.br.row_owner, eng.br.col_block, alive=alive, join=join,
            row_weights=np.bincount(self.problem.rows,
                                    minlength=self.problem.m),
            col_weights=np.bincount(self.problem.cols,
                                    minlength=self.problem.n),
            spread=spread)
        self._apply_transition(tr, mesh=mesh)
        self._after_round(("resize", leave, join, spread, mesh))
        return tr

    def kill(self, *workers: int, mesh="keep") -> TransitionSchedule:
        """Worker failure: the listed workers died without handing off
        their shards.  Recovery restores the last committed verified
        checkpoint (``faults.checkpoint_dir``; cold replay from the base
        data when none exists), deterministically replays the rounds
        after it, and resizes the dead workers out — landing bitwise on
        the state a graceful ``resize(leave=workers)`` reaches, which is
        what makes the recovered history exactly serializable.  The
        replay re-runs each logged resize on its own mesh, and ``mesh``
        is the survivors' (as for :meth:`resize`)."""
        self._require_nomad("kill()")
        if not workers:
            raise ValueError("kill() needs at least one worker id")
        restored, step = None, 0
        with self._timed("restore"):
            if self.faults is not None:
                from .checkpoint.checkpoint import restore_fit_result
                restored, step = restore_fit_result(
                    self.faults.checkpoint_dir, mesh=self._launch)
                if restored is None:
                    step = 0
        log = self._replay_log
        # the log holds rounds [_base_round, _base_round + len(log));
        # with no usable checkpoint, cold-replay the whole window from
        # the base snapshot (bitwise: the base factors are the round-
        # ``_base_round`` state the original run trained from)
        local = 0 if restored is None else step - self._base_round
        if local < 0 or local > len(log):
            raise ValueError(
                f"checkpoint is at round {step} but the session log "
                f"covers rounds [{self._base_round}, "
                f"{self._base_round + len(log)}]")
        t0 = time.perf_counter()
        self.problem = self._base_problem
        self.config = self._base_config
        self.mesh = self._base_mesh
        self._schedule_spec = self._base_spec
        # replay starts where __init__ did — or, after log compaction,
        # at the in-memory base snapshot's round
        self.result = (self._base_result if self._base_round > 0
                       else self._warm0)
        self.history = []
        self._eng = None
        self._replay_log = []
        self._replaying = True
        try:
            for op in log[:local]:
                self._apply_op(op, structural=True)
            if restored is not None:
                # the structural replay has rebuilt the session config as
                # of the checkpointed round — now it can vouch for the
                # checkpoint (modulo the per-round epochs override)
                if restored.config is not None and dataclasses.replace(
                        restored.config,
                        epochs=self.config.epochs) != self.config:
                    raise ValueError(
                        f"checkpoint in {self.faults.checkpoint_dir!r} "
                        "was written by a different run; refuse to "
                        "recover from it")
                eng = self._ensure_engine()
                eng.init_factors(
                    np.asarray(restored.W, dtype=self.problem.dtype),
                    np.asarray(restored.H, dtype=self.problem.dtype))
                self.result = restored
            for op in log[local:]:
                self._apply_op(op)
        finally:
            self._replaying = False
        self.timings["replay"] = time.perf_counter() - t0
        return self.resize(leave=workers, mesh=mesh)

    def _apply_op(self, op: tuple, structural: bool = False):
        """Re-execute one logged round.  ``structural`` replays only the
        layout/worker-set evolution (no training) — used for the rounds
        a restored checkpoint already covers, whose factors come from
        the checkpoint instead."""
        kind = op[0]
        if kind == "fit":
            if structural:
                self._ensure_engine()
            else:
                self.fit(epochs=op[1])
        elif kind == "arrive":
            _, rows, cols, vals, m_new, n_new, test, epochs = op
            if structural:
                self._absorb(self.problem.extend(
                    rows, cols, vals, m_new=m_new, n_new=n_new, test=test),
                    self.config)
            else:
                self.arrive(rows, cols, vals, m_new=m_new, n_new=n_new,
                            test=test, epochs=epochs)
        elif kind == "resize":
            _, leave, join, spread, mesh = op
            self.resize(leave=leave, join=join, spread=spread, mesh=mesh)
        elif kind == "adapt":
            self._adapt_schedule(np.asarray(op[1], dtype=np.float64))
        else:
            raise ValueError(f"unknown replay op {kind!r}")
        if self._replaying:
            self._replay_log.append(op)

    def _apply_transition(self, tr: TransitionSchedule, *, mesh="keep",
                          schedule: Optional[OwnershipSchedule] = None):
        """Engine half of a worker-set (or schedule) change: re-pack
        along ``tr``, migrate the engine, and re-pin the session problem
        to the new sticky assignment."""
        cfg = self.config
        eng = self._ensure_engine()
        if tr.is_identity() and schedule is None:
            return
        policy = cfg.kernel
        # a string spec re-resolves for the new worker set; an explicit
        # old-p schedule cannot carry over, so fall back to its name
        spec = schedule if schedule is not None else (
            self._schedule_spec
            if isinstance(self._schedule_spec, str) else None)
        prob = self.problem

        def repack():
            if policy.sub_blocks == 1:
                return part.repack_transition(
                    eng.br, prob.rows, prob.cols, prob.vals, tr,
                    schedule=spec, schedule_seed=cfg.schedule_seed)
            return part.pack(
                prob.rows, prob.cols, prob.vals, prob.m, prob.n,
                tr.p_new, waves=policy.wave,
                sub_blocks=policy.sub_blocks,
                row_owner=tr.row_owner.astype(np.int32),
                col_block=tr.col_block.astype(np.int32),
                schedule=spec, schedule_seed=cfg.schedule_seed)

        with self._timed("repack_transition"):
            br = _pack_once(self._launch, repack)
        with self._timed("migrate"):
            eng.migrate(br, mesh=mesh)
        if not (isinstance(mesh, str) and mesh == "keep"):
            self.mesh = mesh
            self._launch = self._launch or mesh
        self.config = dataclasses.replace(cfg, p=tr.p_new,
                                          schedule=br.schedule)
        # the resize analogue of _sticky_extended_problem
        self.problem = _seed_pack_cache(MCProblem(
            rows=prob.rows, cols=prob.cols, vals=prob.vals, m=prob.m,
            n=prob.n, test=prob.test, val=prob.val, dtype=prob.dtype,
            row_assign=br.row_owner, col_assign=br.col_block,
            schedule_pin=br.schedule), br, self.config)
        if self._monitor is not None and tr.p_new != tr.p_old:
            from .runtime.straggler import StragglerMonitor
            self._monitor = StragglerMonitor(
                tr.p_new, threshold=self.faults.threshold)

    def observe_step_times(self, step_times) -> List[int]:
        """Feed one round of per-worker step timings to the straggler
        policy (``faults.monitor``).  Returns the flagged workers; with
        ``faults.eject`` they are gracefully resized out, and with
        ``faults.adapt_schedule`` the ownership schedule re-routes by
        the live speed estimates."""
        self._require_nomad("observe_step_times()")
        if self._monitor is None:
            raise RuntimeError(
                "straggler monitoring is off; pass "
                "faults=FaultPolicy(..., monitor=True)")
        flagged = self._monitor.update(np.asarray(step_times,
                                                  dtype=np.float64))
        if flagged and self.faults.eject:
            self.resize(leave=tuple(flagged))
            return flagged
        if self.faults.adapt_schedule \
                and self._monitor.steps >= self._monitor.min_steps:
            self._adapt_schedule(self._monitor.speed_estimates())
        return flagged

    def _adapt_schedule(self, speeds: np.ndarray):
        """Re-route the ownership schedule for the *current* worker set:
        ``OwnershipSchedule.balanced`` on per-cell nnz scaled by each
        worker's inverse speed, applied through the identity transition
        (no shard moves — only the visit order changes)."""
        cfg = self._require_nomad("_adapt_schedule()")
        eng = self._ensure_engine()
        br = eng.br
        speeds = np.maximum(np.asarray(speeds, dtype=np.float64), 1e-12)
        if len(speeds) != br.p:
            raise ValueError(f"got {len(speeds)} speeds for p={br.p}")
        prob = self.problem
        cell = (br.row_owner[prob.rows].astype(np.int64) * br.p
                + br.col_block[prob.cols])
        loads = np.bincount(cell, minlength=br.p * br.p).reshape(
            br.p, br.p) / speeds[:, None]
        sched = OwnershipSchedule.balanced(br.p, seed=cfg.schedule_seed,
                                           loads=loads)
        tr = TransitionSchedule.identity(br.p, br.row_owner, br.col_block)
        self._apply_transition(tr, schedule=sched)
        self._after_round(("adapt", tuple(float(s) for s in speeds)))

    # ----------------------------------------------------------------- #
    # Round log + checkpointing                                          #
    # ----------------------------------------------------------------- #

    def _after_round(self, op: tuple):
        if self._replaying:
            return
        self._replay_log.append(op)
        f = self.faults
        if f is not None and self.result is not None \
                and (self._base_round + len(self._replay_log)) \
                % f.checkpoint_every == 0:
            self.checkpoint()

    def checkpoint(self) -> int:
        """Atomically checkpoint the current result at the current round
        (step = rounds completed), GC'ing to ``faults.keep``; returns the
        step.  Called automatically every ``faults.checkpoint_every``
        rounds.  Each checkpoint also snapshots the session's structural
        state and compacts the kill-recovery round log down to the
        oldest retained committed step, so the log stays bounded by
        ``keep * checkpoint_every`` rounds on a long-lived session."""
        if self.faults is None:
            raise RuntimeError(
                "no FaultPolicy attached; pass faults= to the session")
        if self.result is None:
            raise RuntimeError("nothing to checkpoint yet; call fit()")
        from .checkpoint.checkpoint import gc_checkpoints, save_fit_result
        step = self._base_round + len(self._replay_log)
        # stamp the *session* config, not the last fit round's: when the
        # newest logged op is structural (resize/adapt), the recovery
        # replay vouches the checkpoint against the post-op config
        with self._timed("checkpoint"):
            save_fit_result(self.faults.checkpoint_dir, step,
                            dataclasses.replace(self.result,
                                                config=self.config),
                            mesh=self._launch)
        gc_checkpoints(self.faults.checkpoint_dir, self.faults.keep,
                       mesh=self._launch)
        self._snapshots[step] = (self.problem, self.config,
                                 self._schedule_spec, self.result,
                                 self.mesh)
        self._compact()
        return step

    def _compact(self):
        """Bound the kill-recovery round log: once the oldest *retained*
        committed checkpoint has advanced past the current base round,
        re-base the session on the structural snapshot taken at that
        step and drop the log prefix it covers.  Recovery from any
        retained checkpoint — and cold replay from the in-memory base
        snapshot when every retained checkpoint is corrupt — stays
        bitwise identical; only rounds older than every retained
        checkpoint become unreachable."""
        from .checkpoint.checkpoint import committed_steps
        steps = committed_steps(self.faults.checkpoint_dir)
        if not steps:
            return
        smin = steps[0]
        snap = self._snapshots.get(smin)
        if smin <= self._base_round or snap is None:
            return
        self._replay_log = self._replay_log[smin - self._base_round:]
        (self._base_problem, self._base_config, self._base_spec,
         self._base_result, self._base_mesh) = snap
        self._base_round = smin
        self._snapshots = {s: v for s, v in self._snapshots.items()
                           if s >= smin}
