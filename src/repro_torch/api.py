"""One front door for matrix completion: problem + config -> result.

The port's subset of the JAX package's API, same names and fields:

* :class:`MCProblem`    — immutable dataset container (COO train + held-out
                          test/val, sizes, dtype) that owns *packing*:
                          ``problem.packed(p, waves=..., sub_blocks=...)``
                          memoizes the ``BlockedRatings``.
* :class:`SolverConfig` / :class:`NomadConfig` — frozen hyperparameter
                          records; invalid combinations fail at
                          construction.
* :class:`FitResult`    — factors, per-epoch trace as arrays, wall time,
                          and the exact config; pass one back as
                          ``warm_start=`` to resume.

``solve(problem, config, *, device=None)`` dispatches through the
``@register_solver`` registry; ``device=None`` means ``"cuda"`` and
raises ``RuntimeError`` where CUDA is unavailable.

    >>> from repro_torch import api
    >>> problem = api.MCProblem.synthetic(m=2000, n=400, nnz=80_000, k=16)
    >>> res = api.solve(problem, api.NomadConfig(k=16, p=8,
    ...                                          kernel="wave_pallas"))
    >>> res.rmse[-1], res.wall_time

Not ported yet, and refused with ``NotImplementedError``: ``mesh=``
(SPMD, ROADMAP.md Queue 1 item 9), ``faults=``, :func:`partial_fit` and
:class:`StreamingSession` (Queue 1 item 6).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple, Type, Union

import numpy as np
import torch

from ._device import resolve_device
from .core import partition as part
from .core.schedule import OwnershipSchedule, SCHEDULE_NAMES
from .core.stepsize import PowerSchedule
from .kernels.policy import KernelPolicy

__all__ = [
    "MCProblem", "SolverConfig", "NomadConfig", "FitResult",
    "KernelPolicy", "OwnershipSchedule", "solve", "register_solver",
    "solver_names", "partial_fit", "StreamingSession",
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
    #: honored by :meth:`packed`
    row_assign: Optional[np.ndarray] = None
    col_assign: Optional[np.ndarray] = None
    #: optional pinned ownership schedule: when set, :meth:`packed` lays
    #: out for exactly this schedule regardless of the spec it is called
    #: with
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

    #: NomadConfig flips this: its ``schedule`` field selects the
    #: OwnershipSchedule instead of erroring on leftover values
    _schedule_is_ownership = False

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.epochs < 0:
            raise ValueError(f"epochs must be >= 0, got {self.epochs}")
        if self.epochs != int(self.epochs):
            raise ValueError(
                f"epochs must be integral for {type(self).__name__}, got "
                f"{self.epochs}")
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
    """Register ``fn(problem, config, *, warm_start, verbose, device) ->
    FitResult`` as the solver for ``config_cls`` (and for lookups by
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


def solve(problem: MCProblem, config: SolverConfig, *, mesh=None,
          warm_start: Optional[FitResult] = None,
          verbose: bool = False, faults=None,
          device: Optional[Union[str, torch.device]] = None) -> FitResult:
    """Run the solver registered for ``type(config)`` on ``problem``.

    ``warm_start`` — a previous :class:`FitResult` to resume from.
    ``device``     — where the factors live and the updates run; ``None``
                     means ``"cuda"`` (``RuntimeError`` without CUDA).
    ``mesh`` and ``faults`` are not ported yet and raise
    ``NotImplementedError``.
    """
    if not isinstance(problem, MCProblem):
        raise TypeError(f"problem must be MCProblem, got "
                        f"{type(problem).__name__}")
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (SPMD over several devices) is not ported yet: "
            "ROADMAP.md Queue 1 item 9 [spmd]")
    if faults is not None:
        raise NotImplementedError(
            "faults= (checkpointed fault-tolerant solve) is not ported "
            "yet: ROADMAP.md Queue 1 item 6 [stream/elastic/integrity]")
    device = resolve_device(device)
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
                device=device)
    return _finalize(result, config, t0)


def _finalize(result: FitResult, config: SolverConfig,
              t0: float) -> FitResult:
    """Shared result epilogue: stamp wall time, registry solver name and
    the exact config."""
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


def partial_fit(*args, **kwargs):
    """Streaming refit — not ported yet."""
    raise NotImplementedError(
        "partial_fit is not ported yet: ROADMAP.md Queue 1 item 6 "
        "[stream/elastic/integrity]")


class StreamingSession:
    """Streaming sessions — not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "StreamingSession is not ported yet: ROADMAP.md Queue 1 item 6 "
            "[stream/elastic/integrity]")


# ---------------------------------------------------------------------- #
# Solver implementations (adapters over core/)                            #
# ---------------------------------------------------------------------- #

def _nomad_engine(br, config: NomadConfig, device):
    from .core.nomad import NomadRingEngine
    return NomadRingEngine(br=br, k=config.k, lam=config.lam,
                           stepsize=config.make_stepsize(),
                           policy=config.kernel, device=device)


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


def _nomad_cold_start(problem: MCProblem, config: NomadConfig, device,
                      warm_start):
    """Pack + engine + initial factors (warm, or Algorithm 1's seeded
    init drawn on a CPU ``torch.Generator`` seeded with
    ``config.seed``)."""
    from .core.objective import init_factors

    policy = config.kernel
    br = problem.packed(config.p, balanced=config.balanced,
                        waves=policy.wave, sub_blocks=policy.sub_blocks,
                        schedule=config.schedule,
                        schedule_seed=config.schedule_seed)
    eng = _nomad_engine(br, config, device)
    W0, H0, start = _warm_factors(warm_start, dtype=problem.dtype)
    if W0 is None:
        gen = torch.Generator().manual_seed(int(config.seed))
        W0, H0 = init_factors(gen, problem.m, problem.n, config.k)
        W0, H0 = W0.numpy(), H0.numpy()
    eng.init_factors(W0, H0)
    return eng, start


@register_solver("nomad", NomadConfig)
def _solve_nomad(problem: MCProblem, config: NomadConfig, *,
                 warm_start=None, verbose=False, device=None) -> FitResult:
    eng, start = _nomad_cold_start(problem, config, device, warm_start)
    return _nomad_run(eng, config, problem.test, start, verbose)
