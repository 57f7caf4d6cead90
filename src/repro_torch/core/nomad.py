"""NOMAD engine, local executor: the whole ``p``-worker schedule on one
device.

W shards are owner-fixed, H blocks are *nomadic*: the engine executes the
``core.schedule.OwnershipSchedule`` its packing was laid out for (the
ring by default).  One epoch = ``schedule.n_steps`` steps; at step ``s``
worker ``q`` holds block ``schedule.table[s, q]`` and applies its cell iff
``schedule.active[s, q]``.  The ``p`` cells of a step touch pairwise
disjoint W rows and H blocks, so they run as one batch; after the step
the H blocks move by the schedule's permutation (a gather on the worker
axis).  Every rating is applied exactly once per epoch, in the packed
serial order (``BlockedRatings.schedule_order``).

Epoch functions, one per impl family:

* ``'wave_pallas'`` (the main path) — :func:`_local_epoch_body` over the
  epoch's ratings as a step-major CSR of conflict-free waves
  (:func:`wave_csr`, built once per packing from the wave-major flat
  lists; the padded 4-D wave layout is never uploaded).  Each step is
  one launch of the CUDA wave kernel for all ``p`` cells
  (``kernels.ops.block_sgd_cells_csr``).
* ``'pallas'`` (and ``'auto'`` on CUDA) — the same step loop over
  ``wave_csr(br, sequential=True)``, where every rating of the flat lists
  is its own wave: the strictly sequential update, through the same
  kernel.
* ``'xla'``/``'wave'`` (and ``'auto'`` elsewhere) —
  :func:`_stream_epoch_body` over ``partition.epoch_stream``:
  ``sum_s max_q nnz_cell(q, s)`` conflict-free ``p``-wide slots against
  the flat home-placement factors, in plain PyTorch.

Dispatch: ``train(dispatch="loop")`` syncs with the host once per epoch
(the held-out RMSE read); ``dispatch="fused"`` runs a block of epochs as
one Python loop with the learning rates precomputed
(``PowerSchedule.values``), the RMSE trace and the finiteness flag
accumulated in device tensors, and one host sync per ``fuse_epochs``
block.  Both call the same epoch function, so they are bitwise equal by
construction.  The factor shards are updated in place where the JAX
engine donates them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from . import partition as part
from .schedule import OwnershipSchedule
from .stepsize import PowerSchedule
from .._device import resolve_device
from ..convert import factors_from_reference, factors_to_reference
from ..kernels import ops as kops
from ..kernels.nomad_sgd import WaveCSR, block_sgd_waves_csr
from ..kernels.policy import KernelPolicy

#: impls whose epoch function is the flattened epoch stream
_STREAM_IMPLS = ("xla", "wave")


def wave_csr(br: part.BlockedRatings, *, sequential: bool = False
             ) -> WaveCSR:
    """One epoch's ratings as a CSR of waves on the CPU, step-major: cell
    ``s * p + q`` is worker ``q``'s cell at step ``s``.  Built from the
    flat lists (``br.rows/cols/vals``, wave-major in a wave packing) and
    ``br.wave_cnt`` — or, with ``sequential``, one wave per unmasked
    rating, in list order.  Indices are checked against the shard sizes
    here, once."""
    mask = np.swapaxes(br.mask, 0, 1)                 # (n_steps, p, max_nnz)
    if sequential:
        cnt = mask.astype(np.int64)
    elif br.wave_cnt is None:
        raise ValueError("wave_csr needs a packing with waves=True")
    else:
        cnt = np.swapaxes(br.wave_cnt, 0, 1)          # (n_steps, p, n_waves)
    keep = cnt > 0
    woff = np.zeros(int(keep.sum()) + 1, dtype=np.int64)
    np.cumsum(cnt[keep], out=woff[1:])
    cell_woff = np.zeros(cnt.shape[0] * cnt.shape[1] + 1, dtype=np.int64)
    np.cumsum(keep.sum(-1).ravel(), out=cell_woff[1:])
    if woff[-1] != int(mask.sum()) or woff[-1] >= 2 ** 31:
        raise ValueError(f"wave counts ({woff[-1]}) disagree with the "
                         f"mask ({int(mask.sum())}) or exceed int32")
    csr = WaveCSR(
        rows=torch.from_numpy(np.swapaxes(br.rows, 0, 1)[mask]),
        cols=torch.from_numpy(np.swapaxes(br.cols, 0, 1)[mask]),
        vals=torch.from_numpy(np.swapaxes(br.vals, 0, 1)[mask]),
        woff=torch.from_numpy(woff.astype(np.int32)),
        cell_woff=torch.from_numpy(cell_woff.astype(np.int32)))
    csr.check_bounds(br.m_local, br.n_local)
    return csr


def stream_csr(br: part.BlockedRatings) -> WaveCSR:
    """``partition.epoch_stream`` as a one-cell CSR over the flat
    ``(p * m_local, k)`` / ``(p * n_local, k)`` factors: every slot is a
    wave of its unmasked lanes; all-masked slots are dropped."""
    R, C, V, M = (torch.from_numpy(a)[None] for a in part.epoch_stream(br))
    csr = WaveCSR.from_padded(R, C, V, M)
    csr.check_bounds(br.p * br.m_local, br.p * br.n_local)
    return csr


def _local_epoch_body(Ws, Hs, cells, perm_src, lr, lam,
                      policy: KernelPolicy, entry):
    """Single-device schedule epoch.

    Ws: (p, m_local, k)   Hs: (p, n_local, k) where Hs[q] is the block
    *currently held* by worker q.  ``cells`` is the epoch's
    :class:`WaveCSR` (:func:`wave_csr`; step ``s`` is cells
    ``s*p .. s*p+p-1``).  ``perm_src`` is the schedule's (n_steps, p)
    post-step gather (``OwnershipSchedule.perm_sources``), ``entry`` the
    optional pre-epoch gather from the home placement to ``table[0]``
    (``None`` for the ring).  Each step updates the shards in place.
    """
    if entry is not None:
        Hs = Hs.index_select(0, entry)
    p = Ws.shape[0]
    for s in range(perm_src.shape[0]):
        Ws, Hs = kops.block_sgd_cells_csr(
            Ws, Hs, cells.cells(s * p, (s + 1) * p), lr, lam, policy=policy)
        # ownership transfer: worker q's next block comes from psrc[q]
        Hs = Hs.index_select(0, perm_src[s])
    # the last perm_src row routes every block back home
    return Ws, Hs


def _stream_epoch_body(Ws, Hs, data, lr, lam, policy: KernelPolicy,
                       entry):
    """One epoch over the flattened epoch stream (:func:`stream_csr`):
    slots of up to ``p`` concurrent updates whose rows and columns are
    pairwise disjoint, in the packed serial order, against the flat
    home-placement factors — no per-step permutation, no entry gather.
    Updates the shards in place (``entry`` is unused; it keeps the
    driver signature uniform)."""
    p, m_local, k = Ws.shape
    n_local = Hs.shape[1]
    block_sgd_waves_csr(Ws.view(1, p * m_local, k),
                        Hs.view(1, p * n_local, k), data, lr, lam,
                        compute_dtype=policy.compute_dtype)
    return Ws, Hs


def _steps_epoch_body(Ws, Hs, data, lr, lam, policy: KernelPolicy,
                      entry):
    """:func:`_local_epoch_body` adapted to the driver's ``data``
    signature (``data`` = the epoch's :class:`WaveCSR` plus the per-step
    permutation)."""
    cells, perm_src = data
    return _local_epoch_body(Ws, Hs, cells, perm_src, lr, lam, policy,
                             entry)


#: held-out ratings per gather of :func:`_sharded_rmse_body`: two fp32
#: ``(chunk, k)`` gathers, 800 MB at k=100 (the paper's full Netflix
#: holds out ~9.9 M ratings, 8 GB of gathers in one piece)
RMSE_CHUNK = 1 << 20


def _sharded_rmse_body(Ws, Hs, ridx, cidx, vals):
    """Test RMSE straight off the (p, m_local, k)/(p, n_local, k) factor
    shards.  ``ridx``/``cidx`` are flat shard indices
    (owner * local_size + local), so the gather reads exactly the values
    the unsharded matrices hold.  Evaluated in fp32 whatever the storage,
    :data:`RMSE_CHUNK` ratings at a time (one sum of squares per chunk,
    added in order)."""
    k = Ws.shape[-1]
    W, H = Ws.reshape(-1, k), Hs.reshape(-1, k)
    sse = torch.zeros((), dtype=torch.float32, device=Ws.device)
    for lo in range(0, max(vals.numel(), 1), RMSE_CHUNK):
        hi = lo + RMSE_CHUNK
        wi = W[ridx[lo:hi]].to(torch.float32)
        hj = H[cidx[lo:hi]].to(torch.float32)
        pred = torch.sum(wi * hj, dim=-1)
        sse = sse + torch.sum((vals[lo:hi].to(torch.float32) - pred) ** 2)
    return torch.sqrt(sse / vals.numel())


def _fused_driver(epoch_body):
    """Build a fused multi-epoch driver around an epoch body.

    ``lrs`` are the block's per-epoch learning rates (host floats,
    bitwise the loop path's) and ``rec_pos[e]`` the slot of epoch ``e``'s
    held-out RMSE in the ``(n_rec,)`` device trace (``-1`` = not
    recorded).  The trace and the divergence sentinel ``ok`` (all
    factors finite after every epoch; NaN/Inf is absorbing through SGD,
    so one flag per block is exact) stay on the device: the caller's
    read of them is the block's only host sync.
    """
    def train(Ws, Hs, data, lrs, rec_pos, lam, ridx, cidx, tvals, *,
              policy: KernelPolicy, entry=None, n_rec: int = 0):
        trace = torch.zeros(n_rec, dtype=torch.float32, device=Ws.device)
        ok = torch.ones((), dtype=torch.bool, device=Ws.device)
        for lr, pos in zip(lrs, rec_pos):
            Ws, Hs = epoch_body(Ws, Hs, data, lr, lam, policy, entry)
            ok = ok & torch.isfinite(Ws).all() & torch.isfinite(Hs).all()
            if pos >= 0:
                trace[pos] = _sharded_rmse_body(Ws, Hs, ridx, cidx, tvals)
        return Ws, Hs, trace, ok

    return train


_local_train_stream = _fused_driver(_stream_epoch_body)
_local_train_steps = _fused_driver(_steps_epoch_body)


def _record_slots(epochs: int, record_every: int, have_test: bool):
    """Which epochs of a ``train(epochs, ...)`` call record a held-out
    RMSE: every ``record_every``-th epoch plus always the final one
    (1-based offsets within the call).  The single source of the
    trace-recording rule for both dispatches."""
    if not have_test:
        return []
    return [i for i in range(1, epochs + 1)
            if i % record_every == 0 or i == epochs]


def _lr32(x) -> float:
    """A step size as the fp32 value every path computes with (the
    update accumulates in fp32 under every policy)."""
    return float(np.float32(x))


@dataclasses.dataclass
class NomadRingEngine:
    """Internal executor behind ``repro_torch.api.solve``: owns the
    packed blocks and the factor shards, on ``device`` (``None`` =
    ``"cuda"``; raises ``RuntimeError`` without CUDA).

    Executes the ``OwnershipSchedule`` its packing was laid out for
    (``br.schedule``; the ring by default).  ``stepsize`` is the
    per-epoch SGD step-size schedule, eq. (11).  ``mesh`` (SPMD across
    devices) is not supported yet.
    """
    br: part.BlockedRatings
    k: int
    lam: float
    stepsize: PowerSchedule
    impl: str = "xla"         # legacy: 'xla'|'pallas'|'auto'|'wave'|'wave_pallas'
    sub_blocks: int = 1
    mesh: Optional[object] = None
    policy: Optional[KernelPolicy] = None  # overrides impl/sub_blocks

    #: divergence sentinel: False once any train() call left a
    #: non-finite entry in the factor shards (exact either way, since
    #: NaN/Inf is absorbing through SGD updates).
    last_finite: bool = True
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "mesh= (SPMD over several devices) is not ported yet: "
                "ROADMAP.md Queue 1 item 9 [spmd]")
        self.device = resolve_device(self.device)
        if self.policy is None:
            self.policy = KernelPolicy.coerce(self.impl,
                                              sub_blocks=self.sub_blocks)
        else:
            self.impl = self.policy.impl
            self.sub_blocks = self.policy.sub_blocks
        self.epoch_idx = 0
        self._load_pack(self.br)

    def _load_pack(self, br: part.BlockedRatings):
        """Load the packed ratings onto the device, in the layout the
        policy's epoch function reads (built once per packing)."""
        self.br = br
        self.sched = br.schedule or OwnershipSchedule.ring(br.p)
        self.policy.check_packed(br, pipelined=False)
        dev = self.device
        self._perm_src = torch.from_numpy(
            self.sched.perm_sources().astype(np.int64)).to(dev)
        ent = self.sched.entry_sources()
        self._entry = (None if ent is None
                       else torch.from_numpy(ent.astype(np.int64)).to(dev))
        self._eval_cache = None
        impl = self.policy.impl
        if impl == "auto":      # as kernels.ops resolves it
            impl = "pallas" if dev.type == "cuda" else "xla"
        if impl in _STREAM_IMPLS:
            self._epoch = _stream_epoch_body
            self._train = _local_train_stream
            self._data = stream_csr(br).to(dev)
        else:
            self._epoch = _steps_epoch_body
            self._train = _local_train_steps
            cells = wave_csr(br, sequential=impl == "pallas").to(dev)
            self._data = (cells, self._perm_src)

    def grow(self, br_new: part.BlockedRatings, *, seed: int = 0,
             W_new=None, H_new=None):
        """Swap in an extended packing (from ``partition.repack_delta``)
        and grow the factor shards for the new rows/items.

        Existing W/H entries are preserved bit for bit (gathered off the
        old shards and re-scattered into the new layout); rows for the
        ``br_new.m - br.m`` new users and ``br_new.n - br.n`` new items
        come from ``objective.grow_factors`` (or the explicit
        ``W_new``/``H_new``, each overriding only its own side).
        ``epoch_idx`` is untouched, so the step-size schedule resumes
        where the previous arrival batch left it.
        """
        br_old = self.br
        if br_new.m < br_old.m or br_new.n < br_old.n:
            raise ValueError(
                f"grow() cannot shrink: ({br_new.m}, {br_new.n}) < "
                f"({br_old.m}, {br_old.n})")
        if not (np.array_equal(br_new.row_owner[: br_old.m],
                               br_old.row_owner)
                and np.array_equal(br_new.col_block[: br_old.n],
                                   br_old.col_block)):
            raise ValueError(
                "grow() needs a sticky extension of the current partition "
                "(existing row/col assignments unchanged); use "
                "partition.repack_delta")
        from .objective import grow_factors
        W, H = self.factors()
        m_new = br_new.m - br_old.m
        n_new = br_new.n - br_old.n
        W2, H2 = grow_factors(W, H, m_new, n_new, seed=seed)
        if W_new is not None:
            W2 = np.concatenate([W, self._new_rows("W_new", W_new, m_new)])
        if H_new is not None:
            H2 = np.concatenate([H, self._new_rows("H_new", H_new, n_new)])
        self._load_pack(br_new)
        self.init_factors(W2, H2)

    def _new_rows(self, name: str, rows, count: int) -> np.ndarray:
        rows = np.asarray(rows, np.float32)
        if rows.shape != (count, self.k):
            raise ValueError(f"{name} must have shape ({count}, {self.k}), "
                             f"got {rows.shape}")
        return rows

    def migrate(self, br_new: part.BlockedRatings, *, mesh="keep"):
        """Swap in a re-packing for a *different worker set* (from
        ``partition.repack_transition``): the engine half of an elastic
        resize or a failure recovery.  The global factors are gathered
        off the old shards and re-scattered into the new layout, so every
        row's and item's W/H values are preserved bit for bit; only their
        shard placement changes.  ``epoch_idx`` is untouched: the
        step-size schedule continues across the transition.  ``mesh``
        other than ``"keep"`` or ``None`` (SPMD) is not ported yet."""
        if not (mesh is None or (isinstance(mesh, str) and mesh == "keep")):
            raise NotImplementedError(
                "mesh= (SPMD over several devices) is not ported yet: "
                "ROADMAP.md Queue 1 item 9 [spmd]")
        if (br_new.m, br_new.n) != (self.br.m, self.br.n):
            raise ValueError(
                f"migrate() cannot change the problem shape: "
                f"({br_new.m}, {br_new.n}) != ({self.br.m}, {self.br.n})")
        W, H = self.factors()
        self._load_pack(br_new)
        self.init_factors(W, H)

    def init_factors(self, W0, H0):
        """Shard and load global ``(m, k)``/``(n, k)`` factors."""
        self.last_finite = True     # fresh factors, fresh sentinel
        self.Ws, self.Hs = factors_from_reference(
            W0, H0, self.br, dtype_policy=self.policy.dtype_policy,
            device=self.device)

    def run_epoch(self):
        lr = _lr32(self.stepsize(self.epoch_idx))
        self.Ws, self.Hs = self._epoch(self.Ws, self.Hs, self._data, lr,
                                       self.lam, self.policy, self._entry)
        self.epoch_idx += 1

    def factors(self):
        """Global numpy ``(W, H)`` (bf16 as its fp32 carrier)."""
        return factors_to_reference(self.Ws, self.Hs, self.br)

    # ------------------------------------------------------------------ #
    def _eval_args(self, test):
        """Device-resident (ridx, cidx, vals) for the sharded RMSE,
        memoized on the *content* of the test tuple (component arrays
        matched by identity first, then by value)."""
        key = tuple(np.asarray(a) for a in test)
        if self._eval_cache is not None:
            cached, args = self._eval_cache
            if len(cached) == len(key) and all(
                    a is b or (a.shape == b.shape and a.dtype == b.dtype
                               and np.array_equal(a, b))
                    for a, b in zip(cached, key)):
                return args
        br = self.br
        rows, cols = key[0], key[1]
        ridx = (br.row_owner[rows].astype(np.int64) * br.m_local
                + br.row_local[rows])
        cidx = (br.col_block[cols].astype(np.int64) * br.n_local
                + br.col_local[cols])
        args = (torch.from_numpy(ridx).to(self.device),
                torch.from_numpy(cidx).to(self.device),
                torch.tensor(key[2], dtype=torch.float32,
                             device=self.device))
        self._eval_cache = (key, args)
        return args

    def eval_rmse(self, test) -> float:
        """Test RMSE off the shards.  At epoch boundaries every nomadic H
        block is back home, so shard q holds exactly block q."""
        ridx, cidx, vals = self._eval_args(test)
        return float(_sharded_rmse_body(self.Ws, self.Hs, ridx, cidx, vals))

    def train(self, epochs: int, test=None, verbose=False, *,
              record_every: int = 1, dispatch: str = "loop",
              fuse_epochs: Optional[int] = None):
        """Run ``epochs`` epochs, recording the held-out RMSE every
        ``record_every`` epochs (plus always the final one).

        ``dispatch="loop"`` reads the RMSE on the host after each
        recorded epoch; ``"fused"`` runs ``fuse_epochs``-sized blocks
        (default: all epochs in one) with one host sync per block.  With
        ``verbose`` and no explicit ``fuse_epochs``, blocks default to
        one epoch so the progress prints stay live.  Bitwise-identical
        W/H/trace either way.

        Returns the ``[(epoch_idx, rmse), ...]`` trace list.
        """
        epochs = int(epochs)
        if record_every < 1:
            raise ValueError(
                f"record_every must be >= 1, got {record_every}")
        if dispatch not in ("loop", "fused"):
            raise ValueError(
                f"dispatch={dispatch!r} not in ('loop', 'fused')")
        if dispatch == "fused":
            return self._train_fused(epochs, test, verbose, record_every,
                                     fuse_epochs)
        recs = set(_record_slots(epochs, record_every, test is not None))
        eval_args = self._eval_args(test) if recs else None
        trace = []
        for i in range(1, epochs + 1):
            self.run_epoch()
            if i in recs:
                r = float(_sharded_rmse_body(self.Ws, self.Hs, *eval_args))
                trace.append((self.epoch_idx, r))
                if verbose:
                    print(f"epoch {self.epoch_idx}: test rmse {r:.4f}")
        if epochs > 0:
            self.last_finite = bool(torch.isfinite(self.Ws).all()
                                    & torch.isfinite(self.Hs).all())
        return trace

    def _train_fused(self, epochs: int, test, verbose,
                     record_every: int, fuse_epochs: Optional[int]):
        """Fused dispatch: epochs run in ``fuse_epochs``-sized blocks
        (default: all of them in one).  A block boundary is also a
        bitwise-exact resume point — the learning rates are re-derived
        from ``epoch_idx`` per block."""
        if fuse_epochs is not None and fuse_epochs < 1:
            raise ValueError(
                f"fuse_epochs must be >= 1 (or None), got {fuse_epochs}")
        block = fuse_epochs or (1 if verbose else max(epochs, 1))
        start = self.epoch_idx
        recs = _record_slots(epochs, record_every, test is not None)
        if recs:
            ridx, cidx, tvals = self._eval_args(test)
        else:
            ridx = cidx = torch.zeros(0, dtype=torch.int64,
                                      device=self.device)
            tvals = torch.zeros(0, dtype=torch.float32, device=self.device)
        trace = []
        done = 0
        # __call__-only schedules evaluate per epoch — which is all
        # PowerSchedule.values does anyway
        values = getattr(self.stepsize, "values",
                         lambda start, count: np.asarray(
                             [self.stepsize(start + i)
                              for i in range(count)], dtype=np.float64))
        while done < epochs:
            c = min(block, epochs - done)
            lrs = [_lr32(x) for x in values(self.epoch_idx, c)]
            chunk_recs = [i for i in recs if done < i <= done + c]
            pos = [-1] * c
            for j, i in enumerate(chunk_recs):
                pos[i - done - 1] = j
            self.Ws, self.Hs, tr, ok = self._train(
                self.Ws, self.Hs, self._data, lrs, pos, self.lam, ridx,
                cidx, tvals, policy=self.policy, entry=self._entry,
                n_rec=len(chunk_recs))
            self.epoch_idx += c
            done += c
            tr = tr.cpu().numpy()            # the block's single host sync
            self.last_finite = bool(ok)      # rides the same sync
            for j, i in enumerate(chunk_recs):
                trace.append((start + i, float(tr[j])))
                if verbose:
                    print(f"epoch {start + i}: test rmse {tr[j]:.4f}")
        return trace
