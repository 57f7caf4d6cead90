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
import time
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


def _cells_csr(rows, cols, vals, mask, cnt, m_tile: int, n_tile: int
               ) -> WaveCSR:
    """Padded per-cell rating lists ``(..., max)`` (cells flattened over
    the leading axes) and their wave sizes ``cnt (..., n_waves)`` as a
    CSR of waves, indices checked against the tiles."""
    keep = cnt > 0
    woff = np.zeros(int(keep.sum()) + 1, dtype=np.int64)
    np.cumsum(cnt[keep], out=woff[1:])
    cell_woff = np.zeros(int(np.prod(cnt.shape[:-1])) + 1, dtype=np.int64)
    np.cumsum(keep.sum(-1).ravel(), out=cell_woff[1:])
    if woff[-1] != int(mask.sum()) or woff[-1] >= 2 ** 31:
        raise ValueError(f"wave counts ({woff[-1]}) disagree with the "
                         f"mask ({int(mask.sum())}) or exceed int32")
    def tensor(a):      # a read-only (mapped) packing gives read-only views
        return torch.from_numpy(a if a.flags.writeable else a.copy())

    csr = WaveCSR(
        rows=tensor(rows[mask]), cols=tensor(cols[mask]),
        vals=tensor(vals[mask]),
        woff=torch.from_numpy(woff.astype(np.int32)),
        cell_woff=torch.from_numpy(cell_woff.astype(np.int32)))
    csr.check_bounds(m_tile, n_tile)
    return csr


def wave_csr(br: part.BlockedRatings, *, sequential: bool = False,
             worker: Optional[int] = None) -> WaveCSR:
    """One epoch's ratings as a CSR of waves on the CPU, step-major: cell
    ``s * p + q`` is worker ``q``'s cell at step ``s`` — or, with
    ``worker``, cell ``s`` is that worker's cell at step ``s`` (an SPMD
    rank's view; only its rows of the packed arrays are read).  Built
    from the flat lists (``br.rows/cols/vals``, wave-major in a wave
    packing) and ``br.wave_cnt`` — or, with ``sequential``, one wave per
    unmasked rating, in list order.  Indices are checked against the
    shard sizes here, once."""
    sel = slice(None) if worker is None else slice(worker, worker + 1)
    mask = np.swapaxes(br.mask[sel], 0, 1)            # (n_steps, p, max_nnz)
    if sequential:
        cnt = mask.astype(np.int64)
    elif br.wave_cnt is None:
        raise ValueError("wave_csr needs a packing with waves=True")
    else:
        cnt = np.swapaxes(br.wave_cnt[sel], 0, 1)     # (n_steps, p, n_waves)
    return _cells_csr(*(np.swapaxes(a[sel], 0, 1)
                        for a in (br.rows, br.cols, br.vals)),
                      mask, cnt, br.m_local, br.n_local)


def sub_block_csr(br: part.BlockedRatings, worker: int) -> WaveCSR:
    """Worker ``worker``'s pre-partitioned sub-block lists
    (``partition.pack(..., sub_blocks=...)``) as a sequential CSR, one
    wave per rating: cell ``s * sub_blocks + b`` is sub-block ``b`` of its
    cell at step ``s``, columns local to the sub-block."""
    mask = br.sub_mask[worker]              # (n_steps, sub_blocks, sub_max)
    width = int(np.diff(br.sub_starts).max())
    return _cells_csr(br.sub_rows[worker], br.sub_cols[worker],
                      br.sub_vals[worker], mask, mask.astype(np.int64),
                      br.m_local, width)


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


def _spmd_epoch_fn(mesh, lam: float, policy: KernelPolicy, *, plain: bool,
                   sub_starts=None,
                   sched: Optional[OwnershipSchedule] = None):
    """One rank's epoch of the SPMD executor (one worker's view), the
    counterpart of the JAX engine's ``shard_map`` body.  Returns
    ``epoch(Ws, Hs, cells, lr, log=None) -> (Ws, Hs)``.

    Rank ``q = mesh.rank`` holds its W shard ``Ws (1, m_local, k)`` and
    the H block it holds now, ``Hs (1, n_local, k)`` (its home block at
    epoch boundaries); ``cells`` is its CSR (:func:`wave_csr` with
    ``worker=q``, or :func:`sub_block_csr`).  At step ``s`` it updates its
    cell when ``sched.active[s, q]`` — through
    ``kops.block_sgd_cells_csr`` (one launch of the wave kernel on the
    card), or the plain version when ``plain`` (the ``'xla'``/``'wave'``
    impls) — and then hands its block on by the step's
    ``ppermute_pairs()[s]``: it sends to the rank that holds the block
    next and receives its next block into a second buffer, and the two
    buffers swap.  For the ring every step is the one constant shift (to
    ``(q + 1) % p``, from ``(q - 1) % p``); a general schedule first
    moves the blocks from home to ``table[0]`` (``entry_sources()``),
    and its last row sends every block home.  A slot that is not active
    runs no update but still hands its block on; a hop from a rank to
    itself touches no network.  Each hop is one ``batch_isend_irecv``
    of a send and a receive, posted alike on every rank
    (:meth:`~repro_torch.launch.mesh.McMesh.transfer`).

    With ``policy.sub_blocks > 1`` a step runs sub-block by sub-block
    (``sub_starts``): each sub-block's hop starts once its update is
    queued and is posted once the next sub-block's update is queued, so
    it travels while that one computes; the step waits for every hop.

    ``log``, when a list, gets one record per step: the updates'
    milliseconds (CUDA events on the card, the host clock on the CPU;
    each update is waited for), the host milliseconds spent on staging
    copies and on the network, and the step's wall milliseconds.
    """
    p, q = mesh.p, mesh.rank
    sched = sched or OwnershipSchedule.ring(p)
    src = sched.perm_sources()
    recv_from = src[:, q].tolist()
    send_to = np.argmax(src == q, axis=1).tolist()
    ent = sched.entry_sources()
    active = sched.active[:, q].tolist()
    n_sub = policy.sub_blocks
    bufs = {}

    def update(Ws, Hblk, csr, lr):
        if plain:
            block_sgd_waves_csr(Ws, Hblk, csr, lr, lam,
                                compute_dtype=policy.compute_dtype)
        else:
            kops.block_sgd_cells_csr(Ws, Hblk, csr, lr, lam, policy=policy)

    def timed_update(Ws, Hblk, csr, lr) -> float:
        if Ws.device.type != "cuda":
            t0 = time.perf_counter()
            update(Ws, Hblk, csr, lr)
            return (time.perf_counter() - t0) * 1e3
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        update(Ws, Hblk, csr, lr)
        ev[1].record()
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1])

    def epoch(Ws, Hs, cells: WaveCSR, lr, log=None):
        spare = bufs.pop("spare", None)
        if spare is None:
            spare = torch.empty_like(Hs)
        n_local = Hs.shape[1]
        bounds = ([0, n_local] if n_sub == 1
                  else [int(x) for x in sub_starts])
        if ent is not None and int(ent[q]) != q:
            mesh.transfer(Hs, int(np.argmax(ent == q)), spare,
                          int(ent[q])).wait()
            Hs, spare = spare, Hs
        for s in range(len(active)):
            t0 = time.perf_counter()
            kernel_ms, hops = 0.0, []
            for b in range(n_sub):
                lo, hi = bounds[b], bounds[b + 1]
                if active[s]:
                    csr = cells.cells(s * n_sub + b, s * n_sub + b + 1)
                    if log is None:
                        update(Ws, Hs[:, lo:hi], csr, lr)
                    else:
                        kernel_ms += timed_update(Ws, Hs[:, lo:hi], csr, lr)
                for t in hops:
                    t.post()
                if send_to[s] != q:
                    hops.append(mesh.transfer(Hs[:, lo:hi], send_to[s],
                                              spare[:, lo:hi], recv_from[s],
                                              tag=b))
            for t in hops:
                t.wait()
            if hops:
                Hs, spare = spare, Hs
            if log is not None:
                log.append(dict(
                    step=s, kernel_ms=kernel_ms,
                    stage_ms=1e3 * sum(t.stage_s for t in hops),
                    wire_ms=1e3 * sum(t.wire_s for t in hops),
                    wall_ms=1e3 * (time.perf_counter() - t0)))
        bufs["spare"] = spare
        return Ws, Hs

    return epoch


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


def _spmd_rmse_fn(mesh):
    """The held-out RMSE across the ranks of ``mesh``, as
    :func:`_sharded_rmse_body` computes it on one device: every H block
    (home at epoch boundaries) is gathered to every rank, each rank takes
    the squared errors of the held-out ratings whose W row it owns
    (``rloc``, ``cidx``, ``vals`` at positions ``pos`` of the ``n``
    ratings), a sum over the ranks places each in its slot (every slot
    has one contributor, so the sum is exact), and every rank adds the
    slots up in :data:`RMSE_CHUNK` pieces in order, as the one-device
    body does."""
    def rmse(Ws, Hs, rloc, cidx, vals, pos, n: int):
        k = Ws.shape[-1]
        dev = Ws.device
        W = Ws[0]
        H = mesh.all_gather(Hs[0], device=dev).reshape(-1, k)
        err = torch.zeros(n, dtype=torch.float32, device=dev)
        for lo in range(0, vals.numel(), RMSE_CHUNK):
            hi = lo + RMSE_CHUNK
            pred = torch.sum(W[rloc[lo:hi]].to(torch.float32)
                             * H[cidx[lo:hi]].to(torch.float32), dim=-1)
            err[pos[lo:hi]] = (vals[lo:hi] - pred) ** 2
        mesh.all_reduce_sum_(err)
        sse = torch.zeros((), dtype=torch.float32, device=dev)
        for lo in range(0, max(n, 1), RMSE_CHUNK):
            sse = sse + torch.sum(err[lo:lo + RMSE_CHUNK])
        return torch.sqrt(sse / n)

    return rmse


def _fused_driver(epoch_body, rmse_body=_sharded_rmse_body):
    """Build a fused multi-epoch driver around an epoch body.

    ``lrs`` are the block's per-epoch learning rates (host floats,
    bitwise the loop path's) and ``rec_pos[e]`` the slot of epoch ``e``'s
    held-out RMSE in the ``(n_rec,)`` device trace (``-1`` = not
    recorded).  The trace and the divergence sentinel ``ok`` (all
    factors finite after every epoch; NaN/Inf is absorbing through SGD,
    so one flag per block is exact) stay on the device: the caller's
    read of them is the block's only host sync.
    """
    def train(Ws, Hs, data, lrs, rec_pos, lam, eval_args, *,
              policy: KernelPolicy, entry=None, n_rec: int = 0):
        trace = torch.zeros(n_rec, dtype=torch.float32, device=Ws.device)
        ok = torch.ones((), dtype=torch.bool, device=Ws.device)
        for lr, pos in zip(lrs, rec_pos):
            Ws, Hs = epoch_body(Ws, Hs, data, lr, lam, policy, entry)
            ok = ok & torch.isfinite(Ws).all() & torch.isfinite(Hs).all()
            if pos >= 0:
                trace[pos] = rmse_body(Ws, Hs, *eval_args)
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


def _rank_shards(W0, H0, br: part.BlockedRatings, q: int,
                 policy: KernelPolicy, device):
    """Worker ``q``'s W shard and home H block of global factors, as
    ``(1, m_local, k)``/``(1, n_local, k)`` tensors in the policy's
    storage dtype (``part.shard_factors``' layout: real rows first, zero
    padding)."""
    out = []
    for A, of, size in ((W0, br.row_of[q], br.m_local),
                        (H0, br.col_of[q], br.n_local)):
        idx = of[of >= 0]
        S = np.zeros((size, A.shape[1]), dtype=np.float32)
        S[:idx.size] = np.asarray(A[idx], dtype=np.float32)
        out.append(torch.from_numpy(S)[None].to(
            device=device, dtype=policy.storage_dtype))
    return tuple(out)


@dataclasses.dataclass
class NomadRingEngine:
    """Internal executor behind ``repro_torch.api.solve``: owns the
    packed blocks and the factor shards, on ``device`` (``None`` =
    ``"cuda"``; raises ``RuntimeError`` without CUDA).

    Executes the ``OwnershipSchedule`` its packing was laid out for
    (``br.schedule``; the ring by default).  ``stepsize`` is the
    per-epoch SGD step-size schedule, eq. (11).

    With ``mesh`` (a :class:`~repro_torch.launch.mesh.McMesh`) the engine
    is one rank of the SPMD executor (:func:`_spmd_epoch_fn`): every rank
    constructs it with the same packing and calls the same methods in
    the same order.  It keeps only its rank's cells, W shard and held H
    block, on ``mesh.device``; ``factors()`` and the held-out RMSE are
    collective and give every rank the same values, bitwise those of the
    local executor.  ``grow`` and ``migrate`` do not run on a mesh yet.
    ``step_log``, when a list, receives the SPMD epoch's per-step
    records (:func:`_spmd_epoch_fn`).
    """
    br: part.BlockedRatings
    k: int
    lam: float
    stepsize: PowerSchedule
    impl: str = "xla"         # legacy: 'xla'|'pallas'|'auto'|'wave'|'wave_pallas'
    sub_blocks: int = 1
    mesh: Optional[object] = None  # a launch.mesh.McMesh: this rank's view
    policy: Optional[KernelPolicy] = None  # overrides impl/sub_blocks

    #: divergence sentinel: False once any train() call left a
    #: non-finite entry in the factor shards (exact either way, since
    #: NaN/Inf is absorbing through SGD updates).
    last_finite: bool = True
    device: Optional[Union[str, torch.device]] = None
    step_log: Optional[list] = None

    def __post_init__(self):
        if self.mesh is None:
            self.device = resolve_device(self.device)
        elif (self.device is not None
              and torch.device(self.device).type != self.mesh.device.type):
            raise ValueError(f"device={self.device!r} but the mesh's ranks "
                             f"run on {self.mesh.device}")
        else:
            self.device = self.mesh.device
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
        self._eval_cache = None
        dev = self.device
        impl = self.policy.impl
        if impl == "auto":      # as kernels.ops resolves it
            impl = "pallas" if dev.type == "cuda" else "xla"
        if self.mesh is not None:
            self._load_rank_pack(br, plain=impl in _STREAM_IMPLS)
            return
        self._rmse = _sharded_rmse_body
        self.policy.check_packed(br, pipelined=False)
        self._perm_src = torch.from_numpy(
            self.sched.perm_sources().astype(np.int64)).to(dev)
        ent = self.sched.entry_sources()
        self._entry = (None if ent is None
                       else torch.from_numpy(ent.astype(np.int64)).to(dev))
        if impl in _STREAM_IMPLS:
            self._epoch = _stream_epoch_body
            self._train = _local_train_stream
            self._data = stream_csr(br).to(dev)
        else:
            self._epoch = _steps_epoch_body
            self._train = _local_train_steps
            cells = wave_csr(br, sequential=impl == "pallas").to(dev)
            self._data = (cells, self._perm_src)

    def _load_rank_pack(self, br: part.BlockedRatings, *, plain: bool):
        """:meth:`_load_pack` of one SPMD rank: only its cells, for every
        step (its sub-block lists when ``sub_blocks > 1``)."""
        mesh = self.mesh
        if mesh.p != br.p:
            raise ValueError(f"the mesh has {mesh.p} ranks but the packing "
                             f"wants p={br.p}")
        self.policy.check_packed(br, pipelined=True)
        if self.policy.sub_blocks > 1:
            cells = sub_block_csr(br, mesh.rank)
        else:
            cells = wave_csr(br, sequential=not self.policy.wave,
                             worker=mesh.rank)
        self._data = cells.to(self.device)
        self._perm_src = self._entry = None
        epoch = _spmd_epoch_fn(mesh, self.lam, self.policy, plain=plain,
                               sub_starts=br.sub_starts, sched=self.sched)
        self._epoch = (lambda Ws, Hs, data, lr, lam, policy, entry:
                       epoch(Ws, Hs, data, lr, self.step_log))
        self._rmse = _spmd_rmse_fn(mesh)
        self._train = _fused_driver(self._epoch, self._rmse)

    def _refuse_on_mesh(self, what: str) -> None:
        if self.mesh is not None:
            raise NotImplementedError(
                f"{what} on a mesh (SPMD) is not ported yet: ROADMAP.md "
                "Queue 1 item 9 [spmd]")

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
        self._refuse_on_mesh("grow()")
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
        self._refuse_on_mesh("migrate()")
        if (br_new.m, br_new.n) != (self.br.m, self.br.n):
            raise ValueError(
                f"migrate() cannot change the problem shape: "
                f"({br_new.m}, {br_new.n}) != ({self.br.m}, {self.br.n})")
        W, H = self.factors()
        self._load_pack(br_new)
        self.init_factors(W, H)

    def init_factors(self, W0, H0):
        """Shard and load global ``(m, k)``/``(n, k)`` factors (on a mesh,
        only the rank's W shard and home H block: the other rows of
        ``W0``/``H0`` are not read)."""
        self.last_finite = True     # fresh factors, fresh sentinel
        if self.mesh is not None:
            self.Ws, self.Hs = _rank_shards(W0, H0, self.br, self.mesh.rank,
                                            self.policy, self.device)
            return
        self.Ws, self.Hs = factors_from_reference(
            W0, H0, self.br, dtype_policy=self.policy.dtype_policy,
            device=self.device)

    def run_epoch(self):
        lr = _lr32(self.stepsize(self.epoch_idx))
        self.Ws, self.Hs = self._epoch(self.Ws, self.Hs, self._data, lr,
                                       self.lam, self.policy, self._entry)
        self.epoch_idx += 1

    def factors(self):
        """Global numpy ``(W, H)`` (bf16 as its fp32 carrier); on a mesh
        gathered to every rank (collective)."""
        if self.mesh is None:
            return factors_to_reference(self.Ws, self.Hs, self.br)
        return factors_to_reference(self.mesh.all_gather(self.Ws[0]),
                                    self.mesh.all_gather(self.Hs[0]),
                                    self.br)

    def _all_finite(self, ok) -> bool:
        """``ok``, AND-reduced over the ranks on a mesh."""
        return (bool(ok) if self.mesh is None
                else self.mesh.all_true(bool(ok)))

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
        rows, cols, vals = key[0], key[1], key[2]
        own = None
        if self.mesh is not None:       # the ratings whose W row is ours
            own = np.flatnonzero(br.row_owner[rows] == self.mesh.rank)
            rows, cols, vals = rows[own], cols[own], vals[own]
            ridx = br.row_local[rows].astype(np.int64)
        else:
            ridx = (br.row_owner[rows].astype(np.int64) * br.m_local
                    + br.row_local[rows])
        cidx = (br.col_block[cols].astype(np.int64) * br.n_local
                + br.col_local[cols])
        args = (torch.from_numpy(ridx).to(self.device),
                torch.from_numpy(cidx).to(self.device),
                torch.tensor(vals, dtype=torch.float32, device=self.device))
        if own is not None:
            args += (torch.from_numpy(own.astype(np.int64)).to(self.device),
                     len(key[2]))
        self._eval_cache = (key, args)
        return args

    def eval_rmse(self, test) -> float:
        """Test RMSE off the shards.  At epoch boundaries every nomadic H
        block is back home, so shard q holds exactly block q."""
        return float(self._rmse(self.Ws, self.Hs, *self._eval_args(test)))

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
                r = float(self._rmse(self.Ws, self.Hs, *eval_args))
                trace.append((self.epoch_idx, r))
                if verbose:
                    print(f"epoch {self.epoch_idx}: test rmse {r:.4f}")
        if epochs > 0:
            self.last_finite = self._all_finite(
                torch.isfinite(self.Ws).all() & torch.isfinite(self.Hs).all())
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
        eval_args = self._eval_args(test) if recs else ()
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
                self.Ws, self.Hs, self._data, lrs, pos, self.lam, eval_args,
                policy=self.policy, entry=self._entry, n_rec=len(chunk_recs))
            self.epoch_idx += c
            done += c
            tr = tr.cpu().numpy()            # the block's single host sync
            self.last_finite = self._all_finite(ok)  # rides the same sync
            for j, i in enumerate(chunk_recs):
                trace.append((start + i, float(tr[j])))
                if verbose:
                    print(f"epoch {start + i}: test rmse {tr[j]:.4f}")
        return trace
