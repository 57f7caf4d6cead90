"""Baseline matrix-completion optimizers the paper compares against, on
tensors on an explicit device.

* DSGD      [Gemulla et al., 2011]  — bulk-synchronous p x p block rotation
* CCD++     [Yu et al., 2012]       — feature-wise coordinate descent with
                                      residual maintenance
* ALS       [Zhou et al., 2008]     — exact alternating least squares
* Hogwild   [Recht et al., 2011]    — lock-free minibatch SGD with racing
                                      (sum-combined) updates; NON-serializable,
                                      the contrast class for NOMAD

Each takes COO ratings (numpy) and returns numpy ``(W, H, trace)``, with
the JAX package's signatures plus ``device=`` (``None`` = ``"cuda"``).
Cold starts draw :func:`~.objective.init_factors` on a CPU generator
seeded with ``seed``, as the port's NOMAD solve does.

* DSGD runs each sub-epoch's ``p`` disjoint cells as one launch of the
  CUDA wave kernel over the epoch's sequential CSR (every rating its own
  wave: the update ``nomad_sgd_block`` computes), then rotates the H
  blocks.  The JAX package runs XLA's serial scan there; the update order
  and math are the same, so DSGD equals NOMAD's ring bitwise.  On CPU
  tensors the kernel's wrapper runs its plain version.
* CCD++ and Hogwild sum with ``index_add_``: float atomics on CUDA, so a
  run on the card may differ from another in the last bits.  The JAX
  package promises only a statistical resume for these two.  On the card
  Hogwild replays runs of minibatches as CUDA graphs (its eager loop is
  host-bound).
* ALS builds the per-row normal equations in chunks of rows of similar
  degree, each chunk's Gram matrices one ``torch.bmm`` over a fixed
  layout (:data:`ALS_SLOTS`, :data:`ALS_ROWS`), never the ``(nnz, k, k)``
  outer products: the summation order depends only on the data, so a
  warm start equals the uninterrupted run bitwise on the card as on the
  CPU.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from . import partition as part
from .nomad import _lr32, _sharded_rmse_body, wave_csr
from .objective import init_factors
from .stepsize import PowerSchedule
from .._device import resolve_device
from ..convert import factors_from_reference, factors_to_reference
from ..kernels import ops as kops
from ..kernels.policy import KernelPolicy

__all__ = ["dsgd", "ccdpp", "als", "hogwild"]

#: DSGD's update: the kernel's sequential route, one launch per sub-epoch
_DSGD_POLICY = KernelPolicy(impl="pallas")
#: ratings per gather when CCD++ forms its residuals (two fp32 ``(chunk,
#: k)`` gathers, 800 MB at k=100)
RES_CHUNK = 1 << 20
#: ALS: rating slots (rows x padded degree) gathered per chunk, as fp32
#: ``(slots, k)`` factor rows: 1.7 GB at k=100
ALS_SLOTS = 1 << 22
#: ALS: rows per chunk at most; their ``(rows, k, k)`` fp32 Gram matrices
#: take 2.6 GB at k=100, and the solve as much again
ALS_ROWS = 1 << 16
#: Hogwild on the card: minibatches per CUDA-graph replay (one eager
#: minibatch is ~14 launches of host time, ~0.16 ms at k=100)
HOG_GRAPH = 1024


def _start(W0, H0, m: int, n: int, k: int, seed: int
           ) -> Tuple[np.ndarray, np.ndarray]:
    """The given factors as fp32 numpy, or the seeded cold start."""
    if W0 is None:
        gen = torch.Generator().manual_seed(int(seed))
        W0, H0 = init_factors(gen, m, n, k)
        return W0.numpy(), H0.numpy()
    return (np.asarray(W0, dtype=np.float32),
            np.asarray(H0, dtype=np.float32))


def _on(device, *arrays, dtype=None) -> List[torch.Tensor]:
    """Copies of numpy arrays on ``device`` (never views of the caller's
    arrays: Hogwild updates its factors in place)."""
    return [torch.tensor(np.asarray(a), dtype=dtype, device=device)
            for a in arrays]


def _test_args(test, device):
    if test is None:
        return None
    r, c, v = test
    return (*_on(device, r, c, dtype=torch.int64),
            *_on(device, v, dtype=torch.float32))


# --------------------------------------------------------------------- #
# DSGD                                                                   #
# --------------------------------------------------------------------- #

def _dsgd_subepoch(Ws, Hs, cells, lr, lam):
    """One DSGD sub-epoch: every worker updates its current diagonal block
    (disjoint rows x disjoint cols: one launch for the ``p`` cells of
    ``cells``, in place), then a bulk synchronization rotates the H
    blocks (worker ``q`` takes worker ``q - 1``'s, ``jnp.roll(Hs, 1,
    axis=0)``)."""
    Ws, Hs = kops.block_sgd_cells_csr(Ws, Hs, cells, lr, lam,
                                      policy=_DSGD_POLICY)
    return Ws, torch.roll(Hs, 1, 0)


def dsgd(rows, cols, vals, m, n, k, p, *, lam=0.05, epochs=10,
         schedule: Optional[PowerSchedule] = None, seed=0, test=None,
         W0=None, H0=None, start_epoch=0,
         br: Optional[part.BlockedRatings] = None, device=None):
    """Bulk-synchronous DSGD.  Identical update math and order to NOMAD's
    ring: slot ``(q, s)`` of the ring packing holds cell ``(q, (q - s)
    mod p)``, the block worker ``q`` holds after ``s`` rotations.

    ``start_epoch`` resumes the step-size schedule mid-run (a warm start
    equals one uninterrupted run bitwise).  ``br`` is a ring packing of
    these ratings to reuse (``pack(..., balanced=True, waves=False)``);
    it is built here when ``None``."""
    dev = resolve_device(device)
    schedule = schedule or PowerSchedule()
    if br is None:
        br = part.pack(rows, cols, vals, m, n, p, balanced=True,
                       waves=False)
    if br.schedule is not None and not br.schedule.is_ring:
        raise ValueError(f"DSGD rotates the H blocks on the ring; the "
                         f"packing is for schedule {br.schedule.name!r}")
    W0, H0 = _start(W0, H0, m, n, k, seed)
    Ws, Hs = factors_from_reference(W0, H0, br, device=dev)
    cells = wave_csr(br, sequential=True).to(dev)
    steps = [cells.cells(s * p, (s + 1) * p) for s in range(p)]
    ev = None
    if test is not None:
        r, c = np.asarray(test[0]), np.asarray(test[1])
        ev = _test_args((br.row_owner[r].astype(np.int64) * br.m_local
                         + br.row_local[r],
                         br.col_block[c].astype(np.int64) * br.n_local
                         + br.col_local[c], test[2]), dev)
    trace = []
    for e in range(start_epoch, start_epoch + epochs):
        lr = _lr32(schedule(e))
        for step in steps:
            Ws, Hs = _dsgd_subepoch(Ws, Hs, step, lr, lam)
        if ev is not None:
            trace.append((e + 1, float(_sharded_rmse_body(Ws, Hs, *ev))))
    W, H = factors_to_reference(Ws, Hs, br)
    return W, H, trace


# --------------------------------------------------------------------- #
# CCD++                                                                  #
# --------------------------------------------------------------------- #

def _segment_sum(x, seg, count: int):
    return torch.zeros(count, dtype=x.dtype, device=x.device).index_add_(
        0, seg, x)


def _ccd_feature_pass(wl, hl, res_plus, rows, cols, lam_r, lam_c, inner=3):
    """Given residual-plus matrix entries ``res_plus = R_ij + w_il h_jl``,
    alternately solve the rank-1 fit  min sum (res_plus - w h)^2 + reg."""
    m, n = wl.shape[0], hl.shape[0]
    for _ in range(inner):
        # update w: w_i = sum_j res+ * h_j / (lam_r_i + sum h_j^2)
        hc = hl[cols]
        wl = (_segment_sum(res_plus * hc, rows, m)
              / (_segment_sum(hc ** 2, rows, m) + lam_r))
        wr = wl[rows]
        hl = (_segment_sum(res_plus * wr, cols, n)
              / (_segment_sum(wr ** 2, cols, n) + lam_c))
    return wl, hl


def _residuals(W, H, rows, cols, vals):
    """``vals - <w_i, h_j>``, :data:`RES_CHUNK` ratings per gather."""
    res = torch.empty_like(vals)
    for lo in range(0, vals.numel(), RES_CHUNK):
        hi = lo + RES_CHUNK
        res[lo:hi] = vals[lo:hi] - torch.sum(W[rows[lo:hi]]
                                             * H[cols[lo:hi]], dim=-1)
    return res


def ccdpp(rows, cols, vals, m, n, k, *, lam=0.05, epochs=10, inner=3,
          seed=0, test=None, W0=None, H0=None, start_epoch=0, device=None):
    """CCD++ with residual maintenance (feature-wise alternating CD).
    ``start_epoch`` only offsets the trace's epoch labels (no schedule).
    The factors are held transposed, ``(k, m)``/``(k, n)``, so a feature
    is one contiguous row."""
    dev = resolve_device(device)
    rows, cols = _on(dev, rows, cols, dtype=torch.int64)
    vals, = _on(dev, vals, dtype=torch.float32)
    W0, H0 = _start(W0, H0, m, n, k, seed)
    W, H = _on(dev, W0, H0)
    ev = _test_args(test, dev)
    # weighted regularization (eq. 1): lam * |Omega_i| per row
    ones = torch.ones_like(vals)
    lam_r = lam * _segment_sum(ones, rows, m)
    lam_c = lam * _segment_sum(ones, cols, n)
    del ones
    res = _residuals(W, H, rows, cols, vals)
    Wt, Ht = W.T.contiguous(), H.T.contiguous()
    del W, H
    trace = []
    for e in range(start_epoch, start_epoch + epochs):
        for l in range(k):
            wl, hl = Wt[l], Ht[l]
            res_plus = res + wl[rows] * hl[cols]
            wl, hl = _ccd_feature_pass(wl, hl, res_plus, rows, cols,
                                       lam_r, lam_c, inner=inner)
            res = res_plus - wl[rows] * hl[cols]
            Wt[l], Ht[l] = wl, hl
        if ev is not None:
            trace.append((e + 1, float(_sharded_rmse_body(Wt.T, Ht.T, *ev))))
    return (Wt.T.contiguous().cpu().numpy(),
            Ht.T.contiguous().cpu().numpy(), trace)


# --------------------------------------------------------------------- #
# ALS                                                                    #
# --------------------------------------------------------------------- #

class _RowGroups:
    """The ratings of one side grouped by the row they solve for: sorted
    by row once (stable), with the rows in chunks of one padded degree
    ``D`` (the next power of two of the row's count) and at most
    ``max(1, slots // D)`` and ``max_rows`` rows.  A chunk's ``(rows,
    D)`` slots index the sorted ratings; a row's unused slots point at a
    sentinel rating of value 0 on the other side's sentinel zero row."""

    def __init__(self, rows, cols, vals, m: int, n: int, device, *,
                 slots: int = ALS_SLOTS, max_rows: int = ALS_ROWS):
        rows_n = np.asarray(rows)
        deg = np.bincount(rows_n, minlength=m).astype(np.int64)
        r, c = _on(device, rows_n, cols, dtype=torch.int64)
        v, = _on(device, vals, dtype=torch.float32)
        order = torch.sort(r, stable=True).indices
        nnz = r.numel()
        # the sentinel rating (position nnz) reads the other side's row
        # n, which normal_equations appends as zeros
        self.other = torch.cat([c[order], c.new_full((1,), n)])
        self.vals = torch.cat([v[order], v.new_zeros(1)])
        off = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(deg, out=off[1:])
        self.off = torch.from_numpy(off).to(device)
        self.deg = torch.from_numpy(deg).to(device)
        self.nnz = nnz
        pad = 1 << np.ceil(np.log2(np.maximum(deg, 1))).astype(np.int64)
        by = np.argsort(pad, kind="stable")
        self.chunks: List[Tuple[torch.Tensor, int]] = []
        sizes = pad[by]
        for D in np.unique(sizes).tolist():
            ids = by[sizes == D]
            step = max(1, min(max_rows, slots // D))
            for lo in range(0, len(ids), step):
                self.chunks.append(
                    (torch.from_numpy(ids[lo:lo + step]).to(device), D))

    def normal_equations(self, F, lam) -> Iterator[Tuple[torch.Tensor, ...]]:
        """Per chunk ``(ids, M, b)``: ``M_i = F_{O_i}^T F_{O_i} +
        (lam |O_i| + 1e-8) I`` and ``b_i = F_{O_i}^T a_i`` of its rows."""
        k = F.shape[1]
        Fp = torch.cat([F, F.new_zeros(1, k)])
        for ids, D in self.chunks:
            cnt = self.deg[ids]
            lane = torch.arange(D, device=F.device)
            pos = torch.where(lane[None, :] < cnt[:, None],
                              self.off[ids][:, None] + lane[None, :],
                              self.nnz)
            g = Fp[self.other[pos]]                          # (R, D, k)
            gt = g.transpose(1, 2)
            M = torch.bmm(gt, g)
            b = torch.bmm(gt, self.vals[pos][:, :, None])
            M.diagonal(dim1=1, dim2=2).add_(
                (lam * cnt.to(F.dtype) + 1e-8)[:, None])
            yield ids, M, b


def _als_solve_side(F, groups: _RowGroups, lam, m: int):
    """w_i <- (F_{O_i}^T F_{O_i} + lam |O_i| I)^{-1} F^T a_i for every
    row, chunk by chunk (:meth:`_RowGroups.normal_equations`)."""
    out = F.new_empty((m, F.shape[1]))
    for ids, M, b in groups.normal_equations(F, lam):
        out[ids] = torch.linalg.solve(M, b)[..., 0]
    return out


def als(rows, cols, vals, m, n, k, *, lam=0.05, epochs=10, seed=0,
        test=None, W0=None, H0=None, start_epoch=0, device=None):
    dev = resolve_device(device)
    W0, H0 = _start(W0, H0, m, n, k, seed)
    W, H = _on(dev, W0, H0)
    by_row = _RowGroups(rows, cols, vals, m, n, dev)
    by_col = _RowGroups(cols, rows, vals, n, m, dev)
    ev = _test_args(test, dev)
    trace = []
    for e in range(start_epoch, start_epoch + epochs):
        W = _als_solve_side(H, by_row, lam, m)
        H = _als_solve_side(W, by_col, lam, n)
        if ev is not None:
            trace.append((e + 1, float(_sharded_rmse_body(W, H, *ev))))
    return W.cpu().numpy(), H.cpu().numpy(), trace


# --------------------------------------------------------------------- #
# Hogwild-style ASGD                                                     #
# --------------------------------------------------------------------- #

def _hogwild_minibatch(W, H, rows, cols, vals, lr, lam):
    """A 'parallel' minibatch where conflicting updates race; the
    scatter-add models the sum-combination of racy lock-free writes, in
    place.  Deliberately non-serializable — the contrast class of
    §4.2/§4.3."""
    wi = W.index_select(0, rows)
    hj = H.index_select(0, cols)
    err = vals - torch.sum(wi * hj, dim=-1)
    gw = -err[:, None] * hj + lam * wi
    gh = -err[:, None] * wi + lam * hj
    W.index_add_(0, rows, gw, alpha=-lr)
    H.index_add_(0, cols, gh, alpha=-lr)
    return W, H


def _hogwild_epoch(W, H, R, C, V, nb: int, batch: int, lr, lam):
    """Minibatches ``0 .. nb-1`` of the permuted ratings ``R, C, V``, in
    order, in place.  On the card, runs of :data:`HOG_GRAPH` of them are
    one CUDA graph of the same launches, replayed over each run's slices
    (copied into the graph's inputs); the rest run eagerly."""
    done = 0
    if W.device.type == "cuda" and nb >= HOG_GRAPH:
        span = HOG_GRAPH * batch
        bufs = [t[:span].clone() for t in (R, C, V)]

        def body(W_, H_):
            for g in range(HOG_GRAPH):
                lo, hi = g * batch, (g + 1) * batch
                _hogwild_minibatch(W_, H_, bufs[0][lo:hi], bufs[1][lo:hi],
                                   bufs[2][lo:hi], lr, lam)

        side = torch.cuda.Stream(W.device)     # warm-up on copies
        side.wait_stream(torch.cuda.current_stream(W.device))
        with torch.cuda.stream(side):
            body(W.clone(), H.clone())
        torch.cuda.current_stream(W.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body(W, H)
        runs = nb // HOG_GRAPH
        for r in range(runs):
            for buf, t in zip(bufs, (R, C, V)):
                buf.copy_(t[r * span:(r + 1) * span])
            graph.replay()
        done = runs * HOG_GRAPH
    for b in range(done, nb):
        lo, hi = b * batch, (b + 1) * batch
        _hogwild_minibatch(W, H, R[lo:hi], C[lo:hi], V[lo:hi], lr, lam)


def hogwild(rows, cols, vals, m, n, k, *, lam=0.05, epochs=10, batch=256,
            schedule: Optional[PowerSchedule] = None, seed=0, test=None,
            W0=None, H0=None, start_epoch=0, device=None):
    """``start_epoch`` resumes the schedule; note the shuffle rng restarts
    per call, so a warm-started run is statistically (not bitwise)
    equivalent to an uninterrupted one.  Each epoch's permutation is the
    JAX package's (``np.random.default_rng(seed)``), applied on the device
    to the ratings uploaded once; its minibatches are slices of it
    (:func:`_hogwild_epoch`: CUDA graphs on the card)."""
    dev = resolve_device(device)
    schedule = schedule or PowerSchedule()
    R, C = _on(dev, rows, cols, dtype=torch.int64)
    V, = _on(dev, vals, dtype=torch.float32)
    W0, H0 = _start(W0, H0, m, n, k, seed)
    W, H = _on(dev, W0, H0)
    ev = _test_args(test, dev)
    rng = np.random.default_rng(seed)
    nnz = R.numel()
    nb = max(1, nnz // batch)
    trace = []
    for e in range(start_epoch, start_epoch + epochs):
        lr = _lr32(schedule(e))
        perm = torch.from_numpy(rng.permutation(nnz)).to(dev)
        _hogwild_epoch(W, H, R[perm], C[perm], V[perm], nb, batch, lr, lam)
        del perm
        if ev is not None:
            trace.append((e + 1, float(_sharded_rmse_body(W, H, *ev))))
    return W.cpu().numpy(), H.cpu().numpy(), trace
