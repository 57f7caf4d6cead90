#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # Netflix x 0.1, k=100, p=8, 3 epochs;
                                     # then Qwen2.5-32B serving

Phases, one line each (any failure raises and exits non-zero):

0. device: the card's name and power limit (nvidia-smi), torch, CUDA and
   nvcc versions;
1. build: compiles ``src/repro_torch/kernels/csrc/*.cu`` (one nvcc per
   source, in parallel, sm_90a) and prints the build seconds;
2. data + pack of the main path's problem, then every kernel wrapper
   against its plain PyTorch version on cells cut from that pack, at
   k=100, in fp32 and in bf16 with fp32 accumulation (bf16 also held to
   ``repro_torch.testing.assert_rare_flips``, with two controls that it
   must reject: the plain version accumulating in bf16, and no update at
   all); grid == per-cell == sequential, bitwise;
3. the main path: ``repro_torch.api.solve`` with ``kernel="wave_pallas"``
   for 3 epochs (one kernel launch per schedule step), then one epoch
   of each other route (``wave_pallas`` per cell, and ``pallas``: every
   rating its own wave, one launch per step), each with the launch
   counts zeroed before and read after, and a sha256 digest of its
   factors (equal digests from two trees in one call: bitwise equal
   results); and a small problem solved on the card against the plain
   versions on the CPU;
4. timing with CUDA events on the main path's real step layout, for
   each route the launch it makes, beside its byte bound, chain length,
   chain bound and the plain version's time on the same inputs, with the
   kernel's plan (``variant``) on every line; where the hottest cell's
   waves spend their time (``[4.wave.split]``, ``clock64()`` samples of
   the kernel's profile build) with H in global memory beside the ring
   and as the plan lays it out, each bitwise the launch's result; the
   variant for an H block too large for shared memory (``[4.hglobal]``,
   2,222 item rows, the plan must keep H in global memory) against its
   plain version; and
   ``nomad_sgd_block`` on a whole cell, bitwise equal to the sequential
   route's launch;
5. serving: the main path's result saved with ``save_fit_result``,
   ``RecServer.from_checkpoint`` booted from it (factors bitwise the
   trained ones), 2,000 queries through ``serve_mc.run_load`` (4 clients,
   ``max_batch=64``, top-10) without and with ``filter_rated``, every
   microbatch through the CUDA top-k kernel and none through its plain
   version; then the kernel against its plain version on the trained
   factors (within tolerance) at every user bucket the serving runs
   launched (top-10 and their filtered over-fetch) and at U=64, and its
   time, taken three times;
6. the top-k kernel at the Yahoo! Music catalog (624,961 items, 1,999,990
   users, k=100) on seeded factors published through ``FactorStore`` in
   fp32, bf16 and int8: for U in {1, 8, 64} users at top-10 and U=64 at
   top-1,000, its plan (users per CTA, stripes, shared memory, registers
   from ``cudaFuncGetAttributes``) and time (CUDA events) beside its
   bound, the plain version's and ``torch.topk(W_u @ H.T)``'s, and at
   U=64 where the device time goes (``[6.topk.split]``: pass 1, the
   merge rounds, the decode, and pass 1 scoring alone); bitwise against
   the plain version on integer-valued factors and on a catalog whose
   scores rise with the item id (every item passes the threshold), with
   that catalog's time; within tolerance on the seeded factors; and a
   control that must be rejected (the tie rule reversed);
7. the LM: Qwen2.5-32B at full width and depth (64 layers, bf16, seeded
   weights on the card) served through ``repro_torch.launch.serve``:
   prefill of 4 prompts of 1,024 tokens (every layer's attention through
   the CUDA flash kernel, none through its plain version), the merge into
   decode caches of 1,056 positions and 32 greedy decode steps, twice
   (warm-up, measured); prefill and decode times beside their bounds,
   peak memory; on the same weights the prefill's logits with the kernel
   against the plain chunked flash (``impl="xla"``), a control that
   check must reject (the first layer's attention unmasked), and decode
   after prefill against the full forward; the prefill and 4 decode steps
   under ``torch.profiler`` (device busy share, largest kernels); then
   each flash kernel's registers, shared memory and spills
   (``cudaFuncGetAttributes``); the kernel against its plain version at
   the served shape in bf16, fp16 and fp32 (fp32 also against the
   materialized oracle; bf16/fp16 within the P-rounding bound of
   ``repro_torch.testing.flash_p_rounding_tolerance``) and in bf16 at
   (S, D) = (200, 64) and (1024, 36), two controls it must reject in
   each (no causal mask; KV head ``h % Hkv``), and at the served shape
   its time beside its bound, the plain version's and SDPA's;
8. streaming, elasticity and integrity at the main path's full width,
   warm from phase 3's result (its pack a cache hit): a
   ``StreamingSession`` absorbs three arrival batches (each 1 % new
   ratings, 1 % new users and items, a 5 % held-out share), one epoch
   each (``[8.stream]``: repack, grow and epoch seconds, the layout and
   the kernel's plan, RMSE and digest per round), equal to the same
   chain through ``partial_fit``; a worker leaves and one joins
   (``[8.elastic]``: re-pack and migrate seconds), and after every grow
   and migrate the wave kernel runs the new layout's hottest step (256
   waves) against its plain version, with a control it must reject; a
   killed worker recovers from the session's checkpoints onto the
   digest of a graceful twin, once more with the newest checkpoint
   bit-flipped (quarantined) (``[8.kill]``); ``solve(faults=)`` cut
   after 2 epochs and resumed equals phase 3's run (``[8.faults]``); a
   ``FactorStore`` attached to the session serves 64 queries (16 new
   users) after every round, every microbatch through the CUDA top-k
   kernel and none through its plain version, one version per round
   (``[8.swap]``).  Each path is driven with the launch counts zeroed
   before and read after.

The line before the last is a JSON record of the kernels; the last line
is ``{"ok": true, "device": {...}}``.  Without CUDA the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
EPOCHS = 3
KERNEL_SRC = "src/repro_torch/kernels/csrc/nomad_sgd.cu"
TOPK_SRC = "src/repro_torch/kernels/csrc/topk.cu"
#: the pallas_call of the JAX package's serving top-k kernel
TOPK_REPLACES = "src/repro/serve/topk.py:312"
#: the Yahoo! Music catalog (configs/nomad_mf.py): items, users, rank
YAHOO_N, YAHOO_M, YAHOO_K = 624_961, 1_999_990, 100
SERVE_QUERIES = 2000
#: the Pallas kernel (pallas_call line) each route's launches replace:
#: all three routes launch the one CUDA kernel through
#: ``nomad_sgd_waves_csr``
REPLACES = {
    "grid": "src/repro/kernels/nomad_sgd.py:381",        # waves_grid
    "per_cell": "src/repro/kernels/nomad_sgd.py:259",    # waves_block
    "sequential": "src/repro/kernels/nomad_sgd.py:146",  # nomad_sgd_block
}
#: the padded wrappers with the JAX package's signatures
PADDED = ("nomad_sgd_waves_grid", "nomad_sgd_waves_block", "nomad_sgd_block")
FLASH_SRC = "src/repro_torch/kernels/csrc/flash_attn.cu"
#: the pallas_call of the JAX package's flash-attention kernel
FLASH_REPLACES = "src/repro/kernels/flash_attn.py:99"
#: the LM serving cell: Qwen2.5-32B, B prompts of P tokens, G decode steps
LM_B, LM_P, LM_G = 4, 1024, 32
#: max |logit difference| between two runs on the same bf16 weights
#: (see lm_phase's checks): 128 residual additions (rms ~10) each rounded
#: to bf16 walk to ~2 % of the final norm's input, ~0.02 rms in logits of
#: rms ~1 and ~5x that at the max of 608k of them; the bound is 2.5x that.
#: A control (one layer's attention unmasked) must exceed it.
LM_LOGIT_BOUND = 0.25
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s outside
#: the tensor cores, dense bf16/fp16 tensor-core FLOP/s (fp32 accumulate)
PEAK_BW = 3.35e12
PEAK_FP32 = 67e12
PEAK_TC16 = 989e12
EPS_FP32 = 2.0 ** -24


def phase(tag: str, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rel_err(a, b) -> float:
    """max |a - b| / (1 + |b|), the tolerance tier's measure."""
    a64, b64 = a.double(), b.double()
    return float(((a64 - b64).abs() / (1 + b64.abs())).max())


def check_close(what, got, want, n_updates, start=None) -> float:
    """Hold ``got`` against its plain version ``want``; return the max
    abs error.  The tolerance tier: ``16 eps sqrt(n_updates)`` of
    ``|a - b| / (1 + |b|)`` (the k-dot is summed in another order, and
    the difference walks with the updates).  Below fp32 storage, where
    both compute in fp32 over the same storage, also: they differ on
    few of the elements the update changed from ``start``
    (``repro_torch.testing.assert_rare_flips``)."""
    from repro_torch.testing import assert_rare_flips
    eps = EPS_FP32 if got.dtype == torch.float32 else 2.0 ** -9
    bound = 16 * eps * max(float(n_updates), 1.0) ** 0.5
    err = rel_err(got, want)
    flips = {}
    if got.dtype != torch.float32:
        differing, changed = assert_rare_flips(got, want, start, what)
        flips = dict(differing=differing, of_updated=changed)
    phase("check", what=what, max_rel_err=f"{err:.3e}",
          bound=f"{bound:.3e}", n_updates=n_updates, **flips)
    if not err <= bound:
        raise AssertionError(f"{what}: {err:.3e} > bound {bound:.3e}")
    return float((got.double() - want.double()).abs().max())


def check_control(what, got, want, start) -> None:
    """A wrong result the low-precision check must reject: fail unless
    ``assert_rare_flips`` rejects it."""
    from repro_torch.testing import FLIP_SHARE, FLIP_SLACK, flips
    differing, changed = flips(got, want, start)
    rejected = differing > FLIP_SLACK + FLIP_SHARE * changed
    phase("control", what=what, differing=differing, of_updated=changed,
          rejected=rejected)
    if not rejected:
        raise AssertionError(f"{what}: the bf16 check cannot tell it from "
                             "the plain version")


def check_bitwise(what, a, b) -> None:
    if not (a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)):
        raise AssertionError(f"{what}: not bitwise-identical")
    phase("check", what=what, bitwise=True)


def cell_ratings(csr):
    """(cell, rows, cols) of the ratings of ``csr``'s cells."""
    bounds = csr.woff.long()[csr.cell_woff.long()]
    lo, hi = int(bounds[0]), int(bounds[-1])
    cell = torch.repeat_interleave(
        torch.arange(csr.n_cells, device=bounds.device), torch.diff(bounds))
    return cell, csr.rows[lo:hi].long(), csr.cols[lo:hi].long()


def max_row_updates(csr, n_w: int, n_h: int) -> int:
    """Most updates any one factor row receives from ``csr``'s ratings
    (cells of ``n_w`` W rows and ``n_h`` H rows)."""
    cell, rows, cols = cell_ratings(csr)
    if not rows.numel():
        return 0
    return max(int(torch.bincount(cell * n_w + rows).max()),
               int(torch.bincount(cell * n_h + cols).max()))


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, by CUDA
    events, after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timed(fn):
    """``(fn(), milliseconds)`` by the host clock, synchronised on both
    ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound(Ws, Hs, csr):
    """Least time of one launch, ``(ms, "bytes" | "operations")``: each
    factor row the ratings touch read once and written once, each rating
    (row, col, value) and wave offset read once, over HBM bandwidth — or
    the update arithmetic (14k + 8 FLOPs per rating) over the fp32 peak,
    whichever is larger."""
    k, elem = Ws.shape[-1], Ws.element_size()
    cell, rows, cols = cell_ratings(csr)
    touched = (torch.unique(cell * Ws.shape[1] + rows).numel()
               + torch.unique(cell * Hs.shape[1] + cols).numel())
    n_waves = int(csr.cell_woff[-1] - csr.cell_woff[0])
    nbytes = (2 * touched * k * elem + 12 * rows.numel()
              + 4 * (n_waves + 1 + csr.cell_woff.numel()))
    t_bytes = nbytes / PEAK_BW * 1e3
    t_ops = (14 * k + 8) * rows.numel() / PEAK_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def factor_digest(W, H) -> str:
    """sha256 of the factors' bytes, W then H: equal digests from two
    trees in one call show their results bitwise equal."""
    import hashlib
    h = hashlib.sha256(np.ascontiguousarray(W).tobytes())
    h.update(np.ascontiguousarray(H).tobytes())
    return h.hexdigest()[:16]


#: the segments of ``nomad_sgd.wave_split``: warp 0's index fetch, row
#: fetch, butterfly, update and wait to the barrier's end; the stager
#: warp's staging, copy wait and wait to the barrier's end
SPLIT_NAMES = ("index", "rows", "butterfly", "update", "barrier", "stage",
               "wait", "stager_barrier")


def wave_split(ks, W, H, csr, lr, lam, plan, what: str) -> dict:
    """[4.wave.split]: one cell's waves under ``plan``, split by
    ``clock64()`` samples of lane 0 of warp 0 and of the stager warp
    (``nomad_sgd.wave_split``): cycles and ns per wave of each segment,
    ns per cycle from the launch's CUDA-event time over its sampled
    cycles.  Fails unless the result is bitwise the kernel's under the
    launch's own plan."""
    want = ks.nomad_sgd_waves_csr(W.clone(), H.clone(), csr, lr, lam)
    got = (W.clone(), H.clone())
    sp = ks.wave_split(*got, csr, lr, lam, plan)
    check_bitwise(f"{plan.describe()} == launch plan W", got[0], want[0])
    check_bitwise(f"{plan.describe()} == launch plan H", got[1], want[1])
    ns_per_cycle = sp["ms"] * 1e6 / max(sp["cycles"], 1)
    us_per_wave = sp["ms"] * 1e3 / max(sp["waves"], 1)
    phase("4.wave.split", what=what, variant=plan.describe(),
          waves=sp["waves"], trips=sp["trips"], ms=f"{sp['ms']:.3f}",
          us_per_wave=f"{us_per_wave:.4f}",
          ns_per_cycle=f"{ns_per_cycle:.4f}",
          cycles_per_wave=json.dumps({name: round(sp[name + "_cycles"], 1)
                                      for name in SPLIT_NAMES}),
          ns_per_wave=json.dumps({name: round(sp[name + "_cycles"]
                                              * ns_per_cycle, 1)
                                  for name in SPLIT_NAMES}))
    sp["ns_per_cycle"] = ns_per_cycle
    return sp


def h_global_check(ks, dev, m_tile: int, k: int, lr, lam) -> None:
    """[4.hglobal]: the variant for an H block too large for shared
    memory, on one synthetic cell of full Netflix's ``n_local`` (2,222
    item rows), ``m_tile`` user rows and rank ``k``: ratings from a seed
    (users uniform, items Zipf(1.3), as skewed as real ratings), packed
    into waves on the host, factors from a seed on the card.  Its plan
    must keep H in global memory; the kernel against its plain version
    within ``check_close``; its time."""
    from repro_torch.core.partition import pack_cell_waves
    n_tile, nnz = 2222, 137_000
    rng = np.random.default_rng(18)
    r = rng.integers(0, m_tile, nnz)
    c = np.minimum(rng.zipf(1.3, nnz) - 1, n_tile - 1)
    v = rng.normal(size=nnz).astype(np.float32)
    _, *pad, _ = pack_cell_waves(r, c, v)
    csr = ks.WaveCSR.from_padded(*(torch.from_numpy(a)[None].to(dev)
                                   for a in pad))
    g = torch.Generator(device=dev).manual_seed(18)
    W0 = torch.rand((1, m_tile, k), generator=g, device=dev) / k ** 0.5
    H0 = torch.rand((1, n_tile, k), generator=g, device=dev) / k ** 0.5
    plan = ks.launch_plan(W0, H0)
    if plan.resident:
        raise AssertionError(f"n_tile={n_tile}: plan {plan.describe()} "
                             "keeps H resident")
    Wk, Hk = ks.nomad_sgd_waves_csr(W0.clone(), H0.clone(), csr, lr, lam)
    (Wp, Hp), p_ms = timed(lambda: ks.block_sgd_waves_csr(
        W0.clone(), H0.clone(), csr, lr, lam))
    upd = max_row_updates(csr, m_tile, n_tile)
    for x, got, want in (("W", Wk, Wp), ("H", Hk, Hp)):
        check_close(f"{x} kernel vs plain, n_tile={n_tile} "
                    f"({plan.describe()})", got, want, upd)
    k_ms = cuda_ms(lambda: ks.nomad_sgd_waves_csr(W0.clone(), H0.clone(),
                                                  csr, lr, lam), 3)
    phase("4.hglobal", n_tile=n_tile, m_tile=m_tile, ratings=nnz,
          chain=chain(csr), kernel_ms=f"{k_ms:.3f}",
          us_per_wave=f"{k_ms * 1e3 / chain(csr):.4f}",
          plain_ms=f"{p_ms:.1f}", variant=plan.describe())


def dependency_path(br, csr) -> tuple:
    """``(sum of step maxima, longest dependency path)`` of one epoch, in
    waves: the step loop costs each step its longest cell; a kernel that
    started each cell once its W shard's and its H block's previous cells
    were done would cost the longest path through those dependencies."""
    p, n_steps = br.p, br.n_steps
    chains = torch.diff(csr.cell_woff.long()).view(n_steps, p).tolist()
    done_w, done_h = [0] * p, [0] * p
    for s in range(n_steps):
        for q in range(p):
            b = br.block_at(q, s)
            done_w[q] = done_h[b] = max(done_w[q], done_h[b]) + chains[s][q]
    return sum(max(c) for c in chains), max(done_w)


def chain(csr) -> int:
    """Dependent waves of a launch: the most waves any of its cells has."""
    return int(torch.diff(csr.cell_woff.long()).max())


def interleave(csr, m_tile: int, n_tile: int):
    """``csr``'s cells as one cell over the flat ``(n_cells * m_tile, k)``
    / ``(n_cells * n_tile, k)`` factors, wave ``j`` holding the ``j``-th
    wave of every cell.  The cells touch disjoint factor blocks, so this
    is the same update, with one plain-PyTorch wave step per ``j``
    instead of one per cell and ``j``."""
    from repro_torch.kernels.nomad_sgd import WaveCSR
    cw = csr.cell_woff.long()
    w0, w1 = int(cw[0]), int(cw[-1])
    n_cells, dev = csr.n_cells, cw.device
    woff = csr.woff.long()[w0:w1 + 1]
    w_cell = torch.repeat_interleave(torch.arange(n_cells, device=dev),
                                     torch.diff(cw))
    w_idx = torch.arange(w0, w1, device=dev) - cw[:-1][w_cell]
    order = torch.argsort(w_idx * n_cells + w_cell)
    size = torch.diff(woff)[order]
    take = (torch.repeat_interleave(woff[:-1][order] - (torch.cumsum(
        size, 0) - size), size) + torch.arange(int(size.sum()), device=dev))
    cell = torch.repeat_interleave(w_cell[order], size)
    merged = torch.zeros(int(w_idx.max()) + 2, dtype=torch.int64,
                         device=dev)
    torch.cumsum(torch.bincount(w_idx, weights=torch.diff(woff).double())
                 .long(), 0, out=merged[1:])
    return WaveCSR(
        rows=(csr.rows[take] + cell * m_tile).int(),
        cols=(csr.cols[take] + cell * n_tile).int(),
        vals=csr.vals[take], woff=merged.int(),
        cell_woff=torch.tensor([0, merged.numel() - 1], dtype=torch.int32,
                               device=dev))


def topk_tolerance(ps, k: int):
    """Per-score bound of the top-k kernel against its plain version:
    the fp32 k-dot summed in another order (``16 eps sqrt(k)`` of ``1 +
    |s|``), plus one ulp of the score dtype where the sum is rounded to
    it afterwards."""
    ulp = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8,
           torch.float16: 2.0 ** -10}[ps.dtype]
    a = ps.double().abs()
    return 16 * EPS_FP32 * k ** 0.5 * (1 + a) + ulp * a


def check_topk(what, s, i, ps, pi, k: int) -> float:
    """Hold the kernel's ``(s, i)`` against the plain version's ``(ps,
    pi)``, which may hold one column more (the next item, for the gap
    below the last): scores within :func:`topk_tolerance`, ids equal
    wherever neighbouring plain scores are further apart than twice it.
    Returns the max abs score error."""
    k_top = s.shape[1]
    tol = topk_tolerance(ps, k)
    psd = ps.double()
    finite = torch.isfinite(psd[:, :k_top])
    d = (s.double() - psd[:, :k_top]).abs()
    close = (torch.equal(torch.isfinite(s.double()), finite)
             and bool((d[finite] <= tol[:, :k_top][finite]).all()))
    gap = psd[:, :-1] - psd[:, 1:]
    apart = torch.ones(psd.shape, dtype=torch.bool, device=psd.device)
    apart[:, 1:] &= gap > 2 * tol[:, 1:]
    apart[:, :-1] &= gap > 2 * tol[:, :-1]
    apart = apart[:, :k_top]
    same = bool((i[apart] == pi[:, :k_top][apart]).all())
    err = float(d[finite].max()) if bool(finite.any()) else 0.0
    phase("check", what=what, max_abs_err=f"{err:.3e}",
          ids_checked=f"{float(apart.float().mean()):.3f}", ids_equal=same,
          ids_differing=int((i != pi[:, :k_top]).sum()),
          scores_close=close)
    if not (close and same):
        raise AssertionError(f"{what}: kernel and plain version disagree")
    return err


def topk_bound(W_u, H, h_scale, k_top: int):
    """Least time of one top-k call, ``(ms, "bytes" | "operations")``:
    ``H``, ``W_u`` and the scales read once and the ``(U, k_top)`` result
    written once, over HBM bandwidth, or the ``2 U n k`` flops of the
    scores over the peak for their operands, whichever is larger.  bf16
    and fp16 products are exact in fp32, so their peak is the tensor
    cores' with fp32 accumulation; fp32 ``W_u`` (against an fp32 or an
    int8 ``H``) takes the fp32 peak outside the tensor cores."""
    U, k = W_u.shape
    n = H.shape[0]
    nbytes = (H.numel() * H.element_size() + W_u.numel() * W_u.element_size()
              + (0 if h_scale is None else 4 * n)
              + U * k_top * (W_u.element_size() + 4))
    t_bytes = nbytes / PEAK_BW * 1e3
    peak = PEAK_FP32 if W_u.dtype == torch.float32 else PEAK_TC16
    t_ops = 2 * U * n * k / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(W_u, H, h_scale, k_top: int):
    """``torch.topk(W_u @ H.T, k_top)`` (an int8 ``H`` widened to fp32
    beforehand, its scale applied to the product): the yardstick, never
    called by the port."""
    if h_scale is None:
        return lambda: torch.topk(W_u @ H.T, k_top)
    Hf = H.float()
    return lambda: torch.topk((W_u @ Hf.T) * h_scale, k_top)


def serve_phase(result, problem, dev):
    """[5.serve]: the slice end to end on the main path's result.
    Returns the kernel record at the serving shape and the top-k launches
    the serving runs made."""
    import shutil
    from collections import Counter

    from repro_torch.checkpoint import save_fit_result
    from repro_torch.kernels import topk as ktopk
    from repro_torch.launch.serve_mc import run_load
    from repro_torch.serve import RecServer, ServeConfig

    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    save_fit_result(str(ckpt), int(result.epochs_done), result)
    save_s = time.perf_counter() - t0
    cfg = ServeConfig(top_k=10, max_batch=64)
    t0 = time.perf_counter()
    server = RecServer.from_checkpoint(str(ckpt), cfg, device=dev)
    boot_s = time.perf_counter() - t0
    store = server.store
    view = store.view()
    for x in ("W", "H"):
        check_bitwise(f"restored {x} == trained {x}",
                      getattr(view, x).cpu(),
                      torch.from_numpy(getattr(result, x)))
    phase("5.boot", step=store.boot_step, save_s=f"{save_s:.2f}",
          boot_s=f"{boot_s:.2f}", m=view.m, n=view.n, k=view.k,
          device=view.W.device)

    # instruments for the serving runs: calls of the plain version, and
    # the (users, k_top) shape of every launch, recorded where the
    # wrapper hands its inputs to the kernel; the launch counter stays
    # the wrapper's own
    plain, launch = ktopk.topk_plain, ktopk._launch
    plain_calls, shapes = [0], Counter()

    def counted_plain(*a, **kw):
        plain_calls[0] += 1
        return plain(*a, **kw)

    def recorded_launch(W_u, H, h_scale, k_top):
        shapes[W_u.shape[0], k_top] += 1
        return launch(W_u, H, h_scale, k_top)

    ktopk.topk_plain, ktopk._launch = counted_plain, recorded_launch
    total_launches = 0
    rng = np.random.default_rng(5)
    try:
        for filt in (False, True):
            if filt:
                t0 = time.perf_counter()
                view = store.publish(view.W, view.H,
                                     rated=(problem.rows, problem.cols))
                phase("5.rated", version=view.version,
                      publish_s=f"{time.perf_counter() - t0:.2f}",
                      rated=len(view.rated_items))
            srv = RecServer(store, dataclasses.replace(cfg,
                                                       filter_rated=filt))
            ktopk.reset_launches()
            plain_calls[0] = 0
            with srv:
                srv.recommend([0])
                qps, p50, p99 = run_load(srv, view.m, SERVE_QUERIES,
                                         clients=4)
                sample = rng.choice(view.m, 16, replace=False)
                recs = [srv.recommend([u]) for u in sample]
            launches = ktopk.topk_scores_cuda.launches
            batches = srv.n_batches
            total_launches += launches
            for u, rec in zip(sample, recs):
                again = srv.score([u])
                if not (rec.items.shape == (1, 10)
                        and np.all((rec.items >= 0) & (rec.items < view.n))
                        and np.all(np.isfinite(rec.scores))
                        and np.all(np.diff(rec.scores[0]) <= 0)
                        and np.array_equal(rec.items, again.items)
                        and np.array_equal(rec.scores, again.scores)):
                    raise AssertionError(f"user {u}: bad recommendation "
                                         f"{rec}")
                if filt and set(rec.items[0].tolist()) & set(
                        view.rated_for([u])[0].tolist()):
                    raise AssertionError(f"user {u}: a rated item served")
            phase("5.serve", filter_rated=filt, queries=SERVE_QUERIES,
                  answered=srv.n_queries, qps=f"{qps:.1f}",
                  p50_ms=f"{p50:.3f}", p99_ms=f"{p99:.3f}",
                  microbatches=batches, topk_launches=launches,
                  plain_calls=plain_calls[0])
            if launches < batches or plain_calls[0] != 0:
                raise AssertionError(
                    f"serving: {launches} kernel launches for {batches} "
                    f"microbatches, {plain_calls[0]} plain calls")
    finally:
        ktopk.topk_plain, ktopk._launch = plain, launch
    buckets = Counter()
    for (U, _), c in shapes.items():
        buckets[U] += c
    phase("5.buckets", users_per_launch=json.dumps(dict(sorted(
        buckets.items()))), k_tops=len({kt for _, kt in shapes}))

    # one microbatch of 4 users scored synchronously, host clock: the
    # scoring part of a served request's latency
    srv = RecServer(store, cfg)
    four = rng.choice(view.m, 4, replace=False)
    srv.score(four)
    t0 = time.perf_counter()
    for _ in range(50):
        srv.score(four)
    phase("5.score", users=4, sync_ms=f"{(time.perf_counter() - t0) * 20:.3f}")

    # the kernel against its plain version at the shapes the serving runs
    # launched: each user bucket at top-10 and at the smallest and the
    # largest filtered over-fetch it saw; and a full microbatch (U=64)
    # at top-10, the over-fetch of its users and the whole catalog
    H = view.H
    cases = []
    for U in sorted(buckets):
        over = sorted(kt for u, kt in shapes if u == U and kt != 10)
        cases += [(U, kt) for kt in sorted({10, *over[:1], *over[-1:]})]
    rows = torch.from_numpy(rng.choice(view.m, 64, replace=False)).to(dev)
    over = 10 + max(len(r) for r in view.rated_for(rows.cpu().numpy()))
    cases += [(64, 10), (64, min(view.n, over)), (64, view.n)]
    errs = []
    for U, k_top in cases:
        W_u = view.W.index_select(0, rows[:U])
        s, i = ktopk.topk_scores_cuda(W_u, H, k_top=k_top)
        ps, pi = plain(W_u, H, k_top=min(view.n, k_top + 1))
        errs.append(check_topk(f"topk serving U={U} k_top={k_top}", s, i,
                               ps, pi, view.k))
    serve_err = max(errs)
    W_u = view.W.index_select(0, rows)
    # three timings, for the spread between them
    times = [cuda_ms(lambda: ktopk.topk_scores_cuda(W_u, H, k_top=10), 20)
             for _ in range(3)]
    k_ms = float(np.median(times))
    _, p_ms = timed(lambda: plain(W_u, H, k_top=10))
    lib_ms = cuda_ms(library_call(W_u, H, None, 10), 20)
    b_ms, b_by = topk_bound(W_u, H, None, 10)
    phase("5.topk", U=64, n=view.n, k_top=10, kernel_ms=f"{k_ms:.4f}",
          kernel_ms_each=json.dumps([round(t, 4) for t in times]),
          bound_ms=f"{b_ms:.5f}", bound_by=b_by, plain_ms=f"{p_ms:.3f}",
          library_ms=f"{lib_ms:.4f}", **ktopk.kernel_attrs(W_u, H, 10))
    return dict(name="topk_scores_cuda[serve,fp32,U=64,k_top=10]",
                route="cuda", source=TOPK_SRC, replaces=TOPK_REPLACES,
                launches=total_launches, launches_on="[5.serve]",
                max_abs_err=serve_err, ms=k_ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms), total_launches


def topk_split(storage, W_u, H, h_scale, k_top: int, reps: int = 5):
    """[6.topk.split]: where one top-k call's device time goes, by kernel
    name under the profiler over ``reps`` calls: pass 1, the merge rounds
    (launches per call, summed time) and the decode; and the scoring
    alone: pass 1 with its selection compiled out (``topk_score_only``,
    one checksum per CTA), on the same inputs."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import topk as ktopk
    lib = _build.load("topk")
    U, k = W_u.shape
    n = H.shape[0]
    # the profiler may drop events (a whole window's, now and then): each
    # part is averaged over the launches it saw, the merge rounds counted
    # per decode seen, and a window that saw none is taken again
    for _ in range(3):
        counts = {}
        _, _, by_name = device_busy(lambda: [ktopk.topk_scores_cuda(
            W_u, H, h_scale, k_top=k_top) for _ in range(reps)], counts)
        parts = {"pass1": [0, 0.0], "merge": [0, 0.0], "decode": [0, 0.0]}
        for name, ms in by_name.items():
            part = ("merge" if "merge" in name else
                    "decode" if "decode" in name else "pass1")
            parts[part][0] += counts[name]
            parts[part][1] += ms
        calls = parts["decode"][0]
        if parts["pass1"][0] and calls:
            break
    else:
        raise AssertionError(f"top-k split: kernels seen {counts}")
    p = ktopk.device_plan(W_u, H, k_top)
    sums = torch.empty(-(-U // p.ub) * p.stripes, dtype=torch.int64,
                       device=W_u.device)

    def score_only():
        err = lib.topk_score_only(
            W_u.data_ptr(), H.data_ptr(),
            None if h_scale is None else h_scale.data_ptr(), U, n, k,
            ktopk._DTYPE_CODE[W_u.dtype], ktopk._DTYPE_CODE[H.dtype], k_top,
            *ktopk.plan_args(p), sums.data_ptr(), sums.numel(),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"topk_score_only failed: code {err}")

    score_only()
    for _ in range(3):
        score_counts = {}
        _, score_busy, _ = device_busy(
            lambda: [score_only() for _ in range(reps)], score_counts)
        if score_counts:
            break
    else:
        raise AssertionError("score-only: the profiler saw no kernel")
    pass1, decode = (parts[x][1] / parts[x][0] for x in ("pass1", "decode"))
    merge = parts["merge"][1] / calls
    phase("6.topk.split", storage=storage, U=U, k_top=k_top,
          total_ms=f"{pass1 + merge + decode:.4f}",
          pass1_ms=f"{pass1:.4f}",
          merge_rounds=f"{parts['merge'][0] / calls:g}",
          merge_ms=f"{merge:.4f}",
          decode_ms=f"{decode:.4f}",
          score_only_ms=f"{score_busy / sum(score_counts.values()):.4f}")


def topk_rising(dev):
    """[6.topk.rising]: the worst case of the running threshold, a
    catalog of Yahoo! Music size whose scores rise with the item id, so
    every item passes every user's threshold: the kernel against its
    plain version, bitwise (fp32 and int8 scores are exact; bf16 rounds
    ids to equal, non-decreasing scores), and its time."""
    from repro_torch.kernels import topk as ktopk
    ids = torch.arange(YAHOO_N, device=dev, dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(2)
    # score = W[:, 0] * id: W's other columns are 0, H's random integers
    H = torch.randint(-2, 3, (YAHOO_N, YAHOO_K), generator=g, device=dev,
                      dtype=torch.float32)
    H[:, 0] = ids
    W = torch.zeros((64, YAHOO_K), device=dev)
    W[:, 0] = torch.arange(64, device=dev) % 16 + 1
    # int8: one integer dot per user against a rising per-item scale
    hs = (ids + 1) / YAHOO_N
    for storage, args in (
            ("fp32", (W, H, None)),
            ("bf16", (W.bfloat16(), H.bfloat16(), None)),
            ("int8", (W, torch.ones_like(H, dtype=torch.int8), hs))):
        dense = ktopk._tile_scores(args[0], args[1], args[2])
        if not bool((dense[:, 1:] >= dense[:, :-1]).all()):
            raise AssertionError(f"rising catalog {storage}: scores fall")
        del dense
        for k_top in (10, 1000):
            s, i = ktopk.topk_scores_cuda(*args, k_top=k_top)
            ps, pi = ktopk.topk_plain(*args, k_top=k_top)
            if not (torch.equal(s, ps) and torch.equal(i, pi)):
                raise AssertionError(f"topk rising {storage} k_top={k_top}:"
                                     " kernel != plain")
            k_ms = cuda_ms(lambda: ktopk.topk_scores_cuda(*args,
                                                          k_top=k_top), 10)
            phase("6.topk.rising", storage=storage, U=64, k_top=k_top,
                  kernel_equals_plain=True, kernel_ms=f"{k_ms:.4f}")


def topk_phase(dev, launches: int):
    """[6.topk]: the kernel at the Yahoo! Music catalog.  Returns one
    kernel record per (storage, cell); the cells bypass the server, so
    each record's ``launches`` is the kernel's count on the serving path
    (``launches_on``), not this phase's."""
    from repro_torch.kernels import topk as ktopk
    from repro_torch.serve import FactorStore

    g = torch.Generator(device=dev).manual_seed(0)
    W = torch.randn((YAHOO_M, YAHOO_K), generator=g, device=dev) * 0.3
    H = torch.randn((YAHOO_N, YAHOO_K), generator=g, device=dev) * 0.3
    views = {}
    for storage, kw in (("fp32", {}), ("bf16", dict(dtype=torch.bfloat16)),
                        ("int8", dict(quantize="int8"))):
        t0 = time.perf_counter()
        views[storage] = FactorStore(dev).publish(W, H, **kw)
        v = views[storage]
        phase("6.publish", storage=storage,
              seconds=f"{time.perf_counter() - t0:.2f}",
              W_bytes=v.W.numel() * v.W.element_size(),
              H_bytes=v.H.numel() * v.H.element_size())
    del W, H

    # integer-valued factors: kernel == plain, bitwise; and a control
    gi = torch.Generator(device=dev).manual_seed(1)
    Hi = torch.randint(-2, 3, (YAHOO_N, YAHOO_K), generator=gi, device=dev)
    Wi = torch.randint(-2, 3, (64, YAHOO_K), generator=gi, device=dev)
    hs = torch.rand(YAHOO_N, generator=gi, device=dev) + 0.01
    for storage, args in (
            ("fp32", (Wi.float(), Hi.float(), None)),
            ("bf16", (Wi.bfloat16(), Hi.bfloat16(), None)),
            ("int8", (Wi.float(), Hi.to(torch.int8), hs))):
        for k_top in (10, 1000):
            s, i = ktopk.topk_scores_cuda(*args, k_top=k_top)
            ps, pi = ktopk.topk_plain(*args, k_top=k_top)
            if not (torch.equal(s, ps) and torch.equal(i, pi)):
                raise AssertionError(f"topk integer {storage} k_top="
                                     f"{k_top}: kernel != plain")
            phase("check", what=f"topk integer-valued {storage} U=64 "
                  f"k_top={k_top} kernel == plain", bitwise=True)
    # control: the same selection with ties broken to the larger id
    s, i = ktopk.topk_scores_cuda(Wi.float(), Hi.float(), k_top=1000)
    dense = Wi.float() @ Hi.float().T
    desc = torch.arange(YAHOO_N - 1, -1, -1, device=dev)
    order = torch.sort(-dense[:, desc], dim=1, stable=True).indices[:, :1000]
    reversed_ids = desc[order].int()
    rejected = not torch.equal(reversed_ids, i)
    phase("control", what="topk ties to the larger id", rejected=rejected,
          differing=int((reversed_ids != i).sum()))
    if not rejected:
        raise AssertionError("the top-k check cannot tell the tie rule")
    del Hi, Wi, dense
    topk_rising(dev)

    records = []
    for storage, view in views.items():
        for U, k_top in ((1, 10), (8, 10), (64, 10), (64, 1000)):
            rows = torch.from_numpy(np.random.default_rng(U).choice(
                YAHOO_M, U, replace=False)).to(dev)
            W_u, H, h_scale = view.W.index_select(0, rows), view.H, None
            if view.quantized:
                W_u = W_u.float() * view.w_scale.index_select(0, rows)[:,
                                                                    None]
                h_scale = view.h_scale
            s, i = ktopk.topk_scores_cuda(W_u, H, h_scale, k_top=k_top)
            ps, pi = ktopk.topk_plain(W_u, H, h_scale, k_top=k_top + 1)
            err = check_topk(f"topk {storage} U={U} k_top={k_top}", s, i,
                             ps, pi, YAHOO_K)
            attrs = ktopk.kernel_attrs(W_u, H, k_top)
            k_ms = cuda_ms(lambda: ktopk.topk_scores_cuda(
                W_u, H, h_scale, k_top=k_top), 10)
            _, p_ms = timed(lambda: ktopk.topk_plain(W_u, H, h_scale,
                                                     k_top=k_top))
            lib_ms = cuda_ms(library_call(W_u, H, h_scale, k_top), 10)
            b_ms, b_by = topk_bound(W_u, H, h_scale, k_top)
            phase("6.topk", storage=storage, U=U, k_top=k_top,
                  kernel_ms=f"{k_ms:.4f}", bound_ms=f"{b_ms:.4f}",
                  bound_by=b_by, plain_ms=f"{p_ms:.2f}",
                  library_ms=f"{lib_ms:.4f}", **attrs)
            if U == 64:
                topk_split(storage, W_u, H, h_scale, k_top)
            records.append(dict(
                name=f"topk_scores_cuda[{storage},U={U},k_top={k_top}]",
                route="cuda", source=TOPK_SRC, replaces=TOPK_REPLACES,
                launches=launches, launches_on="[5.serve]",
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms))
    return records


def flash_within(got, want, dtype, abs_v=None) -> bool:
    """The flash kernel's result ``got`` against ``want`` (its plain
    version's, or the oracle's).  fp32: both accumulate in fp32, the
    reference's own ``2e-5`` abs and rel between two orders of
    summation.  bf16 and fp16: the tensor-core kernel also rounds its
    probabilities once to the type before ``P V``, so the bound is
    ``repro_torch.testing.flash_p_rounding_tolerance``: that fp32 bound,
    two ulps of the output, and the type's epsilon times ``abs_v``, the
    plain version on ``|v|``."""
    from repro_torch.testing import flash_p_rounding_tolerance
    w = want.double()
    tol = (2e-5 * (1 + w.abs()) if dtype == torch.float32
           else flash_p_rounding_tolerance(w, abs_v, dtype))
    return bool(((got.double() - w).abs() <= tol).all())


def flash_bound(B, Hq, Hkv, S, D, dtype):
    """Least time of one causal flash call, ``(ms, "bytes" |
    "operations")``: the two products over the keys each query sees
    (``2 * 2 * B * Hq * D * S (S + 1) / 2`` flops) at the peak of the
    operand type (bf16/fp16 tensor cores, fp32 FMA units), or q, k, v
    read once and o written once over HBM bandwidth."""
    elem = torch.empty((), dtype=dtype).element_size()
    flops = 4 * B * Hq * D * (S * (S + 1) // 2)
    nbytes = elem * B * S * D * (2 * Hq + 2 * Hkv)
    t_ops = flops / (PEAK_FP32 if dtype == torch.float32 else PEAK_TC16) * 1e3
    t_bytes = nbytes / PEAK_BW * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: [7.flash]'s cases: (dtype, S, D, timed); the served shape in each type,
#: then a ragged last tile (S=200, D padded to 64) and rows of 72 bytes
#: (D=36: the element-wise loading variant), B, Hq, Hkv as served
FLASH_CASES = ((torch.bfloat16, LM_P, 128, True),
               (torch.float16, LM_P, 128, True),
               (torch.float32, LM_P, 128, True),
               (torch.bfloat16, 200, 64, False),
               (torch.bfloat16, LM_P, 36, False))


def flash_kernel_checks(dev, launches: int):
    """[7.flash]: each kernel of ``csrc/flash_attn.cu`` with its registers,
    shared memory and spills; then the kernel against its plain version
    at each of :data:`FLASH_CASES`, on q/k/v laid out as the prefill
    hands them over ((B, S, H, D) projections viewed as (B, H, S, D)),
    fp32 also against the materialized oracle, and two controls the
    check must reject; at the served shape its time beside its bound,
    the plain version's and SDPA's.  Returns the kernel records
    (``launches`` is the main path's count, bf16)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as kfa
    from repro_torch.kernels import ref
    for name, attrs in kfa.kernel_attrs().items():
        phase("7.flash", kernel=name, **attrs)
        if attrs["local_bytes"]:
            raise AssertionError(f"{name} spills {attrs['local_bytes']} "
                                 "bytes per thread")
    B, Hq, Hkv = LM_B, 40, 8
    g = torch.Generator(device=dev).manual_seed(3)
    records = []
    for dtype, S, D, timed_case in FLASH_CASES:
        name = {torch.bfloat16: "bf16", torch.float16: "fp16",
                torch.float32: "fp32"}[dtype]
        q, k, v = ((torch.randn((B, S, h, D), generator=g, device=dev)
                    * sc).to(dtype).transpose(1, 2)
                   for h, sc in ((Hq, 0.3), (Hkv, 0.3), (Hkv, 1.0)))
        got = kfa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        kernel = kfa.KERNELS[kfa.kernel_index(q, k, v, got)]
        want = kfa.flash_attention_plain(q, k, v, causal=True)
        abs_v = (None if dtype == torch.float32 else kfa.flash_attention_plain(
            q.float(), k.float(), v.abs().float(), causal=True))
        err = float((got.double() - want.double()).abs().max())
        ok = flash_within(got, want, dtype, abs_v)
        phase("check", what=f"flash_attention {name} B={B} Hq={Hq} Hkv={Hkv} "
              f"S={S} D={D} kernel vs plain", kernel=kernel,
              max_abs_err=f"{err:.3e}", within=ok)
        if not ok:
            raise AssertionError(f"flash_attention {name} S={S} D={D}: "
                                 "kernel and plain version disagree")
        if dtype == torch.float32:
            # a second witness: the materialized oracle (in bf16 it rounds
            # the probabilities to bf16, which the fp32 kernel does not)
            oracle = ref.flash_attention_ref(q, k, v, causal=True)
            ok = flash_within(got, oracle, dtype)
            phase("check", what=f"flash_attention {name} kernel vs "
                  "materialized oracle", max_abs_err=(
                      f"{float((got.double() - oracle.double()).abs().max()):.3e}"),
                  within=ok)
            del oracle
            if not ok:
                raise AssertionError("flash_attention fp32: kernel and "
                                     "materialized oracle disagree")
        # wrong results the check must reject: no causal mask, and query
        # head h reading KV head h % Hkv instead of h // (Hq / Hkv)
        wrong_heads = torch.arange(Hq, device=dev) % Hkv
        for what, bad in (
                ("plain without the causal mask",
                 kfa.flash_attention_plain(q, k, v, causal=False)),
                ("plain with KV head h % Hkv",
                 kfa.flash_attention_plain(q, k[:, wrong_heads],
                                           v[:, wrong_heads], causal=True))):
            rejected = not flash_within(got, bad, dtype, abs_v)
            phase("control", what=f"flash {name} S={S} D={D} {what}",
                  rejected=rejected)
            if not rejected:
                raise AssertionError(f"the flash check cannot tell {what}")
        del want, abs_v
        if not timed_case:
            continue
        k_ms = cuda_ms(lambda: kfa.flash_attention(q, k, v), 10)
        p_ms = cuda_ms(lambda: kfa.flash_attention_plain(q, k, v), 3)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 10)
        b_ms, b_by = flash_bound(B, Hq, Hkv, S, D, dtype)
        phase("7.flash", dtype=name, kernel=kernel, kernel_ms=f"{k_ms:.4f}",
              bound_ms=f"{b_ms:.4f}", bound_by=b_by, plain_ms=f"{p_ms:.3f}",
              sdpa_ms=f"{lib_ms:.4f}")
        records.append(dict(
            name=f"flash_attention[{name},B={B},Hq={Hq},Hkv={Hkv},S={S},"
                 f"D={D}]", route="cuda", source=FLASH_SRC,
            replaces=FLASH_REPLACES, kernel=kernel,
            launches=launches if dtype == torch.bfloat16 else 0,
            launches_on=("[7.lm] prefill" if dtype == torch.bfloat16
                         else f"[7.lm] prefill (bf16 only; {name} is not "
                              "served)"),
            max_abs_err=err, ms=k_ms,
            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    return records


def logits_agree(what, got, want, bound: float, tag="check") -> bool:
    """Two runs' logits (B, V) on the same bf16 weights agree when their
    max abs difference is within ``bound`` and the greedy token is the
    same in every row whose top-2 margin (in ``want``) is more than twice
    the difference."""
    d = float((got.float() - want.float()).abs().max())
    top2 = torch.topk(want.float(), 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * d
    same = bool((got.argmax(-1) == want.argmax(-1))[clear].all())
    phase(tag, what=what, max_abs_diff=f"{d:.4f}", bound=bound,
          rows_with_clear_argmax=f"{int(clear.sum())}/{clear.numel()}",
          argmax_equal=same)
    return d <= bound and same


def check_logits(what, got, want, bound: float) -> None:
    if not logits_agree(what, got, want, bound):
        raise AssertionError(f"{what}: logits differ beyond {bound} or a "
                             "clear argmax differs")


def device_busy(fn, counts=None):
    """Run ``fn`` under ``torch.profiler`` (CPU and CUDA); returns ``(wall
    ms, device busy ms, {kernel name: ms})``: busy is the union of the
    kernels' intervals on the card, so overlapping kernels count once.
    A ``counts`` dict, if given, receives each kernel's launches."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + (e.time_range.end - e.time_range.start) / 1e3)
            if counts is not None:
                counts[e.name] = counts.get(e.name, 0) + 1
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return wall, busy / 1e3, by_name


def lm_profile(model, cfg, prompts, dev, unprofiled_ms) -> None:
    """[7.profile]: where the served path's time goes: the prefill and 4
    decode steps under the profiler, each with its device busy time, its
    largest kernels and its busy share, of the profiled wall time and of
    ``unprofiled_ms[what]`` (the same work's time in the measured run:
    the profiler adds host time to every op, so where the host sets the
    pace the second share is the one a user sees)."""
    from repro_torch.launch import serve as lserve
    from repro_torch.models import transformer as T
    B, P = prompts.shape
    state = {}

    def prefill():
        state["logits"], state["pre"] = lserve.make_prefill(cfg)(
            model, {"inputs": prompts})

    def decode(steps=4):
        step = lserve.make_decode_step(cfg)
        tok = state["logits"].argmax(-1)
        for i in range(steps):
            logits, state["cache"] = step(model, {"inputs": tok[:, None]},
                                          state["cache"], P + i)
            tok = logits.argmax(-1)

    with torch.inference_mode():
        for what, fn, per in (("prefill", prefill, 1), ("decode", decode, 4)):
            wall, busy, by_name = device_busy(fn)
            if not busy > 0:
                raise AssertionError(f"{what}: the profiler saw no kernel "
                                     "run on the card")
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
            phase("7.profile", what=what, wall_ms=f"{wall / per:.2f}",
                  device_busy_ms=f"{busy / per:.2f}",
                  busy_share=f"{busy / wall:.3f}",
                  unprofiled_ms=f"{unprofiled_ms[what]:.2f}",
                  busy_share_unprofiled=(
                      f"{busy / per / unprofiled_ms[what]:.3f}"),
                  top_kernels_ms=json.dumps({n[:48]: round(t / per, 3)
                                             for n, t in top}))
            if what == "prefill":
                state["cache"] = lserve._merge_prefill_cache(
                    T.init_cache(cfg, B, P + 4, device=dev), state["pre"],
                    cfg, P)
                del state["pre"]


def lm_phase(dev):
    """[7.lm]: Qwen2.5-32B served end to end on the card: init, prefill
    of B prompts, merge into the decode caches, greedy decode steps, all
    through ``repro_torch.launch.serve``; then checks on the same
    weights.  Returns the flash kernel's launches in the prefill."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attn as kfa
    from repro_torch.launch import serve as lserve
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T

    cfg = configs.get_config("qwen2_5_32b")
    B, P, G = LM_B, LM_P, LM_G
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                          device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    phase("7.init", model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
          params=n_params, weight_bytes=weight_bytes, seconds=f"{init_s:.2f}",
          mem_bytes=torch.cuda.memory_allocated())
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, the config has "
                             f"{cfg.param_count()}")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (B, P))).to(dev)

    # instrument: calls of the kernel's plain version (the wrapper's
    # launch count stays its own)
    plain, plain_calls = kfa.flash_attention_plain, [0]

    def counted_plain(*a, **kw):
        plain_calls[0] += 1
        return plain(*a, **kw)

    kfa.flash_attention_plain = counted_plain
    runs = []
    try:
        with torch.inference_mode():
            for run in ("warm-up", "measured"):
                kfa.reset_launches()
                plain_calls[0] = 0
                torch.cuda.reset_peak_memory_stats()
                toks, t = lserve.generate(model, cfg, prompts, G + 1)
                runs.append((toks, t, kfa.flash_attention.launches,
                             plain_calls[0],
                             torch.cuda.max_memory_allocated()))
                phase("7.run", run=run, prefill_s=f"{t['prefill_s']:.4f}",
                      decode_s=f"{t['decode_s']:.4f}",
                      flash_launches=runs[-1][2], plain_calls=runs[-1][3])
    finally:
        kfa.flash_attention_plain = plain
    toks, t, launches, n_plain, peak = runs[-1]
    if any(r[2] != cfg.n_layers or r[3] != 0 for r in runs):
        raise AssertionError(f"prefill launched the flash kernel "
                             f"{[r[2] for r in runs]} times (want "
                             f"{cfg.n_layers}), plain calls "
                             f"{[r[3] for r in runs]}")
    if not (toks.shape == (B, G + 1) and bool((toks >= 0).all())
            and bool((toks < cfg.vocab_size).all())
            and torch.equal(toks, runs[0][0])):
        raise AssertionError("generated tokens misshapen, out of range or "
                             "not the same in both runs")

    # what decode must read per step: every weight but the embedding
    # table (B rows of it), and the valid part of every layer's KV cache
    kv_step = 2 * cfg.n_layers * B * (P + G // 2) * cfg.n_kv_heads * \
        cfg.head_dim * 2
    dec_bytes = (weight_bytes - cfg.vocab_size * cfg.d_model * 2
                 + B * cfg.d_model * 2 + kv_step)
    dec_bound_ms = dec_bytes / PEAK_BW * 1e3
    # prefill: 2 flops per weight per token, plus the attention products
    pre_flops = (2 * (n_params - cfg.vocab_size * cfg.d_model) * B * P
                 + cfg.n_layers * 4 * B * cfg.n_heads * cfg.head_dim
                 * (P * (P + 1) // 2))
    pre_bound_ms = pre_flops / PEAK_TC16 * 1e3
    step_ms = t["decode_s"] / G * 1e3
    phase("7.lm", batch=B, prompt=P, decode_steps=G,
          prefill_ms=f"{t['prefill_s'] * 1e3:.2f}",
          prefill_tok_s=f"{B * P / t['prefill_s']:.1f}",
          prefill_bound_ms=f"{pre_bound_ms:.2f}",
          decode_ms_per_step=f"{step_ms:.3f}",
          decode_tok_s=f"{B * G / t['decode_s']:.1f}",
          decode_bound_ms_per_step=f"{dec_bound_ms:.3f}",
          peak_mem_bytes=peak, flash_launches=launches, plain_calls=n_plain,
          tokens=json.dumps(toks[:, :8].tolist()))
    lm_profile(model, cfg, prompts, dev,
               {"prefill": t["prefill_s"] * 1e3, "decode": step_ms})

    # the same weights: the prefill's last logits with the kernel and
    # with the plain chunked flash; then decode after prefill against the
    # full forward (tests/test_models.py:58)
    with torch.inference_mode():
        pal, _ = lserve.make_prefill(cfg, impl="pallas")(
            model, {"inputs": prompts})
        xla, _ = lserve.make_prefill(cfg, impl="xla")(
            model, {"inputs": prompts})
        if not torch.equal(pal.argmax(-1), toks[:, 0]):
            raise AssertionError("the prefill's greedy token differs from "
                                 "the served one")
        check_logits("prefill last logits pallas vs xla", pal, xla,
                     LM_LOGIT_BOUND)
        # control: the first layer's attention without the causal mask
        # (its plain version), every other layer through the kernel
        calls = [0]

        def first_layer_unmasked(q, k, v, *, causal=True, **kw):
            calls[0] += 1
            if calls[0] == 1:
                return kfa.flash_attention_plain(q, k, v, causal=False)
            return kfa.flash_attention(q, k, v, causal=causal, **kw)

        A.flash_attn = types.SimpleNamespace(
            flash_attention=first_layer_unmasked)
        try:
            bad, _ = lserve.make_prefill(cfg)(model, {"inputs": prompts})
        finally:
            A.flash_attn = kfa
        if logits_agree("prefill, layer 0 unmasked, vs xla", bad, xla,
                        LM_LOGIT_BOUND, tag="control"):
            raise AssertionError("the logits check cannot tell one layer's "
                                 "attention without the causal mask")
        del pal, xla, bad
        # the flash kernel's contract (S a multiple of its 256-row blocks)
        # holds at t = P - 256; causal, so forward(x)[t] sees x[:t + 1]
        t = P - 256
        last, pre = lserve.make_prefill(cfg)(model,
                                             {"inputs": prompts[:, :t]})
        cache = lserve._merge_prefill_cache(
            T.init_cache(cfg, B, t + 1, device=dev), pre, cfg, t)
        del pre
        dec, cache = lserve.make_decode_step(cfg)(
            model, {"inputs": prompts[:, t:t + 1]}, cache, t)
        del cache
        full, _, _ = T.forward(model, cfg, prompts, impl="pallas")
        check_logits(f"prefill(x[:{t}]) logits vs forward(x)[{t - 1}]",
                     last, full[:, t - 1], LM_LOGIT_BOUND)
        check_logits(f"decode(prefill(x[:{t}]), x[{t}]) vs forward(x)[{t}]",
                     dec, full[:, t], LM_LOGIT_BOUND)
        finite = bool(torch.isfinite(full.float()).all())
        del full
    if not finite:
        raise AssertionError("non-finite logits")
    return launches


#: [8.*]'s arrival batches: new ratings as a share of the training set,
#: new users and items as a share of m and n, held-out share of a batch
ARRIVALS, ARRIVE_SHARE, ARRIVE_TEST = 3, 0.01, 0.05
#: [8.swap]: queries after each round, of which new users
SWAP_QUERIES, SWAP_NEW = 64, 16


def layout_check(ks, ref, eng, lr, lam, what: str) -> str:
    """After a grow or a migrate: the wave kernel on the new layout's
    hottest step (the longest wave chain), cut to its first 256 waves as
    in phase 2, from the live factors, held against ``ref.block_sgd_waves``
    with ``check_close``; the starting factors (no update) are a control
    the check must reject.  Returns the plan of the engine's launches."""
    br, dev = eng.br, eng.Ws.device
    s = int((br.wave_cnt > 0).sum(-1).max(0).argmax())
    pad = [torch.from_numpy(np.ascontiguousarray(a[:, s, :256])).to(dev)
           for a in (br.wave_rows, br.wave_cols, br.wave_vals,
                     br.wave_mask)]
    held = torch.from_numpy(eng.sched.table[s].astype(np.int64)).to(dev)
    Ws, Hs = eng.Ws, eng.Hs.index_select(0, held)
    Wg, Hg = ks.nomad_sgd_waves_grid(Ws, Hs, *pad, lr, lam)
    plain = [ref.block_sgd_waves(Ws[c], Hs[c], *(a[c] for a in pad), lr,
                                 lam) for c in range(br.p)]
    n_upd = max_row_updates(ks.WaveCSR.from_padded(*pad), br.m_local,
                            br.n_local)
    want_W = torch.stack([w for w, _ in plain])
    for x, got, want in (("W", Wg, want_W),
                         ("H", Hg, torch.stack([h for _, h in plain]))):
        check_close(f"{what} step {s} {x} p={br.p} n_local={br.n_local}",
                    got, want, n_upd)
    bound_ = 16 * EPS_FP32 * max(float(n_upd), 1.0) ** 0.5
    err = rel_err(Ws, want_W)
    phase("control", what=f"{what} no update", max_rel_err=f"{err:.3e}",
          bound=f"{bound_:.3e}", rejected=err > bound_)
    if not err > bound_:
        raise AssertionError(f"{what}: the check cannot tell a launch that "
                             "did nothing from the plain version")
    return ks.launch_plan(eng.Ws, eng.Hs).describe()


def arrival_batches(result, m: int, n: int, nnz: int, k: int):
    """[8.stream]'s arrival batches, drawn from a seeded numpy generator:
    each 1 % new ratings, 1 % new users and items, and a 5 % held-out
    share, valued by phase 3's trained factors (new users and items get
    seeded ones) plus noise, so the stream stays a low-rank problem."""
    rng = np.random.default_rng(8)
    m_new, n_new = round(m * ARRIVE_SHARE), round(n * ARRIVE_SHARE)
    count = round(nnz * ARRIVE_SHARE)
    Wt = np.concatenate([result.W, rng.standard_normal(
        (ARRIVALS * m_new, k)).astype(np.float32) / k ** 0.5])
    Ht = np.concatenate([result.H, rng.standard_normal(
        (ARRIVALS * n_new, k)).astype(np.float32) / k ** 0.5])
    out = []
    for t in range(ARRIVALS):
        hi_m, hi_n = m + (t + 1) * m_new, n + (t + 1) * n_new

        def draw(c):
            r, cc = rng.integers(0, hi_m, c), rng.integers(0, hi_n, c)
            v = (np.einsum("ij,ij->i", Wt[r], Ht[cc])
                 + 0.1 * rng.standard_normal(c)).astype(np.float32)
            return r, cc, v

        rows, cols, vals = draw(count)
        out.append(dict(rows=rows, cols=cols, vals=vals, m_new=m_new,
                        n_new=n_new, test=draw(round(count * ARRIVE_TEST))))
    return out


def stream_phase(api, ks, ref, problem, config, warm, dev):
    """[8.*]: streaming, elasticity and integrity on the card, warm from
    phase 3's result at its full width.  Returns the wave kernel's and
    the top-k kernel's launches on these paths."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import topk as ktopk
    from repro_torch.runtime.chaos import bitflip_checkpoint
    from repro_torch.serve import FactorStore, RecServer, ServeConfig

    t_phase = time.perf_counter()
    cfg1 = dataclasses.replace(config, epochs=1)
    lr, lam = float(np.float32(config.make_stepsize()(warm.epochs_done))), \
        config.lam
    batches = arrival_batches(warm, problem.m, problem.n, problem.nnz,
                              config.k)
    ckpt = Path(tempfile.mkdtemp(prefix="chip_smoke_stream_",
                                 dir=ROOT / "build"))
    launches = {"wave": 0, "topk": 0}

    def run(fn, epochs_of):
        """``fn()`` with the wave kernel's count zeroed before and read
        after; it must be one launch per schedule step of every epoch,
        and no other wrapper (``epochs_of(result)`` gives the epochs and
        steps it ran)."""
        ks.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = {w.__name__: w.launches for w in ks.WRAPPERS}
        want = epochs_of(out)
        if ks.nomad_sgd_waves_csr.launches != want \
                or sum(counts.values()) != want:
            raise AssertionError(f"launches {counts}, want {want} on "
                                 "nomad_sgd_waves_csr")
        launches["wave"] += want
        return out, want

    # [8.swap]'s store and server, attached to session A
    store = FactorStore(dev)
    store.publish_result(warm)
    sess = api.StreamingSession(
        problem, cfg1, warm_start=warm, device=dev,
        faults=api.FaultPolicy(checkpoint_dir=str(ckpt), keep=2))
    store.attach(sess)
    srv = RecServer(store, ServeConfig(top_k=10, max_batch=64))
    plain, calls = ktopk.topk_plain, [0]
    qrng = np.random.default_rng(88)

    def counted_plain(*a, **kw):
        calls[0] += 1
        return plain(*a, **kw)

    def swap_check(tag, m_before, version_before):
        """64 queries (16 of them new users) against the round's version:
        every microbatch through the kernel, none through the plain
        version, answers within check_topk of the plain version on the
        round's factors."""
        view = store.view()
        if view.version != version_before + 1:
            raise AssertionError(f"{tag}: version {view.version} after "
                                 f"{version_before}")
        fresh = (qrng.choice(np.arange(m_before, view.m), SWAP_NEW,
                             replace=False) if view.m > m_before
                 else np.zeros(0, np.int64))
        users = np.concatenate([fresh, qrng.choice(
            m_before, SWAP_QUERIES - len(fresh), replace=False)])
        ktopk.reset_launches()
        calls[0] = 0
        b0 = srv.n_batches
        ktopk.topk_plain = counted_plain
        try:
            with ThreadPoolExecutor(max_workers=4) as pool:
                recs = list(pool.map(lambda u: srv.recommend([u]), users))
        finally:
            ktopk.topk_plain = plain
        n_launch = ktopk.topk_scores_cuda.launches
        batches_ = srv.n_batches - b0
        launches["topk"] += n_launch
        if {r.version for r in recs} != {view.version}:
            raise AssertionError(f"{tag}: answers from versions "
                                 f"{sorted({r.version for r in recs})}")
        W_u = view.W.index_select(0, torch.from_numpy(users).to(dev))
        ps, pi = plain(W_u, view.H, k_top=11)
        s = torch.from_numpy(np.concatenate([r.scores for r in recs])).to(dev)
        i = torch.from_numpy(np.concatenate([r.items for r in recs])).to(dev)
        check_topk(f"{tag} served v{view.version}", s, i.to(pi.dtype), ps,
                   pi, view.k)
        phase("8.swap", round=tag, version=view.version, m=view.m, n=view.n,
              queries=len(users), new_users=len(fresh),
              microbatches=batches_, topk_launches=n_launch,
              plain_calls=calls[0])
        if n_launch < batches_ or calls[0] != 0:
            raise AssertionError(f"{tag}: {n_launch} launches for "
                                 f"{batches_} microbatches, {calls[0]} "
                                 "plain calls")

    def epochs_steps(res):
        return int(res.trace_epochs.size) * sess._eng.br.n_steps

    # -- [8.stream]: three arrivals, one epoch each ----------------------
    digests = []
    with srv:
        for t, b in enumerate(batches):
            m_before, v0 = sess.problem.m, store.version
            res, n_l = run(lambda: sess.arrive(**b), epochs_steps)
            eng = sess._eng
            tm = sess.timings
            digests.append(factor_digest(res.W, res.H))
            phase("8.stream", round=t + 1, m=eng.br.m, n=eng.br.n,
                  nnz=sess.problem.nnz, m_local=eng.br.m_local,
                  n_local=eng.br.n_local,
                  repack_delta_s=f"{tm['repack_delta']:.3f}",
                  grow_s=f"{tm['grow']:.3f}", epoch_s=f"{tm['train']:.3f}",
                  checkpoint_s=f"{tm['checkpoint']:.3f}",
                  rmse=f"{float(res.trace_rmse[-1]):.6f}",
                  launches=n_l, digest=digests[-1],
                  plan=ks.launch_plan(eng.Ws, eng.Hs).describe())
            swap_check(f"arrive{t + 1}", m_before, v0)
            layout_check(ks, ref, eng, lr, lam, f"grow {t + 1}")

        # the same chain through partial_fit calls, a session of its own
        chain, pr = warm, problem
        t0 = time.perf_counter()
        for b in batches:
            chain, _ = run(lambda: api.partial_fit(
                chain, pr.extend(**b), cfg1, device=dev),
                lambda r: r.extras["problem"].packed(
                    config.p, waves=True).n_steps)
            pr = chain.extras["problem"]
        chain_digest = factor_digest(chain.W, chain.H)
        phase("8.stream", chain="partial_fit", rounds=len(batches),
              seconds=f"{time.perf_counter() - t0:.2f}",
              digest=chain_digest, session_digest=digests[-1],
              equal=chain_digest == digests[-1])
        if chain_digest != digests[-1]:
            raise AssertionError("the partial_fit chain and the session "
                                 "differ")

        # -- [8.elastic]: a worker leaves, one joins ----------------------
        for what, kw in (("leave", dict(leave=(3,))), ("join",
                                                       dict(join=1))):
            tr = sess.resize(**kw)
            eng = sess._eng
            tm = sess.timings
            plan_ = layout_check(ks, ref, eng, lr, lam, f"migrate {what}")
            m_before, v0 = sess.problem.m, store.version
            res, n_l = run(lambda: sess.fit(), epochs_steps)
            phase("8.elastic", op=what, p=f"{tr.p_old}->{tr.p_new}",
                  moved_rows=len(tr.moved_rows),
                  moved_cols=len(tr.moved_cols),
                  repack_transition_s=f"{tm['repack_transition']:.3f}",
                  migrate_s=f"{tm['migrate']:.3f}",
                  epoch_s=f"{tm['train']:.3f}", n_steps=eng.br.n_steps,
                  m_local=eng.br.m_local, n_local=eng.br.n_local,
                  rmse=f"{float(res.trace_rmse[-1]):.6f}", launches=n_l,
                  digest=factor_digest(res.W, res.H), plan=plan_)
            swap_check(f"{what}", m_before, v0)
    sess.unsubscribe(store.publish_result)

    # -- [8.kill]: kill recovery against a graceful twin -----------------
    # the twin: a session warm from the partial_fit chain's result and its
    # pinned problem, through the same worker-set changes
    twin = api.StreamingSession(pr, cfg1, warm_start=chain, device=dev)
    twin.resize(leave=(3,))
    twin.fit()
    twin.resize(join=1)
    twin_res = twin.fit()
    if factor_digest(twin_res.W, twin_res.H) != factor_digest(
            sess.result.W, sess.result.H):
        raise AssertionError("the twin session differs before the kill")
    for worker, flip in ((5, False), (0, True)):
        if flip:
            # one more round each, then the newest checkpoint corrupted
            sess.fit()
            twin.fit()
            flipped = bitflip_checkpoint(str(ckpt), seed=8)
        t0 = time.perf_counter()
        sess.kill(worker)
        kill_s = time.perf_counter() - t0
        twin.resize(leave=(worker,))
        got = factor_digest(*sess._eng.factors())
        want = factor_digest(*twin._eng.factors())
        tm = sess.timings
        quarantined = (flip and (ckpt / f"step_{flipped:08d}.corrupt")
                       .is_dir())
        phase("8.kill", worker=worker, p=sess.config.p,
              bitflipped_newest=flip,
              **({"quarantined_step": flipped, "quarantined": quarantined}
                 if flip else {}),
              checkpoint_save_s=f"{tm['checkpoint']:.3f}",
              restore_s=f"{tm['restore']:.3f}",
              replay_s=f"{tm['replay']:.3f}",
              repack_transition_s=f"{tm['repack_transition']:.3f}",
              migrate_s=f"{tm['migrate']:.3f}", kill_s=f"{kill_s:.3f}",
              digest=got, twin_digest=want, equal=got == want)
        if got != want or (flip and not quarantined):
            raise AssertionError(f"kill({worker}): recovery {got} against "
                                 f"the twin's {want}, quarantined "
                                 f"{quarantined}")
    del twin, sess, chain, pr
    shutil.rmtree(ckpt, ignore_errors=True)

    # -- [8.faults]: crash-resume equals the uninterrupted run -----------
    ckpt = Path(tempfile.mkdtemp(prefix="chip_smoke_faults_",
                                 dir=ROOT / "build"))
    policy = api.FaultPolicy(checkpoint_dir=str(ckpt), checkpoint_every=1)
    n_steps = problem.packed(config.p, waves=True).n_steps
    t0 = time.perf_counter()
    _, n1 = run(lambda: api.solve(problem, dataclasses.replace(
        config, epochs=2), faults=policy, device=dev), lambda r: 2 * n_steps)
    part1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res, n2 = run(lambda: api.solve(problem, config, faults=policy,
                                    device=dev),
                  lambda r: (config.epochs - 2) * n_steps)
    part2_s = time.perf_counter() - t0
    got, want = factor_digest(res.W, res.H), factor_digest(warm.W, warm.H)
    same_trace = np.array_equal(res.trace_rmse, warm.trace_rmse)
    phase("8.faults", epochs=f"2+{config.epochs - 2}",
          part1_s=f"{part1_s:.3f}", part2_s=f"{part2_s:.3f}",
          launches=n1 + n2, digest=got, uninterrupted_digest=want,
          equal=got == want, trace_equal=same_trace)
    if got != want or not same_trace:
        raise AssertionError("crash-resume differs from the uninterrupted "
                             "run")
    shutil.rmtree(ckpt, ignore_errors=True)
    import resource
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    phase("8.done", seconds=f"{time.perf_counter() - t_phase:.1f}",
          wave_launches=launches["wave"], topk_launches=launches["topk"],
          host_peak_rss_gb=f"{rss_gb:.1f}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.1,
                    help="Netflix scale of the main path's problem")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs on an NVIDIA card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import api
    from repro_torch.core.nomad import wave_csr
    from repro_torch.core.stepsize import PowerSchedule
    from repro_torch.kernels import _build, nomad_sgd as ks, ref
    from repro_torch.kernels.policy import KernelPolicy

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 0. device ------------------------------------------------------
    smi = nvidia_smi()
    nvcc_ver = subprocess.run([_build.nvcc_path(), "--version"],
                              capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[-1]
    print(smi, flush=True)
    phase("0.device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, nvcc=repr(nvcc_ver))

    # -- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.load("nomad_sgd")
    phase("1.build", seconds=f"{time.perf_counter() - t0:.2f}",
          libraries=",".join(x.name for x in _build.library_paths()),
          max_k=lib.nomad_sgd_max_k(),
          flash_max_d=_build.load("flash_attn").flash_attention_max_d())
    # the wave kernel's plan and its C layout agree
    for n_t, kk, elem in ((228, 100, 4), (228, 100, 2), (2222, 100, 4),
                          (228, ks.MAX_K, 4), (1, 1, 2)):
        pl = ks.plan(n_t, kk, elem)
        c_smem = lib.nomad_sgd_smem(n_t, kk, elem, int(pl.resident), pl.R)
        if c_smem != pl.smem or lib.nomad_sgd_max_k() != ks.MAX_K:
            raise AssertionError(f"plan {pl} for ({n_t}, {kk}, {elem}): C "
                                 f"layout {c_smem} bytes")
    phase("1.plan", shapes=5, main=ks.plan(228, 100, 4).describe(),
          full_netflix=ks.plan(2222, 100, 4).describe())

    # -- 2. data, pack, kernels against their plain versions -------------
    m = max(500, int(2_649_429 * args.scale))
    n = max(200, int(17_770 * args.scale))
    k, p = 100, 8
    t0 = time.perf_counter()
    problem = api.MCProblem.synthetic(m, n, 37 * m, k=100, seed=0,
                                      noise=0.1, test_frac=0.05,
                                      split_seed=1)
    t_data = time.perf_counter() - t0
    config = api.NomadConfig(k=k, p=p, lam=0.01,
                             stepsize=PowerSchedule(0.096, 0.05),
                             kernel="wave_pallas", epochs=EPOCHS)
    t0 = time.perf_counter()
    br = problem.packed(p, balanced=config.balanced, waves=True,
                        sub_blocks=1, schedule=config.schedule,
                        schedule_seed=config.schedule_seed)
    t_pack = time.perf_counter() - t0
    phase("2.data", m=m, n=n, nnz=problem.nnz, test=len(problem.test[0]),
          data_s=f"{t_data:.2f}", pack_s=f"{t_pack:.2f}", p=p,
          m_local=br.m_local, n_local=br.n_local, max_nnz=br.max_nnz,
          n_waves=br.n_waves, wave_width=br.wave_width, n_steps=br.n_steps)

    gen = torch.Generator().manual_seed(0)
    Ws0 = (torch.rand((p, br.m_local, k), generator=gen) / k ** 0.5).to(dev)
    Hs0 = (torch.rand((p, br.n_local, k), generator=gen) / k ** 0.5).to(dev)
    lr, lam = 0.096, 0.01
    # the step with the longest wave chain, cut to its first cut_w waves
    waves_per = (br.wave_cnt > 0).sum(-1)               # (p, n_steps)
    s_hot = int(waves_per.max(0).argmax())
    cut_w = 256
    pad = [torch.from_numpy(a[:, s_hot, :cut_w]).to(dev)
           for a in (br.wave_rows, br.wave_cols, br.wave_vals, br.wave_mask)]
    cnt_cut = br.wave_cnt[:, s_hot, :cut_w].sum(-1)     # ratings per cell
    c_hot = int(cnt_cut.argmax())
    flat = [torch.from_numpy(a[c_hot, s_hot, :cnt_cut[c_hot]]).to(dev)
            for a in (br.rows, br.cols, br.vals)]
    n_upd = max_row_updates(ks.WaveCSR.from_padded(*pad), br.m_local,
                            br.n_local)
    errs = {}
    for policy in ("fp32", "bf16"):
        sd = torch.float32 if policy == "fp32" else torch.bfloat16
        cd = None if policy == "fp32" else torch.float32
        acc = policy != "fp32"
        Ws, Hs = Ws0.to(sd), Hs0.to(sd)
        ks.reset_launches()
        Wg, Hg = ks.nomad_sgd_waves_grid(Ws, Hs, *pad, lr, lam,
                                         accum_fp32=acc)
        cells = [ks.nomad_sgd_waves_block(Ws[c], Hs[c], *(a[c] for a in pad),
                                          lr, lam, accum_fp32=acc)
                 for c in range(p)]
        Wb, Hb = ks.nomad_sgd_block(
            Ws[c_hot], Hs[c_hot], *flat,
            torch.ones_like(flat[0], dtype=torch.bool), lr, lam,
            accum_fp32=acc)
        torch.cuda.synchronize()
        counts = {w.__name__: w.launches for w in ks.WRAPPERS}
        if min(counts[name] for name in PADDED) < 1:
            raise AssertionError(f"a wrapper did not launch: {counts}")
        check_bitwise(f"grid==per-cell W {policy}", Wg,
                      torch.stack([w for w, _ in cells]))
        check_bitwise(f"grid==per-cell H {policy}", Hg,
                      torch.stack([h for _, h in cells]))
        check_bitwise(f"sequential==waves W {policy}", Wb, cells[c_hot][0])
        check_bitwise(f"sequential==waves H {policy}", Hb, cells[c_hot][1])
        plain = [ref.block_sgd_waves(Ws[c], Hs[c], *(a[c] for a in pad),
                                     lr, lam, compute_dtype=cd)
                 for c in range(p)]
        e = [check_close(f"nomad_sgd_waves_grid {x} {policy}", g,
                         torch.stack([pl[i] for pl in plain]), n_upd, s0)
             for i, (x, g, s0) in enumerate((("W", Wg, Ws), ("H", Hg, Hs)))]
        errs["nomad_sgd_waves_grid", policy] = max(e)
        e = [check_close(f"nomad_sgd_waves_block {x} {policy}",
                         cells[c_hot][i], plain[c_hot][i], n_upd, s0)
             for i, (x, s0) in enumerate((("W", Ws[c_hot]),
                                          ("H", Hs[c_hot])))]
        errs["nomad_sgd_waves_block", policy] = max(e)
        Wr, Hr = ref.block_sgd_ref(
            Ws[c_hot], Hs[c_hot], *flat,
            torch.ones_like(flat[0], dtype=torch.bool), lr, lam,
            compute_dtype=cd)
        e = [check_close(f"nomad_sgd_block {x} {policy}", got, want, n_upd,
                         s0)
             for x, got, want, s0 in (("W", Wb, Wr, Ws[c_hot]),
                                      ("H", Hb, Hr, Hs[c_hot]))]
        errs["nomad_sgd_block", policy] = max(e)
        if policy == "bf16":
            # wrong results the bf16 check must reject: the update
            # accumulated in bf16, and no update at all
            Wa, Ha = ref.block_sgd_waves(
                Ws[c_hot], Hs[c_hot], *(a[c_hot] for a in pad), lr, lam)
            start = torch.cat([Ws[c_hot], Hs[c_hot]])
            check_control("plain accumulating in bf16",
                          torch.cat([Wa, Ha]), torch.cat(plain[c_hot]), start)
            check_control("no update", start, torch.cat(plain[c_hot]), start)
        phase("2.kernels", policy=policy, step=s_hot, waves_cut=cut_w,
              ratings=int(cnt_cut.sum()), launches=json.dumps(counts))

    # -- 3. the main path, then the other routes --------------------------
    n_steps = br.n_steps
    routes = {}
    for route, kernel, epochs, per_step in (
            ("grid", "wave_pallas", EPOCHS, 1),
            ("per_cell", KernelPolicy(impl="wave_pallas", block_rows=-1), 1,
             p),
            ("sequential", "pallas", 1, 1)):
        cfg = api.NomadConfig(k=k, p=p, lam=0.01,
                              stepsize=PowerSchedule(0.096, 0.05),
                              kernel=kernel, epochs=epochs)
        torch.cuda.reset_peak_memory_stats()
        ks.reset_launches()
        t0 = time.perf_counter()
        res = api.solve(problem, cfg, device=dev)
        wall = time.perf_counter() - t0
        counts = {w.__name__: w.launches for w in ks.WRAPPERS}
        want = epochs * n_steps * per_step
        launched = ks.nomad_sgd_waves_csr.launches
        if launched != want or sum(counts.values()) != want:
            raise AssertionError(f"{route}: launches {counts}, want {want} "
                                 "on nomad_sgd_waves_csr")
        rm = [float(x) for x in res.rmse]
        if not (len(rm) == epochs and all(b < a for a, b in zip(
                [float("inf")] + rm, rm))):
            raise AssertionError(f"{route}: RMSE trace {rm} not strictly "
                                 "descending")
        finite = res.extras["divergence"]["finite"]
        if not (finite and res.W.shape == (m, k) and res.H.shape == (n, k)
                and bool(np.isfinite(res.W).all())
                and bool(np.isfinite(res.H).all())):
            raise AssertionError(f"{route}: non-finite or misshapen factors")
        routes[route] = dict(launches=launched, wall_s=wall, result=res)
        phase(f"3.{route}", epochs=epochs, wall_s=f"{wall:.3f}",
              rmse=json.dumps(rm), last_finite=finite,
              digest=factor_digest(res.W, res.H),
              max_mem_bytes=torch.cuda.max_memory_allocated(),
              launches=json.dumps(counts), want=want)

    # a small problem on the card against the plain versions on the CPU
    small = api.MCProblem.synthetic(2000, 400, 40_000, k=16, seed=0,
                                    noise=0.1, test_frac=0.1)
    rng = np.random.default_rng(0)
    warm = api.FitResult(
        W=rng.uniform(0, 0.25, (2000, 16)).astype(np.float32),
        H=rng.uniform(0, 0.25, (400, 16)).astype(np.float32),
        trace_epochs=np.zeros(0), trace_rmse=np.zeros(0), epochs_done=0)
    scfg = api.NomadConfig(k=16, p=4, lam=0.05, kernel="wave_pallas",
                           epochs=3)
    on_card = api.solve(small, scfg, warm_start=warm, device=dev)
    on_cpu = api.solve(small, scfg, warm_start=warm, device="cpu")
    n_small = 3 * small.nnz / (2000 + 400)
    for x in "WH":
        check_close(f"small solve {x} card vs cpu", torch.from_numpy(
            getattr(on_card, x)), torch.from_numpy(getattr(on_cpu, x)),
            n_small)
    gap = float(np.max(np.abs(on_card.rmse - on_cpu.rmse) / on_cpu.rmse))
    if not gap <= 1e-5:
        raise AssertionError(f"small solve RMSE traces differ by {gap}")
    phase("3.small", rmse_card=json.dumps(on_card.rmse.tolist()),
          rmse_cpu=json.dumps(on_cpu.rmse.tolist()), rel_gap=f"{gap:.2e}")

    # -- 4. timing on the main path's real step layout --------------------
    csr = wave_csr(br).to(dev)
    steps = [csr.cells(s * p, (s + 1) * p) for s in range(n_steps)]
    chains = [chain(c) for c in steps]
    plan = ks.launch_plan(Ws0, Hs0)
    variant = plan.describe()
    # the step with the longest chain, and its longest cell
    s_t = max(range(n_steps), key=chains.__getitem__)
    step = steps[s_t]
    c_t = int(torch.diff(step.cell_woff.long()).argmax())
    one = step.cells(c_t, c_t + 1)
    W1, H1 = Ws0[c_t:c_t + 1], Hs0[c_t:c_t + 1]
    # where that cell's waves spend their time: with H in global memory
    # beside the ring (the variant for a larger H block), and as the plan
    # lays it out
    h_global = ks.Plan(False, plan.R, plan.copy_bytes,
                       ks.plan_smem(br.n_local, k, 4, False, plan.R))
    if h_global != plan:
        wave_split(ks, W1, H1, one, lr, lam, h_global,
                   f"step {s_t} cell {c_t}")
    split = wave_split(ks, W1, H1, one, lr, lam, plan,
                       f"step {s_t} cell {c_t}")
    # the chain bound: each dependent wave at least a shared-memory row
    # round trip, the butterfly and a barrier, as warp 0 measured them
    floor_ns = (split["rows_cycles"] + split["butterfly_cycles"]
                + split["barrier_cycles"]) * split["ns_per_cycle"]
    phase("4.floor", variant=variant, floor_ns_per_wave=f"{floor_ns:.1f}",
          of="rows + butterfly + barrier of the split above")

    def chain_ms(c) -> float:
        return chain(c) * floor_ns * 1e-6

    Ws, Hs = Ws0.clone(), Hs0.clone()
    step_ms = []
    for s, c in enumerate(steps):
        t = cuda_ms(lambda: ks.nomad_sgd_waves_csr(Ws, Hs, c, lr, lam), 3)
        step_ms.append(t)
        b_ms, b_by = bound(Ws, Hs, c)
        phase("4.step", step=s, kernel_ms=f"{t:.3f}", bound_ms=f"{b_ms:.4f}",
              bound_by=b_by, chain=chains[s],
              chain_bound_ms=f"{chain_ms(c):.3f}",
              ratings=cell_ratings(c)[1].numel(), variant=variant)

    def timed_pair(csr_t, W0, H0):
        """One launch of ``nomad_sgd_waves_csr`` on ``csr_t`` from
        ``(W0, H0)``: its time (CUDA events), the plain version's time
        (host clock) on the same inputs, the kernel's max abs error
        against it, and the kernel's result."""
        Wt, Ht = W0.clone(), H0.clone()
        k_ms = cuda_ms(lambda: ks.nomad_sgd_waves_csr(Wt, Ht, csr_t, lr,
                                                      lam), 3)
        Wk, Hk = ks.nomad_sgd_waves_csr(W0.clone(), H0.clone(), csr_t, lr,
                                        lam)
        n_c, m_t, kk = W0.shape
        n_t = H0.shape[1]
        flat = interleave(csr_t, m_t, n_t)
        (Wp, Hp), p_ms = timed(lambda: ks.block_sgd_waves_csr(
            W0.clone().view(1, n_c * m_t, kk),
            H0.clone().view(1, n_c * n_t, kk), flat, lr, lam))
        upd = max_row_updates(csr_t, m_t, n_t)
        err = max(check_close(f"{x} kernel vs plain", got, want.view_as(got),
                              upd) for x, got, want in (("W", Wk, Wp),
                                                        ("H", Hk, Hp)))
        return k_ms, p_ms, err, (Wk, Hk)

    # each cell of the hottest step alone: does a step cost its slowest
    # cell?
    alone = [cuda_ms(lambda: ks.nomad_sgd_waves_csr(
        Ws[c:c + 1], Hs[c:c + 1], step.cells(c, c + 1), lr, lam), 1)
        for c in range(p)]
    phase("4.cells", step=s_t, alone_ms=json.dumps([round(t, 3)
                                                    for t in alone]),
          chains=json.dumps(torch.diff(step.cell_woff.long()).tolist()),
          chain_bound_ms=json.dumps([round(chain_ms(step.cells(c, c + 1)),
                                           3) for c in range(p)]),
          ratings=json.dumps(torch.bincount(cell_ratings(step)[0],
                                            minlength=p).tolist()),
          variant=variant)
    h_global_check(ks, dev, br.m_local, k, lr, lam)

    # where solve's time goes: its engine's pieces, one by one
    from repro_torch.core.nomad import NomadRingEngine
    from repro_torch.core.objective import init_factors
    W0, H0 = (x.numpy() for x in init_factors(
        torch.Generator().manual_seed(config.seed), m, n, k))
    eng, engine_ms = timed(lambda: NomadRingEngine(
        br=br, k=k, lam=config.lam, stepsize=config.make_stepsize(),
        policy=config.kernel, device=dev))
    _, init_ms = timed(lambda: eng.init_factors(W0, H0))
    _, train_ms = timed(lambda: eng.train(EPOCHS, test=problem.test,
                                          dispatch="fused"))
    _, factors_ms = timed(eng.factors)
    phase("4.split", epochs=EPOCHS, engine_ms=f"{engine_ms:.1f}",
          init_factors_ms=f"{init_ms:.1f}", train_ms=f"{train_ms:.1f}",
          factors_ms=f"{factors_ms:.1f}", variant=variant)

    # grid route: the step, one launch for its p cells
    grid_ms, grid_plain_ms, grid_err, _ = timed_pair(step, Ws0, Hs0)
    # per-cell route: that step's longest cell, one launch for the cell
    cell_ms, cell_plain_ms, cell_err, _ = timed_pair(one, W1, H1)
    # sequential route: the same step with every rating its own wave,
    # one launch for its p cells, as the engine builds it
    seq = wave_csr(br, sequential=True).to(dev).cells(s_t * p,
                                                      (s_t + 1) * p)
    seq_ms, seq_plain_ms, seq_err, (Wq, Hq) = timed_pair(seq, Ws0, Hs0)
    # the padded sequential wrapper on one whole cell of it: bitwise the
    # sequential route's result for that cell
    _, r1, c1 = cell_ratings(seq.cells(c_t, c_t + 1))
    lo, hi = (int(seq.woff[seq.cell_woff[c_t + i]]) for i in (0, 1))
    v1 = seq.vals[lo:hi]
    ones = torch.ones_like(r1, dtype=torch.bool)
    ks.reset_launches()
    (Wb, Hb), block_ms = timed(lambda: ks.nomad_sgd_block(
        Ws0[c_t], Hs0[c_t], r1.int(), c1.int(), v1, ones, lr, lam))
    if ks.nomad_sgd_block.launches != 1:
        raise AssertionError("nomad_sgd_block did not launch once")
    check_bitwise("nomad_sgd_block whole cell == sequential route W", Wb,
                  Wq[c_t])
    check_bitwise("nomad_sgd_block whole cell == sequential route H", Hb,
                  Hq[c_t])
    epoch_kernel_ms = sum(step_ms)
    phase("4.timing", step=s_t, chain=chains[s_t],
          step_kernel_ms=f"{grid_ms:.3f}", step_plain_ms=f"{grid_plain_ms:.1f}",
          cell=c_t, cell_chain=chain(one), cell_kernel_ms=f"{cell_ms:.3f}",
          cell_plain_ms=f"{cell_plain_ms:.1f}", seq_chain=chain(seq),
          seq_kernel_ms=f"{seq_ms:.3f}", seq_plain_ms=f"{seq_plain_ms:.1f}",
          block_cell_ratings=r1.numel(), block_host_ms=f"{block_ms:.1f}",
          epoch_kernel_ms=f"{epoch_kernel_ms:.2f}", epoch_chain=sum(chains),
          step_chain_bound_ms=f"{chain_ms(step):.3f}",
          cell_chain_bound_ms=f"{chain_ms(one):.3f}",
          seq_chain_bound_ms=f"{chain_ms(seq):.3f}",
          epoch_chain_bound_ms=f"{sum(map(chain_ms, steps)):.2f}",
          kernel_updates_per_s=f"{problem.nnz / epoch_kernel_ms * 1e3:.4g}",
          solve_s_per_epoch=f"{routes['grid']['wall_s'] / EPOCHS:.3f}",
          variant=variant)

    # a persistent kernel that passes H blocks between cells as they
    # finish (ROADMAP R2b) against the step loop, at the hottest cell's
    # measured cost per wave
    step_waves, path_waves = dependency_path(br, csr)
    us_wave = alone[c_t] * 1e3 / chain(one)
    phase("4.r2b", step_max_sum_waves=step_waves,
          longest_path_waves=path_waves,
          us_per_wave=f"{us_wave:.4f}",
          step_loop_ms=f"{step_waves * us_wave * 1e-3:.2f}",
          longest_path_ms=f"{path_waves * us_wave * 1e-3:.2f}",
          variant=variant)

    kernels = []
    for route, k_ms, p_ms, err, (b_ms, b_by) in (
            ("grid", grid_ms, grid_plain_ms, grid_err,
             bound(Ws0, Hs0, step)),
            ("per_cell", cell_ms, cell_plain_ms, cell_err,
             bound(W1, H1, one)),
            ("sequential", seq_ms, seq_plain_ms, seq_err,
             bound(Ws0, Hs0, seq))):
        kernels.append(dict(
            name=f"nomad_sgd_waves_csr[{route}]", route="cuda",
            source=KERNEL_SRC, replaces=REPLACES[route],
            launches=routes[route]["launches"], max_abs_err=err, ms=k_ms,
            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
            variant=variant))
    record, serve_launches = serve_phase(routes["grid"]["result"], problem,
                                         dev)
    kernels.append(record)
    kernels.extend(topk_phase(dev, serve_launches))
    torch.cuda.empty_cache()
    flash_launches = lm_phase(dev)
    torch.cuda.empty_cache()
    kernels.extend(flash_kernel_checks(dev, flash_launches))
    torch.cuda.empty_cache()
    stream = stream_phase(api, ks, ref, problem, config,
                          routes["grid"]["result"], dev)
    for rec in kernels:
        if rec["name"] == "nomad_sgd_waves_csr[grid]":
            rec["launches"] += stream["wave"]
            rec["launches_on"] = "[3.grid] and [8.*]"
        elif rec["name"].startswith("topk_scores_cuda"):
            rec["launches"] += stream["topk"]
            rec["launches_on"] = "[5.serve] and [8.swap]"
    phase("done", seconds=f"{time.perf_counter() - t_start:.1f}",
          errors=json.dumps({f"{a}/{b}": f"{v:.3e}"
                             for (a, b), v in errs.items()}))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
