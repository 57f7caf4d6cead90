#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # Netflix x 0.1, k=100, p=8, 3 epochs;
                                     # Qwen2.5-32B serving; streaming; then
                                     # the full Netflix size: NOMAD, its
                                     # SPMD executor in 8 ranks, then the
                                     # paper's baselines

Phases, one line each (any failure raises and exits non-zero):

0. device: the card's name and power limit (nvidia-smi), torch, CUDA and
   nvcc versions;
1. build: compiles ``src/repro_torch/kernels/csrc/*.cu`` (one nvcc per
   source, in parallel, sm_90a) and prints the build seconds;
2. data + pack of the main path's problem, then every kernel wrapper
   against its plain PyTorch version on cells cut from that pack (a
   window of its padded wave layout, ``partition.padded_waves``), at
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
   and as the plan lays it out, each bitwise the launch's result (the
   variant for an H block too large for shared memory is held against
   its plain version at full Netflix, phase 9); and
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
   ``StreamingSession`` absorbs two arrival batches (each 1 % new
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
   before and read after;
9. the main path at the paper's full Netflix size (``[9.netflix]``):
   ``MCProblem.synthetic(2,649,429, 17,770, 99,072,112, k=100, seed=0)``
   with 10 % held out, through ``api.solve`` (k=100, p=8, the ring,
   ``kernel="wave_pallas"``, fp32, the paper's Netflix step sizes, 3
   epochs): generation and pack seconds, host and card peak memory, the
   padded wave layout never built, the plan (H in global memory: 2,222
   item rows do not fit in shared memory), 8 launches per epoch and no
   plain call, a descending RMSE trace; the engine's pieces, each step's
   time (CUDA events) beside its byte bound and its chain bound (chain x
   ``[4.floor]``'s ns per wave), seconds per epoch and updates per
   second; the kernel against its plain version on the hottest cell's
   first waves (at most 100,000 ratings, a window of the padded layout)
   with a no-update control.  Then ``[9.sim]``: the discrete-event
   simulator (``AsyncSimConfig(p=8, emit_schedule=True)``) on a small
   problem on the host, its ``update_log`` replayed bitwise by
   ``serial.replay_np``, and its schedule through the wave kernel on the
   card (``n_steps`` launches per epoch, 0 plain), held against
   ``serial.replay_torch`` of ``schedule_order()`` on the card at
   ``rtol=2e-5, atol=2e-6``, with a shuffled order as a control.
10. the paper's baselines at full Netflix on phase 9's problem (its wave
   pack released first): DSGD through ``api.solve`` with phase 9's
   settings (``DsgdConfig(k=100, p=8)``, 3 epochs; ``[10.dsgd]``): pack
   seconds (no coloring), solve seconds, 8 launches an epoch of the
   kernel's sequential route and no plain call, factors whose digest
   must equal ``[9.solve]``'s, a descending trace; each sub-epoch's
   launch by CUDA events beside its byte and chain bounds; the kernel
   against its plain version on the first 50,000 ratings of the hottest
   sub-epoch's largest cell, with a no-update control.  Then CCD++ (1
   epoch, ``inner=3``, eq. (1) read after it), ALS (1 epoch) and
   Hogwild (1 epoch, minibatches of 256), cold from seed 0: seconds per
   epoch, card and host peaks, the RMSE trace against the initial
   factors', all-finite factors; and ``[10.als.resume]``: on phase 2's
   problem, 1 + 1 ALS epochs through ``warm_start`` equal 2, bitwise.
11. NOMAD's SPMD executor (it runs between ``[9.sim]`` and phase 10, on
   phase 9's wave pack): 8 ranks started by
   ``launch.mesh.spawn_ranks`` share the card, so their H blocks travel
   by gloo through pinned host buffers (the transport is printed).
   Phase 9's pack, cold start and held-out ratings are written once
   under ``build/`` and mapped read-only by the ranks.
   ``[11.netflix]``: ``NomadRingEngine(mesh=)`` with ``[9.solve]``'s
   settings for 3 fused epochs; the factors' digest must be
   ``[9.solve]``'s, every rank must launch the wave kernel 24 times and
   call no plain version, the RMSE trace must be ``[9.solve]``'s
   (bitwise, or within 1e-6); per step each rank's kernel ms (CUDA
   events), staging and gloo ms per hop, the step's wall; seconds per
   epoch beside ``[9.split]``'s, spawn to ready, card and host peaks.
   ``[11.api]``: ``api.solve(mesh=)`` on Netflix x 0.02 (1 epoch) for
   the ring, random and balanced schedules, each digest equal to this
   process's one-device ``solve``, the ring's loop dispatch equal to its
   fused one, and ``sub_blocks=2`` (the sequential route, sub-block by
   sub-block) equal to the one-device ``solve`` of the same config.  Any
   rank's failure or timeout fails the phase.
12. NOMAD's streaming, elastic and fault-tolerant paths on the mesh, in
   the same spawn as phase 11, after it: phase 2's ratings, phase 3's
   factors and packing (with the ratings' ids) are written once under
   ``build/`` and mapped by the ranks.  ``StreamingSession(mesh=)`` warm
   from phase 3's result replays phase 8's sequence: the two arrival
   batches, one epoch each; a leave (worker 3) and a join, each onto a
   mesh of the new worker count within the 8 ranks
   (``McMesh.ranks_after``), each followed by ``fit()``; ``kill(5)``;
   ``fit()``; the newest checkpoint bit-flipped; ``kill(0)``
   (``[12.op]``, one line an op: the digest, which must equal phase 8's
   for the same op, or the factors before a resize; the wave kernel's
   launches, steps x epochs on member ranks and 0 on idle ones; 0 plain
   calls; the idle ranks; the slowest rank's seconds of each part: the
   lead rank's re-pack that the others map, migrate with its gather, the
   epoch, checkpoint save, restore and replay).  ``[12.faults]``:
   ``solve(faults=, mesh=)`` cut after 2 epochs and resumed equals phase
   3's run.  ``[12.chaos]``: ``ChaosHarness(mesh_factory=make_mc_mesh)``
   with a leave, a join, a kill and a NaN on a small problem equals the
   same harness on one device in this process.  ``[12.ranks]``: each
   rank's card and host peaks.

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
    """sha256 of the factors' bytes, W then H
    (``repro_torch.testing.factor_digest``, which the ranks of phase 11
    use too): equal digests from two trees in one call show their results
    bitwise equal."""
    from repro_torch.testing import factor_digest as digest
    return digest(W, H)


#: the segments of ``nomad_sgd.wave_split``: warp 0's index fetch, row
#: fetch, butterfly, update and wait to the barrier's end; the stager
#: warp's staging, copy wait and wait to the barrier's end
SPLIT_NAMES = ("index", "rows", "butterfly", "update", "barrier", "stage",
               "wait", "stager_barrier")


def wave_split(ks, W, H, csr, lr, lam, plan, what: str,
               tag: str = "4.wave.split") -> dict:
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
    phase(tag, what=what, variant=plan.describe(),
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
#: (a third batch, a repeat of the second, was cut to keep the smoke near
#: half its time limit once phase 11 came)
ARRIVALS, ARRIVE_SHARE, ARRIVE_TEST = 2, 0.01, 0.05
#: [8.swap]: queries after each round, of which new users
SWAP_QUERIES, SWAP_NEW = 64, 16


def layout_check(ks, ref, eng, lr, lam, what: str) -> str:
    """After a grow or a migrate: the wave kernel on the new layout's
    hottest step (the longest wave chain), cut to its first 256 waves as
    in phase 2, from the live factors, held against ``ref.block_sgd_waves``
    with ``check_close``; the starting factors (no update) are a control
    the check must reject.  Returns the plan of the engine's launches."""
    from repro_torch.core.partition import padded_waves
    br, dev = eng.br, eng.Ws.device
    s = int((br.wave_cnt > 0).sum(-1).max(0).argmax())
    pad = [torch.from_numpy(a).to(dev)
           for a in padded_waves(br, s, slice(0, 256))[:4]]
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
    the top-k kernel's launches on these paths, and the digests phase 12
    is held to (keyed by its ops: ``arrive1``, ``arrive2``, ``fit after
    leave``, ``fit after join``, ``kill5``, ``fit after kill5``,
    ``kill0``, ``faults``)."""
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
    want = {}

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

    # -- [8.stream]: the arrivals, one epoch each -----------------------
    digests = []
    with srv:
        for t, b in enumerate(batches):
            m_before, v0 = sess.problem.m, store.version
            res, n_l = run(lambda: sess.arrive(**b), epochs_steps)
            eng = sess._eng
            tm = sess.timings
            digests.append(factor_digest(res.W, res.H))
            want[f"arrive{t + 1}"] = digests[-1]
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
            want[f"fit after {what}"] = factor_digest(res.W, res.H)
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
    # the twin: a session warm from the session's result, on its problem
    # (pinned to its partition and schedule, the packing a cache hit) and
    # config, which departs gracefully where the session is killed
    twin = api.StreamingSession(sess.problem, sess.config,
                                warm_start=sess.result, device=dev)
    for worker, flip in ((5, False), (0, True)):
        if flip:
            # one more round each, then the newest checkpoint corrupted
            res = sess.fit()
            want["fit after kill5"] = factor_digest(res.W, res.H)
            twin.fit()
            flipped = bitflip_checkpoint(str(ckpt), seed=8)
        t0 = time.perf_counter()
        sess.kill(worker)
        kill_s = time.perf_counter() - t0
        twin.resize(leave=(worker,))
        got = factor_digest(*sess._eng.factors())
        twin_d = factor_digest(*twin._eng.factors())
        want[f"kill{worker}"] = got
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
              digest=got, twin_digest=twin_d, equal=got == twin_d)
        if got != twin_d or (flip and not quarantined):
            raise AssertionError(f"kill({worker}): recovery {got} against "
                                 f"the twin's {twin_d}, quarantined "
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
    got, whole = factor_digest(res.W, res.H), factor_digest(warm.W, warm.H)
    want["faults"] = got
    same_trace = np.array_equal(res.trace_rmse, warm.trace_rmse)
    phase("8.faults", epochs=f"2+{config.epochs - 2}",
          part1_s=f"{part1_s:.3f}", part2_s=f"{part2_s:.3f}",
          launches=n1 + n2, digest=got, uninterrupted_digest=whole,
          equal=got == whole, trace_equal=same_trace)
    if got != whole or not same_trace:
        raise AssertionError("crash-resume differs from the uninterrupted "
                             "run")
    shutil.rmtree(ckpt, ignore_errors=True)
    import resource
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    phase("8.done", seconds=f"{time.perf_counter() - t_phase:.1f}",
          wave_launches=launches["wave"], topk_launches=launches["topk"],
          host_peak_rss_gb=f"{rss_gb:.1f}")
    return launches, want


#: [9.netflix]: the paper's Netflix (its Table 2) with its
#: hyperparameters (``configs/nomad_mf.py``), synthetic from seed 0, 10 %
#: held out; epochs of ``solve``
NETFLIX_EPOCHS = 3
#: [9.netflix]'s kernel check: the hottest cell's first waves, up to this
#: many ratings
CHECK_RATINGS = 100_000
#: [9.sim]: the simulator's problem (users, items, ratings, rank), its
#: workers, and the epochs its schedule runs on the card
SIM_M, SIM_N, SIM_NNZ, SIM_K, SIM_P = 2000, 500, 40_000, 16, 8
SIM_EPOCHS = 1
#: the reference tests' tolerance of an engine against the serial replay
REPLAY_RTOL, REPLAY_ATOL = 2e-5, 2e-6
#: bytes of one padded wave slot: row, col, value, mask, global id
SLOT_BYTES = 4 + 4 + 4 + 1 + 8


def count_plain(ks):
    """Count the calls of the wave kernel's plain version (the wrappers'
    CPU path) until the returned ``restore()``; returns ``(calls,
    restore)`` with ``calls[0]`` the count."""
    plain, calls = ks.block_sgd_waves_csr, [0]

    def counted(*a, **kw):
        calls[0] += 1
        return plain(*a, **kw)

    ks.block_sgd_waves_csr = counted

    def restore():
        ks.block_sgd_waves_csr = plain
    return calls, restore


def netflix_phase(api, ks, ref, dev, floor_ns):
    """[9.netflix]: the main path at the paper's full Netflix size —
    ``MCProblem.synthetic(2,649,429, 17,770, 99,072,112, k=100, seed=0)``
    through ``api.solve`` with k=100, p=8, the ring schedule,
    ``kernel="wave_pallas"``, fp32, 3 epochs — with its generation and
    pack seconds, host and card peak memory, the padded wave layout never
    built, the plan (H in global memory), launches (8 per epoch, 0 plain
    calls), a descending RMSE trace; then the engine's pieces, each step's
    time by CUDA events beside its byte bound and its chain bounds (chain
    x ``floor_ns``, ``[4.floor]``'s ns per wave of the H-resident plan,
    and chain x the H-global plan's own floor from ``[9.wave.split]``),
    and the kernel against its plain version on the hottest
    cell's first waves, read through ``partition.padded_waves``, with a
    no-update control.  Returns the kernel record, the problem (its wave
    pack kept for phase 11), ``[9.solve]``'s digest, the H-global plan's
    ns per wave, and what phase 11 reads of this run: the packing, the
    config, ``[9.solve]``'s RMSE trace and ``[9.split]``'s epoch ms."""
    from repro_torch.configs.nomad_mf import NETFLIX
    from repro_torch.core.nomad import NomadRingEngine
    from repro_torch.core.partition import padded_waves
    from repro_torch.core.stepsize import PowerSchedule
    from repro_torch.testing import HostPeak

    t_phase = time.perf_counter()
    peak = HostPeak()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    problem = api.MCProblem.synthetic(NETFLIX.m, NETFLIX.n, NETFLIX.nnz,
                                      k=NETFLIX.k, seed=0)
    gen_s = time.perf_counter() - t0
    n_test = len(problem.test[0])
    phase("9.data", m=problem.m, n=problem.n, ratings=problem.nnz + n_test,
          train=problem.nnz, test=n_test, requested=NETFLIX.nnz,
          gen_s=f"{gen_s:.2f}", host_peak_rss_gb=peak.gb())
    k, p = NETFLIX.k, 8
    config = api.NomadConfig(
        k=k, p=p, lam=NETFLIX.lam,
        stepsize=PowerSchedule(NETFLIX.alpha, NETFLIX.beta),
        kernel="wave_pallas", epochs=NETFLIX_EPOCHS)
    t0 = time.perf_counter()
    br = problem.packed(p, balanced=config.balanced, waves=True,
                        sub_blocks=1, schedule=config.schedule,
                        schedule_seed=config.schedule_seed)
    pack_s = time.perf_counter() - t0
    built = br.__dict__.get("_padded_waves") is not None
    slots = br.p * br.n_steps * br.n_waves * br.wave_width
    plan = ks.plan(br.n_local, k, 4)
    waves_per = (br.wave_cnt > 0).sum(-1)                  # (p, n_steps)
    s_hot = int(waves_per.max(0).argmax())
    q_hot = int(waves_per[:, s_hot].argmax())
    phase("9.pack", pack_s=f"{pack_s:.2f}", p=p, n_steps=br.n_steps,
          m_local=br.m_local, n_local=br.n_local, max_nnz=br.max_nnz,
          n_waves=br.n_waves, wave_width=br.wave_width,
          padded_built=built, padded_slots=slots,
          padded_bytes=slots * SLOT_BYTES, variant=plan.describe(),
          hot_step=s_hot, hot_cell=q_hot,
          hot_step_waves=json.dumps(waves_per[:, s_hot].tolist()),
          hot_step_ratings=json.dumps(br.nnz_cell[:, s_hot].tolist()),
          host_peak_rss_gb=peak.gb())
    if built or plan.resident:
        raise AssertionError(f"padded layout built {built}, plan "
                             f"{plan.describe()} (want H_global)")

    # the main path: launches counted, plain calls counted
    calls, restore = count_plain(ks)
    ks.reset_launches()
    try:
        t0 = time.perf_counter()
        res = api.solve(problem, config, device=dev)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
    finally:
        restore()
    counts = {w.__name__: w.launches for w in ks.WRAPPERS}
    launched = ks.nomad_sgd_waves_csr.launches
    want = NETFLIX_EPOCHS * br.n_steps
    card_peak = torch.cuda.max_memory_allocated()
    rm = [float(x) for x in res.rmse]
    digest = factor_digest(res.W, res.H)
    phase("9.solve", epochs=NETFLIX_EPOCHS, wall_s=f"{solve_s:.2f}",
          rmse=json.dumps(rm), last_finite=res.extras["divergence"]["finite"],
          digest=digest,
          launches=json.dumps(counts), want=want, plain_calls=calls[0],
          card_peak_bytes=card_peak, host_peak_rss_gb=peak.gb())
    if launched != want or sum(counts.values()) != want or calls[0]:
        raise AssertionError(f"launches {counts}, plain calls {calls[0]}, "
                             f"want {want} launches")
    if not (len(rm) == NETFLIX_EPOCHS and all(
            b < a for a, b in zip([float("inf")] + rm, rm))):
        raise AssertionError(f"RMSE trace {rm} not strictly descending")
    if not (res.extras["divergence"]["finite"]
            and res.W.shape == (problem.m, k)
            and res.H.shape == (problem.n, k)
            and bool(np.isfinite(res.W).all())
            and bool(np.isfinite(res.H).all())):
        raise AssertionError("non-finite or misshapen factors")

    # where solve's time goes: its engine's pieces, on the trained factors
    eng, engine_ms = timed(lambda: NomadRingEngine(
        br=br, k=k, lam=config.lam, stepsize=config.make_stepsize(),
        policy=config.kernel, device=dev))
    _, init_ms = timed(lambda: eng.init_factors(res.W, res.H))
    live = ks.launch_plan(eng.Ws, eng.Hs)
    variant = live.describe()
    if live.resident:
        raise AssertionError(f"launch plan {variant} keeps H resident")
    eng.epoch_idx = NETFLIX_EPOCHS
    lr = float(np.float32(config.make_stepsize()(NETFLIX_EPOCHS)))
    lam = config.lam

    # the kernel against its plain version: the hottest cell's first
    # waves, from the trained factors (every H block home)
    cum = np.cumsum(br.wave_cnt[q_hot, s_hot])
    w_cut = max(1, int(np.searchsorted(cum, CHECK_RATINGS, side="right")))
    pad = [torch.from_numpy(a).to(dev) for a in padded_waves(
        br, s_hot, slice(0, w_cut), workers=q_hot)[:4]]
    csr = ks.WaveCSR.from_padded(*(a[None] for a in pad))
    csr.check_bounds(br.m_local, br.n_local)
    b_hot = br.block_at(q_hot, s_hot)
    W1 = eng.Ws[q_hot:q_hot + 1].clone()
    H1 = eng.Hs[b_hot:b_hot + 1].clone()
    # where those waves spend their time under the H-global plan, and
    # that plan's own floor (a row fetch, the butterfly, a barrier)
    sp = wave_split(ks, W1, H1, csr, lr, lam, ks.launch_plan(W1, H1),
                    f"full Netflix step {s_hot} cell {q_hot}",
                    tag="9.wave.split")
    global_floor_ns = ((sp["rows_cycles"] + sp["butterfly_cycles"]
                        + sp["barrier_cycles"]) * sp["ns_per_cycle"])
    Wk, Hk = ks.nomad_sgd_waves_csr(W1.clone(), H1.clone(), csr, lr, lam)
    Wt, Ht = W1.clone(), H1.clone()
    k_ms = cuda_ms(lambda: ks.nomad_sgd_waves_csr(Wt, Ht, csr, lr, lam), 3)
    (Wp, Hp), p_ms = timed(lambda: ref.block_sgd_waves(
        W1[0].clone(), H1[0].clone(), *pad, lr, lam))
    n_cut = int(pad[3].sum())
    upd = max_row_updates(csr, br.m_local, br.n_local)
    what = (f"full Netflix step {s_hot} cell {q_hot} first {w_cut} waves "
            f"({variant})")
    err = max(check_close(f"W kernel vs plain, {what}", Wk[0], Wp, upd),
              check_close(f"H kernel vs plain, {what}", Hk[0], Hp, upd))
    bound_ = 16 * EPS_FP32 * max(float(upd), 1.0) ** 0.5
    ctrl = rel_err(W1[0], Wp)
    phase("control", what=f"{what} no update", max_rel_err=f"{ctrl:.3e}",
          bound=f"{bound_:.3e}", rejected=ctrl > bound_)
    if not ctrl > bound_:
        raise AssertionError("the check cannot tell a launch that did "
                             "nothing from the plain version")
    b_ms, b_by = bound(W1, H1, csr)
    del Wk, Hk, Wt, Ht, Wp, Hp

    # one epoch as solve runs it, then one with each step's launch
    # between CUDA events
    _, epoch_ms = timed(lambda: eng.train(1))
    cells, perm = eng._data
    Ws, Hs = eng.Ws, eng.Hs
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(br.n_steps)]
    steps = [cells.cells(s * p, (s + 1) * p) for s in range(br.n_steps)]
    for s, c in enumerate(steps):
        events[s][0].record()
        ks.nomad_sgd_waves_csr(Ws, Hs, c, lr, lam)
        events[s][1].record()
        Hs = Hs.index_select(0, perm[s])
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in events]
    for s, c in enumerate(steps):
        sb_ms, sb_by = bound(Ws, Hs, c)
        phase("9.step", step=s, kernel_ms=f"{step_ms[s]:.3f}",
              bound_ms=f"{sb_ms:.4f}", bound_by=sb_by, chain=chain(c),
              chain_bound_ms=f"{chain(c) * floor_ns * 1e-6:.3f}",
              h_global_chain_bound_ms=(
                  f"{chain(c) * global_floor_ns * 1e-6:.3f}"),
              ratings=cell_ratings(c)[1].numel(), variant=variant)
    _, factors_ms = timed(eng.factors)
    epoch_chain = sum(chain(c) for c in steps)
    phase("9.split", engine_ms=f"{engine_ms:.1f}",
          init_factors_ms=f"{init_ms:.1f}", epoch_ms=f"{epoch_ms:.1f}",
          factors_ms=f"{factors_ms:.1f}",
          epoch_kernel_ms=f"{sum(step_ms):.2f}", epoch_chain=epoch_chain,
          epoch_chain_bound_ms=f"{epoch_chain * floor_ns * 1e-6:.2f}",
          updates_per_s=f"{problem.nnz / epoch_ms * 1e3:.4g}",
          solve_s_per_epoch=f"{solve_s / NETFLIX_EPOCHS:.3f}",
          floor_ns_per_wave=f"{floor_ns:.1f}",
          h_global_floor_ns_per_wave=f"{global_floor_ns:.1f}",
          variant=variant)
    card_peak = max(card_peak, torch.cuda.max_memory_allocated())
    peak.close()
    phase("9.done", seconds=f"{time.perf_counter() - t_phase:.1f}",
          host_peak_rss_gb=peak.gb(), rss_sampled_every_s=0.02,
          card_peak_bytes=card_peak, padded_built=br.__dict__.get(
              "_padded_waves") is not None)
    record = dict(
        name="nomad_sgd_waves_csr[grid,full_netflix]", route="cuda",
        source=KERNEL_SRC, replaces=REPLACES["grid"], launches=launched,
        launches_on="[9.solve]", max_abs_err=err, ms=k_ms, plain_ms=p_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, variant=variant,
        work=f"step {s_hot} cell {q_hot}, first {w_cut} waves, {n_cut} "
        "ratings", step_ms_max=max(step_ms),
        step_chain_bound_ms=max(chain(c) for c in steps) * floor_ns * 1e-6)
    ran = dict(br=br, config=config, rmse=rm, epoch_ms=epoch_ms)
    return record, problem, digest, global_floor_ns, ran


#: [10.dsgd]'s kernel check: the hottest sub-epoch's largest cell's
#: first ratings, each its own wave (the plain version takes ~0.2 ms a
#: rating on the card)
DSGD_CHECK_RATINGS = 50_000
#: [10.*]: CCD++'s epochs (each one solve, warm from the last) and inner
#: sweeps, ALS's epochs, Hogwild's epochs and minibatch (CCD++'s and
#: ALS's second epochs, repeats of the first, were cut to keep the smoke
#: near half its time limit once phase 11 came)
CCD_EPOCHS, CCD_INNER, ALS_EPOCHS, HOG_EPOCHS, HOG_BATCH = 1, 3, 1, 1, 256


def objective_chunked(W, H, rows, cols, vals, lam) -> float:
    """eq. (1) over the ratings, 2**20 at a time on the card (fp32 terms,
    summed in fp64)."""
    tot = 0.0
    for lo in range(0, vals.numel(), 1 << 20):
        hi = lo + (1 << 20)
        wi, hj = W[rows[lo:hi]], H[cols[lo:hi]]
        err = vals[lo:hi] - torch.sum(wi * hj, dim=-1)
        reg = torch.sum(wi * wi, dim=-1) + torch.sum(hj * hj, dim=-1)
        tot += float(torch.sum(err * err + lam * reg, dtype=torch.float64))
    return 0.5 * tot


def dsgd_phase(api, ks, dev, problem, want_digest, floor_ns,
               global_floor_ns):
    """[10.pack], [10.dsgd], [10.step], [10.split]: DSGD at the paper's
    full Netflix on phase 9's problem, through ``api.solve`` with phase
    9's settings.  Fails unless its factors' digest is ``[9.solve]``'s,
    it launched the kernel 8 times an epoch and never its plain version,
    and its trace strictly descends.  Then each sub-epoch's launch by
    CUDA events beside its bounds, and the kernel against its plain
    version on a window of the hottest sub-epoch's largest cell, with a
    no-update control.  Returns the kernel record."""
    from repro_torch.configs.nomad_mf import NETFLIX
    from repro_torch.convert import factors_from_reference
    from repro_torch.core.nomad import wave_csr
    from repro_torch.core.stepsize import PowerSchedule
    from repro_torch.testing import HostPeak

    peak = HostPeak()
    torch.cuda.reset_peak_memory_stats()
    k, p = NETFLIX.k, 8
    config = api.DsgdConfig(
        k=k, p=p, lam=NETFLIX.lam,
        stepsize=PowerSchedule(NETFLIX.alpha, NETFLIX.beta),
        epochs=NETFLIX_EPOCHS)
    t0 = time.perf_counter()
    br = problem.packed(p, balanced=True, waves=False)
    pack_s = time.perf_counter() - t0
    s_hot = int(br.nnz_cell.max(0).argmax())
    q_hot = int(br.nnz_cell[:, s_hot].argmax())
    phase("10.pack", pack_s=f"{pack_s:.2f}", p=p, n_steps=br.n_steps,
          m_local=br.m_local, n_local=br.n_local, max_nnz=br.max_nnz,
          waves=br.wave_cnt is not None, hot_step=s_hot, hot_cell=q_hot,
          host_peak_rss_gb=peak.gb())

    calls, restore = count_plain(ks)
    ks.reset_launches()
    try:
        t0 = time.perf_counter()
        res = api.solve(problem, config, device=dev)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
    finally:
        restore()
    counts = {w.__name__: w.launches for w in ks.WRAPPERS}
    launched = ks.nomad_sgd_waves_csr.launches
    want = NETFLIX_EPOCHS * p
    card_peak = torch.cuda.max_memory_allocated()
    rm = [float(x) for x in res.rmse]
    digest = factor_digest(res.W, res.H)
    phase("10.dsgd", epochs=NETFLIX_EPOCHS, wall_s=f"{solve_s:.2f}",
          s_per_epoch=f"{solve_s / NETFLIX_EPOCHS:.3f}", rmse=json.dumps(rm),
          digest=digest, want_digest=want_digest,
          equal=digest == want_digest, launches=json.dumps(counts),
          want=want, plain_calls=calls[0], card_peak_bytes=card_peak,
          host_peak_rss_gb=peak.gb())
    if digest != want_digest:
        raise AssertionError(f"DSGD digest {digest} != [9.solve]'s "
                             f"{want_digest}")
    if launched != want or sum(counts.values()) != want or calls[0]:
        raise AssertionError(f"launches {counts}, plain calls {calls[0]}, "
                             f"want {want} launches")
    if not (len(rm) == NETFLIX_EPOCHS and all(
            b < a for a, b in zip([float("inf")] + rm, rm))):
        raise AssertionError(f"RMSE trace {rm} not strictly descending")

    # one more epoch as solve runs it, each sub-epoch between CUDA events
    Ws, Hs = factors_from_reference(res.W, res.H, br, device=dev)
    del res
    cells = wave_csr(br, sequential=True).to(dev)
    steps = [cells.cells(s * p, (s + 1) * p) for s in range(p)]
    lr = float(np.float32(config.make_stepsize()(NETFLIX_EPOCHS)))
    lam = config.lam
    W1 = Ws[q_hot:q_hot + 1].clone()
    H1 = Hs[br.block_at(q_hot, s_hot)].clone()[None]
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in steps]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for (a, b), c in zip(events, steps):
        a.record()
        ks.nomad_sgd_waves_csr(Ws, Hs, c, lr, lam)
        b.record()
        Hs = torch.roll(Hs, 1, 0)
    torch.cuda.synchronize()
    epoch_ms = (time.perf_counter() - t0) * 1e3
    step_ms = [a.elapsed_time(b) for a, b in events]
    for s, c in enumerate(steps):
        sb_ms, sb_by = bound(Ws, Hs, c)
        phase("10.step", step=s, kernel_ms=f"{step_ms[s]:.3f}",
              bound_ms=f"{sb_ms:.4f}", bound_by=sb_by, chain=chain(c),
              chain_bound_ms=f"{chain(c) * floor_ns * 1e-6:.3f}",
              h_global_chain_bound_ms=(
                  f"{chain(c) * global_floor_ns * 1e-6:.3f}"),
              ratings=cell_ratings(c)[1].numel(),
              variant=ks.launch_plan(Ws, Hs).describe())
    epoch_chain = sum(chain(c) for c in steps)
    phase("10.split", epoch_ms=f"{epoch_ms:.1f}",
          epoch_kernel_ms=f"{sum(step_ms):.2f}", epoch_chain=epoch_chain,
          epoch_chain_bound_ms=f"{epoch_chain * floor_ns * 1e-6:.2f}",
          h_global_epoch_chain_bound_ms=(
              f"{epoch_chain * global_floor_ns * 1e-6:.2f}"),
          updates_per_s=f"{problem.nnz / epoch_ms * 1e3:.4g}",
          ns_per_update=f"{sum(step_ms) * 1e6 / epoch_chain:.1f}")
    del Ws, Hs

    # the kernel against its plain version: the first ratings of the
    # hottest sub-epoch's largest cell, each its own wave
    hot = steps[s_hot].cells(q_hot, q_hot + 1)
    lo = int(hot.woff[hot.cell_woff[0]])
    n_cut = min(DSGD_CHECK_RATINGS, int(br.nnz_cell[q_hot, s_hot]))
    csr = ks.WaveCSR(
        rows=hot.rows[lo:lo + n_cut].contiguous(),
        cols=hot.cols[lo:lo + n_cut].contiguous(),
        vals=hot.vals[lo:lo + n_cut].contiguous(),
        woff=torch.arange(n_cut + 1, dtype=torch.int32, device=dev),
        cell_woff=torch.tensor([0, n_cut], dtype=torch.int32, device=dev))
    Wk, Hk = ks.nomad_sgd_waves_csr(W1.clone(), H1.clone(), csr, lr, lam)
    Wt, Ht = W1.clone(), H1.clone()
    k_ms = cuda_ms(lambda: ks.nomad_sgd_waves_csr(Wt, Ht, csr, lr, lam), 3)
    (Wp, Hp), p_ms = timed(lambda: ks.block_sgd_waves_csr(
        W1.clone(), H1.clone(), csr, lr, lam))
    upd = max_row_updates(csr, br.m_local, br.n_local)
    what = (f"DSGD full Netflix sub-epoch {s_hot} cell {q_hot} first "
            f"{n_cut} ratings (sequential)")
    err = max(check_close(f"W kernel vs plain, {what}", Wk, Wp, upd),
              check_close(f"H kernel vs plain, {what}", Hk, Hp, upd))
    bound_ = 16 * EPS_FP32 * max(float(upd), 1.0) ** 0.5
    ctrl = rel_err(W1, Wp)
    phase("control", what=f"{what} no update", max_rel_err=f"{ctrl:.3e}",
          bound=f"{bound_:.3e}", rejected=ctrl > bound_)
    if not ctrl > bound_:
        raise AssertionError("the check cannot tell a launch that did "
                             "nothing from the plain version")
    b_ms, b_by = bound(W1, H1, csr)
    peak.close()
    problem._pack_cache.clear()
    return dict(
        name="nomad_sgd_waves_csr[sequential,dsgd,full_netflix]",
        route="cuda", source=KERNEL_SRC, replaces=REPLACES["sequential"],
        launches=launched, launches_on="[10.dsgd]", max_abs_err=err,
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, variant=ks.launch_plan(W1, H1).describe(),
        work=f"sub-epoch {s_hot} cell {q_hot}, first {n_cut} ratings",
        step_ms_max=max(step_ms),
        step_chain_bound_ms=max(chain(c) for c in steps) * floor_ns * 1e-6)


def baselines_phase(api, dev, problem, small):
    """[10.ccdpp], [10.als], [10.hogwild] at the paper's full Netflix on
    phase 9's problem (cold starts from seed 0, one solve per epoch, each
    warm from the last, so eq. (1) is read after each), and
    [10.als.resume] on phase 2's problem: seconds per epoch, card and
    host peaks, the RMSE trace against the initial factors', all-finite
    factors.  Fails unless every epoch's RMSE is below the initial one,
    CCD++ and ALS (exact coordinate minimizers of eq. (1)) lower it every
    epoch (1.001 slack, as the JAX package's test), and 1 + 1 ALS epochs
    through ``warm_start`` equal 2 bitwise."""
    from repro_torch.configs.nomad_mf import NETFLIX
    from repro_torch.core.nomad import _sharded_rmse_body
    from repro_torch.core.objective import init_factors
    from repro_torch.core.stepsize import PowerSchedule
    from repro_torch.testing import HostPeak

    k, lam = NETFLIX.k, NETFLIX.lam
    W0, H0 = (x.to(dev) for x in init_factors(
        torch.Generator().manual_seed(0), problem.m, problem.n, k))
    tr, tc = (torch.tensor(a, device=dev) for a in problem.test[:2])
    tv = torch.tensor(problem.test[2], dtype=torch.float32, device=dev)
    rmse0 = float(_sharded_rmse_body(W0, H0, tr, tc, tv))
    rows, cols = (torch.tensor(a, device=dev)
                  for a in (problem.rows, problem.cols))
    vals = torch.tensor(problem.vals, dtype=torch.float32, device=dev)
    obj = [objective_chunked(W0, H0, rows, cols, vals, lam)]
    del W0, H0

    def run(tag, cfg, epochs):
        """``epochs`` solves of one epoch each, warm from the last, with
        their seconds, peaks, RMSE and objective."""
        peak = HostPeak()
        torch.cuda.reset_peak_memory_stats()
        res, secs, rm, objs = None, [], [], []
        for _ in range(epochs):
            t0 = time.perf_counter()
            res = api.solve(problem, cfg, warm_start=res, device=dev)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            rm.append(float(res.rmse[-1]))
            if tag in ("ccdpp", "als"):
                objs.append(objective_chunked(
                    torch.from_numpy(res.W).to(dev),
                    torch.from_numpy(res.H).to(dev), rows, cols, vals, lam))
        finite = bool(np.isfinite(res.W).all() and np.isfinite(res.H).all())
        peak.close()
        phase(f"10.{tag}", epochs=epochs,
              s_per_epoch=json.dumps([round(x, 3) for x in secs]),
              rmse_initial=rmse0, rmse=json.dumps(rm),
              **({"objective_initial": f"{obj[0]:.6e}",
                  "objective": json.dumps([f"{o:.6e}" for o in objs])}
                 if objs else {}),
              finite=finite, card_peak_bytes=torch.cuda.max_memory_allocated(),
              host_peak_rss_gb=peak.gb(), config=repr(cfg))
        if not (finite and res.W.shape == (problem.m, k)
                and res.H.shape == (problem.n, k)):
            raise AssertionError(f"{tag}: non-finite or misshapen factors")
        if not all(r < rmse0 for r in rm):
            raise AssertionError(f"{tag}: RMSE {rm} not below the "
                                 f"initial {rmse0}")
        if objs and not all(b <= a * 1.001
                            for a, b in zip(obj + objs, objs)):
            raise AssertionError(f"{tag}: objective {objs} rose from "
                                 f"{obj[0]}")
        return res

    run("ccdpp", api.CcdConfig(k=k, lam=lam, epochs=1, inner=CCD_INNER),
        CCD_EPOCHS)
    run("als", api.AlsConfig(k=k, lam=lam, epochs=1), ALS_EPOCHS)
    run("hogwild", api.HogwildConfig(
        k=k, lam=lam, epochs=1, batch=HOG_BATCH,
        stepsize=PowerSchedule(NETFLIX.alpha, NETFLIX.beta)), HOG_EPOCHS)
    del rows, cols, vals, tr, tc, tv
    torch.cuda.empty_cache()

    # Hogwild's CUDA graphs against its eager loop, one epoch of phase 2's
    # problem from the same factors: the racing sums (float atomics) may
    # differ in the last bits, so within the tolerance tier, and a
    # no-update control
    from repro_torch.core import baselines
    t0 = time.perf_counter()
    args = (small.rows, small.cols, small.vals, small.m, small.n, k)
    W0, H0 = (x.numpy() for x in init_factors(
        torch.Generator().manual_seed(0), small.m, small.n, k))
    kw = dict(lam=0.01, epochs=1, batch=HOG_BATCH, W0=W0, H0=H0,
              schedule=PowerSchedule(0.096, 0.05), device=dev)
    Wg, Hg, _ = baselines.hogwild(*args, **kw)
    graph_s = time.perf_counter() - t0
    per_graph, baselines.HOG_GRAPH = baselines.HOG_GRAPH, 1 << 62
    try:
        t0 = time.perf_counter()
        We, He, _ = baselines.hogwild(*args, **kw)
        eager_s = time.perf_counter() - t0
    finally:
        baselines.HOG_GRAPH = per_graph
    upd = max(np.bincount(small.rows).max(), np.bincount(small.cols).max())
    what = "Hogwild CUDA graphs vs eager, phase 2's problem, 1 epoch"
    for x, got, want in (("W", Wg, We), ("H", Hg, He)):
        check_close(f"{x} {what}", torch.from_numpy(got),
                    torch.from_numpy(want), upd)
    bound_ = 16 * EPS_FP32 * float(upd) ** 0.5
    ctrl = rel_err(torch.from_numpy(W0), torch.from_numpy(We))
    phase("control", what=f"{what}: no update", max_rel_err=f"{ctrl:.3e}",
          bound=f"{bound_:.3e}", rejected=ctrl > bound_)
    if not ctrl > bound_:
        raise AssertionError("the check cannot tell no update from eager")
    phase("10.hogwild.graph", graph_s=f"{graph_s:.2f}",
          eager_s=f"{eager_s:.2f}", minibatches=small.nnz // HOG_BATCH,
          per_graph=per_graph)

    # ALS resumes bitwise on the card: 1 + 1 epochs == 2
    cfg = api.AlsConfig(k=k, lam=0.01, epochs=1)
    t0 = time.perf_counter()
    whole = api.solve(small, dataclasses.replace(cfg, epochs=2), device=dev)
    half = api.solve(small, cfg, device=dev)
    rest = api.solve(small, cfg, warm_start=half, device=dev)
    equal = (np.array_equal(whole.W, rest.W)
             and np.array_equal(whole.H, rest.H))
    phase("10.als.resume", m=small.m, n=small.n, nnz=small.nnz, k=k,
          digest_2=factor_digest(whole.W, whole.H),
          digest_1_1=factor_digest(rest.W, rest.H), equal=equal,
          rmse=json.dumps([float(x) for x in whole.rmse]),
          seconds=f"{time.perf_counter() - t0:.1f}")
    if not equal:
        raise AssertionError("ALS 1 + 1 epochs != 2 epochs on the card")


def log_order(update_log, stepsize):
    """The simulator's ``update_log`` in execution order (start time, then
    log position), with each update's step size (its rating's count of
    earlier updates)."""
    idx = sorted(range(len(update_log)), key=lambda t: (update_log[t][0], t))
    order = np.array([update_log[t][1] for t in idx], dtype=np.int64)
    seen, lrs = {}, np.empty(len(order))
    for t, g in enumerate(order.tolist()):
        c = seen.get(g, 0)
        lrs[t] = stepsize(c)
        seen[g] = c + 1
    return order, lrs


def sim_phase(api, ks, dev) -> int:
    """[9.sim]: ``solve(AsyncSimConfig(p=8, emit_schedule=True))`` on a
    small problem on the host, its ``update_log`` replayed with
    ``serial.replay_np`` (bitwise its factors), then its schedule through
    ``solve(NomadConfig(schedule=..., kernel="wave_pallas"))`` on the card
    (``n_steps`` launches per epoch, 0 plain calls), held against
    ``serial.replay_torch`` of ``schedule_order()`` on the card within
    the reference tests' tolerance; a replay of a shuffled order is a
    control it must reject.  Returns the wave kernel's launches."""
    from repro_torch.core import serial
    from repro_torch.core.objective import init_factors_np
    from repro_torch.core.stepsize import PowerSchedule

    t_phase = time.perf_counter()
    small = api.MCProblem.synthetic(SIM_M, SIM_N, SIM_NNZ, k=SIM_K, seed=9,
                                    noise=0.1)
    lam, stepsize = 0.05, PowerSchedule(0.05, 0.1)
    t0 = time.perf_counter()
    sim = api.solve(small, api.AsyncSimConfig(
        k=SIM_K, p=SIM_P, lam=lam, stepsize=stepsize,
        epochs=float(SIM_EPOCHS), seed=9, emit_schedule=True), device=dev)
    sim_s = time.perf_counter() - t0
    W0, H0 = init_factors_np(9, small.m, small.n, SIM_K)
    order, lrs = log_order(sim.extras["update_log"], stepsize)
    Wr, Hr = serial.replay_np(W0, H0, small.rows, small.cols, small.vals,
                              order, lrs, lam)
    replay_equal = bool(np.array_equal(Wr, sim.W)
                        and np.array_equal(Hr, sim.H))
    sched = sim.extras["schedule"]
    phase("9.sim", m=small.m, n=small.n, nnz=small.nnz, p=SIM_P,
          sim_s=f"{sim_s:.2f}", updates=sim.extras["n_updates"],
          virtual_time=f"{sim.virtual_time:.6g}",
          throughput=f"{sim.extras['throughput']:.6g}",
          rmse=f"{float(sim.rmse[-1]):.6f}", n_steps=sched.n_steps,
          update_log_replay_bitwise=replay_equal)
    if not replay_equal:
        raise AssertionError("the simulator's update_log does not replay "
                             "to its factors")

    # its schedule through the engine on the card, from seeded factors
    rng = np.random.default_rng(9)
    Wi = rng.uniform(0, SIM_K ** -0.5, (small.m, SIM_K)).astype(np.float32)
    Hi = rng.uniform(0, SIM_K ** -0.5, (small.n, SIM_K)).astype(np.float32)
    warm = api.FitResult(W=Wi, H=Hi, trace_epochs=np.zeros(0),
                         trace_rmse=np.zeros(0), epochs_done=0)
    cfg = api.NomadConfig(k=SIM_K, p=SIM_P, lam=lam, stepsize=stepsize,
                          epochs=SIM_EPOCHS, schedule=sched,
                          kernel="wave_pallas")
    calls, restore = count_plain(ks)
    ks.reset_launches()
    try:
        res = api.solve(small, cfg, warm_start=warm, device=dev)
        torch.cuda.synchronize()
    finally:
        restore()
    counts = {w.__name__: w.launches for w in ks.WRAPPERS}
    want = SIM_EPOCHS * sched.n_steps
    if (ks.nomad_sgd_waves_csr.launches != want
            or sum(counts.values()) != want or calls[0]):
        raise AssertionError(f"launches {counts}, plain calls {calls[0]}, "
                             f"want {want}")
    order = small.packed(SIM_P, waves=True, schedule=sched).schedule_order()

    def replay(o):
        W, H = torch.from_numpy(Wi), torch.from_numpy(Hi)
        for e in range(SIM_EPOCHS):
            W, H = serial.replay_torch(W, H, small.rows, small.cols,
                                       small.vals, o, stepsize(e), lam,
                                       device=dev)
        return W, H

    def within(got, want_):
        return (bool(torch.allclose(got, want_, rtol=REPLAY_RTOL,
                                    atol=REPLAY_ATOL)),
                float((got - want_).abs().max()))

    t0 = time.perf_counter()
    Wr, Hr = replay(order)
    replay_s = time.perf_counter() - t0
    Wg = torch.from_numpy(res.W).to(dev)
    Hg = torch.from_numpy(res.H).to(dev)
    (okW, eW), (okH, eH) = within(Wg, Wr), within(Hg, Hr)
    phase("check", what="[9.sim] engine on the card vs replay_torch of "
          "schedule_order()", within=okW and okH,
          max_abs_err=f"{max(eW, eH):.3e}", rtol=REPLAY_RTOL,
          atol=REPLAY_ATOL, replay_s=f"{replay_s:.2f}")
    if not (okW and okH):
        raise AssertionError("the simulator's schedule on the card is not "
                             "its serial order")
    Wc, Hc = replay(np.random.default_rng(9).permutation(order))
    (cW, eW), (cH, eH) = within(Wg, Wc), within(Hg, Hc)
    phase("control", what="[9.sim] replay of a shuffled order",
          max_abs_err=f"{max(eW, eH):.3e}", rejected=not (cW and cH))
    if cW and cH:
        raise AssertionError("the replay check cannot tell a shuffled "
                             "order from the schedule's")
    phase("9.sim", schedule="on the card", epochs=SIM_EPOCHS,
          launches=json.dumps(counts), want=want, plain_calls=calls[0],
          rmse=json.dumps([float(x) for x in res.rmse]),
          seconds=f"{time.perf_counter() - t_phase:.1f}")
    return want


#: [11.*]: ranks of the SPMD executor (all on the one card), the seconds
#: they may take, [11.api]'s problem (Netflix x SPMD_API_SCALE, built as
#: phases 2-8 build theirs; below the pack's fork threshold, so ranks
#: pack it without forking) and its epochs (the sub_blocks=2 run's too),
#: and the bound of [11.netflix]'s RMSE trace against [9.solve]'s where
#: it is not bitwise
SPMD_P, SPMD_TIMEOUT = 8, 900
SPMD_API_SCALE, SPMD_API_EPOCHS = 0.02, 1
SPMD_TRACE_RTOL = 1e-6


def spmd_phase(api, ks, dev, problem, ran, want_digest, floor_ns, stream):
    """[11.netflix], [11.api]: NOMAD's SPMD executor in ``SPMD_P`` ranks
    started by ``launch.mesh.spawn_ranks`` (spawned, one process group, the
    transport ``make_mc_mesh`` picks: staged gloo when the ranks share the
    card).  Phase 9's packing, cold start and held-out ratings are written
    once under ``build/`` and mapped read-only by the ranks.
    ``[11.netflix]``: ``NomadRingEngine(mesh=)`` with phase 9's settings for
    its epochs (fused), each rank's steps logged; the factors' digest must
    be ``[9.solve]``'s, each rank must launch the wave kernel once per step
    and call no plain version, and the RMSE trace must be ``[9.solve]``'s
    (bitwise, or within ``SPMD_TRACE_RTOL``).  ``[11.api]``:
    ``api.solve(mesh=)`` on Netflix x ``SPMD_API_SCALE`` for the ring,
    random and balanced schedules (digests equal to this process's
    one-device ``solve``), the ring under both dispatches, and
    ``sub_blocks=2`` (the sequential route, sub-block by sub-block) held
    to the one-device ``solve`` of the same config.
    Returns the ranks' launches of the per-cell and the sequential route.
    Chain bounds are waves x ``floor_ns`` (``[4.floor]``): a step's longest
    cell, and its cells one after another (what 8 processes time-slicing one
    card can at best do).  Phase 12's runs (:func:`mesh_stream_runs`, on
    ``stream``) follow in the same spawn, reported by
    :func:`mesh_stream_report`."""
    import shutil

    from repro_torch.configs.nomad_mf import NETFLIX
    from repro_torch.core import partition as part
    from repro_torch.core.objective import init_factors
    from repro_torch.core.stepsize import PowerSchedule
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.testing import HostPeak, run_on_mesh

    t_phase = time.perf_counter()
    peak = HostPeak()
    br, config = ran["br"], ran["config"]
    k, p = config.k, SPMD_P

    # phase 9's pack, cold start and held-out ratings, written once
    out = ROOT / "build" / "spmd_netflix"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    part.save_pack(br, str(out / "pack"))
    W0, H0 = init_factors(torch.Generator().manual_seed(int(config.seed)),
                          problem.m, problem.n, k)
    np.save(out / "W0.npy", W0.numpy())
    np.save(out / "H0.npy", H0.numpy())
    del W0, H0
    for name, a in zip(("rows", "cols", "vals"), problem.test):
        np.save(out / f"test_{name}.npy", a)
    write_s = time.perf_counter() - t0
    written = sum(f.stat().st_size for f in out.rglob("*") if f.is_file())
    netflix = dict(kind="engine", br=str(out / "pack"), k=k, lam=config.lam,
                   stepsize=config.make_stepsize(), policy=config.kernel,
                   W0=str(out / "W0.npy"), H0=str(out / "H0.npy"),
                   test=str(out / "test"), epochs=NETFLIX_EPOCHS,
                   dispatch=config.dispatch,
                   record_every=config.record_every, log_steps=True,
                   return_factors=False)

    # [11.api]'s problem, and its one-device solves on the card
    m_a = int(NETFLIX.m * SPMD_API_SCALE)
    n_a = int(NETFLIX.n * SPMD_API_SCALE)
    small = api.MCProblem.synthetic(m_a, n_a, 37 * m_a, k=k, seed=0,
                                    noise=0.1, test_frac=0.05, split_seed=1)
    base = api.NomadConfig(k=k, p=p, lam=NETFLIX.lam,
                           stepsize=PowerSchedule(NETFLIX.alpha,
                                                  NETFLIX.beta),
                           kernel="wave_pallas", epochs=SPMD_API_EPOCHS)
    cases = {s: dataclasses.replace(base, schedule=s)
             for s in ("ring", "random", "balanced")}
    cases["ring, loop"] = dataclasses.replace(base, dispatch="loop")
    sub = dataclasses.replace(base, kernel="pallas", sub_blocks=2)
    local = {}
    t0 = time.perf_counter()
    for name, cfg in (("ring", cases["ring"]), ("random", cases["random"]),
                      ("balanced", cases["balanced"]), ("sub", sub)):
        res = api.solve(small, cfg, device=dev)
        local[name] = (factor_digest(res.W, res.H),
                       [float(x) for x in res.rmse])
    local_s = time.perf_counter() - t0
    fresh = api.MCProblem(small.rows, small.cols, small.vals, small.m,
                          small.n, test=small.test)     # no packs pickled
    runs = [netflix]
    runs += [dict(kind="solve", problem=fresh, config=c)
             for c in cases.values()]
    runs += [dict(kind="solve", problem=fresh, config=sub)]
    first12 = len(runs)
    t12 = time.perf_counter()
    runs12, chaos_local = mesh_stream_runs(api, stream, dev)
    runs += runs12
    t12 = time.perf_counter() - t12
    phase("11.write", seconds=f"{write_s:.2f}", bytes=written,
          api_m=small.m, api_n=small.n, api_train=small.nnz,
          api_local_solves_s=f"{local_s:.2f}", host_peak_rss_gb=peak.gb())

    torch.cuda.empty_cache()
    t_spawn = time.time()
    t0 = time.perf_counter()
    outs = spawn_ranks(run_on_mesh, p, runs, None, timeout=SPMD_TIMEOUT)
    spawn_s = time.perf_counter() - t0

    # -- [11.netflix] ---------------------------------------------------
    steps_per_epoch = br.n_steps
    want = NETFLIX_EPOCHS * steps_per_epoch
    waves = [o["launches0"]["nomad_sgd_waves_csr"] for o in outs]
    totals = [sum(o["launches0"].values()) for o in outs]
    plain = [o["plain0"] for o in outs]
    digests = sorted({o["digest0"] for o in outs})
    rm = [[x for _, x in o["trace0"]] for o in outs]
    trace_bitwise = all(r == ran["rmse"] for r in rm)
    trace_rel = max(abs(a - b) / abs(b) for r in rm
                    for a, b in zip(r, ran["rmse"]))
    train_s = [o["train_s0"] for o in outs]
    phase("11.netflix", transport=repr(outs[0]["transport"]), ranks=p,
          epochs=NETFLIX_EPOCHS, digest=",".join(digests),
          want_digest=want_digest, equal=digests == [want_digest],
          launches=json.dumps(waves), all_wrappers=json.dumps(totals),
          want=want, plain_calls=json.dumps(plain),
          rmse=json.dumps(rm[0]), want_rmse=json.dumps(ran["rmse"]),
          trace_bitwise=trace_bitwise, trace_max_rel=f"{trace_rel:.3e}",
          finite=all(o["finite0"] for o in outs),
          spawn_to_ready_s=(
              f"{max(o['ready_at'] for o in outs) - t_spawn:.2f}"),
          load_s=f"{max(o['load_s0'] for o in outs):.2f}",
          train_s=f"{max(train_s):.2f}",
          factors_s=f"{max(o['factors_s0'] for o in outs):.2f}")
    if digests != [want_digest]:
        raise AssertionError(f"[11.netflix] digests {digests} != "
                             f"[9.solve]'s {want_digest}")
    if waves != [want] * p or totals != [want] * p or any(plain):
        raise AssertionError(f"[11.netflix] launches {waves}/{totals}, plain "
                             f"calls {plain}, want {want} each")
    if not (trace_bitwise or trace_rel <= SPMD_TRACE_RTOL) or not all(
            o["finite0"] for o in outs):
        raise AssertionError(f"[11.netflix] trace {rm} vs [9.solve]'s "
                             f"{ran['rmse']}, or non-finite factors")
    hop_bytes = br.n_local * k * 4
    last = [o["steps0"][-steps_per_epoch:] for o in outs]
    cell_waves = (br.wave_cnt > 0).sum(-1)                # (p, n_steps)
    for s in range(steps_per_epoch):
        rec = [r[s] for r in last]
        phase("11.step", step=s, epoch=NETFLIX_EPOCHS - 1,
              kernel_ms=json.dumps([round(x["kernel_ms"], 3) for x in rec]),
              stage_ms=json.dumps([round(x["stage_ms"], 3) for x in rec]),
              wire_ms=json.dumps([round(x["wire_ms"], 3) for x in rec]),
              wall_ms=f"{max(x['wall_ms'] for x in rec):.3f}",
              hop_bytes=hop_bytes,
              cells_waves=json.dumps(cell_waves[:, s].tolist()),
              chain_bound_ms=(
                  f"{cell_waves[:, s].max() * floor_ns * 1e-6:.1f}"),
              serial_chain_bound_ms=(
                  f"{cell_waves[:, s].sum() * floor_ns * 1e-6:.1f}"))
    epoch_ms = [sum(x["wall_ms"] for x in r) for r in last]
    kernel_ms = [sum(x["kernel_ms"] for x in r) for r in last]
    phase("11.split", epoch_ms=f"{max(epoch_ms):.1f}",
          s_per_epoch=f"{max(train_s) / NETFLIX_EPOCHS:.3f}",
          one_device_epoch_ms=f"{ran['epoch_ms']:.1f}",
          epoch_chain_bound_ms=(
              f"{cell_waves.max(0).sum() * floor_ns * 1e-6:.1f}"),
          epoch_serial_chain_bound_ms=(
              f"{cell_waves.sum() * floor_ns * 1e-6:.1f}"),
          kernel_ms_per_rank=json.dumps([round(x, 1) for x in kernel_ms]),
          kernel_ms_sum=f"{sum(kernel_ms):.1f}",
          stage_ms_per_rank=json.dumps([round(sum(
              x["stage_ms"] for x in r), 2) for r in last]),
          wire_ms_per_rank=json.dumps([round(sum(
              x["wire_ms"] for x in r), 2) for r in last]),
          card_peak_bytes_per_rank=json.dumps(
              [o["card_peak_bytes"] for o in outs]),
          card_peak_bytes_sum=sum(o["card_peak_bytes"] for o in outs),
          rank_host_peak_rss_gb=json.dumps(
              [round(o["host_peak_rss_gb"], 2) for o in outs]),
          parent_host_peak_rss_gb=peak.gb())

    # -- [11.api] -------------------------------------------------------
    launched = {"per_cell": sum(waves), "sequential": 0}
    for i, name in enumerate(cases, start=1):
        sched = small.packed(p, waves=True, schedule=cases[name].schedule,
                             schedule_seed=base.schedule_seed).schedule
        want_l = [SPMD_API_EPOCHS * int(sched.active[:, q].sum())
                  for q in range(p)]
        got_l = [o[f"launches{i}"]["nomad_sgd_waves_csr"] for o in outs]
        ds = sorted({o[f"digest{i}"] for o in outs})
        want_d, want_rm = local[name.split(",")[0]]
        traces = {tuple(x for _, x in o[f"trace{i}"]) for o in outs}
        phase("11.api", schedule=repr(name), digest=",".join(ds),
              want_digest=want_d, equal=ds == [want_d],
              trace_equal=traces == {tuple(want_rm)},
              launches=json.dumps(got_l), want=json.dumps(want_l),
              plain_calls=json.dumps([o[f"plain{i}"] for o in outs]),
              solve_s=f"{max(o[f'train_s{i}'] for o in outs):.2f}")
        if ds != [want_d] or traces != {tuple(want_rm)}:
            raise AssertionError(f"[11.api] {name}: digests {ds}, want "
                                 f"{want_d}; traces {traces}")
        if got_l != want_l or any(o[f"plain{i}"] for o in outs) or any(
                sum(o[f"launches{i}"].values()) != w
                for o, w in zip(outs, want_l)):
            raise AssertionError(f"[11.api] {name}: launches {got_l}, want "
                                 f"{want_l}, or plain calls")
        launched["per_cell"] += sum(got_l)
    card = len(cases) + 1
    want_l = SPMD_API_EPOCHS * p * sub.sub_blocks    # the ring: p steps
    got_l = [o[f"launches{card}"]["nomad_sgd_waves_csr"] for o in outs]
    ds = sorted({o[f"digest{card}"] for o in outs})
    traces = {tuple(x for _, x in o[f"trace{card}"]) for o in outs}
    phase("11.api", schedule="'ring'", sub_blocks=2, kernel="pallas",
          digest=",".join(ds), want_digest=local["sub"][0],
          equal=ds == [local["sub"][0]],
          trace_equal=traces == {tuple(local["sub"][1])},
          launches=json.dumps(got_l), want=want_l,
          plain_calls=json.dumps([o[f"plain{card}"] for o in outs]),
          solve_s=f"{max(o[f'train_s{card}'] for o in outs):.2f}")
    if ds != [local["sub"][0]] or traces != {tuple(local["sub"][1])}:
        raise AssertionError(f"[11.api] sub_blocks=2: digests {ds}, want "
                             f"{local['sub'][0]}; traces {traces}")
    if got_l != [want_l] * p or any(o[f"plain{card}"] for o in outs):
        raise AssertionError(f"[11.api] sub_blocks=2: launches {got_l}, "
                             f"want {want_l}, or plain calls")
    launched["sequential"] = sum(got_l)
    shutil.rmtree(out, ignore_errors=True)
    peak.close()
    phase("11.done", seconds=f"{time.perf_counter() - t_phase:.1f}",
          spawn_s=f"{spawn_s:.1f}", host_peak_rss_gb=peak.gb())
    launched["per_cell"] += mesh_stream_report(outs, first12, stream,
                                               chaos_local, t12)
    return launched


#: [12.*]: phase 8's sequence on the mesh, each op with the phase 8
#: digest it is held to (``None``: a resize, held to the factors before
#: it, which it only moves)
MESH_SCRIPT = [("arrive", 0, "arrive1"), ("arrive", 1, "arrive2"),
               ("leave", (3,), None), ("fit", None, "fit after leave"),
               ("join", 1, None), ("fit", None, "fit after join"),
               ("kill", (5,), "kill5"), ("fit", None, "fit after kill5"),
               ("bitflip", 8, None), ("kill", (0,), "kill0")]
#: [12.chaos]: the harness's problem (users, items, ratings; k and p are
#: phase 8's), its seed; its script is a leave, a join, a kill and a NaN
#: in worker 0's shard, one epoch a round
CHAOS_M, CHAOS_N, CHAOS_NNZ, CHAOS_SEED = 4000, 400, 80_000, 5


def mesh_stream_inputs(problem, config, warm, br, want) -> dict:
    """Phase 12's inputs, written once under ``build/spmd_stream`` for the
    ranks to map: phase 2's ratings and held-out ratings, phase 3's
    factors and its packing (with the ratings' ids, which the lead rank's
    re-packs read); the digests of phase 8 the ops are held to."""
    import shutil

    from repro_torch.core import partition as part

    out = ROOT / "build" / "spmd_stream"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    part.save_pack(br, str(out / "pack"), ids=True)
    files = {}
    for name, a in (("rows", problem.rows), ("cols", problem.cols),
                    ("vals", problem.vals), ("W", warm.W), ("H", warm.H),
                    *((f"test_{c}", t) for c, t in zip(
                        ("rows", "cols", "vals"), problem.test))):
        files[name] = str(out / f"{name}.npy")
        np.save(files[name], a)
    write_s = time.perf_counter() - t0
    written = sum(f.stat().st_size for f in out.rglob("*") if f.is_file())
    phase("12.write", seconds=f"{write_s:.2f}", bytes=written)
    return dict(
        dir=out, config=config, want=want, n=problem.n, m=problem.m,
        write_s=write_s,
        nnz=problem.nnz, k=config.k, epochs_done=warm.epochs_done,
        trace_epochs=warm.trace_epochs, trace_rmse=warm.trace_rmse,
        problem=dict(rows=files["rows"], cols=files["cols"],
                     vals=files["vals"], m=problem.m, n=problem.n,
                     test=tuple(files[f"test_{c}"]
                                for c in ("rows", "cols", "vals"))),
        pack=str(out / "pack"),
        warm=dict(W=files["W"], H=files["H"], trace_epochs=warm.trace_epochs,
                  trace_rmse=warm.trace_rmse, epochs_done=warm.epochs_done))


def mesh_stream_runs(api, stream, dev):
    """Phase 12's runs for the ranks (``testing.run_script`` kinds): the
    session through :data:`MESH_SCRIPT` with phase 8's arrival batches,
    ``solve(faults=)`` cut after 2 epochs, and the chaos harness on a
    small problem (:data:`CHAOS_M` ...) with phase 8's k, p and step
    sizes; and the harness's one-device run on the card in this process,
    which the ranks' must equal."""
    from repro_torch import testing
    from repro_torch.runtime.chaos import ChaosEvent

    cfg1 = dataclasses.replace(stream["config"], epochs=1)
    warm = api.FitResult(W=np.load(stream["warm"]["W"]),
                         H=np.load(stream["warm"]["H"]),
                         trace_epochs=stream["trace_epochs"],
                         trace_rmse=stream["trace_rmse"],
                         epochs_done=stream["epochs_done"])
    batches = arrival_batches(warm, stream["m"], stream["n"],
                              stream["nnz"], stream["k"])
    del warm
    ckpt = stream["dir"] / "ckpt"
    script = [(op, batches[arg] if op == "arrive" else arg)
              for op, arg, _ in MESH_SCRIPT]
    base = dict(problem=stream["problem"], pack=stream["pack"])
    events = [ChaosEvent(1, "leave", 3), ChaosEvent(2, "join"),
              ChaosEvent(3, "kill", 5), ChaosEvent(4, "nan")]

    chaos_config = dataclasses.replace(cfg1, stepsize=stream["config"]
                                       .stepsize)

    def chaos(where):
        d = stream["dir"] / f"chaos_{where}"
        d.mkdir()
        # a problem of its own for each run: no pack cache is pickled
        problem = api.MCProblem.synthetic(
            CHAOS_M, CHAOS_N, CHAOS_NNZ, k=stream["k"], seed=CHAOS_SEED,
            noise=0.1, test_frac=0.05, split_seed=1)
        return dict(kind="chaos", problem=problem, config=chaos_config,
                    events=events, seed=CHAOS_SEED,
                    faults=api.FaultPolicy(
                        checkpoint_dir=str(d), checkpoint_every=1,
                        divergence=api.DivergencePolicy(max_rollbacks=3)))

    runs = [dict(base, kind="session", config=cfg1, warm=stream["warm"],
                 script=script,
                 faults=api.FaultPolicy(checkpoint_dir=str(ckpt), keep=2)),
            dict(base, kind="faults", config=stream["config"], cut=2,
                 ckpt=str(stream["dir"] / "faults")),
            chaos("mesh")]
    t0 = time.perf_counter()
    with testing.KernelCounts() as counts:
        local = testing.run_script(chaos("card"), counts, device=dev)
    local["seconds"] = time.perf_counter() - t0
    return runs, local


def mesh_stream_report(outs, first: int, stream, chaos_local,
                       setup_s: float) -> int:
    """[12.*] from the ranks' results (runs ``first`` .. ``first + 2`` of
    the spawn): each op's digest against phase 8's, its launches against
    steps x epochs on member ranks and 0 on idle ones, 0 plain calls,
    the slowest rank's seconds for each part of the op; the crash-resume
    against phase 3's run; the harness against its one-device run.
    ``setup_s`` is this process's part before the spawn.  Returns the
    ranks' launches of the per-cell route."""
    import shutil

    p = len(outs)
    want = stream["want"]
    recs = [[o[f"script{first}"]["ops"][j] for o in outs]
            for j in range(len(MESH_SCRIPT))]
    launched = 0
    last = None
    for j, ((op, arg, key), rs) in enumerate(zip(MESH_SCRIPT, recs)):
        digests = sorted({r.get("digest") for r in rs} - {None})
        target = want[key] if key else last
        waves = [r["launches"]["nomad_sgd_waves_csr"] for r in rs]
        totals = [sum(r["launches"].values()) for r in rs]
        plain = [r["plain"] for r in rs]
        before = rs[0]["ranks_before"]
        epochs = rs[0]["rounds"]
        want_l = [epochs * len(before) if q in before else 0
                  for q in range(p)]
        timings = {}
        for r in rs:
            for name, v in r["timings"].items():
                timings[name] = max(timings.get(name, 0.0), v)
        fields = dict(op=op, arg=repr(arg) if op != "arrive" else arg + 1,
                      p=rs[0]["p"],
                      idle=json.dumps([q for q in range(p)
                                       if not rs[q]["member"]]),
                      seconds=f"{max(r['seconds'] for r in rs):.3f}",
                      **{f"{n}_s": f"{v:.3f}" for n, v in timings.items()})
        if op != "bitflip":
            fields.update(digest=",".join(digests), want_digest=target,
                          equal=digests == [target])
        else:
            fields.update(flipped_step=rs[0]["flipped"])
        if op == "kill":
            fields.update(quarantined=json.dumps(rs[0]["corrupt"]))
        fields.update(launches=json.dumps(waves), want=json.dumps(want_l),
                      plain_calls=json.dumps(plain))
        if "trace" in rs[0]:
            fields.update(rmse=f"{rs[0]['trace'][-1]:.6f}")
        phase("12.op", i=j, **fields)
        if op != "bitflip" and digests != [target]:
            raise AssertionError(f"[12.op] {j} {op}: digests {digests}, "
                                 f"want {target}")
        if waves != want_l or totals != want_l or any(plain):
            raise AssertionError(f"[12.op] {j} {op}: launches {waves} / "
                                 f"{totals}, want {want_l}, plain {plain}")
        if op == "kill" and arg == (0,) and rs[0]["corrupt"] != [
                f"step_{recs[j - 1][0]['flipped']:08d}.corrupt"]:
            raise AssertionError("[12.op] the bit-flipped checkpoint was "
                                 "not quarantined")
        if op != "bitflip":
            last = digests[0]
        launched += sum(waves)

    # -- [12.faults]: solve(faults=, mesh=) cut after 2 epochs, resumed ---
    parts = [[o[f"script{first + 1}"]["ops"][j] for o in outs]
             for j in (0, 1)]
    digests = sorted({r["digest"] for r in parts[1]})
    traces = {tuple(r["trace"]) for r in parts[1]}
    waves = [[r["launches"]["nomad_sgd_waves_csr"] for r in rs]
             for rs in parts]
    want_l = [[2 * p] * p, [(EPOCHS - 2) * p] * p]
    plain = [r["plain"] for rs in parts for r in rs]
    phase("12.faults", epochs=f"2+{EPOCHS - 2}", digest=",".join(digests),
          want_digest=want["faults"], equal=digests == [want["faults"]],
          trace_equal=traces == {tuple(float(x)
                                       for x in stream["trace_rmse"])},
          launches=json.dumps(waves), want=json.dumps(want_l),
          plain_calls=json.dumps(plain),
          part1_s=f"{max(r['seconds'] for r in parts[0]):.3f}",
          part2_s=f"{max(r['seconds'] for r in parts[1]):.3f}")
    if digests != [want["faults"]] or len(traces) != 1 or any(plain) \
            or waves != want_l:
        raise AssertionError(f"[12.faults] digests {digests}, traces "
                             f"{traces}, launches {waves}, plain {plain}")
    launched += sum(map(sum, waves))

    # -- [12.chaos]: ChaosHarness(mesh_factory=) against one device ------
    ch = [o[f"script{first + 2}"] for o in outs]
    digests = sorted({c["digest"] for c in ch})
    plain = [c["plain"] for c in ch]
    waves = [c["launches"]["nomad_sgd_waves_csr"] for c in ch]
    phase("12.chaos", actions=json.dumps(ch[0]["actions"]),
          rollbacks=ch[0]["rollbacks"], p_final=ch[0]["p_final"],
          digest=",".join(digests), one_device_digest=chaos_local["digest"],
          equal=digests == [chaos_local["digest"]],
          rmse_equal=all(c["rmse"] == chaos_local["rmse"] for c in ch),
          launches=json.dumps(waves), plain_calls=json.dumps(plain),
          one_device_s=f"{chaos_local['seconds']:.2f}")
    if digests != [chaos_local["digest"]] or any(plain) or not all(
            c["rmse"] == chaos_local["rmse"] for c in ch) \
            or not ch[0]["rollbacks"]:
        raise AssertionError(f"[12.chaos] digests {digests} against "
                             f"{chaos_local['digest']}, plain {plain}")
    launched += sum(waves)
    phase("12.ranks", card_peak_bytes=json.dumps(
              [o[f"card_peak_bytes{first}"] for o in outs]),
          host_peak_rss_gb=json.dumps(
              [round(o[f"host_peak_rss_gb{first}"], 2) for o in outs]))
    shutil.rmtree(stream["dir"], ignore_errors=True)
    ranks_s = (max(o[f"span{first + 2}"][1] for o in outs)
               - min(o[f"span{first}"][0] for o in outs))
    phase("12.done", seconds=f"{stream['write_s'] + setup_s + ranks_s:.1f}",
          write_s=f"{stream['write_s']:.2f}", setup_s=f"{setup_s:.2f}",
          ranks_s=f"{ranks_s:.1f}", wave_launches=launched)
    return launched


def main_path(args, api, ks, ref, dev):
    """Phases 2-8 at Netflix x ``args.scale``.  Returns the kernel
    records, phase 2's errors, ``[4.floor]``'s ns per wave, phase 2's
    problem (its packs released) and phase 12's inputs
    (:func:`mesh_stream_inputs`)."""
    from repro_torch.core.nomad import wave_csr
    from repro_torch.core.partition import padded_waves
    from repro_torch.core.stepsize import PowerSchedule
    from repro_torch.kernels.policy import KernelPolicy

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
    pad = [torch.from_numpy(a).to(dev)
           for a in padded_waves(br, s_hot, slice(0, cut_w))[:4]]
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
    stream, digests = stream_phase(api, ks, ref, problem, config,
                                   routes["grid"]["result"], dev)
    for rec in kernels:
        if rec["name"] == "nomad_sgd_waves_csr[grid]":
            rec["launches"] += stream["wave"]
            rec["launches_on"] = "[3.grid] and [8.*]"
        elif rec["name"].startswith("topk_scores_cuda"):
            rec["launches"] += stream["topk"]
            rec["launches_on"] = "[5.serve] and [8.swap]"
    stream_in = mesh_stream_inputs(problem, config, routes["grid"]["result"],
                                   br, digests)
    problem._pack_cache.clear()
    return kernels, errs, floor_ns, problem, stream_in


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.1,
                    help="Netflix scale of phases 2-8's problem")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs on an NVIDIA card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import api
    from repro_torch.kernels import _build, nomad_sgd as ks, ref

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

    kernels, errs, floor_ns, small, stream_in = main_path(args, api, ks, ref,
                                                          dev)
    # -- 9. full Netflix on the main path; the simulator's schedule ------
    torch.cuda.empty_cache()
    record, netflix, digest, global_floor_ns, ran = netflix_phase(
        api, ks, ref, dev, floor_ns)
    kernels.append(record)
    sim_launches = sim_phase(api, ks, dev)
    # -- 11, 12. the SPMD executor in ranks on the card: phase 9's pack;
    # phase 8's streaming, elastic and fault-tolerant sequence ----------
    torch.cuda.empty_cache()
    spmd_launches = spmd_phase(api, ks, dev, netflix, ran, digest, floor_ns,
                               stream_in)
    del ran
    netflix._pack_cache.clear()
    # -- 10. the paper's baselines at full Netflix ----------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels.append(dsgd_phase(api, ks, dev, netflix, digest, floor_ns,
                              global_floor_ns))
    torch.cuda.empty_cache()
    baselines_phase(api, dev, netflix, small)
    del netflix, small
    phase("10.done", seconds=f"{time.perf_counter() - t0:.1f}")
    for rec in kernels:
        if rec["name"] == "nomad_sgd_waves_csr[grid]":
            rec["launches"] += sim_launches
            rec["launches_on"] = "[3.grid], [8.*] and [9.sim]"
        elif rec["name"] == "nomad_sgd_waves_csr[per_cell]":
            rec["launches"] += spmd_launches["per_cell"]
            rec["launches_on"] = ("[3.per_cell], and [11.netflix], "
                                  "[11.api] and [12.*] summed over their "
                                  "ranks")
        elif rec["name"] == "nomad_sgd_waves_csr[sequential]":
            rec["launches"] += spmd_launches["sequential"]
            rec["launches_on"] = ("[3.sequential], and [11.api]'s "
                                  "sub_blocks=2 summed over its ranks")
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
