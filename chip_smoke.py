#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # Netflix x 0.1, k=100, p=8, 3 epochs

Phases, one line each (any failure raises and exits non-zero):

0. device: the card's name and power limit (nvidia-smi), torch, CUDA and
   nvcc versions;
1. build: compiles ``src/repro_torch/kernels/csrc/nomad_sgd.cu`` (nvcc,
   sm_90a) and prints the build seconds;
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
   counts zeroed before and read after; and a small problem solved on
   the card against the plain versions on the CPU;
4. timing with CUDA events on the main path's real step layout, for
   each route the launch it makes, beside its byte bound, chain length
   and the plain version's time on the same inputs; and
   ``nomad_sgd_block`` on a whole cell, bitwise equal to the sequential
   route's launch.

The line before the last is a JSON record of the kernels; the last line
is ``{"ok": true, "device": {...}}``.  Without CUDA the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
EPOCHS = 3
KERNEL_SRC = "src/repro_torch/kernels/csrc/nomad_sgd.cu"
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
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s outside
#: the tensor cores
PEAK_BW = 3.35e12
PEAK_FP32 = 67e12
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
    lib = _build.load()
    phase("1.build", seconds=f"{time.perf_counter() - t0:.2f}",
          library=_build.library_path().name,
          max_k=lib.nomad_sgd_max_k())

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
        routes[route] = dict(launches=launched, wall_s=wall)
        phase(f"3.{route}", epochs=epochs, wall_s=f"{wall:.3f}",
              rmse=json.dumps(rm), last_finite=finite,
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
    Ws, Hs = Ws0.clone(), Hs0.clone()
    step_ms = []
    for s, c in enumerate(steps):
        t = cuda_ms(lambda: ks.nomad_sgd_waves_csr(Ws, Hs, c, lr, lam), 3)
        step_ms.append(t)
        b_ms, b_by = bound(Ws, Hs, c)
        phase("4.step", step=s, kernel_ms=f"{t:.3f}", bound_ms=f"{b_ms:.4f}",
              bound_by=b_by, chain=chains[s], ratings=cell_ratings(c)[1]
              .numel())

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

    # the step with the longest chain, all p cells in one launch
    s_t = max(range(n_steps), key=chains.__getitem__)
    step = steps[s_t]
    # each of its cells alone: does a step cost its slowest cell?
    alone = [cuda_ms(lambda: ks.nomad_sgd_waves_csr(
        Ws[c:c + 1], Hs[c:c + 1], step.cells(c, c + 1), lr, lam), 1)
        for c in range(p)]
    phase("4.cells", step=s_t, alone_ms=json.dumps([round(t, 3)
                                                    for t in alone]),
          chains=json.dumps(torch.diff(step.cell_woff.long()).tolist()),
          ratings=json.dumps(torch.bincount(cell_ratings(step)[0],
                                            minlength=p).tolist()))

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
          factors_ms=f"{factors_ms:.1f}")

    # grid route: the step, one launch for its p cells
    grid_ms, grid_plain_ms, grid_err, _ = timed_pair(step, Ws0, Hs0)
    # per-cell route: that step's longest cell, one launch for the cell
    c_t = int(torch.diff(step.cell_woff.long()).argmax())
    one = step.cells(c_t, c_t + 1)
    W1, H1 = Ws0[c_t:c_t + 1], Hs0[c_t:c_t + 1]
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
          kernel_updates_per_s=f"{problem.nnz / epoch_kernel_ms * 1e3:.4g}",
          solve_s_per_epoch=f"{routes['grid']['wall_s'] / EPOCHS:.3f}")

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
            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None))
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
