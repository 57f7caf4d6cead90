"""The port's host side at the paper's full Netflix size, checked small.

``partition.pack`` stores no padded wave layout: the five padded arrays
are built from the flat wave-major lists and ``wave_cnt`` when read
(``partition.padded_waves``), whole or as a window, and must then equal
the JAX package's ``pack`` byte for byte.  The synthetic generator
computes its ratings in chunks, bitwise the reference's one-piece sum.
Inputs come from the seeded generators in ``tests/strategies.py``.
"""
import tracemalloc

import numpy as np
import pytest
import torch

import strategies
import tolerance as tol

from repro.core import partition as rpart
from repro.core.schedule import compile_transition as r_compile
from repro.data import synthetic as rsyn

from repro_torch.core import nomad as tnomad
from repro_torch.core import partition as tpart
from repro_torch.core.schedule import compile_transition as t_compile
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import nomad_sgd as tk
from repro_torch.kernels.policy import KernelPolicy

#: (seed, p, m, n, nnz) — shapes drawn from strategies.PACK_SHAPE's ranges
SHAPES = [(0, 1, 4, 4, 1), (1, 3, 20, 12, 150), (2, 4, 50, 30, 400),
          (3, 6, 37, 9, 260)]
SCHEDULES = ["ring", "random", "balanced"]


def _packs(shape, schedule):
    seed, p, m, n, nnz = shape
    rows, cols, vals = strategies.coo_problem(seed, m, n, nnz)
    kw = dict(waves=True, schedule=schedule, schedule_seed=seed)
    return (tpart.pack(rows, cols, vals, m, n, p, **kw),
            rpart.pack(rows, cols, vals, m, n, p, **kw))


def _unbuilt(br) -> bool:
    return br.__dict__.get("_padded_waves") is None


def assert_padded_equal(bt, br):
    """The port's padded layout, read whole, equals the reference's."""
    assert _unbuilt(bt)
    for name in tpart.PADDED_WAVES:
        tol.assert_bitwise(getattr(bt, name), getattr(br, name), name)
    assert not _unbuilt(bt)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_pack_leaves_padded_layout_unbuilt_until_read(shape, schedule):
    bt, br = _packs(shape, schedule)
    assert _unbuilt(bt)
    for name in ("rows", "cols", "vals", "mask", "gid", "wave_cnt"):
        tol.assert_bitwise(getattr(bt, name), getattr(br, name), name)
    assert (bt.n_waves, bt.wave_width) == (br.n_waves, br.wave_width)
    assert _unbuilt(bt)
    assert_padded_equal(bt, br)
    # read again: the same arrays, not a rebuild
    assert bt.wave_rows is bt.wave_rows


@pytest.mark.parametrize("shape", SHAPES[1:])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_padded_windows_match_reference(shape, schedule):
    """Any window — one cell, a worker's or a step's cells or a run of
    them, any run of waves — is the reference's arrays sliced, built
    without the whole layout."""
    bt, br = _packs(shape, schedule)
    nw, every = bt.n_waves, slice(None)
    windows = [(every, s, every) for s in range(bt.n_steps)]
    windows += [(every, 0, slice(1, max(2, nw // 2))),
                (every, bt.n_steps - 1, slice(nw - 1, nw + 3)),
                (every, slice(1, 3), slice(0, 2)),
                (every, every, slice(2, 2)),
                (every, slice(None, None, 2), every),
                (bt.p - 1, 0, slice(0, 3)), (0, every, every),
                (slice(1, None), 1, slice(1, None))]
    for workers, steps, waves in windows:
        got = tpart.padded_waves(bt, steps, waves, workers=workers)
        for name, a in zip(tpart.PADDED_WAVES, got):
            tol.assert_bitwise(a, getattr(br, name)[workers, steps, waves],
                               f"{name}[{workers}, {steps}, {waves}]")
        assert _unbuilt(bt)


def test_padded_layout_refusals():
    rows, cols, vals = strategies.coo_problem(4, 30, 12, 200)
    flat = tpart.pack(rows, cols, vals, 30, 12, 3, waves=False)
    for name in tpart.PADDED_WAVES:
        assert getattr(flat, name) is None
    with pytest.raises(ValueError, match="waves=True"):
        tpart.padded_waves(flat)
    bt = tpart.pack(rows, cols, vals, 30, 12, 3)
    with pytest.raises(TypeError, match="slice"):
        tpart.padded_waves(bt, 0, 3)
    with pytest.raises(AttributeError, match="cannot be set"):
        bt.wave_rows = np.zeros(3)
    assert _unbuilt(bt)


def test_pack_does_not_allocate_padded_layout():
    """At a shape where the padded arrays dominate — one hot item rated
    by every user makes thousands of waves, most of them one rating wide,
    beside a few wide ones — ``pack``'s traced peak stays a fraction of
    what the five padded arrays need."""
    rng = np.random.default_rng(11)
    m, n, p = 4000, 64, 2
    hot_r = np.arange(m)
    wide_r = rng.integers(0, m, 2000)
    rows = np.concatenate([hot_r, wide_r])
    cols = np.concatenate([np.zeros(m, dtype=np.int64),
                           rng.integers(1, n, 2000)])
    vals = rng.normal(size=len(rows))
    tracemalloc.start()
    try:
        bt = tpart.pack(rows, cols, vals, m, n, p)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    slots = p * bt.n_steps * bt.n_waves * bt.wave_width
    padded = slots * (4 + 4 + 4 + 1 + 8)
    assert _unbuilt(bt)
    assert padded > 20 * bt.rows.nbytes
    assert peak < padded / 4, (peak, padded)
    # and what it would have stored is the reference's
    assert_padded_equal(bt, rpart.pack(rows, cols, vals, m, n, p))


@pytest.mark.parametrize("seed,p,batches", [(0, 2, 2), (3, 3, 1),
                                            (5, 4, 2)])
def test_padded_layout_after_repack_delta(seed, p, batches):
    (rows, cols, vals), script = strategies.arrival_script(
        seed, 30, 18, 200, batches)
    m, n = 30, 18
    bt = tpart.pack(rows, cols, vals, m, n, p)
    br = rpart.pack(rows, cols, vals, m, n, p)
    for b in script:
        m2, n2 = m + b["m_new"], n + b["n_new"]
        args = (rows, cols, vals, b["rows"], b["cols"], b["vals"], m2, n2)
        bt, br = tpart.repack_delta(bt, *args), rpart.repack_delta(br, *args)
        tol.assert_bitwise(bt.wave_cnt, br.wave_cnt, "wave_cnt")
        rows = np.concatenate([rows, b["rows"]])
        cols = np.concatenate([cols, b["cols"]])
        vals = np.concatenate([vals, b["vals"]])
        m, n = m2, n2
    assert_padded_equal(bt, br)


@pytest.mark.parametrize("kind", ["kill", "join", "killjoin"])
def test_padded_layout_after_repack_transition(kind):
    m, n, nnz, p = 60, 24, 700, 4
    rows, cols, vals = strategies.coo_problem(3, m, n, nnz)
    kw = dict(waves=True, schedule="random", schedule_seed=2)
    bt = tpart.pack(rows, cols, vals, m, n, p, **kw)
    br = rpart.pack(rows, cols, vals, m, n, p, **kw)
    alive = np.ones(p, dtype=bool)
    join = {"join": 2, "killjoin": 1}.get(kind, 0)
    alive[{"kill": [1], "killjoin": [2]}.get(kind, [])] = False
    tkw = dict(alive=alive, join=join,
               row_weights=np.bincount(rows, minlength=m),
               col_weights=np.bincount(cols, minlength=n))
    tt = t_compile(p, bt.row_owner, bt.col_block, **tkw)
    tr = r_compile(p, br.row_owner, br.col_block, **tkw)
    bt2 = tpart.repack_transition(bt, rows, cols, vals, tt)
    br2 = rpart.repack_transition(br, rows, cols, vals, tr)
    tol.assert_bitwise(bt2.wave_cnt, br2.wave_cnt, "wave_cnt")
    assert _unbuilt(bt) and _unbuilt(bt2)
    assert_padded_equal(bt2, br2)


@pytest.mark.parametrize("impl", ["wave", "wave_pallas"])
def test_check_packed_refuses_a_packing_without_waves(impl):
    rows, cols, vals = strategies.coo_problem(1, 20, 10, 80)
    flat = tpart.pack(rows, cols, vals, 20, 10, 2, waves=False)
    with pytest.raises(ValueError, match="needs the wave layout"):
        KernelPolicy(impl=impl).check_packed(flat, pipelined=False)
    waved = tpart.pack(rows, cols, vals, 20, 10, 2)
    KernelPolicy(impl=impl).check_packed(waved, pipelined=False)
    assert _unbuilt(waved)


@pytest.mark.parametrize("chunk", [1, 7, 999, tsyn.CHUNK, 1 << 20])
@pytest.mark.parametrize("powerlaw", [True, False])
def test_synthetic_chunks_are_bitwise_the_reference(monkeypatch, chunk,
                                                    powerlaw):
    want = rsyn.synthetic_ratings(400, 60, 5000, k=12, seed=7,
                                  powerlaw=powerlaw)
    monkeypatch.setattr(tsyn, "CHUNK", chunk)
    got = tsyn.synthetic_ratings(400, 60, 5000, k=12, seed=7,
                                 powerlaw=powerlaw)
    for name, a, b in zip(("rows", "cols", "vals", "W", "H"), got, want):
        tol.assert_bitwise(a, b, name)


@pytest.mark.parametrize("threaded_from", [1, 700, 2048])
@pytest.mark.parametrize("chunk", [7, tsyn.CHUNK])
def test_synthetic_threads_are_bitwise_the_reference(monkeypatch,
                                                     threaded_from, chunk):
    """The true ratings split into one contiguous span per thread."""
    want = rsyn.synthetic_ratings(400, 60, 5000, k=12, seed=7)
    monkeypatch.setattr(tsyn, "THREADED_FROM", threaded_from)
    monkeypatch.setattr(tsyn, "CHUNK", chunk)
    got = tsyn.synthetic_ratings(400, 60, 5000, k=12, seed=7)
    for name, a, b in zip(("rows", "cols", "vals", "W", "H"), got, want):
        tol.assert_bitwise(a, b, name)


def test_netflix_like_is_bitwise_the_reference():
    for a, b in zip(tsyn.netflix_like(2e-4, seed=3, k=8),
                    rsyn.netflix_like(2e-4, seed=3, k=8)):
        tol.assert_bitwise(a, b, "netflix_like")


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("sequential", [False, True])
def test_wave_csr_of_an_unbuilt_packing(schedule, sequential):
    """The engine's CSR of waves, from a packing whose padded layout was
    never built, equals the CSR compacted from the reference ``pack``'s
    padded arrays, step by step; building it leaves the layout
    unbuilt."""
    bt, br = _packs((2, 4, 50, 30, 400), schedule)
    csr = tnomad.wave_csr(bt, sequential=sequential)
    assert _unbuilt(bt)
    p = bt.p
    for s in range(bt.n_steps):
        if sequential:
            pad = [torch.from_numpy(np.ascontiguousarray(a[:, s, :, None]))
                   for a in (br.rows, br.cols, br.vals, br.mask)]
        else:
            pad = [torch.from_numpy(np.ascontiguousarray(a[:, s]))
                   for a in (br.wave_rows, br.wave_cols, br.wave_vals,
                             br.wave_mask)]
        want = tk.WaveCSR.from_padded(*pad)
        got = csr.cells(s * p, (s + 1) * p)
        base = int(got.woff[got.cell_woff[0]])
        end = int(got.woff[got.cell_woff[-1]])
        w0, w1 = int(got.cell_woff[0]), int(got.cell_woff[-1])
        assert torch.equal(got.rows[base:end], want.rows)
        assert torch.equal(got.cols[base:end], want.cols)
        assert torch.equal(got.vals[base:end], want.vals)
        assert torch.equal(got.woff[w0:w1 + 1] - base, want.woff)
        assert torch.equal(got.cell_woff - w0, want.cell_woff)


def test_sharded_rmse_in_chunks(monkeypatch):
    """The held-out RMSE summed chunk by chunk equals the one-piece
    computation to fp32 rounding, at a chunk smaller than the test set."""
    rng = np.random.default_rng(2)
    Ws = torch.from_numpy(rng.normal(size=(3, 40, 6)).astype(np.float32))
    Hs = torch.from_numpy(rng.normal(size=(3, 9, 6)).astype(np.float32))
    ridx = torch.from_numpy(rng.integers(0, 120, 1000))
    cidx = torch.from_numpy(rng.integers(0, 27, 1000))
    vals = torch.from_numpy(rng.normal(size=1000).astype(np.float32))
    whole = tnomad._sharded_rmse_body(Ws, Hs, ridx, cidx, vals)
    monkeypatch.setattr(tnomad, "RMSE_CHUNK", 64)
    chunked = tnomad._sharded_rmse_body(Ws, Hs, ridx, cidx, vals)
    pred = (Ws.reshape(-1, 6)[ridx].double()
            * Hs.reshape(-1, 6)[cidx].double()).sum(-1)
    want = float(((vals.double() - pred) ** 2).mean().sqrt())
    for got in (whole, chunked):
        assert abs(float(got) - want) <= 1e-6 * want


@pytest.mark.parametrize("seed", range(4))
def test_list_recurrences_are_bitwise_the_reference(seed):
    """``pack``'s two host recurrences, run over Python lists in the port
    (a heap of bin loads for the greedy fill), give the reference's
    numpy-scalar loops' results: assignments, colors and the loads left
    in place, for int and float loads, dead (infinite) bins and ties."""
    from repro.core import schedule as rsched
    from repro_torch.core import schedule as tsched
    rng = np.random.default_rng(seed)
    for trial in range(40):
        p, count = int(rng.integers(1, 10)), int(rng.integers(0, 200))
        kind = trial % 4
        if kind == 0:
            load, w = np.zeros(p, np.int64), rng.integers(0, 5, count)
        elif kind == 1:
            load, w = rng.integers(0, 50, p), rng.integers(0, 40, count)
        elif kind == 2:
            load = rng.integers(0, 9, p).astype(np.float64)
            load[rng.random(p) < 0.4] = np.inf
            w = np.ones(count)
        else:
            load, w = rng.random(p).astype(np.float32), rng.random(count)
        pad = (1.0, 0.0)[trial % 2]
        lt, lr = load.copy(), load.copy()
        tol.assert_bitwise(tsched.greedy_fill(lt, w, pad=pad),
                           rsched.greedy_fill(lr, w, pad=pad), "assign")
        tol.assert_bitwise(lt, lr, "load")
        a = rng.integers(0, 30, count)
        b = rng.integers(0, 7, count).astype(np.int32)
        tol.assert_bitwise(
            tsched.greedy_two_resource_color(a, b, 30, 7),
            rsched.greedy_two_resource_color(a, b, 30, 7), "colors")


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("m,n", [(50, 9), (3_000_000, 20_000),
                                 (2 ** 40, 2 ** 20)])
def test_cell_order_is_the_lexsort(seed, m, n):
    """One stable sort of a combined key (or, where the key would not fit
    in int64, the lexsort itself) orders ratings as pack's lexsort did,
    repeated (row, col) pairs in input order."""
    rng = np.random.default_rng(seed)
    cells = 16
    rows = rng.integers(0, min(m, 40), 3000) * (m // min(m, 40))
    cols = rng.integers(0, min(n, 8), 3000) * (n // min(n, 8))
    cell = rng.integers(0, cells, 3000)
    want = np.lexsort((rows, cols, cell))
    tol.assert_bitwise(tpart._cell_order(rows, cols, cell, m, n, cells),
                       want, "order")


@pytest.mark.parametrize("sub_blocks", [1, 2])
def test_pack_colors_in_processes_bitwise(monkeypatch, sub_blocks):
    """The cells colored in forked processes: the reference's layout."""
    m, n, nnz, p = 60, 24, 900, 4
    rows, cols, vals = strategies.coo_problem(4, m, n, nnz)
    want = rpart.pack(rows, cols, vals, m, n, p, sub_blocks=sub_blocks)
    monkeypatch.setattr(tpart, "COLOR_PROCESSES_FROM", 0)
    got = tpart.pack(rows, cols, vals, m, n, p, sub_blocks=sub_blocks)
    tol.assert_bitwise(got.wave_cnt, want.wave_cnt, "wave_cnt")
    tol.assert_bitwise(got.gid, want.gid, "gid")
    if sub_blocks > 1:
        tol.assert_bitwise(got.sub_rows, want.sub_rows, "sub_rows")
    assert_padded_equal(got, want)


@pytest.mark.parametrize("kind", ["delta", "transition"])
def test_repacks_color_in_processes_bitwise(monkeypatch, kind):
    """repack_delta's and repack_transition's re-colored cells, colored in
    forked processes: the reference's layout."""
    m, n, p = 60, 24, 4
    (rows, cols, vals), script = strategies.arrival_script(5, m, n, 700, 1)
    bt = tpart.pack(rows, cols, vals, m, n, p)
    br = rpart.pack(rows, cols, vals, m, n, p)
    monkeypatch.setattr(tpart, "COLOR_PROCESSES_FROM", 0)
    if kind == "delta":
        b = script[0]
        args = (rows, cols, vals, b["rows"], b["cols"], b["vals"],
                m + b["m_new"], n + b["n_new"])
        got = tpart.repack_delta(bt, *args)
        want = rpart.repack_delta(br, *args)
    else:
        alive = np.ones(p, dtype=bool)
        alive[1] = False
        tkw = dict(alive=alive, join=1,
                   row_weights=np.bincount(rows, minlength=m),
                   col_weights=np.bincount(cols, minlength=n))
        got = tpart.repack_transition(bt, rows, cols, vals, t_compile(
            p, bt.row_owner, bt.col_block, **tkw))
        want = rpart.repack_transition(br, rows, cols, vals, r_compile(
            p, br.row_owner, br.col_block, **tkw))
    tol.assert_bitwise(got.wave_cnt, want.wave_cnt, "wave_cnt")
    assert_padded_equal(got, want)
