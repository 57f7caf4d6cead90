"""The port's streaming layer against the JAX package's, and against
itself.

Held against the reference on the same numpy inputs: the incremental
re-pack (``partition.repack_delta``) byte for byte, the
``RatingArrivalStream`` batches and the factor growth bit for bit, and
``partial_fit`` chains within the tolerance tier's bound in fp32 and
bf16 (both sides start from the same injected ``W0``/``H0``, since the
reference's cold start draws with threefry).  Held inside the port,
bitwise: a ``StreamingSession`` chain equals the ``partial_fit`` chain
and a warm-started ``solve`` of the sticky extended problem.
"""
import numpy as np
import pytest
import torch

import strategies
import tolerance as tol

from repro import api as rapi
from repro.core import objective as robj
from repro.core import partition as rpart
from repro.core.stepsize import PowerSchedule as RPower
from repro.data.pipeline import RatingArrivalStream as RStream

from repro_torch import api as tapi
from repro_torch.core import objective as tobj
from repro_torch.core import partition as tpart
from repro_torch.core.nomad import NomadRingEngine
from repro_torch.core.stepsize import PowerSchedule as TPower
from repro_torch.data import RatingArrivalStream as TStream
from repro_torch.testing import assert_rare_flips

CPU = "cpu"
K = 4
_LAYOUT = ("p", "m", "n", "m_local", "n_local", "max_nnz", "n_waves",
           "wave_width", "sub_blocks")
_ARRAYS = ("row_owner", "row_local", "col_block", "col_local", "row_of",
           "col_of", "rows", "cols", "vals", "mask", "nnz_cell", "gid",
           "wave_rows", "wave_cols", "wave_vals", "wave_mask", "wave_gid",
           "wave_cnt", "sub_starts")


def assert_same_packing(a, b):
    """Two packings equal field for field, byte for byte."""
    for f in _LAYOUT:
        assert getattr(a, f) == getattr(b, f), f
    for f in _ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None:
            assert y is None, f
        else:
            tol.assert_bitwise(x, y, f)
    assert a.schedule == b.schedule or (
        a.schedule.p == b.schedule.p
        and np.array_equal(a.schedule.table, b.schedule.table)
        and np.array_equal(a.schedule.active, b.schedule.active))
    tol.assert_bitwise(a.schedule_order(), b.schedule_order(), "order")


def _stream_problems(seed=0, m=36, n=20, nnz=260):
    rows, cols, vals = strategies.coo_problem(seed, m, n, nnz)
    t = strategies.coo_problem(seed + 1, m, n, 50)
    kw = dict(rows=rows, cols=cols, vals=vals, m=m, n=n, test=t)
    return tapi.MCProblem(**kw), rapi.MCProblem(**kw)


def _configs(kernel="wave_pallas", dtype_policy="fp32", p=2, epochs=1):
    kw = dict(k=K, lam=0.01, epochs=epochs, seed=0, p=p, kernel=kernel,
              dtype_policy=dtype_policy)
    return (tapi.NomadConfig(stepsize=TPower(0.04, 0.05), **kw),
            rapi.NomadConfig(stepsize=RPower(0.04, 0.05), **kw))


def _warm(api, m, n, seed=0):
    rng = np.random.default_rng(seed)
    return api.FitResult(
        W=rng.uniform(0, 0.5, (m, K)).astype(np.float32),
        H=rng.uniform(0, 0.5, (n, K)).astype(np.float32),
        trace_epochs=np.zeros(0), trace_rmse=np.zeros(0), epochs_done=0)


def _script(problem, seed=7, batches=2, max_new=80):
    _, script = strategies.arrival_script(seed, problem.m, problem.n, 1,
                                          batches, max_new_ratings=max_new)
    return script


# --------------------------------------------------------------------- #
# layouts and host-side draws, byte for byte against the reference       #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("seed,p,batches,waves", [
    (0, 4, 2, True), (1, 1, 3, True), (2, 3, 2, False), (3, 5, 1, True)])
def test_repack_delta_matches_reference(seed, p, batches, waves):
    """The port's incremental re-pack equals the reference's, chained
    across batches, and a from-scratch pack under the sticky assignment;
    existing assignments never move."""
    (rows, cols, vals), script = strategies.arrival_script(
        seed, 30, 18, 200, batches)
    m, n = 30, 18
    bt = tpart.pack(rows, cols, vals, m, n, p, waves=waves)
    br = rpart.pack(rows, cols, vals, m, n, p, waves=waves)
    assert_same_packing(bt, br)
    for b in script:
        m2, n2 = m + b["m_new"], n + b["n_new"]
        args = (rows, cols, vals, b["rows"], b["cols"], b["vals"], m2, n2)
        bt2, br2 = tpart.repack_delta(bt, *args), rpart.repack_delta(br, *args)
        assert_same_packing(bt2, br2)
        rows = np.concatenate([rows, b["rows"]])
        cols = np.concatenate([cols, b["cols"]])
        vals = np.concatenate([vals, b["vals"]])
        assert_same_packing(bt2, tpart.pack(
            rows, cols, vals, m2, n2, p, waves=waves,
            row_owner=bt2.row_owner, col_block=bt2.col_block))
        tol.assert_bitwise(bt2.row_owner[:m], bt.row_owner, "sticky rows")
        tol.assert_bitwise(bt2.col_block[:n], bt.col_block, "sticky cols")
        m, n, bt, br = m2, n2, bt2, br2


def test_rating_arrival_stream_matches_reference():
    kw = dict(m0=50, n0=20, nnz0=400, batches=3, nnz_batch=60,
              m_growth=4, n_growth=2, k=K, seed=5)
    ts, rs = TStream(**kw), RStream(**kw)
    tp, rp = ts.initial_problem(), rs.initial_problem()
    assert isinstance(tp, tapi.MCProblem) and (tp.m, tp.n) == (50, 20)
    for a, b in zip((*tp.train, *tp.test), (*rp.train, *rp.test)):
        tol.assert_bitwise(a, b)
    got, want = list(ts), list(rs)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in ("rows", "cols", "vals"):
            tol.assert_bitwise(g[key], w[key], key)
        for a, b in zip(g["test"], w["test"]):
            tol.assert_bitwise(a, b, "test")
        assert (g["m_new"], g["n_new"]) == (w["m_new"], w["n_new"])
    tol.assert_bitwise(ts.batch_at(1)["vals"], got[1]["vals"], "replay")
    with pytest.raises(IndexError):
        ts.batch_at(3)
    with pytest.raises(ValueError):
        TStream(m0=0, n0=1, nnz0=1)


def test_grow_factors_matches_reference():
    rng = np.random.default_rng(0)
    W = rng.normal(size=(10, K)).astype(np.float32)
    H = rng.normal(size=(6, K)).astype(np.float32)
    got = tobj.grow_factors(W, H, 3, 2, seed=5)
    want = robj.grow_factors(W, H, 3, 2, seed=5)
    for a, b in zip(got, want):
        tol.assert_bitwise(a, b)
    tol.assert_bitwise(got[0][:10], W, "old rows untouched")


def test_problem_delta_matches_reference():
    tp, rp = _stream_problems(4)
    b = _script(tp, seed=3, batches=1)[0]
    test = strategies.coo_problem(9, tp.m + b["m_new"], tp.n + b["n_new"],
                                  7)
    td = tp.extend(b["rows"], b["cols"], b["vals"], m_new=b["m_new"],
                   n_new=b["n_new"], test=test)
    rd = rp.extend(b["rows"], b["cols"], b["vals"], m_new=b["m_new"],
                   n_new=b["n_new"], test=test)
    assert (td.m, td.n, td.nnz) == (rd.m, rd.n, rd.nnz)
    te, re = td.extended(), rd.extended()
    assert te is td.extended()                  # memoized
    for a, c in zip((*te.train, *te.test), (*re.train, *re.test)):
        tol.assert_bitwise(a, c)
    for bad in (dict(m_new=-1), dict()):
        with pytest.raises(ValueError):
            tp.extend(**bad)
    with pytest.raises(ValueError, match="out of range"):
        tp.extend([tp.m], [0], [1.0])
    with pytest.raises(TypeError):
        tapi.ProblemDelta(base=rp, m_new=1)


# --------------------------------------------------------------------- #
# partial_fit against the reference, within the tolerance tier          #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("kernel,dtype_policy", [
    ("wave_pallas", "fp32"), ("xla", "fp32"), ("wave_pallas", "bf16")])
def test_partial_fit_matches_reference(kernel, dtype_policy):
    tp, rp = _stream_problems()
    tcfg, rcfg = _configs(kernel, dtype_policy)
    script = _script(tp)
    tres = tapi.solve(tp, tcfg, warm_start=_warm(tapi, tp.m, tp.n),
                      device=CPU)
    rres = rapi.solve(rp, rcfg, warm_start=_warm(rapi, rp.m, rp.n))
    start = tres
    for i, b in enumerate(script):
        kw = dict(m_new=b["m_new"], n_new=b["n_new"])
        start = tres
        tres = tapi.partial_fit(tres, tp.extend(b["rows"], b["cols"],
                                                b["vals"], **kw), tcfg,
                                device=CPU)
        rres = rapi.partial_fit(rres, rp.extend(b["rows"], b["cols"],
                                                b["vals"], **kw), rcfg)
        tp, rp = tres.extras["problem"], rres.extras["problem"]
        tol.assert_bitwise(tp.row_assign, rp.row_assign, "sticky rows")
        tol.assert_bitwise(tp.col_assign, rp.col_assign, "sticky cols")
        n_upd = (i + 2) * tp.nnz / (tp.m + tp.n)
        for a, w in ((tres.W, rres.W), (tres.H, rres.H)):
            tol.assert_factors_close(a, np.asarray(w).astype(np.float32),
                                     dtype_policy=dtype_policy,
                                     n_updates=n_upd)
        np.testing.assert_allclose(tres.trace_rmse, rres.trace_rmse,
                                   rtol=1e-4 if dtype_policy == "fp32"
                                   else 2e-2)
    assert tres.epochs_done == rres.epochs_done == 3
    if dtype_policy == "bf16":
        # the last round: both compute in fp32 over bf16 storage from
        # the grown bf16 factors
        W0 = tobj.grow_factors(start.W, start.H, script[-1]["m_new"],
                               script[-1]["n_new"], seed=0)[0]
        assert_rare_flips(*(torch.from_numpy(np.asarray(x, np.float32))
                            .bfloat16() for x in (tres.W, rres.W, W0)),
                          what="bf16 partial_fit")


def test_partial_fit_refusals():
    tp, _ = _stream_problems(4)
    tcfg, _ = _configs()
    res = tapi.solve(tp, tcfg, warm_start=_warm(tapi, tp.m, tp.n),
                     device=CPU)
    delta = tp.extend(m_new=1)
    for other in (tapi.CcdConfig(k=K), tapi.AlsConfig(k=K)):
        with pytest.raises(NotImplementedError, match="partial_fit"):
            tapi.partial_fit(res, delta, other, device=CPU)
        with pytest.raises(NotImplementedError, match="streaming"):
            tapi.StreamingSession(tp, other, device=CPU)
    # partial_fit(mesh=) runs (tests/test_torch_spmd_elastic.py); a mesh
    # that is not an McMesh is refused
    with pytest.raises(TypeError, match="McMesh"):
        tapi.partial_fit(res, delta, tcfg, mesh=object(), device=CPU)
    with pytest.raises(TypeError):
        tapi.partial_fit(res, tp, tcfg, device=CPU)
    assert tapi.streaming_solver_names() == ["dsgd", "hogwild", "nomad"]
    assert tapi.supports_partial_fit("nomad")
    assert tapi.supports_partial_fit(tapi.DsgdConfig(k=K))
    assert not tapi.supports_partial_fit("als")
    assert not tapi.supports_partial_fit(tapi.SolverConfig)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tapi.partial_fit(res, delta, tcfg)
        with pytest.raises(RuntimeError, match="cuda"):
            tapi.StreamingSession(tp, tcfg)


# --------------------------------------------------------------------- #
# inside the port, bitwise                                               #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("kernel", ["wave_pallas", "pallas", "xla"])
def test_session_equals_partial_fit_chain_and_batch_refit(kernel):
    """The session's persistent engine (``grow``) == the stateless
    ``partial_fit`` chain == grow-factors + a warm-started ``solve`` of
    the sticky extended problem, bit for bit, with the history length
    and the final problem shape the chain's."""
    problem, _ = _stream_problems(3)
    cfg, _ = _configs(kernel)
    script = _script(problem, seed=11, max_new=70)
    warm = _warm(tapi, problem.m, problem.n)
    res = tapi.solve(problem, cfg, warm_start=warm, device=CPU)
    pr = problem
    for b in script:
        delta = pr.extend(b["rows"], b["cols"], b["vals"],
                          m_new=b["m_new"], n_new=b["n_new"])
        prev, res = res, tapi.partial_fit(res, delta, cfg, device=CPU)
        ext = res.extras["problem"]
        W2, H2 = tobj.grow_factors(prev.W, prev.H, b["m_new"], b["n_new"],
                                   seed=cfg.seed)
        batch = tapi.solve(ext, cfg, device=CPU, warm_start=tapi.FitResult(
            W=W2, H=H2, trace_epochs=np.zeros(0), trace_rmse=np.zeros(0),
            epochs_done=prev.epochs_done))
        for x in ("W", "H", "trace_rmse"):
            tol.assert_bitwise(getattr(res, x), getattr(batch, x), x)
        pr = ext
    sess = tapi.StreamingSession(problem, cfg, warm_start=warm, device=CPU)
    sess.fit()
    for b in script:
        sres = sess.arrive(**{key: b[key] for key in
                              ("rows", "cols", "vals", "m_new", "n_new")})
    tol.assert_bitwise(sres.W, res.W, "session W")
    tol.assert_bitwise(sres.H, res.H, "session H")
    assert len(sess.history) == len(script) + 1
    assert (sess.problem.m, sess.problem.n) == (pr.m, pr.n)
    assert set(sess.timings) >= {"repack_delta", "grow", "train"}


def test_partial_fit_chain_stays_incremental():
    """The extended problem handed back carries the incremental packing
    in its pack cache, so a chained round never re-packs history."""
    problem, _ = _stream_problems(9)
    cfg, _ = _configs()
    res = tapi.solve(problem, cfg, warm_start=_warm(tapi, problem.m,
                                                    problem.n), device=CPU)
    res = tapi.partial_fit(res, problem.extend([0], [0], [1.0], m_new=2),
                           cfg, device=CPU)
    ext = res.extras["problem"]
    policy = cfg.kernel
    br = ext.packed(cfg.p, balanced=cfg.balanced, waves=policy.wave,
                    sub_blocks=policy.sub_blocks, schedule=cfg.schedule,
                    schedule_seed=cfg.schedule_seed)
    assert br is ext._pack_cache[tapi.MCProblem._pack_key(
        cfg.p, cfg.balanced, policy.wave, None, policy.sub_blocks,
        cfg.schedule, cfg.schedule_seed)]
    assert br.m == ext.m and int(br.mask.sum()) == ext.nnz


def _engine(br):
    return NomadRingEngine(br=br, k=K, lam=0.01, stepsize=TPower(),
                           impl="wave_pallas", device=CPU)


def test_engine_grow_rebuilds_layout_and_keeps_old_entries():
    """``grow`` keeps every old entry bitwise, seeds the new rows as
    ``grow_factors`` does (a one-sided override keeps the other side's
    draw), and rebuilds the wave CSR, its ``prev`` links and the eval
    cache for the grown packing; a non-sticky packing is refused."""
    rows, cols, vals = strategies.coo_problem(2, 20, 10, 150)
    br = tpart.pack(rows, cols, vals, 20, 10, 2, waves=True)
    eng = _engine(br)
    W0, H0 = (x.astype(np.float32)
              for x in tobj.init_factors_np(0, 20, 10, K))
    eng.init_factors(W0, H0)
    t = (rows[:5], cols[:5], vals[:5])
    eng.eval_rmse(t)
    assert eng._eval_cache is not None
    br2 = tpart.repack_delta(br, rows, cols, vals, [21, 3], [11, 2],
                             [1.0, 2.0], 23, 12)
    mine = np.full((3, K), 0.125, np.float32)
    eng.grow(br2, seed=4, W_new=mine)
    W, H = eng.factors()
    tol.assert_bitwise(W[:20], W0, "old W")
    tol.assert_bitwise(H[:10], H0, "old H")
    tol.assert_bitwise(W[20:], mine, "W_new")
    tol.assert_bitwise(H[10:], tobj.grow_factors(W0, H0, 3, 2, seed=4)[1][10:],
                       "seeded H")
    assert eng.br is br2 and eng._eval_cache is None
    cells = eng._data[0]
    assert cells.prev is None          # links rebuilt for the new layout
    want = NomadRingEngine(br=br2, k=K, lam=0.01, stepsize=TPower(),
                           impl="wave_pallas", device=CPU)._data[0]
    for f in ("rows", "cols", "vals", "woff", "cell_woff"):
        assert torch.equal(getattr(cells, f), getattr(want, f)), f
    assert torch.equal(cells.links(), want.links())
    with pytest.raises(ValueError, match="W_new must have shape"):
        eng.grow(br2, W_new=np.zeros((1, K), np.float32))
    other = tpart.pack(rows, cols, vals, 23, 12, 2, waves=True,
                       row_owner=(np.arange(23) + 1) % 2)
    with pytest.raises(ValueError, match="sticky"):
        eng.grow(other)
    with pytest.raises(ValueError, match="shrink"):
        eng.grow(br)
    with pytest.raises(TypeError, match="McMesh"):
        eng.migrate(br2, mesh=object())
