"""The port's baselines (``repro_torch.core.baselines``: DSGD, CCD++, ALS,
Hogwild) against the JAX package's, and against the port's NOMAD.

Both packages start from the same numpy ``W0``/``H0`` (JAX's threefry
cold start cannot be reproduced in torch).  DSGD is NOMAD's ring with a
bulk barrier, so inside the port it equals the ring bitwise on every
kernel route; against the reference its factors are held within the
tolerance tier's bound.  CCD++, ALS and Hogwild sum in another order
than XLA's segment sums, so their RMSE traces are held to
``assert_convergence_equivalent`` and their factors, where the fit is
well conditioned, to the tolerance tier.  Everything runs on the CPU,
where the kernel's wrapper runs its plain version.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tolerance as tol

from repro import api as rapi
from repro.checkpoint import checkpoint as rck
from repro.core import baselines as rbase
from repro.core import partition as rpart
from repro.core.stepsize import PowerSchedule as RPower

from repro_torch import api as tapi
from repro_torch.checkpoint import checkpoint as tck
from repro_torch.core import baselines as tbase
from repro_torch.core import objective as tobj
from repro_torch.core import partition as tpart
from repro_torch.core.nomad import wave_csr
from repro_torch.core.stepsize import PowerSchedule as TPower
from repro_torch.data.synthetic import synthetic_ratings, train_test_split

CPU = "cpu"
M, N, NNZ, K, P = 60, 40, 1200, 4, 3
LAM = 0.01
ALPHA, BETA = 0.05, 0.05
BASELINES = ("dsgd", "ccdpp", "als", "hogwild")


@pytest.fixture(scope="module")
def data():
    rows, cols, vals, _, _ = synthetic_ratings(M, N, NNZ, k=K, seed=3,
                                               noise=0.05)
    train, test = train_test_split(rows, cols, vals, test_frac=0.15, seed=0)
    rng = np.random.default_rng(5)
    W0 = rng.uniform(0, 1 / np.sqrt(K), (M, K)).astype(np.float32)
    H0 = rng.uniform(0, 1 / np.sqrt(K), (N, K)).astype(np.float32)
    return dict(train=train, test=test, W0=W0, H0=H0)


def _problems(d):
    kw = dict(rows=d["train"][0], cols=d["train"][1], vals=d["train"][2],
              m=M, n=N, test=d["test"])
    return tapi.MCProblem(**kw), rapi.MCProblem(**kw)


def _warm(api, d, done=0):
    return api.FitResult(W=d["W0"], H=d["H0"], trace_epochs=np.zeros(0),
                         trace_rmse=np.zeros(0), epochs_done=done)


def _config(api, name, epochs=2, **kw):
    cls = api.config_for(name)
    if name in ("dsgd", "nomad"):
        kw.setdefault("p", P)
    if name == "hogwild":
        kw.setdefault("batch", 16)
    power = TPower if api is tapi else RPower
    return cls(k=K, lam=LAM, epochs=epochs, seed=0,
               stepsize=power(ALPHA, BETA), **kw)


def _n_updates(d, epochs):
    return epochs * len(d["train"][0]) / (M + N)


def _args(d, **kw):
    return (*d["train"], M, N, K), dict(lam=LAM, test=d["test"],
                                        W0=d["W0"], H0=d["H0"], **kw)


# --------------------------------------------------------------------- #
# DSGD                                                                   #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("kernel", ["xla", "wave", "pallas", "wave_pallas"])
def test_dsgd_equals_nomad_ring_bitwise(data, kernel):
    """DSGD's sub-epochs are the ring's steps, each cell updated in the
    same serial order: bitwise equal factors and trace on every route."""
    tp, _ = _problems(data)
    dsgd = tapi.solve(tp, _config(tapi, "dsgd", epochs=3),
                      warm_start=_warm(tapi, data), device=CPU)
    nomad = tapi.solve(tp, _config(tapi, "nomad", epochs=3, kernel=kernel),
                       warm_start=_warm(tapi, data), device=CPU)
    tol.assert_bitwise(dsgd.W, nomad.W, "W")
    tol.assert_bitwise(dsgd.H, nomad.H, "H")
    tol.assert_bitwise(dsgd.trace_rmse.astype(np.float32),
                       nomad.trace_rmse.astype(np.float32), "trace")
    assert dsgd.solver == "dsgd" and dsgd.epochs_done == 3


def test_dsgd_cold_start_equals_nomad_cold_start(data):
    tp, _ = _problems(data)
    dsgd = tapi.solve(tp, _config(tapi, "dsgd", epochs=1), device=CPU)
    nomad = tapi.solve(tp, _config(tapi, "nomad", epochs=1,
                                   kernel="wave_pallas"), device=CPU)
    tol.assert_bitwise(dsgd.W, nomad.W, "W")
    tol.assert_bitwise(dsgd.H, nomad.H, "H")


def test_dsgd_matches_reference(data):
    args, kw = _args(data, epochs=2)
    W, H, tr = tbase.dsgd(*args, P, device=CPU,
                          schedule=TPower(ALPHA, BETA), **kw)
    rW, rH, rtr = rbase.dsgd(*args, P, schedule=RPower(ALPHA, BETA), **kw)
    for a, b in ((W, rW), (H, rH)):
        tol.assert_factors_close(a, np.asarray(b), dtype_policy="fp32",
                                 n_updates=_n_updates(data, 2))
    assert [e for e, _ in tr] == [e for e, _ in rtr] == [1, 2]
    np.testing.assert_allclose([r for _, r in tr], [r for _, r in rtr],
                               rtol=1e-5)


@pytest.mark.parametrize("step", [0, 1])
def test_dsgd_subepoch_matches_reference(data, step):
    """One sub-epoch (the p cells of one rotation step, then the roll)
    from the same sharded factors."""
    rows, cols, vals = data["train"]
    tbr = tpart.pack(rows, cols, vals, M, N, P, balanced=True, waves=False)
    rbr = rpart.pack(rows, cols, vals, M, N, P, balanced=True, waves=False)
    Ws, Hs = tpart.shard_factors(data["W0"], data["H0"], tbr)
    cells = wave_csr(tbr, sequential=True)
    lr = 0.05
    tW, tH = tbase._dsgd_subepoch(torch.from_numpy(Ws.copy()),
                                  torch.from_numpy(Hs.copy()),
                                  cells.cells(step * P, (step + 1) * P),
                                  lr, LAM)
    import jax.numpy as jnp
    R, C, V, Mk = (jnp.asarray(a[:, step]) for a in
                   (rbr.rows, rbr.cols, rbr.vals, rbr.mask))
    rW, rH = rbase._dsgd_subepoch(jnp.asarray(Ws), jnp.asarray(Hs), R, C, V,
                                  Mk, jnp.float32(lr), LAM)
    n_upd = int(tbr.nnz_cell.max())
    tol.assert_factors_close(tW.numpy(), np.asarray(rW), dtype_policy="fp32",
                             n_updates=n_upd, what="W")
    tol.assert_factors_close(tH.numpy(), np.asarray(rH), dtype_policy="fp32",
                             n_updates=n_upd, what="H (rolled)")
    # the roll moved every block: worker q now holds q - 1's
    assert not np.array_equal(tH.numpy(), Hs)


def test_dsgd_refuses_a_non_ring_packing(data):
    rows, cols, vals = data["train"]
    br = tpart.pack(rows, cols, vals, M, N, P, waves=False,
                    schedule="random")
    with pytest.raises(ValueError, match="ring"):
        tbase.dsgd(rows, cols, vals, M, N, K, P, epochs=1, br=br,
                   device=CPU)


# --------------------------------------------------------------------- #
# CCD++, ALS, Hogwild against the reference                              #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["ccdpp", "als", "hogwild"])
def test_trace_matches_reference(data, name):
    args, kw = _args(data, epochs=3)
    if name == "hogwild":
        kw.update(batch=16)
        W, H, tr = tbase.hogwild(*args, device=CPU, schedule=TPower(
            ALPHA, BETA), **kw)
        rW, rH, rtr = rbase.hogwild(*args, schedule=RPower(ALPHA, BETA),
                                    **kw)
    else:
        W, H, tr = getattr(tbase, name)(*args, device=CPU, **kw)
        rW, rH, rtr = getattr(rbase, name)(*args, **kw)
    assert [e for e, _ in tr] == [e for e, _ in rtr] == [1, 2, 3]
    base = tobj.rmse_np(data["W0"], data["H0"], *data["test"])
    got = [base] + [r for _, r in tr]
    want = [base] + [r for _, r in rtr]
    tol.assert_convergence_equivalent(got, want, rel=1e-3)
    assert np.isfinite(W).all() and np.isfinite(H).all()


def test_hogwild_draws_the_reference_minibatches(data):
    """With the same permutation the minibatches are the same sets, and
    the racing sums differ only in order: factors within the tier (a
    different permutation lands far outside it)."""
    args, kw = _args(data, epochs=1, batch=16)
    W, H, _ = tbase.hogwild(*args, device=CPU, schedule=TPower(ALPHA, BETA),
                            **kw)
    rW, rH, _ = rbase.hogwild(*args, schedule=RPower(ALPHA, BETA), **kw)
    n_upd = _n_updates(data, 1)
    tol.assert_factors_close(W, np.asarray(rW), dtype_policy="fp32",
                             n_updates=n_upd, what="W")
    tol.assert_factors_close(H, np.asarray(rH), dtype_policy="fp32",
                             n_updates=n_upd, what="H")
    other, _, _ = tbase.hogwild(*args, device=CPU, seed=1,
                                schedule=TPower(ALPHA, BETA), **kw)
    with pytest.raises(AssertionError):
        tol.assert_factors_close(other, np.asarray(rW), dtype_policy="fp32",
                                 n_updates=n_upd)


@pytest.mark.parametrize("name,sweeps", [("als", 1), ("ccdpp", 3)])
def test_factors_match_reference(data, name, sweeps):
    """ALS and CCD++ from the same factors: every entry is a ratio of
    sums over a row's or a column's ratings, re-formed ``sweeps`` times an
    epoch, so the walk is epochs x sweeps x the largest degree."""
    args, kw = _args(data, epochs=2)
    W, H, _ = getattr(tbase, name)(*args, device=CPU, **kw)
    rW, rH, _ = getattr(rbase, name)(*args, **kw)
    deg = max(np.bincount(data["train"][0]).max(),
              np.bincount(data["train"][1]).max())
    for a, b, what in ((W, rW, "W"), (H, rH, "H")):
        tol.assert_factors_close(a, np.asarray(b), dtype_policy="fp32",
                                 n_updates=2 * sweeps * deg, what=what)


def test_ccdpp_decreases_objective_monotonically(data):
    rows, cols, vals = data["train"]
    t = [torch.as_tensor(x) for x in (rows, cols)]
    v = torch.as_tensor(vals, dtype=torch.float32)
    W, H = data["W0"], data["H0"]
    objs = [float(tobj.objective(torch.as_tensor(W), torch.as_tensor(H),
                                 *t, v, LAM))]
    for _ in range(4):
        W, H, _ = tbase.ccdpp(rows, cols, vals, M, N, K, lam=LAM, epochs=1,
                              W0=W, H0=H, device=CPU)
        objs.append(float(tobj.objective(torch.as_tensor(W),
                                         torch.as_tensor(H), *t, v, LAM)))
    assert all(objs[i + 1] <= objs[i] * 1.001 for i in range(len(objs) - 1))
    assert objs[-1] < objs[0]


# --------------------------------------------------------------------- #
# ALS's chunked normal equations                                         #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("slots,max_rows", [(64, 4), (16, 1 << 16),
                                            (1 << 22, 3)])
def test_als_chunked_gram_equals_one_piece(data, slots, max_rows):
    rows, cols, vals = data["train"]
    groups = tbase._RowGroups(rows, cols, vals, M, N, CPU, slots=slots,
                              max_rows=max_rows)
    assert len(groups.chunks) > len({D for _, D in groups.chunks})
    H = torch.from_numpy(data["H0"])
    Mk = torch.full((M, K, K), float("nan"))
    b = torch.full((M, K), float("nan"))
    for ids, Mc, bc in groups.normal_equations(H, LAM):
        Mk[ids], b[ids] = Mc, bc[..., 0]
    # the one-piece form: segment sums of (nnz, k, k) outer products
    r = torch.as_tensor(rows)
    hj = H[torch.as_tensor(cols)]
    outer = hj[:, :, None] * hj[:, None, :]
    want = torch.zeros(M, K, K).index_add_(0, r, outer)
    cnt = torch.zeros(M).index_add_(0, r, torch.ones(len(rows)))
    want += (LAM * cnt[:, None, None] + 1e-8) * torch.eye(K)[None]
    bw = torch.zeros(M, K).index_add_(
        0, r, hj * torch.as_tensor(vals, dtype=torch.float32)[:, None])
    n_upd = int(cnt.max())
    tol.assert_factors_close(Mk.numpy(), want.numpy(), dtype_policy="fp32",
                             n_updates=n_upd, what="Gram")
    tol.assert_factors_close(b.numpy(), bw.numpy(), dtype_policy="fp32",
                             n_updates=n_upd, what="b")


def test_als_padded_degrees_and_chunk_bounds(data):
    rows, cols, vals = data["train"]
    groups = tbase._RowGroups(rows, cols, vals, M, N, CPU, slots=64,
                              max_rows=4)
    deg = np.bincount(rows, minlength=M)
    seen = np.concatenate([ids.numpy() for ids, _ in groups.chunks])
    assert sorted(seen.tolist()) == list(range(M))
    for ids, D in groups.chunks:
        d = deg[ids.numpy()]
        assert (d <= D).all() and (2 * d > D).all() | (D == 1)
        assert len(ids) <= max(1, min(4, 64 // D))


# --------------------------------------------------------------------- #
# The front door: registry, warm starts, streaming, checkpoints          #
# --------------------------------------------------------------------- #

def test_solver_registry_equals_reference():
    assert tapi.solver_names() == rapi.solver_names() == [
        "als", "async_sim", "ccdpp", "dsgd", "hogwild", "nomad"]
    assert tapi.streaming_solver_names() == rapi.streaming_solver_names() \
        == ["dsgd", "hogwild", "nomad"]
    for name in BASELINES:
        t, r = tapi.config_for(name), rapi.config_for(name)
        assert t.__name__ == r.__name__
        assert [f.name for f in dataclasses.fields(t)] == \
            [f.name for f in dataclasses.fields(r)]


@pytest.mark.parametrize("cls,bad", [("DsgdConfig", dict(p=0)),
                                     ("CcdConfig", dict(inner=0)),
                                     ("HogwildConfig", dict(batch=0)),
                                     ("AlsConfig", dict(epochs=1.5))])
def test_config_validation_as_reference(cls, bad):
    for api in (tapi, rapi):
        with pytest.raises(ValueError):
            getattr(api, cls)(k=4, **bad)


@pytest.mark.parametrize("name", ["dsgd", "als"])
def test_warm_start_is_bitwise_resume(data, name):
    tp, _ = _problems(data)
    full = tapi.solve(tp, _config(tapi, name, epochs=2), device=CPU)
    half = tapi.solve(tp, _config(tapi, name, epochs=1), device=CPU)
    rest = tapi.solve(tp, _config(tapi, name, epochs=1), warm_start=half,
                      device=CPU)
    tol.assert_bitwise(rest.W, full.W, "W")
    tol.assert_bitwise(rest.H, full.H, "H")
    assert rest.epochs_done == 2
    assert half.trace + rest.trace == full.trace


@pytest.mark.parametrize("name", ["ccdpp", "hogwild"])
def test_warm_start_trace_epochs_continue(data, name):
    tp, _ = _problems(data)
    cfg = _config(tapi, name, epochs=2)
    half = tapi.solve(tp, cfg, device=CPU)
    rest = tapi.solve(tp, cfg, warm_start=half, device=CPU)
    joint = np.concatenate([half.trace_epochs, rest.trace_epochs])
    assert np.all(np.diff(joint.astype(np.float64)) > 0)
    assert rest.epochs_done == 4


def _delta(problem, seed=0):
    rng = np.random.default_rng(seed)
    m2, n2 = problem.m + 3, problem.n + 2
    return problem.extend(rng.integers(0, m2, 40), rng.integers(0, n2, 40),
                          rng.normal(size=40), m_new=3, n_new=2)


def test_dsgd_partial_fit_equals_warm_refit(data):
    tp, _ = _problems(data)
    cfg = _config(tapi, "dsgd", epochs=1)
    res = tapi.solve(tp, cfg, device=CPU)
    delta = _delta(tp)
    got = tapi.partial_fit(res, delta, device=CPU)
    W2, H2 = tobj.grow_factors(res.W, res.H, 3, 2, seed=cfg.seed)
    want = tapi.solve(delta.extended(), cfg,
                      warm_start=dataclasses.replace(res, W=W2, H=H2),
                      device=CPU)
    tol.assert_bitwise(got.W, want.W, "W")
    tol.assert_bitwise(got.H, want.H, "H")
    assert got.epochs_done == 2 and got.solver == "dsgd"
    assert got.extras["problem"].m == tp.m + 3


@pytest.mark.parametrize("name", ["dsgd", "hogwild"])
def test_session_equals_partial_fit_chain(data, name):
    tp, _ = _problems(data)
    cfg = _config(tapi, name, epochs=1)
    sess = tapi.StreamingSession(tp, cfg, device=CPU)
    first = sess.fit()
    chain = tapi.solve(tp, cfg, device=CPU)
    tol.assert_bitwise(first.W, chain.W, "fit W")
    prob = tp
    for seed in (0, 1):
        delta = _delta(prob, seed)
        got = sess.arrive(delta.rows, delta.cols, delta.vals,
                          m_new=delta.m_new, n_new=delta.n_new)
        chain = tapi.partial_fit(chain, delta, device=CPU)
        prob = chain.extras["problem"]
        tol.assert_bitwise(got.W, chain.W, f"W after arrival {seed}")
        tol.assert_bitwise(got.H, chain.H, f"H after arrival {seed}")
    assert sess.problem.m == M + 6 and len(sess.history) == 3
    with pytest.raises(NotImplementedError, match="NomadConfig"):
        sess.resize(leave=(0,))


@pytest.mark.parametrize("name", ["ccdpp", "als", "async_sim"])
def test_non_streaming_solvers_refuse(data, name):
    tp, _ = _problems(data)
    cfg = _config(tapi, name, epochs=1)
    res = tapi.solve(tp, cfg, device=CPU)
    with pytest.raises(NotImplementedError, match="partial_fit"):
        tapi.partial_fit(res, tp.extend(m_new=1), device=CPU)
    with pytest.raises(NotImplementedError, match="streaming"):
        tapi.StreamingSession(tp, cfg, device=CPU)


def _same_config(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "stepsize":
            assert (x.alpha, x.beta) == (y.alpha, y.beta)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("name", BASELINES)
def test_reference_checkpoint_restores_in_port(tmp_path, data, name):
    _, rp = _problems(data)
    cfg = _config(rapi, name, epochs=1)
    res = rapi.solve(rp, cfg, warm_start=_warm(rapi, data))
    rck.save_fit_result(str(tmp_path), 1, res)
    got, step = tck.restore_fit_result(str(tmp_path))
    assert step == 1 and got.solver == name
    assert type(got.config).__name__ == type(cfg).__name__
    assert isinstance(got.config, tapi.config_for(name))
    _same_config(got.config, cfg)
    tol.assert_bitwise(got.W, np.asarray(res.W, np.float32), "W")
    # the port resumes it
    more = tapi.solve(_problems(data)[0], got.config, warm_start=got,
                      device=CPU)
    assert more.epochs_done == 2 and np.isfinite(more.W).all()


@pytest.mark.parametrize("name", BASELINES)
def test_port_checkpoint_restores_in_reference(tmp_path, data, name):
    tp, _ = _problems(data)
    cfg = _config(tapi, name, epochs=1)
    res = tapi.solve(tp, cfg, warm_start=_warm(tapi, data), device=CPU)
    tck.save_fit_result(str(tmp_path), 1, res)
    got, step = rck.restore_fit_result(str(tmp_path))
    assert step == 1 and got.solver == name
    assert isinstance(got.config, rapi.config_for(name))
    _same_config(got.config, cfg)
    tol.assert_bitwise(np.asarray(got.W), res.W, "W")
    back, _ = tck.restore_fit_result(str(tmp_path))
    assert back.config == cfg


def test_core_exports_baselines_without_an_import_cycle():
    """``repro_torch.core.baselines`` as the JAX package exports it, and
    every module still importable first in a fresh process."""
    code = ("import repro_torch.convert, repro_torch.serve\n"
            "import repro_torch.core as core\n"
            "assert core.baselines.dsgd.__module__ == "
            "'repro_torch.core.baselines'\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=src),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
