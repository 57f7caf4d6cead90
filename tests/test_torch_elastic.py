"""The port's elasticity and integrity layer against the JAX package's,
and against itself.

Held against the reference on the same numpy inputs: the runtime
modules (``replan_on_failure``, ``StragglerMonitor``, ``seeded_script``,
``seeded_link_script``, ``Envelope`` bytes) equal, the transition
re-pack (``partition.repack_transition``) byte for byte, an elastic
script within the tolerance tier, and a reference ``solve(faults=)``
checkpoint resumed by the port.  Held inside the port, bitwise: resize
is pure data movement, kill recovery equals graceful departure,
crash-resume equals the uninterrupted run, divergence rollback replays
identically through a kill, log compaction keeps recovery exact, and a
bit-flipped newest checkpoint never boots.
"""
import dataclasses
import os
import tempfile

import numpy as np
import pytest

import strategies
import tolerance as tol

from repro import api as rapi
from repro.core import partition as rpart
from repro.core.schedule import compile_transition as r_compile
from repro.core.stepsize import PowerSchedule as RPower
from repro.runtime import chaos as rchaos
from repro.runtime import elastic as relastic
from repro.runtime import straggler as rstraggler
from repro.runtime import transport as rtransport

from repro_torch import api as tapi
from repro_torch.core import partition as tpart
from repro_torch.core.schedule import compile_transition as t_compile
from repro_torch.core.stepsize import PowerSchedule as TPower
from repro_torch.runtime import chaos as tchaos
from repro_torch.runtime import elastic as telastic
from repro_torch.runtime import straggler as tstraggler
from repro_torch.runtime import transport as ttransport

from test_torch_stream import assert_same_packing

CPU = "cpu"
K = 4


def _problems(seed=0, m=60, n=24, nnz=700):
    tp = tapi.MCProblem.synthetic(m, n, nnz, k=K, seed=seed)
    rp = rapi.MCProblem.synthetic(m, n, nnz, k=K, seed=seed)
    return tp, rp


def _cfg(api=tapi, impl="wave_pallas", p=4, epochs=1, alpha=0.02,
         beta=0.1, **kw):
    sched = (TPower if api is tapi else RPower)(alpha=alpha, beta=beta)
    return api.NomadConfig(k=K, p=p, epochs=epochs, seed=1, lam=0.01,
                           kernel=impl, stepsize=sched, **kw)


def _warm(api, m=60, n=24, seed=0):
    rng = np.random.default_rng(seed)
    return api.FitResult(
        W=rng.uniform(0, 0.5, (m, K)).astype(np.float32),
        H=rng.uniform(0, 0.5, (n, K)).astype(np.float32),
        trace_epochs=np.zeros(0), trace_rmse=np.zeros(0), epochs_done=0)


def _session(prob, cfg=None, faults=None, **kw):
    return tapi.StreamingSession(prob, cfg or _cfg(), faults=faults,
                                 warm_start=_warm(tapi), device=CPU, **kw)


def _assert_same_factors(a, b):
    Wa, Ha = a._eng.factors()
    Wb, Hb = b._eng.factors()
    tol.assert_bitwise(Wa, Wb, "W")
    tol.assert_bitwise(Ha, Hb, "H")


# --------------------------------------------------------------------- #
# runtime modules: equal to the reference                                #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("seed", range(4))
def test_replan_on_failure_matches_reference(seed):
    rng = np.random.default_rng(seed)
    p, m, nb = 6, 50, 16
    row_owner = rng.integers(0, p, m).astype(np.int64)
    failed = rng.choice(p, size=2, replace=False)
    weights = rng.integers(1, 20, m).astype(float) if seed % 2 else None
    got = telastic.replan_on_failure(
        telastic.initial_plan(p, row_owner, nb, seed=seed), failed,
        row_weights=weights, seed=seed)
    want = relastic.replan_on_failure(
        relastic.initial_plan(p, row_owner, nb, seed=seed), failed,
        row_weights=weights, seed=seed)
    for f in ("alive", "row_owner", "block_owner"):
        tol.assert_bitwise(getattr(got, f), getattr(want, f), f)
    assert not np.any(~got.alive[got.row_owner])
    assert telastic.shrink_data_axis(8, 3, 2) == 5


def test_straggler_monitor_matches_reference():
    rng = np.random.default_rng(0)
    a = tstraggler.StragglerMonitor(8, threshold=1.4, min_steps=3)
    b = rstraggler.StragglerMonitor(8, threshold=1.4, min_steps=3)
    for _ in range(20):
        t = np.abs(1.0 + 0.05 * rng.normal(size=8))
        t[5] *= 2.5
        flagged = a.update(t)
        assert flagged == b.update(t)
    assert flagged == [5]
    tol.assert_bitwise(a.speed_estimates(), b.speed_estimates())
    assert a.utilization_penalty(t) == b.utilization_penalty(t)


def test_chaos_scripts_match_reference():
    for args, kw in (((7, 12, 4), {}),
                     ((11, 60, 4), dict(bitflip_prob=0.25, nan_prob=0.25))):
        got = tchaos.seeded_script(*args, **kw)
        want = rchaos.seeded_script(*args, **kw)
        assert [dataclasses.astuple(e) for e in got] \
            == [dataclasses.astuple(e) for e in want]
    got = tchaos.seeded_link_script(3, 100.0, n_events=8, p=5)
    want = rchaos.seeded_link_script(3, 100.0, n_events=8, p=5)
    assert [dataclasses.astuple(e) for e in got] \
        == [dataclasses.astuple(e) for e in want]
    kinds = {e.action for e in tchaos.seeded_script(11, 60, 4,
                                                    bitflip_prob=0.25,
                                                    nan_prob=0.25)}
    assert {"bitflip", "nan"} <= kinds
    link = tchaos.DegradedLink(got[:3], drop=0.1, corrupt=0.2)
    rlink = rchaos.DegradedLink(want[:3], drop=0.1, corrupt=0.2)
    s, r = link.state(4), rlink.state(4)
    for t in np.linspace(0, 100, 25):
        assert s.draw(1, 2, t) == r.draw(1, 2, t)
    with pytest.raises(ValueError):
        tchaos.LinkEvent("teleport")
    with pytest.raises(ValueError):
        tchaos.DegradedLink(drop=1.0)


def test_envelope_bytes_match_reference():
    for j, ver in ((0, 0), (17, 3), (2 ** 40, 9)):
        pay = ttransport.encode_item(j, ver)
        assert pay == rtransport.encode_item(j, ver)
        assert ttransport.decode_item(pay) == (j, ver)
        env = ttransport.seal(1, 2, 5, pay)
        renv = rtransport.seal(1, 2, 5, pay)
        assert dataclasses.astuple(env) == dataclasses.astuple(renv)
        assert env.verify() and not env.corrupted(13).verify()
        assert ttransport.flip_bit(pay, 13) == rtransport.flip_bit(pay, 13)
    with pytest.raises(ValueError, match="malformed"):
        ttransport.decode_item(b"abc")
    led = ttransport.ItemLedger(4)
    v = led.launch(2)
    assert led.accept(2, v) and not led.accept(2, v)
    cfg = ttransport.TransportConfig()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        rtransport.TransportConfig())


# --------------------------------------------------------------------- #
# transitions: byte for byte against the reference                       #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("spread", ["balance", "minimal"])
@pytest.mark.parametrize("kind", ["kill", "join", "shrink2", "killjoin"])
def test_repack_transition_matches_reference(kind, spread):
    m, n, nnz, p = 60, 24, 700, 4
    rows, cols, vals = strategies.coo_problem(3, m, n, nnz)
    kw = dict(waves=True, schedule="random", schedule_seed=2)
    bt = tpart.pack(rows, cols, vals, m, n, p, **kw)
    br = rpart.pack(rows, cols, vals, m, n, p, **kw)
    alive = np.ones(p, dtype=bool)
    join = {"join": 2, "killjoin": 1}.get(kind, 0)
    alive[{"kill": [1], "shrink2": [0, 3], "killjoin": [2]}.get(kind, [])] \
        = False
    tkw = dict(alive=alive, join=join,
               row_weights=np.bincount(rows, minlength=m),
               col_weights=np.bincount(cols, minlength=n), spread=spread)
    tt = t_compile(p, bt.row_owner, bt.col_block, **tkw)
    tr = r_compile(p, br.row_owner, br.col_block, **tkw)
    for f in ("row_owner", "col_block", "moved_rows", "moved_cols",
              "new_of_old", "old_of_new"):
        tol.assert_bitwise(getattr(tt, f), getattr(tr, f), f)
    inc = tpart.repack_transition(bt, rows, cols, vals, tt)
    assert_same_packing(inc, rpart.repack_transition(br, rows, cols, vals,
                                                     tr))
    assert_same_packing(inc, tpart.pack(
        rows, cols, vals, m, n, tt.p_new, waves=True,
        row_owner=inc.row_owner, col_block=inc.col_block,
        schedule=inc.schedule))


# --------------------------------------------------------------------- #
# an elastic script against the reference, within the tolerance tier     #
# --------------------------------------------------------------------- #

def test_elastic_script_matches_reference():
    """fit / arrive / leave / join / kill through both sessions from the
    same factors: the same serial orders, so the same optimization."""
    tp, rp = _problems()
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        ts = tapi.StreamingSession(
            tp, _cfg(), warm_start=_warm(tapi), device=CPU,
            faults=tapi.FaultPolicy(checkpoint_dir=d1, checkpoint_every=2))
        rs = rapi.StreamingSession(
            rp, _cfg(rapi, impl="wave"), warm_start=_warm(rapi),
            faults=rapi.FaultPolicy(checkpoint_dir=d2, checkpoint_every=2))
        traces = []
        for s in (ts, rs):
            rmse = [s.fit().trace_rmse[-1]]
            s.arrive([5, 61], [3, 24], [0.4, 0.2], m_new=2, n_new=1)
            s.resize(leave=(1,))
            rmse.append(s.fit().trace_rmse[-1])
            s.resize(join=2)
            rmse.append(s.fit(epochs=2).trace_rmse[-1])
            s.kill(0)
            rmse.append(s.fit().trace_rmse[-1])
            traces.append(rmse)
        assert ts.config.p == rs.config.p == 4
        assert ts.result.epochs_done == rs.result.epochs_done == 6
        tol.assert_convergence_equivalent(traces[0], traces[1], rel=1e-4)
        n_upd = 6 * ts.problem.nnz / (ts.problem.m + ts.problem.n)
        for a, b in zip(ts._eng.factors(), rs._eng.factors()):
            tol.assert_factors_close(a, b, dtype_policy="fp32",
                                     n_updates=n_upd)
        tol.assert_bitwise(ts._eng.br.row_owner, rs._eng.br.row_owner)
        tol.assert_bitwise(ts._eng.br.schedule_order(),
                           rs._eng.br.schedule_order())


# --------------------------------------------------------------------- #
# inside the port, bitwise                                               #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("spread", ["balance", "minimal"])
def test_resize_preserves_factors_bitwise(spread):
    tp, _ = _problems()
    sess = _session(tp)
    sess.fit()
    W0, H0 = sess._eng.factors()
    tr = sess.resize(leave=(2,), spread=spread)
    assert tr.p_new == 3 and sess.config.p == 3
    assert set(sess.timings) >= {"repack_transition", "migrate"}
    for _ in range(2):
        W1, H1 = sess._eng.factors()
        tol.assert_bitwise(W0, W1, "W")
        tol.assert_bitwise(H0, H1, "H")
        sess.resize(join=2, spread=spread)
    assert sess.config.p == 7
    assert np.isfinite(sess.fit().trace_rmse).all()
    # resize(mesh=) moves onto an McMesh (tests/test_torch_spmd_elastic.py);
    # anything else is refused before the re-pack
    with pytest.raises(TypeError, match="McMesh"):
        sess.resize(leave=(0,), mesh=object())
    with pytest.raises(ValueError):
        sess.resize(p_new=3, join=1)


@pytest.mark.parametrize("impl", ["wave_pallas", "xla"])
def test_kill_recovery_bitwise_equals_graceful(impl):
    """A worker killed mid-run and recovered from the last checkpoint +
    round replay lands bitwise on a graceful departure of the same
    worker, and the two stay equal afterwards."""
    tp, _ = _problems()
    with tempfile.TemporaryDirectory() as d:
        a = _session(tp, _cfg(impl=impl), tapi.FaultPolicy(
            checkpoint_dir=d, checkpoint_every=2))
        b = _session(tp, _cfg(impl=impl))
        for s in (a, b):
            s.fit()
            s.arrive([5], [3], [4.0], epochs=2)
            s.fit(epochs=1)
        a.kill(2)
        b.resize(leave=(2,))
        _assert_same_factors(a, b)
        assert a.result.epochs_done == b.result.epochs_done
        assert set(a.timings) >= {"restore", "replay", "checkpoint"}
        ra, rb = a.fit(epochs=1), b.fit(epochs=1)
        tol.assert_bitwise(ra.W, rb.W)
        tol.assert_bitwise(ra.trace_rmse, rb.trace_rmse)


@pytest.mark.parametrize("seed", [0, 3])
def test_random_elastic_script_kill_equals_graceful(seed):
    ops = strategies.elastic_script(seed, 4, 6)
    tp = tapi.MCProblem.synthetic(40, 16, 400, k=3, seed=seed % 7)

    def run(graceful):
        faults = None if graceful else tapi.FaultPolicy(
            checkpoint_dir=tempfile.mkdtemp(dir=d))
        sess = tapi.StreamingSession(
            tp, _cfg(), faults=faults, device=CPU,
            warm_start=_warm(tapi, 40, 16, seed))
        sess.fit()
        for op, arg in ops:
            if op == "fit":
                sess.fit(epochs=arg)
            elif op == "leave" or (op == "kill" and graceful):
                sess.resize(leave=(arg,))
            elif op == "join":
                sess.resize(join=arg)
            else:
                sess.kill(arg)
        return sess

    with tempfile.TemporaryDirectory() as d:
        _assert_same_factors(run(False), run(True))


def test_crash_resume_equals_uninterrupted():
    """``solve(faults=)``: a run cut after 2 epochs and resumed for 3
    equals the uninterrupted 3-epoch run in W, H and trace."""
    tp, _ = _problems()
    warm = _warm(tapi)
    full = tapi.solve(tp, _cfg(epochs=3), warm_start=warm, device=CPU)
    with tempfile.TemporaryDirectory() as d:
        f = tapi.FaultPolicy(checkpoint_dir=d, checkpoint_every=1)
        tapi.solve(tp, _cfg(epochs=2), warm_start=warm, device=CPU,
                   faults=f)
        res = tapi.solve(tp, _cfg(epochs=3), warm_start=warm, device=CPU,
                         faults=f)
        for x in ("W", "H", "trace_rmse", "trace_epochs"):
            tol.assert_bitwise(getattr(res, x), getattr(full, x), x)
        assert res.epochs_done == 3
        with pytest.raises(ValueError, match="different config"):
            tapi.solve(tp, _cfg(epochs=3, p=2), warm_start=warm,
                       device=CPU, faults=f)
    with pytest.raises(TypeError):
        tapi.solve(tp, _cfg(), device=CPU, faults=object())


def test_reference_faulted_checkpoint_resumes_in_port():
    """A ``solve(faults=)`` block checkpointed by the reference resumes
    in the port: the restored epochs are the reference's, and the run
    ends within tolerance of the reference's uninterrupted run."""
    tp, rp = _problems()
    full = rapi.solve(rp, _cfg(rapi, "wave_pallas", epochs=3),
                      warm_start=_warm(rapi))
    with tempfile.TemporaryDirectory() as d:
        first = rapi.solve(rp, _cfg(rapi, "wave_pallas", epochs=2),
                           warm_start=_warm(rapi),
                           faults=rapi.FaultPolicy(checkpoint_dir=d))
        res = tapi.solve(tp, _cfg(epochs=3), warm_start=_warm(tapi),
                         device=CPU,
                         faults=tapi.FaultPolicy(checkpoint_dir=d))
    tol.assert_bitwise(res.trace_rmse[:2], first.trace_rmse, "restored")
    np.testing.assert_allclose(res.trace_rmse, full.trace_rmse, rtol=1e-5)
    for a, b in ((res.W, full.W), (res.H, full.H)):
        tol.assert_factors_close(a, np.asarray(b), dtype_policy="fp32",
                                 n_updates=3 * tp.nnz / (tp.m + tp.n))


def test_log_compaction_bounds_log_and_stays_bitwise():
    tp, _ = _problems()
    with tempfile.TemporaryDirectory() as d:
        a = _session(tp, faults=tapi.FaultPolicy(
            checkpoint_dir=d, checkpoint_every=1, keep=2))
        b = _session(tp)
        for s in (a, b):
            for _ in range(7):
                s.fit()
        assert a._base_round >= 5
        assert len(a._replay_log) <= 2
        a.kill(1)
        b.resize(leave=(1,))
        _assert_same_factors(a, b)
        ra, rb = a.fit(epochs=1), b.fit(epochs=1)
        tol.assert_bitwise(ra.W, rb.W)
        tol.assert_bitwise(ra.trace_rmse, rb.trace_rmse)


def test_bitflipped_newest_checkpoint_never_boots():
    """With the newest checkpoint bit-flipped, recovery quarantines it,
    falls back to an older verified step (past the compaction base) and
    still equals the graceful run."""
    tp, _ = _problems()
    with tempfile.TemporaryDirectory() as d:
        a = _session(tp, faults=tapi.FaultPolicy(
            checkpoint_dir=d, checkpoint_every=1, keep=3))
        b = _session(tp)
        for s in (a, b):
            for _ in range(6):
                s.fit()
        assert a._base_round > 0
        flipped = tchaos.bitflip_checkpoint(d, seed=1)
        assert flipped == 6
        a.kill(2)
        assert os.path.isdir(os.path.join(d, f"step_{flipped:08d}.corrupt"))
        b.resize(leave=(2,))
        _assert_same_factors(a, b)


def _divergent(**kw):
    return _cfg(alpha=1e6, beta=0.0, **kw)


def test_divergence_rollback_replays_identically_through_kill():
    div = tapi.DivergencePolicy(max_rollbacks=3, backoff=1e-4)
    tp, _ = _problems()
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        a, b = (_session(tp, _divergent(), tapi.FaultPolicy(
            checkpoint_dir=d, checkpoint_every=100, divergence=div))
            for d in (d1, d2))
        for s in (a, b):
            res = s.fit()
            assert res.extras["divergence"]["rollbacks"] >= 1
            assert res.extras["divergence"]["finite"]
            s.fit()
        a.kill(1)              # no checkpoint yet: cold replay re-trips
        b.resize(leave=(1,))
        _assert_same_factors(a, b)
        assert np.isfinite(a._eng.factors()[0]).all()
    with tempfile.TemporaryDirectory() as d:
        sess = _session(tp, _divergent(), tapi.FaultPolicy(
            checkpoint_dir=d, divergence=tapi.DivergencePolicy(
                max_rollbacks=1, backoff=0.99)))
        with pytest.raises(tapi.DivergenceError):
            sess.fit()


def test_solve_divergence_rollback_and_exhaustion():
    tp, _ = _problems()
    cfg = _divergent(epochs=2)
    with tempfile.TemporaryDirectory() as d:
        res = tapi.solve(tp, cfg, device=CPU, warm_start=_warm(tapi),
                         faults=tapi.FaultPolicy(
                             checkpoint_dir=d, checkpoint_every=1,
                             divergence=tapi.DivergencePolicy(
                                 max_rollbacks=4, backoff=1e-4)))
        assert np.isfinite(res.W).all()
        assert res.extras["divergence"]["rollbacks"] >= 1
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(tapi.DivergenceError):
            tapi.solve(tp, cfg, device=CPU, warm_start=_warm(tapi),
                       faults=tapi.FaultPolicy(
                           checkpoint_dir=d, checkpoint_every=1,
                           divergence=tapi.DivergencePolicy(
                               max_rollbacks=1, backoff=0.99)))


def test_integrity_gauntlet_recovers():
    """Checkpoint bitflips, kills, a join, a slowdown and a NaN written
    in place into the live shards, through the chaos harness: corrupted
    steps are quarantined, the NaN round rolls back, and the session
    ends finite.  A ``mesh_factory`` that moves the engine onto the
    local executor (``None``) at every change gives the same factors
    bit for bit (an ``McMesh`` factory: tests/test_torch_spmd_elastic.py)."""
    events = [tchaos.ChaosEvent(1, "slow", 1, factor=2.0),
              tchaos.ChaosEvent(2, "bitflip"),
              tchaos.ChaosEvent(2, "kill", 2),
              tchaos.ChaosEvent(3, "join"),
              tchaos.ChaosEvent(4, "bitflip"),
              tchaos.ChaosEvent(4, "kill", 0),
              tchaos.ChaosEvent(5, "nan")]
    tp, _ = _problems()
    factors, rmse = [], []
    for factory in (None, lambda p: None):
        with tempfile.TemporaryDirectory() as d:
            sess = _session(tp, faults=tapi.FaultPolicy(
                checkpoint_dir=d, checkpoint_every=1, monitor=True,
                divergence=tapi.DivergencePolicy(max_rollbacks=3)))
            sess.fit()
            report = tchaos.ChaosHarness(sess, events, seed=5,
                                         mesh_factory=factory).run()
            assert np.isfinite(report.rmse).all() and len(report.rmse) == 6
            assert [r.action for r in report.recoveries] == ["kill", "join",
                                                             "kill"]
            assert any(f.endswith(".corrupt") for f in os.listdir(d))
            assert sess.history[-1].extras["divergence"]["rollbacks"] >= 1
            W, H = sess._eng.factors()
            assert np.isfinite(W).all() and np.isfinite(H).all()
            factors.append((W, H))
            rmse.append(report.rmse)
    tol.assert_bitwise(factors[1][0], factors[0][0], "W")
    tol.assert_bitwise(factors[1][1], factors[0][1], "H")
    assert rmse[1] == rmse[0]


def test_straggler_policy_through_the_session():
    """``observe_step_times`` ejects a flagged straggler, and a schedule
    adapted to live speeds still kill-recovers bitwise."""
    tp, _ = _problems()
    with tempfile.TemporaryDirectory() as d:
        sess = _session(tp, faults=tapi.FaultPolicy(
            checkpoint_dir=d, monitor=True, eject=True))
        sess.fit()
        flagged = []
        for _ in range(6):
            flagged = sess.observe_step_times([1.0, 1.0, 5.0, 1.0])
            if flagged:
                break
        assert flagged == [2] and sess.config.p == 3
        sess.fit()

    def adapted(d):
        s = _session(tp, _cfg(schedule="balanced"), tapi.FaultPolicy(
            checkpoint_dir=d, monitor=True, adapt_schedule=True))
        s.fit()
        for _ in range(6):
            s.observe_step_times([1.0, 1.0, 2.5, 1.0])
        s.fit()
        return s

    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        a, b = adapted(d1), adapted(d2)
        assert a.config.schedule.name == "balanced"
        a.kill(3)
        b.resize(leave=(3,))
        _assert_same_factors(a, b)
    with pytest.raises(RuntimeError, match="monitoring is off"):
        _session(tp).observe_step_times([1.0] * 4)


@pytest.mark.parametrize("kw", [dict(max_rollbacks=0), dict(backoff=1.0),
                                dict(spike_factor=0.5)])
def test_policy_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        rapi.DivergencePolicy(**kw)
    with pytest.raises(ValueError):
        tapi.DivergencePolicy(**kw)
    for bad in (dict(checkpoint_dir=""), dict(checkpoint_every=0),
                dict(keep=0), dict(threshold=1.0)):
        args = dict(dict(checkpoint_dir="d"), **bad)
        with pytest.raises(ValueError):
            tapi.FaultPolicy(**args)
        with pytest.raises(ValueError):
            rapi.FaultPolicy(**args)
    with pytest.raises(TypeError):
        tapi.FaultPolicy(checkpoint_dir="d", divergence="strict")
    assert [f.name for f in dataclasses.fields(tapi.FaultPolicy)] \
        == [f.name for f in dataclasses.fields(rapi.FaultPolicy)]
