"""The port's discrete-event simulator (``repro_torch.core.async_sim``)
and its front door (``api.AsyncSimConfig``) against the JAX package's.

The simulator is float64 numpy on both sides, so for the same inputs and
seed every output is bitwise equal: factors, ``update_log``, trace,
``visit_log``, clocks and transport counters — with stragglers, failures,
rejoins, rating arrivals, a hierarchical network and a faulty link.  Each
``update_log``, replayed serially with the port's ``serial.replay_np``,
gives the simulated factors bitwise (the paper's serializability).  The
schedule ``solve(AsyncSimConfig(emit_schedule=True))`` emits is the
reference's, and the port's engine replays it within the tolerance tier
of the reference engine.  ``AsyncSimConfig`` checkpoints move between
the packages both ways.
"""
import dataclasses

import numpy as np
import pytest

import strategies
import tolerance as tol

from repro import api as rapi
from repro import checkpoint as rck
from repro.core import async_sim as rsim
from repro.core import objective as robj
from repro.core import topology as rtopo
from repro.core.stepsize import PowerSchedule as RPower
from repro.runtime import chaos as rchaos
from repro.runtime import transport as rtransport

from repro_torch import api as tapi
from repro_torch import checkpoint as tck
from repro_torch.core import async_sim as tsim
from repro_torch.core import serial as tserial
from repro_torch.core import topology as ttopo
from repro_torch.core.stepsize import PowerSchedule as TPower
from repro_torch.runtime import chaos as tchaos
from repro_torch.runtime import transport as ttransport

M, N, NNZ, K = 40, 20, 300, 6


def _case(name, side):
    """SimConfig keywords of case ``name`` built from ``side``'s modules
    (the reference's or the port's own types)."""
    topo, chaos, transport = side
    late = np.arange(NNZ - 90, NNZ)
    return {
        "plain": dict(p=3),
        "stragglers": dict(p=4, speed=np.array([1.0, 2.5, 4.0, 1.5])),
        "load_balance": dict(p=4, load_balance=True,
                             speed=np.array([1.0, 3.0, 1.0, 1.0])),
        "failures": dict(p=4, failures=((50.0, 0), (120.0, 2))),
        "rejoins": dict(p=3, epochs=3.0, failures=((50.0, 0),),
                        rejoins=((400.0, 0),)),
        "arrivals": dict(p=3, arrivals=((80.0, tuple(late[:45])),
                                        (300.0, tuple(late[45:])))),
        "mesh": dict(p=4, topology=topo.HierarchicalMesh(
            p=4, workers_per_node=2)),
        "link_faults": dict(p=3, transport=transport.TransportConfig(),
                            link_faults=chaos.DegradedLink(
                                [chaos.LinkEvent("drop", t1=60.0)],
                                dup=0.1, reorder=0.1, corrupt=0.05)),
    }[name]


REF = (rtopo, rchaos, rtransport)
PORT = (ttopo, tchaos, ttransport)
CASES = ["plain", "stragglers", "load_balance", "failures", "rejoins",
         "arrivals", "mesh", "link_faults"]


def _inputs(seed):
    rows, cols, vals = strategies.coo_problem(seed, M, N, NNZ)
    W0, H0 = robj.init_factors_np(seed, M, N, K)
    test = strategies.coo_problem(seed + 100, M, N, 60)
    return rows, cols, vals, W0, H0, test


def _sim_config(mod, power, side, name, seed):
    kw = dict(k=K, lam=0.01, schedule=power(0.02, 0.1), epochs=2.0,
              seed=seed)
    kw.update(_case(name, side))
    return mod.SimConfig(**kw)


def assert_same_sim(a, b):
    tol.assert_bitwise(a.W, b.W, "W")
    tol.assert_bitwise(a.H, b.H, "H")
    tol.assert_bitwise(np.asarray(a.busy_time), np.asarray(b.busy_time),
                       "busy_time")
    assert a.update_log == b.update_log
    assert a.trace == b.trace
    assert a.visit_log == b.visit_log
    assert (a.n_updates, a.sim_time, a.throughput, a.transport) == (
        b.n_updates, b.sim_time, b.throughput, b.transport)


def _replay(res, rows, cols, vals, W0, H0, sched, lam):
    """``res.update_log`` in execution order (start time, then log
    position), each update at its rating's own step size (the count of
    its earlier updates), through the port's ``replay_np``."""
    idx = sorted(range(len(res.update_log)),
                 key=lambda t: (res.update_log[t][0], t))
    order = np.array([res.update_log[t][1] for t in idx], dtype=np.int64)
    seen = {}
    lrs = np.empty(len(order))
    for t, g in enumerate(order):
        c = seen.get(g, 0)
        lrs[t] = sched(c)
        seen[g] = c + 1
    return tserial.replay_np(W0, H0, rows, cols, vals, order, lrs, lam)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("seed", [0, 7])
def test_nomad_simulator_is_bitwise_the_reference(name, seed):
    rows, cols, vals, W0, H0, test = _inputs(seed)
    ct = _sim_config(tsim, TPower, PORT, name, seed)
    cr = _sim_config(rsim, RPower, REF, name, seed)
    got = tsim.NomadSimulator(ct, M, N, rows, cols, vals, W0, H0,
                              test=test).run()
    want = rsim.NomadSimulator(cr, M, N, rows, cols, vals, W0, H0,
                               test=test).run()
    assert got.n_updates > 0
    assert_same_sim(got, want)
    Wr, Hr = _replay(got, rows, cols, vals, W0, H0, ct.schedule, ct.lam)
    tol.assert_bitwise(Wr, got.W, "replayed W")
    tol.assert_bitwise(Hr, got.H, "replayed H")


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("straggle", [False, True])
def test_dsgd_simulator_is_bitwise_the_reference(overlap, straggle):
    rows, cols, vals, W0, H0, test = _inputs(3)
    speed = np.array([1.0, 3.0, 1.0]) if straggle else None
    kw = dict(p=3, k=K, lam=0.01, epochs=1.5, seed=3, speed=speed)
    ct = tsim.SimConfig(schedule=TPower(0.02, 0.1), **kw)
    cr = rsim.SimConfig(schedule=RPower(0.02, 0.1), **kw)
    got = tsim.simulate_dsgd(ct, M, N, rows, cols, vals, W0, H0, test=test,
                             overlap=overlap)
    want = rsim.simulate_dsgd(cr, M, N, rows, cols, vals, W0, H0, test=test,
                              overlap=overlap)
    assert_same_sim(got, want)
    Wr, Hr = _replay(got, rows, cols, vals, W0, H0, ct.schedule, ct.lam)
    tol.assert_bitwise(Wr, got.W, "replayed W")
    tol.assert_bitwise(Hr, got.H, "replayed H")


def test_replay_of_the_log_tells_orders_apart():
    """The bitwise replay is a real check: the log replayed with two of
    its updates swapped no longer gives the simulated factors."""
    rows, cols, vals, W0, H0, _ = _inputs(1)
    cfg = _sim_config(tsim, TPower, PORT, "plain", 1)
    res = tsim.NomadSimulator(cfg, M, N, rows, cols, vals, W0, H0).run()
    log = list(res.update_log)
    i = next(t for t in range(len(log) - 1)
             if rows[log[t][1]] == rows[log[t + 1][1]]
             and log[t][0] == log[t + 1][0])
    log[i], log[i + 1] = log[i + 1], log[i]
    swapped = dataclasses.replace(res, update_log=log)
    Wr, _ = _replay(swapped, rows, cols, vals, W0, H0, cfg.schedule, cfg.lam)
    assert not np.array_equal(Wr, res.W)


def _problems(seed=11, m=30, n=15, nnz=250):
    rows, cols, vals = strategies.coo_problem(seed, m, n, nnz)
    test = strategies.coo_problem(seed + 1, m, n, 40)
    kw = dict(rows=rows, cols=cols, vals=vals, m=m, n=n, test=test)
    return tapi.MCProblem(**kw), rapi.MCProblem(**kw)


SIM_KW = {
    "plain": dict(k=4, p=3, epochs=1.5),
    "rejoin": dict(k=4, p=3, epochs=1.5, failures=((30.0, 0),),
                   rejoins=((300.0, 0),)),
    "stragglers": dict(k=4, p=4, epochs=2.0, speed=(1.0, 3.0, 1.0, 2.0),
                       load_balance=True),
}


@pytest.mark.parametrize("case", list(SIM_KW))
def test_emit_schedule_is_the_reference_schedule(case):
    tp, rp = _problems()
    kw = dict(SIM_KW[case], emit_schedule=True,
              stepsize=None, lam=0.02, seed=5)
    got = tapi.solve(tp, tapi.AsyncSimConfig(**kw), device="cpu")
    want = rapi.solve(rp, rapi.AsyncSimConfig(**kw))
    assert got.solver == "async_sim"
    for x in ("W", "H", "trace_epochs", "trace_rmse"):
        tol.assert_bitwise(getattr(got, x), np.asarray(getattr(want, x)), x)
    assert got.epochs_done == want.epochs_done
    assert got.virtual_time == want.virtual_time
    assert got.extras["update_log"] == want.extras["update_log"]
    gs, ws = got.extras["schedule"], want.extras["schedule"]
    assert gs.p == ws.p and gs.name == ws.name
    tol.assert_bitwise(gs.table, ws.table, "schedule.table")
    tol.assert_bitwise(gs.active, ws.active, "schedule.active")
    # the emitted schedule replays every rating exactly once per epoch
    order = tp.packed(gs.p, schedule=gs).schedule_order()
    tol.assert_bitwise(np.sort(order), np.arange(tp.nnz), "order")


@pytest.mark.parametrize("kernel", ["wave_pallas", "pallas", "xla"])
def test_emitted_schedule_through_the_engine(kernel):
    """The simulator's schedule through the port's ``solve`` on the CPU
    is within the tolerance tier of the reference ``solve`` with the
    reference's schedule, from the same warm start."""
    tp, rp = _problems()
    kw = dict(k=4, p=3, epochs=1.0, emit_schedule=True, seed=5)
    ts = tapi.solve(tp, tapi.AsyncSimConfig(**kw),
                    device="cpu").extras["schedule"]
    rs = rapi.solve(rp, rapi.AsyncSimConfig(**kw)).extras["schedule"]
    rng = np.random.default_rng(5)
    W0 = rng.uniform(0, 0.5, (tp.m, 4)).astype(np.float32)
    H0 = rng.uniform(0, 0.5, (tp.n, 4)).astype(np.float32)
    warm = [api.FitResult(W=W0, H=H0, trace_epochs=np.zeros(0),
                          trace_rmse=np.zeros(0), epochs_done=0)
            for api in (tapi, rapi)]
    ckw = dict(k=4, p=3, lam=0.02, epochs=2, kernel=kernel)
    got = tapi.solve(tp, tapi.NomadConfig(schedule=ts,
                                          stepsize=TPower(0.05, 0.1), **ckw),
                     warm_start=warm[0], device="cpu")
    want = rapi.solve(rp, rapi.NomadConfig(schedule=rs,
                                           stepsize=RPower(0.05, 0.1),
                                           **ckw), warm_start=warm[1])
    n_upd = 2 * tp.nnz / (tp.m + tp.n)
    for x in "WH":
        tol.assert_factors_close(getattr(got, x), getattr(want, x),
                                 dtype_policy="fp32", n_updates=n_upd,
                                 what=x)
    np.testing.assert_allclose(got.rmse, want.rmse, rtol=1e-5)


def _same_fields(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "stepsize" and x is not None:
            assert dataclasses.asdict(x) == dataclasses.asdict(y)
        elif f.name in ("transport", "link_faults"):
            assert (x is None) == (y is None), f.name
            if x is not None:
                assert tck.checkpoint._encode_value(x) == \
                    rck.checkpoint._encode_value(y), f.name
        else:
            assert x == y, f.name


def test_async_sim_checkpoint_interchanges_with_the_reference(tmp_path):
    tp, rp = _problems()
    kw = dict(k=4, p=3, epochs=1.5, seed=2, failures=((30.0, 1),),
              rejoins=((200.0, 1),), speed=(1.0, 2.0, 1.0),
              emit_schedule=True)
    tcfg = tapi.AsyncSimConfig(
        transport=ttransport.TransportConfig(max_retries=5),
        link_faults=tchaos.DegradedLink(dup=0.2), **kw)
    rcfg = rapi.AsyncSimConfig(
        transport=rtransport.TransportConfig(max_retries=5),
        link_faults=rchaos.DegradedLink(dup=0.2), **kw)
    # reference -> port
    res = rapi.solve(rp, rcfg)
    rck.save_fit_result(str(tmp_path / "ref"), 1, res)
    got, step = tck.restore_fit_result(str(tmp_path / "ref"))
    assert step == 1 and got.solver == "async_sim"
    assert isinstance(got.config, tapi.AsyncSimConfig)
    _same_fields(got.config, rcfg)
    tol.assert_bitwise(got.W, np.asarray(res.W), "W")
    assert got.virtual_time == res.virtual_time
    tol.assert_bitwise(got.extras["schedule"].table,
                       res.extras["schedule"].table, "schedule")
    # port -> reference
    res = tapi.solve(tp, tcfg, device="cpu")
    tck.save_fit_result(str(tmp_path / "port"), 1, res)
    back, step = rck.restore_fit_result(str(tmp_path / "port"))
    assert step == 1 and isinstance(back.config, rapi.AsyncSimConfig)
    _same_fields(tcfg, back.config)
    tol.assert_bitwise(np.asarray(back.H), res.H, "H")
    # a warm start from the restored result continues as the reference's
    ref_restored, _ = rck.restore_fit_result(str(tmp_path / "ref"))
    a = tapi.solve(tp, dataclasses.replace(tcfg, epochs=0.5),
                   warm_start=got, device="cpu")
    b = rapi.solve(rp, dataclasses.replace(rcfg, epochs=0.5),
                   warm_start=ref_restored)
    tol.assert_bitwise(a.W, np.asarray(b.W), "continued W")


BAD = [
    dict(p=0),
    dict(mode="hogwild"),
    dict(mode="dsgd", emit_schedule=True),
    dict(mode="dsgd", rejoins=((1.0, 0),)),
    dict(mode="dsgd++", arrivals=((1.0, (0,)),)),
    dict(speed=(1.0, 2.0)),
    dict(rejoins=((-1.0, 0),)),
    dict(rejoins=((1.0, 9),)),
    dict(arrivals=((-2.0, (1,)),)),
    dict(k=0),
    dict(epochs=-1),
]


@pytest.mark.parametrize("kw", BAD, ids=[str(b) for b in BAD])
def test_async_sim_config_validation_is_the_reference(kw):
    with pytest.raises(ValueError) as want:
        rapi.AsyncSimConfig(**kw)
    with pytest.raises(ValueError) as got:
        tapi.AsyncSimConfig(**kw)
    assert str(got.value) == str(want.value)


def test_async_sim_config_type_checks_and_fractional_faults(tmp_path):
    for kw in (dict(transport=object()), dict(link_faults=object()),
               dict(topology=object())):
        with pytest.raises(TypeError):
            tapi.AsyncSimConfig(**kw)
    with pytest.raises(ValueError, match="only simulated for mode='nomad'"):
        tapi.AsyncSimConfig(mode="dsgd",
                            link_faults=tchaos.DegradedLink(dup=0.1))
    with pytest.raises(ValueError, match="topology is for p=4"):
        tapi.AsyncSimConfig(p=3, topology=ttopo.HierarchicalMesh(p=4))
    with pytest.raises(ValueError, match="integral"):
        tapi.NomadConfig(epochs=1.5)
    tp, _ = _problems()
    with pytest.raises(ValueError, match="faults= requires integral"):
        tapi.solve(tp, tapi.AsyncSimConfig(k=4, p=3, epochs=1.5),
                   device="cpu",
                   faults=tapi.FaultPolicy(checkpoint_dir=str(tmp_path)))
    assert "async_sim" in tapi.solver_names()
    assert tapi.config_for("async_sim") is tapi.AsyncSimConfig
    assert tapi.streaming_solver_names() == rapi.streaming_solver_names()
