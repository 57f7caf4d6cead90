"""NOMAD's streaming, elastic and fault-tolerant paths on the port's SPMD
mesh: ``StreamingSession(mesh=)`` with arrivals, a leave, a join and
kills (``resize``/``kill`` onto sub-meshes of one launch, a bit-flipped
checkpoint among them), ``partial_fit(mesh=)`` chains,
``solve(faults=, mesh=)`` crash-resume and ``ChaosHarness(mesh_factory=)``
in ranks started by ``launch.mesh.spawn_ranks`` on the CPU (gloo).

Held bitwise (every rank's factor digest and RMSE trace, op by op)
against the same calls in the port on one CPU device
(``testing.run_script`` runs both), and the reference's own contracts
bitwise on the mesh: kill recovery equals graceful departure, crash-resume
equals the uninterrupted run, the ``partial_fit`` chain equals the
session.  A checkpoint the mesh wrote restores in the port and in the
JAX reference.  Held within ``tolerance.assert_factors_close`` against
the JAX reference's session on the same inputs, run in one subprocess
with a forced host-device count: its local session, and its mesh session
(``mesh=make_mc_mesh(p)`` at every change) as far as that one runs.

No process group is initialised in the pytest process: one spawn runs
every mesh case, with a hard timeout.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import tolerance as tol

from repro_torch import api as tapi
from repro_torch import testing as ttesting
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.core.stepsize import PowerSchedule as TPower
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.launch import mesh as tmesh
from repro_torch.runtime.chaos import ChaosEvent

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
P, K, M, N, NNZ, N_TEST = 4, 8, 96, 48, 1500, 150
LAM, ALPHA, BETA = 0.05, 0.05, 0.05
#: seconds the spawn (and the reference's subprocess) may take
SPAWN_TIMEOUT = 150

#: the session's script: phase 8's sequence of ``chip_smoke.py`` at p=4
#: (``("arrive", i)`` is arrival batch ``i``)
SCRIPT = [("arrive", 0), ("arrive", 1), ("leave", (1,)), ("fit", None),
          ("join", 1), ("fit", None), ("kill", (2,)), ("fit", None),
          ("bitflip", 8), ("kill", (0,))]
#: a resize under ``sub_blocks=2`` (its re-packs are full packs)
SUB_SCRIPT = [("arrive", 0), ("leave", (2,)), ("fit", None), ("join", 1),
              ("fit", None)]
IMPLS = ["wave_pallas", "pallas", "xla"]
CHAOS_EVENTS = [ChaosEvent(1, "leave", 1), ChaosEvent(2, "join"),
                ChaosEvent(3, "kill", 0), ChaosEvent(4, "nan")]
FAULT_EPOCHS, FAULT_CUT = 3, 2


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(23)

    def ratings(count, m, n):
        return (rng.integers(0, m, count), rng.integers(0, n, count),
                rng.normal(size=count).astype(np.float32))

    problem = dict(zip(("rows", "cols", "vals"), ratings(NNZ, M, N)),
                   m=M, n=N, test=ratings(N_TEST, M, N))
    scale = 1 / np.sqrt(K)
    W0 = rng.uniform(0, scale, (M, K)).astype(np.float32)
    H0 = rng.uniform(0, scale, (N, K)).astype(np.float32)
    batches, m, n = [], M, N
    for count, m_new, n_new in ((120, 3, 2), (90, 2, 1)):
        m, n = m + m_new, n + n_new
        r, c, v = ratings(count, m, n)
        batches.append(dict(rows=r, cols=c, vals=v, m_new=m_new,
                            n_new=n_new, test=ratings(12, m, n)))
    return dict(problem=problem, W0=W0, H0=H0, batches=batches)


def _warm(d):
    return dict(W=d["W0"], H=d["H0"], trace_epochs=np.zeros(0),
                trace_rmse=np.zeros(0), epochs_done=0)


def _config(kernel="wave_pallas", **kw):
    return tapi.NomadConfig(k=K, p=P, lam=LAM, epochs=1, seed=1,
                            kernel=kernel, stepsize=TPower(ALPHA, BETA),
                            **kw)


def _script(d, script):
    return [(op, d["batches"][arg] if op == "arrive" else arg)
            for op, arg in script]


def _runs(d, where, tmp):
    """Every case's run, keyed by its name; checkpoint directories of
    their own under ``tmp/where``."""
    def ckpt(name):
        path = tmp / where / name
        path.mkdir(parents=True)
        return str(path)

    runs = {}
    for impl in IMPLS:
        runs["session", impl] = dict(
            kind="session", problem=d["problem"], config=_config(impl),
            warm=_warm(d), script=_script(d, SCRIPT),
            keep_factors=impl == "wave_pallas",
            faults=tapi.FaultPolicy(checkpoint_dir=ckpt(f"session_{impl}"),
                                    keep=2))
    runs["session", "sub_blocks"] = dict(
        kind="session", problem=d["problem"],
        config=_config(KernelPolicy(impl="pallas", sub_blocks=2)),
        warm=_warm(d), script=_script(d, SUB_SCRIPT))
    for name, cfg in (("nomad", _config()),
                      ("dsgd", tapi.DsgdConfig(k=K, p=P, epochs=1,
                                               lam=LAM, seed=1))):
        runs["partial_fit", name] = dict(
            kind="partial_fit", problem=d["problem"], config=cfg,
            warm=dict(_warm(d), config=cfg), batches=d["batches"])
    runs["faults"] = dict(kind="faults", problem=d["problem"],
                          config=dataclasses.replace(
                              _config(), epochs=FAULT_EPOCHS),
                          cut=FAULT_CUT, ckpt=ckpt("faults"))
    runs["chaos"] = dict(
        kind="chaos", problem=d["problem"], config=_config(),
        warm=_warm(d), events=CHAOS_EVENTS, seed=5,
        faults=tapi.FaultPolicy(
            checkpoint_dir=ckpt("chaos"), checkpoint_every=1,
            divergence=tapi.DivergencePolicy(max_rollbacks=3)))
    return runs


def _reference(d, out_dir):
    """Start the JAX reference's session on :data:`SCRIPT` (``kernel``
    xla) in a subprocess with :data:`P` forced host devices: its local
    session, and its mesh session (``make_mc_mesh(p)`` at every change)
    until an op raises.  Returns the process and where it writes each
    op's factors (``local_W{i}``, ``mesh_W{i}``, ...) and the mesh
    session's error."""
    inp = os.path.join(out_dir, "ref_in.npz")
    out = os.path.join(out_dir, "ref_out.npz")
    pr = d["problem"]
    arrays = dict(rows=pr["rows"], cols=pr["cols"], vals=pr["vals"],
                  W0=d["W0"], H0=d["H0"])
    for name, a in zip(("tr", "tc", "tv"), pr["test"]):
        arrays[name] = a
    for b, batch in enumerate(d["batches"]):
        for f in ("rows", "cols", "vals"):
            arrays[f"b{b}_{f}"] = batch[f]
        for f, a in zip(("tr", "tc", "tv"), batch["test"]):
            arrays[f"b{b}_{f}"] = a
    np.savez(inp, **arrays)
    news = [(b["m_new"], b["n_new"]) for b in d["batches"]]
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={P}"
        import sys
        import tempfile
        import traceback
        sys.path.insert(0, {SRC!r})
        import jax
        import numpy as np
        assert jax.device_count() == {P}
        from repro import api
        from repro.core.stepsize import PowerSchedule
        from repro.launch.mesh import make_mc_mesh
        from repro.runtime.chaos import bitflip_checkpoint
        a = dict(np.load({inp!r}))
        news = {news!r}
        res = {{}}
        for where in ("local", "mesh"):
            ckpt = tempfile.mkdtemp(dir={out_dir!r})
            prob = api.MCProblem(a["rows"], a["cols"], a["vals"], m={M},
                                 n={N}, test=(a["tr"], a["tc"], a["tv"]))
            cfg = api.NomadConfig(k={K}, p={P}, lam={LAM}, epochs=1, seed=1,
                                  kernel="xla",
                                  stepsize=PowerSchedule({ALPHA}, {BETA}))
            warm = api.FitResult(W=a["W0"], H=a["H0"],
                                 trace_epochs=np.zeros(0),
                                 trace_rmse=np.zeros(0), epochs_done=0)
            kw = dict(mesh=make_mc_mesh({P})) if where == "mesh" else {{}}
            sess = api.StreamingSession(prob, cfg, warm_start=warm,
                                        faults=api.FaultPolicy(
                                            checkpoint_dir=ckpt, keep=2),
                                        **kw)
            for i, (op, arg) in enumerate({SCRIPT!r}):
                p = sess.config.p
                mk = {{}}
                if where == "mesh" and op in ("leave", "kill", "join"):
                    mk = dict(mesh=make_mc_mesh(p + 1 if op == "join"
                                                else p - 1))
                try:
                    if op == "arrive":
                        b = f"b{{arg}}_"
                        sess.arrive(a[b + "rows"], a[b + "cols"],
                                    a[b + "vals"], m_new=news[arg][0],
                                    n_new=news[arg][1],
                                    test=(a[b + "tr"], a[b + "tc"],
                                          a[b + "tv"]))
                    elif op == "fit":
                        sess.fit()
                    elif op == "leave":
                        sess.resize(leave=arg, **mk)
                    elif op == "join":
                        sess.resize(join=arg, **mk)
                    elif op == "kill":
                        sess.kill(*arg, **mk)
                    else:
                        bitflip_checkpoint(ckpt, seed=arg)
                    W, H = sess._eng.factors()
                except Exception:
                    res[f"{{where}}_error"] = np.array(
                        f"op {{i}} {{op}}{{arg}}: " + traceback.format_exc())
                    break
                res[f"{{where}}_W{{i}}"] = np.asarray(W, np.float32)
                res[f"{{where}}_H{{i}}"] = np.asarray(H, np.float32)
        np.savez({out!r}, **res)
    """)
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, out


@pytest.fixture(scope="module")
def cases(data, tmp_path_factory):
    """One spawn of :data:`P` CPU ranks for every mesh run (the
    reference's subprocess beside it), and the same runs on one CPU
    device in this process.  Returns ``(mesh, local, ref, runs)``: each
    case's per-rank results, its one-device result, the reference's
    arrays, and the runs (for their checkpoint directories)."""
    d = data
    tmp = tmp_path_factory.mktemp("spmd_elastic")
    ref_proc, ref_out = _reference(d, str(tmp))
    runs = _runs(d, "mesh", tmp)
    names = list(runs)
    try:
        outs = tmesh.spawn_ranks(ttesting.run_on_mesh, P,
                                 [runs[n] for n in names], "cpu",
                                 timeout=SPAWN_TIMEOUT, device="cpu")
        local = {}
        with ttesting.KernelCounts() as counts:
            for name, run in _runs(d, "local", tmp).items():
                counts.reset()
                local[name] = ttesting.run_script(run, counts, device="cpu")
    finally:
        try:
            _, err = ref_proc.communicate(timeout=SPAWN_TIMEOUT)
        except subprocess.TimeoutExpired:
            ref_proc.kill()
            raise
    assert ref_proc.returncode == 0, err
    with np.load(ref_out) as z:
        ref = dict(z)
    mesh = {n: [o[f"script{i}"] for o in outs] for i, n in enumerate(names)}
    return mesh, local, ref, runs


def _members(script, p=P):
    """Each op's expected members among the launch's ranks, as
    ``launch.mesh.ranks_after`` places the workers."""
    ranks, out = tuple(range(p)), []
    for op, arg in script:
        if op in ("leave", "kill"):
            ranks = tmesh.ranks_after(ranks, p, leave=arg)
        elif op == "join":
            ranks = tmesh.ranks_after(ranks, p, join=arg)
        out.append(ranks)
    return out


@pytest.mark.parametrize("impl", IMPLS)
def test_session_equals_one_device_bitwise(cases, impl):
    """``StreamingSession(mesh=)`` through arrivals, a leave, a join and
    two kills (the second after a bit-flipped newest checkpoint): every
    op's digest and RMSE trace on every rank equal the one-device
    session's; the bit-flipped step is quarantined."""
    mesh, local, _, _ = cases
    want = local["session", impl]["ops"]
    for r, got in enumerate(mesh["session", impl]):
        for i, (g, w) in enumerate(zip(got["ops"], want)):
            assert g["op"] == w["op"]
            assert g.get("digest") == w.get("digest"), (r, i, g["op"])
            assert g.get("trace") == w.get("trace"), (r, i, g["op"])
            assert g["p"] == w["p"]
        assert len(got["ops"]) == len(SCRIPT)
        flip = got["ops"][SCRIPT.index(("bitflip", 8))]["flipped"]
        assert flip is not None
        assert got["ops"][-1]["corrupt"] == [f"step_{flip:08d}.corrupt"]


@pytest.mark.parametrize("impl", IMPLS)
def test_session_members_run_the_kernel_idle_ranks_do_not(cases, impl):
    """A rank outside the current mesh holds no worker and makes no
    update; each member updates its cell once a step of each epoch it
    runs (a kill's replayed rounds run on the mesh before it), through
    the plain version here on CPU tensors (the stream impl calls it
    directly, uncounted), and no wrapper counts a launch on the CPU."""
    mesh, _, _, _ = cases
    placed = _members(SCRIPT)
    for r, got in enumerate(mesh["session", impl]):
        before = tuple(range(P))
        for (op, _), ranks, rec in zip(SCRIPT, placed, got["ops"]):
            assert rec["member"] == (r in ranks), (r, op)
            assert tuple(rec["ranks_before"]) == before
            assert rec["rounds"] == {"fit": 1, "arrive": 1}.get(
                op, rec["rounds"] if op == "kill" else 0), op
            assert sum(rec["launches"].values()) == 0
            want = (0 if impl == "xla" or r not in before
                    else rec["rounds"] * len(before))
            assert rec["plain"] == want, (r, op)
            before = ranks
        # the second kill restores the checkpoint before the bit-flipped
        # one and replays the round after it
        assert got["ops"][-1]["rounds"] == 1


def test_session_sub_blocks_resize_bitwise(cases):
    """``sub_blocks=2`` (the sequential route, sub-block by sub-block,
    full re-packs at each change): an arrival, a leave and a join on the
    mesh equal one device, on every rank."""
    mesh, local, _, _ = cases
    want = local["session", "sub_blocks"]["ops"]
    for got in mesh["session", "sub_blocks"]:
        assert [(g["digest"], g.get("trace")) for g in got["ops"]] == \
            [(w["digest"], w.get("trace")) for w in want]


def test_kill_equals_graceful_departure(cases):
    """Kill recovery lands on the state a graceful leave of the same
    worker reaches: the factors after each kill are the factors before
    it (a leave only moves shards), on the mesh as on one device."""
    mesh, local, _, _ = cases
    for ops in [local["session", "wave_pallas"]["ops"]] + [
            o["ops"] for o in mesh["session", "wave_pallas"]]:
        for i, (op, _) in enumerate(SCRIPT):
            if op == "kill":
                before = next(ops[j]["digest"] for j in range(i - 1, -1, -1)
                              if "digest" in ops[j])
                assert ops[i]["digest"] == before


@pytest.mark.parametrize("solver", ["nomad", "dsgd"])
def test_partial_fit_chain_on_mesh(cases, solver):
    """``partial_fit(mesh=)`` chains equal one device on every rank
    (DSGD passes the mesh on to ``solve``, which ignores it), and
    NOMAD's chain equals the session's arrivals."""
    mesh, local, _, _ = cases
    want = [(o["digest"], o["trace"])
            for o in local["partial_fit", solver]["ops"]]
    for got in mesh["partial_fit", solver]:
        assert [(o["digest"], o["trace"]) for o in got["ops"]] == want
    if solver == "nomad":
        session = local["session", "wave_pallas"]["ops"][:2]
        assert [w[0] for w in want] == [o["digest"] for o in session]


def test_faulted_solve_resumes_bitwise(cases, data):
    """``solve(faults=, mesh=)`` cut after :data:`FAULT_CUT` epochs and
    resumed equals the uninterrupted one-device ``solve``, digest and
    trace, on every rank; every member updates once a step of each
    epoch of each part."""
    mesh, local, _, _ = cases
    whole = tapi.solve(ttesting._problem(data["problem"]),
                       dataclasses.replace(_config(), epochs=FAULT_EPOCHS),
                       device="cpu")
    want = (ttesting.factor_digest(whole.W, whole.H),
            [float(x) for x in whole.trace_rmse])
    assert (local["faults"]["ops"][1]["digest"],
            local["faults"]["ops"][1]["trace"]) == want
    for got in mesh["faults"]:
        first, resumed = got["ops"]
        assert (resumed["digest"], resumed["trace"]) == want
        assert first["trace"] == want[1][:FAULT_CUT]
        assert first["plain"] == FAULT_CUT * P
        assert resumed["plain"] == (FAULT_EPOCHS - FAULT_CUT) * P


def test_chaos_harness_mesh_factory_bitwise(cases):
    """``ChaosHarness(mesh_factory=make_mc_mesh)`` with a leave, a join,
    a kill and a NaN written into worker 0's shard: the NaN round rolls
    back on every rank, and the final factors equal the same harness on
    one device."""
    mesh, local, _, _ = cases
    want = local["chaos"]
    assert want["actions"] == ["leave", "join", "kill"]
    assert want["rollbacks"] >= 1
    for got in mesh["chaos"]:
        for key in ("digest", "rmse", "p_final", "actions", "rollbacks"):
            assert got[key] == want[key], key


def test_mesh_checkpoint_restores_in_port_and_reference(cases):
    """The checkpoints the mesh wrote (its lead rank alone) are the
    one-device session's, byte for byte in what they hold, and restore
    in the port and in the JAX reference."""
    from repro.checkpoint import checkpoint as rckpt
    _, _, _, runs = cases
    mesh_dir = runs["session", "wave_pallas"]["faults"].checkpoint_dir
    local_dir = mesh_dir.replace(os.sep + "mesh" + os.sep,
                                 os.sep + "local" + os.sep)
    steps = tckpt.committed_steps(mesh_dir)
    assert steps and steps == tckpt.committed_steps(local_dir)
    for step in steps:
        got, _ = tckpt.restore_fit_result(mesh_dir, step)
        want, _ = tckpt.restore_fit_result(local_dir, step)
        ref, _ = rckpt.restore_fit_result(mesh_dir, step)
        for name in ("W", "H", "trace_epochs", "trace_rmse"):
            tol.assert_bitwise(getattr(got, name), getattr(want, name),
                               name)
            tol.assert_bitwise(np.asarray(getattr(ref, name)),
                               getattr(got, name), f"reference {name}")
        assert got.epochs_done == want.epochs_done == ref.epochs_done
        assert got.config == want.config
        assert ref.config.p == got.config.p and ref.config.k == K


def _n_updates(epochs):
    return epochs * max(NNZ / M, NNZ / N)


@pytest.mark.parametrize("where", ["local", "mesh"])
def test_session_against_the_reference(cases, data, where):
    """The port's mesh session within ``assert_factors_close`` of the
    reference's session, op by op, on every rank: the reference's local
    session over the whole script, and its mesh session over the ops it
    ran (its second kill rebuilds the engine on the session's first
    mesh, which no longer fits the worker count: a reference fault,
    ROADMAP Queue 3).  A no-update control lies outside the bound."""
    mesh, _, ref, _ = cases
    d = data
    ran = [i for i in range(len(SCRIPT)) if f"{where}_W{i}" in ref]
    if where == "local":
        assert "local_error" not in ref and len(ran) == len(SCRIPT)
    else:
        assert len(ran) >= SCRIPT.index(("kill", (2,))) + 1
    for r, got in enumerate(mesh["session", "wave_pallas"]):
        epochs = 0
        for i in ran:
            epochs += SCRIPT[i][0] in ("fit", "arrive")
            if SCRIPT[i][0] == "bitflip":
                continue
            for name in ("W", "H"):
                tol.assert_factors_close(
                    got["ops"][i][name], ref[f"{where}_{name}{i}"],
                    dtype_policy="fp32", n_updates=_n_updates(epochs),
                    what=f"rank {r} op {i} {name}")
    with pytest.raises(AssertionError, match="exceeds"):
        tol.assert_factors_close(d["W0"], ref[f"{where}_W{ran[-1]}"][:M],
                                 dtype_policy="fp32",
                                 n_updates=_n_updates(epochs))


@pytest.mark.parametrize("ranks,world,change,want", [
    (range(8), 8, dict(leave=(3,)), (0, 1, 2, 4, 5, 6, 7)),
    ((0, 1, 2, 4, 5, 6, 7), 8, dict(join=1), (0, 1, 2, 4, 5, 6, 7, 3)),
    ((0, 1, 2, 4, 5, 6, 7, 3), 8, dict(leave=(5,)),
     (0, 1, 2, 4, 5, 7, 3)),
    ((0, 1, 2, 4, 5, 7, 3), 8, dict(leave=(0,)), (1, 2, 4, 5, 7, 3)),
    (range(4), 6, dict(join=2), (0, 1, 2, 3, 4, 5)),
    (range(4), 4, dict(leave=(0, 2), join=1), (1, 3, 0)),
])
def test_ranks_after_keeps_survivors_and_fills_idle_ranks(ranks, world,
                                                          change, want):
    """After a worker-set change the survivors keep their global ranks in
    the new worker order (``TransitionSchedule``'s: survivors first,
    joiners appended), and joining workers take the lowest idle ranks."""
    assert tmesh.ranks_after(tuple(ranks), world, **change) == want


def test_ranks_after_refuses_a_join_without_an_idle_rank():
    with pytest.raises(ValueError, match="cannot join"):
        tmesh.ranks_after(range(4), 4, join=1)


class _Lead:
    """A stand-in for one rank's ``McMesh`` in :func:`_pack_once`: the
    lead runs what ``on_lead`` is given; another rank gets the lead's
    answer (``path``)."""

    def __init__(self, lead, shared_dir, path=None):
        self.lead, self.shared_dir, self.path = lead, shared_dir, path
        self.barriers = 0

    def on_lead(self, fn):
        return fn() if self.lead else self.path

    def barrier(self):
        self.barriers += 1


def test_pack_once_builds_on_the_lead_and_maps_elsewhere(data, tmp_path):
    """On a mesh with a shared directory the lead alone builds a
    packing, keeps it and removes the files once every rank has mapped
    them; another rank maps the files, the ratings' ids included, byte for
    byte the built packing; without a shared directory every rank
    builds."""
    from repro_torch.core import partition as tpart
    pr = data["problem"]
    built = []

    def build():
        built.append(tpart.pack(pr["rows"], pr["cols"], pr["vals"], M, N,
                                P, waves=True))
        return built[-1]

    br = tapi._pack_once(None, build)
    assert len(built) == 1 and br is built[0]
    assert tapi._pack_once(_Lead(False, None), build) is built[1]

    saved = []
    real_save = tpart.save_pack

    def save_and_copy(b, path, **kw):       # keep a copy for the others
        real_save(b, path, **kw)
        real_save(b, str(tmp_path / "copy"), **kw)
        saved.append(path)

    tpart.save_pack, old = save_and_copy, tpart.save_pack
    try:
        lead = _Lead(True, str(tmp_path))
        got = tapi._pack_once(lead, build)
    finally:
        tpart.save_pack = old
    assert got is built[-1] and lead.barriers == 1
    assert not os.path.exists(saved[0])     # removed after the barrier
    other = _Lead(False, str(tmp_path), path=str(tmp_path / "copy"))
    mapped = tapi._pack_once(other, build)
    assert len(built) == 3 and other.barriers == 1
    assert os.path.exists(tmp_path / "copy")  # only the lead removes
    for f in ("rows", "cols", "vals", "mask", "wave_cnt", "gid",
              "row_owner", "col_block"):
        tol.assert_bitwise(np.asarray(getattr(mapped, f)),
                           getattr(built[-1], f), f)
