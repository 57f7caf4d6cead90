"""NOMAD's SPMD executor in the port: ``NomadRingEngine(mesh=)`` and
``api.solve(mesh=)`` in ranks started by ``launch.mesh.spawn_ranks`` on
the CPU (gloo), against the port's local executor (bitwise: W, H and
the held-out RMSE trace, every rank alike) and against the JAX
reference's SPMD engine (``tolerance.assert_factors_close``: the k-dot
is reduced in another order by XLA and by torch).  The reference runs in
one subprocess with a forced host-device count, as its own distributed
tests do; both start from the same injected ``W0``/``H0`` (the
reference's threefry cold start cannot be reproduced in torch).

No process group is ever initialised in the pytest process: every rank
is a spawned process.  All SPMD runs share one spawn; the launcher's
failure cases take one each; every spawn has a hard timeout.
"""
import multiprocessing
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import tolerance as tol

from repro_torch import api as tapi
from repro_torch import testing as ttesting
from repro_torch.core import nomad as tnomad
from repro_torch.core import partition as tpart
from repro_torch.core.stepsize import PowerSchedule as TPower
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.launch import mesh as tmesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
P, K, M, N, NNZ, N_TEST, EPOCHS = 4, 8, 96, 48, 1500, 150, 2
LAM, ALPHA, BETA = 0.05, 0.05, 0.05
#: seconds a spawn may take before every rank is killed
SPAWN_TIMEOUT = 120

ENGINE_CASES = [(sched, impl, dispatch)
                for sched in ("ring", "random", "balanced")
                for impl in ("wave_pallas", "pallas", "xla")
                for dispatch in ("loop", "fused")]
SOLVE_CASES = [(sched, dispatch)
               for sched in ("ring", "random", "balanced")
               for dispatch in ("loop", "fused")]
#: solvers that accept a mesh and ignore it, as the reference's do
IGNORING = {"dsgd": tapi.DsgdConfig(k=K, p=P, epochs=EPOCHS),
            "als": tapi.AlsConfig(k=K, epochs=EPOCHS)}
#: against the reference's SPMD engine: (schedule, sub_blocks)
REF_CASES = [("ring", 1), ("random", 1), ("ring", 2), ("random", 2)]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    rows = rng.integers(0, M, NNZ)
    cols = rng.integers(0, N, NNZ)
    vals = rng.normal(size=NNZ).astype(np.float32)
    test = (rng.integers(0, M, N_TEST), rng.integers(0, N, N_TEST),
            rng.normal(size=N_TEST).astype(np.float32))
    scale = 1 / np.sqrt(K)
    W0 = rng.uniform(0, scale, (M, K)).astype(np.float32)
    H0 = rng.uniform(0, scale, (N, K)).astype(np.float32)
    return dict(train=(rows, cols, vals), test=test, W0=W0, H0=H0)


def _pack(d, sched, *, waves=True, sub_blocks=1, p=P):
    return tpart.pack(*d["train"], M, N, p, waves=waves,
                      sub_blocks=sub_blocks, schedule=sched,
                      schedule_seed=3)


def _engine_run(d, br, policy, dispatch="fused"):
    return dict(kind="engine", br=br, k=K, lam=LAM,
                stepsize=TPower(ALPHA, BETA), policy=policy, W0=d["W0"],
                H0=d["H0"], test=d["test"], epochs=EPOCHS,
                dispatch=dispatch, log_steps=True)


def _problem(d):
    return tapi.MCProblem(*d["train"], m=M, n=N, test=d["test"])


def _nomad_config(sched, dispatch):
    return tapi.NomadConfig(k=K, p=P, lam=LAM, epochs=EPOCHS,
                            kernel="wave_pallas", schedule=sched,
                            schedule_seed=3, dispatch=dispatch,
                            stepsize=TPower(ALPHA, BETA))


def _reference(d, out_dir):
    """Start the JAX reference's SPMD engine on :data:`REF_CASES` in a
    subprocess (4 forced host devices); returns the process and where it
    writes its results."""
    inp = os.path.join(out_dir, "ref_in.npz")
    out = os.path.join(out_dir, "ref_out.npz")
    np.savez(inp, *d["train"], *d["test"], d["W0"], d["H0"])
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={P}"
        import sys
        sys.path.insert(0, {SRC!r})
        import jax
        import numpy as np
        assert jax.device_count() == {P}
        from repro.core import nomad, partition
        from repro.core.stepsize import PowerSchedule
        from repro.kernels.policy import KernelPolicy
        from repro.launch.mesh import make_mc_mesh
        a = np.load({inp!r})
        rows, cols, vals, tr, tc, tv, W0, H0 = (a[f"arr_{{i}}"]
                                                 for i in range(8))
        mesh = make_mc_mesh({P})
        res = {{}}
        for i, (sched, sub) in enumerate({REF_CASES!r}):
            br = partition.pack(rows, cols, vals, {M}, {N}, {P},
                                sub_blocks=sub, schedule=sched,
                                schedule_seed=3)
            eng = nomad.NomadRingEngine(
                br=br, k={K}, lam={LAM}, stepsize=PowerSchedule({ALPHA},
                {BETA}), policy=KernelPolicy(impl="xla", sub_blocks=sub),
                mesh=mesh)
            eng.init_factors(W0, H0)
            trace = eng.train({EPOCHS}, test=(tr, tc, tv),
                              dispatch="fused")
            res[f"W{{i}}"], res[f"H{{i}}"] = eng.factors()
            res[f"trace{{i}}"] = np.array([r for _, r in trace])
        np.savez({out!r}, **res)
    """)
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, out


@pytest.fixture(scope="module")
def spmd(data, tmp_path_factory):
    """One spawn of :data:`P` CPU ranks for every SPMD run of this file
    (the reference subprocess runs beside it).  Returns the ranks'
    results, the index of each case's run, and the reference's
    results."""
    d = data
    ref_proc, ref_out = _reference(d, str(tmp_path_factory.mktemp("ref")))
    runs, index = [], {}
    for case in ENGINE_CASES:
        sched, impl, dispatch = case
        br = _pack(d, sched, waves=impl == "wave_pallas")
        index["engine", case] = len(runs)
        runs.append(_engine_run(d, br, KernelPolicy(impl=impl), dispatch))
    for case in SOLVE_CASES:
        index["solve", case] = len(runs)
        runs.append(dict(kind="solve", problem=_problem(d),
                         config=_nomad_config(*case)))
    for name, cfg in IGNORING.items():
        index["ignoring", name] = len(runs)
        runs.append(dict(kind="solve", problem=_problem(d), config=cfg))
    for case in REF_CASES:
        sched, sub = case
        index["ref", case] = len(runs)
        runs.append(_engine_run(d, _pack(d, sched, waves=False,
                                         sub_blocks=sub),
                                KernelPolicy(impl="xla", sub_blocks=sub)))
    # the packing, factors and held-out ratings from files, mapped
    # read-only by every rank (as chip_smoke.py's [11.netflix] reads them)
    files = tmp_path_factory.mktemp("files")
    tpart.save_pack(_pack(d, "balanced"), str(files / "pack"))
    for name in ("W0", "H0"):
        np.save(files / f"{name}.npy", d[name])
    for name, a in zip(("rows", "cols", "vals"), d["test"]):
        np.save(files / f"test_{name}.npy", a)
    index["files"] = len(runs)
    runs.append(dict(_engine_run(d, str(files / "pack"),
                                 KernelPolicy(impl="wave_pallas")),
                     W0=str(files / "W0.npy"), H0=str(files / "H0.npy"),
                     test=str(files / "test")))
    index["errors"] = len(runs)
    runs.append(dict(kind="errors", br=_pack(d, "ring", p=P - 2)))
    try:
        outs = tmesh.spawn_ranks(ttesting.run_on_mesh, P, runs, "cpu",
                                 timeout=SPAWN_TIMEOUT, device="cpu")
    finally:
        try:
            _, err = ref_proc.communicate(timeout=SPAWN_TIMEOUT)
        except subprocess.TimeoutExpired:
            ref_proc.kill()
            raise
    assert ref_proc.returncode == 0, err
    with np.load(ref_out) as z:
        ref = dict(z)
    return outs, index, ref


def _same_on_every_rank(outs, i, W, H, trace):
    trace = list(trace)
    for r, o in enumerate(outs):
        tol.assert_bitwise(o[f"W{i}"], W, f"rank {r} W")
        tol.assert_bitwise(o[f"H{i}"], H, f"rank {r} H")
        assert o[f"trace{i}"] == [(int(e), float(x)) for e, x in trace], r


@pytest.mark.parametrize("sched,impl,dispatch", ENGINE_CASES)
def test_engine_equals_local_bitwise(data, spmd, sched, impl, dispatch):
    """``NomadRingEngine(mesh=)`` == the local executor on the same
    packing and factors: W, H and the RMSE trace, on every rank, under
    both dispatches; the update runs once per active slot of the rank."""
    d = data
    outs, index, _ = spmd
    i = index["engine", (sched, impl, dispatch)]
    br = _pack(d, sched, waves=impl == "wave_pallas")
    eng = tnomad.NomadRingEngine(br=br, k=K, lam=LAM,
                                 stepsize=TPower(ALPHA, BETA), impl=impl,
                                 device="cpu")
    eng.init_factors(d["W0"], d["H0"])
    trace = eng.train(EPOCHS, test=d["test"], dispatch=dispatch)
    _same_on_every_rank(outs, i, *eng.factors(), trace)
    for r, o in enumerate(outs):
        assert o[f"finite{i}"] is True
        active = int(br.schedule.active[:, r].sum())
        # the kernel impls' plain version on CPU tensors, once per
        # active slot; the stream impl calls the plain version directly
        assert o[f"plain{i}"] == (0 if impl == "xla" else EPOCHS * active)
        assert sum(o[f"launches{i}"].values()) == 0
        steps = o[f"steps{i}"]
        assert len(steps) == EPOCHS * br.n_steps
        assert all(s["wall_ms"] >= s["kernel_ms"] >= 0 for s in steps)


def test_engine_from_saved_files_equals_local(data, spmd):
    """Ranks that map a ``save_pack`` directory and ``.npy`` factors and
    held-out ratings read-only equal the local executor on the packing
    in memory."""
    d = data
    outs, index, _ = spmd
    i = index["files"]
    eng = tnomad.NomadRingEngine(br=_pack(d, "balanced"), k=K, lam=LAM,
                                 stepsize=TPower(ALPHA, BETA),
                                 impl="wave_pallas", device="cpu")
    eng.init_factors(d["W0"], d["H0"])
    trace = eng.train(EPOCHS, test=d["test"])
    _same_on_every_rank(outs, i, *eng.factors(), trace)


def test_saved_pack_round_trip(data, tmp_path):
    """``load_pack`` gives back every array ``save_pack`` wrote, mapped
    read-only, and the same schedule; ``gid`` is not written."""
    br = _pack(data, "random", sub_blocks=2)
    tpart.save_pack(br, str(tmp_path))
    back = tpart.load_pack(str(tmp_path))
    for name in ("rows", "cols", "vals", "mask", "nnz_cell", "wave_cnt",
                 "row_of", "col_of", "row_owner", "col_local", "sub_rows",
                 "sub_cols", "sub_vals", "sub_mask", "sub_starts"):
        a, b = getattr(back, name), getattr(br, name)
        tol.assert_bitwise(a, b, name)
        assert not a.flags.writeable, name
    assert back.gid is None
    assert (back.p, back.m, back.n, back.m_local, back.n_local,
            back.sub_blocks) == (br.p, br.m, br.n, br.m_local, br.n_local,
                                 br.sub_blocks)
    tol.assert_bitwise(back.schedule.table, br.schedule.table, "table")
    tol.assert_bitwise(back.schedule.active, br.schedule.active, "active")


@pytest.mark.parametrize("sched,dispatch", SOLVE_CASES)
def test_solve_equals_local_bitwise(data, spmd, sched, dispatch):
    """``api.solve(mesh=)`` with the cold start: every rank's FitResult
    is the local ``solve``'s, bitwise."""
    outs, index, _ = spmd
    i = index["solve", (sched, dispatch)]
    res = tapi.solve(_problem(data), _nomad_config(sched, dispatch),
                     device="cpu")
    _same_on_every_rank(outs, i, res.W, res.H,
                        zip(res.trace_epochs, res.trace_rmse))
    assert all(o[f"finite{i}"] is True for o in outs)


@pytest.mark.parametrize("name", list(IGNORING))
def test_other_solvers_ignore_the_mesh(data, spmd, name):
    outs, index, _ = spmd
    i = index["ignoring", name]
    res = tapi.solve(_problem(data), IGNORING[name], device="cpu")
    _same_on_every_rank(outs, i, res.W, res.H,
                        zip(res.trace_epochs, res.trace_rmse))


@pytest.mark.parametrize("sched,sub_blocks", REF_CASES)
def test_spmd_matches_reference(data, spmd, sched, sub_blocks):
    """The port's gloo run against the JAX reference's SPMD engine on the
    same packing and factors (``sub_blocks=2``: the pipelined
    per-sub-block lists on both sides)."""
    d = data
    outs, index, ref = spmd
    i = index["ref", (sched, sub_blocks)]
    j = REF_CASES.index((sched, sub_blocks))
    n_upd = EPOCHS * NNZ / (M + N)
    for r, o in enumerate(outs):
        for name in ("W", "H"):
            tol.assert_factors_close(o[f"{name}{i}"], ref[f"{name}{j}"],
                                     dtype_policy="fp32", n_updates=n_upd,
                                     what=f"rank {r} {name}")
        np.testing.assert_allclose([x for _, x in o[f"trace{i}"]],
                                   ref[f"trace{j}"], rtol=1e-5)
    # the control: the factors the runs started from are outside the bound
    with pytest.raises(AssertionError, match="exceeds"):
        tol.assert_factors_close(d["W0"], ref[f"W{j}"], dtype_policy="fp32",
                                 n_updates=n_upd)


def test_mesh_and_engine_errors(data, spmd):
    """``make_mc_mesh`` refuses a missing process group and a world
    smaller than ``p`` (a larger one holds a mesh over some of its ranks:
    tests/test_torch_spmd_elastic.py); the engine refuses a packing for
    another ``p``."""
    outs, index, _ = spmd
    for o in outs:
        wrong_p, wrong_pack = o[f"errors{index['errors']}"]
        assert f"has {P} ranks, the mesh wants p={P + 1}" in wrong_p
        assert f"the mesh has {P} ranks but the packing wants p={P - 2}" \
            in wrong_pack
        assert o["transport"] == f"gloo, {P} ranks on the CPU"
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mc_mesh(P, device="cpu")


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_spawn_ranks_names_the_rank_that_raised():
    with pytest.raises(tmesh.RankError,
                       match=r"rank 1 raised:[\s\S]*told to fail"):
        tmesh.spawn_ranks(ttesting.raise_on_rank, 2, 1, timeout=60,
                          device="cpu")


def test_spawn_ranks_kills_a_rank_that_hangs(tmp_path):
    with pytest.raises(tmesh.RankError, match=r"did not finish within 10"):
        tmesh.spawn_ranks(ttesting.hang_on_rank, 2, 0, str(tmp_path),
                          timeout=10, device="cpu")
    # no child left: none that multiprocessing knows of, and none of the
    # ranks that got as far as writing their pid
    assert multiprocessing.active_children() == []
    pids = [int(f.read_text()) for f in tmp_path.glob("rank*.pid")]
    assert not any(_alive(pid) for pid in pids)
