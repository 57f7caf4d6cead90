"""The port's ``solve`` against ``repro.api.solve``, and the package's
isolation from JAX.

Both sides warm-start from the same numpy factors (``FitResult(W=W0,
H=H0, ..., epochs_done=0)``): JAX's threefry cold start cannot be
reproduced in torch.  Factors are held within the tolerance tier's bound,
RMSE traces within relative 1e-5.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tolerance as tol

from repro import api as rapi

from repro_torch import api as tapi
from repro_torch.core.objective import init_factors
from repro_torch.core.stepsize import PowerSchedule as TPower
from repro_torch.testing import assert_rare_flips

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _problems(d):
    return (tapi.MCProblem.from_coo(*d["train"], d["m"], d["n"],
                                    test=d["test"]),
            rapi.MCProblem.from_coo(*d["train"], d["m"], d["n"],
                                    test=d["test"]))


def _warm(api, d, k, seed=0, done=0):
    rng = np.random.default_rng(seed)
    return api.FitResult(
        W=rng.uniform(0, 1 / np.sqrt(k), (d["m"], k)).astype(np.float32),
        H=rng.uniform(0, 1 / np.sqrt(k), (d["n"], k)).astype(np.float32),
        trace_epochs=np.zeros(0), trace_rmse=np.zeros(0), epochs_done=done)


@pytest.mark.parametrize("kw", [
    dict(kernel="wave_pallas"),
    dict(kernel="wave_pallas", schedule="balanced", dispatch="loop"),
    dict(kernel="xla", schedule="random", fuse_epochs=2),
    dict(kernel="pallas", record_every=2),
    dict(kernel="wave_pallas", dtype_policy="bf16"),
])
def test_solve_matches_reference(tiny_mc_problem, kw):
    d = tiny_mc_problem
    tp, rp = _problems(d)
    common = dict(k=8, p=4, lam=0.05, epochs=3, **kw)
    warm = _warm(tapi, d, 8)
    got = tapi.solve(tp, tapi.NomadConfig(**common), warm_start=warm,
                     device="cpu")
    want = rapi.solve(rp, rapi.NomadConfig(**common),
                      warm_start=_warm(rapi, d, 8))
    tol.assert_bitwise(got.trace_epochs, want.trace_epochs, "trace epochs")
    np.testing.assert_allclose(got.trace_rmse, want.trace_rmse, rtol=1e-5)
    policy = kw.get("dtype_policy", "fp32")
    n_upd = 3 * tp.nnz / (d["m"] + d["n"])
    for a, b, s0 in ((got.W, want.W, warm.W), (got.H, want.H, warm.H)):
        b = np.asarray(b).astype(np.float32)
        tol.assert_factors_close(a, b, dtype_policy=policy, n_updates=n_upd)
        if policy == "bf16":    # both compute in fp32 over bf16 storage
            assert_rare_flips(*(torch.from_numpy(x).bfloat16()
                                for x in (a, b, s0)), what="bf16")
    assert got.solver == want.solver == "nomad"
    assert got.epochs_done == want.epochs_done == 3
    assert got.extras == {"divergence": {"finite": True}}


def test_fit_result_and_stepsize_continuation(tiny_mc_problem):
    d = tiny_mc_problem
    tp, _ = _problems(d)
    cfg = tapi.NomadConfig(k=8, p=3, epochs=3, kernel="wave_pallas",
                           stepsize=TPower(0.05, 0.05))
    whole = tapi.solve(tp, cfg, warm_start=_warm(tapi, d, 8), device="cpu")
    first = tapi.solve(tp, tapi.NomadConfig(**{**_fields(cfg), "epochs": 1}),
                       warm_start=_warm(tapi, d, 8), device="cpu")
    rest = tapi.solve(tp, tapi.NomadConfig(**{**_fields(cfg), "epochs": 2}),
                      warm_start=first, device="cpu")
    assert rest.epochs_done == 3 and rest.trace_epochs.tolist() == [2, 3]
    tol.assert_bitwise(rest.W, whole.W, "W")
    tol.assert_bitwise(rest.H, whole.H, "H")
    np.testing.assert_array_equal(
        np.concatenate([first.trace_rmse, rest.trace_rmse]),
        whole.trace_rmse)
    assert whole.W.shape == (d["m"], 8) and whole.W.dtype == np.float32
    assert whole.wall_time > 0 and whole.config == cfg
    assert whole.trace == list(zip([1, 2, 3], whole.rmse.tolist()))


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def test_cold_start_is_seeded_and_descends(tiny_mc_problem):
    d = tiny_mc_problem
    tp, _ = _problems(d)
    cfg = tapi.NomadConfig(k=8, p=4, epochs=3, kernel="wave_pallas",
                           stepsize=TPower(0.05, 0.05), seed=7)
    a = tapi.solve(tp, cfg, device="cpu")
    b = tapi.solve(tp, cfg, device="cpu")
    tol.assert_bitwise(a.W, b.W, "seeded cold start")
    assert a.rmse[-1] < a.rmse[0]


def test_init_factors_same_draw_any_device():
    W, H = init_factors(torch.Generator().manual_seed(3), 50, 20, 16)
    W2, _ = init_factors(torch.Generator().manual_seed(3), 50, 20, 16,
                         device="cpu", dtype=torch.bfloat16)
    assert torch.equal(W.to(torch.bfloat16), W2)
    assert 0 <= float(W.min()) and float(W.max()) < 0.25
    assert W.shape == (50, 16) and H.shape == (20, 16)


def test_objective_and_rmse_match_numpy():
    from repro_torch.core.objective import (objective, objective_np, rmse,
                                            rmse_np)
    rng = np.random.default_rng(8)
    W, H = rng.normal(size=(30, 6)), rng.normal(size=(20, 6))
    r, c = rng.integers(0, 30, 100), rng.integers(0, 20, 100)
    v = rng.normal(size=100)
    tW, tH, tr, tc, tv = map(torch.from_numpy, (W, H, r, c, v))
    assert float(rmse(tW, tH, tr, tc, tv)) == pytest.approx(
        rmse_np(W, H, r, c, v), rel=1e-12)
    assert float(objective(tW, tH, tr, tc, tv, 0.1)) == pytest.approx(
        objective_np(W, H, r, c, v, 0.1), rel=1e-12)


def test_config_fields_and_defaults_match_reference():
    t = tapi.NomadConfig()
    r = rapi.NomadConfig()
    names = [f for f in r.__dataclass_fields__]
    assert [f for f in t.__dataclass_fields__] == names
    for f in names:
        a, b = getattr(t, f), getattr(r, f)
        if f == "kernel":
            assert (a.impl, a.chunk, a.wave_chunk, a.sub_blocks,
                    a.dtype_policy, a.block_rows) == (
                b.impl, b.chunk, b.wave_chunk, b.sub_blocks,
                b.dtype_policy, b.block_rows)
        else:
            assert a == b, f


@pytest.mark.parametrize("kw", [dict(p=0), dict(dispatch="jit"),
                                dict(fuse_epochs=0), dict(record_every=0),
                                dict(schedule="zigzag"), dict(k=0),
                                dict(epochs=1.5), dict(kernel="cuda")])
def test_config_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        rapi.NomadConfig(**kw)
    with pytest.raises(ValueError):
        tapi.NomadConfig(**kw)


def test_problem_validation():
    with pytest.raises(ValueError):
        tapi.MCProblem.from_coo([0, 5], [0, 1], [1.0, 2.0], 3, 3)
    prob = tapi.MCProblem.synthetic(40, 20, 300, k=4, seed=1)
    ref = rapi.MCProblem.synthetic(40, 20, 300, k=4, seed=1)
    for a, b in zip((*prob.train, *prob.test), (*ref.train, *ref.test)):
        tol.assert_bitwise(a, b)
    assert prob.packed(2, waves=True) is prob.packed(2, waves=True)


def test_refuses_what_is_not_ported(tiny_mc_problem):
    d = tiny_mc_problem
    tp, _ = _problems(d)
    cfg = tapi.NomadConfig(k=8, p=2, epochs=1)
    # mesh= runs on an McMesh in solve, partial_fit and the session
    # (tests/test_torch_spmd.py, tests/test_torch_spmd_elastic.py);
    # anything else is refused
    with pytest.raises(TypeError, match="McMesh"):
        tapi.StreamingSession(tp, cfg, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="McMesh"):
        tapi.solve(tp, cfg, mesh=object(), device="cpu",
                   faults=tapi.FaultPolicy(checkpoint_dir="unused"))
    # CCD++ and ALS have no streaming continuation, as in the reference
    res = tapi.solve(tp, cfg, device="cpu")
    with pytest.raises(TypeError, match="McMesh"):
        tapi.partial_fit(res, tp.extend(m_new=1), mesh=object(),
                         device="cpu")
    for other in (tapi.CcdConfig(k=8, epochs=1),
                  tapi.AlsConfig(k=8, epochs=1)):
        with pytest.raises(NotImplementedError, match="partial_fit"):
            tapi.partial_fit(res, tp.extend(m_new=1), other, device="cpu")
        with pytest.raises(NotImplementedError, match="streaming"):
            tapi.StreamingSession(tp, other, device="cpu")


def test_solve_defaults_to_cuda(tiny_mc_problem):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    tp, _ = _problems(tiny_mc_problem)
    with pytest.raises(RuntimeError, match="cuda"):
        tapi.solve(tp, tapi.NomadConfig(k=8, p=2, epochs=1))


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys\n"
            "import repro_torch.api, repro_torch.kernels.ops, "
            "repro_torch.convert, repro_torch.core.nomad, "
            "repro_torch.serve, repro_torch.checkpoint, "
            "repro_torch.launch.serve_mc, repro_torch.kernels.topk, "
            "repro_torch.launch.serve, repro_torch.models.transformer, "
            "repro_torch.configs, repro_torch.kernels.flash_attn, "
            "repro_torch.runtime, repro_torch.data, "
            "repro_torch.core.serial, repro_torch.core.async_sim, "
            "repro_torch.core.baselines, repro_torch.launch.mesh\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
