"""The port's serial-order witness (``repro_torch.core.serial``).

``replay_np`` is bitwise the JAX package's (numpy float64 both sides);
``replay_torch`` matches its ``replay_jax`` within the reference tests'
``rtol=2e-5, atol=2e-6`` (the k-dot is summed in another order).  Then
the paper's headline property on the port's engine: every route —
``wave_pallas`` one launch per step and one per cell, ``pallas`` (every
rating its own wave) and ``xla`` (the flat epoch stream) — run on the CPU
equals ``replay_torch`` of the packing's ``schedule_order()``, epoch by
epoch, for the ring, random and balanced schedules and a drawn one (the
counterparts of tests/test_waves.py's and tests/test_schedule.py's
engine-against-replay tests).
"""
import numpy as np
import pytest
import torch

import strategies
import tolerance as tol

from repro.core import objective as robj
from repro.core import serial as rserial

from repro_torch.core import nomad as tnomad
from repro_torch.core import partition as tpart
from repro_torch.core import serial as tserial
from repro_torch.core.schedule import OwnershipSchedule
from repro_torch.core.stepsize import PowerSchedule as TPower
from repro_torch.kernels.policy import KernelPolicy

RTOL, ATOL = 2e-5, 2e-6
K = 6


def _problem(seed=0, m=30, n=15, nnz=200):
    rows, cols, vals = strategies.coo_problem(seed, m, n, nnz)
    W0, H0 = robj.init_factors_np(seed, m, n, K)
    return rows, cols, vals, W0, H0


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("lr_kind", ["scalar", "per_update"])
def test_replay_np_is_bitwise_the_reference(seed, lr_kind):
    rows, cols, vals, W0, H0 = _problem(seed)
    order = np.random.default_rng(seed).permutation(len(rows))
    lr = (0.03 if lr_kind == "scalar"
          else np.linspace(0.05, 0.01, len(order)))
    got = tserial.replay_np(W0, H0, rows, cols, vals, order, lr, 0.02)
    want = rserial.replay_np(W0, H0, rows, cols, vals, order, lr, 0.02)
    for a, b, name in zip(got, want, "WH"):
        tol.assert_bitwise(a, b, name)
    # the inputs are not touched
    tol.assert_bitwise(W0, robj.init_factors_np(seed, 30, 15, K)[0], "W0")


def test_run_epochs_np_is_bitwise_the_reference():
    rows, cols, vals, W0, H0 = _problem(4)
    sched = TPower(0.04, 0.1)
    for shuffle in (True, False):
        got = tserial.run_epochs_np(W0, H0, rows, cols, vals, sched, 0.01,
                                    2, seed=4, shuffle=shuffle)
        want = rserial.run_epochs_np(W0, H0, rows, cols, vals, sched, 0.01,
                                     2, seed=4, shuffle=shuffle)
        for a, b, name in zip(got, want, "WH"):
            tol.assert_bitwise(a, b, name)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("lr_kind", ["scalar", "per_update"])
def test_replay_torch_matches_replay_jax(seed, lr_kind):
    rows, cols, vals, W0, H0 = _problem(seed)
    W0, H0 = W0.astype(np.float32), H0.astype(np.float32)
    order = np.random.default_rng(seed + 10).permutation(len(rows))
    lr = (0.03 if lr_kind == "scalar"
          else np.linspace(0.05, 0.01, len(order)).astype(np.float32))
    Wt, Ht = tserial.replay_torch(W0, H0, rows, cols, vals, order, lr, 0.02,
                                  device="cpu")
    Wj, Hj = rserial.replay_jax(W0, H0, rows, cols, vals, order, lr, 0.02)
    assert Wt.dtype == torch.float32 and Wt.device.type == "cpu"
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=RTOL,
                               atol=ATOL)
    # a tensor input stays where it is and is not updated in place
    W0t = torch.from_numpy(W0)
    Wt2, _ = tserial.replay_torch(W0t, H0, rows, cols, vals, order, lr, 0.02)
    assert torch.equal(Wt2, Wt) and torch.equal(W0t, torch.from_numpy(W0))


def test_replay_torch_control_rejects_another_order():
    """The tolerance above tells orders apart: a replay of a shuffled
    order lies outside it."""
    rows, cols, vals, W0, H0 = _problem(1)
    W0, H0 = W0.astype(np.float32), H0.astype(np.float32)
    order = np.arange(len(rows))
    shuffled = np.random.default_rng(1).permutation(len(rows))
    W1, _ = tserial.replay_torch(W0, H0, rows, cols, vals, order, 0.05, 0.01)
    W2, _ = tserial.replay_torch(W0, H0, rows, cols, vals, shuffled, 0.05,
                                 0.01)
    assert not np.allclose(W1.numpy(), W2.numpy(), rtol=RTOL, atol=ATOL)


#: the engine's routes: (impl or policy, what it launches per step)
ROUTES = {
    "wave_pallas_grid": "wave_pallas",
    "wave_pallas_per_cell": KernelPolicy(impl="wave_pallas", block_rows=-1),
    "pallas": "pallas",
    "xla": "xla",
}


def _schedule(spec, p, seed):
    if spec == "drawn":
        rng = np.random.default_rng((seed, 0x5CED))
        cells = [(q, b) for q in range(p) for b in range(p)]
        return OwnershipSchedule.from_visits(
            p, [cells[i] for i in rng.permutation(len(cells))],
            name=f"drawn_{seed}")
    return spec


@pytest.mark.parametrize("epochs", [1, 2])
@pytest.mark.parametrize("spec", ["ring", "random", "balanced", "drawn"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_engine_equals_serial_replay(tiny_mc_problem, route, spec, epochs):
    """One and two epochs of the engine == ``replay_torch`` of
    ``schedule_order()`` per epoch at that epoch's step size: the epoch
    is the serial order it claims, and (epoch 2) every block is home
    before the next epoch."""
    d = tiny_mc_problem
    rows, cols, vals = d["train"]
    m, n, p = d["m"], d["n"], 4
    waves = route != "xla"
    br = tpart.pack(rows, cols, vals, m, n, p, waves=waves,
                    schedule=_schedule(spec, p, 7), schedule_seed=5)
    W0, H0 = robj.init_factors_np(0, m, n, K)
    W0, H0 = W0.astype(np.float32), H0.astype(np.float32)
    stepsize = TPower(0.04, 0.1)
    policy = ROUTES[route]
    kw = (dict(policy=policy) if isinstance(policy, KernelPolicy)
          else dict(impl=policy))
    eng = tnomad.NomadRingEngine(br=br, k=K, lam=0.01, stepsize=stepsize,
                                 device="cpu", **kw)
    eng.init_factors(W0, H0)
    order = br.schedule_order()
    Wr, Hr = torch.from_numpy(W0), torch.from_numpy(H0)
    for e in range(epochs):
        eng.run_epoch()
        Wr, Hr = tserial.replay_torch(Wr, Hr, rows, cols, vals, order,
                                      stepsize(e), 0.01)
    W1, H1 = eng.factors()
    np.testing.assert_allclose(Wr.numpy(), W1, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(Hr.numpy(), H1, rtol=RTOL, atol=ATOL)
