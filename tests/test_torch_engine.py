"""The port's ``NomadRingEngine`` against the JAX package's engine.

Both engines start from the same ``W0``/``H0`` (made with numpy and
loaded into the port through ``convert.factors_from_reference``) and the
same packing, run 3 epochs on ``tiny_mc_problem`` and are held within the
tolerance tier's bound: the k-dot is reduced in a different order by XLA
and by torch, and otherwise both sides apply the same updates in the same
serial order.  Inside the port, fused dispatch equals loop dispatch
bitwise.
"""
import numpy as np
import pytest
import torch

import tolerance as tol

from repro.core import nomad as rnomad
from repro.core import partition as rpart
from repro.core.stepsize import PowerSchedule as RPower

from repro_torch import convert
from repro_torch.core import nomad as tnomad
from repro_torch.core import partition as tpart
from repro_torch.core.stepsize import PowerSchedule as TPower
from repro_torch.kernels import nomad_sgd as tk
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.testing import assert_rare_flips

P, K, EPOCHS = 4, 8, 3


@pytest.fixture(scope="module")
def packs(tiny_mc_problem):
    d = tiny_mc_problem
    out = {}
    for sched in ("ring", "random", "balanced"):
        for waves in (True, False):
            args = (*d["train"], d["m"], d["n"], P)
            kw = dict(waves=waves, schedule=sched, schedule_seed=3)
            out[sched, waves] = (tpart.pack(*args, **kw),
                                 rpart.pack(*args, **kw))
    return out


def _w0(d, seed=0):
    rng = np.random.default_rng(seed)
    scale = 1 / np.sqrt(K)
    return (rng.uniform(0, scale, (d["m"], K)).astype(np.float32),
            rng.uniform(0, scale, (d["n"], K)).astype(np.float32))


def _port(br, impl, **kw):
    return tnomad.NomadRingEngine(br=br, k=K, lam=0.05,
                                  stepsize=TPower(0.05, 0.05), impl=impl,
                                  device="cpu", **kw)


@pytest.mark.parametrize("impl", ["xla", "wave", "wave_pallas", "pallas"])
@pytest.mark.parametrize("sched", ["ring", "random", "balanced"])
def test_engine_matches_reference(tiny_mc_problem, packs, impl, sched):
    d = tiny_mc_problem
    wave = impl in ("wave", "wave_pallas")
    bt, br = packs[sched, wave]
    W0, H0 = _w0(d)
    port = _port(bt, impl)
    port.init_factors(W0, H0)
    ref = rnomad.NomadRingEngine(br=br, k=K, lam=0.05,
                                 stepsize=RPower(0.05, 0.05), impl=impl)
    ref.init_factors(W0, H0)
    tr_p = port.train(EPOCHS, test=d["test"], dispatch="fused")
    tr_r = ref.train(EPOCHS, test=d["test"], dispatch="fused")
    assert [e for e, _ in tr_p] == [e for e, _ in tr_r] == [1, 2, 3]
    np.testing.assert_allclose([r for _, r in tr_p], [r for _, r in tr_r],
                               rtol=1e-5)
    n_upd = EPOCHS * len(d["train"][0]) / (d["m"] + d["n"])
    for a, b in zip(port.factors(), ref.factors()):
        tol.assert_factors_close(a, b, dtype_policy="fp32", n_updates=n_upd)
    assert port.last_finite


@pytest.mark.parametrize("sched", ["ring", "balanced"])
def test_engine_bf16_matches_reference(tiny_mc_problem, packs, sched):
    d = tiny_mc_problem
    bt, br = packs[sched, True]
    W0, H0 = _w0(d, 1)
    pol = dict(impl="wave_pallas", dtype_policy="bf16")
    port = tnomad.NomadRingEngine(br=bt, k=K, lam=0.05,
                                  stepsize=TPower(0.05, 0.05),
                                  policy=KernelPolicy(**pol), device="cpu")
    from repro.kernels.policy import KernelPolicy as RPolicy
    ref = rnomad.NomadRingEngine(br=br, k=K, lam=0.05,
                                 stepsize=RPower(0.05, 0.05),
                                 policy=RPolicy(**pol))
    port.init_factors(W0, H0)
    ref.init_factors(W0, H0)
    assert port.Ws.dtype == torch.bfloat16
    port.train(EPOCHS, dispatch="fused")
    ref.train(EPOCHS, dispatch="fused")
    n_upd = EPOCHS * len(d["train"][0]) / (d["m"] + d["n"])
    for a, b, s0 in zip(port.factors(), ref.factors(), (W0, H0)):
        b = np.asarray(b).astype(np.float32)
        tol.assert_factors_close(a, b, dtype_policy="bf16", n_updates=n_upd)
        # both compute in fp32 over bf16 storage
        assert_rare_flips(*(torch.from_numpy(x).bfloat16()
                            for x in (a, b, s0)), what="bf16")


@pytest.mark.parametrize("impl", ["xla", "wave_pallas", "pallas"])
@pytest.mark.parametrize("sched", ["ring", "random"])
@pytest.mark.parametrize("fuse_epochs,record_every",
                         [(None, 1), (1, 1), (2, 2)])
def test_fused_equals_loop_bitwise(tiny_mc_problem, packs, impl, sched,
                                   fuse_epochs, record_every):
    d = tiny_mc_problem
    bt, _ = packs[sched, impl != "xla" and impl != "pallas"]
    W0, H0 = _w0(d, 2)
    runs = []
    for dispatch in ("loop", "fused"):
        eng = _port(bt, impl)
        eng.init_factors(W0, H0)
        tr = eng.train(EPOCHS, test=d["test"], dispatch=dispatch,
                       record_every=record_every, fuse_epochs=fuse_epochs)
        runs.append((tr, eng.Ws, eng.Hs, eng.epoch_idx))
    (ta, Wa, Ha, ea), (tb, Wb, Hb, eb) = runs
    assert ta == tb and ea == eb == EPOCHS
    assert torch.equal(Wa, Wb) and torch.equal(Ha, Hb)


def test_split_training_resumes_bitwise(tiny_mc_problem, packs):
    d = tiny_mc_problem
    bt, _ = packs["ring", True]
    W0, H0 = _w0(d, 4)
    one = _port(bt, "wave_pallas")
    one.init_factors(W0, H0)
    one.train(3, dispatch="fused")
    two = _port(bt, "wave_pallas")
    two.init_factors(W0, H0)
    two.train(1, dispatch="loop")
    two.train(2, dispatch="fused", fuse_epochs=1)
    assert torch.equal(one.Ws, two.Ws) and torch.equal(one.Hs, two.Hs)


def test_wave_csr_equals_compacted_padded_layout(packs):
    bt, _ = packs["balanced", True]
    csr = tnomad.wave_csr(bt)
    p = bt.p
    for s in range(bt.n_steps):
        pad = [torch.from_numpy(np.ascontiguousarray(a[:, s]))
               for a in (bt.wave_rows, bt.wave_cols, bt.wave_vals,
                         bt.wave_mask)]
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


@pytest.mark.parametrize("waves", [True, False])
def test_sequential_csr_is_one_wave_per_rating(packs, waves):
    bt, _ = packs["random", waves]
    csr = tnomad.wave_csr(bt, sequential=True)
    mask = np.swapaxes(bt.mask, 0, 1)
    n = int(mask.sum())
    assert csr.n_cells == bt.n_steps * bt.p
    assert torch.equal(csr.woff, torch.arange(n + 1, dtype=torch.int32))
    assert csr.cell_woff.tolist() == [0, *np.cumsum(mask.sum(-1).ravel())]
    assert torch.equal(csr.rows, torch.from_numpy(
        np.swapaxes(bt.rows, 0, 1)[mask]))
    assert torch.equal(csr.vals, torch.from_numpy(
        np.swapaxes(bt.vals, 0, 1)[mask]))


def test_stream_covers_every_rating_once(tiny_mc_problem, packs):
    bt, _ = packs["random", False]
    csr = tnomad.stream_csr(bt)
    assert csr.n_cells == 1
    assert int(csr.woff[-1]) == len(tiny_mc_problem["train"][0])


def test_divergence_sentinel(tiny_mc_problem, packs):
    d = tiny_mc_problem
    bt, _ = packs["ring", True]
    for dispatch in ("loop", "fused"):
        eng = _port(bt, "wave_pallas")
        W0, H0 = _w0(d)
        W0[0, 0] = np.nan
        eng.init_factors(W0, H0)
        eng.train(1, dispatch=dispatch)
        assert eng.last_finite is False
        eng.init_factors(*_w0(d))
        assert eng.last_finite is True


def test_eval_rmse_matches_unsharded(tiny_mc_problem, packs):
    d = tiny_mc_problem
    bt, _ = packs["balanced", True]
    eng = _port(bt, "wave_pallas")
    eng.init_factors(*_w0(d, 5))
    eng.train(1)
    W, H = eng.factors()
    r, c, v = d["test"]
    want = np.sqrt(np.mean((v.astype(np.float32)
                            - np.sum(W[r] * H[c], axis=-1)) ** 2))
    assert eng.eval_rmse(d["test"]) == pytest.approx(float(want), rel=1e-6)
    assert eng._eval_args(tuple(np.copy(a) for a in d["test"])) is \
        eng._eval_args(d["test"])


def test_convert_roundtrip(tiny_mc_problem, packs):
    d = tiny_mc_problem
    bt, _ = packs["ring", True]
    W0, H0 = _w0(d, 6)
    for policy, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16),
                       ("fp16", torch.float16)):
        Ws, Hs = convert.factors_from_reference(W0, H0, bt,
                                                dtype_policy=policy,
                                                device="cpu")
        assert Ws.dtype == dt and Ws.shape == (P, bt.m_local, K)
        W, H = convert.factors_to_reference(Ws, Hs, bt)
        assert W.dtype == (np.float16 if policy == "fp16" else np.float32)
        for got, want in ((W, W0), (H, H0)):
            # exactly the storage rounding of the input, nothing more
            tol.assert_bitwise(got.astype(np.float32), torch.from_numpy(
                want).to(dt).float().numpy())


def test_engine_refuses_mesh_and_missing_cuda(packs):
    bt, _ = packs["ring", True]
    # NomadRingEngine(mesh=) runs (tests/test_torch_spmd.py); migrating
    # onto a mesh does not yet
    eng = _port(bt, "wave_pallas")
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        eng.migrate(bt, mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tnomad.NomadRingEngine(br=bt, k=K, lam=0.05, stepsize=TPower())


def test_engine_rejects_packing_without_waves(packs):
    bt, _ = packs["ring", False]
    with pytest.raises(ValueError, match="wave layout"):
        _port(bt, "wave_pallas")
