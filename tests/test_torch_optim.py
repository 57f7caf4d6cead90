"""The port's optimizers, schedule and gradient compression against the
JAX package's (``repro.optim``), on the same numpy inputs.

Bounds, stated per comparison, in units of the storage type's unit
roundoff relative to ``1 + |reference|`` (``tests/tolerance.py``'s
``rel_err_in_eps``): fp32 values within 16 units (the same fp32
operations; ``b ** step`` and ``sqrt`` may round differently in the two
libraries, by an ulp, and three steps compound a few of those); bf16
values (states, parameters) within 2 units (an fp32 difference of an ulp
can move the one rounding to bf16 by one bf16 unit).  The int8 codes
are bitwise (the same fp32 scale and division, both round half to even).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as RA
from repro.optim import grad_compress as RG
from repro.optim.schedule import cosine_warmup as r_cosine_warmup

from repro_torch import optim as topt
from repro_torch.optim import adamw as TA
from repro_torch.optim import grad_compress as TG

from tolerance import rel_err_in_eps

SHAPES = {"a": (4, 8), "b": (16,), "c": (3, 5, 2)}
FP32_UNITS = 16
BF16_UNITS = 2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _close(got, want, policy):
    units = FP32_UNITS if policy == "fp32" else BF16_UNITS
    err = rel_err_in_eps(_np(got), _np(want), policy)
    assert err <= units, (err, policy)


def _draw(rng, scale=1.0):
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("state_dtype,master,param_dtype,clip", [
    ("float32", "float32", "float32", 1.0),
    ("float32", "float32", "bfloat16", 1.0),
    ("bfloat16", "float32", "bfloat16", 1.0),
    ("float32", None, "float32", 1.0),
    ("float32", None, "bfloat16", 1.0),
    ("float32", "float32", "float32", 0.0),
])
def test_adamw_matches_reference(state_dtype, master, param_dtype, clip):
    cfg = dict(lr=1e-2, weight_decay=0.05, state_dtype=state_dtype,
               master_dtype=master, grad_clip=clip)
    rcfg, tcfg = RA.AdamWConfig(**cfg), TA.AdamWConfig(**cfg)
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(tcfg)
    rng = np.random.default_rng(0)
    p0 = _draw(rng)
    jdt, tdt = jnp.dtype(param_dtype), getattr(torch, param_dtype)
    rp = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p0.items()}
    rs, ts = RA.adamw_init(rp, rcfg), TA.adamw_init(tp, tcfg)
    ppol = "fp32" if param_dtype == "float32" else "bf16"
    spol = "fp32" if state_dtype == "float32" else "bf16"
    for step in range(3):
        # large gradients: the clip (at 1.0) is active every step
        g = _draw(rng, scale=3.0)
        rg = {k: jnp.asarray(v, jdt) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(tdt) for k, v in g.items()}
        lr_scale = r_cosine_warmup(step, base_lr=1.0, warmup=1, total=5)
        rp, rs, rm = RA.adamw_update(rp, rg, rs, rcfg, lr_scale=lr_scale)
        tp, ts, tm = TA.adamw_update(
            tp, tg, ts, tcfg, lr_scale=topt.cosine_warmup(
                step, base_lr=1.0, warmup=1, total=5))
        assert int(ts["step"]) == int(rs["step"]) == step + 1
        _close(tm["grad_norm"], rm["grad_norm"], "fp32")
        _close(tm["lr"], rm["lr"], "fp32")
        for k in SHAPES:
            assert tp[k].dtype == tdt
            _close(tp[k], rp[k], ppol)
            _close(ts["m"][k], rs["m"][k], spol)
            _close(ts["v"][k], rs["v"][k], spol)
            if master is not None:
                _close(ts["master"][k], rs["master"][k], "fp32")
    assert ("master" in ts) == (master is not None)
    if clip:
        assert float(tm["grad_norm"]) > clip


def test_adamw_init_copies_and_keys_by_module_names():
    model = torch.nn.Linear(3, 2)
    state = TA.adamw_init(model, TA.AdamWConfig())
    names = {"weight", "bias"}
    assert set(state["m"]) == set(state["v"]) == set(state["master"]) == names
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    # the master copy is a copy, not an alias of the parameter
    assert state["master"]["weight"].data_ptr() != model.weight.data_ptr()
    with pytest.raises(ValueError, match="do not match"):
        TA.adamw_update(model, {"weight": torch.zeros(2, 3)}, state,
                        TA.AdamWConfig())


def test_sgdm_matches_reference():
    rng = np.random.default_rng(1)
    p0 = _draw(rng)
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    rs, ts = RA.sgdm_init(rp), TA.sgdm_init(tp)
    for _ in range(4):
        g = _draw(rng)
        rp, rs = RA.sgdm_update(rp, {k: jnp.asarray(v) for k, v in g.items()},
                                rs, 0.05)
        tp, ts = TA.sgdm_update(tp, {k: torch.from_numpy(v)
                                     for k, v in g.items()}, ts, 0.05)
        for k in SHAPES:
            _close(tp[k], rp[k], "fp32")
            _close(ts["mom"][k], rs["mom"][k], "fp32")
    assert int(ts["step"]) == int(rs["step"]) == 4


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 5), (1, 5),
                                          (100, 50)])
def test_cosine_warmup_matches_reference(warmup, total):
    for s in range(0, max(total, warmup) + 3):
        want = r_cosine_warmup(s, base_lr=3e-4, warmup=warmup, total=total)
        got = topt.cosine_warmup(s, base_lr=3e-4, warmup=warmup, total=total)
        assert got.dtype == torch.float32 and got.dim() == 0
        _close(got, want, "fp32")
        # a 0-d int32 tensor, as the optimizer's step counter is
        got_t = topt.cosine_warmup(torch.tensor(s, dtype=torch.int32),
                                   base_lr=3e-4, warmup=warmup, total=total)
        assert torch.equal(got_t, got)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000, 4096])
def test_int8_codes_bitwise_reference(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(n,)) * 10).astype(np.float32)
    # values exactly halfway between two codes round to even in both
    x[: min(n, 4)] = [127.0, 63.5, -0.5, 1.5][: min(n, 4)]
    rc, rsc, rmeta = RG.compress_int8(jnp.asarray(x))
    tc, tsc, tmeta = TG.compress_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(rsc))
    assert tmeta == (tuple(rmeta[0]), rmeta[1])
    assert tc.dtype == torch.int8 and tc.shape == (-(-n // 256), 256)
    np.testing.assert_array_equal(
        TG.decompress_int8(tc, tsc, tmeta).numpy(),
        np.asarray(RG.decompress_int8(rc, rsc, rmeta)))


def test_int8_round_half_to_even():
    x = torch.zeros(256)
    x[0] = 127.0                      # the block's absmax: scale = 1
    x[1:5] = torch.tensor([0.5, 1.5, 2.5, -2.5])
    codes, scale, _ = TG.compress_int8(x)
    assert float(scale) == 1.0
    assert codes[0, :5].tolist() == [127, 0, 2, 2, -2]


def test_error_feedback_matches_reference():
    rng = np.random.default_rng(3)
    shape = (300, 7)
    r_ef = RG.ErrorFeedbackState(jnp.zeros(shape, jnp.float32))
    t_ef = TG.ef_init({"w": torch.zeros(shape, dtype=torch.bfloat16)})["w"]
    assert t_ef.residual.dtype == torch.float32
    for _ in range(5):
        g = rng.normal(size=shape).astype(np.float32)
        r_hat, r_ef = RG.ef_compress_update(jnp.asarray(g), r_ef)
        t_hat, t_ef = TG.ef_compress_update(torch.from_numpy(g), t_ef)
        np.testing.assert_array_equal(t_hat.numpy(), np.asarray(r_hat))
        np.testing.assert_array_equal(t_ef.residual.numpy(),
                                      np.asarray(r_ef.residual))
    # the quantized gradient comes back in the gradient's dtype
    h, _ = TG.ef_compress_update(torch.ones(8, dtype=torch.bfloat16),
                                 TG.ErrorFeedbackState(torch.zeros(8)))
    assert h.dtype == torch.bfloat16


def test_optim_exports_match_reference():
    from repro import optim as R
    assert topt.__all__ == R.__all__
