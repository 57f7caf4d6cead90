"""The port's Mamba block (``repro_torch/models/mamba.py``) against the
JAX package's ``models/mamba.py`` on the same inputs, and Falcon-Mamba's
train steps against the reference's.

Inputs come from numpy seeds; the reference's parameters are drawn by
its ``mamba_init`` and copied into the port's module by name.  Bounds,
stated per comparison:

* the chunked scan in fp32 within ``1e-5 (1 + |want|)``: the port's
  Hillis–Steele tree and ``jax.lax.associative_scan``'s apply the same
  combine in another order (measured ≤ 3e-8 on states up to 2); inside
  the port, the scan against a step-by-step loop in float64 within
  ``1e-12``;
* the causal convolution bitwise, in fp32 and bf16 (the same K products
  and adds, each rounded to the input type, in the same order), with
  ``F.conv1d`` as a control that departs in bf16;
* ``mamba_apply``/``mamba_decode`` outputs and states in fp32 within
  ``1e-5 (1 + |want|)`` (the same fp32 arithmetic in another order);
  the ``conv`` state bitwise; gradients within ``1e-5 (1 + |want|)``;
* bf16 outputs within ``2^-6 (1 + |want|)``, two bf16 ulps (both round
  the projections and the convolution's products to bf16; ``silu`` and
  the matmuls' fp32 sums round at other places; measured one ulp); the
  fp32 state of a bf16 block within ``2^-7 (1 + |want|)``: it sums
  ``dt x B`` from those bf16 inputs (measured ≤ 9.3e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as rconfigs
from repro.models import mamba as rmamba

from repro_torch.convert import _flatten, serving_array
from repro_torch.models import mamba as tmamba

from test_torch_hybrid import check_train_steps

CPU = "cpu"
FP32_REL = 1e-5
BF16_REL = 2.0 ** -6
BF16_STATE_REL = 2.0 ** -7


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _within(got, want, rel):
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert g.shape == w.shape
    err = np.abs(g - w)
    assert (err <= rel * (1 + np.abs(w))).all(), float(err.max())


def _cfg(dtype="float32", **kw):
    return dataclasses.replace(rconfigs.get_smoke_config("falcon_mamba_7b"),
                               dtype=dtype, **kw)


def _pair(cfg, seed=0):
    """The reference's Mamba parameters and the port's module holding
    them."""
    p = rmamba.mamba_init(jax.random.key(seed), cfg, jnp.dtype(cfg.dtype))
    m = tmamba.Mamba(cfg, dtype=getattr(torch, cfg.dtype), device=CPU)
    flat = _flatten(jax.tree.map(np.asarray, p))
    state = m.state_dict()
    assert set(state) == set(flat)
    with torch.no_grad():
        for k, t in state.items():
            t.copy_(serving_array(flat[k], CPU))
    return p, m


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def _both_x(x, dtype):
    return jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))


def _ab(B, S, d, N, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (B, S, d, N)).astype(np.float32)
    b = rng.normal(size=(B, S, d, N)).astype(np.float32) * 0.3
    h0 = rng.normal(size=(B, d, N)).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("S,chunk", [(16, 16), (16, 4), (24, 8), (7, 256),
                                     (1, 1), (30, 10)])
def test_ssm_scan_matches_reference(S, chunk):
    a, b, h0 = _ab(2, S, 6, 4, seed=S)
    want_h, want_fin = rmamba._ssm_scan_chunked(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0), chunk)
    got_h, got_fin = tmamba._ssm_scan_chunked(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(h0), chunk)
    _within(got_h, want_h, FP32_REL)
    _within(got_fin, want_fin, FP32_REL)


def test_ssm_scan_equals_a_loop_in_float64():
    a, b, h0 = (torch.from_numpy(t).double() for t in _ab(2, 37, 3, 5, 1))
    h, want = h0, []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got, fin = tmamba._ssm_scan_chunked(a, b, h0, 37)
    assert torch.allclose(got, torch.stack(want, 1), rtol=0, atol=1e-12)
    assert torch.equal(fin, got[:, -1])


def test_ssm_scan_refuses_a_ragged_chunk():
    a, b, h0 = (torch.from_numpy(t) for t in _ab(1, 10, 2, 2, 0))
    with pytest.raises(ValueError, match="multiple of chunk=4"):
        tmamba._ssm_scan_chunked(a, b, h0, 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("history", [False, True])
def test_causal_conv_matches_reference_bitwise(dtype, history):
    rng = np.random.default_rng(4)
    di, K = 128, 4
    w = rng.normal(size=(K, di)).astype(np.float32)
    b = rng.normal(size=(di,)).astype(np.float32)
    x = rng.normal(size=(2, 33, di)).astype(np.float32)
    hist = rng.normal(size=(2, K - 1, di)).astype(np.float32) \
        if history else None
    J = lambda a: None if a is None else jnp.asarray(a, jnp.dtype(dtype))
    T = lambda a: None if a is None else torch.from_numpy(a).to(
        getattr(torch, dtype))
    want = rmamba._causal_conv(J(x), J(w), J(b), K, J(hist))
    got = tmamba._causal_conv(T(x), T(w), T(b), K, T(hist))
    assert got.dtype == getattr(torch, dtype)
    assert np.array_equal(_np(got), _np(want))
    # control: the same convolution by F.conv1d, whose sums run in fp32
    hist_t = T(hist) if history else T(np.zeros((2, K - 1, di), np.float32))
    xp = torch.cat([hist_t, T(x)], 1).transpose(1, 2)
    conv = F.conv1d(xp, T(w).t()[:, None, :], T(b), groups=di).transpose(1, 2)
    if dtype == "float32":
        _within(conv, want, FP32_REL)
    else:
        assert not np.array_equal(_np(conv), _np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [24, 8, 4])
def test_mamba_apply_matches_reference(dtype, chunk):
    cfg = _cfg(dtype)
    p, m = _pair(cfg, seed=1)
    jx, tx = _both_x(_x(cfg, 2, 24, 1), dtype)
    want, want_st = rmamba.mamba_apply(p, jx, cfg, chunk=chunk)
    got, st = tmamba.mamba_apply(m, tx, cfg, chunk=chunk)
    assert got.dtype == tx.dtype and st.ssm.dtype == torch.float32
    rel = FP32_REL if dtype == "float32" else BF16_REL
    _within(got, want, rel)
    _within(st.ssm, want_st.ssm,
            FP32_REL if dtype == "float32" else BF16_STATE_REL)
    assert st.conv.dtype == tx.dtype
    assert np.array_equal(_np(st.conv), _np(want_st.conv))
    # the state is a copy, not a view of the activations or of the
    # scan's last chunk (a Falcon-Mamba prefill of 4 x 1,024 tokens would
    # keep 64 layers x 537 MB of chunks alive)
    for t in st:
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


def test_mamba_state_carries_across_segments():
    """Segments of 10 and 14 tokens (chunks 5 and 7), the second from the
    first's state: the reference's chain, and the port's own one-piece
    apply, each within ``1e-5 (1 + |want|)``."""
    cfg = _cfg()
    p, m = _pair(cfg, seed=2)
    jx, tx = _both_x(_x(cfg, 2, 24, 2), "float32")
    y1, st = rmamba.mamba_apply(p, jx[:, :10], cfg, chunk=5)
    y2, st2 = rmamba.mamba_apply(p, jx[:, 10:], cfg, state=st, chunk=7)
    g1, gst = tmamba.mamba_apply(m, tx[:, :10], cfg, chunk=5)
    g2, gst2 = tmamba.mamba_apply(m, tx[:, 10:], cfg, state=gst, chunk=7)
    _within(torch.cat([g1, g2], 1), jnp.concatenate([y1, y2], 1), FP32_REL)
    _within(gst2.ssm, st2.ssm, FP32_REL)
    assert np.array_equal(_np(gst2.conv), _np(st2.conv))
    whole, wst = tmamba.mamba_apply(m, tx, cfg, chunk=8)
    _within(torch.cat([g1, g2], 1), whole, FP32_REL)
    _within(gst2.ssm, wst.ssm, FP32_REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_matches_reference(dtype):
    """A prefill of 8 tokens, then 5 decode steps, each from the previous
    step's state, against the reference's chain."""
    cfg = _cfg(dtype)
    p, m = _pair(cfg, seed=3)
    jx, tx = _both_x(_x(cfg, 3, 13, 3), dtype)
    _, want_st = rmamba.mamba_apply(p, jx[:, :8], cfg, chunk=8)
    _, st = tmamba.mamba_apply(m, tx[:, :8], cfg, chunk=8)
    rel = FP32_REL if dtype == "float32" else BF16_REL
    for t in range(8, 13):
        want, want_st = rmamba.mamba_decode(p, jx[:, t:t + 1], want_st, cfg)
        got, st = tmamba.mamba_decode(m, tx[:, t:t + 1], st, cfg)
        assert got.shape == (3, 1, cfg.d_model) and got.dtype == tx.dtype
        _within(got, want, rel)
        _within(st.ssm, want_st.ssm,
                FP32_REL if dtype == "float32" else BF16_STATE_REL)
        assert np.array_equal(_np(st.conv), _np(want_st.conv))


def test_chunked_apply_equals_stepwise_decode():
    """Inside the port (``tests/test_models.py``'s check at its bound):
    the chunked full-sequence forward equals decode from a zero state,
    token by token."""
    cfg = _cfg()
    m = tmamba.mamba_init(torch.Generator().manual_seed(0), cfg,
                          torch.float32)
    x = torch.from_numpy(_x(cfg, 2, 16, 4))
    y, st_seq = tmamba.mamba_apply(m, x, cfg, chunk=8)
    st = tmamba.init_ssm_state(cfg, 2, torch.float32)
    ys = []
    for t in range(16):
        y_t, st = tmamba.mamba_decode(m, x[:, t:t + 1], st, cfg)
        ys.append(y_t)
    np.testing.assert_allclose(_np(torch.cat(ys, 1)), _np(y), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(_np(st.ssm), _np(st_seq.ssm), rtol=2e-4,
                               atol=2e-5)
    assert torch.equal(st.conv, st_seq.conv)


def test_mamba_gradients_match_reference():
    """``jax.grad`` of ``sum(y * ct) + sum(h_fin * ct_h)`` through the
    chunked scan (S=16, chunk 4) with respect to every parameter and
    ``x``, against torch's autograd, fp32."""
    cfg = _cfg()
    p, m = _pair(cfg, seed=5)
    rng = np.random.default_rng(5)
    x = _x(cfg, 2, 16, 5)
    ct = rng.normal(size=x.shape).astype(np.float32)
    ct_h = rng.normal(size=(2, cfg.d_inner, cfg.ssm_state)).astype(
        np.float32)

    def loss(params, xx):
        y, st = rmamba.mamba_apply(params, xx, cfg, chunk=4)
        return jnp.sum(y * ct) + jnp.sum(st.ssm * ct_h)

    want_p, want_x = jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(x))
    want = {**_flatten(jax.tree.map(np.asarray, want_p)), "x": want_x}
    tx = torch.from_numpy(x).requires_grad_(True)
    params = dict(m.named_parameters())
    for t in params.values():
        t.requires_grad_(True)
    y, st = tmamba.mamba_apply(m, tx, cfg, chunk=4)
    total = (y * torch.from_numpy(ct)).sum() + (st.ssm * torch.from_numpy(
        ct_h)).sum()
    grads = torch.autograd.grad(total, [*params.values(), tx])
    got = {**dict(zip(params, grads)), "x": grads[-1]}
    assert set(got) == set(want)
    for k in want:
        _within(got[k], want[k], FP32_REL)


def test_mamba_init_draws_the_reference_shapes():
    cfg = _cfg("bfloat16")
    ref = jax.eval_shape(lambda: rmamba.mamba_init(jax.random.key(0), cfg,
                                                   jnp.bfloat16))
    want = {k: (tuple(v.shape), v.dtype.name) for k, v in
            _flatten(ref).items()}
    m = tmamba.mamba_init(torch.Generator().manual_seed(0), cfg,
                          torch.bfloat16)
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in m.state_dict().items()}
    assert got == want
    assert {k for k, v in got.items() if v[1] == "float32"} == {
        "dt_bias", "A_log", "D"}
    r = rmamba.mamba_init(jax.random.key(0), cfg, jnp.bfloat16)
    # log(1..N): one fp32 ulp apart where the two libraries' log differ
    np.testing.assert_allclose(_np(m.A_log), np.asarray(r["A_log"]),
                               rtol=2.0 ** -23, atol=0)
    assert np.array_equal(_np(m.D), np.asarray(r["D"]))
    dt = F.softplus(m.dt_bias)
    assert 1e-3 * 0.999 <= float(dt.min()) and float(dt.max()) <= 0.1 * 1.001
    assert float(m.conv_b.float().abs().max()) == 0.0
    assert float(m.conv_w.float().abs().max()) <= 2 / cfg.ssm_conv ** 0.5


@pytest.mark.parametrize("remat,grad_accum", [(False, 1), (True, 1),
                                              (False, 2)])
def test_falcon_mamba_train_steps_match_reference(remat, grad_accum):
    """Two ``make_train_step`` steps from the reference's state against
    the reference's (``tests/test_torch_hybrid.py`` states the bounds)."""
    check_train_steps("falcon_mamba_7b", remat, grad_accum)
