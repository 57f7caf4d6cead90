"""The port's MoE layer (``repro_torch/models/moe.py``) against the JAX
package's ``models/moe.py`` on the same inputs, and the MoE stacks'
train steps (Qwen3-MoE, Kimi-K2) against the reference's.

Inputs come from numpy seeds; the reference's parameters are drawn by
its ``moe_init`` and copied into the port's module by name (the names
``convert`` maps).  Bounds, stated per comparison:

* routes (each token's top ``k`` experts, in order), capacity ranks and
  ``dropped`` equal: with equal routes they are exact counts; ties (a
  zero row of ``x``, two equal router columns) keep the lower expert
  first in both;
* fp32 outputs within ``1e-5`` abs and rel (the same fp32 products in
  another order; measured ≤ 4e-7 on outputs up to 2), ``aux_loss``
  within ``1e-5`` relative, gradients within ``1e-5 (1 + |want|)``;
* bf16 outputs within ``2^-6 (1 + |want|)``: two or three bf16 ulps of
  the output.  Both packages round each expert product, ``silu(h) u``
  and the combine weights to bf16; the port sums a token's ``k``
  entries in fp32 and rounds once, where XLA's ``segment_sum`` rounds
  after each add (up to ``k - 1`` more half-ulps), and the shared
  expert's sum rounds once more (measured ≤ 0.0157 on outputs up to
  2.06, one ulp there).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import moe as rmoe

from repro_torch.convert import _flatten, serving_array
from repro_torch.models import moe as tmoe

from test_torch_hybrid import check_train_steps

CPU = "cpu"
FP32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -6, atol=2.0 ** -6)
AUX_RTOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _cfg(arch="qwen3_moe_30b_a3b", **kw):
    return dataclasses.replace(rconfigs.get_smoke_config(arch), **kw)


def _pair(cfg, seed=0):
    """The reference's MoE parameters and the port's module holding them."""
    dt = cfg.dtype
    p = rmoe.moe_init(jax.random.key(seed), cfg, jnp.dtype(dt))
    m = tmoe.MoE(cfg, dtype=getattr(torch, dt), device=CPU)
    flat = _flatten(jax.tree.map(np.asarray, p))
    state = m.state_dict()
    assert set(state) == set(flat)
    with torch.no_grad():
        for k, t in state.items():
            t.copy_(serving_array(flat[k], CPU))
    return p, m


def _ref_routes(x2d, router_w, cfg):
    """The reference's ``_moe_math`` routing: ``(topi, rank)``."""
    logits = x2d.astype(jnp.float32) @ router_w
    _, topi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    flat = topi.reshape(-1)
    return np.asarray(topi), np.asarray(rmoe._ranks_by_sort(
        flat, cfg.n_experts))


@pytest.mark.parametrize("Tk,E,seed", [(1, 4, 0), (17, 4, 1), (64, 8, 2),
                                       (300, 384, 3), (256, 2, 4)])
def test_ranks_by_sort_matches_reference(Tk, E, seed):
    flat = np.random.default_rng(seed).integers(0, E, Tk).astype(np.int32)
    want = np.asarray(rmoe._ranks_by_sort(jnp.asarray(flat), E))
    got = tmoe._ranks_by_sort(torch.from_numpy(flat).long(), E)
    assert np.array_equal(got.numpy(), want)
    # each expert's entries are ranked 0, 1, ... in entry order
    for e in range(E):
        assert np.array_equal(want[flat == e], np.arange((flat == e).sum()))


def test_route_keeps_the_lower_expert_on_ties():
    """Zero rows (every probability equal) and two equal router columns:
    the port's routes are the reference's, lower index first."""
    cfg = _cfg()
    p, m = _pair(cfg)
    w = np.asarray(p["router"]["w"]).copy()
    w[:, 5] = w[:, 2]
    x = np.random.default_rng(0).normal(size=(12, cfg.d_model)).astype(
        np.float32)
    x[:4] = 0.0
    want, _ = _ref_routes(jnp.asarray(x), jnp.asarray(w), cfg)
    probs, topw, got = tmoe.route(torch.from_numpy(x), torch.from_numpy(w),
                                  cfg.top_k)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want[:4], np.tile(np.arange(cfg.top_k), (4, 1)))
    assert torch.allclose(topw.sum(-1), torch.ones(12))
    # where experts 2 and 5 tie inside the top k, 2 comes first
    tied = (want == 2).any(1) & (want == 5).any(1)
    assert tied[4:].any()
    for row in np.nonzero(tied)[0]:
        assert list(want[row]).index(2) < list(want[row]).index(5)


CASES = {
    "plain": dict(arch="qwen3_moe_30b_a3b", kw={}, zero_rows=0),
    "overflow": dict(arch="qwen3_moe_30b_a3b",
                     kw=dict(capacity_factor=0.02), zero_rows=0),
    "shared": dict(arch="kimi_k2_1t_a32b", kw={}, zero_rows=0),
    "ties": dict(arch="qwen3_moe_30b_a3b", kw={}, zero_rows=7),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_reference(case, dtype):
    spec = CASES[case]
    cfg = _cfg(spec["arch"], dtype=dtype, **spec["kw"])
    p, m = _pair(cfg, seed=1)
    x = np.random.default_rng(1).normal(size=(2, 32, cfg.d_model)).astype(
        np.float32)
    x[0, :spec["zero_rows"]] = 0.0
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want, want_aux = rmoe.moe_apply(p, jx, cfg, None)
    got, aux = tmoe.moe_apply(m, tx, cfg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    # routes and capacity ranks
    x2d = jx.reshape(-1, cfg.d_model)
    want_i, want_rank = _ref_routes(x2d, p["router"]["w"], cfg)
    _, _, got_i = tmoe.route(tx.reshape(-1, cfg.d_model), m.router.w,
                             cfg.top_k)
    assert np.array_equal(got_i.numpy(), want_i)
    got_rank = tmoe._ranks_by_sort(got_i.reshape(-1), cfg.n_experts)
    assert np.array_equal(got_rank.numpy(), want_rank)
    C = max(1, math.ceil(x2d.shape[0] * cfg.top_k / cfg.n_experts
                         * cfg.capacity_factor))
    kept = int((want_rank < C).sum())
    assert float(aux["dropped"]) == float(want_aux["dropped"]) == \
        np.float32(1.0) - np.float32(kept) / np.float32(want_rank.size)
    if case == "overflow":
        assert float(aux["dropped"]) > 0.5
    np.testing.assert_allclose(float(aux["aux_loss"]),
                               float(want_aux["aux_loss"]), rtol=AUX_RTOL)
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_routes_is_the_dispatch_policy(case):
    """``routes`` (what ``_moe_math`` dispatches by, and what the chip
    smoke logs): the reference's top ``k`` and capacity ranks, ``kept``
    exactly the ranks below the call's capacity, and ``moe_apply``'s
    ``dropped`` the share of entries not kept; fp32."""
    spec = CASES[case]
    cfg = _cfg(spec["arch"], **spec["kw"])
    p, m = _pair(cfg, seed=4)
    x = np.random.default_rng(4).normal(size=(2, 24, cfg.d_model)).astype(
        np.float32)
    x[0, :spec["zero_rows"]] = 0.0
    x2d = torch.from_numpy(x).reshape(-1, cfg.d_model)
    probs, topw, topi, rank, kept = tmoe.routes(x2d, m.router.w, cfg)
    want_i, want_rank = _ref_routes(jnp.asarray(x2d.numpy()),
                                    p["router"]["w"], cfg)
    assert np.array_equal(topi.numpy(), want_i)
    assert np.array_equal(rank.reshape(-1).numpy(), want_rank)
    C = tmoe.capacity(x2d.shape[0], cfg)
    assert np.array_equal(kept.numpy(), (want_rank < C).reshape(topi.shape))
    _, aux = tmoe.moe_apply(m, torch.from_numpy(x), cfg)
    assert float(aux["dropped"]) == pytest.approx(
        1.0 - float(kept.float().mean()), abs=1e-7)


def test_moe_apply_equals_a_token_loop():
    """An oracle independent of both packages' dispatch: each token's
    output is the weighted sum of its kept experts' SwiGLU (an entry is
    kept when fewer than ``C`` earlier entries chose its expert), plus
    the shared expert; with capacity overflow, fp32."""
    cfg = _cfg("kimi_k2_1t_a32b", capacity_factor=0.5)
    _, m = _pair(cfg, seed=2)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 24, cfg.d_model)).astype(np.float32))
    got, aux = tmoe.moe_apply(m, x, cfg)
    x2d = x[0]
    T, k = x2d.shape[0], cfg.top_k
    C = max(1, math.ceil(T * k / cfg.n_experts * cfg.capacity_factor))
    _, topw, topi = tmoe.route(x2d, m.router.w, k)
    used = [0] * cfg.n_experts
    want = torch.zeros_like(x2d)
    dropped = 0
    for t in range(T):
        for j in range(k):
            e = int(topi[t, j])
            if used[e] >= C:
                dropped += 1
                continue
            used[e] += 1
            h = torch.nn.functional.silu(x2d[t] @ m.gate[e]) * \
                (x2d[t] @ m.up[e])
            want[t] += topw[t, j] * (h @ m.down[e])
    want = want + tmoe.layers.swiglu(m.shared, x2d)
    assert dropped > 0
    assert float(aux["dropped"]) == pytest.approx(dropped / (T * k))
    np.testing.assert_allclose(_np(got[0]), _np(want), **FP32_TOL)


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "kimi_k2_1t_a32b"])
def test_moe_gradients_match_reference(arch):
    """``jax.grad`` of ``sum(out * ct) + aux_loss`` with respect to the
    parameters and ``x``, against torch's autograd, fp32, with dropped
    tokens (capacity factor 0.5)."""
    cfg = _cfg(arch, capacity_factor=0.5)
    p, m = _pair(cfg, seed=3)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)

    def loss(params, xx):
        out, aux = rmoe.moe_apply(params, xx, cfg, None)
        return jnp.sum(out * ct) + aux["aux_loss"]

    want_p, want_x = jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(x))
    want = {**{f"p.{k}": v for k, v in _flatten(
        jax.tree.map(np.asarray, want_p)).items()}, "x": want_x}
    tx = torch.from_numpy(x).requires_grad_(True)
    params = dict(m.named_parameters())
    for t in params.values():
        t.requires_grad_(True)
    out, aux = tmoe.moe_apply(m, tx, cfg)
    total = (out * torch.from_numpy(ct)).sum() + aux["aux_loss"]
    grads = torch.autograd.grad(total, [*params.values(), tx])
    got = {**{f"p.{k}": g for k, g in zip(params, grads)}, "x": grads[-1]}
    assert float(aux["dropped"]) > 0.0 and set(got) == set(want)
    for k, w in want.items():
        w = _np(w)
        err = np.abs(_np(got[k]) - w)
        assert (err <= 1e-5 * (1 + np.abs(w))).all(), (k, err.max())


def test_moe_init_draws_the_reference_shapes():
    cfg = _cfg("kimi_k2_1t_a32b", dtype="bfloat16")
    ref = jax.eval_shape(lambda: rmoe.moe_init(jax.random.key(0), cfg,
                                               jnp.bfloat16))
    want = {k: (tuple(v.shape), v.dtype.name) for k, v in
            _flatten(ref).items()}
    m = tmoe.moe_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in m.state_dict().items()}
    assert got == want and got["router.w"][1] == "float32"
    d, ff = cfg.d_model, cfg.d_expert
    for name, sd in (("gate", d), ("up", d), ("down", ff)):
        w = getattr(m, name).float()
        assert float(w.abs().max()) <= 2 / sd ** 0.5 * (1 + 2 ** -8)
        assert 0.5 < float(w.std()) * sd ** 0.5 < 1.0
    assert not any(t.requires_grad for t in m.parameters())


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "kimi_k2_1t_a32b"])
@pytest.mark.parametrize("remat,grad_accum", [(False, 1), (True, 1),
                                              (False, 2)])
def test_moe_train_steps_match_reference(arch, remat, grad_accum):
    """Two ``make_train_step`` steps from the reference's state against
    the reference's (``tests/test_torch_hybrid.py`` states the bounds):
    with ``grad_accum=2`` each microbatch routes with its own capacity,
    as in the reference."""
    check_train_steps(arch, remat, grad_accum)
