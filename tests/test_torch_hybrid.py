"""The port's MoE, SSM and hybrid stacks against the JAX package's, on
the same inputs: the four smoke configs (Qwen3-MoE, Kimi-K2 with its
dense prologue and shared expert, Falcon-Mamba, Jamba's attention/SSM
interleave with MoE every other layer) through ``forward``, ``prefill``
and decode, ``loss_and_metrics`` and its gradients, and (Jamba here;
the other families in ``tests/test_torch_moe.py`` and
``tests/test_torch_mamba.py``) ``make_train_step``; train-state
checkpoints both ways; the CLIs.

The reference draws its parameters with threefry, which torch cannot
reproduce, so each test draws them with the reference's ``init_params``
and carries them across with ``repro_torch.convert``; tokens come from a
numpy seed.  Bounds, stated per comparison:

* logits, the loss's gradients and a train step's moments in fp32 within
  ``2e-4`` abs and rel, the LM tests' bound (``tests/test_torch_lm.py``,
  ``tests/test_torch_train.py``): the same fp32 model, summed in another
  order (here also the chunked scan over another tree, and the MoE's
  combine); parameters and master copies within ``2e-4`` relative and
  ``2e-4 lr`` absolute; the loss within ``2e-5`` relative;
* ``aux_loss`` and ``dropped`` within ``1e-5`` relative: ``dropped`` is a
  ratio of exact counts and ``aux_loss`` a sum of 8 products of exact
  counts and fp32 means, in either package;
* MoE routes equal, layer by layer: each package's top ``k`` of its own
  router probabilities in that layer (the routing is discontinuous; a
  different expert would move a token's output by its whole size);
* bf16 logits within ``0.05`` abs and rel, the LM tests' bf16 bound.

Under ``jax.disable_jit`` the reference's ``lax.scan`` runs its period
body with concrete values, so a wrapper around ``moe._moe_math`` can
record each layer's routes.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.checkpoint import restore_checkpoint as r_restore
from repro.checkpoint import save_checkpoint as r_save
from repro.launch import serve as rserve
from repro.launch import train as rtrain
from repro.models import moe as rmoe
from repro.models import transformer as RT
from repro.optim.adamw import AdamWConfig as RAdamWConfig

from repro_torch import configs as tconfigs
from repro_torch.checkpoint import restore_train_state, save_train_state
from repro_torch.convert import (_lm_tree, lm_params_from_reference,
                                 to_numpy, train_state_from_reference,
                                 train_state_to_reference)
from repro_torch.data import TokenPipeline
from repro_torch.kernels import flash_attn as tk
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT
from repro_torch.models.attention import KVCache
from repro_torch.models.mamba import SSMState
from repro_torch.optim import adamw as TA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
LM_TOL = dict(rtol=2e-4, atol=2e-4)
AUX_RTOL = 1e-5
LOSS_RTOL = 2e-5
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
#: the families this slice ports
ARCHS = ["qwen3_moe_30b_a3b", "kimi_k2_1t_a32b", "falcon_mamba_7b",
         "jamba_1_5_large_398b"]
MOE_ARCHS = ["qwen3_moe_30b_a3b", "kimi_k2_1t_a32b", "jamba_1_5_large_398b"]
#: AdamW for the train-step comparisons: eps far above the two packages'
#: rounding noise in a gradient (``tests/test_torch_train.py`` says why)
OPT_KW = dict(lr=1e-3, eps=1e-4)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def inputs(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.embed_input:
        return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)


def t_inputs(x):
    return (torch.from_numpy(x).long() if x.dtype == np.int32
            else torch.from_numpy(x))


def both(cfg, seed=0):
    """The reference's parameters and the port's model built from them."""
    params = RT.init_params(jax.random.key(seed), cfg)
    model = lm_params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                     device=CPU)
    return params, model


def assert_aux_close(got, want):
    for k in ("aux_loss", "dropped"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=AUX_RTOL, atol=1e-7, err_msg=k)


def leaves(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def assert_tree_close(got_tree, want_tree, **tol):
    got, want = leaves(got_tree), leaves(want_tree)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(np32(got[key]), np32(want[key]),
                                   err_msg=key, **tol)


# --------------------------------------------------------------------- #
# serving: prefill, the merge, decode                                   #
# --------------------------------------------------------------------- #

def ref_serve(params, cfg, prompts, gen, impl):
    """The reference's prefill, merge and ``gen - 1`` greedy decode steps;
    returns (tokens (B, gen), logits of every step)."""
    B, P = prompts.shape[:2]
    prefill = jax.jit(rserve.make_prefill(cfg, None, impl=impl))
    decode = jax.jit(rserve.make_decode_step(cfg, None))
    logits, pre = prefill(params, {"inputs": jnp.asarray(prompts)})
    cache = rserve._merge_prefill_cache(RT.init_cache(cfg, B, P + gen), pre,
                                        cfg, P)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    toks, all_logits = [tok], [logits]
    for i in range(gen - 1):
        logits, cache = decode(params, {"inputs": tok[:, None]}, cache,
                               jnp.int32(P + i))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(tok)
        all_logits.append(logits)
    return np.stack([np.asarray(t) for t in toks], 1), all_logits


def port_serve(model, cfg, prompts, gen, impl):
    B, P = prompts.shape[:2]
    prefill = tserve.make_prefill(cfg, None, impl=impl)
    decode = tserve.make_decode_step(cfg, None)
    logits, pre = prefill(model, {"inputs": t_inputs(prompts)})
    cache = tserve._merge_prefill_cache(
        TT.init_cache(cfg, B, P + gen, device=CPU, dtype=model.dtype), pre,
        cfg, P)
    tok = torch.argmax(logits, dim=-1)
    toks, all_logits = [tok], [logits]
    for i in range(gen - 1):
        logits, cache = decode(model, {"inputs": tok[:, None]}, cache, P + i)
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
        all_logits.append(logits)
    return torch.stack(toks, 1).numpy(), all_logits


def record_routes(monkeypatch):
    """Wrap both packages' ``_moe_math`` to record, per MoE call, the
    top-``k`` experts of each token by that package's own routing."""
    ref, port = [], []
    r_math, t_math = rmoe._moe_math, tmoe._moe_math

    def r_wrap(x2d, router_w, *a, **kw):
        cfg = a[3]
        probs = jax.nn.softmax(x2d.astype(jnp.float32) @ router_w, axis=-1)
        ref.append(np.asarray(jax.lax.top_k(probs, cfg.top_k)[1]))
        return r_math(x2d, router_w, *a, **kw)

    def t_wrap(x2d, router_w, *a, **kw):
        port.append(tmoe.route(x2d, router_w, a[3].top_k)[2].numpy())
        return t_math(x2d, router_w, *a, **kw)

    monkeypatch.setattr(rmoe, "_moe_math", r_wrap)
    monkeypatch.setattr(tmoe, "_moe_math", t_wrap)
    return ref, port


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_forward_matches_reference(arch, impl, monkeypatch):
    """Logits within ``2e-4``, the summed aux within ``1e-5``, and every
    MoE layer's routes equal to the reference's."""
    cfg = rconfigs.get_smoke_config(arch)
    params, model = both(cfg)
    x = inputs(cfg, 2, 16)
    routes = record_routes(monkeypatch)
    with jax.disable_jit():
        want, _, want_aux = RT.forward(params, cfg, jnp.asarray(x),
                                       impl=impl)
    got, _, aux = TT.forward(model, tconfigs.get_smoke_config(arch),
                             t_inputs(x), impl=impl)
    assert got.shape == (2, 16, cfg.vocab_size)
    np.testing.assert_allclose(np32(got), np32(want), **LM_TOL)
    assert_aux_close(aux, want_aux)
    n_moe = sum(cfg.mlp_kind(i) == "moe" for i in range(cfg.n_layers))
    assert len(routes[0]) == len(routes[1]) == n_moe
    for r, t in zip(*routes):
        assert np.array_equal(r, t)
    if arch in MOE_ARCHS:
        assert float(aux["aux_loss"]) > 0.0
    else:
        assert float(aux["aux_loss"]) == float(aux["dropped"]) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_prefill_decode_greedy_match_reference(arch, impl):
    """Prefill, the merge (KV caches written, SSM states carried) and 3
    greedy decode steps: logits within ``2e-4`` of the reference's at
    every step, the same tokens."""
    cfg = rconfigs.get_smoke_config(arch)
    params, model = both(cfg, seed=1)
    prompts = inputs(cfg, 3, 12, seed=1)
    want_toks, want = ref_serve(params, cfg, prompts, 4, impl)
    got_toks, got = port_serve(model, cfg, prompts, 4, impl)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np32(g), np32(w), **LM_TOL)
    assert np.array_equal(got_toks, want_toks)


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b",
                                  "jamba_1_5_large_398b"])
def test_bf16_prefill_decode_match_reference(arch):
    """The smoke model stored in bf16, as the full models serve: logits
    within ``0.05`` of the reference's, prefill and decode; the fp32
    leaves (norms, the router, ``dt_bias``, ``A_log``, ``D``) stay fp32."""
    cfg = dataclasses.replace(rconfigs.get_smoke_config(arch),
                              dtype="bfloat16")
    params, model = both(cfg, seed=2)
    assert model.dtype == torch.bfloat16
    for name, t in model.state_dict().items():
        want = torch.float32 if name.endswith(
            ("scale", "router.w", "dt_bias", "A_log", ".D")) \
            else torch.bfloat16
        assert t.dtype == want, name
    prompts = inputs(cfg, 2, 16, seed=2)
    _, want = ref_serve(params, cfg, prompts, 3, "pallas")
    _, got = port_serve(model, cfg, prompts, 3, "pallas")
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(np32(g), np32(w), **BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_matches_full_forward(arch):
    """Inside the port: prefill(x[:t]) then decode(x[t]) gives forward(x)
    at t (``tests/test_models.py``'s check, at its bound).  For an MoE
    stack the check uses a capacity no step can overflow: a decode step's
    capacity comes from its own B tokens, so with the config's capacity
    factor the two may drop different tokens (the reference's
    semantics)."""
    cfg = tconfigs.get_smoke_config(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    model = TT.init_params(0, cfg, device=CPU)
    B, S = 2, 12
    x = t_inputs(inputs(cfg, B, S))
    full, _, _ = TT.forward(model, cfg, x)
    last, pre = TT.prefill(model, cfg, x[:, :S - 1])
    np.testing.assert_allclose(np32(last), np32(full[:, S - 2]), **LM_TOL)
    cache = tserve._merge_prefill_cache(
        TT.init_cache(cfg, B, S + 2, device=CPU), pre, cfg, S - 1)
    for i, c in enumerate(cache):
        want = KVCache if cfg.layer_kind(i) == "attn" else SSMState
        assert isinstance(c, want)
        if want is SSMState:
            assert c is pre[i]
    dec, cache = TT.decode_step(model, cfg, x[:, S - 1:S], cache, S - 1)
    np.testing.assert_allclose(np32(dec), np32(full[:, S - 1]), **LM_TOL)


# --------------------------------------------------------------------- #
# loss_and_metrics and its gradients                                    #
# --------------------------------------------------------------------- #

def batch_of(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"inputs": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}


_REF_GRADS = {}


def ref_value_and_grad(arch, cfg, params, batch):
    if arch not in _REF_GRADS:
        fn = jax.value_and_grad(
            lambda p: RT.loss_and_metrics(
                p, cfg, {k: jnp.asarray(v) for k, v in batch.items()},
                impl="xla"), has_aux=True)
        (loss, metrics), grads = fn(params)
        _REF_GRADS[arch] = (float(loss), jax.tree.map(np.asarray, metrics),
                            jax.tree.map(np.asarray, grads))
    return _REF_GRADS[arch]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_loss_and_grads_match_reference(arch, impl):
    """The loss (xent plus 0.01 of the summed MoE aux) and every
    parameter's gradient against ``jax.value_and_grad`` of the
    reference's ``impl="xla"`` loss (its Pallas kernel has no VJP)."""
    cfg = rconfigs.get_smoke_config(arch)
    params = RT.init_params(jax.random.key(0), cfg)
    batch = batch_of(cfg)
    loss, metrics, grads = ref_value_and_grad(arch, cfg, params, batch)
    model = lm_params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                     device=CPU)
    tb = ttrain.to_device(batch, CPU)
    tgrads, tm = ttrain.grads_and_metrics(model, cfg, tb, impl=impl)
    assert set(tm) == set(metrics)
    assert abs(float(tm["loss"]) - loss) <= LOSS_RTOL * abs(loss)
    assert_aux_close(tm, metrics)
    assert not any(p.requires_grad for p in model.parameters())
    assert_tree_close(_lm_tree({k: to_numpy(g) for k, g in tgrads.items()},
                               cfg, np.stack), grads, **LM_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_remat_keeps_the_moe_aux(arch):
    """With ``remat`` the checkpointed layer returns its aux: the loss,
    ``aux_loss`` and ``dropped`` are those without remat, bitwise, and
    so are the gradients (the recomputation routes the same way)."""
    cfg = tconfigs.get_smoke_config(arch)
    batch = ttrain.to_device(batch_of(cfg), CPU)
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        model = TT.init_params(0, c, device=CPU)
        out.append(ttrain.grads_and_metrics(model, c, batch))
    (g0, m0), (g1, m1) = out
    assert float(m0["aux_loss"]) > 0.0
    for k in ("loss", "aux_loss", "dropped"):
        assert float(m1[k]) == float(m0[k]), k
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


# --------------------------------------------------------------------- #
# make_train_step                                                       #
# --------------------------------------------------------------------- #

_REF_STEPS = {}
STEPS = 2


def ref_train(arch, grad_accum):
    """The reference's state after :data:`STEPS` steps (no warm-up) on
    ``TokenPipeline`` batches of 4 x 16, and each step's metrics; the
    initial state as numpy.  Cached per (arch, grad_accum): remat does
    not change the reference's arithmetic."""
    key = (arch, grad_accum)
    if key not in _REF_STEPS:
        cfg = rconfigs.get_smoke_config(arch)
        state = rtrain.init_state(jax.random.key(1), cfg,
                                  RAdamWConfig(**OPT_KW))
        init = jax.tree.map(np.asarray, state)
        step = jax.jit(rtrain.make_train_step(
            cfg, None, RAdamWConfig(**OPT_KW), total_steps=STEPS, warmup=0,
            grad_accum=grad_accum))
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=16,
                             global_batch=4)
        metrics = []
        for s in range(STEPS):
            state, m = step(state, {k: jnp.asarray(v) for k, v in
                                    pipe.batch_at(s).items()})
            metrics.append(jax.tree.map(np.asarray, m))
        _REF_STEPS[key] = (init, jax.tree.map(np.asarray, state), metrics)
    return _REF_STEPS[key]


def check_train_steps(arch, remat, grad_accum):
    """:data:`STEPS` steps of the port's ``make_train_step`` from the
    reference's initial state against the reference's: each step's
    metrics, then the parameters, master copies and moments."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), remat=remat)
    init, want, want_m = ref_train(arch, grad_accum)
    tstate = train_state_from_reference(init, cfg, device=CPU)
    step = ttrain.make_train_step(cfg, None, TA.AdamWConfig(**OPT_KW),
                                  total_steps=STEPS, warmup=0,
                                  grad_accum=grad_accum)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=16,
                         global_batch=4)
    for s in range(STEPS):
        tstate, tm = step(tstate, pipe.batch_at(s))
        rm = want_m[s]
        assert set(tm) == set(rm)
        assert abs(float(tm["loss"]) - float(rm["loss"])) <= \
            LOSS_RTOL * abs(float(rm["loss"]))
        assert_aux_close(tm, rm)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=2e-4)
    got = train_state_to_reference(tstate, cfg)
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == STEPS
    lr_tol = dict(rtol=LM_TOL["rtol"], atol=LM_TOL["atol"] * OPT_KW["lr"])
    assert_tree_close(got["params"], want["params"], **lr_tol)
    assert_tree_close(got["opt"]["master"], want["opt"]["master"], **lr_tol)
    assert_tree_close(got["opt"]["m"], want["opt"]["m"], **LM_TOL)
    assert_tree_close(got["opt"]["v"], want["opt"]["v"], **LM_TOL)


@pytest.mark.parametrize("remat,grad_accum", [(False, 1), (True, 1),
                                              (False, 2)])
def test_jamba_train_steps_match_reference(remat, grad_accum):
    check_train_steps("jamba_1_5_large_398b", remat, grad_accum)


# --------------------------------------------------------------------- #
# checkpoints                                                           #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b",
                                  "jamba_1_5_large_398b"])
@pytest.mark.parametrize("dtype,state_dtype", [("float32", "float32"),
                                               ("bfloat16", "bfloat16")])
def test_train_state_checkpoints_interchange(tmp_path, arch, dtype,
                                             state_dtype):
    """A port train state saved by ``save_train_state`` restores in
    ``repro.checkpoint`` leaf for leaf, each leaf in the reference's
    dtype (the router, ``dt_bias``, ``A_log``, ``D`` and the norms fp32
    in a bf16 model), and the reference's saved state restores in the
    port."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), dtype=dtype)
    opt = TA.AdamWConfig(state_dtype=state_dtype)
    tstate = ttrain.init_state(0, cfg, opt, device=CPU)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for key in ("m", "v", "master"):
            for t in tstate["opt"][key].values():
                t.copy_(torch.randn(t.shape, generator=gen))
    tstate["opt"]["step"].fill_(5)
    want = train_state_to_reference(tstate, cfg)
    rlike = rtrain.init_state(jax.random.key(1), cfg,
                              RAdamWConfig(state_dtype=state_dtype))
    save_train_state(str(tmp_path / "port"), 1, tstate, cfg)
    back, step = r_restore(str(tmp_path / "port"), rlike)
    assert step == 1
    assert jax.tree.map(lambda a: a.dtype, back) == jax.tree.map(
        lambda a: a.dtype, rlike)
    assert_tree_close(jax.tree.map(np.asarray, back), want, rtol=0, atol=0)
    r_save(str(tmp_path / "ref"), 2, back)
    like = ttrain.init_state(1, cfg, opt, device=CPU)
    got, step = restore_train_state(str(tmp_path / "ref"), like, cfg)
    assert step == 2 and got["params"].dtype == getattr(torch, dtype)
    for name, t in got["params"].state_dict().items():
        assert t.dtype == tstate["params"].state_dict()[name].dtype, name
    assert_tree_close(train_state_to_reference(got, cfg), want, rtol=0,
                      atol=0)


# --------------------------------------------------------------------- #
# the entry points                                                      #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_cache_layout(arch):
    """``init_params`` draws every leaf the reference's ``init_params``
    has, in its dtype and shape (unstacked), ``param_count()`` of them;
    ``init_cache`` holds a KV cache per attention layer and an SSM state
    (``conv`` in the model's dtype, ``ssm`` fp32) per SSM layer."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                              dtype="bfloat16")
    model = TT.init_params(3, cfg, device=CPU)
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    ref = jax.eval_shape(lambda: RT.init_params(jax.random.key(0), cfg))
    got = _lm_tree({k: to_numpy(v) for k, v in model.state_dict().items()},
                   cfg, np.stack)
    ref_leaves, got_leaves = leaves(ref), leaves(got)
    assert set(ref_leaves) == set(got_leaves)
    for k, r in ref_leaves.items():
        carrier = np.float32 if r.dtype.name == "bfloat16" else r.dtype
        assert got_leaves[k].shape == r.shape and \
            got_leaves[k].dtype == carrier, k
    for i, layer in enumerate(model.layers):
        if cfg.layer_kind(i) == "ssm":
            m = layer.mixer
            assert m.dt_bias.dtype == m.A_log.dtype == m.D.dtype == \
                torch.float32
            dt = torch.nn.functional.softplus(m.dt_bias)
            assert float(dt.min()) >= 1e-3 * 0.999 and \
                float(dt.max()) <= 0.1 * 1.001
            assert torch.equal(m.A_log[0], torch.log(torch.arange(
                1, cfg.ssm_state + 1, dtype=torch.float32)))
    cache = TT.init_cache(cfg, 2, 8, device=CPU)
    for i, c in enumerate(cache):
        if cfg.layer_kind(i) == "attn":
            assert isinstance(c, KVCache) and c.k.dtype == torch.bfloat16
        else:
            assert isinstance(c, SSMState)
            assert c.conv.shape == (2, cfg.ssm_conv - 1, cfg.d_inner)
            assert c.conv.dtype == torch.bfloat16
            assert c.ssm.shape == (2, cfg.d_inner, cfg.ssm_state)
            assert c.ssm.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_and_cli_serve_the_family(arch, capsys):
    """``launch.serve.generate`` gives the greedy tokens of the
    step-by-step serve and launches nothing on the CPU; the CLI serves
    the smoke config with ``--arch``."""
    cfg = tconfigs.get_smoke_config(arch)
    model = TT.init_params(0, cfg, device=CPU)
    prompts = inputs(cfg, 2, 8)
    tk.reset_launches()
    toks, t = tserve.generate(model, cfg, t_inputs(prompts), 4)
    assert toks.shape == (2, 4) and tk.flash_attention.launches == 0
    want, _ = port_serve(model, cfg, prompts, 4, "pallas")
    assert np.array_equal(toks.numpy(), want)
    assert tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--temperature", "0", "--prompt-len", "8", "--gen",
                        "4", "--batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "prefill 8 toks x2" in out and "on cpu" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_the_family(arch, capsys):
    ttrain.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                 "3", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "3 steps in" in out and "on cpu" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step")]
    assert losses and all(np.isfinite(losses))


def test_a_sharding_context_serves_and_trains_on_one_rank():
    """The MoE and SSM layers take a ``ctx``: on a mesh of one rank (no
    process group) ``forward``, ``decode_step`` and ``moe_apply`` serve
    and equal the unsharded ones bitwise (``tests/test_torch_lm_ep_spmd.py``
    serves on 4 ranks), and they train with it: a forward under autograd
    gives the unsharded logits bitwise, and one step of
    ``make_train_step(cfg, ctx, ...)`` from ``init_state(ctx=)`` equals the
    unsharded step (its loss and the MoE's aux bitwise, the parameters
    after it within ``rtol=1e-5, atol=1e-6``: the vocabulary-parallel
    cross-entropy's backward rounds otherwise than the unsharded one's;
    ``tests/test_torch_lm_train_ep_spmd.py`` trains on 4 ranks)."""
    from repro_torch.distributed.sharding import make_ctx
    from repro_torch.launch.mesh import make_test_mesh
    ctx = make_ctx(make_test_mesh(1, 1, device=CPU))
    for arch in ("qwen3_moe_30b_a3b", "falcon_mamba_7b"):
        cfg = tconfigs.get_smoke_config(arch)
        model = TT.init_params(0, cfg, device=CPU)
        x = torch.from_numpy(inputs(cfg, 1, 4)).long()
        with torch.no_grad():
            want = TT.forward(model, cfg, x)[0]
            assert torch.equal(TT.forward(model, cfg, x, ctx=ctx)[0], want)
            steps = [TT.decode_step(model, cfg, x[:, :1],
                                    TT.init_cache(cfg, 1, 8, device=CPU,
                                                  ctx=c), 0, ctx=c)[0]
                     for c in (None, ctx)]
        assert torch.equal(steps[1], steps[0])
        model.requires_grad_(True)
        assert torch.equal(TT.forward(model, cfg, x, ctx=ctx)[0], want)
        opt = TA.AdamWConfig(**OPT_KW)
        batch = batch_of(cfg)
        runs = [ttrain.make_train_step(cfg, c, opt, warmup=0, total_steps=2)(
            ttrain.init_state(0, cfg, opt, device=CPU, ctx=c), batch)
            for c in (None, ctx)]
        (want_s, wm), (got_s, gm) = runs
        for k in ("loss", "xent", "aux_loss", "dropped", "lr"):
            assert float(gm[k]) == float(wm[k]), k
        want_p = dict(want_s["params"].named_parameters())
        for k, p in got_s["params"].named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       want_p[k].detach().numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    cfg = tconfigs.get_smoke_config("qwen3_moe_30b_a3b")
    layer = TT.init_params(0, cfg, device=CPU).layers[0]
    h = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 2, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        want, want_aux = tmoe.moe_apply(layer.moe, h, cfg)
        got, aux = tmoe.moe_apply(layer.moe, h, cfg, ctx=ctx, batch=1)
    assert torch.equal(got, want)
    assert_aux_close(aux, want_aux)
    with pytest.raises(ValueError, match="batch"):
        tmoe.moe_apply(layer.moe, h, cfg, ctx=ctx)


def test_port_models_import_neither_jax_nor_reference():
    code = ("import sys\n"
            "import repro_torch.models.moe, repro_torch.models.mamba, "
            "repro_torch.models.transformer, repro_torch.launch.serve, "
            "repro_torch.launch.train, repro_torch.distributed, "
            "repro_torch.distributed.tp, repro_torch.distributed.ring, "
            "repro_torch.launch.specs, repro_torch.launch.mesh\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
