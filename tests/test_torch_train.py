"""The port's LM training path against the JAX package's, on the same
inputs: the flash backward, ``loss_and_metrics`` and its gradients,
``make_train_step``, ``TokenPipeline``, train-state checkpoints and the
trainer's CLI.

Parameters are drawn by the reference (threefry) and carried across with
``repro_torch.convert``; batches come from numpy seeds.  Bounds, stated
per comparison:

* the flash backward against ``jax.grad`` of the reference's
  ``flash_attention_xla``: fp32 within ``1e-5 (1 + |want|)`` (the same
  fp32 products summed in another order, over at most S keys);
  bf16 within that plus two bf16 ulps of the result
  (``repro_torch.testing.low_precision_tolerance``: both sides widen the
  same bf16 inputs, compute in fp32 and round each gradient once); ``L``
  within ``1e-5 (1 + |L|)`` in both;
* ``torch.autograd.gradcheck`` in float64 (its own finite differences);
* the loss within ``2e-5`` relative; gradients and three train steps'
  moments within ``2e-4`` abs and rel, the bound the LM serving tests
  hold fp32 logits to (``tests/test_torch_lm.py``): the same fp32 model,
  summed in another order; parameters and master copies move by steps of
  about ``lr``, so they compare within ``2e-4`` relative and ``2e-4 lr``
  absolute;
* ``TokenPipeline`` batches and checkpointed arrays bitwise.

The CPU path launches no kernel; the one test that needs the card (the
kernel's ``L`` against its plain version) takes the ``requires_cuda``
fixture and skips here.
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
from repro.data.pipeline import TokenPipeline as RPipe
from repro.launch import train as rtrain
from repro.models import flash_xla as rfx
from repro.models import transformer as RT
from repro.optim.adamw import AdamWConfig as RAdamWConfig

from repro_torch import configs as tconfigs
from repro_torch.checkpoint import restore_train_state, save_train_state
from repro_torch.convert import (_lm_tree, lm_params_from_reference,
                                 to_numpy, train_state_from_reference,
                                 train_state_to_reference)
from repro_torch.data import TokenPipeline
from repro_torch.kernels import flash_attn as tk
from repro_torch.launch import train as ttrain
from repro_torch.models import flash_xla as tfx
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as TA
from repro_torch.testing import low_precision_tolerance

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
FLASH_REL = 1e-5
LM_TOL = dict(rtol=2e-4, atol=2e-4)
LOSS_RTOL = 2e-5
ARCH = "qwen2_5_32b"


@pytest.fixture
def requires_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _within(got, want, tol):
    g = torch.as_tensor(_np(got)).double()
    w = torch.as_tensor(_np(want)).double()
    err = (g - w).abs()
    assert bool((err <= tol(w)).all()), float(err.max())


# --------------------------------------------------------------------- #
# the flash backward                                                    #
# --------------------------------------------------------------------- #

def _qkv(B, Hq, Hkv, S, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, S, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    ct = rng.normal(size=(B, Hq, S, D)).astype(np.float32)
    return q, k, v, ct


def _port_grads(fn, q, k, v, ct, dtype):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(True)
          for a in (q, k, v)]
    o = fn(*ts)
    (o.float() * torch.from_numpy(ct)).sum().backward()
    return o, [t.grad for t in ts]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_xla_grads_and_lse_match_reference(dtype, causal):
    B, Hq, Hkv, S, D, chunk = 2, 4, 2, 128, 16, 32     # GQA, chunk < S
    q, k, v, ct = _qkv(B, Hq, Hkv, S, D)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))

    def loss(a, b, c):
        o = rfx.flash_attention_xla(a, b, c, causal, chunk)
        return jnp.sum(o.astype(jnp.float32) * ct)

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    want_o, res = rfx._fwd(jq, jk, jv, causal, chunk)
    want_L = np.asarray(res[4]).reshape(B, Hq, S)
    o, got = _port_grads(
        lambda a, b, c: tfx.flash_attention_xla(a, b, c, causal, chunk),
        q, k, v, ct, tdt)
    fp32 = lambda w: FLASH_REL * (1 + w.abs())
    tol = fp32 if dtype == "float32" else (
        lambda w: low_precision_tolerance(w, tdt, fp32_rel=FLASH_REL))
    _within(o, want_o, tol)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == tdt and g.shape == t.shape
        _within(g, w, tol)
    _, L = tk.flash_attention_plain(*(torch.from_numpy(a).to(tdt)
                                      for a in (q, k, v)), causal=causal,
                                    block_q=chunk, block_k=chunk,
                                    return_lse=True)
    assert L.dtype == torch.float32 and L.shape == (B, Hq, S)
    _within(L, want_L, fp32)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_gradcheck_float64(causal):
    q, k, v, _ = _qkv(1, 2, 1, 8, 4, seed=1)
    ts = [torch.from_numpy(a).double().requires_grad_(True)
          for a in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda a, b, c: tfx.flash_attention_xla(a, b, c, causal, 4), ts,
        eps=1e-6, atol=1e-7, rtol=1e-5)
    # one chunk: no row is skipped
    assert torch.autograd.gradcheck(
        lambda a, b, c: tfx.flash_attention_xla(a, b, c, causal, 8), ts,
        eps=1e-6, atol=1e-7, rtol=1e-5)


def test_kernel_function_on_cpu_equals_plain():
    """On CPU tensors the kernel-forward Function runs the plain version;
    with one key block on both sides the two are bitwise equal."""
    q, k, v, ct = _qkv(2, 4, 2, 128, 16, seed=2)
    before = tk.flash_attention.launches
    o1, g1 = _port_grads(lambda a, b, c: tfx.flash_attention_kernel(
        a, b, c, True, 1024), q, k, v, ct, torch.float32)
    o2, g2 = _port_grads(lambda a, b, c: tfx.flash_attention_xla(
        a, b, c, True, 1024), q, k, v, ct, torch.float32)
    assert tk.flash_attention.launches == before
    assert torch.equal(o1, o2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_xla_naive_differentiates_through_its_loop():
    """``chunked_attention`` records every chunk for autograd (no flash
    backward) and agrees with the flash backward's gradients."""
    from repro_torch.models.attention import chunked_attention
    q, k, v, ct = _qkv(1, 4, 2, 64, 16, seed=3)
    o, g = _port_grads(lambda a, b, c: chunked_attention(
        a, b, c, causal=True, chunk=16), q, k, v, ct, torch.float32)
    assert o.grad_fn is not None and "Flash" not in type(o.grad_fn).__name__
    _, want = _port_grads(lambda a, b, c: tfx.flash_attention_xla(
        a, b, c, True, 16), q, k, v, ct, torch.float32)
    for a, b in zip(g, want):
        _within(a, b, lambda w: FLASH_REL * (1 + w.abs()))


# --------------------------------------------------------------------- #
# loss_and_metrics and its gradients                                    #
# --------------------------------------------------------------------- #

def _cfg(remat=False, **kw):
    return dataclasses.replace(rconfigs.get_smoke_config(ARCH),
                               remat=remat, **kw)


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"inputs": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}


_REF_GRADS = {}


def _ref_value_and_grad(params, cfg, batch, impl):
    key = (impl, cfg.remat)
    if key not in _REF_GRADS:
        fn = jax.value_and_grad(
            lambda p: RT.loss_and_metrics(p, cfg, batch, impl=impl),
            has_aux=True)
        (loss, metrics), grads = fn(params)
        _REF_GRADS[key] = (float(loss), jax.tree.map(np.asarray, metrics),
                           jax.tree.map(np.asarray, grads))
    return _REF_GRADS[key]


def _leaves(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_tree_close(got_tree, want_tree, **tol):
    got, want = _leaves(got_tree), _leaves(want_tree)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(_np(got[key]), _np(want[key]),
                                   err_msg=key, **tol)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("impl", ["pallas", "xla", "xla_naive"])
def test_loss_and_grads_match_reference(impl, remat):
    cfg = _cfg(remat)
    params = RT.init_params(jax.random.key(0), cfg)
    batch = _batch(cfg)
    # the reference's Pallas kernel has no VJP: its "xla" is the yardstick
    loss, metrics, grads = _ref_value_and_grad(
        params, cfg, {k: jnp.asarray(v) for k, v in batch.items()},
        "xla_naive" if impl == "xla_naive" else "xla")
    model = lm_params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                     device=CPU)
    tb = ttrain.to_device(batch, CPU)
    tloss, tmetrics = TT.loss_and_metrics(model, cfg, tb, impl=impl)
    assert abs(float(tloss) - loss) <= LOSS_RTOL * abs(loss)
    assert set(tmetrics) == set(metrics) == {"loss", "xent", "aux_loss",
                                             "dropped"}
    assert float(tmetrics["aux_loss"]) == float(tmetrics["dropped"]) == 0.0
    tgrads, tm = ttrain.grads_and_metrics(model, cfg, tb, impl=impl)
    assert not any(p.requires_grad for p in model.parameters())
    assert float(tm["loss"]) == float(tloss)
    _assert_tree_close(_lm_tree({k: to_numpy(g) for k, g in tgrads.items()},
                                cfg, np.stack), grads, **LM_TOL)


def test_remat_recomputes_each_layer():
    """Under remat the flash forward runs twice a layer (the forward and
    its recomputation in the backward), without it once; the gradients
    are bitwise the same."""
    counts, plain = [], tk.flash_attention_plain

    def counted(*a, **kw):
        counts[-1] += 1
        return plain(*a, **kw)

    cfg = tconfigs.get_smoke_config(ARCH)
    batch = ttrain.to_device(_batch(cfg), CPU)
    out = []
    tk.flash_attention_plain = counted
    try:
        for remat in (False, True):
            counts.append(0)
            model = TT.init_params(0, dataclasses.replace(cfg, remat=remat),
                                   device=CPU)
            out.append(ttrain.grads_and_metrics(
                model, dataclasses.replace(cfg, remat=remat), batch,
                impl="pallas")[0])
    finally:
        tk.flash_attention_plain = plain
    assert counts == [cfg.n_layers, 2 * cfg.n_layers]
    assert all(torch.equal(out[0][k], out[1][k]) for k in out[0])


def test_cross_entropy_grad_matches_reference_with_ignored_labels():
    from repro.models import layers as rlayers
    from repro_torch.models import layers as tlayers
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = -100
    want_l, want_g = jax.value_and_grad(rlayers.cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels))
    t = torch.from_numpy(logits).requires_grad_(True)
    got_l = tlayers.cross_entropy(t, torch.from_numpy(labels).long())
    got_l.backward()
    np.testing.assert_allclose(float(got_l.detach()), float(want_l),
                               rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-7)
    assert not t.grad[0, :3].any()


# --------------------------------------------------------------------- #
# make_train_step                                                       #
# --------------------------------------------------------------------- #

def _states(cfg, opt_kw):
    rstate = rtrain.init_state(jax.random.key(1), cfg,
                               RAdamWConfig(**opt_kw))
    tstate = train_state_from_reference(jax.tree.map(np.asarray, rstate),
                                        cfg, device=CPU)
    return rstate, tstate


@pytest.mark.parametrize("grad_accum,impl", [(1, "pallas"), (1, "xla"),
                                             (2, "pallas")])
def test_train_steps_match_reference(grad_accum, impl):
    cfg = _cfg(remat=True)
    # Adam's step is scale-free: an element whose gradient is at the level
    # of the two frameworks' rounding noise (wk's bias in the rope
    # dimensions that barely turn over 16 positions, where it is nearly a
    # shift the softmax cancels) takes an lr-sized step of either sign.
    # eps far above that noise (and far below the other gradients) keeps
    # the comparison on the arithmetic; test_torch_optim holds the default
    # eps to the reference on well-conditioned inputs.
    opt_kw = dict(lr=1e-3, eps=1e-4)
    rstate, tstate = _states(cfg, opt_kw)
    kw = dict(total_steps=3, warmup=1, grad_accum=grad_accum)
    rstep = jax.jit(rtrain.make_train_step(cfg, None, RAdamWConfig(**opt_kw),
                                           **kw))
    tstep = ttrain.make_train_step(cfg, None, TA.AdamWConfig(**opt_kw),
                                   impl=impl, **kw)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=16,
                         global_batch=4)
    for step in range(3):
        batch = pipe.batch_at(step)
        rstate, rm = rstep(rstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        assert set(tm) == set(rm)
        assert abs(float(tm["loss"]) - float(rm["loss"])) <= \
            LOSS_RTOL * abs(float(rm["loss"]))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=2e-4)
        np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]),
                                   rtol=1e-6)
    got = train_state_to_reference(tstate, cfg)
    want = jax.tree.map(np.asarray, rstate)
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 3
    # parameters and the master copy move by lr-sized steps: compare in
    # units of lr; the moments as the gradients are
    lr_tol = dict(rtol=LM_TOL["rtol"], atol=LM_TOL["atol"] * opt_kw["lr"])
    _assert_tree_close(got["params"], want["params"], **lr_tol)
    _assert_tree_close(got["opt"]["master"], want["opt"]["master"], **lr_tol)
    _assert_tree_close(got["opt"]["m"], want["opt"]["m"], **LM_TOL)
    _assert_tree_close(got["opt"]["v"], want["opt"]["v"], **LM_TOL)


def test_train_step_launches_nothing_on_cpu_and_learns():
    cfg = _cfg(remat=True)
    opt = TA.AdamWConfig(lr=1e-2)
    state = ttrain.init_state(0, cfg, opt, device=CPU)
    step = ttrain.make_train_step(cfg, None, opt, warmup=0, total_steps=5)
    batch = _batch(cfg, B=2, S=32)
    before = tk.flash_attention.launches
    losses = []
    for _ in range(5):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert tk.flash_attention.launches == before
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    assert int(state["opt"]["step"]) == 5


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    cfg = _cfg()
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.init_state(0, cfg, TA.AdamWConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--smoke", "--steps", "1"])


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "falcon_mamba_7b",
                                  "jamba_1_5_large_398b"])
def test_training_runs_the_moe_and_ssm_families(arch):
    """``init_state`` and ``make_train_step`` build for the MoE, SSM and
    hybrid configs and a step runs on the CPU (the loss carries the MoE
    aux; ``tests/test_torch_hybrid.py`` and the family files hold the
    steps to the reference).  With a sharding context on a mesh of one
    rank, ``init_state(ctx=)`` draws the same state and one step of
    ``make_train_step(cfg, ctx, ...)`` equals the unsharded step: its
    loss, ``xent``, ``aux_loss``, ``dropped`` and ``lr`` bitwise, its
    gradients and ``grad_norm`` within the one-rank bounds of
    :func:`test_training_refuses_a_sharding_context` (the
    vocabulary-parallel cross-entropy's backward, ``(softmax - onehot)
    g``, rounds otherwise than autograd of the unsharded one), and the
    parameters after it likewise, at an eps far above that rounding
    (``tests/test_torch_lm_train_spmd.py`` says why;
    ``tests/test_torch_lm_train_ep_spmd.py`` trains on 4 ranks)."""
    cfg = tconfigs.get_smoke_config(arch)
    opt = TA.AdamWConfig()
    state = ttrain.init_state(0, cfg, opt, device=CPU)
    step = ttrain.make_train_step(cfg, None, opt, warmup=0, total_steps=2)
    state, m = step(state, _batch(cfg))
    assert int(state["opt"]["step"]) == 1
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
    assert float(m["loss"]) == pytest.approx(
        float(m["xent"]) + 0.01 * float(m["aux_loss"]), rel=1e-6)
    assert (float(m["aux_loss"]) > 0) == bool(cfg.n_experts)
    from repro_torch.distributed.sharding import make_ctx
    from repro_torch.launch.mesh import make_test_mesh
    ctx = make_ctx(make_test_mesh(1, 1, device=CPU))
    opt = TA.AdamWConfig(lr=1e-3, eps=1e-4)
    batch = _batch(cfg)
    runs = []
    for c in (None, ctx):
        state = ttrain.init_state(0, cfg, opt, device=CPU, ctx=c)
        grads, _ = ttrain.grads_and_metrics(
            state["params"], cfg, ttrain.to_device(batch, CPU), ctx=c)
        step = ttrain.make_train_step(cfg, c, opt, warmup=0, total_steps=2)
        runs.append((grads,) + step(state, batch))
    (want_g, want, wm), (got_g, got, gm) = runs
    for k in ("loss", "xent", "aux_loss", "dropped", "lr"):
        assert float(gm[k]) == float(wm[k]), k
    assert float(gm["grad_norm"]) == pytest.approx(float(wm["grad_norm"]),
                                                   rel=1e-5)
    want_p = dict(want["params"].named_parameters())
    for k, p in got["params"].named_parameters():
        np.testing.assert_allclose(got_g[k].numpy(), want_g[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(p.detach().numpy(),
                                   want_p[k].detach().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_training_refuses_a_sharding_context():
    """A ctx that is not a ``ShardingCtx`` raises ``TypeError`` in
    ``make_train_step``, ``init_state`` and ``loss_and_metrics``; a
    real one on a mesh of one rank trains the dense smoke model to the
    same gradients as no ctx (``tests/test_torch_lm_train_spmd.py``
    trains on 4 ranks)."""
    from repro_torch.distributed.sharding import make_ctx
    from repro_torch.launch.mesh import make_test_mesh
    cfg = _cfg()
    with pytest.raises(TypeError, match="ShardingCtx"):
        ttrain.make_train_step(cfg, object(), TA.AdamWConfig())
    with pytest.raises(TypeError, match="ShardingCtx"):
        ttrain.init_state(0, cfg, TA.AdamWConfig(), device=CPU,
                          ctx=object())
    model = TT.init_params(0, cfg, device=CPU)
    batch = ttrain.to_device(_batch(cfg), CPU)
    with pytest.raises(TypeError, match="ShardingCtx"):
        TT.loss_and_metrics(model, cfg, batch, ctx=object())
    ctx = make_ctx(make_test_mesh(1, 1, device=CPU))
    want, wm = ttrain.grads_and_metrics(model, cfg, batch)
    got, gm = ttrain.grads_and_metrics(model, cfg, batch, ctx=ctx)
    assert float(gm["loss"]) == pytest.approx(float(wm["loss"]), rel=1e-6)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


# --------------------------------------------------------------------- #
# TokenPipeline                                                         #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("kw", [
    dict(vocab_size=100, seq_len=32, global_batch=4),
    dict(vocab_size=50, seq_len=16, global_batch=8, n_shards=2, shard_id=1,
         seed=7),
    dict(vocab_size=64, seq_len=8, global_batch=2, embed_input=False,
         d_model=12, seed=3, mean_doc_len=5),
])
def test_token_pipeline_bitwise_reference(kw):
    got, want = TokenPipeline(**kw), RPipe(**kw)
    assert got.local_batch == want.local_batch
    for step in (0, 1, 17):
        g, w = got.batch_at(step), want.batch_at(step)
        assert set(g) == set(w)
        for key in w:
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])
    it = iter(got)
    np.testing.assert_array_equal(next(it)["labels"],
                                  got.batch_at(0)["labels"])
    with pytest.raises(ValueError, match="n_shards"):
        TokenPipeline(vocab_size=10, seq_len=4, global_batch=3,
                      n_shards=2).local_batch


# --------------------------------------------------------------------- #
# checkpoints and the CLI                                               #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype,state_dtype", [("float32", "float32"),
                                               ("bfloat16", "bfloat16")])
def test_train_state_checkpoints_interchange(tmp_path, dtype, state_dtype):
    cfg = _cfg(dtype=dtype)
    opt = TA.AdamWConfig(state_dtype=state_dtype)
    # a port state whose every leaf holds its own values
    tstate = ttrain.init_state(0, cfg, opt, device=CPU)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for key in ("m", "v", "master"):
            for t in tstate["opt"][key].values():
                t.copy_(torch.randn(t.shape, generator=gen))
    tstate["opt"]["step"].fill_(7)
    want = train_state_to_reference(tstate, cfg)
    assert tstate["params"].dtype == getattr(torch, dtype)
    assert tstate["opt"]["m"]["layers.0.mixer.wq.w"].dtype == getattr(
        torch, state_dtype)
    rlike = rtrain.init_state(jax.random.key(1), cfg,
                              RAdamWConfig(state_dtype=state_dtype))
    # the port writes, the reference reads
    save_train_state(str(tmp_path / "port"), 1, tstate, cfg)
    back, step = r_restore(str(tmp_path / "port"), rlike)
    assert step == 1
    assert jax.tree.map(lambda a: a.dtype, back) == jax.tree.map(
        lambda a: a.dtype, rlike)
    _assert_tree_close(jax.tree.map(np.asarray, back), want, rtol=0, atol=0)
    # the reference writes, the port reads
    r_save(str(tmp_path / "ref"), 2, back)
    like = ttrain.init_state(1, cfg, opt, device=CPU)
    got, step = restore_train_state(str(tmp_path / "ref"), like, cfg)
    assert step == 2
    assert got["opt"]["step"].dtype == torch.int32
    assert got["params"].dtype == getattr(torch, dtype)
    _assert_tree_close(train_state_to_reference(got, cfg), want, rtol=0,
                       atol=0)
    assert restore_train_state(str(tmp_path / "none"), like, cfg) == (
        None, None)


def _cli(args, capsys):
    ttrain.main(["--smoke", "--device", "cpu", "--batch", "2", "--seq",
                 "16", "--ckpt-every", "2", *args])
    return capsys.readouterr().out


def test_cli_runs_and_resumes(tmp_path, capsys):
    """Two steps, then a resume to four, equal an uninterrupted run of
    four bitwise (checkpoints at steps 2 and 4)."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    out = _cli(["--steps", "4", "--ckpt-dir", a], capsys)
    assert "4 steps in" in out and "on cpu" in out
    out = _cli(["--steps", "2", "--ckpt-dir", b], capsys)
    assert "resumed" not in out
    out = _cli(["--steps", "4", "--ckpt-dir", b], capsys)
    assert "resumed from step 2" in out and "2 steps in" in out
    for d in (a, b):
        assert sorted(os.listdir(d)) == ["step_00000002", "step_00000004"]
    with np.load(os.path.join(a, "step_00000004", "shard_0.npz")) as x, \
            np.load(os.path.join(b, "step_00000004", "shard_0.npz")) as y:
        assert set(x.files) == set(y.files)
        for key in x.files:
            np.testing.assert_array_equal(x[key], y[key], err_msg=key)


def test_trainer_imports_neither_jax_nor_reference():
    code = ("import sys\n"
            "import repro_torch.launch.train, repro_torch.optim, "
            "repro_torch.models.flash_xla, repro_torch.data.pipeline\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# --------------------------------------------------------------------- #
# on the card                                                           #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_lse_matches_plain_on_card(requires_cuda, dtype):
    """The kernel's ``L`` against its plain version's within ``2e-5 (1 +
    |L|)`` (scores summed in another order; the tensor-core kernel's
    ``exp2`` and log2 units move ``L`` by a few fp32 ulps), and ``o`` as
    ``[7.flash]`` holds it."""
    from repro_torch.testing import flash_p_rounding_tolerance
    q, k, v, _ = _qkv(2, 8, 2, 256, 128, seed=4)
    q, k, v = (torch.from_numpy(a).to(requires_cuda, dtype) * 0.3
               for a in (q, k, v))
    o, L = tk.flash_attention(q, k, v, causal=True, return_lse=True)
    want_o, want_L = tk.flash_attention_plain(q, k, v, causal=True,
                                              return_lse=True)
    w = want_L.double()
    assert bool(((L.double() - w).abs() <= 2e-5 * (1 + w.abs())).all())
    wo = want_o.double()
    tol = (2e-5 * (1 + wo.abs()) if dtype == torch.float32 else
           flash_p_rounding_tolerance(wo, tk.flash_attention_plain(
               q.float(), k.float(), v.abs().float()), dtype))
    assert bool(((o.double() - wo).abs() <= tol).all())
