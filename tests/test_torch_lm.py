"""The port's LM serving path against the JAX package's, on the same
inputs.

The reference draws its parameters with threefry, which torch cannot
reproduce, so each test draws them with the reference's ``init_params``
and carries them across with ``repro_torch.convert.
lm_params_from_reference``; token ids and embeddings come from a numpy
seed.  On the CPU the port's ``impl="pallas"`` runs the flash kernel's
plain version, held against the reference's Pallas kernel in interpret
mode.

Bounds, stated per comparison: layers in fp32 ``1e-5`` abs and rel
(the same fp32 operations, summed in another order); whole-model logits
in fp32 ``2e-4`` abs and rel, the reference's own bound for prefill and
decode against its full forward (``tests/test_models.py:72``).  In bf16
both frameworks round every projection, residual and activation to bf16,
at slightly different places (a product's fp32 sum, silu), so logits
differ by a few bf16 ulps of the activations that feed them: ``0.05``
abs and rel, 12.8 ulps of a value near 1 (measured: at most 0.023 on
logits up to 3.4).
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
from repro.launch import serve as rserve
from repro.models import layers as rlayers
from repro.models import rope as rrope
from repro.models import transformer as RT

from repro_torch import configs as tconfigs
from repro_torch.convert import (lm_params_from_reference,
                                 lm_params_to_reference)
from repro_torch.kernels import flash_attn as tk
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import rope as trope
from repro_torch.models import transformer as TT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
FP32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
#: the attention families the port serves (dense, and the vlm / audio
#: backbones whose inputs are embeddings)
ARCHS = ["qwen2_5_32b", "qwen2_vl_72b", "musicgen_large"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(x, np.float32)


def _inputs(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.embed_input:
        return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)


def _both(cfg, seed=0):
    """The reference's parameters and the port's model built from them."""
    params = RT.init_params(jax.random.key(seed), cfg)
    model = lm_params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                     device=CPU)
    return params, model


def _t_inputs(x):
    return torch.from_numpy(x).long() if x.dtype == np.int32 else \
        torch.from_numpy(x)


# --------------------------------------------------------------------- #
# layers and rope                                                       #
# --------------------------------------------------------------------- #

def _dense_pair(rng, d_in, d_out, bias):
    w = rng.normal(size=(d_in, d_out)).astype(np.float32) / d_in ** 0.5
    p = {"w": jnp.asarray(w)}
    t = tlayers.Dense(d_in, d_out, bias=bias)
    with torch.no_grad():
        t.w.copy_(torch.from_numpy(w))
        if bias:
            b = rng.normal(size=(d_out,)).astype(np.float32)
            p["b"] = jnp.asarray(b)
            t.b.copy_(torch.from_numpy(b))
    return p, t


@pytest.mark.parametrize("bias", [False, True])
def test_dense_and_swiglu_match_reference(bias):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    rp, tp = _dense_pair(rng, 16, 24, bias)
    np.testing.assert_allclose(_np(tlayers.dense(tp, torch.from_numpy(x))),
                               _np(rlayers.dense(rp, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    sw = tlayers.SwiGLU(16, 40)
    ref = {}
    for name in ("gate", "up", "down"):
        d_in, d_out = (40, 16) if name == "down" else (16, 40)
        ref[name], lin = _dense_pair(rng, d_in, d_out, False)
        getattr(sw, name).load_state_dict(lin.state_dict())
    np.testing.assert_allclose(_np(sw(torch.from_numpy(x))),
                               _np(rlayers.swiglu(ref, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 7, 32)) * 3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    norm = tlayers.RMSNorm(32, eps=1e-5)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
    got = norm(torch.from_numpy(x).to(getattr(torch, dtype)))
    want = rlayers.rmsnorm({"scale": jnp.asarray(scale)},
                           jnp.asarray(x, getattr(jnp, dtype)), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    else:      # fp32 inside, rounded once: at most one bf16 ulp apart
        np.testing.assert_allclose(_np(got), _np(want), rtol=2.0 ** -7,
                                   atol=0)


def test_embed_and_cross_entropy_match_reference():
    rng = np.random.default_rng(2)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    tokens = rng.integers(0, 50, (3, 6))
    emb = tlayers.Embedding(50, 8)
    with torch.no_grad():
        emb.table.copy_(torch.from_numpy(table))
    assert np.array_equal(_np(emb(torch.from_numpy(tokens))),
                          _np(rlayers.embed({"table": jnp.asarray(table)},
                                            jnp.asarray(tokens))))
    logits = rng.normal(size=(3, 6, 50)).astype(np.float32) * 4
    labels = tokens.copy()
    labels[0, :2] = -100
    got = tlayers.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels))
    want = rlayers.cross_entropy(jnp.asarray(logits),
                                 jnp.asarray(labels, jnp.int32))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_truncated_normal_init():
    g = torch.Generator().manual_seed(0)
    t = torch.empty((400, 300), dtype=torch.bfloat16)
    tlayers.truncated_normal_(t, 0.5, g)
    x = t.float()
    assert float(x.abs().max()) <= 1.0 and t.dtype == torch.bfloat16
    # a standard normal cut at +-2 has std 0.8796
    assert abs(float(x.std()) - 0.5 * 0.8796) < 0.01


@pytest.mark.parametrize("theta,hd", [(1e6, 16), (1e4, 64), (5e4, 128)])
def test_rope_matches_reference(theta, hd):
    rng = np.random.default_rng(3)
    pos = rng.integers(0, 4096, (2, 9))
    got = trope.rope_angles(torch.from_numpy(pos), hd, theta)
    want = rrope.rope_angles(jnp.asarray(pos), hd, theta)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-5)
    # the rotation on the same angles (an fp32 ulp of an angle of ~4096
    # rad is 5e-4 rad, so angles that differ by one would move it by that)
    x = rng.normal(size=(2, 9, 3, hd)).astype(np.float32)
    ang = _np(want)
    np.testing.assert_allclose(
        _np(trope.apply_rotary(torch.from_numpy(x), torch.from_numpy(ang))),
        _np(rrope.apply_rotary(jnp.asarray(x), jnp.asarray(ang))), rtol=1e-5,
        atol=1e-5)
    # (S, D/2) angles broadcast over the batch
    np.testing.assert_allclose(
        _np(trope.apply_rotary(torch.from_numpy(x),
                               torch.from_numpy(ang[0]))),
        _np(rrope.apply_rotary(jnp.asarray(x), jnp.asarray(ang[0]))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16), ((16, 24, 24), 128)])
def test_mrope_matches_reference(sections, hd):
    rng = np.random.default_rng(4)
    pos3 = rng.integers(0, 512, (2, 7, 3))
    got = trope.mrope_angles(torch.from_numpy(pos3), hd, 1e6, sections)
    want = rrope.mrope_angles(jnp.asarray(pos3), hd, 1e6, sections)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError):
        trope.mrope_angles(torch.from_numpy(pos3), hd, 1e6, (1, 1, 1))


# --------------------------------------------------------------------- #
# the slice as a whole                                                  #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_forward_matches_reference(arch, impl):
    cfg = rconfigs.get_smoke_config(arch)
    params, model = _both(cfg)
    x = _inputs(cfg, 2, 16)
    want, _, _ = RT.forward(params, cfg, jnp.asarray(x), impl=impl)
    got, _, aux = TT.forward(model, tconfigs.get_smoke_config(arch),
                             _t_inputs(x), impl=impl)
    assert got.shape == (2, 16, cfg.vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), **FP32_TOL)
    assert float(aux["aux_loss"]) == 0.0


def _ref_serve(params, cfg, prompts, gen, impl):
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
        inp = (tok[:, None] if cfg.embed_input
               else jax.nn.one_hot(tok, cfg.d_model)[:, None])
        logits, cache = decode(params, {"inputs": inp}, cache,
                               jnp.int32(P + i))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(tok)
        all_logits.append(logits)
    return np.stack([np.asarray(t) for t in toks], 1), all_logits


def _port_serve(model, cfg, prompts, gen, impl):
    B, P = prompts.shape[:2]
    prefill = tserve.make_prefill(cfg, None, impl=impl)
    decode = tserve.make_decode_step(cfg, None)
    logits, pre = prefill(model, {"inputs": _t_inputs(prompts)})
    cache = tserve._merge_prefill_cache(
        TT.init_cache(cfg, B, P + gen, device=CPU, dtype=model.dtype), pre,
        cfg, P)
    tok = torch.argmax(logits, dim=-1)
    toks, all_logits = [tok], [logits]
    eye = torch.arange(cfg.d_model)
    for i in range(gen - 1):
        inp = (tok[:, None] if cfg.embed_input
               else (tok[:, None] == eye).to(model.dtype)[:, None])
        logits, cache = decode(model, {"inputs": inp}, cache, P + i)
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
        all_logits.append(logits)
    return torch.stack(toks, 1).numpy(), all_logits


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_prefill_decode_greedy_match_reference(arch, impl):
    """Prefill and 4 greedy decode steps: logits within ``2e-4`` of the
    reference's at every step, the same tokens."""
    cfg = rconfigs.get_smoke_config(arch)
    params, model = _both(cfg, seed=1)
    prompts = _inputs(cfg, 3, 12, seed=1)
    want_toks, want = _ref_serve(params, cfg, prompts, 5, impl)
    got_toks, got = _port_serve(model, cfg, prompts, 5, impl)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **FP32_TOL)
    assert np.array_equal(got_toks, want_toks)


def test_bf16_prefill_decode_match_reference():
    """The Qwen smoke model stored in bf16 (as the full model serves):
    logits within ``BF16_TOL`` of the reference's, prefill and decode."""
    cfg = dataclasses.replace(rconfigs.get_smoke_config("qwen2_5_32b"),
                              dtype="bfloat16")
    params, model = _both(cfg, seed=2)
    assert model.dtype == torch.bfloat16
    assert model.final_norm.scale.dtype == torch.float32
    prompts = _inputs(cfg, 2, 16, seed=2)
    _, want = _ref_serve(params, cfg, prompts, 4, "pallas")
    _, got = _port_serve(model, cfg, prompts, 4, "pallas")
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(g), _np(w), **BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["pallas", "xla", "xla_naive"])
def test_decode_after_prefill_matches_full_forward(arch, impl):
    """decode(prefill(x[:t]), x[t]) reproduces forward(x)[t] inside the
    port (``tests/test_models.py``'s check, at its bound)."""
    cfg = tconfigs.get_smoke_config(arch)
    model = TT.init_params(0, cfg, device=CPU)
    B, S = 2, 12
    x = _t_inputs(_inputs(cfg, B, S))
    full, _, _ = TT.forward(model, cfg, x)
    last, pre = TT.prefill(model, cfg, x[:, :S - 1], impl=impl)
    np.testing.assert_allclose(_np(last), _np(full[:, S - 2]), **FP32_TOL)
    cache = tserve._merge_prefill_cache(
        TT.init_cache(cfg, B, S + 2, device=CPU), pre, cfg, S - 1)
    dec, cache = TT.decode_step(model, cfg, x[:, S - 1:S], cache, S - 1)
    np.testing.assert_allclose(_np(dec), _np(full[:, S - 1]), **FP32_TOL)
    assert float(cache[0].k[:, S:].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_bitwise(dtype):
    cfg = dataclasses.replace(rconfigs.get_smoke_config("qwen2_5_32b"),
                              dtype=dtype)
    params = jax.tree.map(np.asarray, RT.init_params(jax.random.key(3), cfg))
    model = lm_params_from_reference(params, cfg, device=CPU)
    back = lm_params_to_reference(model, cfg)
    want_leaves, want_def = jax.tree.flatten(params)
    got_leaves, got_def = jax.tree.flatten(back)
    assert want_def == got_def
    for w, g in zip(want_leaves, got_leaves):
        # bf16 comes back as its fp32 carrier, every other dtype as itself
        carrier = np.float32 if w.dtype.name == "bfloat16" else w.dtype
        assert g.dtype == carrier and g.shape == w.shape
        assert np.array_equal(w.astype(carrier), g)


def test_params_convert_to_another_dtype():
    cfg = rconfigs.get_smoke_config("qwen2_5_32b")
    params = jax.tree.map(np.asarray, RT.init_params(jax.random.key(4), cfg))
    model = lm_params_from_reference(params, cfg, dtype=torch.bfloat16,
                                     device=CPU)
    assert model.dtype == torch.bfloat16
    w = params["blocks"]["pos0"]["mixer"]["wq"]["w"][1]
    assert torch.equal(model.layers[1].mixer.wq.w,
                       torch.from_numpy(np.array(w)).to(torch.bfloat16))
    bad = dict(params, lm_head={"w": params["lm_head"]["w"][:, :3]})
    with pytest.raises(ValueError, match="lm_head.w"):
        lm_params_from_reference(bad, cfg, device=CPU)


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "kimi_k2_1t_a32b",
                                  "falcon_mamba_7b", "jamba_1_5_large_398b"])
def test_init_params_builds_the_moe_and_ssm_families(arch):
    """The MoE, SSM and hybrid configs build (``param_count()``
    parameters) and run a forward on the CPU, also with a sharding
    context on a mesh of one rank, which gives the same logits
    (``tests/test_torch_hybrid.py`` holds them to the reference,
    ``tests/test_torch_lm_ep_spmd.py`` serves them on 4 ranks); what is
    not a ``ShardingCtx`` raises ``TypeError``."""
    cfg = tconfigs.get_smoke_config(arch)
    model = TT.init_params(0, cfg, device=CPU)
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    x = torch.zeros((1, 4), dtype=torch.long)
    logits, _, aux = TT.forward(model, cfg, x)
    assert logits.shape == (1, 4, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert (float(aux["aux_loss"]) > 0) == bool(cfg.n_experts)
    from repro_torch.distributed.sharding import make_ctx
    from repro_torch.launch.mesh import make_test_mesh
    ctx = make_ctx(make_test_mesh(1, 1, device=CPU))
    with torch.no_grad():
        got, _, got_aux = TT.forward(model, cfg, x, ctx=ctx)
    assert torch.equal(got, logits)
    assert float(got_aux["aux_loss"]) == float(aux["aux_loss"])
    with pytest.raises(TypeError, match="ShardingCtx"):
        TT.forward(model, cfg, x, ctx=object())


def test_refuses_a_sharding_context():
    """A dense model takes a sharding context: on a mesh of one rank (no
    process group) forward, prefill and decode equal the unsharded ones
    bitwise; what is not a ``ShardingCtx`` is refused
    (``tests/test_torch_lm_spmd.py`` serves on 4 ranks)."""
    from repro_torch.distributed.sharding import make_ctx
    from repro_torch.launch.mesh import make_test_mesh
    cfg = tconfigs.get_smoke_config("qwen2_5_32b")
    model = TT.init_params(0, cfg, device=CPU)
    ctx = make_ctx(make_test_mesh(1, 1, device=CPU))
    x = torch.from_numpy(_inputs(cfg, 2, 8)).long()
    want, _, _ = TT.forward(model, cfg, x)
    got, _, _ = TT.forward(model, cfg, x, ctx=ctx)
    assert torch.equal(got, want)
    logits = {}
    for c in (None, ctx):
        last, pre = tserve.make_prefill(cfg, c)(model, {"inputs": x[:, :7]})
        cache = tserve._merge_prefill_cache(
            TT.init_cache(cfg, 2, 8, device=CPU, ctx=c), pre, cfg, 7,
            ctx=c, batch=2)
        dec, _ = TT.decode_step(model, cfg, x[:, 7:], cache, 7, ctx=c)
        logits[c] = (last, dec)
    assert all(torch.equal(a, b) for a, b in zip(logits[ctx], logits[None]))
    for bad in (object(), ctx.mesh):
        with pytest.raises(TypeError, match="ShardingCtx"):
            TT.forward(model, cfg, x, ctx=bad)
        with pytest.raises(TypeError, match="ShardingCtx"):
            tserve.make_prefill(cfg, bad)(model, {"inputs": x})
        cache = TT.init_cache(cfg, 1, 8, device=CPU)
        with pytest.raises(TypeError, match="ShardingCtx"):
            TT.decode_step(model, cfg, x[:1, :1], cache, 0, ctx=bad)


def test_configs_equal_reference():
    for arch in rconfigs.ARCHS:
        assert dataclasses.asdict(tconfigs.get_config(arch)) == \
            dataclasses.asdict(rconfigs.get_config(arch))
        assert dataclasses.asdict(tconfigs.get_smoke_config(arch)) == \
            dataclasses.asdict(rconfigs.get_smoke_config(arch))
        assert tconfigs.get_config(arch).param_count() == \
            rconfigs.get_config(arch).param_count()
    assert tconfigs.SHAPES == rconfigs.SHAPES
    assert tconfigs.cells() == rconfigs.cells()
    assert tconfigs.get_config("qwen2-5-32b").param_count() == 32_763_876_352


@pytest.mark.parametrize("which", ["dense", "dense_bias", "rmsnorm",
                                   "swiglu", "embedding"])
def test_layer_inits_draw_the_reference_shapes(which):
    g, key = torch.Generator().manual_seed(0), jax.random.key(0)
    ref, port = {
        "dense": lambda: (rlayers.dense_init(key, 24, 40, jnp.float32),
                          tlayers.dense_init(g, 24, 40, torch.float32)),
        "dense_bias": lambda: (
            rlayers.dense_init(key, 24, 40, jnp.bfloat16, bias=True),
            tlayers.dense_init(g, 24, 40, torch.bfloat16, bias=True)),
        "rmsnorm": lambda: (rlayers.rmsnorm_init(24),
                            tlayers.rmsnorm_init(24)),
        "swiglu": lambda: (rlayers.swiglu_init(key, 24, 40, jnp.float32),
                           tlayers.swiglu_init(g, 24, 40, torch.float32)),
        "embedding": lambda: (
            rlayers.embedding_init(key, 50, 24, jnp.bfloat16),
            tlayers.embedding_init(g, 50, 24, torch.bfloat16)),
    }[which]()
    flat_ref = {"/".join(str(k.key) for k in path): (a.shape, a.dtype.name)
                for path, a in jax.tree_util.tree_flatten_with_path(ref)[0]}
    flat_port = {k.replace(".", "/"): (tuple(v.shape),
                                      str(v.dtype).replace("torch.", ""))
                 for k, v in port.state_dict().items()}
    assert flat_port == flat_ref
    for name, v in port.state_dict().items():
        if name.endswith("w") or name.endswith("table"):
            sd = 1.0 if which == "embedding" else 1 / v.shape[0] ** 0.5
            assert float(v.float().abs().max()) <= 2 * sd * (1 + 2 ** -8)
        elif name.endswith("b"):
            assert float(v.abs().max()) == 0.0
        else:
            assert torch.equal(v, torch.ones_like(v))


def test_attn_init_draws_the_reference_shapes():
    from repro.models.attention import attn_init as rattn_init
    from repro_torch.models.attention import attn_init
    cfg = tconfigs.get_smoke_config("qwen2_5_32b")
    p = attn_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    want = jax.tree.map(np.shape, rattn_init(jax.random.key(0), cfg,
                                             jnp.float32))
    got = {n: {k: tuple(v.shape) for k, v in getattr(p, n).state_dict()
               .items()} for n in ("wq", "wk", "wv", "wo")}
    assert got == want
    assert float(p.wq.b.abs().max()) == 0.0
    assert float(p.wq.w.abs().max()) <= 2 / cfg.d_model ** 0.5


def test_init_params_layout_and_dtype():
    cfg = tconfigs.get_smoke_config("qwen2_5_32b")
    model = TT.init_params(7, dataclasses.replace(cfg, dtype="bfloat16"),
                           device=CPU)
    assert len(model.layers) == cfg.n_layers
    assert model.dtype == torch.bfloat16
    assert model.layers[0].mixer.wq.b.dtype == torch.bfloat16
    assert float(model.layers[0].mixer.wq.b.abs().max()) == 0.0
    assert model.layers[0].norm1.scale.dtype == torch.float32
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_count()
    assert not any(p.requires_grad for p in model.parameters())
    again = TT.init_params(7, dataclasses.replace(cfg, dtype="bfloat16"),
                           device=CPU)
    assert torch.equal(model.lm_head.w, again.lm_head.w)


# --------------------------------------------------------------------- #
# the CLI                                                               #
# --------------------------------------------------------------------- #

def _run_cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], env=env, capture_output=True, text=True,
                          timeout=300, cwd=ROOT)


def test_serve_cli_runs_on_cpu():
    out = _run_cli("--smoke", "--device", "cpu", "--temperature", "0")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "prefill 32 toks x4" in out.stdout and "on cpu" in out.stdout
    assert "sampled token ids" in out.stdout


def test_serve_main_greedy_is_deterministic_and_sampling_runs(capsys):
    args = ["--smoke", "--device", "cpu", "--gen", "6", "--prompt-len", "8",
            "--layers", "1"]
    assert tserve.main(args + ["--temperature", "0"]) == 0
    first = capsys.readouterr().out.split("sampled token ids:")[1]
    assert tserve.main(args + ["--temperature", "0"]) == 0
    assert capsys.readouterr().out.split("sampled token ids:")[1] == first
    assert tserve.main(args + ["--temperature", "1.0"]) == 0
    assert "sampled token ids" in capsys.readouterr().out


def test_serve_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--smoke", "--layers", "1"])


def test_generate_launches_nothing_on_cpu():
    """``generate`` (caches of ``P + gen - 1`` positions) gives the greedy
    tokens of the step-by-step serve (caches of ``P + gen``), and on the
    CPU launches no kernel."""
    cfg = tconfigs.get_smoke_config("qwen2_5_32b")
    model = TT.init_params(0, cfg, device=CPU)
    prompts = _inputs(cfg, 2, 8)
    tk.reset_launches()
    toks, t = tserve.generate(model, cfg, _t_inputs(prompts), 5)
    assert toks.shape == (2, 5) and tk.flash_attention.launches == 0
    assert t["prefill_s"] > 0 and t["decode_s"] > 0
    want, _ = _port_serve(model, cfg, prompts, 5, "pallas")
    assert np.array_equal(toks.numpy(), want)
