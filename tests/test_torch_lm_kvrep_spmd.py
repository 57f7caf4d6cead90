"""KV heads shared across model ranks (tp above ``n_kv_heads``) in the
port, on (1, 4) and (2, 4) meshes of gloo CPU ranks, against the port's
unsharded run and the JAX reference's.

Each smoke config here has 2 KV heads, below tp = 4, so every KV head is
shared by ``r = 2`` model ranks (``distributed.sharding.kv_share``):
Qwen2.5 (QKV bias, 1 query head a rank), Llama-3 (2 query heads a
rank), Qwen3-MoE, Jamba (attention, Mamba, dense and MoE FFNs) and
Qwen2-VL (embeddings in, mrope).  Two ``spawn_ranks`` calls, one a mesh
(4 ranks for (1, 4), 8 for (2, 4)), module-scoped and with a hard
timeout, compute every case (``repro_torch.testing.run_lm_on_mesh``):
for each config, fp32, prefill and 3 greedy decode steps through
``launch.serve.generate(ctx=)`` under both ``tp_collectives`` (with the
decode caches), a prefill with the first attention layer's ``wk`` and
``wv`` blocks rotated among the model ranks of KV group 0 (a head's
slices assembled in the wrong order: the control), and one training
step under each ``tp_collectives`` and with ``remat`` (the KV gather
recomputed in the backward), whose gradients of every attention layer's
``wq``, ``wk``, ``wv`` and ``wo`` the ranks return.  The pytest process never
initialises a process group.

The oracle is per data row, as in ``tests/test_torch_lm_ep_spmd.py`` and
``tests/test_torch_lm_train_ep_spmd.py``: an MoE layer's capacity counts
its call's tokens, so a run sharded over dp equals the unsharded runs on
each data row's rows (``testing.row_oracle`` for the training loss: the
rows' cross-entropies by valid-label count, their aux losses by the mean
over dp); a dense model's per-row oracle is its whole-batch one.

Bounds, fp32 throughout, those of the existing mesh tests
(``tests/test_torch_lm_spmd.py``, ``tests/test_torch_lm_train_spmd.py``):
against the port's unsharded run, logits, the decode caches, the loss
and the gradients within ``1e-5`` abs and rel (the same fp32 products,
partial sums added in another order), the same tokens; against the JAX
reference's unsharded ``prefill`` and ``decode_step`` (``impl="xla"``)
and its ``value_and_grad(loss_and_metrics)``, ``2e-4``, the same tokens.
The control's prefill logits must leave the ``1e-5`` bound by more than
``1e-2``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.launch import serve as rserve
from repro.models import transformer as RT

from repro_torch import configs as tconfigs
from repro_torch import testing as ttesting
from repro_torch.convert import (_lm_flat_from_reference,
                                 lm_params_from_reference)
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs

#: seconds a spawn may take before every rank is killed
SPAWN_TIMEOUT = 300
ARCHS = ["qwen2_5_32b", "llama3_405b", "qwen3_moe_30b_a3b",
         "jamba_1_5_large_398b", "qwen2_vl_72b"]
MESHES = {"1x4": (1, 4), "2x4": (2, 4)}
MODES = ("gspmd", "manual")
#: training cases: name -> (tp_collectives, remat)
TRAIN = {"gspmd": ("gspmd", False), "manual": ("manual", False),
         "remat": ("gspmd", True)}
#: each data row's rows (a mesh's batch is ROWS * dp, so that every
#: oracle, the JAX reference's jitted ones included, runs at one shape),
#: the prompt's length and the tokens generated (prefill + 3 greedy
#: decode steps)
ROWS, P, GEN = 2, 12, 4
S = 16                          # a training row's length
SHARDED_TOL = dict(rtol=1e-5, atol=1e-5)
REF_TOL = dict(rtol=2e-4, atol=2e-4)
#: the control must leave SHARDED_TOL by at least this much
CONTROL_MIN_DIFF = 1e-2
#: AdamW as ``tests/test_torch_lm_train_spmd.py`` sets it (says why)
OPT = dict(lr=1e-3, eps=1e-4)
AUX_WEIGHT = 0.01
ATTN_WEIGHTS = ("wq", "wk", "wv", "wo")


def _tcfg(arch, mode="gspmd"):
    return dataclasses.replace(tconfigs.get_smoke_config(arch),
                               tp_collectives=mode)


def _rcfg(arch):
    return rconfigs.get_smoke_config(arch)


def _batch_size(mesh):
    return ROWS * mesh[0]


def _prompts(arch, b):
    """The first ``b`` of a fixed set of prompts."""
    rng = np.random.default_rng(1)
    cfg = _rcfg(arch)
    if cfg.embed_input:
        return rng.integers(0, cfg.vocab_size, (4, P)).astype(np.int64)[:b]
    return rng.normal(size=(4, P, cfg.d_model)).astype(np.float32)[:b]


def _batch(arch, b):
    """The first ``b`` rows of a fixed global training batch, 3 labels of
    row 0 ignored (mrope positions for Qwen2-VL)."""
    B = 4
    cfg = _rcfg(arch)
    rng = np.random.default_rng(0)
    if cfg.embed_input:
        inputs = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    else:
        inputs = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    out = {"inputs": inputs,
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    out["labels"][0, :3] = -100
    if cfg.rope_kind == "mrope":
        out["positions"] = rng.integers(0, S, (B, S, 3)).astype(np.int32)
    return {k: v[:b] for k, v in out.items()}


def _attn_names(arch):
    cfg = _rcfg(arch)
    return [f"layers.{i}.mixer.{w}.w" for i in range(cfg.n_layers)
            if cfg.layer_kind(i) == "attn" for w in ATTN_WEIGHTS]


_TREES = {}


def _tree(arch):
    """The reference's parameters of the smoke ``arch``, as numpy."""
    if arch not in _TREES:
        _TREES[arch] = jax.tree.map(np.asarray, RT.init_params(
            jax.random.key(1), _rcfg(arch)))
    return _TREES[arch]


def _runs(mesh):
    b = _batch_size(mesh)
    runs = []
    for arch in ARCHS:
        common = dict(mesh=mesh, cfg=tconfigs.get_smoke_config(arch),
                      params=_tree(arch))
        for mode in MODES:
            runs.append(dict(common, name=f"{arch}:{mode}", kind="serve",
                             mode=mode, weights=arch,
                             prompts=_prompts(arch, b), gen=GEN))
        runs.append(dict(common, name=f"{arch}:control", kind="serve",
                         mode="gspmd", weights=arch,
                         prompts=_prompts(arch, b), gen=1, swap="kv"))
        for case, (mode, remat) in TRAIN.items():
            runs.append(dict(common, name=f"{arch}:train_{case}",
                             kind="train", mode=mode,
                             cfg_kw=dict(remat=remat),
                             batches=[_batch(arch, b)],
                             opt=OPT, warmup=0, total_steps=10,
                             keep=dict.fromkeys(_attn_names(arch)),
                             state_keys=()))
    return runs


@pytest.fixture(scope="module")
def ranks():
    """``{mesh name: every rank's results}``: one spawn a mesh."""
    return {name: tmesh.spawn_ranks(
        ttesting.run_lm_on_mesh, mesh[0] * mesh[1], _runs(mesh), "cpu",
        timeout=SPAWN_TIMEOUT, device="cpu")
        for name, mesh in MESHES.items()}


def _layout_ctx(mesh, coords=(0, 0)):
    return tsharding.make_ctx(tmesh.LmMesh(("data", "model"), mesh,
                                           tuple(coords), torch.device("cpu"),
                                           "gloo"))


def _rows(dp):
    """The rows of each data row of a batch of ``ROWS * dp``."""
    return [slice(i * ROWS, (i + 1) * ROWS) for i in range(dp)]


# --------------------------------------------------------------------- #
# oracles                                                               #
# --------------------------------------------------------------------- #

_PORT = {}


def _port(arch, rows):
    """The port's unsharded run (``testing.serve_record``) of the
    prompts' ``rows``, memoized."""
    key = (arch, rows.start, rows.stop)
    if key not in _PORT:
        cfg = tconfigs.get_smoke_config(arch)
        model = lm_params_from_reference(_tree(arch), cfg, device="cpu")
        _PORT[key] = ttesting.serve_record(
            model, cfg, torch.from_numpy(_prompts(arch, 4)[rows]), GEN)
    return _PORT[key]


_REF, _REF_FNS = {}, {}


def _ref_kv(cache, cfg):
    """Each attention layer's ``(k, v)`` of the reference's cache tree
    (prologue layers, then each period position's stacked layers)."""
    out = []
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) != "attn":
            continue
        if i < cfg.n_prologue:
            c = cache["prologue"][i]
        else:
            j = i - cfg.n_prologue
            c = jax.tree.map(lambda a: a[j // cfg.period],
                             cache["blocks"][f"pos{j % cfg.period}"])
        out.append((np.asarray(c.k, np.float32), np.asarray(c.v,
                                                            np.float32)))
    return out


def _reference(arch, rows):
    """The JAX reference's unsharded ``prefill`` and greedy decode steps
    of the prompts' ``rows`` (an embedding model fed each token as
    ``launch.serve.generate`` feeds it): ``(tokens (b, GEN), logits
    (GEN, b, V), each attention layer's (k, v) after the last step)``,
    memoized."""
    key = (arch, rows.start, rows.stop)
    if key in _REF:
        return _REF[key]
    cfg = _rcfg(arch)
    if arch not in _REF_FNS:
        _REF_FNS[arch] = (jax.jit(rserve.make_prefill(cfg, None,
                                                      impl="xla")),
                          jax.jit(rserve.make_decode_step(cfg, None)))
    prefill, decode = _REF_FNS[arch]
    params = jax.tree.map(jnp.asarray, _tree(arch))
    prompts = _prompts(arch, 4)[rows]
    b = prompts.shape[0]
    inputs = (jnp.asarray(prompts, jnp.int32) if cfg.embed_input
              else jnp.asarray(prompts))
    logits, pre = prefill(params, {"inputs": inputs})
    cache = rserve._merge_prefill_cache(RT.init_cache(cfg, b, P + GEN - 1),
                                        pre, cfg, P)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    toks, all_logits = [tok], [logits]
    eye = jnp.arange(cfg.d_model)
    for i in range(GEN - 1):
        inp = (tok[:, None] if cfg.embed_input
               else (tok[:, None] == eye).astype(jnp.float32)[:, None])
        logits, cache = decode(params, {"inputs": inp}, cache,
                               jnp.int32(P + i))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(tok)
        all_logits.append(logits)
    _REF[key] = (np.stack([np.asarray(t) for t in toks], 1),
                 np.stack([np.asarray(x) for x in all_logits]),
                 _ref_kv(cache, cfg))
    return _REF[key]


def _joined(fn, arch, dp):
    """``fn``'s (tokens, logits, kv) on each data row's rows, joined along
    the batch."""
    outs = [fn(arch, r) for r in _rows(dp)]
    kv = [tuple(np.concatenate([o[2][layer][n] for o in outs])
                for n in (0, 1)) for layer in range(len(outs[0][2]))]
    return (np.concatenate([o[0] for o in outs]),
            np.concatenate([o[1] for o in outs], axis=1), kv)


def _port_triple(arch, rows):
    rec = _port(arch, rows)
    return rec["tokens"], rec["logits"], rec["kv"]


def _sharded(ranks, mesh_name, arch, run):
    """A serve run's tokens (every rank's must be equal) and logits
    (steps, B, V), from the first model rank of each data row (the model
    ranks of a row hold the same, which is asserted)."""
    dp, tp = MESHES[mesh_name]
    outs = ranks[mesh_name]
    name = f"{arch}:{run}"
    toks = [r[f"{name}.tokens"] for r in outs]
    for t in toks[1:]:
        assert np.array_equal(t, toks[0])
    parts = []
    for i in range(dp):
        group = outs[i * tp:(i + 1) * tp]
        for r in group[1:]:
            assert np.array_equal(r[f"{name}.logits"],
                                  group[0][f"{name}.logits"])
        parts.append(group[0][f"{name}.logits"])
    return toks[0].astype(np.int64), np.concatenate(parts, axis=1)


def _sharded_kv(ranks, mesh_name, arch, mode):
    """Each attention layer's whole ``(k, v)`` decode cache (B, P + GEN -
    1, Hkv, D) from the ranks' blocks (``launch.specs``: the batch over
    dp, the positions over tp in slices of ``ceil(S_max / tp)``, the cut
    of the last slice past ``S_max`` all zero), and whether every rank's
    block has ``launch.specs.local_kv_shape``."""
    mesh = MESHES[mesh_name]
    cfg = tconfigs.get_smoke_config(arch)
    B, S_max = _batch_size(mesh), P + GEN - 1
    name = f"{arch}:{mode}"
    outs = ranks[mesh_name]
    n_kv = len(outs[0][f"{name}.kv"])
    whole = [[np.zeros((B, mesh[1] * -(-S_max // mesh[1]), cfg.n_kv_heads,
                        cfg.head_dim), np.float32) for _ in (0, 1)]
             for _ in range(n_kv)]
    shapes_ok = True
    for r in outs:
        ctx = _layout_ctx(mesh, r[f"{name}.coords"])
        want_shape = tspecs.local_kv_shape(cfg, B, S_max, ctx)
        n, idx, S_loc = tspecs.seq_shard(B, S_max, ctx)
        assert n == mesh[1]
        rows = _rows(mesh[0])[ctx.dp_index]
        for layer, kv in enumerate(r[f"{name}.kv"]):
            for j, t in enumerate(kv):
                shapes_ok &= t.shape == want_shape
                whole[layer][j][rows, idx * S_loc:(idx + 1) * S_loc] = t
    for layer in whole:
        for t in layer:
            assert not t[:, S_max:].any()
    return [tuple(t[:, :S_max] for t in layer) for layer in whole], shapes_ok


# --------------------------------------------------------------------- #
# serving                                                               #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_serving_matches_the_port_unsharded(ranks, mesh, arch, mode):
    """Prefill and 3 greedy decode steps with each KV head shared by 2
    model ranks: every step's logits within ``1e-5`` of the port's
    unsharded run on each data row's rows, the same tokens on every rank
    and as unsharded."""
    want_toks, want, _ = _joined(_port_triple, arch, MESHES[mesh][0])
    toks, got = _sharded(ranks, mesh, arch, mode)
    assert got.shape == (GEN, _batch_size(MESHES[mesh]),
                         _rcfg(arch).vocab_size)
    np.testing.assert_allclose(got, want, **SHARDED_TOL)
    assert np.array_equal(toks, want_toks)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_serving_matches_the_reference(ranks, mesh, arch, mode):
    """The same against the JAX reference's unsharded ``prefill`` and
    ``decode_step`` on each data row's rows, within ``2e-4``, the same
    greedy tokens."""
    want_toks, want, _ = _joined(_reference, arch, MESHES[mesh][0])
    toks, got = _sharded(ranks, mesh, arch, mode)
    np.testing.assert_allclose(got, want, **REF_TOL)
    assert np.array_equal(toks, want_toks)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_decode_caches_are_the_spec_blocks_of_the_unsharded(ranks, mesh,
                                                            arch, mode):
    """Each attention layer's k and v caches after the last step, put
    together from the ranks' sequence-sharded blocks (each of
    ``launch.specs.local_kv_shape``): the prefill's post-rope column
    slices, carried to the ranks that hold their positions by the
    all-to-all in rank order, and the decode steps' whole heads, within
    ``1e-5`` of the port's unsharded caches and ``2e-4`` of the JAX
    reference's, on each data row's rows."""
    got, shapes_ok = _sharded_kv(ranks, mesh, arch, mode)
    assert shapes_ok
    dp = MESHES[mesh][0]
    for fn, tol in ((_port_triple, SHARDED_TOL), (_reference, REF_TOL)):
        want = _joined(fn, arch, dp)[2]
        assert len(got) == len(want) > 0
        for layer, (g, w) in enumerate(zip(got, want)):
            for n in (0, 1):
                np.testing.assert_allclose(
                    g[n], w[n][:, :P + GEN - 1], err_msg=f"layer {layer}",
                    **tol)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_a_head_assembled_from_swapped_slices_is_rejected(ranks, mesh, arch):
    """The control: the first attention layer's wk and wv blocks (and
    biases) rotated among the 2 model ranks of KV group 0
    (``testing.control_partner``), so the head's column slices arrive in
    the wrong order; the prefill's logits leave the sharded-vs-unsharded
    bound."""
    _, want, _ = _joined(_port_triple, arch, MESHES[mesh][0])
    _, got = _sharded(ranks, mesh, arch, "control")
    assert got.shape == want[:1].shape
    assert not np.allclose(got, want[:1], **SHARDED_TOL)
    assert float(np.abs(got - want[:1]).max()) > CONTROL_MIN_DIFF


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_every_rank_runs_the_flash_wrapper_on_its_shared_head(ranks, mesh,
                                                              arch):
    """Each rank's prefill ran every attention layer through the flash
    kernel's wrapper (on CPU tensors its plain version, once a layer),
    and the collectives moved bytes."""
    cfg = _rcfg(arch)
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    for r in ranks[mesh]:
        for mode in MODES:
            name = f"{arch}:{mode}"
            assert r[f"{name}.plain_calls"] == n_attn
            assert r[f"{name}.flash_launches"] == 0
            assert r[f"{name}.calls"] > 0 and r[f"{name}.bytes_in"] > 0


# --------------------------------------------------------------------- #
# training                                                              #
# --------------------------------------------------------------------- #

_ORACLES = {}


def _oracle(arch, dp, mode):
    """The port's unsharded loss and gradients on each data row's rows
    (``testing.row_oracle``): ``(gradients (numpy), metrics)``."""
    key = (arch, dp, mode)
    if key not in _ORACLES:
        cfg = _tcfg(arch, mode)
        model = lm_params_from_reference(_tree(arch), cfg, device="cpu")
        grads, m = ttesting.row_oracle(model, cfg,
                                       _batch(arch, ROWS * dp), dp,
                                       aux_weight=AUX_WEIGHT)
        _ORACLES[key] = ({k: g.numpy() for k, g in grads.items()}, m)
    return _ORACLES[key]


_REF_GRADS, _ROW_FNS = {}, {}


def _ref_grads(arch, dp):
    """The JAX reference's unsharded ``value_and_grad`` of
    ``loss_and_metrics`` on each data row's rows, combined as the sharded
    loss combines them (as ``tests/test_torch_lm_train_ep_spmd.py``
    does): ``(loss, {port name: gradient})``."""
    key = (arch, dp)
    if key in _REF_GRADS:
        return _REF_GRADS[key]
    cfg = _rcfg(arch)
    if arch not in _ROW_FNS:
        def part(p, row, w_x, w_a):
            _, m = RT.loss_and_metrics(p, cfg, row, impl="xla",
                                       aux_weight=AUX_WEIGHT)
            return w_x * m["xent"] + w_a * m["aux_loss"]
        _ROW_FNS[arch] = jax.jit(jax.value_and_grad(part))
    fn = _ROW_FNS[arch]
    batch = _batch(arch, ROWS * dp)
    rows = [{k: jnp.asarray(v[r]) for k, v in batch.items()}
            for r in _rows(dp)]
    counts = [int(np.sum(np.asarray(r["labels"]) != -100)) for r in rows]
    params = jax.tree.map(jnp.asarray, _tree(arch))
    loss, grads = 0.0, None
    for r, c in zip(rows, counts):
        li, gi = fn(params, r, c / sum(counts), AUX_WEIGHT / len(rows))
        loss += float(li)
        grads = gi if grads is None else jax.tree.map(jnp.add, grads, gi)
    _REF_GRADS[key] = (loss, _lm_flat_from_reference(
        jax.tree.map(np.asarray, grads), cfg))
    return _REF_GRADS[key]


def _train_grads(ranks, mesh, arch, case):
    """The step's gradients of every attention layer's wq, wk, wv and wo,
    each put together from the ranks' blocks, with whether the copies of
    a block agree bitwise; and rank 0's metrics."""
    dims = MESHES[mesh]
    ctx = _layout_ctx(dims)
    name = f"{arch}:train_{case}"
    outs = ranks[mesh]
    coords = [r[f"{name}.coords"] for r in outs]
    shapes = {k: v.shape for k, v in _oracle(arch, dims[0],
                                              TRAIN[case][0])[0].items()}
    got = {}
    for k in _attn_names(arch):
        spec = tsharding.spec_for(k, len(shapes[k]), ctx)
        got[k] = ttesting.assemble_rows([r[f"{name}.grad.{k}"] for r in outs],
                                        coords, shapes[k], spec,
                                        ("data", "model"), dims)
    return got, outs[0][f"{name}.metrics"][0]


@pytest.mark.parametrize("case", sorted(TRAIN))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_training_step_matches_the_port_unsharded(ranks, mesh, arch, case):
    """One step's loss and its gradients of every attention layer's wq,
    wk, wv and wo (the KV slices' gradients summed over the 2 model ranks
    that gathered them), against the port's unsharded run (without
    remat: the same values) on each data row's rows within ``1e-5``; a
    replicated block's copies bitwise equal."""
    want, m = _oracle(arch, MESHES[mesh][0], TRAIN[case][0])
    got, metrics = _train_grads(ranks, mesh, arch, case)
    for k, (g, equal) in got.items():
        assert equal, k
        np.testing.assert_allclose(g, want[k], err_msg=k, **SHARDED_TOL)
    for key in ("loss", "xent", "aux_loss"):
        np.testing.assert_allclose(metrics[key], m[key], err_msg=key,
                                   **SHARDED_TOL)


@pytest.mark.parametrize("case", sorted(TRAIN))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_training_step_matches_the_reference(ranks, mesh, arch, case):
    """The same against the JAX reference's ``value_and_grad`` on each
    data row's rows, within ``2e-4``."""
    loss, want = _ref_grads(arch, MESHES[mesh][0])
    got, metrics = _train_grads(ranks, mesh, arch, case)
    for k, (g, _) in got.items():
        np.testing.assert_allclose(g, want[k], err_msg=k, **REF_TOL)
    np.testing.assert_allclose(metrics["loss"], loss, **REF_TOL)
