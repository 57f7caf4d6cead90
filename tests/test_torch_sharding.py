"""The port's sharding rules against the JAX package's, in the pytest
process, with no process group: ``spec_for``/``param_specs`` for every
parameter of every smoke config (single-pod and multi-pod dp), the KV
caches' specs, ``make_ctx``, the divisibility refusal, and
``shard_lm_params`` cutting each rank's blocks.

The reference's rules need only a mesh's axis names and sizes, so it
runs on ``jax.sharding.AbstractMesh``; the port's on an ``LmMesh`` of one
rank (``make_lm_mesh`` without a process group) or one constructed for
its layout only (no groups: its collectives over more than one rank
raise).
"""
import dataclasses

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro import configs as rconfigs
from repro.distributed import sharding as rsharding
from repro.launch import specs as rspecs
from repro.models import transformer as RT

from repro_torch import configs as tconfigs
from repro_torch.convert import shard_lm_params
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.models import transformer as TT

CPU = torch.device("cpu")
#: the two dp layouts: the single-pod (data, model) mesh and the
#: multi-pod (pod, data, model) one
LAYOUTS = {"data": {"data": 2, "model": 2},
           "pod": {"pod": 2, "data": 1, "model": 2}}


def _layout(axes, coords=None):
    """An LmMesh for ``axes``'s layout (no process group) and the
    reference's AbstractMesh of the same axes."""
    names, shape = tuple(axes), tuple(axes.values())
    mesh = tmesh.LmMesh(names, shape, coords or (0,) * len(names), CPU,
                        "gloo")
    return mesh, AbstractMesh(shape, names)


def _reference_specs(cfg, rctx):
    """The reference's ``param_specs`` as ``{port name: spec}``: period
    stacks unstacked (their leading axis, which the rules leave whole,
    dropped) onto the port's one-module-per-layer names."""
    shapes = jax.eval_shape(lambda k: RT.init_params(k, cfg),
                            jax.random.key(0))
    specs = rsharding.param_specs(shapes, rctx)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    out = {}
    for path, spec in flat:
        parts = rsharding._path_str(path).split("/")
        if parts[0] == "blocks":
            assert spec[0] is None
            pos = int(parts[1][3:])
            for s in range(cfg.n_periods):
                idx = cfg.n_prologue + s * cfg.period + pos
                out[".".join(["layers", str(idx)] + parts[2:])] = \
                    tuple(spec)[1:]
        elif parts[0] == "prologue":
            out[".".join(["layers"] + parts[1:])] = tuple(spec)
        else:
            out[".".join(parts)] = tuple(spec)
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_param_specs_equal_the_reference(arch, layout):
    """Every parameter of every smoke config gets exactly the reference's
    spec (single-pod ``dp="data"`` and multi-pod ``dp=("pod", "data")``)."""
    mesh, rmesh = _layout(LAYOUTS[layout])
    ctx, rctx = tsharding.make_ctx(mesh), rsharding.make_ctx(rmesh)
    assert (ctx.dp, ctx.tp) == (rctx.dp, rctx.tp)
    cfg = tconfigs.get_smoke_config(arch)
    model = TT.Transformer(cfg, device="meta")
    got = tsharding.param_specs(model, ctx)
    want = _reference_specs(rconfigs.get_smoke_config(arch), rctx)
    assert got == want
    for name, t in model.state_dict().items():
        assert tsharding.spec_for(name.replace(".", "/"), t.dim(), ctx) == \
            got[name]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_make_ctx_on_both_layouts(layout):
    """``make_ctx`` names the reference's axes, and the sizes and this
    rank's indices follow the mesh (row-major over several dp axes)."""
    axes = LAYOUTS[layout]
    coords = tuple(n - 1 for n in axes.values())
    mesh, rmesh = _layout(axes, coords)
    ctx, rctx = tsharding.make_ctx(mesh), rsharding.make_ctx(rmesh)
    assert (ctx.dp, ctx.tp) == (rctx.dp, rctx.tp)
    assert (ctx.dp_size, ctx.tp_size) == (rctx.dp_size, rctx.tp_size)
    assert (ctx.dp_index, ctx.tp_index) == (ctx.dp_size - 1,
                                            ctx.tp_size - 1)
    one = tmesh.make_lm_mesh({a: 1 for a in axes}, device="cpu")
    assert tsharding.make_ctx(one).dp == ctx.dp
    with pytest.raises(TypeError, match="LmMesh"):
        tsharding.make_ctx(rmesh)


@pytest.mark.parametrize("B", [4, 3])
def test_kv_cache_specs_equal_the_reference(B):
    """The KV caches' specs: the batch over dp and the sequence over tp
    when the batch divides dp (B=4), else the sequence over (dp, tp)."""
    cfg = tconfigs.get_smoke_config("qwen2_5_32b")
    mesh, rmesh = _layout(LAYOUTS["data"])
    ctx, rctx = tsharding.make_ctx(mesh), rsharding.make_ctx(rmesh)
    ref = rspecs.cache_struct(rconfigs.get_smoke_config("qwen2_5_32b"), B,
                              16, rctx)
    want = tuple(ref["blocks"]["pos0"].k.sharding.spec)[1:]
    for layer in tspecs.cache_struct(cfg, B, 16, ctx):
        assert isinstance(layer, tspecs.KVStruct)
        for shape, spec in layer:
            assert shape == (B, 16, cfg.n_kv_heads, cfg.head_dim)
            assert spec == want
    n, _, S_loc = tspecs.seq_shard(B, 16, ctx)
    assert n * S_loc >= 16
    assert tspecs.local_kv_shape(cfg, B, 16, ctx) == (
        B // 2 if B % 2 == 0 else B, S_loc, cfg.n_kv_heads, cfg.head_dim)
    # an SSM stack's cache has specs too (ROADMAP Queue 1 item 24 is done)
    falcon = tspecs.cache_struct(tconfigs.get_smoke_config("falcon_mamba_7b"),
                                 B, 16, ctx)
    assert all(isinstance(c, tspecs.SSMStruct) for c in falcon)


@pytest.mark.parametrize("B", [4, 3])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "jamba_1_5_large_398b"])
def test_ssm_cache_specs_equal_the_reference(arch, layout, B):
    """Every cache leaf of an SSM or hybrid stack gets the reference's
    spec, layer by layer: the conv history ``(B, K-1, d_inner)`` and the
    state ``(B, d_inner, N)`` with the batch as laid out and ``d_inner``
    over tp, the hybrid's KV caches sequence-sharded; the local shapes
    are those specs' blocks."""
    cfg = tconfigs.get_smoke_config(arch)
    mesh, rmesh = _layout(LAYOUTS[layout])
    ctx, rctx = tsharding.make_ctx(mesh), rsharding.make_ctx(rmesh)
    ref = rspecs.cache_struct(rconfigs.get_smoke_config(arch), B, 16, rctx)
    got = tspecs.cache_struct(cfg, B, 16, ctx)
    assert len(got) == cfg.n_layers
    for i, layer in enumerate(got):
        pos = i % cfg.period
        want = ref["blocks"][f"pos{pos}"]
        for name, leaf in layer._asdict().items():
            w = getattr(want, name)
            assert leaf.shape == tuple(w.shape)[1:], (i, name)
            assert leaf.spec == tuple(w.sharding.spec)[1:], (i, name)
    conv, ssm = tspecs.ssm_state_shapes(cfg, B, ctx)
    rows = B // ctx.dp_size if B % ctx.dp_size == 0 else B
    di = cfg.d_inner // ctx.tp_size
    assert conv == (rows, cfg.ssm_conv - 1, di)
    assert ssm == (rows, di, cfg.ssm_state)
    caches = TT.init_cache(cfg, B, 16, device=CPU, ctx=ctx)
    for c, layer in zip(caches, got):
        if isinstance(layer, tspecs.SSMStruct):
            assert (tuple(c.conv.shape), tuple(c.ssm.shape)) == (conv, ssm)
            assert c.ssm.dtype == torch.float32


@pytest.mark.parametrize("field", ["n_heads", "n_kv_heads", "d_ff",
                                   "vocab_size", "d_model"])
def test_an_uneven_shard_raises(field):
    """GSPMD pads uneven shards; the port raises ``ValueError`` naming
    the dimension (tp must divide the heads, KV heads, d_ff and the
    vocabulary, dp the model width)."""
    cfg = tconfigs.get_smoke_config("qwen2_5_32b")
    cfg = dataclasses.replace(cfg, **{field: getattr(cfg, field) + 1})
    mesh, _ = _layout({"data": 2, "model": 2})
    ctx = tsharding.make_ctx(mesh)
    with pytest.raises(ValueError, match=field):
        tsharding.check_divisible(cfg, ctx)
    with pytest.raises(ValueError, match=field):
        shard_lm_params(TT.Transformer(cfg, device="meta"), cfg, ctx)


@pytest.mark.parametrize("tp", [4, 8])
def test_kv_heads_fewer_than_tp_are_shared_by_model_ranks(tp):
    """2 KV heads at tp 4 and 8 (the smoke Llama-3: 8 query heads, head
    dim 8) are accepted, each shared by ``r = tp / 2`` model ranks: model
    rank ``t``'s wk and wv blocks are the reference's ``(dp, tp)`` blocks,
    columns ``[t c, (t+1) c)`` with ``c = head_dim / r``, a slice of KV
    head ``t // r``, the one its query heads use."""
    cfg = tconfigs.get_smoke_config("llama3_405b")
    assert (cfg.n_heads, cfg.n_kv_heads) == (8, 2)
    r = tp // cfg.n_kv_heads
    assert tsharding.kv_share(cfg.n_kv_heads, tp) == r
    full = TT.init_params(0, cfg, device=CPU)
    hd, c = cfg.head_dim, cfg.head_dim // r
    group = cfg.n_heads // cfg.n_kv_heads           # query heads a KV head
    for t in range(tp):
        mesh, _ = _layout({"data": 1, "model": tp}, (0, t))
        ctx = tsharding.make_ctx(mesh)
        tsharding.check_divisible(cfg, ctx)
        part = shard_lm_params(full, cfg, ctx)
        hq = cfg.n_heads // tp
        assert {h // group for h in range(t * hq, (t + 1) * hq)} == {t // r}
        for w in ("wk", "wv"):
            got = getattr(part.layers[0].mixer, w).w
            whole = getattr(full.layers[0].mixer, w).w
            head = whole[:, (t // r) * hd:(t // r + 1) * hd]
            assert torch.equal(got, head[:, (t % r) * c:(t % r + 1) * c])
    # one KV head a rank and more are the even case
    for n_tp in (1, 2):
        assert tsharding.kv_share(cfg.n_kv_heads, n_tp) == 1


@pytest.mark.parametrize("case", ["n_kv_heads", "n_heads", "head_dim"])
def test_uneven_kv_or_query_heads_over_tp_raise(case):
    """At tp 4: 3 KV heads (neither divides the other) name
    ``n_kv_heads``; the smoke Mistral's 6 query heads name ``n_heads``
    with the reason that the port does not pad query heads (ROADMAP item
    29); KV heads shared by more model ranks than ``head_dim`` can be cut
    into name ``head_dim``."""
    cfg = {"n_kv_heads": dataclasses.replace(
               tconfigs.get_smoke_config("qwen2_5_32b"), n_heads=12,
               n_kv_heads=3),
           "n_heads": tconfigs.get_smoke_config("mistral_large_123b"),
           "head_dim": dataclasses.replace(
               tconfigs.get_smoke_config("llama3_405b"), n_kv_heads=1,
               head_dim=2)}[case]
    match = {"n_kv_heads": "n_kv_heads=3",
             "n_heads": r"n_heads=6 .*ROADMAP item 29",
             "head_dim": "head_dim=2"}[case]
    mesh, _ = _layout({"data": 1, "model": 4})
    ctx = tsharding.make_ctx(mesh)
    with pytest.raises(ValueError, match=match):
        tsharding.check_divisible(cfg, ctx)
    with pytest.raises(ValueError, match=match):
        shard_lm_params(TT.Transformer(cfg, device="meta"), cfg, ctx)


@pytest.mark.parametrize("arch,field", [("qwen3_moe_30b_a3b", "n_experts"),
                                        ("kimi_k2_1t_a32b", "shared_width"),
                                        ("falcon_mamba_7b", "d_inner"),
                                        ("jamba_1_5_large_398b", "d_inner")])
def test_an_uneven_expert_or_channel_shard_raises(arch, field):
    """tp must also divide the experts, the shared experts' width and
    (with SSM layers) ``d_inner``; a dense model's ``d_inner`` is never
    cut, so it is not checked."""
    cfg = tconfigs.get_smoke_config(arch)
    change = {"n_experts": dict(n_experts=cfg.n_experts + 1),
              "shared_width": dict(d_expert=cfg.d_expert + 1),
              "d_inner": dict(d_model=cfg.d_model + 1, ssm_expand=1)}[field]
    cfg = dataclasses.replace(cfg, **change)
    mesh, _ = _layout({"data": 1, "model": 2})
    ctx = tsharding.make_ctx(mesh)
    with pytest.raises(ValueError, match=field):
        tsharding.check_divisible(cfg, ctx)
    dense = dataclasses.replace(tconfigs.get_smoke_config("qwen2_5_32b"),
                                d_model=65, ssm_expand=1)
    tsharding.check_divisible(dense, ctx)
    assert dense.d_inner % 2


@pytest.mark.parametrize("coords", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_shard_lm_params_cuts_in_proj_half_by_half(coords):
    """Mamba's ``in_proj`` ``(d, 2 d_inner)`` holds ``x`` and ``z`` side by
    side: a rank's block is ``[x block | z block]`` of the same channels
    (a contiguous tp block of the whole would give model rank 0 all of
    ``x`` and none of ``z``); every other tensor is its spec's block."""
    cfg = tconfigs.get_smoke_config("jamba_1_5_large_398b")
    full = TT.init_params(0, cfg, device=CPU)
    mesh, _ = _layout({"data": 2, "model": 2}, coords)
    ctx = tsharding.make_ctx(mesh)
    part = shard_lm_params(full, cfg, ctx)
    whole = full.state_dict()
    i, j = coords
    di, dl = cfg.d_inner, cfg.d_inner // 2
    rows = slice(i * cfg.d_model // 2, (i + 1) * cfg.d_model // 2)
    for name, t in part.state_dict().items():
        assert t.is_contiguous() and t.dtype == whole[name].dtype
        if not name.endswith("in_proj.w"):
            spec = tsharding.spec_for(name, whole[name].dim(), ctx)
            assert torch.equal(t, tsharding.shard_tensor(whole[name], spec,
                                                         ctx))
            continue
        w = whole[name]
        assert torch.equal(t[:, :dl], w[rows, j * dl:(j + 1) * dl])
        assert torch.equal(t[:, dl:], w[rows, di + j * dl:di + (j + 1) * dl])
        assert torch.equal(t, tsharding.shard_param(name, w, ctx))
        # the contiguous block would be another one
        spec = tsharding.spec_for(name, w.dim(), ctx)
        assert not torch.equal(t, tsharding.shard_tensor(w, spec, ctx))
    # the conv, dt_proj and A_log blocks hold the same channels
    m = part.layers[0].mixer
    assert torch.equal(m.conv_w, full.layers[0].mixer.conv_w[
        :, j * dl:(j + 1) * dl])
    assert torch.equal(m.A_log, full.layers[0].mixer.A_log[
        j * dl:(j + 1) * dl])


@pytest.mark.parametrize("coords", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_shard_lm_params_cuts_the_spec_blocks(coords):
    """Each rank's blocks are its spec's slices of the whole tensors, in
    their own dtype and contiguous (checked by hand for wq's (dp, tp)
    block and the embedding's (tp, dp) block)."""
    cfg = tconfigs.get_smoke_config("qwen2_5_32b")
    full = TT.init_params(0, cfg, device=CPU)
    mesh, _ = _layout({"data": 2, "model": 2}, coords)
    ctx = tsharding.make_ctx(mesh)
    part = shard_lm_params(full, cfg, ctx)
    whole = full.state_dict()
    for name, t in part.state_dict().items():
        spec = tsharding.spec_for(name, whole[name].dim(), ctx)
        assert torch.equal(t, tsharding.shard_tensor(whole[name], spec,
                                                     ctx))
        assert t.dtype == whole[name].dtype and t.is_contiguous()
    i, j = coords
    w = whole["layers.1.mixer.wq.w"]              # (d, Hq hd): (dp, tp)
    d, o = w.shape[0] // 2, w.shape[1] // 2
    assert torch.equal(part.layers[1].mixer.wq.w,
                       w[i * d:(i + 1) * d, j * o:(j + 1) * o])
    V = cfg.vocab_size // 2
    assert torch.equal(part.embed.table, whole["embed.table"][
        j * V:(j + 1) * V, i * cfg.d_model // 2:(i + 1) * cfg.d_model // 2])


def test_a_mesh_of_one_rank_needs_no_process_group():
    """Without a process group an LM mesh of one rank forms, its
    collectives return their input, and a ctx on it serves as no ctx;
    a larger mesh, or axes that do not end in ``model``, raise."""
    mesh = tmesh.make_test_mesh(1, 1, device="cpu")
    assert mesh.coords == (0, 0) and mesh.transport == "gloo"
    t = torch.arange(6.0).reshape(2, 3)
    for out in (mesh.all_reduce(t, "model"), mesh.all_gather(t, "data"),
                mesh.reduce_scatter(t, ("data", "model")),
                mesh.all_to_all(t, "model")):
        assert out is t
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_test_mesh(2, 2, device="cpu")
    with pytest.raises(ValueError, match="model"):
        tmesh.make_lm_mesh({"model": 1, "data": 1}, device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        _layout({"data": 2, "model": 2})[0].all_reduce(t, "model")
