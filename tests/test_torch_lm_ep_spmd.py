"""Expert-parallel MoE and ``d_inner``-parallel Mamba in the port, on a
(data, model) mesh of 4 gloo CPU ranks, against the port's unsharded
run and the JAX reference's.

One ``spawn_ranks`` of 4 ranks, module-scoped and with a hard timeout,
serves every case (``repro_torch.testing.run_lm_on_mesh``): the smoke
configs of Qwen3-MoE, Kimi-K2 (a shared expert, a dense prologue),
Falcon-Mamba and Jamba (8 layers: attention, Mamba, dense and MoE), fp32,
prefill and 4 greedy decode steps through ``launch.serve.generate(ctx=)``
on (2, 2) under both ``tp_collectives``, on (4, 1) under both, and with a
batch of 3 that (2, 2) cannot shard (replicated over dp).  The pytest
process never initialises a process group: it assembles the ranks'
blocks and asserts case by case.  The JAX side runs here on one CPU
device, unsharded, on the same weights (the reference's ``init_params``,
carried across by ``repro_torch.convert``); the ranks cut their blocks
from the same tree.

The oracle is per dp shard.  An MoE layer's capacity counts the tokens of
its call (``_moe_math``, reference ``models/moe.py:68``), so with the
batch sharded over dp each shard drops entries among its own tokens: a
sharded run equals the unsharded model run on each dp shard's rows
separately, and on the whole batch only where the batch is replicated.
Every comparison here takes the unsharded runs on those sub-batches.

Bounds, fp32 throughout, those of ``tests/test_torch_lm_spmd.py``.
Against the port's unsharded run: logits and SSM states within ``1e-5``
abs and rel (the same fp32 products, partial sums added in another
order), tokens and MoE routes (experts and kept slots) equal, ``aux_loss``
and ``dropped`` within ``1e-5`` relative (``tests/test_torch_hybrid.py``'s
aux bound).  Against the JAX reference: ``2e-4``, the same tokens.
``"manual"`` against ``"gspmd"``: ``rtol=1e-3, atol=1e-4``.  The two
model ranks of a data row route alike (equal digests).  Two controls,
each on (2, 2): a rank serving with the next model rank's experts of the
first MoE layer, and with the next model rank's ``out_proj`` block of
layer 0's Mamba mixer, must fall outside the ``1e-5`` bound.
"""
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
from repro_torch.convert import lm_params_from_reference, shard_lm_params
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import specs as tspecs

#: seconds the spawn may take before every rank is killed
SPAWN_TIMEOUT = 300
WORLD = 4
ARCHS = ["qwen3_moe_30b_a3b", "kimi_k2_1t_a32b", "falcon_mamba_7b",
         "jamba_1_5_large_398b"]
MOE_ARCHS = ["qwen3_moe_30b_a3b", "kimi_k2_1t_a32b", "jamba_1_5_large_398b"]
SSM_ARCHS = ["falcon_mamba_7b", "jamba_1_5_large_398b"]
P, GEN = 12, 5                  # prefill + 4 greedy decode steps
SHARDED_TOL = dict(rtol=1e-5, atol=1e-5)
REF_TOL = dict(rtol=2e-4, atol=2e-4)
MODE_TOL = dict(rtol=1e-3, atol=1e-4)
AUX_RTOL = 1e-5
#: serving cases: (mesh, tp_collectives, batch); (4, 1) takes 8 prompts,
#: so that every case's dp shards hold 2 rows (or the 3 of the
#: replicated batch)
CASES = {"gspmd_2x2": ((2, 2), "gspmd", 4),
         "manual_2x2": ((2, 2), "manual", 4),
         "gspmd_4x1": ((4, 1), "gspmd", 8),
         "manual_4x1": ((4, 1), "manual", 8),
         "gspmd_2x2_b3": ((2, 2), "gspmd", 3)}
#: the controls: the parameters served with the next model rank's blocks
#: (``testing.control_params``), on (2, 2), prefill only
CONTROLS = [(a, "experts") for a in MOE_ARCHS] + [(a, "out_proj")
                                                   for a in SSM_ARCHS]


def _prompts(arch, batch):
    rng = np.random.default_rng(1)
    cfg = rconfigs.get_smoke_config(arch)
    return rng.integers(0, cfg.vocab_size, (batch, P)).astype(np.int64)


def _shards(batch, dp):
    """The rows of each dp shard: ``dp`` equal slices, or the whole batch
    once where ``dp`` does not divide it (replicated)."""
    if batch % dp:
        return [slice(0, batch)]
    n = batch // dp
    return [slice(i * n, (i + 1) * n) for i in range(dp)]


@pytest.fixture(scope="module")
def trees():
    """The reference's parameters for each config, as numpy."""
    return {arch: jax.tree.map(np.asarray, RT.init_params(
        jax.random.key(1), rconfigs.get_smoke_config(arch)))
        for arch in ARCHS}


@pytest.fixture(scope="module")
def ranks(trees):
    """Every case, served in one spawn of 4 gloo CPU ranks."""
    runs = []
    for arch in ARCHS:
        cfg = tconfigs.get_smoke_config(arch)
        common = dict(kind="serve", cfg=cfg, params=trees[arch])
        for case, (mesh, mode, b) in CASES.items():
            runs.append(dict(common, name=f"{arch}:{case}", mesh=mesh,
                             mode=mode, weights=f"{arch}:{mesh}",
                             prompts=_prompts(arch, b), gen=GEN))
        for control in (c for a, c in CONTROLS if a == arch):
            runs.append(dict(common, name=f"{arch}:control_{control}",
                             mesh=(2, 2), mode="gspmd",
                             weights=f"{arch}:{(2, 2)}",
                             prompts=_prompts(arch, 4), gen=1,
                             swap=control))
    return tmesh.spawn_ranks(ttesting.run_lm_on_mesh, WORLD, runs, "cpu",
                             timeout=SPAWN_TIMEOUT, device="cpu")


_PORT, _REF, _REF_FNS = {}, {}, {}


def _port(trees, arch, prompts):
    """The port's unsharded run of ``prompts`` (``testing.serve_record``),
    memoized."""
    key = (arch, prompts.tobytes(), prompts.shape)
    if key not in _PORT:
        cfg = tconfigs.get_smoke_config(arch)
        model = lm_params_from_reference(trees[arch], cfg, device="cpu")
        _PORT[key] = ttesting.serve_record(model, cfg,
                                           torch.from_numpy(prompts), GEN)
    return _PORT[key]


def _reference(trees, arch, prompts):
    """The JAX reference's unsharded prefill and greedy decode steps of
    ``prompts``: (tokens (B, GEN), logits (GEN, B, V)), memoized."""
    key = (arch, prompts.tobytes(), prompts.shape)
    if key in _REF:
        return _REF[key]
    cfg = rconfigs.get_smoke_config(arch)
    if arch not in _REF_FNS:
        _REF_FNS[arch] = (jax.jit(rserve.make_prefill(cfg, None,
                                                      impl="pallas")),
                          jax.jit(rserve.make_decode_step(cfg, None)))
    prefill, decode = _REF_FNS[arch]
    params = jax.tree.map(jnp.asarray, trees[arch])
    B = prompts.shape[0]
    logits, pre = prefill(params, {"inputs": jnp.asarray(prompts,
                                                         jnp.int32)})
    cache = rserve._merge_prefill_cache(RT.init_cache(cfg, B, P + GEN), pre,
                                        cfg, P)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    toks, all_logits = [tok], [logits]
    for i in range(GEN - 1):
        logits, cache = decode(params, {"inputs": tok[:, None]}, cache,
                               jnp.int32(P + i))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(tok)
        all_logits.append(logits)
    _REF[key] = (np.stack([np.asarray(t) for t in toks], 1),
                 np.stack([np.asarray(x) for x in all_logits]))
    return _REF[key]


def _groups(ranks, name, mesh, batch):
    """For each dp shard: its rows and its model ranks' results (rank
    (i, j) is global rank ``i * M + j``); with the batch replicated, one
    shard of every rank."""
    dp, tp = mesh
    rows = _shards(batch, dp)
    if len(rows) == 1:
        return [(rows[0], ranks)]
    return [(rows[i], [ranks[i * tp + j] for j in range(tp)])
            for i in range(dp)]


def _sharded(ranks, arch, case):
    """A case's tokens (every rank's must be equal) and logits (steps, B,
    V) from the ranks' rows (the model ranks of a shard hold the same)."""
    mesh, _, batch = CASES[case]
    name = f"{arch}:{case}"
    toks = [r[f"{name}.tokens"] for r in ranks]
    for t in toks[1:]:
        assert np.array_equal(t, toks[0])
    parts = []
    for _, group in _groups(ranks, name, mesh, batch):
        for r in group[1:]:
            assert np.array_equal(r[f"{name}.logits"],
                                  group[0][f"{name}.logits"])
        parts.append(group[0][f"{name}.logits"])
    return toks[0].astype(np.int64), np.concatenate(parts, axis=1)


def _oracle(fn, trees, arch, batch, dp, **kw):
    """``fn``'s (tokens, logits) on each dp shard's rows, joined."""
    prompts = _prompts(arch, batch)
    outs = [fn(trees, arch, prompts[rows], **kw)
            for rows in _shards(batch, dp)]
    return (np.concatenate([o[0] for o in outs]),
            np.concatenate([o[1] for o in outs], axis=1))


def _port_pair(trees, arch, prompts):
    rec = _port(trees, arch, prompts)
    return rec["tokens"], rec["logits"]


# --------------------------------------------------------------------- #
# serving                                                               #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_matches_the_port_unsharded(ranks, trees, arch,
                                                    case):
    """Prefill and 4 greedy decode steps on the mesh: every step's logits
    within ``1e-5`` of the port's unsharded run on each dp shard's rows,
    the same tokens on every rank and as unsharded."""
    mesh, _, batch = CASES[case]
    want_toks, want = _oracle(_port_pair, trees, arch, batch, mesh[0])
    toks, got = _sharded(ranks, arch, case)
    assert got.shape == (GEN, batch, tconfigs.get_smoke_config(
        arch).vocab_size)
    np.testing.assert_allclose(got, want, **SHARDED_TOL)
    assert np.array_equal(toks, want_toks)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_matches_the_reference(ranks, trees, arch, case):
    """The same against the JAX reference's unsharded ``prefill`` and
    ``decode_step`` (the Pallas kernel in interpret mode) on each dp
    shard's rows, within ``2e-4``, the same greedy tokens."""
    mesh, _, batch = CASES[case]
    want_toks, want = _oracle(_reference, trees, arch, batch, mesh[0])
    toks, got = _sharded(ranks, arch, case)
    np.testing.assert_allclose(got, want, **REF_TOL)
    assert np.array_equal(toks, want_toks)


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_manual_collectives_match_gspmd(ranks, arch, mesh):
    """``tp_collectives="manual"`` against ``"gspmd"`` on the same mesh
    and weights."""
    toks_g, got_g = _sharded(ranks, arch, f"gspmd_{mesh}")
    toks_m, got_m = _sharded(ranks, arch, f"manual_{mesh}")
    np.testing.assert_allclose(got_m, got_g, **MODE_TOL)
    assert np.array_equal(toks_m, toks_g)


# --------------------------------------------------------------------- #
# routes, aux, states                                                   #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_routes_are_equal_across_model_ranks_and_to_the_oracle(
        ranks, trees, arch, case):
    """The model ranks of a dp shard route its tokens alike (equal
    digests, equal routes), every MoE call's experts and kept slots equal
    the unsharded run's on those rows, prefill and decode, and capacity
    dropped some entry somewhere (so that the per-shard oracle is
    exercised)."""
    mesh, _, batch = CASES[case]
    name = f"{arch}:{case}"
    prompts = _prompts(arch, batch)
    dropped = False
    for rows, group in _groups(ranks, name, mesh, batch):
        want = _port(trees, arch, prompts[rows])
        for r in group:
            assert r[f"{name}.route_digests"] == want["route_digests"]
            assert len(r[f"{name}.routes"]) == len(want["routes"])
            for (e, k), (we, wk) in zip(r[f"{name}.routes"],
                                        want["routes"]):
                assert np.array_equal(e, we) and np.array_equal(k, wk)
        dropped |= any(not k.all() for _, k in want["routes"])
    assert dropped


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_aux_is_the_reference_pmean_of_the_shards(ranks, trees, arch,
                                                  case):
    """The prefill's ``aux_loss`` is the mean over dp shards of the
    unsharded run's on their rows (the whole batch's when replicated);
    ``dropped`` the mean over model ranks, then dp shards, of each rank's
    share of its own experts' entries that were dropped (the reference's
    ``pmean``s), both summed over the MoE layers; every rank holds the
    same."""
    mesh, _, batch = CASES[case]
    cfg = tconfigs.get_smoke_config(arch)
    name = f"{arch}:{case}"
    dp, tp = mesh
    n_moe = sum(cfg.mlp_kind(i) == "moe" for i in range(cfg.n_layers))
    E_loc = cfg.n_experts // tp
    prompts = _prompts(arch, batch)
    aux_loss, dropped = [], []
    for rows in _shards(batch, dp):
        want = _port(trees, arch, prompts[rows])
        aux_loss.append(want["aux_loss"])
        per_layer = []
        for e, k in want["routes"][:n_moe]:
            shares = []
            for j in range(tp):
                local = (e >= j * E_loc) & (e < (j + 1) * E_loc)
                shares.append(1.0 - (k & local).sum() / max(local.sum(), 1))
            per_layer.append(np.mean(shares))
        dropped.append(sum(per_layer))
    for r in ranks:
        np.testing.assert_allclose(r[f"{name}.aux_loss"], np.mean(aux_loss),
                                   rtol=AUX_RTOL, atol=1e-7)
        np.testing.assert_allclose(r[f"{name}.dropped"], np.mean(dropped),
                                   rtol=AUX_RTOL, atol=1e-7)
    assert ranks[0][f"{name}.aux_loss"] > 0


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_states_are_the_spec_blocks_of_the_unsharded(ranks, trees, arch,
                                                         case):
    """Each SSM layer's conv history and state after the last step: a
    rank's block has the shapes ``launch.specs.ssm_state_shapes`` gives
    and equals its rows' and ``d_inner/tp`` channels' block of the
    unsharded run's within ``1e-5``, so the ``in_proj`` halves put the
    ``x`` and ``z`` channels of the same indices on a rank."""
    mesh, _, batch = CASES[case]
    cfg = tconfigs.get_smoke_config(arch)
    name = f"{arch}:{case}"
    dp, tp = mesh
    ctx = tsharding.make_ctx(tmesh.LmMesh(("data", "model"), mesh, (0, 0),
                                          torch.device("cpu"), "gloo"))
    conv_shape, ssm_shape = tspecs.ssm_state_shapes(cfg, batch, ctx)
    di = cfg.d_inner // tp
    prompts = _prompts(arch, batch)
    n_ssm = sum(cfg.layer_kind(i) == "ssm" for i in range(cfg.n_layers))
    for rows, group in _groups(ranks, name, mesh, batch):
        want = _port(trees, arch, prompts[rows])["ssm"]
        assert len(want) == n_ssm
        for j, r in enumerate(group):
            j = j % tp
            got = r[f"{name}.ssm"]
            assert len(got) == n_ssm
            for (conv, ssm), (w_conv, w_ssm) in zip(got, want):
                assert conv.shape == conv_shape and ssm.shape == ssm_shape
                np.testing.assert_allclose(
                    conv, w_conv[..., j * di:(j + 1) * di], **SHARDED_TOL)
                np.testing.assert_allclose(
                    ssm, w_ssm[:, j * di:(j + 1) * di], **SHARDED_TOL)


# --------------------------------------------------------------------- #
# controls, weights, kernels                                            #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("arch,control", CONTROLS)
def test_a_rank_with_a_wrong_block_is_rejected(ranks, trees, arch,
                                               control):
    """The controls: the next model rank's experts of the first MoE layer,
    or its ``out_proj`` block of layer 0's Mamba mixer; the prefill's
    logits leave the sharded-vs-unsharded bound."""
    prompts = _prompts(arch, 4)
    want = np.concatenate([_port(trees, arch, prompts[rows])["logits"][:1]
                           for rows in _shards(4, 2)], axis=1)
    name = f"{arch}:control_{control}"
    got = np.concatenate([ranks[0][f"{name}.logits"],
                          ranks[2][f"{name}.logits"]], axis=1)
    assert got.shape == want.shape
    assert not np.allclose(got, want, **SHARDED_TOL)
    assert float(np.abs(got - want).max()) > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_every_rank_holds_its_blocks_and_runs_the_flash_wrapper(ranks, trees,
                                                                arch):
    """Each rank's weights are its blocks of the reference's tree (their
    fingerprint against the blocks cut here), each prefill ran attention
    through the flash kernel's wrapper (on CPU tensors its plain version,
    once an attention layer), and the collectives moved bytes."""
    cfg = tconfigs.get_smoke_config(arch)
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    full = lm_params_from_reference(trees[arch], cfg, device="cpu")
    for rank, r in enumerate(ranks):
        coords = tuple(int(c) for c in np.unravel_index(rank, (2, 2)))
        mesh = tmesh.LmMesh(("data", "model"), (2, 2), coords,
                            torch.device("cpu"), "gloo")
        part = shard_lm_params(full, cfg, tsharding.make_ctx(mesh))
        assert r[f"{arch}:gspmd_2x2.fingerprint"] == \
            ttesting.param_fingerprint(part)
        for case in CASES:
            name = f"{arch}:{case}"
            assert r[f"{name}.plain_calls"] == n_attn
            assert r[f"{name}.flash_launches"] == 0
            assert r[f"{name}.calls"] > 0 and r[f"{name}.bytes_in"] > 0


def test_serve_cli_serves_a_hybrid_model_on_a_mesh(capsys):
    """``--mesh 2x2`` serves the Jamba smoke model (every layer kind): the
    ranks' transport and a 4 x 16 array of tokens."""
    assert tserve.main(["--arch", "jamba_1_5_large_398b", "--smoke",
                        "--device", "cpu", "--mesh", "2x2", "--temperature",
                        "0"]) == 0
    out = capsys.readouterr().out
    assert "on gloo, (data,model)=2x2 on the CPU" in out
    assert "decode 15 steps" in out
