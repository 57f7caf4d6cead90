"""Sharded LM serving in the port, on a (data, model) mesh of 4 gloo CPU
ranks, against the port's unsharded run and the JAX reference's.

One ``spawn_ranks`` of 4 ranks, module-scoped and with a hard timeout,
computes every case (``repro_torch.testing.run_lm_on_mesh``): the ring
matmuls and the plain collectives they replace, each tensor-parallel
primitive, the sequence-sharded decode attention, and the smoke Qwen2.5
model's prefill and 4 greedy decode steps through
``launch.serve.generate(ctx=)``.  The pytest process never initialises
a process group: it assembles the ranks' blocks and asserts case by
case.  The JAX side runs here on one CPU device, unsharded, on the same
weights (the reference's ``init_params``, carried across by
``repro_torch.convert``); the ranks cut their blocks from the same tree.

Bounds, fp32 throughout.  The ring all-gather matmul is its all-gather
reference bitwise (the same row products); the reduce-scatter ring
within the reference test's ``1e-4`` of its reference
(``tests/test_distributed.py:31-55``).  A primitive against the
unsharded product, and a sharded model against the port's unsharded
run: ``1e-5`` abs and rel (the same fp32 products, partial sums added in
another order).  Against the JAX reference: ``2e-4``, the bound
``tests/test_torch_lm.py`` holds the unsharded port to.  ``"manual"``
against ``"gspmd"``: the reference's ``rtol=1e-3, atol=1e-4``
(``test_distributed.py:347-355``).  The sequence-sharded decode
attention: ``2e-5`` (``test_distributed.py:358``).  A rank holding a
wrong block (layer 0's wo shards of the two model ranks swapped) must
fall outside the sharded-vs-unsharded bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.launch import serve as rserve
from repro.models import attention as rattn
from repro.models import transformer as RT

from repro_torch import configs as tconfigs
from repro_torch import testing as ttesting
from repro_torch.convert import lm_params_from_reference, shard_lm_params
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn

#: seconds the spawn may take before every rank is killed
SPAWN_TIMEOUT = 300
WORLD = 4
ARCH = "qwen2_5_32b"
B, P, GEN = 4, 12, 5            # prefill + 4 greedy decode steps
SHARDED_TOL = dict(rtol=1e-5, atol=1e-5)
REF_TOL = dict(rtol=2e-4, atol=2e-4)
MODE_TOL = dict(rtol=1e-3, atol=1e-4)
#: sharded serving cases: (mesh, tp_collectives, batch)
SERVE = {"gspmd_2x2": ((2, 2), "gspmd", B),
         "manual_2x2": ((2, 2), "manual", B),
         "gspmd_2x2_b3": ((2, 2), "gspmd", 3),
         "manual_4x1": ((4, 1), "manual", B)}
PRIMITIVES = ["col", "row_manual", "row_gspmd", "col_2dtp", "row_2dtp",
              "embed", "embed_2dtp"]
DECODE_LENS = [47, 10]


def _cfg():
    return rconfigs.get_smoke_config(ARCH)


def _prompts(batch):
    rng = np.random.default_rng(1)
    return rng.integers(0, _cfg().vocab_size, (batch, P)).astype(np.int64)


@pytest.fixture(scope="module")
def tree():
    """The reference's parameters, as numpy."""
    return jax.tree.map(np.asarray, RT.init_params(jax.random.key(1),
                                                   _cfg()))


@pytest.fixture(scope="module")
def ranks(tree):
    """Every case, computed in one spawn of 4 gloo CPU ranks."""
    cfg = tconfigs.get_smoke_config(ARCH)
    runs = [dict(name="ring_fp32", kind="ring", mesh=(1, 4), seed=0),
            dict(name="ring_bf16", kind="ring", mesh=(1, 4), seed=1,
                 dtype=torch.bfloat16)]
    runs += [dict(name=f"tp_b{b}", kind="tp", mesh=(2, 2), B=b, seed=2)
             for b in (4, 3)]
    runs += [dict(name=f"dec_{n}", kind="decode_attention", mesh=(1, 4),
                  cur_len=n, seed=3) for n in DECODE_LENS]
    runs += [dict(name=name, kind="serve", mesh=mesh, mode=mode, cfg=cfg,
                  params=tree, weights=str(mesh), prompts=_prompts(b),
                  gen=GEN) for name, (mesh, mode, b) in SERVE.items()]
    runs += [dict(name="control", kind="serve", mesh=(2, 2), mode="gspmd",
                  cfg=cfg, params=tree, weights=str((2, 2)),
                  prompts=_prompts(B), gen=1, swap="wo")]
    return tmesh.spawn_ranks(ttesting.run_lm_on_mesh, WORLD, runs, "cpu",
                             timeout=SPAWN_TIMEOUT, device="cpu")


def _rng_arrays(seed, *shapes, scale=None):
    """The arrays a case drew on the ranks (the same numpy stream)."""
    rng = np.random.default_rng(seed)
    scale = scale or [1.0] * len(shapes)
    return [(rng.normal(size=s) * c).astype(np.float32)
            for s, c in zip(shapes, scale)]


# --------------------------------------------------------------------- #
# ring matmuls                                                          #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("case", ["ring_fp32", "ring_bf16"])
def test_ring_ag_matmul_is_its_reference_bitwise(ranks, case):
    """Each rank's ``all_gather(X) @ W_local`` by the ring equals the
    gather-then-matmul reference bitwise (fp32, and bf16 carried as its
    bytes), and the columns tile ``X @ W``."""
    x, w = _rng_arrays(0 if case == "ring_fp32" else 1, (64, 32), (32, 48))
    if case == "ring_bf16":
        x, w = (torch.from_numpy(a).bfloat16().float().numpy()
                for a in (x, w))
    got = np.concatenate([r[f"{case}.ag"] for r in ranks], axis=1)
    for r in ranks:
        assert np.array_equal(r[f"{case}.ag"], r[f"{case}.ag_ref"])
    tol = 1e-5 if case == "ring_fp32" else 2e-2
    np.testing.assert_allclose(got, x @ w, rtol=tol, atol=tol)


def test_ring_rs_matmul_within_the_reference_bound(ranks):
    """The reduce-scatter ring against ``reduce_scatter(X @ W)`` within
    ``1e-4``, its row blocks tiling ``X @ W``."""
    x, w = _rng_arrays(0, (64, 32), (32, 48))
    for r in ranks:
        np.testing.assert_allclose(r["ring_fp32.rs"], r["ring_fp32.rs_ref"],
                                   rtol=1e-4, atol=1e-4)
    got = np.concatenate([r["ring_fp32.rs"] for r in ranks])
    np.testing.assert_allclose(got, x @ w, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------- #
# tensor-parallel primitives                                            #
# --------------------------------------------------------------------- #

def _primitive_want(prim, b):
    """The unsharded result of primitive ``prim`` on the tp case's
    inputs, and how its blocks lie: (result, dp shards its rows?, tp
    shards its columns?)."""
    rng = np.random.default_rng(2)
    d, f, V, S = 8, 12, 16, 3
    x, xf, w_col, w_row, b_col, b_row, table = (
        (rng.normal(size=s)).astype(np.float32) for s in
        ((b, S, d), (b, S, f), (d, f), (f, d), (f,), (d,), (V, d)))
    tokens = rng.integers(0, V, (b, S))
    rows = b % 2 == 0
    if prim in ("col", "col_2dtp"):
        return x @ w_col + b_col, rows, True
    if prim.startswith("row"):
        return xf @ w_row + b_row, rows, False
    return table[tokens], rows, False


def _assemble(ranks, key, rows, cols):
    """The whole result from the (2, 2) ranks' blocks (rank (i, j) is
    global rank 2 i + j)."""
    blocks = [[ranks[2 * i + j][key] for j in range(2)] for i in range(2)]
    row_parts = [np.concatenate(bl, axis=-1) if cols else bl[0]
                 for bl in blocks]
    for i in range(2):
        for j in range(2):
            if not cols:
                assert np.array_equal(blocks[i][j], blocks[i][0])
    if rows:
        return np.concatenate(row_parts, axis=0)
    assert np.array_equal(row_parts[0], row_parts[1])
    return row_parts[0]


@pytest.mark.parametrize("b", [4, 3])
@pytest.mark.parametrize("prim", PRIMITIVES)
def test_tp_primitive_matches_the_unsharded_product(ranks, prim, b):
    """Each primitive on its shards, assembled, against the product on
    whole tensors: the batch sharded over dp (B=4) or replicated (B=3)."""
    want, rows, cols = _primitive_want(prim, b)
    got = _assemble(ranks, f"tp_b{b}.{prim}", rows, cols)
    np.testing.assert_allclose(got, want, **SHARDED_TOL)


# --------------------------------------------------------------------- #
# sequence-sharded decode attention                                     #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("cur_len", DECODE_LENS)
def test_decode_attention_lse_combination_is_exact(ranks, cur_len):
    """Four slices of the cache, their (m, l, o) combined by max and sum,
    against one device's ``decode_attention``, the port's and the
    reference's, within ``2e-5`` (at ``cur_len=10`` three slices hold no
    valid position)."""
    q, kc, vc = _rng_arrays(3, (2, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16),
                            scale=[0.5, 0.5, 1.0])
    outs = [r[f"dec_{cur_len}.out"] for r in ranks]
    for o in outs[1:]:
        assert np.array_equal(o, outs[0])
    port = tattn.decode_attention(*(torch.from_numpy(a) for a in
                                    (q, kc, vc)), cur_len).numpy()
    ref = np.asarray(rattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                            jnp.asarray(vc), cur_len))
    np.testing.assert_allclose(outs[0], port, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(outs[0], ref, rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------- #
# sharded serving                                                       #
# --------------------------------------------------------------------- #

def _port_unsharded(tree, mode, batch, gen=GEN):
    cfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                              tp_collectives=mode)
    model = lm_params_from_reference(tree, cfg, device="cpu")
    with torch.inference_mode():
        toks, t = tserve.generate(model, cfg, torch.from_numpy(
            _prompts(batch)), gen, keep_logits=True)
    return toks.numpy(), np.stack([x.numpy() for x in t["logits"]])


def _reference(tree, batch):
    """The JAX reference's prefill and greedy decode steps, unsharded:
    (tokens (B, GEN), logits (GEN, B, V))."""
    cfg = _cfg()
    prefill = jax.jit(rserve.make_prefill(cfg, None, impl="pallas"))
    decode = jax.jit(rserve.make_decode_step(cfg, None))
    params = jax.tree.map(jnp.asarray, tree)
    logits, pre = prefill(params, {"inputs": jnp.asarray(_prompts(batch),
                                                         jnp.int32)})
    cache = rserve._merge_prefill_cache(RT.init_cache(cfg, batch, P + GEN),
                                        pre, cfg, P)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    toks, all_logits = [tok], [logits]
    for i in range(GEN - 1):
        logits, cache = decode(params, {"inputs": tok[:, None]}, cache,
                               jnp.int32(P + i))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(tok)
        all_logits.append(logits)
    return (np.stack([np.asarray(t) for t in toks], 1),
            np.stack([np.asarray(x) for x in all_logits]))


def _sharded(ranks, name):
    """A serving case's tokens (every rank's must be equal) and logits
    (steps, B, V) from the ranks' rows."""
    mesh, _, batch = SERVE.get(name, ((2, 2), None, B))
    toks = [r[f"{name}.tokens"] for r in ranks]
    for t in toks[1:]:
        assert np.array_equal(t, toks[0])
    n_data = mesh[0]
    if batch % n_data:
        logits = ranks[0][f"{name}.logits"]
        for r in ranks[1:]:
            assert np.array_equal(r[f"{name}.logits"], logits)
    else:
        logits = np.concatenate([ranks[i * mesh[1]][f"{name}.logits"]
                                 for i in range(n_data)], axis=1)
    return toks[0].astype(np.int64), logits


@pytest.mark.parametrize("case", sorted(SERVE))
def test_sharded_serving_matches_the_port_unsharded(ranks, tree, case):
    """Prefill and 4 greedy decode steps on the mesh: every step's logits
    within ``1e-5`` of the port's unsharded run on the same weights, the
    same tokens on every rank and as unsharded."""
    _, mode, batch = SERVE[case]
    want_toks, want = _port_unsharded(tree, mode, batch)
    toks, got = _sharded(ranks, case)
    assert got.shape == (GEN, batch, _cfg().vocab_size)
    np.testing.assert_allclose(got, want, **SHARDED_TOL)
    assert np.array_equal(toks, want_toks)


@pytest.mark.parametrize("case", sorted(SERVE))
def test_sharded_serving_matches_the_reference(ranks, tree, case):
    """The same against the JAX reference's unsharded ``prefill`` and
    ``decode_step`` (the Pallas kernel in interpret mode), within
    ``2e-4``, the same greedy tokens."""
    _, _, batch = SERVE[case]
    want_toks, want = _reference(tree, batch)
    toks, got = _sharded(ranks, case)
    np.testing.assert_allclose(got, want, **REF_TOL)
    assert np.array_equal(toks, want_toks)


def test_manual_collectives_match_gspmd(ranks):
    """``tp_collectives="manual"`` (activation-dtype sums, the 2-D decode
    forms) against ``"gspmd"`` (fp32 sums, weights gathered over dp) on
    the same mesh and weights."""
    toks_g, got_g = _sharded(ranks, "gspmd_2x2")
    toks_m, got_m = _sharded(ranks, "manual_2x2")
    np.testing.assert_allclose(got_m, got_g, **MODE_TOL)
    assert np.array_equal(toks_m, toks_g)


def test_a_rank_with_a_wrong_block_is_rejected(ranks, tree):
    """The control: layer 0's wo blocks of the two model ranks swapped;
    the prefill's logits leave the sharded-vs-unsharded bound."""
    _, want = _port_unsharded(tree, "gspmd", B, gen=1)
    _, got = _sharded(ranks, "control")
    assert not np.allclose(got, want, **SHARDED_TOL)
    assert float(np.abs(got - want).max()) > 1e-2


def test_every_rank_holds_its_blocks_and_runs_the_flash_wrapper(ranks,
                                                                tree):
    """Each rank's weights are its blocks of the reference's tree (their
    fingerprint against the blocks cut here), each prefill ran attention
    through the flash kernel's wrapper (on CPU tensors its plain version,
    once a layer), and the collectives moved bytes."""
    cfg = tconfigs.get_smoke_config(ARCH)
    full = lm_params_from_reference(tree, cfg, device="cpu")
    for rank, r in enumerate(ranks):
        coords = tuple(int(c) for c in np.unravel_index(rank, (2, 2)))
        mesh = tmesh.LmMesh(("data", "model"), (2, 2), coords,
                            torch.device("cpu"), "gloo")
        part = shard_lm_params(full, cfg, tsharding.make_ctx(mesh))
        assert r["gspmd_2x2.fingerprint"] == ttesting.param_fingerprint(part)
        assert r["transport"] == "gloo, (data,model)=1x4 on the CPU"
        for name in SERVE:
            assert r[f"{name}.plain_calls"] == cfg.n_layers
            assert r[f"{name}.flash_launches"] == 0
            assert r[f"{name}.calls"] > 0 and r[f"{name}.bytes_in"] > 0


@pytest.mark.parametrize("bad", ["2", "2x", "0x2", "axb"])
def test_serve_cli_refuses_a_malformed_mesh(bad, capsys):
    """``--mesh`` takes ``DxM`` with sizes of at least 1."""
    with pytest.raises(SystemExit) as e:
        tserve.main(["--smoke", "--device", "cpu", "--mesh", bad])
    assert e.value.code == 2
    assert "--mesh" in capsys.readouterr().err
