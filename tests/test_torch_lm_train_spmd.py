"""Sharded LM training in the port, on a (data, model) mesh of 4 gloo CPU
ranks, against the port's unsharded run and the JAX reference's.

One ``spawn_ranks`` of 4 ranks, module-scoped and with a hard timeout,
computes every case (``repro_torch.testing.run_lm_on_mesh``): the
backward of each tensor-parallel primitive and of the
vocabulary-parallel cross-entropy, and one training step of the smoke
Qwen2.5 on (2, 2) under ``"gspmd"`` and ``"manual"``, on (4, 1), with a
replicated batch (B=3), with ``remat=True`` and with ``grad_accum=2``,
and of the smoke Qwen2-VL (embeddings in, mrope positions) on (2, 2);
then two steps on (2, 2), the second through
``launch.train.make_train_step(cfg, ctx, ...)``.  A first step is the
two calls that step makes (``testing.split_train_step``).  Each rank
returns its blocks of that step's gradients, each spec kind's part of
their global norm (``testing.kind_norms``), its blocks of the state
after the last step, the metrics and the counters; the pytest
process never initialises a process group and assembles the blocks
(``testing.assemble_rows``).  The JAX side runs here on one CPU device,
unsharded, on the same weights (the reference's ``init_params``,
carried across by ``repro_torch.convert``).

Bounds, fp32 throughout.  A primitive's gradients against autograd of
the unsharded op, and a sharded model's loss and gradients against the
port's unsharded run: ``1e-5`` abs and rel (the same fp32 products,
partial sums added in another order).  Against the JAX reference's
``jax.value_and_grad(loss_and_metrics)``: ``2e-4``, the bound
``tests/test_torch_lm.py`` and ``tests/test_torch_train.py`` hold the
unsharded port to.  One whole step against the reference's jitted
single-device ``make_train_step``: ``tests/test_distributed.py:249``'s
bounds (loss ``1e-3``; parameters ``rtol=5e-3, atol=5e-4``), at
``lr=1e-3`` without warm-up (the reference test's default schedule
gives its first step a learning rate of 0) and AdamW's ``eps=1e-4``
(``OPT``).  ``"manual"`` against
``"gspmd"``: ``test_distributed.py:310``'s (loss ``1e-4``; parameters
``rtol=5e-3, atol=1e-3``).  The global gradient norm against the
unsharded one: ``1e-5`` relative, and so is the square of each spec
kind's part, the ranks' ``sharding.global_norm`` of that kind's blocks
(each block's sum of squares divided by its number of copies).  Two
controls must fall outside these bounds: the unsharded
gradient of one data row's half of the batch (what a missing sum over
dp gives, up to scale) and a norm that counts the tp-replicated tensors
once for each model rank.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.launch import train as rtrain
from repro.models import transformer as RT
from repro.optim.adamw import AdamWConfig as RAdamWConfig

from repro_torch import configs as tconfigs
from repro_torch import testing as ttesting
from repro_torch.convert import _lm_flat_from_reference, lm_params_from_reference
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tlayers
from repro_torch.optim import adamw as TA

#: seconds the spawn may take before every rank is killed
SPAWN_TIMEOUT = 300
WORLD = 4
B, S = 4, 16
SHARDED_TOL = dict(rtol=1e-5, atol=1e-5)
REF_TOL = dict(rtol=2e-4, atol=2e-4)
STEP_TOL = dict(rtol=5e-3, atol=5e-4)
MODE_TOL = dict(rtol=5e-3, atol=1e-3)
NORM_REL = 1e-5
#: Adam's step is scale-free: an element whose gradient is at the level of
#: the rounding noise takes an lr-sized step of either sign (as in
#: ``tests/test_torch_train.py``); eps far above that noise and far below
#: the other gradients keeps the state comparisons on the arithmetic
OPT = dict(lr=1e-3, eps=1e-4)
#: training cases: (arch, mesh, tp_collectives, batch, remat, grad_accum)
TRAIN = {"gspmd_2x2": ("qwen2_5_32b", (2, 2), "gspmd", B, False, 1),
         "manual_2x2": ("qwen2_5_32b", (2, 2), "manual", B, False, 1),
         "gspmd_4x1": ("qwen2_5_32b", (4, 1), "gspmd", B, False, 1),
         "gspmd_2x2_b3": ("qwen2_5_32b", (2, 2), "gspmd", 3, False, 1),
         "remat_2x2": ("qwen2_5_32b", (2, 2), "gspmd", B, True, 1),
         "accum_2x2": ("qwen2_5_32b", (2, 2), "gspmd", B, False, 2),
         "vl_2x2": ("qwen2_vl_72b", (2, 2), "gspmd", B, False, 1)}
#: two steps on (2, 2) under "gspmd", the second through make_train_step
STEPS2 = ("qwen2_5_32b", (2, 2), 2)
PRIMITIVES = ["col", "row_manual", "row_gspmd", "embed", "xent"]
#: the tp_grad case's sequence length (``testing._tp_grad_case``)
S_TP = 3


def _rcfg(arch, remat=False):
    return dataclasses.replace(rconfigs.get_smoke_config(arch), remat=remat)


def _tcfg(arch, mode="gspmd", remat=False):
    return dataclasses.replace(tconfigs.get_smoke_config(arch),
                               tp_collectives=mode, remat=remat)


def _batch(arch, b, seed=0):
    cfg = _rcfg(arch)
    rng = np.random.default_rng(seed)
    if cfg.embed_input:
        inputs = rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32)
    else:
        inputs = rng.normal(size=(b, S, cfg.d_model)).astype(np.float32)
    out = {"inputs": inputs,
           "labels": rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32)}
    out["labels"][0, :3] = -100
    if cfg.rope_kind == "mrope":
        out["positions"] = rng.integers(0, S, (b, S, 3)).astype(np.int32)
    return out


_TREES = {}


def _tree(arch):
    """The reference's parameters of the smoke ``arch``, as numpy."""
    if arch not in _TREES:
        _TREES[arch] = jax.tree.map(np.asarray, RT.init_params(
            jax.random.key(1), _rcfg(arch)))
    return _TREES[arch]


@pytest.fixture(scope="module")
def ranks():
    """Every case, computed in one spawn of 4 gloo CPU ranks."""
    runs = [dict(name=f"tp_b{b}", kind="tp_grad", mesh=(2, 2), B=b, seed=4)
            for b in (4, 3)]
    for name, (arch, mesh, mode, b, remat, ga) in TRAIN.items():
        runs.append(dict(name=name, kind="train", mesh=mesh, mode=mode,
                         cfg=tconfigs.get_smoke_config(arch),
                         cfg_kw=dict(remat=remat), params=_tree(arch),
                         batches=[_batch(arch, b)], opt=OPT, warmup=0,
                         total_steps=10, grad_accum=ga))
    arch, mesh, n = STEPS2
    runs.append(dict(name="steps2", kind="train", mesh=mesh, mode="gspmd",
                     cfg=tconfigs.get_smoke_config(arch), params=_tree(arch),
                     batches=[_batch(arch, B, seed=i) for i in range(n)],
                     opt=OPT, warmup=0, total_steps=10))
    return tmesh.spawn_ranks(ttesting.run_lm_on_mesh, WORLD, runs, "cpu",
                             timeout=SPAWN_TIMEOUT, device="cpu")


def _layout_ctx(mesh):
    return tsharding.make_ctx(tmesh.LmMesh(("data", "model"), mesh, (0, 0),
                                           torch.device("cpu"), "gloo"))


def _assembled(ranks, run, what, shapes, mesh):
    """``{name: (whole tensor, replicated copies equal)}`` of a train
    run's ``what`` (``grad``, ``params``, ...) from the ranks' blocks."""
    ctx = _layout_ctx(mesh)
    coords = [r[f"{run}.coords"] for r in ranks]
    out = {}
    for k, shape in shapes.items():
        spec = tsharding.spec_for(k, len(shape), ctx)
        out[k] = ttesting.assemble_rows([r[f"{run}.{what}.{k}"]
                                         for r in ranks], coords, shape,
                                        spec, ("data", "model"), mesh)
    return out


_ORACLES = {}


def _oracle(run):
    """The port's unsharded run of a case: ``(model, gradients (numpy),
    loss, grad_norm)``."""
    if run not in _ORACLES:
        arch, _, mode, b, remat, ga = TRAIN[run]
        cfg = _tcfg(arch, mode, remat)
        model = lm_params_from_reference(_tree(arch), cfg, device="cpu")
        grads, m = ttrain.grads_and_metrics(
            model, cfg, ttrain.to_device(_batch(arch, b), "cpu"),
            impl="pallas", grad_accum=ga)
        _ORACLES[run] = (model, {k: g.numpy() for k, g in grads.items()},
                         float(m["loss"]), float(TA.global_norm(
                             grads.values())))
    return _ORACLES[run]


_REFS = {}


def _reference(run):
    """The JAX reference's ``value_and_grad`` of ``loss_and_metrics`` on
    one device: ``(loss, {port name: gradient})``; with ``grad_accum``
    microbatches, their mean (the reference step's arithmetic: a
    microbatch's mean counts its own valid labels)."""
    arch, _, _, b, remat, ga = TRAIN[run]
    key = (arch, b, remat, ga)
    if key not in _REFS:
        cfg = _rcfg(arch, remat)
        params = jax.tree.map(jnp.asarray, _tree(arch))
        fn = jax.value_and_grad(
            lambda p, mb: RT.loss_and_metrics(p, cfg, mb, impl="xla"),
            has_aux=True)
        n = b // ga
        loss, grads = 0.0, None
        for i in range(ga):
            mb = {k: jnp.asarray(v[i * n:(i + 1) * n])
                  for k, v in _batch(arch, b).items()}
            (li, _), gi = fn(params, mb)
            loss += float(li) / ga
            gi = _lm_flat_from_reference(jax.tree.map(np.asarray, gi), cfg)
            grads = {k: g / ga + (0 if grads is None else grads[k])
                     for k, g in gi.items()}
        _REFS[key] = (loss, grads)
    return _REFS[key]


def _shapes(run):
    return {k: v.shape for k, v in _oracle(run)[1].items()}


# --------------------------------------------------------------------- #
# the primitives' backward                                              #
# --------------------------------------------------------------------- #

def _primitive_grads(prim, b):
    """Autograd of the unsharded op on the tp_grad case's inputs:
    ``{what: (gradient, dp shards its rows?, tp shards dim -1?)}``."""
    rng = np.random.default_rng(4)
    d, f, V = 8, 12, 16
    draw = [(b, S_TP, d), (b, S_TP, f), (d, f), (f, d), (f,), (d,), (V, d),
            (b, S_TP, V), (b, S_TP, f), (b, S_TP, d), (b, S_TP, d)]
    vals = [(rng.normal(size=s) * (3.0 if i == 7 else 1.0)).astype(
        np.float32) for i, s in enumerate(draw)]
    tokens = rng.integers(0, V, (b, S_TP))
    labels = rng.integers(0, V, (b, S_TP))
    labels[0, :2] = -100
    (x, xf, w_col, w_row, b_col, b_row, table, logits, ct_col, ct_row,
     ct_emb) = (torch.from_numpy(a).requires_grad_(True) for a in vals)
    rows = b % 2 == 0
    if prim == "col":
        (x @ w_col + b_col).backward(ct_col)
        return {"x": (x.grad, rows, False), "w": (w_col.grad, False, True),
                "b": (b_col.grad, False, True)}
    if prim.startswith("row"):
        (xf @ w_row + b_row).backward(ct_row)
        return {"x": (xf.grad, rows, True), "w": (w_row.grad, False, False),
                "b": (b_row.grad, False, False)}
    if prim == "embed":
        tlayers.embed(type("P", (), {"table": table})(),
                      torch.from_numpy(tokens)).backward(ct_emb)
        return {"table": (table.grad, False, False)}
    loss = tlayers.cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    return {"logits": (logits.grad, rows, True),
            "value": (loss.detach(), False, False)}



def _blocks_of(ranks, key, rows, cols, b):
    """The whole gradient from the (2, 2) ranks' blocks (rank (i, j) is
    global rank 2 i + j): rows over dp where the batch is sharded, else
    the dp ranks' parts summed; dim -1 over tp where ``cols``, else the
    model ranks' copies, which must be equal."""
    parts = []
    for i in range(2):
        bl = [ranks[2 * i + j][key] for j in range(2)]
        if cols:
            parts.append(np.concatenate(bl, axis=-1))
        else:
            assert np.array_equal(bl[0], bl[1]), key
            parts.append(bl[0])
    if rows:
        return np.concatenate(parts, axis=0)
    if b % 2 == 0:
        assert np.array_equal(parts[0], parts[1]), key
        return parts[0]
    return parts[0] + parts[1]


@pytest.mark.parametrize("b", [4, 3])
@pytest.mark.parametrize("prim", PRIMITIVES)
def test_tp_primitive_gradients_match_autograd_unsharded(ranks, prim, b):
    """Each primitive's gradients, assembled from the ranks' blocks (a
    replicated batch's dp parts summed, as the loss's shares are),
    against autograd of the op on whole tensors.  The weight gradients of
    the FSDP gathers arrive reduce-scattered: a (dp, tp) or (tp, dp)
    block whose rows or columns lie over dp."""
    want = _primitive_grads(prim, b)
    for what, (w, rows, cols) in want.items():
        key = f"tp_b{b}.{prim}.{what}"
        w = w.numpy()
        if what == "w":
            got = np.block([[ranks[2 * i + j][key] for j in range(2)]
                            for i in range(2)]) if prim == "col" else \
                np.block([[ranks[2 * i + j][key] for i in range(2)]
                          for j in range(2)])
        elif what == "table":
            got = np.block([[ranks[2 * i + j][key] for i in range(2)]
                            for j in range(2)])
        elif what == "value":
            vals = [r[key] for r in ranks]
            assert all(np.array_equal(v, vals[0]) for v in vals)
            got = vals[0]
            shares = [float(ranks[2 * i][f"tp_b{b}.xent.share"])
                      for i in range(2)]
            np.testing.assert_allclose(sum(shares), float(w), **SHARDED_TOL)
        elif what == "b":
            # a bias has no dp axis: its gradient is summed over dp
            got = _blocks_of(ranks, key, False, cols, 3)
        else:
            got = _blocks_of(ranks, key, rows, cols, b)
        np.testing.assert_allclose(got, w, err_msg=key, **SHARDED_TOL)


# --------------------------------------------------------------------- #
# sharded training                                                      #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("run", list(TRAIN))
def test_sharded_loss_and_grads_match_unsharded_port(ranks, run):
    """The step's loss and every gradient, assembled from the blocks,
    against the port's unsharded ``grads_and_metrics`` (``1e-5``); the
    copies of a replicated block (a tp-replicated tensor on the model
    ranks, a (tp,) one on the dp ranks) bitwise equal."""
    _, grads, loss, _ = _oracle(run)
    mesh = TRAIN[run][1]
    got = _assembled(ranks, run, "grad", _shapes(run), mesh)
    assert set(got) == set(grads)
    for k, (g, equal) in got.items():
        assert equal, f"{k}: the ranks' copies differ"
        np.testing.assert_allclose(g, grads[k], err_msg=k, **SHARDED_TOL)
    np.testing.assert_allclose(ranks[0][f"{run}.metrics"][0]["loss"], loss,
                               **SHARDED_TOL)


@pytest.mark.parametrize("run", list(TRAIN))
def test_sharded_loss_and_grads_match_reference(ranks, run):
    """The same against the JAX reference's ``value_and_grad`` of
    ``loss_and_metrics`` on one device (``2e-4``)."""
    loss, grads = _reference(run)
    got = _assembled(ranks, run, "grad", _shapes(run), TRAIN[run][1])
    assert set(got) == set(grads)
    for k, (g, _) in got.items():
        np.testing.assert_allclose(g, np.asarray(grads[k], np.float32),
                                   err_msg=k, **REF_TOL)
    np.testing.assert_allclose(ranks[0][f"{run}.metrics"][0]["loss"], loss,
                               **REF_TOL)


_STEPS = {}


@pytest.mark.parametrize("run", list(TRAIN))
def test_sharded_step_matches_reference_step(ranks, run):
    """One whole step against the reference's jitted single-device
    ``make_train_step`` from the same state: the loss within ``1e-3``,
    the parameters within ``rtol=5e-3, atol=5e-4``, the step 1."""
    arch, mesh, _, b, remat, ga = TRAIN[run]
    cfg = _rcfg(arch, remat)
    key = (arch, b, remat, ga)
    if key not in _STEPS:
        opt = RAdamWConfig(**OPT)
        step = jax.jit(rtrain.make_train_step(cfg, None, opt, warmup=0,
                                              total_steps=10,
                                              grad_accum=ga))
        state = rtrain.init_state(jax.random.key(1), cfg, opt)
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in _batch(arch, b).items()})
        _STEPS[key] = (float(m["loss"]), _lm_flat_from_reference(
            jax.tree.map(np.asarray, state["params"]), cfg))
    loss, params = _STEPS[key]
    assert abs(ranks[0][f"{run}.metrics"][0]["loss"] - loss) < 1e-3
    got = _assembled(ranks, run, "params", _shapes(run), mesh)
    for k, (p, equal) in got.items():
        assert equal, k
        np.testing.assert_allclose(p, np.asarray(params[k], np.float32),
                                   err_msg=k, **STEP_TOL)
    assert all(r[f"{run}.step"] == 1 for r in ranks)


def test_manual_matches_gspmd(ranks):
    """``"manual"`` against ``"gspmd"`` on (2, 2): the loss within
    ``1e-4`` and the parameters after the step within ``rtol=5e-3,
    atol=1e-3`` (``test_distributed.py:310``)."""
    lm = ranks[0]["manual_2x2.metrics"][0]["loss"]
    lg = ranks[0]["gspmd_2x2.metrics"][0]["loss"]
    assert abs(lm - lg) < 1e-4
    shapes = _shapes("gspmd_2x2")
    pm = _assembled(ranks, "manual_2x2", "params", shapes, (2, 2))
    pg = _assembled(ranks, "gspmd_2x2", "params", shapes, (2, 2))
    for k in shapes:
        np.testing.assert_allclose(pm[k][0], pg[k][0], err_msg=k, **MODE_TOL)


@pytest.mark.parametrize("run", list(TRAIN))
def test_state_blocks_and_metrics_on_every_rank(ranks, run):
    """Every rank's params, m, v and master are the blocks
    ``launch.specs.train_state_struct`` names (shape and dtype), its
    metrics are the same on every rank, and the state after the step is
    the port's unsharded step's, block by block (``1e-5``; AdamW's m, v
    and master of the blocks)."""
    arch, mesh, mode, b, remat, ga = TRAIN[run]
    for r in ranks:
        assert r[f"{run}.struct_mismatches"] == []
        assert r[f"{run}.metrics"] == ranks[0][f"{run}.metrics"]
    cfg = _tcfg(arch, mode, remat)
    opt = TA.AdamWConfig(**OPT)
    model = lm_params_from_reference(_tree(arch), cfg, device="cpu")
    state = {"params": model, "opt": TA.adamw_init(model, opt)}
    step = ttrain.make_train_step(cfg, None, opt, impl="pallas", warmup=0,
                                  total_steps=10, grad_accum=ga)
    state, m = step(state, _batch(arch, b))
    for key in ("loss", "xent", "aux_loss", "dropped", "grad_norm", "lr"):
        np.testing.assert_allclose(ranks[0][f"{run}.metrics"][0][key],
                                   float(m[key]), err_msg=key,
                                   **SHARDED_TOL)
    want = {"params": {k: p.detach().numpy()
                       for k, p in model.named_parameters()},
            **{o: {k: t.numpy() for k, t in state["opt"][o].items()}
               for o in ("m", "v", "master")}}
    for part, tensors in want.items():
        got = _assembled(ranks, run, part, _shapes(run), mesh)
        for k, w in tensors.items():
            np.testing.assert_allclose(got[k][0], w, err_msg=f"{part}/{k}",
                                       **SHARDED_TOL)


def _norm_parts(ranks, run, replicated_times=1):
    """Each spec kind's part of the squared gradient norm, as the ranks'
    ``sharding.global_norm`` of that kind's blocks gives it
    (``testing.kind_norms``, the same on every rank), the tp-replicated
    kinds' counted ``replicated_times`` over."""
    ctx = _layout_ctx(TRAIN[run][1])
    norms = ranks[0][f"{run}.kind_norms"]
    assert all(r[f"{run}.kind_norms"] == norms for r in ranks)
    spec_of = {str(spec): spec for spec in (
        tsharding.spec_for(k, len(shape), ctx)
        for k, shape in _shapes(run).items())}
    return {kind: v * v * (1 if ctx.tp in spec_of[kind] else
                           replicated_times)
            for kind, v in norms.items()}


def _oracle_parts(run):
    ctx = _layout_ctx(TRAIN[run][1])
    parts = {}
    for k, g in _oracle(run)[1].items():
        kind = str(tsharding.spec_for(k, g.ndim, ctx))
        parts[kind] = parts.get(kind, 0.0) + float(
            np.sum(np.square(g.astype(np.float64))))
    return parts


@pytest.mark.parametrize("run", list(TRAIN))
def test_global_norm_counts_each_block_once(ranks, run):
    """The ranks' ``grad_norm`` (``sharding.global_norm``) against the
    unsharded norm, and each spec kind's part of its square against the
    unsharded tensors' (``1e-5`` relative)."""
    want_parts = _oracle_parts(run)
    got_parts = _norm_parts(ranks, run)
    assert set(got_parts) == set(want_parts)
    for kind in want_parts:
        np.testing.assert_allclose(got_parts[kind], want_parts[kind],
                                   rtol=NORM_REL, err_msg=kind)
    np.testing.assert_allclose(ranks[0][f"{run}.metrics"][0]["grad_norm"],
                               _oracle(run)[3], rtol=NORM_REL)


@pytest.mark.parametrize("run", ["gspmd_2x2", "gspmd_2x2_b3"])
def test_controls_are_rejected(ranks, run):
    """Two controls fall outside the bounds: the unsharded gradient of
    data row 0's half of the batch (a missing sum over dp), and a norm
    that counts every tp-replicated tensor once for each model rank."""
    arch, mesh, mode, b, remat, ga = TRAIN[run]
    cfg = _tcfg(arch, mode, remat)
    model = _oracle(run)[0]
    half = {k: v[:2] for k, v in _batch(arch, b).items()}
    bad, _ = ttrain.grads_and_metrics(model, cfg,
                                      ttrain.to_device(half, "cpu"),
                                      impl="pallas")
    got = _assembled(ranks, run, "grad", _shapes(run), mesh)
    far = [k for k in got if not np.allclose(
        got[k][0], bad[k].numpy(), **SHARDED_TOL)]
    assert len(far) == len(got)
    twice = _norm_parts(ranks, run, replicated_times=2)
    want = _oracle_parts(run)
    assert any(not np.isclose(twice[k], want[k], rtol=NORM_REL)
               for k in want)


@pytest.mark.parametrize("run", list(TRAIN))
def test_flash_calls_and_collectives(ranks, run):
    """On the CPU the step runs the flash kernel's plain version once a
    layer (twice under remat) and a microbatch, and launches nothing;
    every rank makes the same collective calls."""
    arch, _, _, _, remat, ga = TRAIN[run]
    n = _rcfg(arch).n_layers * (2 if remat else 1) * ga
    for r in ranks:
        assert r[f"{run}.flash_launches"] == 0
        assert r[f"{run}.plain_calls"] == n
        assert r[f"{run}.calls"] == ranks[0][f"{run}.calls"] > 0


def test_later_steps_run_make_train_step_on_the_mesh(ranks):
    """Two steps on (2, 2), the second through ``make_train_step(cfg,
    ctx, ...)``: both steps' metrics, and every rank's params, m, v and
    master after them, against two steps of the port's unsharded
    ``make_train_step`` from the same state (``1e-5``)."""
    arch, mesh, n = STEPS2
    cfg = _tcfg(arch)
    opt = TA.AdamWConfig(**OPT)
    model = lm_params_from_reference(_tree(arch), cfg, device="cpu")
    state = {"params": model, "opt": TA.adamw_init(model, opt)}
    step = ttrain.make_train_step(cfg, None, opt, impl="pallas", warmup=0,
                                  total_steps=10)
    for i in range(n):
        state, m = step(state, _batch(arch, B, seed=i))
        for r in ranks:
            got = r["steps2.metrics"][i]
            for key in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(got[key], float(m[key]),
                                           err_msg=f"step {i + 1} {key}",
                                           **SHARDED_TOL)
    assert all(r["steps2.step"] == n for r in ranks)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    want = {"params": {k: p.detach().numpy()
                       for k, p in model.named_parameters()},
            **{o: {k: t.numpy() for k, t in state["opt"][o].items()}
               for o in ("m", "v", "master")}}
    for part, tensors in want.items():
        got = _assembled(ranks, "steps2", part, shapes, mesh)
        for k, w in tensors.items():
            assert got[k][1], f"{part}/{k}: the ranks' copies differ"
            np.testing.assert_allclose(got[k][0], w, err_msg=f"{part}/{k}",
                                       **SHARDED_TOL)
