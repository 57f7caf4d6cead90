"""Sharded training of the MoE, SSM and hybrid LMs in the port, on a
(data, model) mesh of 4 gloo CPU ranks, against the port's unsharded run
on each data row's rows and the JAX reference's.

One ``spawn_ranks`` of 4 ranks, module-scoped and with a hard timeout,
computes every case (``repro_torch.testing.run_lm_on_mesh``): one
training step of the smoke Qwen3-MoE, Kimi-K2 (dense prologue, shared
expert), Falcon-Mamba and Jamba (attention and Mamba, dense and MoE
FFNs) on (2, 2) under ``"gspmd"`` and ``"manual"``, on (4, 1), with a
replicated batch (B=3) and with ``remat=True``, and of Falcon-Mamba on
(1, 4); two steps of Qwen3-MoE on (2, 2), the second through
``launch.train.make_train_step(cfg, ctx, ...)``; and, on a step's state
before the step, the gradient of the aux term alone (``aux_weight`` 1,
every label ignored) of each MoE family on (2, 2) and two controls,
each a backward of the same loss in which one kind of ``tp.copy_to_tp``
passes on the rank's own gradient instead of the model group's sum
(``testing.unsum_over_tp``): the MoE families' routers' gradients with
the combine weights' ``f`` so (``testing.combine_weights``) on (2, 2),
and Falcon-Mamba's ``x_proj`` gradients with the ``f`` after the sum of
``x_proj``'s partials so (``testing.x_proj_partials``) on (1, 4) and
(2, 2).  A first step is the two
calls that step makes (``testing.split_train_step``), so its gradients
are read between them.
The pytest process never initialises a process group and assembles the
ranks' blocks (``testing.assemble_rows``).

The oracle.  An MoE layer's capacity counts the tokens of its call, so a
dp-sharded layer routes and drops each data row's rows on their own, and
its aux loss is the mean over dp of the rows' aux losses (the
reference's ``shard_map``).  A sharded run is held against the
unsharded runs on each data row's rows, combined as the sharded loss
combines them: the cross-entropy by valid-label count (``_batch`` masks
3 labels of row 0) and the aux term by the mean over dp
(``testing.row_oracle``); a replicated batch against the whole batch.
The JAX reference is held to the same combination of its unsharded
``jax.value_and_grad(loss_and_metrics)`` on the rows (a JAX mesh run is
no oracle: its replicated-batch ``shard_map`` runs with
``check_vma=False``).  Its step: on a replicated batch the reference's
jitted ``make_train_step`` itself; on a sharded one its jitted update
(``cosine_warmup`` and ``adamw_update``, what that step runs after its
gradients) of the rows' gradients.

Bounds, fp32 throughout, those of ``tests/test_torch_lm_train_spmd.py``:
the loss and every gradient against the port's row oracle ``1e-5`` abs
and rel; against the reference ``2e-4``; one step against the
reference's: the loss ``1e-3``, the parameters ``rtol=5e-3,
atol=5e-4``; ``"manual"`` against ``"gspmd"``: the loss ``1e-4``, the
parameters ``rtol=5e-3, atol=1e-3``; ``grad_norm`` and the square of
each spec kind's part (the ranks' ``sharding.global_norm`` of that
kind's blocks) ``1e-5`` relative.  ``dropped`` is a metric: with a ctx
the mean over the model ranks of each rank's share of its own entries
(the reference's ``pmean``), so it is held to be the same on every rank,
not to the oracle.

Three traps, each a test that fails where the collectives of the
forward are left as serving placed them:
* the router's gradient on (2, 2) (the combine weights' gradient, each
  model rank's experts' share, summed over tp; the aux path's not), with
  two controls: the aux path summed over tp, and the combine weights'
  gradient not summed;
* the aux term's gradient alone on a dp-sharded (2, 2) batch (it must
  not pass through ``mesh.all_reduce``, which keeps no autograd history);
* Falcon-Mamba's ``x_proj`` and ``dt_proj`` gradients on (1, 4) and
  (2, 2), with the control of each model rank's unsummed gradient.
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
from repro.optim import adamw as radamw
from repro.optim.schedule import cosine_warmup as r_cosine_warmup

from repro_torch import configs as tconfigs
from repro_torch import testing as ttesting
from repro_torch.convert import (_lm_flat_from_reference,
                                 lm_params_from_reference)
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from repro_torch.optim import adamw as TA
from repro_torch.optim.schedule import cosine_warmup

#: seconds the spawn may take before every rank is killed
SPAWN_TIMEOUT = 600
WORLD = 4
B, S = 4, 16
SHARDED_TOL = dict(rtol=1e-5, atol=1e-5)
REF_TOL = dict(rtol=2e-4, atol=2e-4)
STEP_TOL = dict(rtol=5e-3, atol=5e-4)
MODE_TOL = dict(rtol=5e-3, atol=1e-3)
NORM_REL = 1e-5
#: AdamW as ``tests/test_torch_lm_train_spmd.py`` sets it (says why)
OPT = dict(lr=1e-3, eps=1e-4)
AUX_WEIGHT = 0.01
ARCHS = {"qwen3": "qwen3_moe_30b_a3b", "kimi": "kimi_k2_1t_a32b",
         "falcon": "falcon_mamba_7b", "jamba": "jamba_1_5_large_398b"}
MOE = ("qwen3", "kimi", "jamba")
#: each family's cases: (mesh, tp_collectives, batch, remat)
CASES = {"gspmd_2x2": ((2, 2), "gspmd", B, False),
         "manual_2x2": ((2, 2), "manual", B, False),
         "gspmd_4x1": ((4, 1), "gspmd", B, False),
         "gspmd_2x2_b3": ((2, 2), "gspmd", 3, False),
         "remat_2x2": ((2, 2), "gspmd", B, True)}
#: training runs: name -> (arch, mesh, tp_collectives, batch, remat)
TRAIN = {f"{a}.{c}": (ARCHS[a],) + case
         for a in ARCHS for c, case in CASES.items()}
TRAIN["falcon.gspmd_1x4"] = (ARCHS["falcon"], (1, 4), "gspmd", B, False)
#: the runs whose state first takes the x_proj control's gradients (the
#: MoE families' "gspmd_2x2" runs take the aux term's and the combine
#: weights' control's)
X_PROJ_RUNS = ("falcon.gspmd_1x4", "falcon.gspmd_2x2")
#: two steps of Qwen3-MoE on (2, 2) under "gspmd", the second through
#: make_train_step
STEPS2 = ("qwen3_moe_30b_a3b", (2, 2), 2)


def _rcfg(arch, remat=False):
    return dataclasses.replace(rconfigs.get_smoke_config(arch), remat=remat)


def _tcfg(arch, mode="gspmd", remat=False):
    return dataclasses.replace(tconfigs.get_smoke_config(arch),
                               tp_collectives=mode, remat=remat)


def _batch(arch, b, seed=0, labels=True):
    """A global batch of ``b`` token rows; 3 labels of row 0 ignored, or
    every label (``labels=False``: the aux term alone)."""
    cfg = _rcfg(arch)
    rng = np.random.default_rng(seed)
    out = {"inputs": rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32)}
    out["labels"][0, :3] = -100
    if not labels:
        out["labels"][:] = -100
    return out


_TREES = {}


def _tree(arch):
    """The reference's parameters of the smoke ``arch``, as numpy."""
    if arch not in _TREES:
        _TREES[arch] = jax.tree.map(np.asarray, RT.init_params(
            jax.random.key(1), _rcfg(arch)))
    return _TREES[arch]


def _extra(run):
    """The gradient passes a run takes on its state before its step: on
    (2, 2) the aux term alone of an MoE family and its routers' control,
    the x_proj control of Falcon-Mamba's X_PROJ_RUNS."""
    family, case = run.split(".")
    arch, b = TRAIN[run][0], TRAIN[run][3]
    if family in MOE and case == "gspmd_2x2":
        return {"aux": dict(batch=_batch(arch, b, labels=False),
                            aux_weight=1.0),
                "combine_unsummed": dict(batch=_batch(arch, b),
                                         only=("router",),
                                         unsum=ttesting.combine_weights)}
    if run in X_PROJ_RUNS:
        return {"x_proj_unsummed": dict(batch=_batch(arch, b),
                                        only=("x_proj",),
                                        unsum=ttesting.x_proj_partials)}
    return {}


@pytest.fixture(scope="module")
def ranks():
    """Every case, computed in one spawn of 4 gloo CPU ranks."""
    runs = []
    for name, (arch, mesh, mode, b, remat) in TRAIN.items():
        runs.append(dict(name=name, kind="train", mesh=mesh, mode=mode,
                         cfg=tconfigs.get_smoke_config(arch),
                         cfg_kw=dict(remat=remat), params=_tree(arch),
                         batches=[_batch(arch, b)], opt=OPT, warmup=0,
                         total_steps=10, extra=_extra(name)))
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
    """``{name: (whole tensor, replicated copies equal)}`` of a run's
    ``what`` (``grad``, ``params``, ...) from the ranks' blocks, Mamba's
    ``in_proj`` in its own ``[x | z]`` layout (``testing.unhalve``)."""
    ctx = _layout_ctx(mesh)
    coords = [r[f"{run}.coords"] for r in ranks]
    out = {}
    for k, shape in shapes.items():
        spec = tsharding.spec_for(k, len(shape), ctx)
        whole, equal = ttesting.assemble_rows(
            [r[f"{run}.{what}.{k}"] for r in ranks], coords, shape, spec,
            ("data", "model"), mesh)
        out[k] = (ttesting.unhalve(k, whole, mesh[1]), equal)
    return out


_MODELS = {}


def _model(arch, mode="gspmd", remat=False):
    """The port's unsharded model on the reference's parameters."""
    key = (arch, mode, remat)
    if key not in _MODELS:
        _MODELS[key] = lm_params_from_reference(
            _tree(arch), _tcfg(arch, mode, remat), device="cpu")
    return _MODELS[key]


_ORACLES = {}


def _oracle(arch, mesh, mode, b, remat, labels=True, aux_weight=AUX_WEIGHT):
    """The port's unsharded run on each data row's rows
    (``testing.row_oracle``): ``(gradients (numpy), metrics,
    grad_norm)``."""
    key = (arch, mesh[0], mode, b, remat, labels, aux_weight)
    if key not in _ORACLES:
        grads, m = ttesting.row_oracle(
            _model(arch, mode, remat), _tcfg(arch, mode, remat),
            _batch(arch, b, labels=labels), mesh[0], aux_weight=aux_weight)
        _ORACLES[key] = ({k: g.numpy() for k, g in grads.items()}, m,
                         float(TA.global_norm(grads.values())))
    return _ORACLES[key]


def _run_oracle(run):
    arch, mesh, mode, b, remat = TRAIN[run]
    return _oracle(arch, mesh, mode, b, remat)


def _rows(b, dp):
    n = dp if b % dp == 0 else 1
    return [slice(i * b // n, (i + 1) * b // n) for i in range(n)]


_REFS = {}
_ROW_FNS = {}


def _row_value_and_grad(arch, aux_weight):
    """The reference's jitted ``value_and_grad`` of one data row's part
    of the sharded loss: ``w_x * xent + w_a * aux_loss`` of
    ``loss_and_metrics`` on the row."""
    key = (arch, aux_weight)
    if key not in _ROW_FNS:
        cfg = _rcfg(arch)

        def part(p, row, w_x, w_a):
            _, m = RT.loss_and_metrics(p, cfg, row, impl="xla",
                                       aux_weight=aux_weight)
            return w_x * m["xent"] + w_a * m["aux_loss"]

        _ROW_FNS[key] = jax.jit(jax.value_and_grad(part))
    return _ROW_FNS[key]


def _reference(arch, b, dp, labels=True, aux_weight=AUX_WEIGHT):
    """The JAX reference's unsharded ``value_and_grad`` of
    ``loss_and_metrics`` on each data row's rows, combined as the sharded
    loss combines them: ``(loss, {port name: gradient}, gradient
    tree)``.  Without remat: the reference's remat recomputes the same
    values."""
    key = (arch, b, dp, labels, aux_weight)
    if key not in _REFS:
        fn = _row_value_and_grad(arch, aux_weight)
        batch = _batch(arch, b, labels=labels)
        rows = [{k: jnp.asarray(v[r]) for k, v in batch.items()}
                for r in _rows(b, dp)]
        counts = [int(np.sum(np.asarray(r["labels"]) != -100)) for r in rows]
        total = sum(counts)
        params = jax.tree.map(jnp.asarray, _tree(arch))
        loss, grads = 0.0, None
        for r, c in zip(rows, counts):
            li, gi = fn(params, r, c / total if total else 0.0,
                        aux_weight / len(rows))
            loss += float(li)
            grads = gi if grads is None else jax.tree.map(jnp.add, grads, gi)
        _REFS[key] = (loss, _lm_flat_from_reference(
            jax.tree.map(np.asarray, grads), _rcfg(arch)), grads)
    return _REFS[key]


def _shapes(arch):
    return {k: tuple(p.shape) for k, p in _model(arch).named_parameters()}


def _check_grads(got, want, tol, what):
    assert set(got) == set(want)
    for k, (g, equal) in got.items():
        assert equal, f"{what} {k}: the ranks' copies differ"
        np.testing.assert_allclose(g, np.asarray(want[k], np.float32),
                                   err_msg=f"{what} {k}", **tol)


# --------------------------------------------------------------------- #
# each step against the oracles                                         #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("run", list(TRAIN))
def test_sharded_loss_and_grads_match_row_oracle(ranks, run):
    """The step's loss, xent and aux loss and every gradient, assembled
    from the blocks, against the port's unsharded runs on each data
    row's rows (``1e-5``); the copies of a replicated block bitwise
    equal."""
    arch, mesh = TRAIN[run][:2]
    grads, m, _ = _run_oracle(run)
    got = _assembled(ranks, run, "grad", _shapes(arch), mesh)
    _check_grads(got, grads, SHARDED_TOL, run)
    for key in ("loss", "xent", "aux_loss"):
        np.testing.assert_allclose(ranks[0][f"{run}.metrics"][0][key],
                                   m[key], err_msg=key, **SHARDED_TOL)


@pytest.mark.parametrize("run", list(TRAIN))
def test_sharded_loss_and_grads_match_reference(ranks, run):
    """The same against the JAX reference's ``value_and_grad`` on each
    data row's rows (``2e-4``)."""
    arch, mesh, _, b, remat = TRAIN[run]
    loss, grads, _ = _reference(arch, b, mesh[0])
    got = _assembled(ranks, run, "grad", _shapes(arch), mesh)
    _check_grads(got, grads, REF_TOL, run)
    np.testing.assert_allclose(ranks[0][f"{run}.metrics"][0]["loss"], loss,
                               **REF_TOL)


_STEPS = {}


def _reference_step(arch, b, dp, remat):
    """One step of the reference from its ``init_state``: ``(loss,
    {port name: parameter})``.  A replicated batch (one row): its jitted
    ``make_train_step``; a sharded one: its jitted update of the rows'
    gradients (:func:`_reference`), the arithmetic that step runs after
    its gradients."""
    key = (arch, b, dp, remat)
    if key not in _STEPS:
        cfg = _rcfg(arch, remat)
        opt = radamw.AdamWConfig(**OPT)
        state = rtrain.init_state(jax.random.key(1), cfg, opt)
        if len(_rows(b, dp)) == 1:
            step = jax.jit(rtrain.make_train_step(
                cfg, None, opt, warmup=0, total_steps=10))
            state, m = step(state, {k: jnp.asarray(v)
                                    for k, v in _batch(arch, b).items()})
            loss = float(m["loss"])
        else:
            loss, _, grads = _reference(arch, b, dp)

            @jax.jit
            def update(state, grads):
                lr_scale = r_cosine_warmup(state["opt"]["step"],
                                           base_lr=1.0, warmup=0, total=10)
                params, opt_state, _ = radamw.adamw_update(
                    state["params"], grads, state["opt"], opt,
                    lr_scale=lr_scale)
                return {"params": params, "opt": opt_state}

            state = update(state, grads)
        _STEPS[key] = (loss, _lm_flat_from_reference(
            jax.tree.map(np.asarray, state["params"]), cfg))
    return _STEPS[key]


@pytest.mark.parametrize("run", list(TRAIN))
def test_sharded_step_matches_reference_step(ranks, run):
    """One whole step against the reference's from the same state: the
    loss within ``1e-3``, the parameters within ``rtol=5e-3,
    atol=5e-4``, the step 1."""
    arch, mesh, _, b, remat = TRAIN[run]
    loss, params = _reference_step(arch, b, mesh[0], remat)
    assert abs(ranks[0][f"{run}.metrics"][0]["loss"] - loss) < 1e-3
    got = _assembled(ranks, run, "params", _shapes(arch), mesh)
    for k, (p, equal) in got.items():
        assert equal, k
        np.testing.assert_allclose(p, np.asarray(params[k], np.float32),
                                   err_msg=k, **STEP_TOL)
    assert all(r[f"{run}.step"] == 1 for r in ranks)


@pytest.mark.parametrize("family", list(ARCHS))
def test_manual_matches_gspmd(ranks, family):
    """``"manual"`` against ``"gspmd"`` on (2, 2): the loss within
    ``1e-4`` and the parameters after the step within ``rtol=5e-3,
    atol=1e-3``."""
    lm = ranks[0][f"{family}.manual_2x2.metrics"][0]["loss"]
    lg = ranks[0][f"{family}.gspmd_2x2.metrics"][0]["loss"]
    assert abs(lm - lg) < 1e-4
    shapes = _shapes(ARCHS[family])
    pm = _assembled(ranks, f"{family}.manual_2x2", "params", shapes, (2, 2))
    pg = _assembled(ranks, f"{family}.gspmd_2x2", "params", shapes, (2, 2))
    for k in shapes:
        np.testing.assert_allclose(pm[k][0], pg[k][0], err_msg=k, **MODE_TOL)


def _port_steps(arch, mesh, mode, batches, remat=False):
    """Steps of the port's unsharded arithmetic from the reference's
    parameters: each step's gradients the row oracle's
    (``testing.row_oracle``), then ``optim.adamw.adamw_update`` with the
    schedule ``make_train_step`` gives it.  Returns ``(state, [metrics
    of each step])``."""
    cfg = _tcfg(arch, mode, remat)
    opt = TA.AdamWConfig(**OPT)
    model = lm_params_from_reference(_tree(arch), cfg, device="cpu")
    state = {"params": model, "opt": TA.adamw_init(model, opt)}
    out = []
    for batch in batches:
        grads, m = ttesting.row_oracle(model, cfg, batch, mesh[0])
        lr_scale = cosine_warmup(state["opt"]["step"], base_lr=1.0,
                                 warmup=0, total=10)
        _, _, om = TA.adamw_update(model, grads, state["opt"], opt,
                                   lr_scale=lr_scale)
        out.append({**m, **{k: float(v) for k, v in om.items()}})
    return state, out


def _state_want(state):
    model = state["params"]
    return {"params": {k: p.detach().numpy()
                       for k, p in model.named_parameters()},
            **{o: {k: t.numpy() for k, t in state["opt"][o].items()}
               for o in ("m", "v", "master")}}


@pytest.mark.parametrize("run", list(TRAIN))
def test_state_blocks_and_metrics_on_every_rank(ranks, run):
    """Every rank's params, m, v and master are the blocks
    ``launch.specs.train_state_struct`` names (shape and dtype), its
    metrics are the same on every rank (``dropped`` too), and the state
    after the step is the port's unsharded step on the row oracle's
    gradients, block by block (``1e-5``)."""
    arch, mesh, mode, b, remat = TRAIN[run]
    for r in ranks:
        assert r[f"{run}.struct_mismatches"] == []
        assert r[f"{run}.metrics"] == ranks[0][f"{run}.metrics"]
    state, m = _port_steps(arch, mesh, mode, [_batch(arch, b)], remat)
    for key in ("loss", "xent", "aux_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(ranks[0][f"{run}.metrics"][0][key],
                                   m[0][key], err_msg=key, **SHARDED_TOL)
    for part, tensors in _state_want(state).items():
        got = _assembled(ranks, run, part, _shapes(arch), mesh)
        for k, w in tensors.items():
            np.testing.assert_allclose(got[k][0], w, err_msg=f"{part}/{k}",
                                       **SHARDED_TOL)


def _norm_parts(ranks, run, replicated_times=1):
    """Each spec kind's part of the squared gradient norm, as the ranks'
    ``sharding.global_norm`` of that kind's blocks gives it
    (``testing.kind_norms``, the same on every rank), the tp-replicated
    kinds' counted ``replicated_times`` over."""
    arch, mesh = TRAIN[run][:2]
    ctx = _layout_ctx(mesh)
    norms = ranks[0][f"{run}.kind_norms"]
    assert all(r[f"{run}.kind_norms"] == norms for r in ranks)
    spec_of = {str(spec): spec for spec in (
        tsharding.spec_for(k, len(shape), ctx)
        for k, shape in _shapes(arch).items())}
    return {kind: v * v * (1 if ctx.tp in spec_of[kind] else
                           replicated_times)
            for kind, v in norms.items()}


def _oracle_parts(run):
    ctx = _layout_ctx(TRAIN[run][1])
    parts = {}
    for k, g in _run_oracle(run)[0].items():
        kind = str(tsharding.spec_for(k, g.ndim, ctx))
        parts[kind] = parts.get(kind, 0.0) + float(
            np.sum(np.square(g.astype(np.float64))))
    return parts


@pytest.mark.parametrize("run", list(TRAIN))
def test_global_norm_counts_each_block_once(ranks, run):
    """The ranks' ``grad_norm`` (``sharding.global_norm``) against the
    row oracle's, and each spec kind's part of its square (the experts'
    ``(tp, dp, None)`` and ``(tp, None, dp)``, the router's ``(None,
    None)``, the Mamba mixer's tp-only kinds among them) against the
    unsharded tensors' (``1e-5`` relative); with the tp-replicated kinds
    counted once a model rank, a control, some part falls outside."""
    want = _oracle_parts(run)
    got = _norm_parts(ranks, run)
    assert set(got) == set(want)
    for kind in want:
        np.testing.assert_allclose(got[kind], want[kind], rtol=NORM_REL,
                                   err_msg=kind)
    np.testing.assert_allclose(ranks[0][f"{run}.metrics"][0]["grad_norm"],
                               _run_oracle(run)[2], rtol=NORM_REL)
    if TRAIN[run][1][1] > 1:
        twice = _norm_parts(ranks, run, replicated_times=2)
        assert any(not np.isclose(twice[k], want[k], rtol=NORM_REL)
                   for k in want)


@pytest.mark.parametrize("run", list(TRAIN))
def test_flash_calls_and_collectives(ranks, run):
    """On the CPU the step runs the flash kernel's plain version once an
    attention layer (twice under remat), none in a Mamba layer, and
    launches nothing; every rank makes the same collective calls."""
    arch, _, _, _, remat = TRAIN[run]
    cfg = _rcfg(arch)
    n = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers)) * (
        2 if remat else 1)
    for r in ranks:
        assert r[f"{run}.flash_launches"] == 0
        assert r[f"{run}.plain_calls"] == n
        assert r[f"{run}.calls"] == ranks[0][f"{run}.calls"] > 0


def test_later_steps_run_make_train_step_on_the_mesh(ranks):
    """Two steps of Qwen3-MoE on (2, 2), the second through
    ``make_train_step(cfg, ctx, ...)``: both steps' metrics, and every
    rank's params, m, v and master after them, against two steps of the
    port's unsharded arithmetic on the row oracle's gradients
    (``1e-5``)."""
    arch, mesh, n = STEPS2
    state, ms = _port_steps(arch, mesh, "gspmd",
                            [_batch(arch, B, seed=i) for i in range(n)])
    for i, m in enumerate(ms):
        for r in ranks:
            got = r["steps2.metrics"][i]
            for key in ("loss", "aux_loss", "grad_norm", "lr"):
                np.testing.assert_allclose(got[key], m[key],
                                           err_msg=f"step {i + 1} {key}",
                                           **SHARDED_TOL)
    assert all(r["steps2.step"] == n for r in ranks)
    for part, tensors in _state_want(state).items():
        got = _assembled(ranks, "steps2", part, _shapes(arch), mesh)
        for k, w in tensors.items():
            assert got[k][1], f"{part}/{k}: the ranks' copies differ"
            np.testing.assert_allclose(got[k][0], w, err_msg=f"{part}/{k}",
                                       **SHARDED_TOL)


# --------------------------------------------------------------------- #
# the traps                                                             #
# --------------------------------------------------------------------- #

def _routers(arch):
    return [k for k in _shapes(arch) if k.endswith("router.w")]


@pytest.mark.parametrize("family", MOE)
def test_router_gradient_is_whole_on_every_model_rank(ranks, family):
    """The routers' gradients on (2, 2), the same on both model ranks,
    equal the row oracle's (``1e-5``): the combine weights' gradient is
    summed over tp and the aux path's is not.  Two controls fall outside
    the bound: the oracle's with the aux path counted once a model rank
    (its gradient summed over tp), and the program's with the combine
    weights' ``f`` passing on each model rank's own share
    (``testing.combine_weights``, one ``f`` an MoE layer), whose model
    ranks' copies differ."""
    arch, run = ARCHS[family], f"{family}.gspmd_2x2"
    grads = _run_oracle(run)[0]
    aux = _oracle(arch, (2, 2), "gspmd", B, False, labels=False)[0]
    shapes = _shapes(arch)
    got = _assembled(ranks, run, "grad", shapes, (2, 2))
    routers = {k: shapes[k] for k in _routers(arch)}
    bad = _assembled(ranks, run, "combine_unsummed.grad", routers, (2, 2))
    cfg = _rcfg(arch)
    n_moe = sum(cfg.mlp_kind(i) == "moe" for i in range(cfg.n_layers))
    assert n_moe == len(routers) > 0
    for k in routers:
        g, equal = got[k]
        assert equal, f"{k}: the model ranks' router gradients differ"
        np.testing.assert_allclose(g, grads[k], err_msg=k, **SHARDED_TOL)
        assert np.abs(aux[k]).max() > 0
        control = grads[k] + (2 - 1) * aux[k]
        assert not np.allclose(g, control, **SHARDED_TOL), k
    assert [r[f"{run}.combine_unsummed.unsummed"] for r in ranks] == \
        [n_moe] * WORLD
    for k in routers:
        assert not bad[k][1], f"{k}: the control's model ranks agree"
        assert not np.allclose(bad[k][0], grads[k], **SHARDED_TOL), k


@pytest.mark.parametrize("family", MOE)
def test_aux_gradient_alone_on_a_dp_sharded_batch(ranks, family):
    """The gradient of the aux term alone (``aux_weight`` 1, every label
    ignored) on a dp-sharded (2, 2) batch has a gradient at all, is
    non-zero, and equals the row oracle's (``1e-5``) and the reference's
    (``2e-4``) in every tensor; its metrics' aux loss is the mean over
    dp of the rows'."""
    arch, run = ARCHS[family], f"{family}.gspmd_2x2"
    grads, m, _ = _oracle(arch, (2, 2), "gspmd", B, False, labels=False,
                          aux_weight=1.0)
    assert all(r[f"{run}.aux.requires_grad"] for r in ranks)
    got = _assembled(ranks, run, "aux.grad", _shapes(arch), (2, 2))
    assert max(float(np.abs(g).max()) for g, _ in got.values()) > 0
    assert max(float(np.abs(got[k][0]).max()) for k in _routers(arch)) > 0
    _check_grads(got, grads, SHARDED_TOL, run)
    _, want, _ = _reference(arch, B, 2, labels=False, aux_weight=1.0)
    _check_grads(got, want, REF_TOL, run)
    for r in ranks:
        np.testing.assert_allclose(r[f"{run}.aux.metrics"]["aux_loss"],
                                   m["aux_loss"], **SHARDED_TOL)
        assert r[f"{run}.aux.metrics"]["xent"] == 0.0


@pytest.mark.parametrize("run", X_PROJ_RUNS)
def test_x_proj_and_dt_proj_gradients_sum_over_tp(ranks, run):
    """Falcon-Mamba's ``x_proj`` and ``dt_proj`` gradients on (1, 4) and
    (2, 2) equal the row oracle's (``1e-5``): the gradient of the sum of
    ``x_proj``'s partials is summed over the model group before it
    reaches ``x_proj``.  The control, each model rank's unsummed
    ``x_proj`` gradient (``testing.x_proj_partials`` on the same state
    and batch, one ``f`` a layer, the gradient with respect to
    ``x_proj`` alone), falls outside the bound in every layer."""
    arch, mesh = TRAIN[run][:2]
    grads = _run_oracle(run)[0]
    shapes = _shapes(arch)
    got = _assembled(ranks, run, "grad", shapes, mesh)
    names = [k for k in shapes if k.endswith(("x_proj.w", "dt_proj.w"))]
    bad = _assembled(ranks, run, "x_proj_unsummed.grad",
                     {k: shapes[k] for k in names if "x_proj" in k}, mesh)
    assert len(names) == 2 * _rcfg(arch).n_layers
    for k in names:
        assert got[k][1], k
        np.testing.assert_allclose(got[k][0], grads[k], err_msg=k,
                                   **SHARDED_TOL)
    assert [r[f"{run}.x_proj_unsummed.unsummed"] for r in ranks] == \
        [_rcfg(arch).n_layers] * WORLD
    for k in names:
        if k.endswith("x_proj.w"):
            assert not np.allclose(bad[k][0], grads[k], **SHARDED_TOL), k
