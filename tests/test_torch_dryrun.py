"""The port's LM dry-run (``repro_torch.launch.dryrun``) against the JAX
reference and against real ranks.

* Shapes, at full width, against the reference: ``lm_input_specs`` for
  all 40 (arch x shape) cells, ``params_shape`` for the 10 archs
  (through ``repro_torch.convert``'s name map), each rank's parameter
  blocks on (32, 8) and (2, 32, 8) against the reference's
  ``param_specs`` applied to its shapes, ``analytic_model`` for the
  32 cells, and a collective's wire bytes against those of
  ``hlo_analysis.CollectiveOp``.  The reference runs in one subprocess
  (the ``run_sub`` pattern of ``tests/test_distributed.py:15``), which
  never needs ``repro.launch.dryrun``'s forced device count: that module
  is imported there after jax has started, and never in this process.
* The recording mesh against real ranks: one ``spawn_ranks`` of 4 gloo
  CPU ranks on (2, 2) (``testing.run_lm_on_mesh``) runs training steps
  and serving (a prefill, then a decode step) of smoke configs; each
  rank's collective counters (``calls``, ``bytes_in``, ``bytes_out``)
  for each step must equal its dry-run's exactly, and a dry-run with one
  collective dropped (``DryMesh.drop``) must not.  The dry-run's
  argument bytes must equal the rank's state.
* On a mesh of one rank, the dry-run's FLOPs must equal
  ``FlopCounterMode``'s count of the same step run for real on the CPU.
* The production meshes: every arch divides (32, 8) and (64, 8); on the
  reference's (16, 16) only Qwen2.5-32B is refused (its 40 query heads,
  ROADMAP item 29), and ``main`` exits 0 with those cells refused.

Nothing here leaves global state behind (:func:`clean_state` restores
the environment and checks the rest after every test), and records go
to ``tmp_path``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as tconfigs
from repro_torch import testing as ttesting
from repro_torch.convert import _lm_flat_from_reference, shard_lm_params
from repro_torch.data.pipeline import lm_input_specs
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as TA

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
#: seconds the reference's subprocess and the ranks' spawn may take
SUB_TIMEOUT, SPAWN_TIMEOUT = 300, 300
WORLD, MESH = 4, (2, 2)
B, S = 4, 16
ARCHS = tconfigs.ARCHS
CELLS = [(a, s) for a, s, skip in tconfigs.cells() if not skip]
MESHES = {"32x8": tmesh.production_axes(False),
          "2x32x8": tmesh.production_axes(True)}
#: (kind, group, payload bytes) held to the reference's ring factors
WIRE_CASES = [("all-gather", 4, 400), ("reduce-scatter", 4, 400),
              ("all-to-all", 8, 800), ("all-reduce", 4, 400),
              ("collective-permute", 2, 400), ("all-reduce", 1, 96),
              ("all-gather", 32, 3 * 2 ** 30)]


def run_sub(body: str, n_dev: int = 8, timeout: int = 480):
    """``tests/test_distributed.py:15``'s ``run_sub``: ``body`` in a fresh
    interpreter with ``n_dev`` forced host devices; its stdout."""
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = (
            "--xla_force_host_platform_device_count={n_dev}")
        import sys
        sys.path.insert(0, {SRC!r})
        import jax, jax.numpy as jnp, numpy as np
        assert jax.device_count() == {n_dev}
    """) + textwrap.dedent(body)
    res = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, f"STDOUT:\n{res.stdout}\nERR:\n{res.stderr}"
    return res.stdout


@pytest.fixture(autouse=True)
def clean_state():
    """Every test leaves the environment as it found it (restored: the
    meta kernels' first use imports ``torch._dynamo``, which sets
    ``TORCHINDUCTOR_CACHE_DIR``), and torch's defaults, the process group
    and the dispatch modes unchanged."""
    env = dict(os.environ)
    dtype, device = torch.get_default_dtype(), torch.get_default_device()
    yield
    os.environ.clear()
    os.environ.update(env)
    assert torch.get_default_dtype() == dtype
    assert torch.get_default_device() == device
    assert not (dist.is_available() and dist.is_initialized())
    assert _get_current_dispatch_mode() is None


@pytest.fixture(scope="module")
def ref():
    """The reference's side, in one subprocess: each cell's input specs,
    each arch's stacked parameter leaves (shape, dtype, spec on each
    production mesh's axes), each cell's ``analytic_model`` and the wire
    bytes of ``hlo_analysis.CollectiveOp`` for each of WIRE_CASES."""
    out = run_sub(f"""
        import json
        from repro import configs
        from repro.data.pipeline import lm_input_specs
        from repro.distributed.sharding import ShardingCtx, param_specs
        from repro.launch import specs
        from repro.launch.dryrun import analytic_model
        from repro.launch.hlo_analysis import CollectiveOp

        def spec(p):
            return [list(a) if isinstance(a, tuple) else a for a in p]

        res = {{"inputs": {{}}, "params": {{}}, "analytic": {{}},
                "wire": [CollectiveOp(k, p, g, computation="").wire_bytes
                         for k, g, p in {WIRE_CASES!r}]}}
        for a in configs.ARCHS:
            cfg = configs.get_config(a)
            for s, shape in configs.SHAPES.items():
                res["inputs"][a + "/" + s] = {{
                    k: [list(v.shape), str(v.dtype)]
                    for k, v in lm_input_specs(cfg, shape).items()}}
            ps = specs.params_shape(cfg)
            leaves = jax.tree_util.tree_flatten_with_path(ps)[0]
            per_mesh = []
            for dp in ("data", ("pod", "data")):
                sp = param_specs(ps, ShardingCtx(mesh=None, dp=dp,
                                                 tp="model"))
                per_mesh.append(jax.tree_util.tree_leaves(
                    sp, is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec)))
            res["params"][a] = [
                [jax.tree_util.keystr(path), list(leaf.shape),
                 str(leaf.dtype), spec(s1), spec(s2)]
                for (path, leaf), s1, s2 in zip(leaves, *per_mesh)]
        for a, s, skip in configs.cells():
            if not skip:
                res["analytic"][a + "/" + s] = analytic_model(
                    configs.get_config(a), configs.SHAPES[s], 256)
        print("JSON" + json.dumps(res))
    """, n_dev=1, timeout=SUB_TIMEOUT)
    return json.loads(out[out.index("JSON") + 4:])


# ---------------------------------------------------------------------- #
# Shapes against the reference                                             #
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("arch,shape", [(a, s) for a in ARCHS
                                        for s in tconfigs.SHAPES])
def test_lm_input_specs_match_the_reference(ref, arch, shape):
    got = lm_input_specs(tconfigs.get_config(arch), tconfigs.SHAPES[shape])
    assert all(t.is_meta for t in got.values())
    assert {k: [list(t.shape), str(t.dtype).replace("torch.", "")]
            for k, t in got.items()} == ref["inputs"][f"{arch}/{shape}"]


def _ref_leaves(ref, arch):
    """The reference's parameters of ``arch`` by the port's names: ``{name:
    (shape, dtype, spec on (32, 8), spec on (2, 32, 8))}``, unstacked
    through ``convert._lm_flat_from_reference`` (each leaf a zero-stride
    array holding its index, so the map's output names its source)."""
    rows = ref["params"][arch]
    tree = {}
    for i, (path, shape, _, _, _) in enumerate(rows):
        keys = [k.strip("[]'") for k in path.split("][")]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.broadcast_to(np.int64(i), shape)
    flat = _lm_flat_from_reference(_listify(tree), tconfigs.get_config(arch))
    out = {}
    for name, a in flat.items():
        _, shape, dtype, s1, s2 = rows[int(a.flat[0])]
        cut = len(shape) - a.ndim           # the stacked period axis
        out[name] = (tuple(shape[cut:]), dtype, s1[cut:], s2[cut:])
    return out


def _listify(node):
    """Dicts keyed ``"0", "1", ...`` back to lists (the prologue)."""
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_listify(node[str(i)]) for i in range(len(node))]
    return {k: _listify(v) for k, v in node.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_params_shape_matches_the_reference(ref, arch):
    want = _ref_leaves(ref, arch)
    got = tspecs.params_shape(tconfigs.get_config(arch))
    assert set(got) == set(want)
    for name, t in got.items():
        assert t.is_meta
        assert tuple(t.shape) == want[name][0], name
        assert str(t.dtype).replace("torch.", "") == want[name][1], name


def _block(shape, spec, axes):
    return tuple(n // int(np.prod([axes[a] for a in (
        [] if s is None else [s] if isinstance(s, str) else s)]))
        for n, s in zip(shape, spec))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_blocks_match_the_reference_specs(ref, arch, mesh):
    """Each rank's blocks (``train_state_struct``; on (32, 8) also the
    meta state ``init_state(ctx=)`` builds for the dry-run) against the
    reference's ``param_specs`` applied to its shapes."""
    axes = MESHES[mesh]
    cfg = tconfigs.get_config(arch)
    ctx = tsharding.make_ctx(tmesh.make_dry_mesh(axes))
    want = {k: _block(v[0], v[2 if mesh == "32x8" else 3], axes)
            for k, v in _ref_leaves(ref, arch).items()}
    opt_cfg = TA.AdamWConfig()
    struct = tspecs.train_state_struct(cfg, ctx, opt_cfg)
    assert {k: leaf.shape for k, leaf in struct["params"].items()} == want
    if mesh != "32x8":
        return
    state = ttrain.init_state(0, cfg, opt_cfg, device="meta", ctx=ctx)
    assert {k: tuple(p.shape) for k, p in
            state["params"].named_parameters()} == want
    assert {k: tuple(t.shape) for k, t in state["opt"]["master"].items()} \
        == want


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_model_matches_the_reference(ref, arch, shape):
    got = D.analytic_model(tconfigs.get_config(arch),
                           tconfigs.SHAPES[shape], 256)
    assert got == ref["analytic"][f"{arch}/{shape}"]


def test_batch_struct_shards_the_batch_where_dp_divides_it():
    cfg = tconfigs.get_config("qwen2_vl_72b")
    ctx = tsharding.make_ctx(tmesh.make_dry_mesh(MESHES["32x8"]))
    got = tspecs.batch_struct(cfg, tconfigs.SHAPES["train_4k"], ctx)
    assert {k: (v.shape, v.spec) for k, v in got.items()} == {
        "inputs": ((256, 4096, 8192), ("data", None, None)),
        "labels": ((256, 4096), ("data", None)),
        "positions": ((256, 4096, 3), ("data", None, None))}
    one = tspecs.batch_struct(cfg, tconfigs.SHAPES["long_500k"], ctx)
    assert one["inputs"].shape == (1, 1, 8192)
    assert one["inputs"].spec == (None, None, None)


# ---------------------------------------------------------------------- #
# The production meshes                                                    #
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("mesh", ["32x8", "64x8", "2x32x8", "16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_production_meshes_divide_every_arch(arch, mesh):
    ctx = tsharding.make_ctx(tmesh.make_dry_mesh(D.parse_mesh(mesh)))
    cfg = tconfigs.get_config(arch)
    if mesh == "16x16" and arch == "qwen2_5_32b":
        with pytest.raises(ValueError, match="n_heads=40.*ROADMAP item 29"):
            tsharding.check_divisible(cfg, ctx)
    else:
        tsharding.check_divisible(cfg, ctx)


def test_production_axes_are_h100_nodes():
    assert tmesh.production_axes() == {"data": 32, "model": 8}
    assert tmesh.production_axes(multi_pod=True) == {"pod": 2, "data": 32,
                                                     "model": 8}
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.HBM_BW) == (989e12, 3.35e12)


def test_main_refuses_qwen2_5_32b_on_16x16(tmp_path, capsys):
    """``--mesh 16x16``: the Qwen2.5-32B cells are refused with item 29's
    text and write nothing; an arch that divides writes its record; the
    run exits 0."""
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        assert D.main(["--arch", "qwen2_5_32b", "--shape", shape, "--mesh",
                       "16x16", "--out-dir", str(tmp_path)]) == 0
    assert D.main(["--arch", "falcon_mamba_7b", "--shape", "decode_32k",
                   "--mesh", "16x16", "--out-dir", str(tmp_path)]) == 0
    text = capsys.readouterr().out
    assert text.count("REFUSED qwen2_5_32b") == 3
    assert text.count("ROADMAP item 29") == 3
    assert "OK   falcon_mamba_7b x decode_32k x 16x16" in text
    assert sorted(os.listdir(tmp_path)) == [
        "falcon_mamba_7b__decode_32k__16x16.json"]
    rec = json.loads((tmp_path / os.listdir(tmp_path)[0]).read_text())
    assert rec["mesh"] == "16x16" and rec["coords"] == [0, 0]
    assert set(rec["memory"]) >= {"argument_size_in_bytes",
                                  "temp_size_in_bytes"}
    assert rec["memory"]["arguments"]["cache"] > 0
    assert rec["collectives"]["n_collectives"] == rec["collectives"][
        "stats"]["calls"] > 0
    assert rec["cost"]["flops"] > 0 and "trace_s" in rec


def test_main_counts_a_failure(tmp_path, monkeypatch, capsys):
    """Any error other than a refusal is a failure: exit 1."""
    def broken(*a, **kw):
        raise RuntimeError("broken on purpose")
    monkeypatch.setattr(D, "lower_cell", broken)
    assert D.main(["--arch", "falcon_mamba_7b", "--shape", "decode_32k",
                   "--out-dir", str(tmp_path)]) == 1
    assert "FAIL falcon_mamba_7b" in capsys.readouterr().out


# ---------------------------------------------------------------------- #
# The recording mesh against real ranks                                   #
# ---------------------------------------------------------------------- #

#: the ranks' cases: (arch, kind, tp_collectives, global batch)
CASES = {"dense_train": ("qwen2_5_32b", "train", "gspmd", B),
         "dense_train_b3": ("qwen2_5_32b", "train", "manual", 3),
         "moe_train": ("qwen3_moe_30b_a3b", "train", "gspmd", B),
         "ssm_train": ("falcon_mamba_7b", "train", "manual", B),
         "dense_serve_gspmd": ("qwen2_5_32b", "serve", "gspmd", B),
         "dense_serve_manual": ("qwen2_5_32b", "serve", "manual", B),
         "hybrid_serve": ("jamba_1_5_large_398b", "serve", "manual", B),
         "vl_train": ("qwen2_vl_72b", "train", "gspmd", B),
         "shared_serve_gspmd": ("qwen2_5_32b", "serve", "gspmd", B)}
#: serving cases that reuse another's weights (the blocks cut under its
#: config): a model serves under the config each call passes, as
#: chip_smoke.py's [15.tp] serves "manual" and then "gspmd"
SHARED = {"shared_serve_gspmd": "dense_serve_manual"}
OPT = dict(lr=1e-3)


def _inputs(cfg, b, seed):
    rng = np.random.default_rng(seed)
    if cfg.embed_input:
        return rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32)
    return rng.normal(size=(b, S, cfg.d_model)).astype(np.float32)


def _train_batch(cfg, b, seed=0):
    out = {"inputs": _inputs(cfg, b, seed),
           "labels": np.random.default_rng(seed + 1).integers(
               0, cfg.vocab_size, (b, S)).astype(np.int32)}
    if cfg.rope_kind == "mrope":
        out["positions"] = np.random.default_rng(seed + 2).integers(
            0, S, (b, S, 3)).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def ranks():
    """Every case in one spawn of 4 gloo CPU ranks."""
    runs = []
    for name, (arch, kind, mode, b) in CASES.items():
        cfg = tconfigs.get_smoke_config(arch)
        if kind == "train":
            runs.append(dict(name=name, kind="train", mesh=MESH, mode=mode,
                             cfg=cfg, seed=3, opt=OPT, warmup=0,
                             total_steps=10,
                             batches=[_train_batch(cfg, b)]))
        else:
            runs.append(dict(name=name, kind="serve", mesh=MESH, mode=mode,
                             cfg=cfg, seed=3, weights=SHARED.get(name, name),
                             gen=2, prompts=_inputs(cfg, b, 5)))
    outs = tmesh.spawn_ranks(ttesting.run_lm_on_mesh, WORLD, runs, "cpu",
                             timeout=SPAWN_TIMEOUT, device="cpu")
    return runs, outs


_DRY = {}


def _dry(run, rank, step=0, drop=None):
    """The dry-run of ``run``'s ``step`` (train: its batch's tokens) or
    kind (serve: ``"prefill"`` or ``"decode"``) on ``rank``, traced once
    for the module."""
    key = (run["name"], rank, step, drop)
    if key not in _DRY:
        _DRY[key] = _trace(run, rank, step, drop)
    return _DRY[key]


def _trace(run, rank, step, drop):
    cfg = dataclasses.replace(run["cfg"], tp_collectives=run["mode"])
    axes = {"data": MESH[0], "model": MESH[1]}
    if run["kind"] == "train":
        batch = run["batches"][step]
        shape = dict(kind="train", seq_len=S,
                     global_batch=batch["labels"].shape[0])
        return D.lower_cell(
            cfg, shape, axes, rank=rank, opt_overrides=run["opt"],
            train_kwargs=dict(warmup=0, total_steps=10),
            tokens=batch["inputs"] if cfg.embed_input else None, drop=drop)
    b = run["prompts"].shape[0]
    if step == "prefill":
        shape = dict(kind="prefill", seq_len=S, global_batch=b)
        return D.lower_cell(cfg, shape, axes, rank=rank, drop=drop)
    # decode: generate's caches hold P + gen - 1 positions; its first
    # decode step writes position P
    shape = dict(kind="decode", seq_len=S + run["gen"] - 1, global_batch=b)
    return D.lower_cell(cfg, shape, axes, rank=rank, pos=S, drop=drop)


def _counters(tr):
    return {k: tr.mesh.stats[k] for k in tmesh.COUNTERS}


def _steps(run, out):
    """``[(step, the rank's counters)]``: each train step by index, or the
    serving calls by kind."""
    steps = out[f"{run['name']}.steps"]
    if run["kind"] == "train":
        return list(enumerate(steps))
    return [(s["kind"], s) for s in steps]


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("case", CASES)
def test_ledger_equals_the_ranks_counters(ranks, case, rank):
    runs, outs = ranks
    run = next(r for r in runs if r["name"] == case)
    out = outs[rank]
    assert tuple(out[f"{case}.coords"]) == D.rank_coords(
        {"data": MESH[0], "model": MESH[1]}, rank)
    steps = _steps(run, out)
    assert [s for s, _ in steps] == ([0] if run["kind"] == "train"
                                     else ["prefill", "decode"])
    for step, have in steps:
        tr = _dry(run, rank, step)
        assert _counters(tr) == {k: have[k] for k in tmesh.COUNTERS}, step
        assert tr.mesh.stats["calls"] == len(tr.mesh.ledger) > 0
        assert all(kind in tmesh.KINDS and group > 1 and payload > 0
                   for kind, _, group, payload in tr.mesh.ledger)


@pytest.mark.parametrize("case", CASES)
def test_a_dropped_collective_is_rejected(ranks, case):
    """The control: one collective left out of the ledger (the first, and
    the last) no longer matches the rank's counters."""
    runs, outs = ranks
    run = next(r for r in runs if r["name"] == case)
    step, have = _steps(run, outs[1])[0]
    n = _dry(run, 1, step).mesh.stats["calls"]
    for drop in (0, n - 1):
        tr = _dry(run, 1, step, drop=drop)
        assert tr.mesh.stats["calls"] == n - 1
        assert _counters(tr) != {k: have[k] for k in tmesh.COUNTERS}


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("case", CASES)
def test_argument_bytes_equal_the_ranks_state(ranks, case, rank):
    """The dry-run's params (and AdamW state) are the bytes the rank's
    real ``init_state(ctx=)`` or ``shard_lm_params`` holds."""
    runs, outs = ranks
    run = next(r for r in runs if r["name"] == case)
    tr = _dry(run, rank, 0 if run["kind"] == "train" else "prefill")
    held = tr.arguments["params"] + tr.arguments.get("opt", 0)
    assert held == outs[rank][f"{case}.state_bytes"] > 0


def test_embedding_rows_without_tokens_are_a_bound(ranks):
    """Without the batch's tokens the embedding gradient's rows are a
    bound: no fewer bytes than the data's."""
    runs, outs = ranks
    run = next(r for r in runs if r["name"] == "dense_train")
    cfg = dataclasses.replace(run["cfg"], tp_collectives=run["mode"])
    shape = dict(kind="train", seq_len=S, global_batch=B)
    axes = {"data": MESH[0], "model": MESH[1]}
    kw = dict(opt_overrides=run["opt"],
              train_kwargs=dict(warmup=0, total_steps=10))
    for rank in range(WORLD):
        blind = D.lower_cell(cfg, shape, axes, rank=rank, **kw)
        have = outs[rank]["dense_train.steps"][0]
        assert blind.mesh.stats["calls"] == have["calls"]
        assert blind.mesh.stats["bytes_in"] >= have["bytes_in"]


# ---------------------------------------------------------------------- #
# FLOPs and memory on one rank                                             #
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen2_5_32b", "qwen3_moe_30b_a3b",
                                  "falcon_mamba_7b", "qwen2_vl_72b"])
def test_flops_equal_a_real_run_on_one_rank(arch, kind):
    """On a mesh of one rank, the meta trace's FLOPs equal
    ``FlopCounterMode``'s over the same step run on the CPU (the same
    plain attention route), and the arguments equal the real ones'."""
    cfg = tconfigs.get_smoke_config(arch)
    b = 2
    shape = dict(kind=kind, seq_len=S, global_batch=b)
    tr = D.lower_cell(cfg, shape, {"data": 1, "model": 1})
    ctx = tsharding.make_ctx(tmesh.make_lm_mesh({"data": 1, "model": 1},
                                                device="cpu"))
    inputs = torch.from_numpy(_inputs(cfg, b, 7))
    if kind == "decode":
        inputs = inputs[:, :1]
    if not cfg.embed_input:
        inputs = inputs.to(getattr(torch, cfg.dtype))
    batch = {"inputs": inputs}
    if kind == "train":
        batch = {k: torch.from_numpy(v)
                 for k, v in _train_batch(cfg, b).items()}
    elif cfg.rope_kind == "mrope" and kind == "prefill":
        batch["positions"] = torch.from_numpy(
            _train_batch(cfg, b)["positions"])
    opt = TA.AdamWConfig()
    if kind == "train":
        state = ttrain.init_state(0, cfg, opt, device="cpu", ctx=ctx)
        held = D.nbytes([state["params"].state_dict(), state["opt"]])
        step = ttrain.make_train_step(cfg, ctx, opt, impl="xla")

        def run():
            step(state, batch)
    else:
        params = shard_lm_params(TT.init_params(0, cfg, device="cpu"), cfg,
                                 ctx)
        held = D.nbytes(params.state_dict())
        if kind == "prefill":
            def run():
                tserve.make_prefill(cfg, ctx, impl="xla")(params, batch)
        else:
            cache = TT.init_cache(cfg, b, S, device="cpu",
                                  dtype=params.dtype, ctx=ctx)
            held += D.nbytes(cache)

            def run():
                tserve.make_decode_step(cfg, ctx)(params, batch, cache,
                                                  S - 1)
    with torch.inference_mode(kind != "train"), \
            FlopCounterMode(display=False) as fc:
        run()
    assert tr.flops == fc.get_total_flops() > 0
    dry_held = tr.arguments["params"] + tr.arguments.get(
        "opt", 0) + tr.arguments.get("cache", 0)
    assert dry_held == held
    assert tr.temp_bytes > 0 and tr.mesh.ledger == []


def test_step_tracker_counts_storages_until_they_are_freed():
    with D.StepTracker() as mem:
        a = torch.empty((1024,), device="meta")          # 4 KiB
        b = a.view(32, 32)                               # a view: nothing
        c = a * 2                                        # 4 KiB
        a.add_(1)                                        # in place: nothing
        d = c.to(torch.float64)                          # 8 KiB
        del a, b, c                                      # 8 KiB freed
        live = mem.live
    assert (mem.peak, live) == (4096 + 4096 + 8192, 8192)
    assert d.is_meta


def test_run_cell_writes_the_reference_keys(tmp_path):
    rec = D.run_cell("falcon_mamba_7b", "decode_32k",
                     tmesh.production_axes(), out_dir=str(tmp_path))
    assert os.path.exists(rec["artifact"])
    assert {"arch", "shape", "mesh", "kind", "tag", "trace_s", "memory",
            "cost", "collectives", "analytic"} <= set(rec)
    assert rec["mesh"] == "32x8"
    assert set(rec["collectives"]) >= {"wire_bytes_per_device", "by_kind",
                                       "n_collectives", "top_ops"}
    wire = sum(D.wire_bytes(k, g, p) * o["mult"]
               for o in rec["collectives"]["top_ops"]
               for k, g, p in [(o["kind"], o["group"], o["payload"])])
    assert 0 < wire <= rec["collectives"]["wire_bytes_per_device"]


@pytest.mark.parametrize("case", range(len(WIRE_CASES)))
def test_wire_bytes_use_the_reference_ring_factors(ref, case):
    kind, group, payload = WIRE_CASES[case]
    assert D.wire_bytes(kind, group, payload) == ref["wire"][case]
