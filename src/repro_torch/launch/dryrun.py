"""The LM dry-run: what one rank of a production mesh holds, computes and
sends in each (arch x shape) cell, on a host with no card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_5_32b \\
        --shape train_4k --mesh 16x16

The JAX package's dry-run (``src/repro/launch/dryrun.py``) lowers and
compiles each cell's SPMD program for 256 or 512 forced host devices and
reads XLA's memory and cost analyses and its optimized HLO
(``launch/hlo_analysis.py``).  PyTorch compiles no such program.  The
port runs one rank's step itself instead, through the program's own
code, on the ``meta`` device: every tensor has a shape and a dtype and
no data, so nothing is allocated or computed.  The rank's state comes
from the program's builders (``launch.train.init_state(ctx=)`` for a
train cell; ``convert.shard_lm_params`` and ``models.transformer.
init_cache`` for serving), its inputs from ``data.pipeline.
lm_input_specs``, and the step is ``launch.train.make_train_step(cfg,
ctx, ...)``, ``launch.serve.make_prefill(cfg, ctx)`` or
``make_decode_step(cfg, ctx)`` on a :class:`~repro_torch.launch.mesh.
DryMesh`, which records every collective instead of sending it (its
ledger is what the port has for ``hlo_analysis.py``, which reads HLO
that the port never produces).  While the step runs:

* :class:`StepTracker` (a ``TorchDispatchMode``) follows every storage an
  op creates, and gives the peak of their live bytes: the step's
  temporaries beyond its arguments (``memory.temp_size_in_bytes``); and
  it counts the FLOPs of the matrix products by
  ``torch.utils.flop_counter.FlopCounterMode``'s formulas (``cost.flops``;
  elementwise work, softmax and the optimizer's arithmetic are not
  counted);
* the ledger gives each collective's kind, axes, group and payload, and
  the bytes a ring moves per device with the reference's factors
  (``hlo_analysis.py:66-78``: all-gather and all-to-all ``(n-1)/n``,
  reduce-scatter ``(n-1)/n`` of its input, all-reduce ``2(n-1)/n``, a
  permute 1).

Attention runs its plain route (``impl="xla"``: the online softmax in
torch ops over key blocks), because the CUDA flash kernel reads data a
meta tensor does not hold; the temporaries are that route's.  Every
layer runs in Python and every collective is recorded where it is sent,
so the counts are already totals: the reference's ``depth_probe`` (1-
and 2-period compiles that undo XLA's counting of a loop body once) has
no counterpart.  The one shape the program takes from its data, the rows
of the vocabulary-parallel embedding's gradient, comes from the batch's
token ids where they are given (``tokens=``), else from a bound
(``distributed.tp._dry_rows``).

The JAX package's ``compat.py`` (jax version shims, ``cost_analysis``
among them) has no counterpart: nothing here depends on a jax version.

A cell that ``sharding.check_divisible`` refuses (Qwen2.5-32B's 40 query
heads on the reference's (16, 16) mesh: ROADMAP item 29) raises
:class:`Refused`; ``main`` prints it as ``REFUSED`` and does not count it
as a failure.  Each cell's record goes to ``artifacts/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
import traceback
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .. import configs
from ..convert import shard_lm_params
from ..distributed.sharding import check_divisible, make_ctx
from ..models import transformer as T
from ..models.config import ModelConfig
from ..optim import adamw
from . import mesh as mesh_mod
from . import serve, specs, train

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")
#: what ``cost.flops`` counts
FLOPS_COUNT = ("matrix products only (torch.utils.flop_counter."
               "FlopCounterMode's formulas): elementwise ops, softmax and "
               "the optimizer's arithmetic are not counted")


class Refused(ValueError):
    """A cell whose mesh ``sharding.check_divisible`` refuses."""


class StepTracker(TorchDispatchMode):
    """What a step's ops do while the mode is active: the storages they
    create, their live bytes (``live``) and the peak of those (``peak``),
    and the FLOPs of the matrix products (``flops``).

    A storage counts from the op that makes it (not a view of, nor an
    in-place write to, one of the op's inputs) until it is freed;
    storages that existed before (the step's arguments) never count.
    The FLOPs are ``FlopCounterMode``'s, by its own formulas
    (``torch.utils.flop_counter.flop_registry``), applied here because
    ``FlopCounterMode`` itself keeps activations alive through its module
    hooks (a smoke Qwen2.5 train step with remat: a peak of 952,596
    bytes under it, 637,972 without)."""

    def __init__(self):
        super().__init__()
        self._sizes: Dict[int, tuple] = {}
        self._composite: Dict[object, bool] = {}
        self.live = 0
        self.peak = 0
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._is_composite(func):
            # a composite op (a matmul under inference mode) in its parts,
            # as FlopCounterMode takes it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        seen = None
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._sizes:
                continue
            if seen is None:
                seen = {id(x.untyped_storage())
                        for x in _tensors((args, kwargs))}
            if key in seen:
                continue
            n = st.nbytes()
            self._sizes[key] = (weakref.ref(st, functools.partial(
                self._free, key)), n)
            self.live += n
            self.peak = max(self.peak, self.live)
        return out

    def _is_composite(self, func) -> bool:
        """Whether ``func.decompose`` has a decomposition to run."""
        got = self._composite.get(func)
        if got is None:
            dk = torch._C.DispatchKey.CompositeImplicitAutograd
            got = self._composite[func] = (
                func is not torch.ops.prim.device.default and (
                    dk in func.py_kernels
                    or torch._C._dispatch_has_kernel_for_dispatch_key(
                        func.name(), dk)))
        return got

    def _free(self, key: int, _ref) -> None:
        self.live -= self._sizes.pop(key)[1]


def _tensors(x):
    """The tensors in ``x``: a tensor, or a list, tuple or dict of them
    (nested), as an op's arguments and results are."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def nbytes(tensors) -> int:
    """The bytes of the distinct storages under ``tensors`` (a tensor, or
    a dict, list or tuple of them, nested)."""
    seen = {}
    for t in _tensors(tensors):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


@dataclasses.dataclass
class Trace:
    """One rank's traced step: the config it ran, its mesh (the ledger
    and the counters), the bytes of its arguments by part (``params``,
    ``opt``, ``batch``, ``cache``), its temporaries' peak, the bytes it
    returns that it made, the matrix products' FLOPs and the seconds the
    trace took."""
    cfg: ModelConfig
    mesh: mesh_mod.DryMesh
    arguments: Dict[str, int]
    temp_bytes: int
    output_bytes: int
    flops: int
    trace_s: float


def rank_coords(mesh_axes: Dict[str, int], rank: int):
    """The coordinates of global ``rank`` on a mesh of ``mesh_axes``
    (row-major, as ``launch.mesh.make_lm_mesh`` lays ranks out)."""
    return tuple(int(c) for c in np.unravel_index(rank, tuple(
        mesh_axes.values())))


def lower_cell(cfg: ModelConfig, shape: dict, mesh_axes: Dict[str, int], *,
               rank: int = 0, opt_overrides: Optional[dict] = None,
               train_kwargs: Optional[dict] = None,
               tokens: Optional[np.ndarray] = None,
               pos: Optional[int] = None,
               drop: Optional[int] = None) -> Trace:
    """Trace global rank ``rank``'s step of the cell ``shape`` (``kind``
    train, prefill or decode; ``seq_len``, ``global_batch``) on a mesh
    of ``mesh_axes`` on the meta device.

    train: ``init_state(ctx=)``'s blocks (AdamW from ``opt_overrides``),
    then ``make_train_step(cfg, ctx, opt_cfg, impl="xla",
    **train_kwargs)`` on the whole global batch; ``tokens`` (the batch's
    token ids, ``(B, S)``) gives the embedding gradient's rows, split
    into microbatches as the step splits the batch.  prefill:
    ``shard_lm_params`` of the meta model, then ``make_prefill(cfg,
    ctx, impl="xla")``.  decode: those blocks and ``init_cache(ctx=)`` of
    ``seq_len`` positions, then ``make_decode_step(cfg, ctx)`` of one
    token at ``pos`` (default the last position).  Serving runs without
    autograd (``torch.no_grad()``).  ``drop`` leaves one collective out
    of the mesh's ledger and counters (``DryMesh.drop``, a control).
    Raises :class:`Refused` where the mesh does not divide the config."""
    mesh = mesh_mod.make_dry_mesh(mesh_axes, rank_coords(mesh_axes, rank))
    mesh.drop = drop
    ctx = make_ctx(mesh)
    try:
        check_divisible(cfg, ctx)
    except ValueError as e:
        raise Refused(str(e)) from e
    kind, B, S = shape["kind"], shape["global_batch"], shape["seq_len"]
    batch = {k: torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")
             for k, leaf in specs.batch_struct(cfg, shape, ctx).items()}
    args: Dict[str, object] = {"batch": batch}
    if kind == "train":
        opt_cfg = adamw.AdamWConfig(**(opt_overrides or {}))
        kw = dict(train_kwargs or {})
        state = train.init_state(0, cfg, opt_cfg, device="meta", ctx=ctx)
        args.update(params=state["params"], opt=state["opt"])
        if tokens is not None:
            mesh.tokens = list(np.split(np.asarray(tokens),
                                        kw.get("grad_accum", 1)))
        step = train.make_train_step(cfg, ctx, opt_cfg, impl="xla", **kw)

        def run():
            return step(state, batch)[1]
    else:
        params = shard_lm_params(T.init_params(0, cfg, device="meta"), cfg,
                                 ctx)
        args["params"] = params
        if kind == "prefill":
            prefill = serve.make_prefill(cfg, ctx, impl="xla")

            def run():
                return prefill(params, batch)
        else:
            cache = T.init_cache(cfg, B, S, device="meta",
                                 dtype=params.dtype, ctx=ctx)
            args["cache"] = cache
            decode = serve.make_decode_step(cfg, ctx)
            at = S - 1 if pos is None else pos

            def run():
                return decode(params, batch, cache, at)
    arguments = {k: nbytes(v.state_dict() if isinstance(v, torch.nn.Module)
                           else v) for k, v in args.items()}
    grad = kind == "train"
    t0 = time.perf_counter()
    with torch.set_grad_enabled(grad), StepTracker() as mem:
        out = run()
        made = mem.live
    del out
    return Trace(cfg, mesh, arguments, mem.peak, made, int(mem.flops),
                 time.perf_counter() - t0)


def wire_bytes(kind: str, group: int, payload: int) -> float:
    """The bytes one device moves for a collective over a ring of
    ``group``: the JAX package's factors (``hlo_analysis.py:66-78``)."""
    n = max(group, 1)
    if kind in ("all-gather", "all-to-all", "reduce-scatter"):
        return payload * (n - 1) / n
    if kind == "all-reduce":
        return payload * 2 * (n - 1) / n
    return float(payload)


def collective_summary(mesh: mesh_mod.DryMesh, top: int = 8) -> dict:
    """The ledger as the JAX package's ``collective_summary`` reports
    HLO's: the wire bytes per device, by kind, the number of collectives
    and the ``top`` largest (identical ones counted together as
    ``mult``), with the mesh's counters (``calls``, ``bytes_in``,
    ``bytes_out``) beside them."""
    def wire(entry):
        kind, _, group, payload = entry
        return wire_bytes(kind, group, payload)

    by_kind: Dict[str, float] = {}
    same: Dict[tuple, int] = {}
    for entry in mesh.ledger:
        by_kind[entry[0]] = by_kind.get(entry[0], 0.0) + wire(entry)
        same[entry] = same.get(entry, 0) + 1
    ranked = sorted(same.items(), key=lambda e: -wire(e[0]) * e[1])
    return {"wire_bytes_per_device": sum(by_kind.values()),
            "by_kind": by_kind, "n_collectives": len(mesh.ledger),
            "top_ops": [dict(kind=k, axes=list(axes), group=g, payload=p,
                             mult=m)
                        for (k, axes, g, p), m in ranked[:top]],
            "stats": {k: mesh.stats[k] for k in mesh_mod.COUNTERS}}


def analytic_model(cfg: ModelConfig, shape: dict, n_dev: int) -> dict:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE) + attention term
    (the JAX package's ``analytic_model``, ``dryrun.py:202``; ``n_dev``
    unused there too)."""
    S, B = shape["seq_len"], shape["global_batch"]
    kind = shape["kind"]
    D_tok = B * S if kind in ("train", "prefill") else B
    N = cfg.param_count()
    N_act = cfg.active_param_count()
    mult = 6 if kind == "train" else 2
    flops = mult * N_act * D_tok
    # causal attention score+value FLOPs (not in 6ND):
    attn_layers = sum(1 for i in range(cfg.n_layers)
                      if cfg.layer_kind(i) == "attn")
    if kind in ("train", "prefill"):
        flops += mult * attn_layers * 2 * B * cfg.n_heads * \
            (S * S // 2) * cfg.head_dim
    else:
        flops += 2 * attn_layers * 2 * B * cfg.n_heads * S * cfg.head_dim
    return {"params_total": N, "params_active": N_act,
            "model_flops": float(flops), "tokens": D_tok}


def mesh_name(mesh_axes: Dict[str, int]) -> str:
    return "x".join(str(n) for n in mesh_axes.values())


def parse_mesh(text: str) -> Dict[str, int]:
    """``"DxM"`` -> ``{"data": D, "model": M}``; ``"PxDxM"`` adds
    ``"pod"``."""
    sizes = [int(x) for x in text.lower().split("x")]
    if len(sizes) not in (2, 3):
        raise ValueError(f"--mesh {text!r}: want DxM or PxDxM")
    return dict(zip(("pod", "data", "model")[3 - len(sizes):], sizes))


def artifact_path(arch: str, shape_name: str, mesh_s: str, tag: str = "",
                  out_dir: str = ARTIFACT_DIR) -> str:
    suffix = f"_{tag}" if tag else ""
    return os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_s}{suffix}"
                                 ".json")


def run_cell(arch: str, shape_name: str, mesh_axes: Dict[str, int], *,
             tag: str = "", out_dir: str = ARTIFACT_DIR) -> dict:
    """:func:`lower_cell` of one cell (rank 0), written as a JSON record
    under ``out_dir``: the reference's keys where the port has a
    counterpart (``memory``, ``cost``, ``collectives``, ``analytic``),
    ``trace_s`` for ``lower_s`` and ``compile_s``, and ``notes`` on what
    differs."""
    cfg = configs.get_config(arch)
    shape = configs.SHAPES[shape_name]
    n_dev = int(np.prod(list(mesh_axes.values())))
    tr = lower_cell(cfg, shape, mesh_axes)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh_axes),
           "mesh_axes": mesh_axes, "coords": list(tr.mesh.coords),
           "kind": shape["kind"], "tag": tag,
           "trace_s": round(tr.trace_s, 1),
           "memory": {"argument_size_in_bytes": sum(tr.arguments.values()),
                      "output_size_in_bytes": tr.output_bytes,
                      "temp_size_in_bytes": tr.temp_bytes,
                      "arguments": tr.arguments},
           "cost": {"flops": float(tr.flops), "counts": FLOPS_COUNT},
           "collectives": collective_summary(tr.mesh),
           "analytic": analytic_model(tr.cfg, shape, n_dev),
           "notes": {
               "device": "meta: shapes only, nothing allocated or computed",
               "attention": "plain route (impl='xla'); the flash kernel "
                            "reads data",
               "depth_probe": "none needed: every layer runs in Python and "
                              "every collective is recorded, so the counts "
                              "are totals",
               "embed_rows": "a bound (no tokens given): every token in "
                             "the rank's vocabulary shard, all distinct"
                             if shape["kind"] == "train" else "unused"}}
    os.makedirs(out_dir, exist_ok=True)
    path = artifact_path(arch, shape_name, rec["mesh"], tag, out_dir)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    rec["artifact"] = path
    return rec


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true",
                    help="every cell of configs.cells() not marked skip")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 512-GPU mesh (2, 32, 8)")
    ap.add_argument("--both-meshes", action="store_true",
                    help="(32, 8) and (2, 32, 8)")
    ap.add_argument("--mesh", default=None,
                    help="DxM or PxDxM instead, e.g. 16x16 (the JAX "
                         "package's TPU pod)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", default=ARTIFACT_DIR)
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip cells whose record already exists")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a, s, skip in configs.cells() if not skip]
    elif args.arch and args.shape:
        cells = [(configs.ALIASES.get(args.arch, args.arch), args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    if args.mesh:
        meshes = [parse_mesh(args.mesh)]
    elif args.both_meshes:
        meshes = [mesh_mod.production_axes(False),
                  mesh_mod.production_axes(True)]
    else:
        meshes = [mesh_mod.production_axes(args.multi_pod)]

    failures = refused = 0
    for axes in meshes:
        mesh_s = mesh_name(axes)
        for arch, shape_name in cells:
            label = f"{arch} x {shape_name} x {mesh_s}"
            path = artifact_path(arch, shape_name, mesh_s, args.tag,
                                 args.out_dir)
            if args.skip_existing and os.path.exists(path):
                print(f"SKIP {label} (record exists)", flush=True)
                continue
            try:
                rec = run_cell(arch, shape_name, axes, tag=args.tag,
                               out_dir=args.out_dir)
            except Refused as e:
                refused += 1
                print(f"REFUSED {label}: {e}", flush=True)
                continue
            except Exception as e:  # noqa: BLE001 - counted and reported
                failures += 1
                print(f"FAIL {label}: {e}", flush=True)
                traceback.print_exc()
                continue
            mem = rec["memory"]
            print(f"OK   {label}: trace {rec['trace_s']}s, args "
                  f"{mem['argument_size_in_bytes'] / 1e9:.2f} GB/rank, temp "
                  f"{mem['temp_size_in_bytes'] / 1e9:.2f} GB/rank, "
                  f"{rec['cost']['flops'] / 1e12:.1f} TFLOP, wire "
                  f"{rec['collectives']['wire_bytes_per_device'] / 1e6:.1f} "
                  "MB/rank", flush=True)
    print(f"{failures} failed, {refused} refused", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
