"""Sharding rules: the mesh context and path-based parameter specs.

The layout is the JAX package's (``src/repro/distributed/sharding.py``):

* dp axes — ``("pod", "data")`` multi-pod, ``"data"`` single-pod: the
  batch and FSDP axis.  Parameters are sharded over dp along a
  dimension that tensor parallelism leaves whole; a layer gathers its
  weights over dp just before it uses them and drops them after (ZeRO-3).
* tp axis — ``"model"``: Megatron column and row parallelism for the
  attention projections, the MLP and the Mamba mixer's ``d_inner``, the
  experts of an MoE layer (each model rank owns ``E/tp`` of them), the
  vocabulary-parallel embedding and LM head.

A spec is a tuple with one entry per dimension of a parameter: ``None``
(whole), an axis name, or a tuple of names (one dimension over several
axes, row-major).  The rules match the parameter's path, the port's
``state_dict`` name with ``/`` for ``.``, which ends as the reference's
path does (``repro_torch.convert`` maps the two), so every tensor gets
the reference's spec.  GSPMD inserts the collectives the specs imply;
the port calls them itself (``repro_torch.distributed.tp``), and unlike
GSPMD it does not pad uneven shards: :func:`check_divisible` refuses
them.  One uneven cut is served: where tp exceeds the KV heads (``tp =
r * n_kv_heads``), the ``(dp, tp)`` blocks of ``wk``/``wv`` (and of
their biases) hold a ``1/r`` column slice of one head each, stored as
the reference stores them; the ``r`` model ranks whose query heads use
that head gather its slices (:func:`kv_share`,
``models.attention``), where GSPMD reshards.  The rules run without a
process group (a mesh of one rank, or one made for its layout only).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple, Union

import torch

from ..launch.mesh import LmMesh

Spec = Tuple[Optional[Union[str, Tuple[str, ...]]], ...]

@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    mesh: LmMesh
    dp: Union[str, Tuple[str, ...]]   # data/FSDP axes
    tp: str                           # tensor axis

    @property
    def dp_size(self) -> int:
        return self.mesh.size(self.dp)

    @property
    def tp_size(self) -> int:
        return self.mesh.size(self.tp)

    @property
    def dp_index(self) -> int:
        return self.mesh.index(self.dp)

    @property
    def tp_index(self) -> int:
        return self.mesh.index(self.tp)


def make_ctx(mesh: LmMesh) -> ShardingCtx:
    if not isinstance(mesh, LmMesh):
        raise TypeError(f"make_ctx takes an LmMesh, got {type(mesh).__name__}")
    if "pod" in mesh.axis_names:
        return ShardingCtx(mesh=mesh, dp=("pod", "data"), tp="model")
    return ShardingCtx(mesh=mesh, dp="data", tp="model")


#: (regex on the joined path, base spec); ``"dp"``/``"tp"`` stand for the
#: context's axes (the reference's ``_RULES``, :60-84)
_RULES = [
    (r"embed/table$",        ("tp", "dp")),
    (r"lm_head/w$",          ("dp", "tp")),
    (r"(wq|wk|wv)/w$",       ("dp", "tp")),
    (r"(wq|wk|wv)/b$",       ("tp",)),
    (r"wo/w$",               ("tp", "dp")),
    (r"wo/b$",               (None,)),
    (r"(gate|up)/w$",        ("dp", "tp")),
    (r"down/w$",             ("tp", "dp")),
    (r"(gate|up|down)/b$",   (None,)),
    (r"router/w$",           (None, None)),
    (r"moe/gate$",           ("tp", "dp", None)),   # experts (E, d, ff)
    (r"moe/up$",             ("tp", "dp", None)),
    (r"moe/down$",           ("tp", None, "dp")),
    (r"in_proj/w$",          ("dp", "tp")),
    (r"conv_w$",             (None, "tp")),
    (r"conv_b$",             ("tp",)),
    (r"x_proj/w$",           ("tp", None)),
    (r"dt_proj/w$",          (None, "tp")),
    (r"dt_bias$",            ("tp",)),
    (r"A_log$",              ("tp", None)),
    (r"D$",                  ("tp",)),
    (r"out_proj/w$",         ("tp", "dp")),
    (r"scale$",              (None,)),
]


def spec_for(path: str, ndim: int, ctx: ShardingCtx) -> Spec:
    """The spec of the parameter at ``path`` (a ``state_dict`` name, ``.``
    or ``/`` separated) with ``ndim`` dimensions: the first rule that
    matches, with leading dimensions beyond it whole; no rule: whole."""
    path = path.replace(".", "/")
    for pat, base in _RULES:
        if re.search(pat, path):
            spec = [ctx.dp if s == "dp" else ctx.tp if s == "tp" else None
                    for s in base]
            if len(spec) > ndim:
                raise ValueError(f"{path}: rule {base} has more dimensions "
                                 f"than the tensor's {ndim}")
            return (None,) * (ndim - len(spec)) + tuple(spec)
    return (None,) * ndim


def param_specs(model: torch.nn.Module, ctx: ShardingCtx
                ) -> Dict[str, Spec]:
    """``{state_dict name: spec}`` for a model's parameters."""
    return {name: spec_for(name, t.dim(), ctx)
            for name, t in model.state_dict().items()}


#: parameters whose last dimension is two tensors side by side, each cut
#: over its spec on its own: Mamba's ``in_proj`` ``(d, 2 d_inner)`` holds
#: ``x`` and ``z`` (the reference's GSPMD reshards the one contiguous
#: block it cuts; the port cuts each half, so a rank holds ``[x block |
#: z block]`` of the same channels)
_HALVED = r"in_proj/w$"


def shard_param(name: str, t: torch.Tensor, ctx: ShardingCtx,
                coords: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """The block of parameter ``name`` (a ``state_dict`` name) that the
    rank at ``coords`` (default: this rank's) holds: :func:`shard_tensor`
    under :func:`spec_for`, except that a :data:`_HALVED` tensor has each
    half of its last dimension cut on its own and the two blocks
    concatenated (a copy)."""
    spec = spec_for(name, t.dim(), ctx)
    if not re.search(_HALVED, name.replace(".", "/")):
        return shard_tensor(t, spec, ctx, coords)
    return torch.cat([shard_tensor(h, spec, ctx, coords)
                      for h in t.chunk(2, dim=-1)], dim=-1)


def shard_tensor(t: torch.Tensor, spec: Spec, ctx: ShardingCtx,
                 coords: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """The block of ``t`` (a view) that the rank at ``coords`` (default:
    this rank's) holds under ``spec``: along each sharded dimension, the
    rank's index along its axes, of their product equal parts."""
    mesh = ctx.mesh
    if coords is not None:
        mesh = dataclasses.replace(mesh, coords=tuple(coords), groups={})
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec} for a {t.dim()}-d tensor")
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        n = mesh.size(axes)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} is not "
                             f"divisible by {n} ({axes})")
        step = t.shape[dim] // n
        t = t.narrow(dim, mesh.index(axes) * step, step)
    return t


def kv_share(n_kv_heads: int, tp: int) -> int:
    """How many model ranks share each KV head: ``r = tp / n_kv_heads``
    where tp exceeds the KV heads (and :func:`check_divisible` accepts
    it), else 1 (each rank holds ``n_kv_heads / tp`` whole heads).  With
    ``r > 1`` model rank ``t`` holds columns ``[t c, (t+1) c)`` of
    ``wk``/``wv``, ``c = head_dim / r``: a slice of head ``t // r``, the
    one its query heads use."""
    return tp // n_kv_heads if n_kv_heads and tp > n_kv_heads else 1


def _even_dims(cfg):
    """``(name, size, axis)`` of each dimension a sharded model splits
    evenly (the KV heads evenly or shared: :func:`check_divisible`); the
    MoE's and the SSM's are 0 where the config has no such layers
    (``shared_width``: the shared experts' SwiGLU)."""
    has_ssm = any(cfg.layer_kind(i) == "ssm" for i in range(cfg.n_layers))
    return [("n_heads", cfg.n_heads, "tp"),
            ("n_kv_heads", cfg.n_kv_heads, "tp"), ("d_ff", cfg.d_ff, "tp"),
            ("vocab_size", cfg.vocab_size, "tp"),
            ("d_model", cfg.d_model, "dp"),
            ("n_experts", cfg.n_experts, "tp"),
            ("shared_width", cfg.n_shared_experts * cfg.d_expert, "tp"),
            ("d_inner", cfg.d_inner if has_ssm else 0, "tp")]


def check_divisible(cfg, ctx: ShardingCtx) -> None:
    """Raise ``ValueError`` naming the first of the config's ``n_heads``,
    ``n_kv_heads``, ``d_ff``, ``vocab_size``, ``n_experts``, the shared
    experts' width and (with SSM layers) ``d_inner`` (over tp), and
    ``d_model`` (over dp, the FSDP axis) that the axis does not divide.
    The KV heads may also be fewer than tp where they divide it (each
    head shared by ``tp / n_kv_heads`` model ranks, :func:`kv_share`),
    with that share dividing ``head_dim``; ``n_heads`` must then still
    divide over tp: the port does not pad query heads, where GSPMD pads
    an uneven shard (ROADMAP item 29).  Nor does it pad any other."""
    for field, val, axis in _even_dims(cfg):
        n = ctx.tp_size if axis == "tp" else ctx.dp_size
        if field == "n_kv_heads":
            _check_kv_heads(cfg, n)
        elif val % n:
            why = ("the port does not pad query heads (ROADMAP item 29)"
                   if field == "n_heads" else
                   "the port does not pad uneven shards")
            raise ValueError(f"{field}={val} is not divisible by the "
                             f"{axis} size {n} ({why})")


def _check_kv_heads(cfg, n_tp: int) -> None:
    """tp and ``n_kv_heads`` must divide one another, and a shared head's
    ``tp / n_kv_heads`` slices must cut ``head_dim`` evenly."""
    hkv = cfg.n_kv_heads
    if hkv % n_tp and n_tp % hkv:
        raise ValueError(f"n_kv_heads={hkv} and the tp size {n_tp} do not "
                         "divide one another (the port shares a KV head "
                         "over tp / n_kv_heads model ranks, and does not "
                         "pad uneven shards)")
    r = kv_share(hkv, n_tp)
    if cfg.head_dim % r:
        raise ValueError(f"head_dim={cfg.head_dim} is not divisible by the "
                         f"{r} model ranks that share each of the "
                         f"n_kv_heads={hkv} KV heads")


def _axes(spec: Spec) -> set:
    """The mesh axes a spec shards over."""
    out = set()
    for a in spec:
        if a is not None:
            out.update((a,) if isinstance(a, str) else a)
    return out


def block_shape(shape, spec: Spec, ctx: ShardingCtx) -> Tuple[int, ...]:
    """The shape of a rank's block of a tensor of ``shape`` under
    ``spec`` (every rank's is the same: the port does not pad)."""
    return tuple(n if a is None else n // ctx.mesh.size(a)
                 for n, a in zip(shape, spec))


def copies(spec: Spec, ctx: ShardingCtx) -> int:
    """How many ranks hold each block of a tensor under ``spec``: the
    product of the sizes of the mesh axes it leaves out."""
    used = _axes(spec)
    return ctx.mesh.size(tuple(a for a in ctx.mesh.axis_names
                               if a not in used))


def reduce_grads(grads: Dict[str, torch.Tensor], ctx: ShardingCtx
                 ) -> Dict[str, torch.Tensor]:
    """After a backward on the mesh: the gradients (``{state_dict name:
    this rank's block}``) of parameters whose spec has no dp axis (norm
    scales, biases, the MoE's router ``(None, None)``, the Mamba mixer's
    tp-only ``conv_w``, ``conv_b``, ``x_proj``, ``dt_proj``, ``dt_bias``,
    ``A_log`` and ``D``) summed over dp, in fp32 and rounded once, in one
    collective; the rest (reduce-scattered over dp by their gathers'
    backward: the dense kinds and the experts ``(tp, dp, None)`` and
    ``(tp, None, dp)``) as they are.  Nothing is summed over tp: a
    tp-replicated parameter's gradient (a norm scale, the router) is
    already the same on every model rank, and a tp-sharded one is the
    rank's block's.  Returns a new dict."""
    dp = set(ctx.dp if isinstance(ctx.dp, tuple) else (ctx.dp,))
    names = [k for k, g in grads.items()
             if not dp & _axes(spec_for(k, g.dim(), ctx))]
    out = dict(grads)
    if not names or ctx.dp_size == 1:
        return out
    flat = ctx.mesh.all_reduce(torch.cat([grads[k].float().reshape(-1)
                                          for k in names]), ctx.dp)
    for k, part in zip(names, flat.split([grads[k].numel()
                                          for k in names])):
        out[k] = part.reshape(grads[k].shape).to(grads[k].dtype)
    return out


def global_norm(grads: Dict[str, torch.Tensor], ctx: ShardingCtx
                ) -> torch.Tensor:
    """The global norm of gradients held as blocks (``{state_dict name:
    this rank's block}``, after :func:`reduce_grads`): each block's fp32
    sum of squares divided by its :func:`copies`, summed over the
    tensors and over every rank, square-rooted: each block counts once
    whatever its kind (an expert block, held by its dp-and-tp rank alone,
    has 1 copy; the router, on every rank, ``dp * tp``; a tp-only Mamba
    block ``dp``).  Every rank gets the same 0-d fp32 value, the
    unsharded ``optim.adamw.global_norm``'s up to the order of
    summation."""
    total = sum(torch.sum(torch.square(g.float()))
                / copies(spec_for(k, g.dim(), ctx), ctx)
                for k, g in grads.items())
    axes = tuple(ctx.mesh.axis_names)
    return torch.sqrt(ctx.mesh.all_reduce(total.reshape(1), axes)[0])
