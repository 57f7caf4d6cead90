"""Shape and sharding specs for sharded serving, training and the
dry-run (the JAX package's ``launch/specs.py``): the parameters' shapes
and specs (``params_shape``, ``sharded_params_specs``, :27-33), the
train state's blocks (``train_state_struct``, :37), a cell's inputs
(``batch_dim_spec``, ``batch_struct``, :65-80) and the decode caches'
layout (``_cache_leaf_spec``/``cache_struct``, :82-118).  Nothing here
allocates: shapes come from a model built on the ``meta`` device.

A KV cache ``(B, S_max, Hkv, D)`` keeps its batch as the batch is laid
out (:func:`batch_dim_spec`) and shards its sequence axis: over tp when
the batch is sharded over dp, else over every axis, dp's then tp's (the
small-batch long-context layout), so that every rank holds one slice of
the positions and all heads.  Unlike GSPMD the port does not pad uneven
shards: a rank's slice is ``ceil(S_max / n)`` positions and the cache
holds ``n`` slices (the positions past ``S_max`` are never attended).
An SSM layer's state keeps its batch likewise and shards ``d_inner``
over tp: the conv history ``(B, K-1, d_inner)`` and the recurrent state
``(B, d_inner, N)``.  A train state's params, m, v and master are
sharded by the parameters' specs, its step replicated.  A cell's inputs
keep the reference's specs (the batch over dp where it divides), though
every rank is handed the whole batch and cuts its own rows
(``distributed.tp.local_batch``).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch

from ..distributed.sharding import ShardingCtx, Spec, block_shape, spec_for


class Leaf(NamedTuple):
    """A cache leaf's global shape and spec."""
    shape: Tuple[int, ...]
    spec: Spec


class KVStruct(NamedTuple):
    k: Leaf
    v: Leaf


class SSMStruct(NamedTuple):
    conv: Leaf
    ssm: Leaf


class BatchLeaf(NamedTuple):
    """A cell's input: its global shape (every rank is handed all of
    it), its dtype and the spec the program cuts it by."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Spec


def params_shape(cfg) -> Dict[str, torch.Tensor]:
    """The model's parameters as meta tensors (no allocation):
    ``{state_dict name: tensor}``; ``repro_torch.convert`` maps the names
    to the reference's tree."""
    from ..models.transformer import Transformer
    return dict(Transformer(cfg, device="meta").state_dict())


def sharded_params_specs(cfg, ctx: ShardingCtx
                         ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Spec]]:
    """:func:`params_shape` and each parameter's spec
    (``sharding.spec_for``, the reference's rules)."""
    ps = params_shape(cfg)
    return ps, {k: spec_for(k, t.dim(), ctx) for k, t in ps.items()}


def batch_dim_spec(B: int, ctx: ShardingCtx):
    """Shard the batch over dp when divisible, else replicate."""
    return ctx.dp if B % ctx.dp_size == 0 else None


def batch_struct(cfg, shape: dict, ctx: ShardingCtx) -> Dict[str, BatchLeaf]:
    """A cell's inputs (``data.pipeline.lm_input_specs``) with their specs:
    the batch dimension by :func:`batch_dim_spec`, the rest whole."""
    from ..data.pipeline import lm_input_specs
    bspec = batch_dim_spec(shape["global_batch"], ctx)
    return {name: BatchLeaf(tuple(t.shape), t.dtype,
                            (bspec,) + (None,) * (t.dim() - 1))
            for name, t in lm_input_specs(cfg, shape).items()}


def cache_seq_axes(B: int, ctx: ShardingCtx):
    """The axes a KV cache's sequence is sharded over: tp when the batch
    covers dp, else dp's axes then tp."""
    if B % ctx.dp_size == 0:
        return ctx.tp
    dp = ctx.dp if isinstance(ctx.dp, tuple) else (ctx.dp,)
    return dp + (ctx.tp,)


def kv_cache_spec(B: int, ctx: ShardingCtx) -> Spec:
    """The spec of a KV cache ``(B, S_max, Hkv, D)``."""
    return (batch_dim_spec(B, ctx), cache_seq_axes(B, ctx), None, None)


def ssm_state_specs(B: int, ctx: ShardingCtx) -> Tuple[Spec, Spec]:
    """The specs of an SSM layer's conv history ``(B, K-1, d_inner)`` and
    state ``(B, d_inner, N)``: the batch as laid out, ``d_inner`` over
    tp."""
    bspec = batch_dim_spec(B, ctx)
    return (bspec, None, ctx.tp), (bspec, ctx.tp, None)


def cache_struct(cfg, B: int, S_max: int, ctx: ShardingCtx
                 ) -> List[Union[KVStruct, SSMStruct]]:
    """For each layer, its cache's leaves as (global shape, spec): a
    :class:`KVStruct` (k and v alike) for an attention layer, an
    :class:`SSMStruct` for an SSM layer."""
    out = []
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) == "attn":
            kv = Leaf((B, S_max, cfg.n_kv_heads, cfg.head_dim),
                      kv_cache_spec(B, ctx))
            out.append(KVStruct(kv, kv))
        else:
            out.append(SSMStruct(*(Leaf(shape, spec) for shape, spec in zip(
                ssm_state_shapes(cfg, B), ssm_state_specs(B, ctx)))))
    return out


def seq_shard(B: int, S_max: int, ctx: ShardingCtx) -> Tuple[int, int, int]:
    """``(n, index, S_loc)``: the number of sequence slices of a KV cache,
    this rank's slice and its length ``ceil(S_max / n)``."""
    axes = cache_seq_axes(B, ctx)
    n = ctx.mesh.size(axes)
    return n, ctx.mesh.index(axes), -(-S_max // n)


def local_kv_shape(cfg, B: int, S_max: int, ctx: ShardingCtx
                   ) -> Tuple[int, int, int, int]:
    """This rank's block of a KV cache: its batch rows, its slice of
    positions, every KV head."""
    rows = B // ctx.dp_size if batch_dim_spec(B, ctx) is not None else B
    return rows, seq_shard(B, S_max, ctx)[2], cfg.n_kv_heads, cfg.head_dim


def ssm_state_shapes(cfg, B: int, ctx: Optional[ShardingCtx] = None
                     ) -> Tuple[Tuple[int, int, int], Tuple[int, int, int]]:
    """The shapes of an SSM layer's conv history ``(B, K-1, d_inner)`` and
    state ``(B, d_inner, N)``; with ``ctx`` this rank's blocks of them:
    its batch rows and its ``d_inner/tp`` channels."""
    rows, di = B, cfg.d_inner
    if ctx is not None:
        rows = B // ctx.dp_size if batch_dim_spec(B, ctx) is not None else B
        di //= ctx.tp_size
    return (rows, cfg.ssm_conv - 1, di), (rows, di, cfg.ssm_state)


class StateLeaf(NamedTuple):
    """A train-state leaf on one rank: its block's shape, its dtype and
    the spec it is cut by."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Spec


def train_state_struct(cfg, ctx: ShardingCtx, opt_cfg
                       ) -> Dict[str, Dict[str, object]]:
    """What every rank's train state (``launch.train.init_state(...,
    ctx=ctx)``) holds, without allocating: ``{"params": {name:
    StateLeaf}, "opt": {"m", "v"[, "master"]: {name: StateLeaf}, "step":
    StateLeaf}}``.  Params, m, v and master are the rank's blocks under
    the parameters' specs (``sharding.spec_for``), in the parameters'
    dtype, ``opt_cfg.state_dtype`` and ``opt_cfg.master_dtype``; the step
    is a replicated 0-d int32 (the reference's ``train_state_struct``)."""
    ps, pspecs = sharded_params_specs(cfg, ctx)

    def leaves(dtype=None):
        return {name: StateLeaf(block_shape(p.shape, pspecs[name], ctx),
                                dtype or p.dtype, pspecs[name])
                for name, p in ps.items()}

    opt = {"m": leaves(getattr(torch, opt_cfg.state_dtype)),
           "v": leaves(getattr(torch, opt_cfg.state_dtype)),
           "step": StateLeaf((), torch.int32, ())}
    if opt_cfg.master_dtype is not None:
        opt["master"] = leaves(getattr(torch, opt_cfg.master_dtype))
    return {"params": leaves(), "opt": opt}
