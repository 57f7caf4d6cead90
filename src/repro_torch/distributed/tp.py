"""Tensor-parallel primitives over the LM mesh, with the collectives
written out (GSPMD inserts them in the JAX package).

Each takes this rank's blocks, as ``repro_torch.distributed.sharding``
lays them out, and returns this rank's block of the result.  The batch
is sharded over dp when ``B % dp_size == 0``, else every rank holds all
of it (:func:`batch_sharded`, the reference's ``_bspec``).

``collectives`` chooses how the model group sums row-parallel partial
products: ``"manual"`` in the activation dtype (the reference's
``psum(part.astype(x.dtype))``, ``tp.py``), ``"gspmd"`` in fp32 and
then cast, which is what GSPMD does with the fp32 dot outputs (the
reference's docstring, :3-6).  The 2-D forms (``*_2dtp``), the
reference's decode path under ``"manual"``, move activations instead of
weights.

Owner computes: the weight shard never moves across the model axis; only
partial activations are combined there.
"""
from __future__ import annotations

import torch

from .sharding import ShardingCtx

COLLECTIVES = ("gspmd", "manual")


def batch_sharded(B: int, ctx: ShardingCtx) -> bool:
    """Whether a batch of ``B`` is sharded over dp (else replicated)."""
    return B % ctx.dp_size == 0


def local_batch(x: torch.Tensor, ctx: ShardingCtx) -> torch.Tensor:
    """This rank's rows of a batch every rank holds whole."""
    B = x.shape[0]
    if not batch_sharded(B, ctx):
        return x
    n = B // ctx.dp_size
    return x.narrow(0, ctx.dp_index * n, n)


def psum_tp(part: torch.Tensor, ctx: ShardingCtx,
            collectives: str = "manual") -> torch.Tensor:
    """``part`` summed over the model group: in its own dtype
    (``"manual"``), or in fp32 and cast back (``"gspmd"``)."""
    if collectives == "manual":
        return ctx.mesh.all_reduce(part, ctx.tp)
    if collectives != "gspmd":
        raise ValueError(f"collectives must be one of {COLLECTIVES}, got "
                         f"{collectives!r}")
    return ctx.mesh.all_reduce(part.float(), ctx.tp).to(part.dtype)


def _add_bias(y, bias):
    return y if bias is None else y + bias


def gather_weight(w: torch.Tensor, ctx: ShardingCtx, dim: int
                  ) -> torch.Tensor:
    """An FSDP weight block whole along ``dim`` (gathered over dp)."""
    return ctx.mesh.all_gather(w, ctx.dp, dim=dim)


def col_parallel_dense(x, w, ctx: ShardingCtx, bias=None):
    """``y = x @ w`` with the output dim sharded over the model axis.

    x: (B, S, d), this rank's batch; w: (d/dp, out/tp) sharded
    ``(dp, tp)``, gathered over dp; bias: (out/tp,).  Returns (B, S,
    out/tp)."""
    return _add_bias(x @ gather_weight(w, ctx, 0), bias)


def row_parallel_dense(x, w, ctx: ShardingCtx, bias=None, *,
                       collectives: str = "manual"):
    """``y = x @ w`` with the contraction dim sharded over the model axis.

    x: (B, S, f/tp); w: (f/tp, d/dp) sharded ``(tp, dp)``, gathered over
    dp; the partials summed over tp (:func:`psum_tp`); bias (d,) whole.
    Returns (B, S, d)."""
    part = x @ gather_weight(w, ctx, 1)
    return _add_bias(psum_tp(part, ctx, collectives), bias)


def col_parallel_dense_2dtp(x, w, ctx: ShardingCtx, bias=None, *,
                            sharded: bool):
    """The decode path's column-parallel matmul with both mesh axes as
    tensor axes: the activations move, not the weights.

    x: (B, S, d) this rank's batch (``sharded``: a dp shard of it, else
    all of it); w: (d/dp, out/tp) sharded ``(dp, tp)``.  x is gathered
    over dp (when sharded), each rank contracts its d/dp slice against its
    weight block for the whole batch, and the partials are summed over
    dp, each rank keeping its batch rows (reduce-scatter), in x's dtype.
    Returns (B, S, out/tp)."""
    x_full = ctx.mesh.all_gather(x, ctx.dp, dim=0) if sharded else x
    d_loc = w.shape[0]
    x_me = x_full.narrow(2, ctx.dp_index * d_loc, d_loc)
    part = torch.einsum("bsd,do->bso", x_me, w)
    if sharded:
        y = ctx.mesh.reduce_scatter(part, ctx.dp, dim=0)
    else:
        y = ctx.mesh.all_reduce(part, ctx.dp)
    return _add_bias(y, bias)


def row_parallel_dense_2dtp(x, w, ctx: ShardingCtx, bias=None, *,
                            sharded: bool):
    """The decode path's row-parallel matmul, with no weight movement.

    x: (B, S, f/tp) this rank's batch (``sharded`` as above); w: (f/tp,
    d/dp) sharded ``(tp, dp)``.  x is gathered over dp (when sharded),
    each rank contracts its f slice against its (f/tp, d/dp) block for the
    whole batch, the partials are summed over tp in x's dtype, and an
    all-to-all over dp trades the d blocks for the batch blocks (a
    gather of d when the batch is replicated).  Returns (B, S, d)."""
    x_full = ctx.mesh.all_gather(x, ctx.dp, dim=0) if sharded else x
    part = torch.einsum("bsf,fd->bsd", x_full, w)
    part = ctx.mesh.all_reduce(part, ctx.tp)              # (B, S, d/dp)
    return _add_bias(_trade_d_for_batch(part, ctx, sharded), bias)


def swiglu_sharded(p, h, ctx: ShardingCtx, *, collectives: str,
                   batch=None):
    """A SwiGLU (``p.gate``, ``p.up``, ``p.down``: ``layers.SwiGLU``'s
    blocks) with column-parallel gate and up and a row-parallel down,
    whose partials ``collectives`` sums.  In decode (``batch``, the whole
    batch's size, given) under ``"manual"``, the 2-D forms: no weight
    moves (the reference's ``_swiglu``, ``transformer.py:147-165``)."""
    silu = torch.nn.functional.silu
    if batch is not None and collectives == "manual":
        sharded = batch_sharded(batch, ctx)
        g, u = (col_parallel_dense_2dtp(h, lin.w, ctx, lin.b,
                                        sharded=sharded)
                for lin in (p.gate, p.up))
        return row_parallel_dense_2dtp(silu(g) * u, p.down.w, ctx,
                                       p.down.b, sharded=sharded)
    g, u = (col_parallel_dense(h, lin.w, ctx, lin.b)
            for lin in (p.gate, p.up))
    return row_parallel_dense(silu(g) * u, p.down.w, ctx, p.down.b,
                              collectives=collectives)


def _trade_d_for_batch(part, ctx: ShardingCtx, sharded: bool):
    """(B, S, d/dp) for the whole batch -> this rank's (B/dp, S, d): an
    all-to-all over dp when the batch is sharded, else a gather of d."""
    if not sharded:
        return ctx.mesh.all_gather(part, ctx.dp, dim=2)
    n = ctx.dp_size
    B, S, d_loc = part.shape
    got = ctx.mesh.all_to_all(part.reshape(n, B // n, S, d_loc), ctx.dp)
    return got.permute(1, 2, 0, 3).reshape(B // n, S, n * d_loc)


def _lookup(table_loc, tokens, ctx: ShardingCtx):
    """Rows of a vocabulary shard for ``tokens``: zero where a token lies
    in another rank's shard."""
    V_loc = table_loc.shape[0]
    local = tokens - ctx.tp_index * V_loc
    valid = (local >= 0) & (local < V_loc)
    emb = table_loc[torch.clamp(local, 0, V_loc - 1)]
    return emb * valid[..., None].to(emb.dtype)


def vocab_parallel_embed(table, tokens, ctx: ShardingCtx):
    """Embedding lookup over a vocab-sharded table, summed over the model
    axis in the table's dtype (exact: one rank holds each row).

    table: (V/tp, d/dp) sharded ``(tp, dp)``, gathered over dp; tokens:
    (B, S) this rank's batch.  Returns (B, S, d)."""
    emb = _lookup(gather_weight(table, ctx, 1), tokens, ctx)
    return ctx.mesh.all_reduce(emb, ctx.tp)


def vocab_parallel_embed_2dtp(table, tokens, ctx: ShardingCtx):
    """The decode path's lookup with no weight movement: each rank looks
    up the whole batch's ``tokens`` (B, S) in its (V/tp, d/dp) block,
    the model axis sums the blocks (exact), and an all-to-all over dp
    trades the d blocks for this rank's batch rows (a gather of d when
    the batch is replicated).  Returns (B/dp or B, S, d), as
    :func:`vocab_parallel_embed` for this rank's batch."""
    emb = ctx.mesh.all_reduce(_lookup(table, tokens, ctx), ctx.tp)
    return _trade_d_for_batch(emb, ctx, batch_sharded(tokens.shape[0], ctx))
