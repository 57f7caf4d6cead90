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
weights; they take no gradient.

Under autograd the collectives are ``torch.autograd.Function``s in
conjugate pairs (Megatron's ``f`` and ``g``; ZeRO-3's gather), so the
backward runs the collectives GSPMD derives from the reference's specs:

* :func:`copy_to_tp` (``f``): identity forward, the gradient summed over
  the model group (in fp32, rounded once) backward: a tp-replicated
  activation entering tp-local work (every column-parallel product);
* :func:`psum_tp` (``g``): the sum over the model group forward,
  identity backward;
* :func:`gather_weight`: an FSDP block gathered over dp forward, the
  gradient reduce-scattered over dp (in fp32, rounded once) backward;
* :func:`gather_tp`: its counterpart over the model axis, for the
  column slices of a KV head that several model ranks share (the
  gradient of each slice summed over the ranks that used it);
* :func:`vocab_parallel_embed`: its lookup's gradient sums each local
  row's occurrences in fp32, as ``layers._Embed`` does, reduce-scatters
  the rows the batch touched over dp and rounds once.

With ``f`` and ``g`` so placed, the gradient of a tp-replicated value is
the same on every model rank, and every tp-sharded weight gets its
block's gradient.  Gradients of parameters that no gather covers (specs
without a dp axis) are summed over dp after the backward
(``sharding.reduce_grads``).

Owner computes: the weight shard never moves across the model axis; only
partial activations are combined there.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.autograd import Function

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


class _CopyTp(Function):
    """``f``: identity; the gradient summed over tp in fp32."""

    @staticmethod
    def forward(ctx, x, sc: ShardingCtx):
        ctx.sc = sc
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.sc.mesh.all_reduce(g.float(), ctx.sc.tp).to(g.dtype), None


class _SumTp(Function):
    """``g``: the sum over tp (in fp32 when ``fp32``); identity
    backward."""

    @staticmethod
    def forward(ctx, part, sc: ShardingCtx, fp32: bool):
        src = part.float() if fp32 else part
        return sc.mesh.all_reduce(src, sc.tp).to(part.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherDp(Function):
    """An FSDP gather over dp along ``dim``; the gradient reduce-scattered
    over dp in fp32 and rounded once."""

    @staticmethod
    def forward(ctx, w, sc: ShardingCtx, dim: int):
        ctx.sc, ctx.dim = sc, dim
        return sc.mesh.all_gather(w, sc.dp, dim=dim)

    @staticmethod
    def backward(ctx, g):
        sc = ctx.sc
        return (sc.mesh.reduce_scatter(g.float(), sc.dp, dim=ctx.dim)
                .to(g.dtype), None, None)


class _GatherTp(Function):
    """A gather over tp along ``dim``; the gradient reduce-scattered over
    tp in fp32 and rounded once."""

    @staticmethod
    def forward(ctx, x, sc: ShardingCtx, dim: int):
        ctx.sc, ctx.dim = sc, dim
        return sc.mesh.all_gather(x, sc.tp, dim=dim)

    @staticmethod
    def backward(ctx, g):
        sc = ctx.sc
        return (sc.mesh.reduce_scatter(g.float(), sc.tp, dim=ctx.dim)
                .to(g.dtype), None, None)


def copy_to_tp(x: torch.Tensor, ctx: ShardingCtx) -> torch.Tensor:
    """``x`` (tp-replicated) entering tp-local work: itself forward, its
    gradient summed over the model group backward (``f``)."""
    return _CopyTp.apply(x, ctx)


def psum_tp(part: torch.Tensor, ctx: ShardingCtx,
            collectives: str = "manual") -> torch.Tensor:
    """``part`` summed over the model group: in its own dtype
    (``"manual"``), or in fp32 and cast back (``"gspmd"``); the gradient
    passes unchanged to every rank's part (``g``)."""
    if collectives not in COLLECTIVES:
        raise ValueError(f"collectives must be one of {COLLECTIVES}, got "
                         f"{collectives!r}")
    return _SumTp.apply(part, ctx, collectives == "gspmd")


def _add_bias(y, bias):
    return y if bias is None else y + bias


def gather_weight(w: torch.Tensor, ctx: ShardingCtx, dim: int
                  ) -> torch.Tensor:
    """An FSDP weight block whole along ``dim`` (gathered over dp); its
    gradient is reduce-scattered back over dp."""
    return _GatherDp.apply(w, ctx, dim)


def gather_tp(x: torch.Tensor, ctx: ShardingCtx, dim: int) -> torch.Tensor:
    """Every model rank's ``x`` concatenated along ``dim`` in rank order;
    the gradient of the whole is reduce-scattered back over tp, so each
    rank's block gets the sum of what every rank's use of it gave."""
    return _GatherTp.apply(x, ctx, dim)


def col_parallel_many(x, lins, ctx: ShardingCtx):
    """:func:`col_parallel_dense` of one ``x`` by several ``(w, bias)``
    pairs, ``x`` entering the model group once (one sum of its gradient
    over tp)."""
    x = copy_to_tp(x, ctx)
    return [_add_bias(x @ gather_weight(w, ctx, 0), b) for w, b in lins]


def col_parallel_dense(x, w, ctx: ShardingCtx, bias=None):
    """``y = x @ w`` with the output dim sharded over the model axis.

    x: (B, S, d), this rank's batch; w: (d/dp, out/tp) sharded
    ``(dp, tp)``, gathered over dp; bias: (out/tp,).  Returns (B, S,
    out/tp).  ``x`` is tp-replicated and enters through
    :func:`copy_to_tp`."""
    return col_parallel_many(x, [(w, bias)], ctx)[0]


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
    whose partials ``collectives`` sums; ``h`` enters the model group
    once (:func:`col_parallel_many`).  In decode (``batch``, the whole
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
    g, u = col_parallel_many(h, [(lin.w, lin.b) for lin in (p.gate, p.up)],
                             ctx)
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


def _union_over_dp(rows: torch.Tensor, ctx: ShardingCtx,
                   sizes=None) -> torch.Tensor:
    """The sorted union of every dp rank's sorted int64 ``rows`` (their
    counts, then the rows padded with -1 to the largest, gathered).  On
    the meta device ``sizes`` gives what the data would: ``(the largest
    count, the union's size)``."""
    if ctx.dp_size == 1:
        return rows
    n = ctx.mesh.all_gather(torch.tensor([rows.numel()], device=rows.device),
                            ctx.dp)
    most = int(n.max()) if sizes is None else sizes[0]
    pad = torch.full((max(most, 1),), -1, dtype=rows.dtype,
                     device=rows.device)
    pad[:rows.numel()] = rows
    every = ctx.mesh.all_gather(pad, ctx.dp)
    if sizes is not None:
        return every.new_empty(sizes[1])
    return torch.unique(every[every >= 0])


def _dry_rows(tokens: Optional[np.ndarray], B_loc: int, S: int, V_loc: int,
              ctx: ShardingCtx):
    """For a trace on the meta device: ``(this rank's tokens in its
    vocabulary shard, each dp rank's count of distinct rows there, the
    size of their union)`` for the global (micro)batch of token ids
    ``tokens`` (every rank's rows, as :func:`local_batch` cuts them);
    without them, a bound: every one of the rank's ``B_loc x S`` tokens
    in its shard, all distinct, on every dp rank."""
    dp, t = ctx.dp_size, ctx.tp_index
    if tokens is None:
        n = min(V_loc, B_loc * S)
        return B_loc * S, [n] * dp, min(V_loc, dp * n)
    B = tokens.shape[0]
    step = B // dp if B % dp == 0 else B
    sets = []
    for d in range(dp):
        rows = tokens[d * step:(d + 1) * step] if B % dp == 0 else tokens
        local = rows.reshape(-1).astype(np.int64) - t * V_loc
        sets.append(local[(local >= 0) & (local < V_loc)])
    me = sets[ctx.dp_index]
    return (me.size, [np.unique(x).size for x in sets],
            np.unique(np.concatenate(sets)).size)


class _VocabEmbed(Function):
    """The lookup in a (V/tp, d/dp) block gathered over dp (zero rows for
    other ranks' tokens).  The gradient sums each local row's occurrences
    in fp32 (``layers._Embed``'s arithmetic), reduce-scatters the sums
    over dp and rounds once; only the rows some dp rank of the model
    column looked up have a gradient, so only they are reduce-scattered
    (the batch's tokens, not the (V/tp, d) block GSPMD would move).
    Those rows are the one shape the program takes from its data: on the
    meta device (``launch.mesh.DryMesh``) the forward takes the batch's
    token ids from the mesh and the backward computes their counts on
    the host (:func:`_dry_rows`)."""

    @staticmethod
    def forward(ctx, table, tokens, sc: ShardingCtx):
        full = sc.mesh.all_gather(table, sc.dp, dim=1)
        ctx.sc, ctx.shape = sc, full.shape
        ctx.save_for_backward(tokens)
        if tokens.is_meta and ctx.needs_input_grad[0]:
            ctx.dry = sc.mesh.take_tokens()
        return _lookup(full, tokens, sc)

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        sc, (V_loc, d) = ctx.sc, ctx.shape
        local = (tokens - sc.tp_index * V_loc).reshape(-1)
        if tokens.is_meta:
            n_mine, counts, union = _dry_rows(ctx.dry, *tokens.shape, V_loc,
                                              sc)
            mine = local.new_empty(n_mine)
            rows = _union_over_dp(local.new_empty(counts[sc.dp_index]), sc,
                                  (max(counts), union))
        else:
            mine = (local >= 0) & (local < V_loc)
            rows = _union_over_dp(torch.unique(local[mine]), sc)
        sums = torch.zeros((rows.numel(), d), dtype=torch.float32,
                           device=g.device)
        sums.index_put_((torch.searchsorted(rows, local[mine]),),
                        g.reshape(-1, d)[mine].float(), accumulate=True)
        part = sc.mesh.reduce_scatter(sums, sc.dp, dim=1)
        grad = torch.zeros((V_loc, part.shape[1]), dtype=g.dtype,
                           device=g.device)
        grad[rows] = part.to(g.dtype)
        return grad, None, None


def vocab_parallel_embed(table, tokens, ctx: ShardingCtx):
    """Embedding lookup over a vocab-sharded table, summed over the model
    axis in the table's dtype (exact: one rank holds each row).

    table: (V/tp, d/dp) sharded ``(tp, dp)``, gathered over dp; tokens:
    (B, S) this rank's batch.  Returns (B, S, d).  Differentiable in
    ``table`` (:class:`_VocabEmbed`)."""
    return psum_tp(_VocabEmbed.apply(table, tokens, ctx), ctx, "manual")


class _VocabXent(Function):
    """Per-token cross-entropy ``(B, S)`` fp32 of vocab-sharded logits;
    the backward is ``(softmax - onehot) * g`` on the rank's columns."""

    @staticmethod
    def forward(ctx, logits, labels, sc: ShardingCtx, ignore_index: int):
        z = logits.float()
        V_loc = z.shape[-1]
        m = sc.mesh.all_reduce(z.amax(-1), sc.tp, op="max")
        e = torch.exp(z - m[..., None])
        valid = labels != ignore_index
        local = labels - sc.tp_index * V_loc
        mine = valid & (local >= 0) & (local < V_loc)
        local = torch.where(mine, local, 0)
        gold = torch.gather(z, -1, local[..., None].long())[..., 0]
        del z
        sums = sc.mesh.all_reduce(torch.stack(
            [e.sum(-1), torch.where(mine, gold, 0.0)]), sc.tp)
        losses = torch.where(valid, m + torch.log(sums[0]) - sums[1], 0.0)
        e.div_(sums[0][..., None])
        ctx.save_for_backward(e, local, mine, valid)
        ctx.dtype = logits.dtype
        return losses

    @staticmethod
    def backward(ctx, g):
        p, local, mine, valid = ctx.saved_tensors
        g = torch.where(valid, g, 0.0)
        grad = p * g[..., None]
        grad.scatter_add_(-1, local[..., None].long(),
                          -torch.where(mine, g, 0.0)[..., None])
        return grad.to(ctx.dtype), None, None, None


def vocab_parallel_cross_entropy(logits, labels, ctx: ShardingCtx, *,
                                 sharded: bool, ignore_index: int = -100):
    """The mean token cross-entropy of a batch whose logits are sharded
    over the vocabulary (``layers.cross_entropy`` of the whole logits),
    without gathering the vocabulary: the max over tp (no gradient
    through it), the sum of exponentials and the gold logit (a masked
    local pick) summed over tp, in fp32; token sums and valid counts
    summed over dp.

    logits: (B_loc, S, V/tp) this rank's block; labels: (B_loc, S) its
    rows; ``sharded``: whether the batch is sharded over dp (else every
    dp rank holds all of it).  Returns ``(share, xent)``: ``xent`` the
    global mean (no gradient), ``share`` this rank's part of it, whose
    sum over dp is ``xent``: its token sum over the global count when
    sharded, ``xent / dp`` when replicated, so that the gradients summed
    over dp are the global mean's."""
    losses = _VocabXent.apply(logits, labels, ctx, ignore_index)
    tot = losses.sum()
    stats = torch.stack([tot.detach(),
                         (labels != ignore_index).sum().float()])
    if sharded:
        stats = ctx.mesh.all_reduce(stats, ctx.dp)
    count = torch.clamp(stats[1], min=1)
    share = tot / count
    if not sharded:
        share = share / ctx.dp_size
    return share, stats[0] / count


def vocab_parallel_embed_2dtp(table, tokens, ctx: ShardingCtx):
    """The decode path's lookup with no weight movement: each rank looks
    up the whole batch's ``tokens`` (B, S) in its (V/tp, d/dp) block,
    the model axis sums the blocks (exact), and an all-to-all over dp
    trades the d blocks for this rank's batch rows (a gather of d when
    the batch is replicated).  Returns (B/dp or B, S, d), as
    :func:`vocab_parallel_embed` for this rank's batch."""
    emb = ctx.mesh.all_reduce(_lookup(table, tokens, ctx), ctx.tp)
    return _trade_d_for_batch(emb, ctx, batch_sharded(tokens.shape[0], ctx))
