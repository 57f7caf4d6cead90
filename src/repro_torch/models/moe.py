"""Mixture-of-Experts FFN with capacity-based dispatch, on one device.

Routing, dispatch, the expert products and the combine are torch ops, as
they are XLA ops (not Pallas) in the JAX package: an fp32 router and
softmax, the top ``k`` experts of each token renormalised, ranks within
each expert by a stable sort (``_ranks_by_sort``), a capacity of
``C = ceil(T k / E * capacity_factor)`` slots an expert (entries past it
are dropped: their combine weight is zero), the experts as batched
matrix products over an ``(E, C, d)`` buffer, and a Switch-style
load-balance loss with the dropped share as diagnostics.

Where the reference leaves an order to XLA, the port fixes it so that
the result does not depend on the device:
- the top ``k`` comes from a stable descending sort, so equal
  probabilities (a zero row of ``x`` makes every logit equal) keep the
  lower expert first, as ``jax.lax.top_k`` does; ``torch.topk`` makes no
  such promise;
- the dispatch writes each kept entry to its own ``(expert, slot)``
  once, by indexing, and the dropped ones to a spare slot that is cut
  off (the reference adds zeros into a clipped slot, which leaves the
  same values); nothing waits on the device for a count;
- the combine sums each token's ``k`` contiguous entries with
  ``view(T, k, d).sum(1)``, not an atomic ``index_add_``; in bf16 it
  accumulates in fp32 and rounds once, where XLA's ``segment_sum`` rounds
  after each add (``tests/test_torch_moe.py`` states the tolerance);
- the dispatch counts are exact: an integer ``scatter_add_`` (a
  ``bincount`` on the card would read its maximum back to the host).

With a sharding context (``ctx``) the layer is expert-parallel, as the
reference's ``shard_map`` branch (``src/repro/models/moe.py:122-166``):
no token moves.  The tokens are the rank's batch rows, the same on every
model rank; each model rank owns ``E/tp`` experts (their weights its
blocks, gathered over dp before use: FSDP), routes all of its tokens
with the replicated router, computes its own experts' entries and the
model group sums the partial outputs in the activation dtype under
either ``tp_collectives``, as the reference's ``psum`` does.  The
capacity counts the rank's tokens, so a sharded layer drops entries per
dp shard: it equals the unsharded layer on each dp shard's rows, and its
aux loss is the mean over dp of each shard's.  Under autograd the
gradients are the reference's ``shard_map`` transpose's (:func:`moe_apply`
says where the collectives sit).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import layers
from ..distributed import tp


class MoE(nn.Module):
    """The weights: ``router`` (a ``Dense`` ``(d, E)`` kept in fp32
    whatever the model's dtype), ``gate`` and ``up`` ``(E, d, ff)``,
    ``down`` ``(E, ff, d)``, and ``shared`` (a ``SwiGLU`` of width
    ``n_shared_experts * ff``) when the config has shared experts: the
    reference's parameter names, flattened."""

    def __init__(self, cfg, *, dtype=None, device=None):
        super().__init__()
        d, E, ff = cfg.d_model, cfg.n_experts, cfg.d_expert
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.router = layers.Dense(d, E, dtype=torch.float32, device=device)
        self.gate = layers._param(torch.empty((E, d, ff), **kw))
        self.up = layers._param(torch.empty((E, d, ff), **kw))
        self.down = layers._param(torch.empty((E, ff, d), **kw))
        self.shared = (layers.SwiGLU(d, cfg.n_shared_experts * ff, **kw)
                       if cfg.n_shared_experts else None)

    def reset_parameters(self, generator=None) -> None:
        d, ff = self.cfg.d_model, self.cfg.d_expert
        self.router.reset_parameters(generator)
        layers.truncated_normal_(self.gate, 1.0 / d ** 0.5, generator)
        layers.truncated_normal_(self.up, 1.0 / d ** 0.5, generator)
        layers.truncated_normal_(self.down, 1.0 / ff ** 0.5, generator)
        if self.shared is not None:
            self.shared.reset_parameters(generator)


def moe_init(generator, cfg, dtype, device=None) -> MoE:
    p = MoE(cfg, dtype=dtype, device=device)
    p.reset_parameters(generator)
    return p


def _ranks_by_sort(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """Rank of each entry within its expert group (0-based, in entry
    order), via a stable argsort: ``O(Tk log Tk)``, no ``(T, E)``
    one-hot."""
    Tk = flat_e.shape[0]
    perm = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[perm]
    idx = torch.arange(Tk, device=flat_e.device)
    is_start = torch.ones(Tk, dtype=torch.bool, device=flat_e.device)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    group_start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    rank = torch.empty_like(idx)
    rank[perm] = idx - group_start
    return rank


def route(x2d: torch.Tensor, router_w: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(probs (T, E) fp32, topw (T, k) renormalised, topi (T, k))``:
    the top ``k`` of each row by a stable descending sort, so ties keep
    the lower expert index first (``jax.lax.top_k``'s order)."""
    logits = x2d.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    topi = torch.sort(probs, dim=-1, descending=True,
                      stable=True).indices[:, :k]
    topw = probs.gather(-1, topi)
    return probs, topw / topw.sum(-1, keepdim=True), topi


def capacity(T: int, cfg) -> int:
    """Slots an expert for a call of ``T`` tokens: ``ceil(T k / E *
    capacity_factor)``, at least 1."""
    return max(1, math.ceil(T * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor))


def routes(x2d: torch.Tensor, router_w: torch.Tensor, cfg
           ) -> Tuple[torch.Tensor, ...]:
    """The dispatch policy of a call of ``T = x2d.shape[0]`` tokens:
    ``(probs, topw, topi, rank, kept)``, :func:`route`'s three, each
    entry's rank within its expert ``(T, k)`` (:func:`_ranks_by_sort`, in
    token order) and whether that rank is within :func:`capacity`."""
    probs, topw, topi = route(x2d, router_w, cfg.top_k)
    rank = _ranks_by_sort(topi.reshape(-1), cfg.n_experts).view_as(topi)
    return probs, topw, topi, rank, rank < capacity(x2d.shape[0], cfg)


def _moe_math(x2d, router_w, wg, wu, wd, cfg, e_offset, E_local,
              enter=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Route + dispatch + expert FFN + combine for experts
    ``[e_offset, e_offset + E_local)``.  Returns ``(partial_out (T, d),
    aux)``.  ``enter`` (with a ctx, ``tp.copy_to_tp``) takes the tokens
    and the combine weights into the expert path, which is the rank's
    own; the router and the aux loss take them as they are."""
    T, d = x2d.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(T, cfg)

    probs, topw, topi, rank, kept = routes(x2d, router_w, cfg)
    x_in = x2d
    if enter is not None:
        x_in, topw = enter(x2d), enter(topw)
    flat_e, rank = topi.reshape(-1), rank.reshape(-1)        # (T*k,)
    local = (flat_e >= e_offset) & (flat_e < e_offset + E_local)
    keep = kept.reshape(-1) & local
    e_loc = torch.clamp(flat_e - e_offset, 0, E_local - 1)
    slot = torch.clamp(rank, 0, C - 1)

    # each kept entry to its own (expert, slot); the others to a spare
    # slot C that is cut off: written, never accumulated, never read
    tok = torch.arange(T, device=x2d.device).repeat_interleave(k)
    buf = x2d.new_zeros((E_local, C + 1, d)).index_put(
        (e_loc, torch.where(keep, rank, C)), x_in[tok])[:, :C]
    h = torch.bmm(buf, wg)
    u = torch.bmm(buf, wu)
    y = torch.bmm(F.silu(h) * u, wd)                          # (E_l, C, d)

    weight = (topw.reshape(-1) * keep).to(y.dtype)
    out_k = y[e_loc, slot] * weight[:, None]
    partial = out_k.view(T, k, d).sum(1)

    # Switch-style load-balance aux loss + drop fraction (diagnostics)
    counts = torch.zeros(E, dtype=torch.int64, device=flat_e.device)
    frac_dispatch = counts.scatter_add_(0, flat_e, torch.ones_like(
        flat_e)).float() / T
    frac_prob = probs.mean(0)
    aux_loss = E * torch.sum(frac_dispatch * frac_prob) / k
    dropped = 1.0 - keep.sum().float() / torch.clamp(local.sum(), min=1)
    return partial.to(x2d.dtype), {"aux_loss": aux_loss, "dropped": dropped}


def moe_apply(p: MoE, x, cfg, ctx=None, *, batch=None, decode=False):
    """x: (B, S, d) -> ``((B, S, d), aux)``, aux ``{"aux_loss",
    "dropped"}`` 0-d fp32 tensors.

    Without ``ctx`` all experts are on this device.  With ``ctx``: x is
    this rank's rows of a batch of ``batch`` (the same on every model
    rank), ``p`` the rank's blocks (``gate``/``up`` ``(E/tp, d/dp, ff)``,
    ``down`` ``(E/tp, ff, d/dp)``, the router whole); the output is the
    rank's rows, whole.  ``dropped`` is averaged over the model group,
    and ``aux_loss`` and ``dropped`` over dp where the batch is sharded
    (the reference's ``pmean``s); both are metrics, without a gradient,
    and aux adds ``"aux_loss_own"``, this rank's own aux loss with its
    gradient, which the training loss takes its share of
    (``transformer.loss_and_metrics``).  The shared experts are the
    sharded SwiGLU (``tp.swiglu_sharded``; in ``decode`` under
    ``"manual"`` its 2-D forms).

    Under autograd with ``ctx`` the tokens and the combine weights enter
    the rank's experts through ``tp.copy_to_tp`` (``f``), so their
    gradients, each rank's experts' share, are summed over the model
    group; the partial outputs leave through ``tp.psum_tp`` (``g``).  The
    router and the aux loss, the same on every model rank, take no
    collective, so the router's weight gets its whole gradient on every
    model rank."""
    B, S, d = x.shape
    if ctx is None:
        out2d, aux = _moe_math(x.reshape(-1, d), p.router.w, p.gate, p.up,
                               p.down, cfg, 0, cfg.n_experts)
        out = out2d.reshape(B, S, d)
        if p.shared is not None:
            out = out + layers.swiglu(p.shared, x)
        return out, aux
    if batch is None:
        raise ValueError("moe_apply with a ctx needs batch, the whole "
                         "batch's size")
    E_local = cfg.n_experts // ctx.tp_size
    wg, wu = (tp.gather_weight(w, ctx, 1) for w in (p.gate, p.up))
    wd = tp.gather_weight(p.down, ctx, 2)
    part, aux = _moe_math(x.reshape(-1, d), p.router.w, wg, wu, wd, cfg,
                          ctx.tp_index * E_local, E_local,
                          enter=lambda t: tp.copy_to_tp(t, ctx))
    del wg, wu, wd
    out = tp.psum_tp(part, ctx, "manual").reshape(B, S, d)
    own = aux["aux_loss"]
    aux_loss = own.detach()
    dropped = ctx.mesh.all_reduce(aux["dropped"], ctx.tp) / ctx.tp_size
    if tp.batch_sharded(batch, ctx):
        both = ctx.mesh.all_reduce(torch.stack([aux_loss, dropped]),
                                   ctx.dp) / ctx.dp_size
        aux_loss, dropped = both[0], both[1]
    if p.shared is not None:
        out = out + tp.swiglu_sharded(p.shared, x, ctx,
                                      collectives=cfg.tp_collectives,
                                      batch=batch if decode else None)
    return out, {"aux_loss": aux_loss, "dropped": dropped,
                 "aux_loss_own": own}
