"""Attention: GQA projections, the training and prefill path (the flash
kernel or its plain chunked twin, each differentiable through the flash
backward of ``flash_xla``) and the decode path against a KV cache.

Decode attention is plain torch ops over the whole cache, positions at
or past ``cur_len`` masked, as in the JAX package.  KV caches keep the
reference's ``(B, S_max, Hkv, D)`` layout; the port updates them in
place during decode (the reference returns new arrays), which saves a
copy of every layer's cache per token.

With a sharding context (``ctx``) the projections are Megatron's: wq,
wk and wv column-parallel, so a rank holds ``Hq/tp`` query and
``Hkv/tp`` KV heads and runs the flash kernel on them; wo row-parallel
(``repro_torch.distributed.tp``).  Where tp exceeds the KV heads
(``tp = r * Hkv``, ``distributed.sharding.kv_share``), a rank's wk and
wv blocks hold a ``1/r`` column slice of the one KV head its query heads
use: the rank projects its slice, the slices are gathered over the model
axis (``tp.gather_tp``, whose backward sums each slice's gradient over
the ranks that used it) and the rank attends with its ``Hq/tp`` query
heads against that whole head.  Prefill returns its head-sharded k, v
(with ``r > 1`` its post-rope column slice); decode caches are
sequence-sharded (``repro_torch.launch.specs``): the step's k, v and q
are gathered over the model axis (with ``r > 1`` k's rope after the
gather, on whole heads), the rank whose slice holds the position writes
them, every rank attends over its slice and the partial softmax
statistics are combined by max and sum (:func:`decode_attention_sharded`:
what GSPMD makes of the reference's reductions over a sharded axis), and
each rank keeps its own heads for wo.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..distributed import tp
from ..distributed.sharding import kv_share
from ..kernels import flash_attn
from ..launch import specs
from . import layers, rope as rope_mod
from .flash_xla import flash_attention_kernel, flash_attention_xla

NEG_INF = -1e30


class Attention(nn.Module):
    """The GQA sublayer's weights: ``wq``, ``wk``, ``wv`` (with the
    config's QKV bias) and ``wo``, each ``(d_in, d_out)``."""

    def __init__(self, cfg, *, dtype=None, device=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        kw = dict(dtype=dtype, device=device)
        self.wq = layers.Dense(d, cfg.n_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wk = layers.Dense(d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                               **kw)
        self.wv = layers.Dense(d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                               **kw)
        self.wo = layers.Dense(cfg.n_heads * hd, d, **kw)

    def reset_parameters(self, generator=None) -> None:
        for lin in (self.wq, self.wk, self.wv, self.wo):
            lin.reset_parameters(generator)


def attn_init(generator, cfg, dtype, device=None) -> Attention:
    p = Attention(cfg, dtype=dtype, device=device)
    p.reset_parameters(generator)
    return p


def chunked_attention(q, k, v, *, causal=True, chunk=1024):
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D).  Returns (B, Hq, S, D).

    Blockwise online softmax over key chunks, written as the reference's
    ``lax.scan`` is (every chunk, no in-place update), so autograd
    differentiates through it and saves every chunk's probabilities: the
    baseline without the flash backward (``impl="xla_naive"``)."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    group = Hq // Hkv
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    scale = 1.0 / (D ** 0.5)
    qg = (q.float() * scale).reshape(B, Hkv, group, S, D)
    q_pos = torch.arange(S, device=q.device)
    m = torch.full((B, Hkv, group, S), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, group, S), device=q.device)
    acc = torch.zeros((B, Hkv, group, S, D), device=q.device)
    for k0 in range(0, S, chunk):
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg,
                         k[:, :, k0:k0 + chunk].float())
        if causal:
            msk = q_pos[:, None] >= q_pos[None, k0:k0 + chunk]
            s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p, v[:, :, k0:k0 + chunk].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Hq, S, D).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cur_len):
    """q: (B, Hq, D); caches: (B, S_max, Hkv, D); cur_len: int.  Keys at
    positions ``>= cur_len`` are masked.  fp32 inside, q's dtype out."""
    B, Hq, D = q.shape
    S = k_cache.shape[1]
    Hkv = k_cache.shape[2]
    group = Hq // Hkv
    scale = 1.0 / (D ** 0.5)
    qg = (q.float() * scale).reshape(B, Hkv, group, D)
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float())
    valid = torch.arange(S, device=q.device) < cur_len
    logits = torch.where(valid, logits, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    out = out / torch.clamp(l, min=1e-30)
    return out.reshape(B, Hq, D).to(q.dtype)


def decode_attention_sharded(q, k_cache, v_cache, cur_len: int, mesh, axes):
    """:func:`decode_attention` over a cache whose sequence is sharded
    over ``axes`` of ``mesh``: q (B, Hq, D), every head; caches this
    rank's slice (B, S_loc, Hkv, D); ``cur_len`` the valid positions of
    this slice (may be <= 0 or > S_loc).  Each rank computes its slice's
    running max ``m``, sum ``l`` and unnormalised output ``o``; they are
    combined over ``axes`` by the max of ``m`` and the sums of ``l`` and
    ``o`` rescaled to it (one all-reduce each), fp32 inside."""
    B, Hq, D = q.shape
    S = k_cache.shape[1]
    Hkv = k_cache.shape[2]
    scale = 1.0 / (D ** 0.5)
    qg = (q.float() * scale).reshape(B, Hkv, Hq // Hkv, D)
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float())
    valid = torch.arange(S, device=q.device) < cur_len
    logits = torch.where(valid, logits, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    # a slice with no valid position has m = NEG_INF: its weight is 0
    w = torch.exp(m - mesh.all_reduce(m, axes, op="max"))
    lo = mesh.all_reduce(torch.cat([o * w, l * w], -1), axes)
    out = lo[..., :D] / torch.clamp(lo[..., D:], min=1e-30)
    return out.reshape(B, Hq, D).to(q.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_max, Hkv, D)
    v: torch.Tensor


def attn_apply(p, x, cfg, *, angles=None, impl="xla", ctx=None):
    """Training and prefill self-attention.  x: (B, S, d).  Returns
    ``(out (B, S, d), KVCache of this sequence's k, v (B, S, Hkv, D))``.

    ``impl``: ``"pallas"`` is the flash kernel (the CUDA kernel on the
    card, its plain version on the CPU), ``"xla"`` the plain chunked
    flash of ``flash_xla``, ``"xla_naive"`` :func:`chunked_attention`.
    Where autograd records (grad enabled, an input requiring grad),
    ``"pallas"`` and ``"xla"`` save ``(q, k, v, o, L)`` for the flash
    backward of ``flash_xla`` (the kernel then also writes ``L``), and
    ``"xla_naive"`` is differentiated by autograd through its loop.

    With ``ctx``: x is this rank's batch, and the rank's ``Hq/tp`` query
    and ``Hkv/tp`` KV heads are projected (wq, wk, wv gathered over dp),
    attended and summed through the row-parallel wo; the cache holds
    those KV heads.  Where ``r = kv_share(Hkv, tp) > 1`` the rank projects
    its column slice of one KV head, gathers the head's slices
    (:func:`_kv_head`) and ropes it whole; the cache holds the rank's
    post-rope slice ``(B, S, 1, D/r)``.  Under autograd x enters the
    model group once (``tp.copy_to_tp``, its gradient summed over tp) and
    wo's sum passes the gradient to every rank's heads (``tp.psum_tp``),
    so the flash forward and backward run on the rank's heads only.
    """
    B, S, _ = x.shape
    hd = cfg.head_dim
    n = 1 if ctx is None else ctx.tp_size
    r = kv_share(cfg.n_kv_heads, n)
    hq, hkv = cfg.n_heads // n, cfg.n_kv_heads * r // n
    if ctx is None:
        proj = [layers.dense(lin, x) for lin in (p.wq, p.wk, p.wv)]
    else:
        proj = tp.col_parallel_many(x, [(lin.w, lin.b)
                                        for lin in (p.wq, p.wk, p.wv)], ctx)
    q = proj[0].reshape(B, S, hq, hd)
    k, v = proj[1], proj[2]
    if r > 1:
        k, v = (_kv_head(t, ctx, r) for t in (k, v))
    k = k.reshape(B, S, hkv, hd)
    v = v.reshape(B, S, hkv, hd)
    if angles is not None:
        q = rope_mod.apply_rotary(q, angles)
        k = rope_mod.apply_rotary(k, angles)
    # (B, H, S, D) views: the kernel reads the projections' layout
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if impl == "pallas":
        if any(t.requires_grad for t in (qt, kt, vt)):
            o = flash_attention_kernel(qt, kt, vt, True, cfg.attn_chunk)
        else:
            o = flash_attn.flash_attention(qt, kt, vt, causal=True)
    elif impl == "xla_naive":
        o = chunked_attention(qt, kt, vt, causal=True)
    elif impl == "xla":
        o = flash_attention_xla(qt, kt, vt, True, cfg.attn_chunk)
    else:
        raise ValueError(f"impl must be 'pallas', 'xla' or 'xla_naive', "
                         f"got {impl!r}")
    o = o.transpose(1, 2).reshape(B, S, hq * hd)
    if ctx is None:
        return layers.dense(p.wo, o), KVCache(k=k, v=v)
    out = tp.row_parallel_dense(o, p.wo.w, ctx, p.wo.b,
                                collectives=cfg.tp_collectives)
    if r > 1:
        c = hd // r
        k, v = (t.narrow(-1, ctx.tp_index % r * c, c) for t in (k, v))
    return out, KVCache(k=k, v=v)


def _kv_head(cols, ctx, r: int):
    """The whole KV head ``(..., D)`` whose column slice ``cols`` (``(...,
    D/r)``, this rank's block of wk or wv applied) this model rank holds:
    every model rank's slice gathered in rank order (``tp.gather_tp``),
    head ``tp_index // r`` kept."""
    c = cols.shape[-1]
    whole = tp.gather_tp(cols, ctx, dim=-1)
    return whole.narrow(-1, ctx.tp_index // r * r * c, r * c)


def attn_decode(p, x, cache: KVCache, cfg, *, pos: int, angles=None,
                ctx=None, batch=None):
    """Single-token decode.  x: (B, 1, d); writes this token's k, v at
    ``pos`` of ``cache`` (in place) and attends over positions ``<= pos``.
    Returns ``(out (B, 1, d), cache)``.

    With ``ctx``: x is this rank's rows of a batch of ``batch`` and
    ``cache`` its block of the sequence-sharded cache
    (``launch.specs.local_kv_shape``).  The projections are the 2-D forms
    under ``cfg.tp_collectives == "manual"`` (no weight moves), else
    gathered over dp."""
    if ctx is not None:
        return _attn_decode_sharded(p, x, cache, cfg, pos, angles, ctx,
                                    batch)
    B = x.shape[0]
    hd = cfg.head_dim
    xq = x[:, 0]
    q = layers.dense(p.wq, xq).reshape(B, cfg.n_heads, hd)
    k = layers.dense(p.wk, xq).reshape(B, cfg.n_kv_heads, hd)
    v = layers.dense(p.wv, xq).reshape(B, cfg.n_kv_heads, hd)
    if angles is not None:
        q = rope_mod.apply_rotary(q[:, None], angles)[:, 0]
        k = rope_mod.apply_rotary(k[:, None], angles)[:, 0]
    cache.k[:, pos] = k.to(cache.k.dtype)
    cache.v[:, pos] = v.to(cache.v.dtype)
    o = decode_attention(q, cache.k, cache.v, pos + 1)
    out = layers.dense(p.wo, o.reshape(B, cfg.n_heads * hd))
    return out[:, None], cache


def _attn_decode_sharded(p, x, cache: KVCache, cfg, pos: int, angles, ctx,
                         batch: int):
    Bl = x.shape[0]
    hd, n = cfg.head_dim, ctx.tp_size
    r = kv_share(cfg.n_kv_heads, n)
    hq, kc = cfg.n_heads // n, cfg.n_kv_heads * hd // n
    sharded = tp.batch_sharded(batch, ctx)
    manual = cfg.tp_collectives == "manual"
    proj = [tp.col_parallel_dense_2dtp(x, lin.w, ctx, lin.b,
                                       sharded=sharded)[:, 0] if manual
            else tp.col_parallel_dense(x[:, 0], lin.w, ctx, lin.b)
            for lin in (p.wq, p.wk, p.wv)]
    q = proj[0].reshape(Bl, hq, hd)
    k = proj[1]
    if angles is not None:
        q = rope_mod.apply_rotary(q[:, None], angles)[:, 0]
        if r == 1:
            # whole heads: rope before the gather; shared ones after it
            k = rope_mod.apply_rotary(k.reshape(Bl, 1, -1, hd),
                                      angles)[:, 0]
    # every column of the step's q, k and v: one gather over the model
    # axis, each rank's (hq heads, kc columns of k, kc of v) in rank order
    qkv = torch.cat([t.reshape(Bl, -1) for t in (q, k, proj[2])], 1)
    cols = ctx.mesh.all_gather(qkv[:, None], ctx.tp, dim=1)
    qc = hq * hd
    q_all = cols[:, :, :qc].reshape(Bl, cfg.n_heads, hd)
    k_all = cols[:, :, qc:qc + kc].reshape(Bl, cfg.n_kv_heads, hd)
    v_all = cols[:, :, qc + kc:].reshape(Bl, cfg.n_kv_heads, hd)
    if angles is not None and r > 1:
        k_all = rope_mod.apply_rotary(k_all[:, None], angles)[:, 0]
    axes = specs.cache_seq_axes(batch, ctx)
    S_loc = cache.k.shape[1]
    off = ctx.mesh.index(axes) * S_loc
    if off <= pos < off + S_loc:
        cache.k[:, pos - off] = k_all.to(cache.k.dtype)
        cache.v[:, pos - off] = v_all.to(cache.v.dtype)
    o = decode_attention_sharded(q_all, cache.k, cache.v, pos + 1 - off,
                                 ctx.mesh, axes)
    mine = o[:, ctx.tp_index * hq:(ctx.tp_index + 1) * hq]
    mine = mine.reshape(Bl, 1, hq * hd)
    if manual:
        out = tp.row_parallel_dense_2dtp(mine, p.wo.w, ctx, p.wo.b,
                                         sharded=sharded)
    else:
        out = tp.row_parallel_dense(mine, p.wo.w, ctx, p.wo.b,
                                    collectives="gspmd")
    return out, cache
