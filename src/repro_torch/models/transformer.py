"""Decoder-only LM for every family of the configs: dense, MoE, the
attention-free SSM stack and the hybrid interleave (and the vlm/audio
backbones whose frontends are stubs): training, prefill and decode.

One :class:`DecoderLayer` per layer in a ``ModuleList``, run by a Python
loop where the JAX package scans period-stacked parameters
(``lax.scan``); ``repro_torch.convert`` unstacks the reference's
parameters onto this layout (Kimi's dense prologue layer is
``layers.0``).  A layer's mixer is attention or Mamba
(``cfg.layer_kind``), its FFN a SwiGLU, an MoE or none
(``cfg.mlp_kind``; Falcon-Mamba has none, and no ``norm2``).  Caches are
a list with one :class:`~repro_torch.models.attention.KVCache` or
:class:`~repro_torch.models.mamba.SSMState` per layer.  Nothing here
needs whole periods (``cfg.n_periods``): a stack cut to any depth runs;
only ``convert``'s stacking does.

Entry points, as in the reference:
  loss_and_metrics — the training objective (flash attention with the
                     flash backward of ``flash_xla``)
  forward          — full-sequence forward (logits, optional caches, aux)
  prefill          — last-position logits and the caches
  decode_step      — one token against the caches (KV caches updated in
                     place, SSM states replaced)

``aux`` sums each MoE layer's ``aux_loss`` and ``dropped`` over the
layers, as the reference does (dense and SSM layers add zeros).  With
``cfg.remat``, a forward that autograd records runs each layer under
``torch.utils.checkpoint`` (non-reentrant), which keeps only the layer's
input and recomputes the rest in the backward: the counterpart of the
reference's ``jax.checkpoint`` of its scanned period body.  The
checkpointed function returns the layer's aux with its output, so remat
leaves ``aux_loss`` as it is.

With a sharding context (``ctx``, a ``repro_torch.distributed.sharding.
ShardingCtx``) every family serves on a (data, model) mesh of ranks:
``params`` is the rank's block of each tensor
(``repro_torch.convert.shard_lm_params``), ``inputs`` the whole batch on
every rank; the batch is sharded over dp when it divides, the weights
are gathered over dp before each use and dropped after (FSDP), and the
attention, the MLP, the embedding and the LM head are tensor-parallel
(``repro_torch.distributed.tp``), the MoE expert-parallel
(``models/moe.py``) and the Mamba mixer ``d_inner``-parallel
(``models/mamba.py``).  Logits come back as the rank's block:
its batch rows and its ``V/tp`` columns of the vocabulary
(:func:`gather_logits` assembles the rows' whole vocabulary); caches are
the rank's blocks (``launch.specs``).  Between the sublayers the
activations are the rank's rows, whole and the same on every model rank
(also after the 2-D forms of ``"manual"`` decode), which is the layout
the MoE takes its tokens in.  An MoE layer's capacity counts the rank's
tokens, so a sharded run equals the unsharded one on each dp shard's
rows (on the whole batch where it is replicated).

Every family also trains with a ctx: the collectives are
differentiable (``distributed.tp``'s ``f``/``g`` pairs and FSDP
gathers; the MoE's and the Mamba mixer's place them as their modules
say), the loss is the vocabulary-parallel cross-entropy, and
:func:`loss_and_metrics` returns the rank's share of the global loss
(``launch.train`` sums the gradients over dp:
``sharding.reduce_grads``).  An MoE layer's aux loss enters that share
as the rank's own (``"aux_loss_own"``, summed over the layers beside
``aux_loss`` and ``dropped``, which with a ctx are metrics without a
gradient).
"""
from __future__ import annotations

from typing import Any, Dict, List, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..distributed import tp
from ..distributed.sharding import ShardingCtx, check_divisible
from ..launch import specs
from . import attention, layers, mamba, moe, rope
from .attention import KVCache
from .config import ModelConfig
from .mamba import SSMState


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class DecoderLayer(nn.Module):
    """Pre-norm mixer (attention or Mamba) and FFN (SwiGLU ``mlp``, MoE
    ``moe``, or none), each added to the residual.  The ``cfg`` it is
    built with gives its kinds and shapes; how it runs
    (``tp_collectives``, ``ssm_chunk``, the MoE's capacity) follows the
    ``cfg`` each call passes, as the entry points' ``cfg`` argument
    says."""

    def __init__(self, cfg: ModelConfig, idx: int, *, dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.kind, self.mlp_kind = cfg.layer_kind(idx), cfg.mlp_kind(idx)
        self.norm1 = layers.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.mixer = (attention.Attention(cfg, **kw) if self.kind == "attn"
                      else mamba.Mamba(cfg, **kw))
        if self.mlp_kind != "none":
            self.norm2 = layers.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        if self.mlp_kind == "moe":
            self.moe = moe.MoE(cfg, **kw)
        elif self.mlp_kind == "dense":
            self.mlp = layers.SwiGLU(cfg.d_model, cfg.d_ff, **kw)

    def reset_parameters(self, generator=None) -> None:
        self.mixer.reset_parameters(generator)
        if self.mlp_kind == "moe":
            self.moe.reset_parameters(generator)
        elif self.mlp_kind == "dense":
            self.mlp.reset_parameters(generator)

    def _ffn(self, x, cfg, ctx=None, batch=None, decode=False):
        """``(x + FFN(norm2(x)), aux or None)``; with a ctx, ``batch`` is
        the whole batch's size and ``decode`` says whether this is a
        decode step."""
        if self.mlp_kind == "none":
            return x, None
        h = self.norm2(x)
        if self.mlp_kind == "moe":
            y, aux = moe.moe_apply(self.moe, h, cfg, ctx, batch=batch,
                                   decode=decode)
            return x + y, aux
        if ctx is None:
            return x + self.mlp(h), None
        return x + tp.swiglu_sharded(
            self.mlp, h, ctx, collectives=cfg.tp_collectives,
            batch=batch if decode else None), None

    def forward(self, x, cfg, *, angles=None, impl="xla", ctx=None,
                batch=None):
        """Full sequence under ``cfg``; returns ``(x, cache of this
        sequence, aux or None)``: a KVCache of its k, v or the SSM state
        after it.  With a ctx, ``batch`` is the whole batch's size."""
        h = self.norm1(x)
        if self.kind == "attn":
            mix, cache = attention.attn_apply(self.mixer, h, cfg,
                                              angles=angles, impl=impl,
                                              ctx=ctx)
        else:
            mix, cache = mamba.mamba_apply(self.mixer, h, cfg,
                                           chunk=cfg.ssm_chunk, ctx=ctx)
        x, aux = self._ffn(x + mix, cfg, ctx, batch)
        return x, cache, aux

    def decode(self, x, cache, pos: int, cfg, *, angles=None, ctx=None,
               batch=None):
        h = self.norm1(x)
        if self.kind == "attn":
            mix, cache = attention.attn_decode(self.mixer, h, cache, cfg,
                                               pos=pos, angles=angles,
                                               ctx=ctx, batch=batch)
        else:
            mix, cache = mamba.mamba_decode(self.mixer, h, cache, cfg, ctx)
        return self._ffn(x + mix, cfg, ctx, batch, decode=True)[0], cache


class Transformer(nn.Module):
    """The parameters: ``embed`` (when the config embeds tokens),
    ``layers``, ``final_norm`` and ``lm_head``."""

    def __init__(self, cfg: ModelConfig, *, dtype=None, device=None):
        super().__init__()
        dt = dtype if dtype is not None else _dtype(cfg)
        kw = dict(dtype=dt, device=device)
        self.cfg = cfg
        self.embed = (layers.Embedding(cfg.vocab_size, cfg.d_model, **kw)
                      if cfg.embed_input else None)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i, **kw)
                                    for i in range(cfg.n_layers))
        self.final_norm = layers.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.lm_head = layers.Dense(cfg.d_model, cfg.vocab_size, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return self.lm_head.w.dtype

    def reset_parameters(self, generator=None) -> None:
        for layer in self.layers:
            layer.reset_parameters(generator)
        if self.embed is not None:
            self.embed.reset_parameters(generator)
        self.lm_head.reset_parameters(generator)

    def forward(self, inputs, **kw):
        return forward(self, self.cfg, inputs, **kw)


def init_params(key: Union[int, torch.Generator], cfg: ModelConfig, *,
                device=None) -> Transformer:
    """A model of ``cfg`` with weights drawn on ``device`` (``None`` =
    ``"cuda"``) in the config's dtype: truncated normals (±2σ, σ =
    1/√d_in; the embedding σ = 1), zero biases, unit norm scales.  ``key``
    is a seed or a ``torch.Generator`` on ``device``.  The draws differ
    from the reference's threefry ones; tests carry the reference's
    parameters across with ``repro_torch.convert``.  On the ``meta``
    device (a shape-only trace) nothing is drawn."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev)
    if dev.type == "meta":
        return model
    gen = key
    if not isinstance(key, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(key))
    model.reset_parameters(gen)
    return model


def init_cache(cfg: ModelConfig, B: int, S_max: int, *, device=None,
               dtype=None, ctx=None) -> List[Union[KVCache, SSMState]]:
    """One cache a layer, on ``device`` (``None`` = ``"cuda"``): for an
    attention layer zero KV caches ``(B, S_max, Hkv, D)`` in ``dtype``
    (the config's by default), for an SSM layer a zero
    :class:`SSMState` (its ``conv`` in ``dtype``, its ``ssm`` fp32).
    With ``ctx``: this rank's blocks of the sequence-sharded KV caches
    (``launch.specs.local_kv_shape``) and of the ``d_inner``-sharded SSM
    states (``launch.specs.ssm_state_shapes``)."""
    dev = resolve_device(device)
    dt = dtype if dtype is not None else _dtype(cfg)
    shape = (B, S_max, cfg.n_kv_heads, cfg.head_dim)
    if ctx is not None:
        _check_ctx(cfg, ctx)
        shape = specs.local_kv_shape(cfg, B, S_max, ctx)
    return [KVCache(k=torch.zeros(shape, dtype=dt, device=dev),
                    v=torch.zeros(shape, dtype=dt, device=dev))
            if cfg.layer_kind(i) == "attn"
            else mamba.init_ssm_state(cfg, B, dt, device=dev, ctx=ctx)
            for i in range(cfg.n_layers)]


def _angles_for(cfg: ModelConfig, positions):
    """positions: (B, S) int or (B, S, 3) for mrope."""
    if cfg.n_heads == 0:
        return None
    if cfg.rope_kind == "mrope":
        if positions.dim() == 2:
            positions = positions[..., None].expand(*positions.shape, 3)
        return rope.mrope_angles(positions, cfg.head_dim, cfg.rope_theta,
                                 cfg.mrope_sections)
    return rope.rope_angles(positions, cfg.head_dim, cfg.rope_theta)


def _embed_inputs(params: Transformer, cfg: ModelConfig, inputs, ctx=None):
    if ctx is not None:
        inputs = tp.local_batch(inputs, ctx)
        if cfg.embed_input:
            return tp.vocab_parallel_embed(params.embed.table, inputs, ctx)
    if cfg.embed_input:
        return layers.embed(params.embed, inputs)
    return inputs.to(params.dtype)


def _check_ctx(cfg: ModelConfig, ctx) -> None:
    """A ctx must be a ``ShardingCtx`` and must divide the config's
    sharded dimensions."""
    if ctx is None:
        return
    if not isinstance(ctx, ShardingCtx):
        raise TypeError(f"ctx must be a ShardingCtx (distributed.sharding."
                        f"make_ctx), got {type(ctx).__name__}")
    check_divisible(cfg, ctx)


def gather_logits(logits, ctx):
    """A rank's logits block ``(..., V/tp)`` with the whole vocabulary
    (gathered over the model axis); without a ctx, ``logits``."""
    return logits if ctx is None else ctx.mesh.all_gather(logits, ctx.tp,
                                                          dim=-1)


def forward(params: Transformer, cfg: ModelConfig, inputs, *,
            positions=None, ctx=None, impl="xla", want_cache=False):
    """Full-sequence forward.

    inputs: int tokens (B, S) when cfg.embed_input else embeddings
    (B, S, d).  Returns (logits (B, S, V), caches_or_None, aux); with a
    ctx, the rank's blocks (see the module's docstring; ``positions``
    too are the whole batch's) and aux also holds ``"aux_loss_own"``,
    the rank's own aux loss with its gradient."""
    _check_ctx(cfg, ctx)
    x = _embed_inputs(params, cfg, inputs, ctx)
    B, S = x.shape[:2]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    elif ctx is not None:
        positions = tp.local_batch(positions, ctx)
    angles = _angles_for(cfg, positions)
    caches = []
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux_sum: Dict[str, Any] = {"aux_loss": zero, "dropped": zero}
    if ctx is not None:
        aux_sum["aux_loss_own"] = zero
    remat = cfg.remat and not want_cache and torch.is_grad_enabled()
    batch = inputs.shape[0]
    for layer in params.layers:
        if remat:
            x, aux = checkpoint(_layer_out, layer, cfg, x, angles, impl,
                                ctx, batch, use_reentrant=False)
        else:
            x, cache, aux = layer(x, cfg, angles=angles, impl=impl, ctx=ctx,
                                  batch=batch)
            if want_cache:
                caches.append(cache)
        if aux is not None:
            aux_sum = {k: aux_sum[k] + aux[k] for k in aux_sum}
    x = layers.rmsnorm(params.final_norm, x, cfg.norm_eps)
    if ctx is None:
        logits = layers.dense(params.lm_head, x)
    else:
        logits = tp.col_parallel_dense(x, params.lm_head.w, ctx,
                                       params.lm_head.b)
    return logits, (caches if want_cache else None), aux_sum


def _layer_out(layer: DecoderLayer, cfg, x, angles, impl, ctx, batch):
    """The layer's output and aux (remat's checkpointed function: the
    aux must come out of it, or remat would drop the MoE's loss; with a
    ctx its recomputation gathers the weights again, every rank in the
    same order, and an MoE layer routes again: on bitwise the inputs of
    the forward, so as the forward did)."""
    x, _, aux = layer(x, cfg, angles=angles, impl=impl, ctx=ctx,
                      batch=batch)
    return x, aux


def loss_and_metrics(params: Transformer, cfg: ModelConfig, batch, *,
                     ctx=None, impl="xla", aux_weight=0.01):
    """batch: ``{"inputs", "labels", optional "positions"}`` tensors on
    the model's device.  Returns ``(loss, {"loss", "xent", "aux_loss",
    "dropped"})``, 0-d fp32 tensors; ``aux_loss`` and ``dropped`` are
    summed over the MoE layers (zeros without any), and ``loss`` is
    ``xent + aux_weight * aux_loss``.

    With ``ctx``: the batch is the whole batch on every rank (``labels``
    cut to the rank's rows as ``inputs`` are), ``params`` the rank's
    blocks, and the cross-entropy vocabulary-parallel
    (``tp.vocab_parallel_cross_entropy``).  The metrics are the global
    batch's, the same on every rank; the first element is this rank's
    share of the global loss, whose sum over dp is the loss (its token
    sum over the global count, or the loss over dp where the batch is
    replicated), so the gradients summed over dp
    (``sharding.reduce_grads``) are the global loss's.  Its aux term is
    ``aux_weight / dp`` times the rank's own aux loss (``moe_apply``'s
    ``"aux_loss_own"``): summed over dp, the mean over dp of the shards'
    aux losses, as the metric ``aux_loss`` (their pmean, without a
    gradient) reports it."""
    _check_ctx(cfg, ctx)
    logits, _, aux = forward(params, cfg, batch["inputs"],
                             positions=batch.get("positions"), ctx=ctx,
                             impl=impl)
    if ctx is None:
        xent = layers.cross_entropy(logits, batch["labels"])
        loss = xent + aux_weight * aux["aux_loss"]
        return loss, {"loss": loss, "xent": xent, **aux}
    share, xent = tp.vocab_parallel_cross_entropy(
        logits, tp.local_batch(batch["labels"], ctx), ctx,
        sharded=tp.batch_sharded(batch["inputs"].shape[0], ctx))
    share = share + aux_weight * aux.pop("aux_loss_own") / ctx.dp_size
    loss = xent + aux_weight * aux["aux_loss"].detach()
    return share, {"loss": loss, "xent": xent, **aux}


def prefill(params: Transformer, cfg: ModelConfig, inputs, *,
            positions=None, ctx=None, impl="xla"):
    """Returns (last-position logits (B, V), caches).  The logits are a
    copy, so the all-position ones (B, S, V) are freed on return.  With
    ``ctx`` the rank's blocks, the caches' KV heads its ``Hkv/tp``
    (``launch.serve._merge_prefill_cache`` reshards them)."""
    logits, caches, _ = forward(params, cfg, inputs, positions=positions,
                                ctx=ctx, impl=impl, want_cache=True)
    return logits[:, -1].clone(), caches


def decode_step(params: Transformer, cfg: ModelConfig, inputs,
                cache: List[Union[KVCache, SSMState]], pos: int, *,
                ctx=None):
    """One decode step.

    inputs: (B, 1) tokens or (B, 1, d) embeddings; pos: the current
    position (the number of tokens already in the cache).  Writes the
    step's k, v into the attention layers' caches in place and replaces
    the SSM layers' states.  Returns (logits (B, V), the new caches).

    With ``ctx``: ``inputs`` is the whole batch, ``cache`` the rank's
    blocks (:func:`init_cache` with the ctx) and the logits the rank's
    block (its rows, ``V/tp`` columns).  The embedding is looked up in
    the rank's (V/tp, d/dp) block for the whole batch and traded over dp
    (no weight moves); under ``"manual"`` the projections and the LM head
    are the 2-D forms, else gathered over dp.
    """
    _check_ctx(cfg, ctx)
    B = inputs.shape[0]
    if ctx is not None and cfg.embed_input:
        x = tp.vocab_parallel_embed_2dtp(params.embed.table, inputs, ctx)
    else:
        x = _embed_inputs(params, cfg, inputs, ctx)
    pos = int(pos)
    positions = torch.full((x.shape[0], 1), pos, device=x.device)
    angles = _angles_for(cfg, positions)
    new_cache = []
    for layer, c in zip(params.layers, cache):
        x, c = layer.decode(x, c, pos, cfg, angles=angles, ctx=ctx, batch=B)
        new_cache.append(c)
    x = layers.rmsnorm(params.final_norm, x, cfg.norm_eps)
    if ctx is None:
        return layers.dense(params.lm_head, x)[:, 0], new_cache
    if cfg.tp_collectives == "manual":
        logits = tp.col_parallel_dense_2dtp(
            x, params.lm_head.w, ctx, params.lm_head.b,
            sharded=tp.batch_sharded(B, ctx))
    else:
        logits = tp.col_parallel_dense(x, params.lm_head.w, ctx,
                                       params.lm_head.b)
    return logits[:, 0], new_cache
