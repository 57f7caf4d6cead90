"""Decoder-only LM for the attention families (dense, and the vlm/audio
backbones whose frontends are stubs): training, prefill and decode.

One :class:`DecoderLayer` per layer in a ``ModuleList``, run by a Python
loop where the JAX package scans period-stacked parameters
(``lax.scan``); ``repro_torch.convert`` unstacks the reference's
parameters onto this layout.  Caches are a list with one
:class:`~repro_torch.models.attention.KVCache` per layer.

Entry points, as in the reference:
  loss_and_metrics — the training objective (flash attention with the
                     flash backward of ``flash_xla``)
  forward          — full-sequence forward (logits, optional caches, aux)
  prefill          — last-position logits and the caches
  decode_step      — one token against the caches (updated in place)

With ``cfg.remat``, a forward that autograd records runs each layer
under ``torch.utils.checkpoint`` (non-reentrant), which keeps only the
layer's input and recomputes the rest in the backward: the counterpart
of the reference's ``jax.checkpoint`` of its scanned period body.

A config with MoE or SSM layers raises ``NotImplementedError`` naming the
ROADMAP item that ports it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from . import attention, layers, rope
from .attention import KVCache, _no_ctx
from .config import ModelConfig

MOE_ITEM = "ROADMAP Queue 1 item 13 (models/moe.py)"
SSM_ITEM = "ROADMAP Queue 1 item 14 (models/mamba.py and hybrid stacks)"


def _check_supported(cfg: ModelConfig) -> None:
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) != "attn" or cfg.mlp_kind(i) == "none":
            raise NotImplementedError(
                f"{cfg.name}: SSM layers are not ported yet: {SSM_ITEM}")
        if cfg.mlp_kind(i) == "moe":
            raise NotImplementedError(
                f"{cfg.name}: MoE layers are not ported yet: {MOE_ITEM}")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class DecoderLayer(nn.Module):
    """Pre-norm attention and SwiGLU, each added to the residual."""

    def __init__(self, cfg: ModelConfig, *, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.norm1 = layers.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.mixer = attention.Attention(cfg, **kw)
        self.norm2 = layers.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.mlp = layers.SwiGLU(cfg.d_model, cfg.d_ff, **kw)

    def reset_parameters(self, generator=None) -> None:
        self.mixer.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def forward(self, x, *, angles=None, impl="xla", ctx=None):
        """Full sequence; returns ``(x, KVCache of this sequence)``."""
        mix, kv = self.mixer(self.norm1(x), angles=angles, impl=impl,
                             ctx=ctx)
        x = x + mix
        return x + self.mlp(self.norm2(x)), kv

    def decode(self, x, cache: KVCache, pos: int, *, angles=None, ctx=None):
        mix, cache = attention.attn_decode(self.mixer, self.norm1(x), cache,
                                           self.cfg, pos=pos, angles=angles,
                                           ctx=ctx)
        x = x + mix
        return x + self.mlp(self.norm2(x)), cache


class Transformer(nn.Module):
    """The parameters: ``embed`` (when the config embeds tokens),
    ``layers``, ``final_norm`` and ``lm_head``."""

    def __init__(self, cfg: ModelConfig, *, dtype=None, device=None):
        super().__init__()
        _check_supported(cfg)
        dt = dtype if dtype is not None else _dtype(cfg)
        kw = dict(dtype=dt, device=device)
        self.cfg = cfg
        self.embed = (layers.Embedding(cfg.vocab_size, cfg.d_model, **kw)
                      if cfg.embed_input else None)
        self.layers = nn.ModuleList(DecoderLayer(cfg, **kw)
                                    for _ in range(cfg.n_layers))
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
    parameters across with ``repro_torch.convert``."""
    dev = resolve_device(device)
    gen = key
    if not isinstance(key, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(key))
    model = Transformer(cfg, device=dev)
    model.reset_parameters(gen)
    return model


def init_cache(cfg: ModelConfig, B: int, S_max: int, *, device=None,
               dtype=None) -> List[KVCache]:
    """Zero KV caches ``(B, S_max, Hkv, D)``, one per layer, on
    ``device`` (``None`` = ``"cuda"``) in ``dtype`` (the config's by
    default)."""
    dev = resolve_device(device)
    dt = dtype if dtype is not None else _dtype(cfg)
    shape = (B, S_max, cfg.n_kv_heads, cfg.head_dim)
    return [KVCache(k=torch.zeros(shape, dtype=dt, device=dev),
                    v=torch.zeros(shape, dtype=dt, device=dev))
            for _ in range(cfg.n_layers)]


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


def _embed_inputs(params: Transformer, cfg: ModelConfig, inputs):
    if cfg.embed_input:
        return layers.embed(params.embed, inputs)
    return inputs.to(params.dtype)


def forward(params: Transformer, cfg: ModelConfig, inputs, *,
            positions=None, ctx=None, impl="xla", want_cache=False):
    """Full-sequence forward.

    inputs: int tokens (B, S) when cfg.embed_input else embeddings
    (B, S, d).  Returns (logits (B, S, V), caches_or_None, aux)."""
    _no_ctx(ctx)
    x = _embed_inputs(params, cfg, inputs)
    B, S = x.shape[:2]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    angles = _angles_for(cfg, positions)
    caches = []
    remat = cfg.remat and not want_cache and torch.is_grad_enabled()
    for layer in params.layers:
        if remat:
            x = checkpoint(_layer_out, layer, x, angles, impl,
                           use_reentrant=False)
            continue
        x, kv = layer(x, angles=angles, impl=impl)
        if want_cache:
            caches.append(kv)
    x = layers.rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = layers.dense(params.lm_head, x)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux: Dict[str, Any] = {"aux_loss": zero, "dropped": zero}
    return logits, (caches if want_cache else None), aux


def _layer_out(layer: DecoderLayer, x, angles, impl):
    return layer(x, angles=angles, impl=impl)[0]


def loss_and_metrics(params: Transformer, cfg: ModelConfig, batch, *,
                     ctx=None, impl="xla", aux_weight=0.01):
    """batch: ``{"inputs", "labels", optional "positions"}`` tensors on
    the model's device.  Returns ``(loss, {"loss", "xent", "aux_loss",
    "dropped"})``, 0-d fp32 tensors; dense stacks have no auxiliary loss,
    so ``aux_loss`` and ``dropped`` are zeros."""
    logits, _, aux = forward(params, cfg, batch["inputs"],
                             positions=batch.get("positions"), ctx=ctx,
                             impl=impl)
    xent = layers.cross_entropy(logits, batch["labels"])
    loss = xent + aux_weight * aux["aux_loss"]
    return loss, {"loss": loss, "xent": xent, **aux}


def prefill(params: Transformer, cfg: ModelConfig, inputs, *,
            positions=None, ctx=None, impl="xla"):
    """Returns (last-position logits (B, V), caches).  The logits are a
    copy, so the all-position ones (B, S, V) are freed on return."""
    logits, caches, _ = forward(params, cfg, inputs, positions=positions,
                                ctx=ctx, impl=impl, want_cache=True)
    return logits[:, -1].clone(), caches


def decode_step(params: Transformer, cfg: ModelConfig, inputs,
                cache: List[KVCache], pos: int, *, ctx=None):
    """One decode step.

    inputs: (B, 1) tokens or (B, 1, d) embeddings; pos: the current
    position (the number of tokens already in the cache).  Writes the
    step's k, v into ``cache`` in place.  Returns (logits (B, V), cache).
    """
    _no_ctx(ctx)
    x = _embed_inputs(params, cfg, inputs)
    pos = int(pos)
    positions = torch.full((x.shape[0], 1), pos, device=x.device)
    angles = _angles_for(cfg, positions)
    new_cache = []
    for layer, c in zip(params.layers, cache):
        x, c = layer.decode(x, c, pos, angles=angles)
        new_cache.append(c)
    x = layers.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return layers.dense(params.lm_head, x)[:, 0], new_cache
