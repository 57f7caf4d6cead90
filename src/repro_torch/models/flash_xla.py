"""Differentiable flash attention: the JAX package's
``models/flash_xla.py::flash_attention_xla`` (a ``jax.custom_vjp``) as a
``torch.autograd.Function``, and a second Function whose forward is the
CUDA flash kernel.

Both forwards save only ``(q, k, v, o, L)``, where ``L = m + log(l)`` is
the ``(B, Hq, S)`` log-normaliser; the backward recomputes each
probability block from it over key chunks of ``min(chunk, S)`` keys
[Dao et al. 2022, alg. 4], in fp32 torch ops, the GQA group folded into
the KV heads as the reference's ``_fold_gqa`` does:

    delta = rowsum(do * o)
    p     = exp(q k^T * scale - L)
    dv   += p^T do
    ds    = p * (do v^T - delta) * scale
    dq   += ds k          (accumulated over key chunks)
    dk   += ds^T q

so a layer keeps ``O(S)`` rows for its backward, not the ``S x S``
probabilities autograd would save through the forward's loop.

* :func:`flash_attention_xla` (``impl="xla"``): the forward is the plain
  online softmax (``kernels.flash_attn.flash_attention_plain`` with key
  blocks of ``chunk``), on any device.
* :func:`flash_attention_kernel` (``impl="pallas"``): the forward is
  ``kernels.flash_attn.flash_attention`` with ``return_lse``: the CUDA
  kernel on CUDA tensors (which also writes ``L``), its plain version on
  CPU tensors.  The JAX package's Pallas kernel has no VJP, so the
  reference trains on ``impl="xla"``; the port trains on the kernel.

The backward is torch ops (no backward kernel): the JAX package has none
to port, and ROADMAP.md Queue 2 writes one only once a chip profile puts
it on top.  Rows above the diagonal of a causal chunk have ``p = 0``
exactly, so :func:`flash_bwd` skips the query rows that cannot see a
chunk, as the forward's plain version does.
"""
from __future__ import annotations

import torch

from ..kernels import flash_attn

NEG_INF = -1e30


def _fold_gqa(t, Hkv: int, work: torch.dtype):
    """``(B, Hq, S, D)`` -> ``(B, Hkv, g, S, D)`` in ``work``: query head
    ``h`` sits at ``(h // g, h % g)``."""
    B, Hq, S, D = t.shape
    return t.reshape(B, Hkv, Hq // Hkv, S, D).to(work)


def flash_bwd(q, k, v, o, L, do, causal: bool = True, chunk: int = 1024):
    """The flash backward: ``(dq, dk, dv)`` of attention at ``(q, k, v)``
    with output ``o``, log-normaliser ``L`` (fp32 ``(B, Hq, S)``) and
    output gradient ``do``, each in its input's dtype.  Torch ops in fp32
    (float64 for float64 inputs) over key chunks of ``min(chunk, S)``;
    ``S`` a multiple of it."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    scale = 1.0 / (D ** 0.5)
    work = flash_attn.work_dtype(q.dtype)
    qf = _fold_gqa(q, Hkv, work)
    dog = _fold_gqa(do, Hkv, work)
    Lg = L.reshape(B, Hkv, g, S).to(work)
    delta = torch.sum(dog * _fold_gqa(o, Hkv, work), dim=-1)  # (B,Hkv,g,S)
    dq = torch.zeros_like(qf)
    dk = torch.empty((B, Hkv, S, D), dtype=work, device=q.device)
    dv = torch.empty_like(dk)
    pos = torch.arange(S, device=q.device)
    for k0 in range(0, S, chunk):
        lo = k0 if causal else 0
        kb = k[:, :, k0:k0 + chunk].to(work)
        vb = v[:, :, k0:k0 + chunk].to(work)
        qr, dor = qf[:, :, :, lo:], dog[:, :, :, lo:]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qr, kb) * scale
        if causal:
            see = pos[lo:, None] >= pos[None, k0:k0 + chunk]
            s = torch.where(see, s, NEG_INF)
        p = torch.exp(s - Lg[..., lo:, None])               # (B,Hkv,g,.,c)
        del s
        dv[:, :, k0:k0 + chunk] = torch.einsum("bhgqk,bhgqd->bhkd", p, dor)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dor, vb)
        ds = p * (dp - delta[..., lo:, None]) * scale
        del p, dp
        dq[:, :, :, lo:] += torch.einsum("bhgqk,bhkd->bhgqd", ds, kb)
        dk[:, :, k0:k0 + chunk] = torch.einsum("bhgqk,bhgqd->bhkd", ds, qr)
    return (dq.reshape(B, Hq, S, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _save(ctx, q, k, v, o, L, causal, chunk):
    ctx.save_for_backward(q, k, v, o, L)
    ctx.causal, ctx.chunk = causal, chunk
    return o


class _FlashXla(torch.autograd.Function):
    """Plain forward, saving ``(q, k, v, o, L)``; :func:`flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, chunk):
        o, L = flash_attn.flash_attention_plain(
            q, k, v, causal=causal, block_q=chunk, block_k=chunk,
            return_lse=True)
        return _save(ctx, q, k, v, o, L, causal, chunk)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, L = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, L, do, ctx.causal, ctx.chunk)
        return dq, dk, dv, None, None


class _FlashKernel(_FlashXla):
    """The kernel's forward (it writes ``L``); the same backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, chunk):
        o, L = flash_attn.flash_attention(q, k, v, causal=causal,
                                          return_lse=True)
        return _save(ctx, q, k, v, o, L, causal, chunk)


def flash_attention_xla(q, k, v, causal: bool = True, chunk: int = 1024):
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D) with Hq % Hkv == 0.
    Returns (B, Hq, S, D) in q's dtype.  ``S`` must be a multiple of
    ``min(chunk, S)``.  Differentiable (:func:`flash_bwd`); plain torch
    ops on any device."""
    return _FlashXla.apply(q, k, v, causal, min(chunk, q.shape[2]))


def flash_attention_kernel(q, k, v, causal: bool = True, chunk: int = 1024):
    """:func:`flash_attention_xla` with the flash kernel's forward (the
    CUDA kernel on CUDA tensors, its plain version on CPU tensors) and the
    same backward over chunks of ``min(chunk, S)`` keys."""
    return _FlashKernel.apply(q, k, v, causal, min(chunk, q.shape[2]))
