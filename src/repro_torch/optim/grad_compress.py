"""Gradient compression with error feedback, for a data-parallel
all-reduce over a slow interconnect.

int8 block quantization: each block of 256 values shares one fp32 scale
(absmax / 127), codes rounded half to even (as ``jnp.round``; so is
``torch.round``) and clipped to [-127, 127], so the codes equal the JAX
package's bit for bit.  Error feedback [Seide et al. 2014; Karimireddy
et al. 2019] keeps the quantization residual locally and adds it back the
next step, which restores convergence to the uncompressed rate.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

BLOCK = 256


def _pad_to_block(x):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    return torch.nn.functional.pad(flat, (0, pad)), pad


def compress_int8(x):
    """x: any float tensor -> (int8 codes (N/BLOCK, BLOCK), scales
    (N/BLOCK, 1) fp32, meta)."""
    flat, pad = _pad_to_block(x.to(torch.float32))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    codes = torch.clamp(torch.round(blocks / scale), -127, 127).to(
        torch.int8)
    return codes, scale, (tuple(x.shape), pad)


def decompress_int8(codes, scale, meta, dtype=torch.float32):
    shape, pad = meta
    flat = (codes.to(torch.float32) * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape).to(dtype)


class ErrorFeedbackState(NamedTuple):
    residual: torch.Tensor


def ef_init(params) -> dict:
    """``{name: ErrorFeedbackState(fp32 zeros)}`` for a module's
    parameters or a dict of tensors."""
    from .adamw import named
    return {k: ErrorFeedbackState(torch.zeros_like(p, dtype=torch.float32))
            for k, p in named(params).items()}


def ef_compress_update(grad, ef: ErrorFeedbackState):
    """Compress ``grad + residual``; return (the quantized gradient in
    ``grad``'s dtype, the new residual).  The caller all-reduces the
    quantized gradient; the residual stays local."""
    g = grad.to(torch.float32) + ef.residual
    codes, scale, meta = compress_int8(g)
    g_hat = decompress_int8(codes, scale, meta)
    return g_hat.to(grad.dtype), ErrorFeedbackState(g - g_hat)
