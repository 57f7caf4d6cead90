"""Core layers as plain functions over small ``nn.Module``s that hold the
weights (:class:`Dense`, :class:`RMSNorm`, :class:`Embedding`,
:class:`SwiGLU`), mirroring the JAX package's ``(init, apply)`` pairs.

Weights keep the JAX package's layouts (``Dense.w`` is ``(d_in, d_out)``,
applied as ``x @ w``), so a reference parameter tree maps onto a
``state_dict`` name for name (``repro_torch.convert``).  Parameters are
created with ``requires_grad=False``: the serving path builds no autograd
graph; the trainer (``repro_torch.launch.train``) turns it on for the
span of a gradient.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

#: elements drawn at once in fp32 by :func:`truncated_normal_`
_DRAW_CHUNK = 1 << 26


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


@torch.no_grad()
def truncated_normal_(t: torch.Tensor, stddev: float,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """Fill ``t`` in place with ``stddev`` times a standard normal
    truncated to ``[-2, 2]`` (the reference's ``truncated_normal``), drawn
    in fp32 on ``t``'s device and rounded once to ``t``'s dtype.  The draw
    goes in chunks of ``_DRAW_CHUNK`` elements, so a bf16 weight needs no
    fp32 temporary of its own size."""
    flat = t.view(-1)
    for lo in range(0, flat.numel(), _DRAW_CHUNK):
        part = flat[lo:lo + _DRAW_CHUNK]
        buf = torch.empty(part.shape, dtype=torch.float32, device=t.device)
        nn.init.trunc_normal_(buf, 0.0, 1.0, -2.0, 2.0, generator=generator)
        part.copy_(buf.mul_(float(stddev)))
    return t


class Dense(nn.Module):
    """``y = x @ w (+ b)``; ``w`` is ``(d_in, d_out)``."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 dtype=None, device=None):
        super().__init__()
        self.w = _param(torch.empty((d_in, d_out), dtype=dtype,
                                    device=device))
        self.b = (_param(torch.zeros((d_out,), dtype=dtype, device=device))
                  if bias else None)

    def reset_parameters(self, generator=None, stddev=None) -> None:
        d_in = self.w.shape[0]
        truncated_normal_(self.w, stddev if stddev is not None
                          else 1.0 / d_in ** 0.5, generator)
        if self.b is not None:
            with torch.no_grad():
                self.b.zero_()

    def forward(self, x):
        return dense(self, x)


class RMSNorm(nn.Module):
    """RMS norm with an fp32 ``scale`` (the reference's ``rmsnorm_init``
    default), whatever the model's dtype."""

    def __init__(self, d: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.scale = _param(torch.ones((d,), dtype=torch.float32,
                                       device=device))
        self.eps = eps

    def forward(self, x):
        return rmsnorm(self, x, self.eps)


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, *, dtype=None, device=None):
        super().__init__()
        self.table = _param(torch.empty((vocab, d), dtype=dtype,
                                        device=device))

    def reset_parameters(self, generator=None) -> None:
        truncated_normal_(self.table, 1.0, generator)

    def forward(self, tokens):
        return embed(self, tokens)


class SwiGLU(nn.Module):
    def __init__(self, d: int, d_ff: int, *, dtype=None, device=None):
        super().__init__()
        self.gate = Dense(d, d_ff, dtype=dtype, device=device)
        self.up = Dense(d, d_ff, dtype=dtype, device=device)
        self.down = Dense(d_ff, d, dtype=dtype, device=device)

    def reset_parameters(self, generator=None) -> None:
        for lin in (self.gate, self.up, self.down):
            lin.reset_parameters(generator)

    def forward(self, x):
        return swiglu(self, x)


def dense_init(generator, d_in, d_out, dtype, bias=False, stddev=None,
               device=None) -> Dense:
    p = Dense(d_in, d_out, bias=bias, dtype=dtype, device=device)
    p.reset_parameters(generator, stddev)
    return p


def rmsnorm_init(d, device=None) -> RMSNorm:
    return RMSNorm(d, device=device)


def swiglu_init(generator, d, d_ff, dtype, device=None) -> SwiGLU:
    p = SwiGLU(d, d_ff, dtype=dtype, device=device)
    p.reset_parameters(generator)
    return p


def embedding_init(generator, vocab, d, dtype, device=None) -> Embedding:
    p = Embedding(vocab, d, dtype=dtype, device=device)
    p.reset_parameters(generator)
    return p


def dense(p, x):
    y = x @ p.w
    if p.b is not None:
        y = y + p.b
    return y


def rmsnorm(p, x, eps=1e-5):
    """fp32 inside, cast back to ``x``'s dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.scale.float()).to(x.dtype)


def swiglu(p, x):
    return dense(p.down, F.silu(dense(p.gate, x)) * dense(p.up, x))


class _Embed(torch.autograd.Function):
    """``table[tokens]``, whose gradient sums each row's occurrences in
    fp32 and rounds the sum once to the table's dtype.  Autograd's own
    gradient of the gather (``index_put_`` with ``accumulate``) rounds a
    bf16 row after every occurrence: with a Zipfian token stream a row
    is hit hundreds of times a batch, and its gradient drifts by percents
    (at Qwen2.5-32B's width, beyond ``chip_smoke.py`` ``[13.accum]``'s
    bound)."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.table_shape = table.shape
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        rows, inv = torch.unique(tokens.reshape(-1), return_inverse=True)
        d = g.shape[-1]
        sums = torch.zeros((rows.numel(), d), dtype=torch.float32,
                           device=g.device)
        sums.index_put_((inv,), g.reshape(-1, d).float(), accumulate=True)
        out = torch.zeros(ctx.table_shape, dtype=g.dtype, device=g.device)
        out[rows] = sums.to(g.dtype)
        return out, None


def embed(p, tokens):
    """``p.table[tokens]``; differentiable in ``table`` with fp32 row
    sums (:class:`_Embed`)."""
    return _Embed.apply(p.table, tokens)


def cross_entropy(logits, labels, ignore_index=-100):
    """Mean token cross-entropy in fp32 with a stable logsumexp; labels
    equal to ``ignore_index`` count for nothing."""
    logits = logits.float()
    m = torch.amax(logits, dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    valid = labels != ignore_index
    gold = torch.gather(logits, -1, torch.where(valid, labels, 0)[..., None]
                        .long())[..., 0]
    losses = torch.where(valid, lse - gold, 0.0)
    return torch.sum(losses) / torch.clamp(torch.sum(valid), min=1)
