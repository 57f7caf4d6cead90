"""Mamba-1 block (Falcon-Mamba's and Jamba's SSM layers) as torch ops.

The selective scan ``h_t = a_t h_{t-1} + b_t`` runs in two levels, as in
the JAX package: an outer loop over chunks of the sequence carries the
``(B, d_inner, N)`` fp32 state; inside a chunk a Hillis–Steele scan of
``log2(chunk)`` tensor steps (step ``s`` folds in the element ``2^s``
back) takes the place of ``jax.lax.associative_scan``, which torch
lacks.  Both apply the same combine, ``(a_r a_l, a_r b_l + b_r)``, over
another tree, so fp32 results differ by rounding
(``tests/test_torch_mamba.py`` states the bound).  The chunk materializes
``(B, chunk, d_inner, N)`` fp32 tensors; ``S`` must be a multiple of
``min(chunk, S)`` (the reference asserts; the port raises
``ValueError``).

The causal depthwise convolution is a Python sum of ``K`` shifted
products in the input dtype, in the reference's order, not
``F.conv1d``, whose fp32 accumulation departs from the reference in bf16.
``dt_bias``, ``A_log`` and ``D`` are fp32 whatever the model's dtype.

With a sharding context (``ctx``) the mixer is ``d_inner``-parallel, as
GSPMD shards the reference's by its specs
(``src/repro/distributed/sharding.py:74-82``): ``in_proj`` is
column-parallel (the rank's block holds the ``x`` and ``z`` channels of
the same indices, ``sharding.shard_param``), the convolution,
``dt_proj``, ``dt_bias``, ``A_log``, ``D`` and the whole scan run on the
rank's ``d_inner/tp`` channels with no collective, ``x_proj``'s partial
``(..., r + 2N)`` is summed over the model group before its split, and
``out_proj`` is row-parallel.  Both sums follow ``cfg.tp_collectives``
as ``tp.row_parallel_dense`` does: in fp32 and cast (``"gspmd"``) or in
the activation dtype (``"manual"``).  The state is the rank's block:
its batch rows and ``d_inner/tp`` channels.  Under autograd the sum of
``x_proj``'s partials is followed by ``tp.copy_to_tp``, so the
gradients that reach ``x_proj``, the convolution and ``in_proj`` are
the whole model group's (:func:`_ssm_inputs`); the tp-local
weights (``conv_w``, ``conv_b``, ``x_proj``, ``dt_proj``, ``dt_bias``,
``A_log``, ``D``), whose specs have no dp axis, are summed over dp after
the backward (``sharding.reduce_grads``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import layers
from ..distributed import tp
from ..launch import specs


class SSMState(NamedTuple):
    conv: torch.Tensor   # (B, K-1, d_inner): the last K-1 pre-conv inputs
    ssm: torch.Tensor    # (B, d_inner, N): the recurrent state, fp32


class Mamba(nn.Module):
    """The weights, named as the reference's: ``in_proj`` ``(d, 2 di)``,
    ``conv_w`` ``(K, di)``, ``conv_b``, ``x_proj`` ``(di, r + 2N)``,
    ``dt_proj`` ``(r, di)``, ``out_proj`` ``(di, d)`` in the model's
    dtype; ``dt_bias`` ``(di,)``, ``A_log`` ``(di, N)`` and ``D``
    ``(di,)`` in fp32."""

    def __init__(self, cfg, *, dtype=None, device=None):
        super().__init__()
        d, di, N, r, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                          cfg.dt_rank, cfg.ssm_conv)
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.cfg = cfg
        self.in_proj = layers.Dense(d, 2 * di, **kw)
        self.conv_w = layers._param(torch.empty((K, di), **kw))
        self.conv_b = layers._param(torch.zeros((di,), **kw))
        self.x_proj = layers.Dense(di, r + 2 * N, **kw)
        self.dt_proj = layers.Dense(r, di, **kw)
        self.dt_bias = layers._param(torch.empty((di,), **f32))
        self.A_log = layers._param(torch.empty((di, N), **f32))
        self.D = layers._param(torch.ones((di,), **f32))
        self.out_proj = layers.Dense(di, d, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        """The reference's ``mamba_init``: ``dt`` log-uniform in [1e-3,
        0.1] and ``dt_bias`` its inverse softplus, ``A_log = log(1..N)``
        on every row, ``D`` ones, truncated normals elsewhere."""
        K, N = self.cfg.ssm_conv, self.cfg.ssm_state
        u = torch.rand(self.dt_bias.shape, generator=generator,
                       device=self.dt_bias.device)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                       + math.log(1e-3))
        self.dt_bias.copy_(dt + torch.log1p(-torch.exp(-dt)))
        self.A_log.copy_(torch.log(torch.arange(
            1, N + 1, dtype=torch.float32, device=self.A_log.device))
            .expand_as(self.A_log))
        self.D.fill_(1.0)
        self.conv_b.zero_()
        layers.truncated_normal_(self.conv_w, 1.0 / math.sqrt(K), generator)
        for lin in (self.in_proj, self.x_proj, self.dt_proj, self.out_proj):
            lin.reset_parameters(generator)


def mamba_init(generator, cfg, dtype, device=None) -> Mamba:
    p = Mamba(cfg, dtype=dtype, device=device)
    p.reset_parameters(generator)
    return p


def _scan_in_chunk(a, b):
    """Inclusive Hillis–Steele scan along axis 1 of ``(a, b)`` under
    ``(a_l, b_l) . (a_r, b_r) = (a_r a_l, a_r b_l + b_r)``: after it,
    ``b[:, t]`` is ``h_t`` from a zero state and ``a[:, t]`` the product
    of ``a`` up to ``t``."""
    Q = a.shape[1]
    shift = 1
    while shift < Q:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift]
                       + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return a, b


def _ssm_scan_chunked(a, b, h0, chunk: int):
    """First-order recurrence ``h_t = a_t h_{t-1} + b_t`` over axis 1.

    a, b: (B, S, d, N) fp32; h0: (B, d, N) fp32.  Returns (h at every t
    (B, S, d, N), the final state)."""
    S = a.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    h, out = h0, []
    for c0 in range(0, S, chunk):
        A_pref, B_pref = _scan_in_chunk(a[:, c0:c0 + chunk],
                                        b[:, c0:c0 + chunk])
        h_all = A_pref * h[:, None] + B_pref
        out.append(h_all)
        h = h_all[:, -1]
    # the final state a copy: as a view it would hold its whole chunk
    return torch.cat(out, dim=1), h.clone()


def _causal_conv(x, w, b, K: int, history=None):
    """Depthwise causal conv, width K.  x: (B, S, di); w: (K, di);
    history: (B, K-1, di) previous inputs (decode/prefill chaining).
    A sum of K shifted products in x's dtype, in the reference's order."""
    if history is None:
        history = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([history, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    return out + b


def _in_proj(p: Mamba, x, ctx):
    """``(x_in, z)``, each (..., di) or, with ``ctx``, the rank's di/tp
    channels (``in_proj`` column-parallel)."""
    if ctx is None:
        xz = layers.dense(p.in_proj, x)
    else:
        xz = tp.col_parallel_dense(x, p.in_proj.w, ctx, p.in_proj.b)
    return torch.split(xz, xz.shape[-1] // 2, dim=-1)


def _ssm_inputs(p: Mamba, x_conv, cfg, ctx):
    """``(dt (.., di) fp32, B_t, C_t)`` from the convolved inputs; with
    ``ctx`` ``x_proj``'s partial is summed over the model group first
    (``g``) and taken into the rank's channels (``f``): the sum of
    ``(dt_r, B, C)`` is the same on every model rank and each rank's
    channels use all of it, so its gradient, each rank's channels'
    share, is summed over the model group on its way back to ``x_proj``
    and the convolved inputs."""
    r, N = cfg.dt_rank, cfg.ssm_state
    dbl = layers.dense(p.x_proj, x_conv)
    if ctx is not None:
        dbl = tp.copy_to_tp(tp.psum_tp(dbl, ctx, cfg.tp_collectives), ctx)
    dt_r, B_t, C_t = torch.split(dbl, [r, N, N], dim=-1)
    dt = F.softplus(layers.dense(p.dt_proj, dt_r).float()
                    + p.dt_bias.float())
    return dt, B_t, C_t


def _ssm_out(p: Mamba, y, x_conv, z, dtype, cfg, ctx):
    y = y + p.D * x_conv.float()
    y = (y * F.silu(z.float())).to(dtype)
    if ctx is None:
        return layers.dense(p.out_proj, y)
    return tp.row_parallel_dense(y, p.out_proj.w, ctx, p.out_proj.b,
                                 collectives=cfg.tp_collectives)


def mamba_apply(p: Mamba, x, cfg, *, state: Optional[SSMState] = None,
                chunk: int = 256, ctx=None) -> Tuple[torch.Tensor, SSMState]:
    """Full-sequence forward.  x: (B, S, d).  Returns (y, final state);
    the state's ``conv`` is a copy, so it holds no view of this call's
    activations.  With ``ctx``: x and y are the rank's rows, whole; the
    state its block."""
    B, S, _ = x.shape
    N, K = cfg.ssm_state, cfg.ssm_conv
    x_in, z = _in_proj(p, x, ctx)                           # (B, S, di)
    di = x_in.shape[-1]
    hist = None if state is None else state.conv
    x_conv = F.silu(_causal_conv(x_in, p.conv_w, p.conv_b, K, hist))

    dt, B_t, C_t = _ssm_inputs(p, x_conv, cfg, ctx)
    A = -torch.exp(p.A_log)                                  # (di, N)
    a = torch.exp(dt[..., None] * A)                         # (B,S,di,N)
    b = (dt * x_conv.float())[..., None] * B_t.float()[..., None, :]
    h0 = (x.new_zeros((B, di, N), dtype=torch.float32) if state is None
          else state.ssm)
    h, h_fin = _ssm_scan_chunked(a, b, h0, chunk)
    del a, b
    y = torch.einsum("bsdn,bsn->bsd", h, C_t.float())
    del h
    out = _ssm_out(p, y, x_conv, z, x.dtype, cfg, ctx)
    new_state = SSMState(conv=x_in[:, S - (K - 1):, :].clone(), ssm=h_fin)
    return out, new_state


def mamba_decode(p: Mamba, x, state: SSMState, cfg, ctx=None
                 ) -> Tuple[torch.Tensor, SSMState]:
    """Single-token decode.  x: (B, 1, d).  Returns (y (B, 1, d), the
    new state); with ``ctx`` as :func:`mamba_apply`."""
    K = cfg.ssm_conv
    x_in, z = _in_proj(p, x[:, 0], ctx)                      # (B, di)
    conv_hist = torch.cat([state.conv, x_in[:, None]], dim=1)
    x_conv = sum(conv_hist[:, i] * p.conv_w[i] for i in range(K))
    x_conv = F.silu(x_conv + p.conv_b)

    dt, B_t, C_t = _ssm_inputs(p, x_conv, cfg, ctx)
    A = -torch.exp(p.A_log)
    a = torch.exp(dt[..., None] * A)                         # (B, di, N)
    b = (dt * x_conv.float())[..., None] * B_t.float()[:, None, :]
    h = a * state.ssm + b
    y = torch.einsum("bdn,bn->bd", h, C_t.float())
    out = _ssm_out(p, y, x_conv, z, x.dtype, cfg, ctx)
    return out[:, None], SSMState(conv=conv_hist[:, 1:], ssm=h)


def init_ssm_state(cfg, B: int, dtype, device=None, ctx=None) -> SSMState:
    """A zero state of B rows (with ``ctx`` this rank's block of it,
    ``launch.specs.ssm_state_shapes``): the conv history in ``dtype``, the
    recurrent state fp32."""
    conv, ssm = specs.ssm_state_shapes(cfg, B, ctx)
    return SSMState(conv=torch.zeros(conv, dtype=dtype, device=device),
                    ssm=torch.zeros(ssm, dtype=torch.float32, device=device))
