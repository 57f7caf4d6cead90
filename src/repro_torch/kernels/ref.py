"""Plain PyTorch versions of the block-SGD kernel, and the materialized
attention oracle of the flash kernel (:func:`flash_attention_ref`).

``block_sgd_ref`` is *the* canonical semantics of a NOMAD block update:
sequential SGD over the ratings of one (worker, item-block) cell, exactly
Algorithm 1 lines 16-21 restricted to the cell.  The CUDA kernel and the
engine are validated against these functions.

Every function takes ``compute_dtype=None``: ``None`` runs every op in
the storage dtype, while an explicit dtype (fp32 under
``KernelPolicy.dtype_policy='bf16'``) gathers rows, upcasts, accumulates
the update in that dtype and downcasts on scatter — one rounding per
touched row per update.

The block functions are functional (they return new tensors, like the
JAX package's); scalars ``lr``/``lam`` may be Python floats or 0-dim
tensors and are materialized in the compute dtype before any arithmetic.
"""
from __future__ import annotations

import torch


def _scalar(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device)


def sgd_pair(w, h, a, lr, lam, compute_dtype=None):
    """One rating's update from the old ``w``/``h`` (eqs. 9-10)."""
    if compute_dtype is not None:
        sd = w.dtype
        wn, hn = sgd_pair(w.to(compute_dtype), h.to(compute_dtype),
                          _scalar(a, compute_dtype, w.device),
                          _scalar(lr, compute_dtype, w.device),
                          _scalar(lam, compute_dtype, w.device))
        return wn.to(sd), hn.to(sd)
    err = a - torch.dot(w, h)
    w_new = w - lr * (-err * h + lam * w)
    h_new = h - lr * (-err * w + lam * h)
    return w_new, h_new


def block_sgd_ref(W, H, rows, cols, vals, mask, lr, lam,
                  compute_dtype=None):
    """Sequential masked SGD over a padded rating list.

    W: (m_tile, k)  H: (n_tile, k)  rows/cols: (nnz,) indices into the
    tiles, vals/mask: (nnz,).  Padded entries (mask=False) are exact
    no-ops.  Returns updated (W, H).
    """
    cd = compute_dtype if compute_dtype is not None else W.dtype
    lr = _scalar(lr, cd, W.device)
    lam = _scalar(lam, cd, W.device)
    W = W.clone()
    H = H.clone()
    vals = vals.to(cd)
    for t, (i, j, m) in enumerate(zip(rows.tolist(), cols.tolist(),
                                      mask.tolist())):
        if not m:
            continue            # where(mask, new, old) keeps old exactly
        W[i], H[j] = sgd_pair(W[i], H[j], vals[t], lr, lam,
                              compute_dtype=compute_dtype)
    return W, H


def sgd_pair_batch(w, h, a, lr, lam, compute_dtype=None):
    """Batched :func:`sgd_pair` over a leading wave axis.

    w/h: (width, k), a: (width,).  Valid only when the rows of ``w`` (and
    of ``h``) refer to pairwise-distinct factor vectors — i.e. one
    conflict-free wave — in which case the batch is exactly equivalent to
    applying :func:`sgd_pair` sequentially in any order.
    """
    if compute_dtype is not None:
        sd = w.dtype
        wn, hn = sgd_pair_batch(
            w.to(compute_dtype), h.to(compute_dtype),
            _scalar(a, compute_dtype, w.device),
            _scalar(lr, compute_dtype, w.device),
            _scalar(lam, compute_dtype, w.device))
        return wn.to(sd), hn.to(sd)
    err = a - torch.sum(w * h, dim=-1)
    w_new = w - lr * (-err[:, None] * h + lam * w)
    h_new = h - lr * (-err[:, None] * w + lam * h)
    return w_new, h_new


def block_sgd_waves(W, H, rows, cols, vals, mask, lr, lam,
                    compute_dtype=None):
    """Wave-vectorized NOMAD block update (same math as
    :func:`block_sgd_ref`, executed one conflict-free wave at a time).

    rows/cols/vals/mask: (n_waves, wave_width) as emitted by
    ``partition.pack``/``pack_cell_waves``.  Waves execute in order (the
    serial linearization); within a wave rows and columns are
    pairwise-distinct so the batched gather -> sgd_pair_batch -> scatter
    is exactly a sequential execution of the wave.  Padded entries
    (mask=False) are gathered but never scattered.
    """
    cd = compute_dtype if compute_dtype is not None else W.dtype
    lr = _scalar(lr, cd, W.device)
    lam = _scalar(lam, cd, W.device)
    W = W.clone()
    H = H.clone()
    rows = rows.long()
    cols = cols.long()
    vals = vals.to(cd)
    for t in range(rows.shape[0]):
        r, c, m = rows[t], cols[t], mask[t]
        w_new, h_new = sgd_pair_batch(W[r], H[c], vals[t], lr, lam,
                                      compute_dtype=compute_dtype)
        W[r[m]] = w_new[m]
        H[c[m]] = h_new[m]
    return W, H


def flash_attention_ref(q, k, v, causal=True, scale=None):
    """Plain materialized attention, the oracle of the flash kernel (the
    JAX package's ``ref.flash_attention_ref``).

    q: (B, Hq, S, D), k/v: (B, Hkv, S, D) with Hq % Hkv == 0 (GQA).  The
    scores are taken in q's dtype and widened to fp32, masked with
    ``-inf``, softmaxed in fp32 and cast to v's dtype for the second
    product, as the reference does.
    """
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    kk = torch.repeat_interleave(k, group, dim=1)
    vv = torch.repeat_interleave(v, group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, kk).float() * scale
    if causal:
        msk = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                    device=q.device))
        logits = torch.where(msk[None, None], logits, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(vv.dtype), vv)
