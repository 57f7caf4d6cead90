"""Batched top-k scoring: ``scores = W[u_batch] @ H.T`` over the item
catalog, with the ``k_top`` best items of each user kept, tiled so the
full ``(batch, n_items)`` score matrix is never needed at once.

Two scorers, selected by :meth:`KernelPolicy.serve_impl`:

* ``'xla'``    — :func:`~repro_torch.kernels.topk.topk_plain`, the plain
  tiled scan in PyTorch (the counterpart of the JAX package's
  ``_topk_xla``);
* ``'pallas'`` — :func:`~repro_torch.kernels.topk.topk_scores_cuda`, the
  hand-written CUDA kernel (the counterpart of ``_topk_pallas``); on CPU
  tensors its wrapper runs the same plain scan.

``'auto'`` selects the kernel when the factors are on CUDA.  Both are
**exact** against the dense argsort oracle (:func:`topk_dense_oracle`)
with the reference's tie rule: equal scores resolve to the smaller item
id, always, and ``-0.0`` equals ``+0.0``.  Scores are summed in fp32 and
rounded once to the score dtype (``W_u``'s) before selection.

Inputs may be tensors or numpy arrays (numpy goes to a CPU tensor); the
scorers run where the tensors lie.
"""
from __future__ import annotations

import numpy as np
import torch

from ..convert import serving_array, to_numpy as to_host
from ..kernels import topk as _kernel
from ..kernels.policy import KernelPolicy

__all__ = ["topk_scores", "topk_scores_filtered", "topk_dense_oracle"]


def _tensor(A):
    """Tensors pass through; numpy arrays become CPU tensors."""
    if A is None or isinstance(A, torch.Tensor):
        return A
    return serving_array(A, "cpu")


def topk_dense_oracle(W_u, H, k_top: int, h_scale=None):
    """Dense reference: all scores at once, then a stable host argsort.

    Scores are those of the tiled scorers (fp32 sum, ``h_scale`` after
    the dot, one rounding to the score dtype); the ordering is an
    independent ``np.argsort(-scores, kind="stable")``: score-descending,
    ties by smaller item id.  Returns numpy ``(scores, ids)`` of shape
    ``(U, k_top)``."""
    W_u, H, h_scale = _tensor(W_u), _tensor(H), _tensor(h_scale)
    scores = to_host(_kernel._tile_scores(W_u, H, h_scale))
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k_top]
    return (np.take_along_axis(scores, order, axis=1),
            order.astype(np.int32))


def topk_scores(W_u, H, k_top: int, *,
                policy: KernelPolicy | str | None = None,
                item_tile: int = 4096, h_scale=None):
    """Top-``k_top`` items for a batch of user factor rows.

    W_u       -- (U, k_rank) gathered user factors
    H         -- (n_items, k_rank) item factors (device-resident)
    k_top     -- list length per user (1 <= k_top <= n_items)
    policy    -- KernelPolicy (or legacy impl string); ``serve_impl``
                 picks the plain scan or the CUDA kernel
    item_tile -- catalog tile width the plain scan streams over
    h_scale   -- optional (n_items,) per-row dequantization scales for
                 an int8-quantized ``H``: scores become
                 ``(W_u @ Hq.T) * h_scale``

    Returns ``(scores, ids)`` tensors, both ``(U, k_top)``,
    score-descending, ties by smaller id; exact vs.
    :func:`topk_dense_oracle`.
    """
    policy = KernelPolicy.coerce(policy)
    W_u, H, h_scale = _tensor(W_u), _tensor(H), _tensor(h_scale)
    n = int(H.shape[0])
    if not 1 <= k_top <= n:
        raise ValueError(
            f"k_top must lie in [1, n_items={n}], got {k_top}")
    if item_tile < 1:
        raise ValueError(f"item_tile must be >= 1, got {item_tile}")
    if W_u.shape[-1] != H.shape[-1]:
        raise ValueError(
            f"rank mismatch: W_u has k={W_u.shape[-1]}, H has "
            f"k={H.shape[-1]}")
    if policy.serve_impl(H.device) == "pallas":
        return _kernel.topk_scores_cuda(W_u, H, h_scale, k_top=k_top,
                                        item_tile=item_tile)
    return _kernel.topk_plain(W_u, H, h_scale, k_top=k_top,
                              item_tile=item_tile)


def topk_scores_filtered(W_u, H, k_top: int, *, exclude,
                         policy: KernelPolicy | str | None = None,
                         item_tile: int = 4096, h_scale=None):
    """:func:`topk_scores` with exact per-user candidate filtering:
    ``exclude[u]`` is an array of item rows user ``u`` must not be
    recommended (typically ``FactorView.rated_for``).

    Exactness by over-fetch: the scorer retrieves
    ``min(n, k_top + max_u |exclude[u]|)`` candidates, then drops each
    user's excluded ids on the host and keeps the first ``k_top``.  The
    survivors are in the total order (score desc, id asc) of the
    unfiltered scorer, so the result equals a dense oracle over the
    filtered catalog.  Users with fewer than ``k_top`` admissible items
    pad the tail with the sentinel id ``n`` and ``-inf`` score.  Returns
    numpy arrays (bf16 scores as their fp32 carrier)."""
    n = int(H.shape[0])
    U = int(W_u.shape[0])
    exclude = list(exclude)
    if len(exclude) > U:
        raise ValueError(
            f"exclude has {len(exclude)} entries for {U} users")
    max_ex = max((len(e) for e in exclude), default=0)
    kk = min(n, k_top + max_ex)
    s, ids = topk_scores(W_u, H, kk, policy=policy, item_tile=item_tile,
                         h_scale=h_scale)
    s, ids = to_host(s), to_host(ids)
    out_s = np.full((U, k_top), -np.inf, dtype=s.dtype)
    out_i = np.full((U, k_top), n, dtype=np.int32)
    for u in range(U):
        ex = (np.asarray(exclude[u], dtype=np.int64)
              if u < len(exclude) else np.zeros(0, np.int64))
        keep = ~np.isin(ids[u], ex) & (ids[u] < n)
        sel = np.flatnonzero(keep)[:k_top]
        out_s[u, : len(sel)] = s[u, sel]
        out_i[u, : len(sel)] = ids[u, sel]
    return out_s, out_i
