"""Serial SGD reference — the serializability oracle.

NOMAD's headline property is that its asynchronous execution is equivalent
to *some* serial ordering of SGD updates.  This module replays a given
ordering serially, in numpy float64 (bitwise-comparable against the
discrete-event simulator, ``core.async_sim``) and in torch float32 on an
explicit device (comparable against the NOMAD engine and its CUDA wave
kernel, which apply the same updates in the same per-variable order and
differ only in how the k-dot is summed).

:func:`replay_np` and :func:`run_epochs_np` are the JAX package's,
verbatim; :func:`replay_torch` is the counterpart of its ``replay_jax``.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .objective import sgd_pair_update


def replay_np(W, H, rows, cols, vals, order, lr, lam):
    """Apply SGD updates serially (in-place on copies) in ``order``.

    ``lr`` may be a scalar or an array aligned with ``order``.
    """
    W = W.copy()
    H = H.copy()
    lr_arr = np.broadcast_to(np.asarray(lr, dtype=W.dtype), (len(order),))
    for t, g in enumerate(order):
        i, j, a = int(rows[g]), int(cols[g]), W.dtype.type(vals[g])
        W[i], H[j] = sgd_pair_update(W[i], H[j], a, lr_arr[t], lam)
    return W, H


def _fp32(x) -> float:
    """``x`` rounded to fp32, as the Python float the torch ops take (so
    every operand of the update is an fp32 value)."""
    return float(np.float32(x))


def replay_torch(W, H, rows, cols, vals, order, lr, lam, *,
                 device: Optional[Union[str, torch.device]] = None):
    """Torch twin of :func:`replay_np` in fp32: copies of ``W``/``H``
    (tensors or arrays) on ``device`` (``None``: ``W``'s own device, the
    CPU for an array), then ``objective.sgd_pair_update`` on one rating
    after another, in ``order``.  ``rows``/``cols``/``vals`` are host
    arrays indexed by the entries of ``order``; ``lr`` is a scalar or an
    array aligned with ``order``.  Returns the updated ``(W, H)``."""
    if device is None:
        device = W.device if isinstance(W, torch.Tensor) else "cpu"
    W = torch.as_tensor(W).to(device=device, dtype=torch.float32,
                              copy=True)
    H = torch.as_tensor(H).to(device=device, dtype=torch.float32,
                              copy=True)
    order = np.asarray(order, dtype=np.int64)
    upd_rows = np.asarray(rows)[order].tolist()
    upd_cols = np.asarray(cols)[order].tolist()
    upd_vals = np.asarray(vals, dtype=np.float32)[order].tolist()
    lrs = np.broadcast_to(np.asarray(lr, dtype=np.float32),
                          (len(order),)).tolist()
    lam = _fp32(lam)
    for i, j, a, step in zip(upd_rows, upd_cols, upd_vals, lrs):
        W[i], H[j] = sgd_pair_update(W[i], H[j], a, step, lam)
    return W, H


def run_epochs_np(W, H, rows, cols, vals, schedule, lam, epochs, seed=0,
                  shuffle=True):
    """Plain serial SGD training loop: per-epoch random permutation of the
    ratings, step size keyed on the per-pair update count (= epoch)."""
    rng = np.random.default_rng(seed)
    nnz = len(rows)
    for e in range(epochs):
        order = rng.permutation(nnz) if shuffle else np.arange(nnz)
        W, H = replay_np(W, H, rows, cols, vals, order, schedule(e), lam)
    return W, H
