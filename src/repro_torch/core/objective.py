"""Matrix-completion objective, per-rating SGD updates, metrics.

Implements eq. (1) of the paper in its simplified per-rating form

    J(W,H) = 1/2 sum_{(i,j) in Omega} [ (A_ij - <w_i,h_j>)^2
                                        + lam (||w_i||^2 + ||h_j||^2) ]

and the SGD updates (9)/(10).  Note eq. (10) of the paper contains a typo
(``w_{j_t}``); both updates use the *old* values of ``w_i`` and ``h_j``,
which is what every published implementation (including the authors') does.

The numpy half is the reference package's, verbatim; the torch half
(:func:`init_factors`, :func:`rmse`, :func:`objective`) takes an explicit
``torch.Generator`` / device.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch


def init_factors(generator: torch.Generator, m: int, n: int, k: int, *,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = "cpu"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """W, H ~ UniformReal(0, 1/sqrt(k)) as in Algorithm 1, lines 4-5.

    The draw happens on ``generator``, which must be a CPU generator, and
    only then moves to ``device`` — so the same seed gives the same
    factors on the CPU and on the card.  (JAX's threefry stream cannot be
    reproduced here; tests that compare with the JAX package inject the
    same factors into both instead of sharing a seed.)"""
    if generator.device.type != "cpu":
        raise ValueError("init_factors draws on a CPU torch.Generator")
    scale = 1.0 / np.sqrt(k)
    W = torch.rand((m, k), generator=generator, dtype=torch.float32) * scale
    H = torch.rand((n, k), generator=generator, dtype=torch.float32) * scale
    return W.to(device=device, dtype=dtype), H.to(device=device, dtype=dtype)


def init_factors_np(seed: int, m: int, n: int, k: int,
                    dtype=np.float64) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy twin of :func:`init_factors` for the discrete-event simulator."""
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(k)
    W = rng.uniform(0.0, scale, size=(m, k)).astype(dtype)
    H = rng.uniform(0.0, scale, size=(n, k)).astype(dtype)
    return W, H


def grow_factors(W: np.ndarray, H: np.ndarray, m_new: int, n_new: int, *,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Append factor rows for newly-arrived users/items.

    New rows draw from UniformReal(0, 1/sqrt(k)) — the same distribution
    Algorithm 1 initializes from — using an rng keyed on ``(seed,
    extended dims)`` so every growth round is deterministic yet distinct.
    Existing entries are copied bit for bit, which is what lets a
    streaming ``partial_fit`` match a warm-started batch refit exactly.
    """
    W = np.asarray(W)
    H = np.asarray(H)
    k = W.shape[1]
    rng = np.random.default_rng(
        (seed, W.shape[0] + m_new, H.shape[0] + n_new, 0x6806))
    scale = 1.0 / np.sqrt(k)
    W2 = np.concatenate(
        [W, rng.uniform(0.0, scale, size=(m_new, k)).astype(W.dtype)])
    H2 = np.concatenate(
        [H, rng.uniform(0.0, scale, size=(n_new, k)).astype(H.dtype)])
    return W2, H2


def sgd_pair_update(w, h, a, lr, lam):
    """One SGD update on a single rating (eqs. 9-10). Returns (w', h').

    Works for numpy arrays and torch tensors; uses old values for both
    grads.
    """
    err = a - w @ h
    w_new = w - lr * (-err * h + lam * w)
    h_new = h - lr * (-err * w + lam * h)
    return w_new, h_new


def objective(W, H, rows, cols, vals, lam) -> torch.Tensor:
    """J(W, H) over the given COO ratings (simplified per-rating form)."""
    wi = W[rows]
    hj = H[cols]
    err = vals - torch.sum(wi * hj, dim=-1)
    reg = torch.sum(wi * wi, dim=-1) + torch.sum(hj * hj, dim=-1)
    return 0.5 * torch.sum(err * err + lam * reg)


def rmse(W, H, rows, cols, vals) -> torch.Tensor:
    pred = torch.sum(W[rows] * H[cols], dim=-1)
    return torch.sqrt(torch.mean((vals - pred) ** 2))


def rmse_np(W, H, rows, cols, vals):
    pred = np.sum(W[rows] * H[cols], axis=-1)
    return float(np.sqrt(np.mean((vals - pred) ** 2)))


def objective_np(W, H, rows, cols, vals, lam):
    wi = W[rows]
    hj = H[cols]
    err = vals - np.sum(wi * hj, axis=-1)
    reg = np.sum(wi * wi, axis=-1) + np.sum(hj * hj, axis=-1)
    return float(0.5 * np.sum(err * err + lam * reg))
