"""Synthetic rating generators.

``netflix_like`` reproduces the §5.5 protocol: per-user and per-item
rating counts are sampled from an empirical power-law-ish degree
distribution shaped like Netflix's; nonzero locations conditioned on the
degrees are uniform; ground-truth factors are standard Gaussian; ratings
get N(0, 0.1) noise.  Scaling the user count with the worker count gives
the paper's weak-scaling experiment (Fig. 12).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np


def _powerlaw_degrees(rng, count, mean_deg, alpha=1.5, max_deg=None):
    """Zipf-ish degrees with the requested mean."""
    raw = rng.pareto(alpha, size=count) + 1.0
    deg = raw / raw.mean() * mean_deg
    if max_deg is not None:
        deg = np.minimum(deg, max_deg)
    return np.maximum(1, deg.astype(np.int64))


#: ratings whose ``<w_i, h_j>`` one step of :func:`synthetic_ratings`
#: computes, into two float64 ``(chunk, k)`` buffers it reuses (3.3 MB at
#: k=100: small enough to stay in cache, no page faults per step)
CHUNK = 1 << 12
#: ratings below which the true ratings are computed on one thread
THREADED_FROM = 1 << 20


def _dots(W, H, rows, cols, out, chunk: int) -> None:
    """``out[t] = <W[rows[t]], H[cols[t]]>``, ``chunk`` ratings a step."""
    wbuf = np.empty((min(chunk, len(rows)), W.shape[1]))
    hbuf = np.empty_like(wbuf)
    for lo in range(0, len(rows), chunk):
        hi = min(lo + chunk, len(rows))
        w, h = wbuf[:hi - lo], hbuf[:hi - lo]
        np.take(W, rows[lo:hi], axis=0, out=w)
        np.take(H, cols[lo:hi], axis=0, out=h)
        np.multiply(w, h, out=w)
        np.sum(w, axis=-1, out=out[lo:hi])


def synthetic_ratings(m: int, n: int, nnz: int, k: int = 16, *, seed: int = 0,
                      noise: float = 0.1, powerlaw: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray]:
    """Returns (rows, cols, vals, W_true, H_true).

    The true ratings ``<w_i, h_j>`` are computed :data:`CHUNK` ratings at
    a time, so no ``(nnz, k)`` array lives whole (at the paper's full
    Netflix size one would be 79 GB), on one thread per CPU in contiguous
    spans from :data:`THREADED_FROM` ratings (numpy releases the GIL in
    each step).  Each rating's dot is reduced on its own, so the result is
    bitwise the one-piece computation's whatever the chunk or the thread;
    the random draws stay on the one generator, in the same order."""
    rng = np.random.default_rng(seed)
    if powerlaw:
        user_deg = _powerlaw_degrees(rng, m, nnz / m, max_deg=n)
        rows = np.repeat(np.arange(m, dtype=np.int64), user_deg)
        # item popularity also power-law: sample cols with Zipf weights
        item_w = (rng.pareto(1.2, size=n) + 1.0)
        item_p = item_w / item_w.sum()
        cols = rng.choice(n, size=len(rows), p=item_p)
    else:
        rows = rng.integers(0, m, nnz)
        cols = rng.integers(0, n, nnz)
    # §5.5: factors ~ N(0, I_k); ratings get N(0, noise) noise
    W = rng.standard_normal((m, k)) / np.sqrt(k)
    H = rng.standard_normal((n, k)) / np.sqrt(k)
    vals = np.empty(len(rows), dtype=np.float64)
    threads = min(len(os.sched_getaffinity(0)),
                  max(1, len(rows) // THREADED_FROM))
    if threads == 1:
        _dots(W, H, rows, cols, vals, CHUNK)
    else:
        cut = [-(-len(rows) * i // threads // CHUNK) * CHUNK
               for i in range(threads)] + [len(rows)]
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(lambda i: _dots(
                W, H, rows[cut[i]:cut[i + 1]], cols[cut[i]:cut[i + 1]],
                vals[cut[i]:cut[i + 1]], CHUNK), range(threads)))
    vals += noise * rng.standard_normal(len(rows))
    return rows, cols, vals, W, H


def netflix_like(scale: float = 1e-4, *, seed: int = 0, k: int = 16):
    """A Netflix-shaped dataset shrunk by ``scale`` (keeps m:n ratio and
    mean ratings/user).  scale=1.0 is the full 100M-rating problem."""
    m = max(64, int(2_649_429 * np.sqrt(scale)))
    n = max(32, int(17_770 * np.sqrt(scale)))
    nnz = max(1000, int(99_072_112 * scale))
    return synthetic_ratings(m, n, nnz, k=k, seed=seed)


def train_test_split(rows, cols, vals, test_frac=0.1, seed=0):
    rng = np.random.default_rng(seed)
    nnz = len(rows)
    perm = rng.permutation(nnz)
    ntest = int(nnz * test_frac)
    te, tr = perm[:ntest], perm[ntest:]
    return ((rows[tr], cols[tr], vals[tr]),
            (rows[te], cols[te], vals[te]))
