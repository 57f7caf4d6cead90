"""Public block-SGD entry points, dispatched through a
:class:`KernelPolicy`.

Dispatch mirrors the JAX package: ``'xla'``/``'wave'`` run the plain
PyTorch versions in :mod:`.ref`, ``'pallas'``/``'wave_pallas'`` the CUDA
kernel's wrappers in :mod:`.nomad_sgd` (which run their plain CSR version
on CPU tensors), and ``'auto'`` resolves to ``'pallas'`` when the factors
are on CUDA and to ``'xla'`` elsewhere — as the JAX package resolves it
to the Pallas kernel on a TPU.

Precision threads through from :class:`KernelPolicy.dtype_policy`:
``compute_dtype``/``accum_fp32`` select fp32 accumulation over
low-precision factor storage; the fp32 policy inserts no cast anywhere.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from . import ref
from .nomad_sgd import (WaveCSR, nomad_sgd_block, nomad_sgd_waves_block,
                        nomad_sgd_waves_csr, nomad_sgd_waves_grid)
from .policy import KernelPolicy


def _run_wave(W, H, rows, cols, vals, mask, lr, lam, policy):
    return ref.block_sgd_waves(W, H, rows, cols, vals, mask, lr, lam,
                               compute_dtype=policy.compute_dtype)


def _run_wave_pallas(W, H, rows, cols, vals, mask, lr, lam, policy):
    return nomad_sgd_waves_block(W, H, rows, cols, vals, mask, lr, lam,
                                 wave_chunk=policy.wave_chunk,
                                 accum_fp32=policy.mixed)


def _run_xla(W, H, rows, cols, vals, mask, lr, lam, policy):
    return ref.block_sgd_ref(W, H, rows, cols, vals, mask, lr, lam,
                             compute_dtype=policy.compute_dtype)


def _run_pallas(W, H, rows, cols, vals, mask, lr, lam, policy):
    return nomad_sgd_block(W, H, rows, cols, vals, mask, lr, lam,
                           chunk=policy.chunk, accum_fp32=policy.mixed)


_DISPATCH = {
    "wave": _run_wave,
    "wave_pallas": _run_wave_pallas,
    "xla": _run_xla,
    "pallas": _run_pallas,
}


def _resolve(policy, impl, chunk, wave_chunk, device):
    if policy is None:
        policy = KernelPolicy(impl=impl, chunk=chunk, wave_chunk=wave_chunk)
    elif isinstance(policy, str):
        policy = KernelPolicy(impl=policy, chunk=chunk,
                              wave_chunk=wave_chunk)
    name = policy.impl
    if name == "auto":
        name = "pallas" if device.type == "cuda" else "xla"
    return policy, name


def block_sgd(W, H, rows, cols, vals, mask, lr, lam, *,
              policy: Optional[Union[KernelPolicy, str]] = None,
              impl: str = "auto", chunk: int = 1024, wave_chunk: int = 8):
    """NOMAD block SGD update of one cell, dispatched through a
    :class:`KernelPolicy` (or the legacy ``impl``/``chunk``/``wave_chunk``
    kwargs).  For the sequential impls rows/cols/vals/mask are flat
    ``(nnz,)`` rating lists; for the wave impls the conflict-free
    ``(n_waves, wave_width)`` layouts emitted by ``partition.pack``.
    Returns new ``(W, H)``."""
    policy, name = _resolve(policy, impl, chunk, wave_chunk, W.device)
    return _DISPATCH[name](W, H, rows, cols, vals, mask, lr, lam, policy)


def block_sgd_cells(Ws, Hs, rows, cols, vals, mask, lr, lam, *,
                    policy: KernelPolicy):
    """One schedule step's batch of cell updates: ``Ws``/``Hs`` are
    ``(p, m_tile, k)``/``(p, n_tile, k)`` and the rating arrays carry a
    matching leading cell axis.  The cells of a step touch pairwise
    disjoint factor blocks, so they are independent.

    ``wave_pallas`` on CUDA factors (or when ``policy.block_rows`` asks
    for it) updates the whole batch in one kernel launch
    (:func:`~.nomad_sgd.nomad_sgd_waves_grid`); everything else updates
    the cells one by one through :func:`block_sgd`.  Returns new
    ``(Ws, Hs)``."""
    if policy.impl == "wave_pallas" and policy.wants_grid(
            int(Ws.shape[1]), int(Hs.shape[1]), Ws.device):
        return nomad_sgd_waves_grid(
            Ws, Hs, rows, cols, vals, mask, lr, lam,
            wave_chunk=policy.wave_chunk, accum_fp32=policy.mixed)
    out = [block_sgd(Ws[c], Hs[c], rows[c], cols[c], vals[c], mask[c], lr,
                     lam, policy=policy) for c in range(Ws.shape[0])]
    return (torch.stack([w for w, _ in out]),
            torch.stack([h for _, h in out]))


def block_sgd_cells_csr(Ws, Hs, csr: WaveCSR, lr, lam, *,
                        policy: KernelPolicy):
    """:func:`block_sgd_cells` for the kernel impls on the engine's CSR
    of waves (``wave_pallas``, or ``pallas`` with one wave per rating),
    **in place** (the factor shards the JAX engine donates).  One kernel
    launch for all the cells when the policy wants the grid, one per
    cell otherwise."""
    if policy.wants_grid(int(Ws.shape[1]), int(Hs.shape[1]), Ws.device):
        nomad_sgd_waves_csr(Ws, Hs, csr, lr, lam, accum_fp32=policy.mixed)
        return Ws, Hs
    for c in range(Ws.shape[0]):
        nomad_sgd_waves_csr(Ws[c:c + 1], Hs[c:c + 1], csr.cells(c, c + 1),
                            lr, lam, accum_fp32=policy.mixed)
    return Ws, Hs
