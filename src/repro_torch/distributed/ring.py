"""NOMAD-style ring collectives over the LM mesh (the JAX package's
``src/repro/distributed/ring.py``): one operand stays with its owner,
the other travels around the ring of the ranks along ``axes``, and the
owner computes.

* :func:`ring_ag_matmul` computes ``all_gather(X) @ W_local`` without
  gathering X: the X shard circulates (``batch_isend_irecv``) while each
  owner multiplies it by its fixed weight block.
* :func:`ring_rs_matmul`, the reduce-scatter dual: the partial products
  stay with their owner, the accumulator travels.

Each hop is one :meth:`~repro_torch.launch.mesh.LmMesh.send_recv`
(16-bit tensors travel as their bytes).  The ``_ref`` versions use the
plain collectives.
"""
from __future__ import annotations

import torch

from ..launch.mesh import Axes, LmMesh


def ring_ag_matmul(x_block, w_local, mesh: LmMesh, axes: Axes):
    """x_block: (m_loc, d), this rank's rows of X (X sharded on rows over
    ``axes``); w_local: (d, f_loc).  Returns ``X_full @ w_local``, (m_loc
    * p, f_loc), in row order."""
    p, me = mesh.size(axes), mesh.index(axes)
    m_loc = x_block.shape[0]
    y = x_block.new_empty((p, m_loc, w_local.shape[1]))
    x_cur = x_block
    for i in range(p):
        # at hop i this rank holds the block that started at (me - i) % p
        y[(me - i) % p] = x_cur @ w_local
        if i + 1 < p:
            x_cur = mesh.send_recv(x_cur, axes, (me + 1) % p, (me - 1) % p)
    return y.reshape(p * m_loc, -1)


def ring_rs_matmul(x_local, w_local, mesh: LmMesh, axes: Axes):
    """x_local: (m, d_loc), w_local: (d_loc, f): the partial product
    ``x_local @ w_local`` summed over the ranks along ``axes``, scattered
    over rows.  Returns this rank's (m / p, f) block of the sum."""
    p, me = mesh.size(axes), mesh.index(axes)
    m, f = x_local.shape[0], w_local.shape[1]
    if m % p:
        raise ValueError(f"{m} rows are not divisible by {p} ranks")
    partial = (x_local @ w_local).reshape(p, m // p, f)
    acc = torch.zeros_like(partial[0])
    for i in range(p - 1):
        # the accumulator in hand at hop i is bound for row block
        # (me - 1 - i) % p: add this rank's partial for it and pass it on
        acc = mesh.send_recv(acc + partial[(me - 1 - i) % p], axes,
                             (me + 1) % p, (me - 1) % p)
    # after p - 1 hops it is bound for this rank's own block
    return acc + partial[me]


def ring_ag_matmul_ref(x_block, w_local, mesh: LmMesh, axes: Axes):
    """The plain collective: all_gather then matmul."""
    return mesh.all_gather(x_block, axes, dim=0) @ w_local


def ring_rs_matmul_ref(x_local, w_local, mesh: LmMesh, axes: Axes):
    """The plain collective: matmul then reduce_scatter."""
    return mesh.reduce_scatter(x_local @ w_local, axes, dim=0)
