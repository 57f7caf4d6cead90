"""Flash attention as plain torch ops: the forward of the JAX package's
``models/flash_xla.py::flash_attention_xla`` (``impl="xla"``).

The online softmax over key chunks of ``chunk`` keys, in fp32, never
materializing the ``S x S`` scores, is exactly the arithmetic of the
flash kernel's plain version, so this calls
:func:`repro_torch.kernels.flash_attn.flash_attention_plain` with key
blocks of ``chunk``.  The backward (a ``torch.autograd.Function`` over the
flash recurrence) comes with the training slice; this module serves
prefill.
"""
from __future__ import annotations

from ..kernels import flash_attn


def flash_attention_xla(q, k, v, causal: bool = True, chunk: int = 1024):
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D) with Hq % Hkv == 0.
    Returns (B, Hq, S, D) in q's dtype.  ``S`` must be a multiple of
    ``min(chunk, S)``.  Forward only; plain torch ops on any device."""
    chunk = min(chunk, q.shape[2])
    return flash_attn.flash_attention_plain(
        q, k, v, causal=causal, block_q=chunk, block_k=chunk)
