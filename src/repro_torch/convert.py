"""Carry the JAX package's parameters across.  For matrix completion the
parameters are the factors: global ``W (m, k)`` / ``H (n, k)`` numpy
arrays, as a reference ``FitResult`` or checkpoint holds them, on one
side, and the port's sharded ``(p, m_local, k)`` / ``(p, n_local, k)``
torch tensors on the other.

bf16 travels through an fp32 carrier (numpy has no bfloat16 of its own;
the reference checkpoint stores bf16 the same way): every bf16 value is
exact in fp32, so the round trip is lossless.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ._device import resolve_device
from .core import partition as part
from .kernels.policy import KernelPolicy


def factors_from_reference(W, H, br: part.BlockedRatings, *,
                           dtype_policy: str = "fp32",
                           device: Optional[Union[str, torch.device]] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shard global numpy factors for ``br`` and store them in the
    policy's storage dtype on ``device`` (``None`` = ``"cuda"``).
    Padding rows are zero."""
    dev = resolve_device(device)
    sd = KernelPolicy(dtype_policy=dtype_policy).storage_dtype
    Ws, Hs = part.shard_factors(np.asarray(W).astype(np.float32),
                                np.asarray(H).astype(np.float32), br)
    return (torch.from_numpy(Ws).to(device=dev, dtype=sd),
            torch.from_numpy(Hs).to(device=dev, dtype=sd))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)         # the fp32 carrier
    return t.numpy()


def factors_to_reference(Ws: torch.Tensor, Hs: torch.Tensor,
                         br: part.BlockedRatings
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Gather sharded factors back into global numpy ``(W, H)``: fp32 and
    fp16 keep their dtype, bf16 comes back as its fp32 carrier."""
    return part.unshard_factors(_to_numpy(Ws), _to_numpy(Hs), br)
