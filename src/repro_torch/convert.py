"""Carry the JAX package's parameters across.  For matrix completion the
parameters are the factors: global ``W (m, k)`` / ``H (n, k)`` numpy
arrays, as a reference ``FitResult`` or checkpoint holds them, on one
side, and the port's sharded ``(p, m_local, k)`` / ``(p, n_local, k)``
torch tensors on the other.  For serving, :func:`serving_factors` turns
the same global arrays (and an int8 view's scales) into the tensors the
port's ``FactorStore`` publishes.

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


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy on the host (bf16 as its fp32 carrier)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)         # the fp32 carrier
    return t.numpy()


def factors_to_reference(Ws: torch.Tensor, Hs: torch.Tensor,
                         br: part.BlockedRatings
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Gather sharded factors back into global numpy ``(W, H)``: fp32 and
    fp16 keep their dtype, bf16 comes back as its fp32 carrier."""
    return part.unshard_factors(to_numpy(Ws), to_numpy(Hs), br)


def serving_array(A, device: Optional[Union[str, torch.device]] = None,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One factor array as the serving store holds it: a tensor on
    ``device`` (``None`` = ``"cuda"``), in ``dtype`` when given (the fp32
    carrier of bf16 factors back to bf16, exactly).  Takes numpy arrays,
    bfloat16 ones from the JAX package included (their dtype is named
    ``"bfloat16"``; they travel as their fp32 carrier), and tensors."""
    dev = resolve_device(device)
    if not isinstance(A, torch.Tensor):
        A = np.asarray(A)
        if A.dtype.name == "bfloat16":
            A = torch.from_numpy(A.astype(np.float32)).to(torch.bfloat16)
        else:
            A = torch.from_numpy(np.array(A, order="C"))
    return A.to(device=dev, dtype=dtype).contiguous()


def serving_factors(W, H, *, w_scale=None, h_scale=None,
                    dtype_policy: Optional[str] = None,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> dict:
    """A reference ``FitResult``'s or ``FactorView``'s global ``W``/``H``
    (and, for an int8 view, its ``w_scale``/``h_scale``) as the fields of
    the port's ``FactorView``: tensors on ``device``.  ``dtype_policy``
    stores the factors in that policy's dtype (a bf16 run's fp32 carrier
    as bf16); ``None`` keeps their own dtype."""
    sd = (None if dtype_policy is None
          else KernelPolicy(dtype_policy=dtype_policy).storage_dtype)
    out = dict(W=serving_array(W, device, sd), H=serving_array(H, device, sd),
               w_scale=None, h_scale=None)
    if (w_scale is None) != (h_scale is None):
        raise ValueError("w_scale and h_scale come together")
    if w_scale is not None:
        out["w_scale"] = serving_array(w_scale, device, torch.float32)
        out["h_scale"] = serving_array(h_scale, device, torch.float32)
    return out
