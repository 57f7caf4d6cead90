"""Comparison helpers for the port's checks (its tests and
``chip_smoke.py``).

:func:`low_precision_tolerance` bounds two low-precision results that
both compute in fp32 and round once: the fp32 bound plus units in the
last place of the type.  :func:`flash_p_rounding_tolerance` adds what the
tensor-core flash kernel's one more rounding (of the probabilities,
before ``P V``) can cost.

The rest compares two implementations of the block-SGD update that both
compute in fp32 over the same low-precision factor storage.

They differ only in the order of the k-dot's fp32 sum, a few fp32 ulps,
and a bf16 ulp is 2^16 fp32 ulps.  So their stored results disagree only
where the two fp32 results straddle a rounding boundary of the storage
type (a flip), and afterwards in the values of the element that flipped:
on a rare element, by a few storage ulps (more when the element later
shrinks across binades).  :func:`assert_rare_flips` holds them to that
rarity.  A kernel that skips updates, or accumulates in the storage
type, differs on most of the elements it updates.
"""
from __future__ import annotations

import math

import torch

#: most elements the update changed on which the two may differ: their
#: share, and a count for tiny tensors (one flip and its echo)
FLIP_SHARE = 2.0 ** -10
FLIP_SLACK = 2

#: significand bits (the implicit one included) of the types :func:`ulp`
#: takes
_MANTISSA = {torch.bfloat16: 8, torch.float16: 11, torch.float32: 24}


def ulp(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The unit in the last place of ``dtype`` at each value of ``x``, in
    float64 (at 0 and below the normal range: at ``dtype``'s smallest
    normal)."""
    _, e = torch.frexp(x.double())
    e = torch.clamp(e, min=math.frexp(torch.finfo(dtype).tiny)[1])
    return torch.ldexp(torch.ones_like(e, dtype=torch.float64),
                       e - _MANTISSA[dtype])


def low_precision_tolerance(want: torch.Tensor, dtype: torch.dtype,
                            n_ulps: float = 2.0,
                            fp32_rel: float = 2e-5) -> torch.Tensor:
    """Per-element bound of two results that compute in fp32 and round
    once to ``dtype``: their fp32 values may differ by ``fp32_rel`` of
    ``1 + |want|`` (sums in another order, cancellation included), and
    rounding adds up to ``n_ulps`` units in the last place of ``dtype``
    at ``want``."""
    w = want.double()
    return n_ulps * ulp(w, dtype) + fp32_rel * (1 + w.abs())


#: machine epsilon (twice the unit roundoff) of the types the flash
#: kernel rounds its probabilities to
P_EPS = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


def flash_p_rounding_tolerance(want: torch.Tensor, abs_v_out: torch.Tensor,
                               dtype: torch.dtype) -> torch.Tensor:
    """Per-element bound of the bf16/fp16 flash kernel against its plain
    version ``want``:

        |got - want| <= 2e-5 (1 + |want|) + 2 ulps_T(want)
                        + eps_T * plain(q, k, |v|)

    where ``abs_v_out`` is ``plain(q, k, |v|)``, the plain version on the
    same q, k and ``v.abs()`` (computed in fp32), and ``eps_T``
    (:data:`P_EPS`) is ``dtype``'s machine epsilon.

    Derivation.  Per row, both compute ``o = sum_j p_j v_j / l`` with
    ``p_j = exp(s_j - m)`` and ``l = sum_j p_j`` in fp32.  The plain
    version keeps ``p_j`` in fp32; the kernel rounds each ``p_j`` once to
    ``dtype`` before the product with V (``l`` still sums the fp32
    values).  Rounding to nearest moves ``p_j`` by at most the unit
    roundoff ``u_T = eps_T / 2`` of it, so the output moves by at most
    ``u_T * sum_j p_j |v_j| / l``, which is ``u_T * plain(q, k, |v|)``
    exactly (the rescaling of the online softmax multiplies ``p_j`` and
    its error alike).  The rest is :func:`low_precision_tolerance`: the
    fp32 sums in another order, and each side rounding its output once.
    ``eps_T`` is twice ``u_T``, kept as margin.  Not covered: a ``p_j``
    below the type's normal range (``2^-14`` in fp16), whose rounding
    error is up to half the smallest subnormal (``2^-25``) rather than
    relative; it needs scores that differ by more than ``14 ln 2`` and
    then weighs ``2^-25`` per key.
    """
    return (low_precision_tolerance(want, dtype)
            + P_EPS[dtype] * abs_v_out.double())


def flips(got: torch.Tensor, want: torch.Tensor, start: torch.Tensor
          ) -> tuple:
    """``(differing, changed)``: how many elements of ``got`` differ
    from ``want``, and how many elements ``want`` changed from
    ``start``."""
    if not got.dtype == want.dtype == start.dtype or not (
            got.shape == want.shape == start.shape):
        raise TypeError(f"need three tensors of one dtype and shape, got "
                        f"{got.dtype}{tuple(got.shape)}, "
                        f"{want.dtype}{tuple(want.shape)}, "
                        f"{start.dtype}{tuple(start.shape)}")
    return int((got != want).sum()), int((want != start).sum())


def assert_rare_flips(got: torch.Tensor, want: torch.Tensor,
                      start: torch.Tensor, what: str = "") -> tuple:
    """Raise unless both are finite and ``got`` differs from ``want`` on
    at most ``FLIP_SLACK + FLIP_SHARE * changed`` elements
    (:func:`flips`); return ``(differing, changed)``."""
    if not (bool(torch.isfinite(got).all())
            and bool(torch.isfinite(want).all())):
        raise AssertionError(f"{what}: non-finite values")
    differing, changed = flips(got, want, start)
    if differing > FLIP_SLACK + FLIP_SHARE * changed:
        raise AssertionError(
            f"{what}: {differing} elements differ of {changed} updated "
            f"(bound {FLIP_SLACK} + {FLIP_SHARE:g} x updated)")
    return differing, changed
