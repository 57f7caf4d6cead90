"""Comparison helper for the port's checks (its tests and
``chip_smoke.py``): two implementations of the update that both compute
in fp32 over the same low-precision factor storage.

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

import torch

#: most elements the update changed on which the two may differ: their
#: share, and a count for tiny tensors (one flip and its echo)
FLIP_SHARE = 2.0 ** -10
FLIP_SLACK = 2


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
