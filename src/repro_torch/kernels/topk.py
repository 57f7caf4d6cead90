"""The serving top-k as one hand-written CUDA kernel (``csrc/topk.cu``),
its wrapper and its plain PyTorch version.

Replaces the JAX package's Pallas kernel ``src/repro/serve/topk.py::
_topk_pallas``: for user rows ``W_u (U, k)`` and the catalog ``H (n,
k)``, the ``k_top`` best items by (score descending, item id ascending),
exact, ties included.  Scores are summed in fp32 and rounded once to the
score dtype (``W_u``'s) before selection; with an int8 ``H`` the
per-item ``h_scale`` multiplies the fp32 sum after the dot.  A score of
``-inf`` reports the sentinel id ``n``.

:func:`topk_scores_cuda` launches the kernel on CUDA tensors (on the
current stream, without synchronising) or raises; on CPU tensors, and
only there, it runs :func:`topk_plain`.  It counts its launches in
``topk_scores_cuda.launches``.  :func:`plan` splits each call between
users per CTA and stripes of the catalog, from the card's SM count (see
the source's note); the TPU kernel's ``item_tile`` (VMEM blocking) is
accepted for signature parity and read only by the plain version.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build

#: (W_u dtype, H dtype) pairs the kernel takes, and their C codes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int8: 3}
PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.float16, torch.float16), (torch.float32, torch.int8))


#: as ``csrc/topk.cu`` has them: items per chunk (the threads of a CTA,
#: and one user's candidate buffer), its warps, the shared memory a block
#: may use, and the user blocks the kernel is instantiated for.  The plan
#: is made here alone; the C side checks it (``valid``) and refuses one
#: whose shared memory differs from its kernel's layout
CHUNK = 256
WARPS = CHUNK // 32
MAX_SMEM = 232_448
USER_BLOCKS = (32, 16, 8, 4, 2, 1)


class Plan(NamedTuple):
    """How one call splits its work: ``ub`` users per CTA, the catalog's
    ``n_chunks`` chunks of :data:`CHUNK` items cut into ``stripes`` of
    ``cps`` chunks (the last may be shorter, or empty), each keeping a
    running list of ``L`` keys per user in ``smem`` bytes of shared
    memory."""
    ub: int
    stripes: int
    cps: int
    L: int
    smem: int


def stripe_smem(ub: int, L: int, k: int) -> int:
    """Dynamic shared memory of one CTA (``csrc/topk.cu``'s
    ``stripe_smem``): ``W_u``'s rows padded to a multiple of 4, each
    user's list and candidate buffer, a checksum, the counters and each
    warp's 16-bit candidate ranks."""
    return (ub * (-(-k // 4) * 4) * 4 + ub * (L + CHUNK) * 8 + 8 + ub * 4
            + WARPS * CHUNK * 2)


def stripe_shape(n: int, k_top: int, stripes: int):
    """``(cps, L)`` for ``stripes`` stripes of an ``n``-item catalog."""
    cps = -(-(-(-n // CHUNK)) // stripes)
    return cps, min(k_top, cps * CHUNK)


@functools.lru_cache(maxsize=1024)
def plan(U: int, n: int, k: int, k_top: int, sms: int) -> Plan:
    """The user block and stripes of one call on a card of ``sms`` SMs:
    the largest user block (up to 32, and not above ``U`` rounded up to
    a power of two) whose CTA fits twice in an SM's shared memory, then
    as many stripes as make one wave of two CTAs per SM (a grid one CTA
    larger runs a second wave for it).  Where even one user's list of
    ``k_top`` keys does not fit, the stripes are cut short enough that it
    does.  Cached: a server asks it for every microbatch."""
    n_chunks = -(-n // CHUNK)
    budget = MAX_SMEM // 2
    ub_max = min(32, 1 << (U - 1).bit_length())
    for ub in USER_BLOCKS:
        if ub > ub_max:
            continue
        stripes = max(1, 2 * sms // -(-U // ub))
        cps, L = stripe_shape(n, k_top, stripes)
        if stripe_smem(ub, L, k) <= budget:
            break
    else:
        cps = (budget - stripe_smem(1, 0, k)) // 8 // CHUNK
        if cps < 1:
            raise ValueError(f"rank k={k} leaves no room for a list")
    stripes = -(-n_chunks // cps)
    cps, L = stripe_shape(n, k_top, stripes)
    return Plan(ub, stripes, cps, L, stripe_smem(ub, L, k))


def _tile_scores(W_u, tile, hs):
    """fp32 scores of one item tile, rounded once to the score dtype and
    held in fp32, ``-0.0`` made ``+0.0``."""
    s = W_u.float() @ tile.float().T
    if hs is not None:
        s = s * hs.float()[None, :]
    s = s.to(W_u.dtype).float()
    return torch.where(s == 0, torch.zeros_like(s), s)


def _select(scores, ids, k_top: int):
    """The ``k_top`` best columns of each row by (score desc, id asc):
    a stable sort on id, then a stable sort on ``-score``."""
    by_id = torch.sort(ids, dim=1, stable=True).indices
    scores = scores.gather(1, by_id)
    ids = ids.gather(1, by_id)
    order = torch.sort(-scores, dim=1, stable=True).indices[:, :k_top]
    return scores.gather(1, order), ids.gather(1, order)


def topk_plain(W_u, H, h_scale=None, *, k_top: int, item_tile: int = 4096):
    """Plain PyTorch version of the kernel, the counterpart of the JAX
    package's ``_topk_xla``: a Python loop over item tiles of width
    ``item_tile``, each scored ``W_u @ tile.T`` and merged into the
    running list by an explicit (score desc, id asc) selection.  Returns
    ``(scores, ids)``, ``(U, k_top)`` in ``W_u``'s dtype and int32."""
    U, n = W_u.shape[0], H.shape[0]
    T = min(item_tile, max(n, 1))
    dev = W_u.device
    run_s = torch.full((U, k_top), float("-inf"), device=dev)
    run_i = torch.full((U, k_top), n, dtype=torch.int64, device=dev)
    for base in range(0, n, T):
        tile = H[base:base + T]
        hs = None if h_scale is None else h_scale[base:base + T]
        s = _tile_scores(W_u, tile, hs)
        ids = torch.arange(base, base + tile.shape[0], device=dev)
        run_s, run_i = _select(torch.cat([run_s, s], 1),
                               torch.cat([run_i, ids.expand(U, -1)], 1),
                               k_top)
    run_i = torch.where(torch.isneginf(run_s), n, run_i)
    return run_s.to(W_u.dtype), run_i.to(torch.int32)


def _check(W_u, H, h_scale, k_top: int) -> None:
    if W_u.dim() != 2 or H.dim() != 2:
        raise ValueError(f"W_u/H must be 2-D, got {tuple(W_u.shape)} / "
                         f"{tuple(H.shape)}")
    if W_u.shape[1] != H.shape[1]:
        raise ValueError(f"rank mismatch: W_u has k={W_u.shape[1]}, H has "
                         f"k={H.shape[1]}")
    n = H.shape[0]
    if not 1 <= k_top <= n:
        raise ValueError(f"k_top must lie in [1, n_items={n}], got {k_top}")
    if (W_u.dtype, H.dtype) not in PAIRS:
        raise TypeError(f"W_u/H dtypes {W_u.dtype}/{H.dtype}: need one of "
                        f"{PAIRS}")
    if W_u.shape[0] < 1:
        raise ValueError("W_u has no rows")
    dev = W_u.device
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}")
    if H.device != dev:
        raise RuntimeError(f"H is on {H.device}, W_u on {dev}")
    if h_scale is not None:
        if h_scale.dtype != torch.float32 or tuple(h_scale.shape) != (n,):
            raise ValueError(f"h_scale must be float32 of shape ({n},), got "
                             f"{h_scale.dtype}{tuple(h_scale.shape)}")
        if h_scale.device != dev:
            raise RuntimeError(f"h_scale is on {h_scale.device}, W_u on "
                               f"{dev}")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def device_plan(W_u, H, k_top: int) -> Plan:
    """:func:`plan` for these inputs on their card."""
    return plan(W_u.shape[0], H.shape[0], W_u.shape[1], k_top,
                _sm_count(W_u.device))


def plan_args(p: Plan) -> tuple:
    """The plan as the C entry points take it: ``ub, S, cps, L, smem``."""
    return p.ub, p.stripes, p.cps, p.L, p.smem


def kernel_attrs(W_u, H, k_top: int) -> dict:
    """The plan of a call on these inputs and its pass-1 kernel's
    ``{ub, stripes, cps, L, regs, static_smem, dynamic_smem,
    local_bytes, ctas_per_sm}``, read by ``cudaFuncGetAttributes`` and
    the occupancy calculator on their card."""
    import ctypes
    lib = _build.load("topk")
    p = device_plan(W_u, H, k_top)
    keys = ("regs", "static_smem", "dynamic_smem", "local_bytes",
            "ctas_per_sm")
    vals = (ctypes.c_int * len(keys))()
    with torch.cuda.device(W_u.device):
        err = lib.topk_kernel_attrs(
            W_u.shape[0], H.shape[0], W_u.shape[1], _DTYPE_CODE[W_u.dtype],
            _DTYPE_CODE[H.dtype], k_top, *plan_args(p), vals)
    if err != 0:
        raise RuntimeError(f"topk kernel attributes: code {err}")
    return dict(ub=p.ub, stripes=p.stripes, cps=p.cps, L=p.L,
                **dict(zip(keys, vals)))


def _launch(W_u, H, h_scale, k_top: int):
    lib = _build.load("topk")
    U, k = W_u.shape
    n = H.shape[0]
    for name, t in (("W_u", W_u), ("H", H), ("h_scale", h_scale)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    p = device_plan(W_u, H, k_top)
    elems = lib.topk_scratch_elems(U, p.stripes, p.L, k_top)
    dev = W_u.device
    bufs = [torch.empty(elems, dtype=torch.int64, device=dev)
            for _ in range(2)]
    out_s = torch.empty((U, k_top), dtype=W_u.dtype, device=dev)
    out_i = torch.empty((U, k_top), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.topk_scores(
            W_u.data_ptr(), H.data_ptr(),
            None if h_scale is None else h_scale.data_ptr(), U, n, k,
            _DTYPE_CODE[W_u.dtype], _DTYPE_CODE[H.dtype], k_top,
            *plan_args(p), bufs[0].data_ptr(), bufs[1].data_ptr(), elems,
            out_s.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"topk_scores launch failed: code {err}")
    return out_s, out_i


def topk_scores_cuda(W_u, H, h_scale=None, *, k_top: int,
                     item_tile: int = 4096):
    """Top-``k_top`` items of each row of ``W_u`` over the catalog ``H``
    (the JAX package's ``_topk_pallas`` signature).  The kernel on CUDA
    tensors, :func:`topk_plain` on CPU tensors.  Returns ``(scores,
    ids)``."""
    _check(W_u, H, h_scale, k_top)
    if W_u.device.type == "cpu":
        return topk_plain(W_u, H, h_scale, k_top=k_top, item_tile=item_tile)
    out = _launch(W_u, H, h_scale, k_top)
    topk_scores_cuda.launches += 1
    return out


topk_scores_cuda.launches = 0


def reset_launches() -> None:
    topk_scores_cuda.launches = 0

