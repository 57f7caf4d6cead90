"""Causal GQA flash attention as one hand-written CUDA kernel
(``csrc/flash_attn.cu``), its wrapper and its plain PyTorch version.

Replaces the JAX package's Pallas kernel ``src/repro/kernels/flash_attn.py::
flash_attention``: q ``(B, Hq, S, D)``, k/v ``(B, Hkv, S, D)`` with ``Hq %
Hkv == 0``; query head ``h`` reads KV head ``h // (Hq // Hkv)``.  Online
softmax in fp32 over key blocks, masked scores ``-1e30``, the final divide
by ``max(l, 1e-30)``, the output in q's dtype.  D up to 128; fp32, bf16
and fp16.  Two kernels, by dtype: bf16 and fp16 run on the tensor cores
(``mma.sync``, K/V tiles through ``cp.async``), rounding the
probabilities once to the input type before ``P V`` (see
``repro_torch.testing.flash_p_rounding_tolerance``); fp32 runs on the FMA
units and keeps them in fp32.  The tensor-core kernel copies rows in
16-byte chunks where :func:`vector_loads` holds, else element by element.

:func:`flash_attention` launches the kernel on CUDA tensors (on the
current stream, without synchronising) or raises; on CPU tensors, and
only there, it runs :func:`flash_attention_plain`.  It counts its
launches in ``flash_attention.launches``.  The kernel tiles by 64 query
rows and 64 keys; ``block_q``/``block_k`` keep the reference's contract
(``S`` a multiple of each, once cut to ``S``) and set the key blocks of
the plain version.  The tensors may be strided views (the transposes of
``(B, S, H, D)`` projections), as long as the feature axis is
contiguous; the output has q's strides.
"""
from __future__ import annotations

import torch

from . import _build

NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
MAX_D = 128


def _check(q, k, v, block_q: int, block_k: int, dtypes=_DTYPES,
           devices=("cuda", "cpu")) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D (B, H, S, D)")
    B, Hq, S, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, D):
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    Hkv = k.shape[1]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if not 1 <= D <= MAX_D:
        raise ValueError(f"head dim {D} outside [1, {MAX_D}]")
    bq, bk = min(block_q, S), min(block_k, S)
    if bq < 1 or bk < 1 or S % bq or S % bk:
        raise ValueError(f"S={S} must be a multiple of block_q={bq} and "
                         f"block_k={bk}")
    if q.dtype not in dtypes or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: need "
                        f"one of {dtypes} for all three")
    dev = q.device
    if dev.type not in devices:
        raise RuntimeError(f"unsupported device {dev}")
    if k.device != dev or v.device != dev:
        raise RuntimeError(f"q on {dev}, k on {k.device}, v on {v.device}")


def work_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the plain versions compute in: float64 for float64,
    else fp32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          block_q: int = 256, block_k: int = 256,
                          return_lse: bool = False):
    """Plain PyTorch version of the kernel: the same online softmax, in
    fp32, over key blocks of ``min(block_k, S)``.  Rows that cannot see a
    key block under the causal mask skip it (what skipping the blocks
    above the diagonal does, exactly: such a block changes nothing).
    With ``return_lse`` also each row's log-normaliser ``L = m +
    log(max(l, 1e-30))``, ``(B, Hq, S)`` in fp32.  It also takes float64
    (the kernel does not), computing (and returning ``L``) in float64
    then, for gradient checks, and meta tensors (shapes only: the
    dry-run, ``launch.dryrun``)."""
    _check(q, k, v, block_q, block_k, _DTYPES + (torch.float64,),
           ("cuda", "cpu", "meta"))
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    bk = min(block_k, S)
    scale = 1.0 / (D ** 0.5)
    dev = q.device
    work = work_dtype(q.dtype)
    qf = q.to(work).reshape(B, Hkv, g, S, D)
    m = torch.full((B, Hkv, g, S), NEG_INF, dtype=work, device=dev)
    l = torch.zeros((B, Hkv, g, S), dtype=work, device=dev)
    acc = torch.zeros((B, Hkv, g, S, D), dtype=work, device=dev)
    pos = torch.arange(S, device=dev)
    for k0 in range(0, S, bk):
        lo = k0 if causal else 0
        kb = k[:, :, k0:k0 + bk].to(work)
        vb = v[:, :, k0:k0 + bk].to(work)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf[:, :, :, lo:], kb) * scale
        if causal:
            see = pos[lo:, None] >= pos[None, k0:k0 + bk]
            s = torch.where(see, s, NEG_INF)
        m_prev = m[..., lo:]
        m_new = torch.maximum(m_prev, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_prev - m_new)
        l[..., lo:] = corr * l[..., lo:] + p.sum(-1)
        acc[..., lo:, :] = (acc[..., lo:, :] * corr[..., None]
                            + torch.einsum("bhgqk,bhkd->bhgqd", p, vb))
        m[..., lo:] = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe[..., None]).reshape(B, Hq, S, D).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l_safe)).reshape(B, Hq, S)
    return out


#: the kernels of ``csrc/flash_attn.cu``, in the numbering of its
#: ``kKernels``: the fp32 FMA kernel, then the tensor-core kernel by dtype,
#: loads (16-byte or element-wise) and D padded to 128 or 64
KERNELS = ("flash_fwd_kernel<float>",) + tuple(
    f"flash_fwd_mma_kernel<{t},{ld},{dp}>" for t in ("bf16", "fp16")
    for ld in ("16B", "elementwise") for dp in (128, 64))


def vector_loads(*tensors) -> bool:
    """Whether the tensor-core kernel can move the rows of ``tensors`` (q,
    k, v and o) in 16-byte chunks: a 16-bit dtype, ``D % 8 == 0``, and
    every base address and (b, h, s) stride a multiple of 16 bytes.
    Otherwise it takes its element-wise loading variant."""
    if tensors[0].element_size() != 2 or tensors[0].shape[-1] % 8:
        return False
    return all(t.data_ptr() % 16 == 0
               and all(st % 8 == 0 for st in t.stride()[:3])
               for t in tensors)


def kernel_index(q, k, v, o) -> int:
    """The index into :data:`KERNELS` of the kernel a launch on these
    tensors runs: fp32 the FMA kernel; bf16 and fp16 the tensor-core
    kernel, with 16-byte loads where :func:`vector_loads` holds, and D
    padded to 64 where ``D <= 64``, else to 128."""
    if q.dtype == torch.float32:
        return 0
    return (1 + 4 * (q.dtype == torch.float16)
            + 2 * (not vector_loads(q, k, v, o)) + (q.shape[-1] <= 64))


def _launch(q, k, v, causal: bool, lse=None):
    lib = _build.load("flash_attn")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s feature axis must be contiguous")
    B, Hq, S, D = q.shape
    o = torch.empty_like(q)      # q's strides when q is dense, else packed
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    dev = q.device
    with torch.cuda.device(dev):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Hq,
            k.shape[1], S, D, int(causal), 1.0 / (D ** 0.5),
            kernel_index(q, k, v, o), *strides,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: code {err}")
    return o


def kernel_attrs() -> dict:
    """``{kernel: {regs, static_smem, dynamic_smem, local_bytes,
    ctas_per_sm}}`` for each of :data:`KERNELS`, read by
    ``cudaFuncGetAttributes`` and the occupancy calculator on the current
    card (the fp32 kernel's dynamic shared memory at D = 128)."""
    import ctypes
    lib = _build.load("flash_attn")
    out, keys = {}, ("regs", "static_smem", "dynamic_smem", "local_bytes",
                     "ctas_per_sm")
    for i, name in enumerate(KERNELS):
        vals = (ctypes.c_int * len(keys))()
        err = lib.flash_attention_kernel_attrs(i, vals)
        if err != 0:
            raise RuntimeError(f"attributes of {name}: code {err}")
        out[name] = dict(zip(keys, vals))
    return out


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 256,
                    block_k: int = 256, return_lse: bool = False):
    """Attention of ``q (B, Hq, S, D)`` over ``k, v (B, Hkv, S, D)`` (the
    JAX package's ``flash_attention`` without ``interpret``).  The kernel
    on CUDA tensors, :func:`flash_attention_plain` on CPU tensors.
    Returns ``(B, Hq, S, D)`` in q's dtype; with ``return_lse`` also the
    kernel's log-normaliser ``L`` (fp32 ``(B, Hq, S)``), which the
    training forward saves for its backward
    (``repro_torch.models.flash_xla``)."""
    _check(q, k, v, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     block_q=block_q, block_k=block_k,
                                     return_lse=return_lse)
    B, Hq, S, _ = q.shape
    lse = (torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    out = _launch(q, k, v, causal, lse)
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def reset_launches() -> None:
    flash_attention.launches = 0
