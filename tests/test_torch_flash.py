"""The port's flash attention and its plain twins against the JAX
package's, on the same inputs.

On CPU tensors ``repro_torch.kernels.flash_attn.flash_attention`` runs its
plain version, so it is held against the reference's Pallas kernel in
interpret mode (as ``tests/test_kernels.py`` runs it) and against the
materialized oracle ``ref.flash_attention_ref``.  Bounds, stated per case:
in fp32 ``2e-5`` abs and rel, the reference's own bound for its kernel
against the oracle (both sides sum the same fp32 products in another
order); in bf16 both sides widen the same bf16 inputs, compute in fp32
and round once, so they differ by that fp32 bound plus one bf16 ulp of
the result (``repro_torch.testing.low_precision_tolerance``); against
the oracle, which rounds its probabilities to bf16 before the second
product, ``2^-8`` abs and rel.  On the card the kernel is held to its
plain version: ``2e-5`` of ``1 + |plain|`` in fp32; in bf16 and fp16,
where the tensor-core kernel rounds its probabilities once to the input
type before ``P V``, that plus two ulps of the result plus the type's
epsilon times the plain version on ``|v|``
(``repro_torch.testing.flash_p_rounding_tolerance``).  Here on the CPU,
an emulation of that kernel's numerics is held to the same bound, and
two wrong results must fall outside it.

The kernel itself runs only on a card: that test takes the
``requires_cuda`` fixture and skips here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.kernels.flash_attn import flash_attention as rflash
from repro.models import attention as rattn
from repro.models.flash_xla import flash_attention_xla as rflash_xla

from repro_torch.kernels import flash_attn as tk
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models.flash_xla import flash_attention_xla
from repro_torch.testing import (flash_p_rounding_tolerance,
                                 low_precision_tolerance)

BF16_ULP = 2.0 ** -8

# the four shapes of tests/test_kernels.py::test_flash_attention_matches_dense
SHAPES = [
    (1, 2, 1, 256, 64, 128, 128, True),
    (2, 4, 2, 256, 128, 64, 128, True),
    (1, 4, 4, 128, 128, 128, 128, False),   # MHA, non-causal
    (2, 8, 2, 512, 64, 256, 256, True),     # GQA group 4
]


@pytest.fixture
def requires_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _qkv(seed, B, Hq, Hkv, S, D):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, Hq, S, D)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(B, Hkv, S, D)) * 0.3).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    return q, k, v


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _j(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,Hq,Hkv,S,D,bq,bk,causal", SHAPES)
def test_flash_matches_reference_kernel_and_oracle(B, Hq, Hkv, S, D, bq, bk,
                                                   causal):
    q, k, v = _qkv(B * S + Hq, B, Hq, Hkv, S, D)
    tk.reset_launches()
    got = tk.flash_attention(*_t(q, k, v), causal=causal, block_q=bq,
                             block_k=bk)
    assert tk.flash_attention.launches == 0      # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (B, Hq, S, D)
    want = rflash(*_j(q, k, v), causal=causal, block_q=bq, block_k=bk,
                  interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)
    oracle = rref.flash_attention_ref(*_j(q, k, v), causal=causal)
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=2e-5, atol=2e-5)
    port_oracle = tref.flash_attention_ref(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(_np(port_oracle), _np(oracle), rtol=2e-5,
                               atol=2e-5)


def test_flash_bf16_matches_reference():
    # tests/test_kernels.py::test_flash_attention_bf16's case
    rng = np.random.default_rng(11)
    q = (rng.normal(size=(1, 2, 256, 64)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(1, 2, 256, 64)) * 0.3).astype(np.float32)
    v = rng.normal(size=(1, 2, 256, 64)).astype(np.float32)
    got = tk.flash_attention(*_t(q, k, v, dtype=torch.bfloat16), causal=True,
                             block_q=128, block_k=128)
    assert got.dtype == torch.bfloat16
    want = rflash(*_j(q, k, v, dtype=jnp.bfloat16), causal=True,
                  block_q=128, block_k=128, interpret=True)
    w = torch.from_numpy(_np(want)).double()
    assert torch.all((got.double() - w).abs()
                     <= low_precision_tolerance(w, torch.bfloat16, 1))
    g = _np(got)
    oracle = _np(rref.flash_attention_ref(
        *_j(q, k, v, dtype=jnp.bfloat16), causal=True))
    np.testing.assert_allclose(g, oracle, rtol=BF16_ULP, atol=BF16_ULP)
    port_oracle = _np(tref.flash_attention_ref(
        *_t(q, k, v, dtype=torch.bfloat16), causal=True))
    np.testing.assert_allclose(port_oracle, oracle, rtol=BF16_ULP,
                               atol=BF16_ULP)


def test_flash_takes_strided_views():
    """The projections' (B, S, H, D) layout, transposed to (B, H, S, D)
    without a copy, gives what the contiguous tensors give."""
    q, k, v = _qkv(3, 2, 4, 2, 64, 32)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in _t(q, k, v)]
    assert not views[0].is_contiguous()
    a = tk.flash_attention(*views, block_q=32, block_k=32)
    b = tk.flash_attention(*_t(q, k, v), block_q=32, block_k=32)
    assert torch.equal(a, b)


@pytest.mark.parametrize("shape,kw,err", [
    (((1, 3, 64, 16), (1, 2, 64, 16)), {}, ValueError),         # Hq % Hkv
    (((1, 2, 64, 160), (1, 2, 64, 160)), {}, ValueError),       # D > 128
    (((1, 2, 96, 16), (1, 2, 96, 16)), dict(block_q=64), ValueError),
    (((1, 2, 64, 16), (1, 2, 32, 16)), {}, ValueError),         # k's S
])
def test_flash_rejects_what_the_kernel_does_not_take(shape, kw, err):
    q = torch.zeros(shape[0])
    k = torch.zeros(shape[1])
    with pytest.raises(err):
        tk.flash_attention(q, k, k, **kw)


def test_flash_rejects_mixed_dtypes():
    q = torch.zeros((1, 2, 16, 16))
    with pytest.raises(TypeError):
        tk.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(TypeError):
        tk.flash_attention(q.double(), q.double(), q.double())


@pytest.mark.parametrize("chunk", [32, 128])
def test_chunked_and_xla_flash_match_reference(chunk):
    rng = np.random.default_rng(5)
    q = (rng.normal(size=(2, 4, 128, 32)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(2, 2, 128, 32)) * 0.5).astype(np.float32)
    v = rng.normal(size=(2, 2, 128, 32)).astype(np.float32)
    want = _np(rattn.chunked_attention(*_j(q, k, v), causal=True,
                                       chunk=chunk))
    got = _np(tattn.chunked_attention(*_t(q, k, v), causal=True,
                                      chunk=chunk))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    want = _np(rflash_xla(*_j(q, k, v), True, chunk))
    got = _np(flash_attention_xla(*_t(q, k, v), True, chunk))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("cur_len", [1, 7, 16])
def test_decode_attention_matches_reference(cur_len):
    rng = np.random.default_rng(cur_len)
    q = rng.normal(size=(3, 8, 32)).astype(np.float32)
    kc = rng.normal(size=(3, 16, 2, 32)).astype(np.float32)
    vc = rng.normal(size=(3, 16, 2, 32)).astype(np.float32)
    want = _np(rattn.decode_attention(*_j(q, kc, vc), jnp.int32(cur_len)))
    got = _np(tattn.decode_attention(*_t(q, kc, vc), cur_len))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------- #
# the tensor-core kernel's numerics, emulated                           #
# --------------------------------------------------------------------- #

def _emulate_mma_kernel(q, k, v, *, causal=True, block_k=64):
    """The bf16/fp16 kernel's arithmetic in plain PyTorch: the online
    softmax in fp32 over 64-key tiles, ``l`` summed from the fp32
    probabilities, the probabilities rounded once to the input type
    before ``P V`` (fp32 sums), the output rounded once."""
    B, Hq, S, D = q.shape
    g = Hq // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    m = torch.full((B, Hq, S), tk.NEG_INF)
    l = torch.zeros((B, Hq, S))
    acc = torch.zeros((B, Hq, S, D))
    pos = torch.arange(S)
    for k0 in range(0, S, block_k):
        s = qf @ kf[:, :, k0:k0 + block_k].transpose(-1, -2) / D ** 0.5
        if causal:
            s = torch.where(pos[:, None] >= pos[None, k0:k0 + block_k], s,
                            tk.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(-1)
        acc = (acc * corr[..., None]
               + p.to(q.dtype).float() @ vf[:, :, k0:k0 + block_k])
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def _cancelling_qkv(seed, Hq, Hkv, S, D, dtype):
    """Small scores (nearly uniform weights) over v centred on 0 across
    the keys, so the outputs cancel towards 0; rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, Hq, S, D)) * 0.1
    k = rng.normal(size=(1, Hkv, S, D)) * 0.1
    v = rng.normal(size=(1, Hkv, S, D))
    v -= v.mean(axis=2, keepdims=True)
    return _t(*(a.astype(np.float32) for a in (q, k, v)), dtype=dtype)


def _p_bound(q, k, v, want):
    abs_v = tk.flash_attention_plain(q.float(), k.float(), v.abs().float())
    return flash_p_rounding_tolerance(want.double(), abs_v, q.dtype)


@pytest.mark.parametrize("group", [1, 5])
@pytest.mark.parametrize("D", [8, 36, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_p_rounding_emulation_within_bound(dtype, D, group):
    """The emulated kernel, on cancelling outputs at a ragged S=200 (not a
    multiple of the 64-key tile), is within the P-rounding bound of the
    plain version, and rounding P does move it off the plain version."""
    Hkv, S = 2, 200
    q, k, v = _cancelling_qkv(D * group, Hkv * group, Hkv, S, D, dtype)
    got = _emulate_mma_kernel(q, k, v)
    want = tk.flash_attention_plain(q, k, v)
    assert got.dtype == want.dtype == dtype
    err = (got.double() - want.double()).abs()
    assert torch.all(err <= _p_bound(q, k, v, want))
    # the bound is needed: the fp32 bound plus two ulps alone fails here
    assert not torch.all(err <= low_precision_tolerance(want.double(), dtype))


@pytest.mark.parametrize("control", ["no causal mask", "KV head h % Hkv"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_p_rounding_bound_rejects_controls(dtype, control):
    Hkv, g, S, D = 2, 5, 200, 64
    q, k, v = _cancelling_qkv(7, Hkv * g, Hkv, S, D, dtype)
    got = _emulate_mma_kernel(q, k, v)
    if control == "no causal mask":
        bad = tk.flash_attention_plain(q, k, v, causal=False)
    else:
        heads = torch.arange(Hkv * g) % Hkv
        bad = tk.flash_attention_plain(q, k[:, heads], v[:, heads])
    assert not torch.all((got.double() - bad.double()).abs()
                         <= _p_bound(q, k, v, bad))


def _proj_views(B, S, H, D, dtype, offset=0):
    """A ``(B, H, S, D)`` view of a ``(B, S, H, D)`` projection, starting
    ``offset`` elements into its storage."""
    base = torch.zeros(B * S * H * D + offset, dtype=dtype)
    return base[offset:].view(B, S, H, D).transpose(1, 2)


@pytest.mark.parametrize("D,dtype,offset,want", [
    (128, torch.bfloat16, 0, True),      # the served layout
    (64, torch.float16, 0, True),
    (36, torch.bfloat16, 0, False),      # rows of 72 bytes
    (8, torch.bfloat16, 0, True),
    (128, torch.bfloat16, 1, False),     # a base 2 bytes off
    (128, torch.float32, 0, False),      # the fp32 kernel loads elements
])
def test_vector_loads_only_on_aligned_rows(D, dtype, offset, want):
    q = _proj_views(2, 64, 4, D, dtype, offset)
    kv = _proj_views(2, 64, 2, D, dtype)
    assert tk.vector_loads(q, kv, kv, torch.empty_like(q)) is want


@pytest.mark.parametrize("D,dtype,offset,want", [
    (128, torch.bfloat16, 0, "flash_fwd_mma_kernel<bf16,16B,128>"),
    (64, torch.float16, 0, "flash_fwd_mma_kernel<fp16,16B,64>"),
    (36, torch.bfloat16, 0, "flash_fwd_mma_kernel<bf16,elementwise,64>"),
    (72, torch.float16, 0, "flash_fwd_mma_kernel<fp16,16B,128>"),
    (72, torch.float16, 1, "flash_fwd_mma_kernel<fp16,elementwise,128>"),
    (128, torch.float32, 0, "flash_fwd_kernel<float>"),
])
def test_kernel_index_names_the_launched_kernel(D, dtype, offset, want):
    q = _proj_views(1, 64, 4, D, dtype, offset)
    assert tk.KERNELS[tk.kernel_index(q, q, q, q)] == want
    assert len(set(tk.KERNELS)) == len(tk.KERNELS) == 9


# --------------------------------------------------------------------- #
# on the card                                                           #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kernel_matches_plain_on_card(requires_cuda, dtype):
    cases = [((1, 2, 1, 256, 64, True), _qkv),
             ((2, 8, 2, 192, 128, True), _qkv),
             ((1, 4, 4, 128, 128, False), _qkv),
             ((2, 4, 2, 12, 16, True), _qkv),
             ((1, 40, 8, 320, 128, True), _qkv)]
    # the emulation's shapes: cancelling outputs at a ragged S=200
    cases += [((1, 2 * g, 2, 200, D, True), None)
              for D in (8, 36, 64, 128) for g in (1, 5)]
    for seed, ((B, Hq, Hkv, S, D, causal), make) in enumerate(cases):
        if make is None:
            q, k, v = _cancelling_qkv(seed, Hq, Hkv, S, D, dtype)
        else:
            q, k, v = _t(*make(seed, B, Hq, Hkv, S, D), dtype=dtype)
        q, k, v = (t.to(requires_cuda) for t in (q, k, v))
        blk = min(64, S) if S % 64 == 0 or S < 64 else S
        tk.reset_launches()
        got = tk.flash_attention(q, k, v, causal=causal, block_q=blk,
                                 block_k=blk)
        torch.cuda.synchronize()
        assert tk.flash_attention.launches == 1
        want = tk.flash_attention_plain(q, k, v, causal=causal,
                                        block_q=blk, block_k=blk)
        g, w = got.double(), want.double()
        if dtype == torch.float32:
            tol = 2e-5 * (1 + w.abs())
        else:
            abs_v = tk.flash_attention_plain(
                q.float(), k.float(), v.abs().float(), causal=causal,
                block_q=blk, block_k=blk)
            tol = flash_p_rounding_tolerance(w, abs_v, dtype)
        assert torch.all((g - w).abs() <= tol), (B, Hq, Hkv, S, D, causal)
