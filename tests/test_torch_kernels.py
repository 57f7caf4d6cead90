"""The port's block-SGD wrappers against the JAX package's Pallas kernels.

On CPU tensors every wrapper runs its plain CSR version, so these tests
hold the port's compaction and arithmetic against the reference kernels
run in interpret mode, exactly as ``tests/test_kernels.py`` runs them.
The bound is the tolerance tier's ``16 * eps * sqrt(n_updates)``, with
``n_updates`` the mean updates per factor row of the more-updated side:
XLA and torch reduce the k-dot in different orders, and otherwise both
sides perform the same operations in the same serial order.  In bf16
both sides compute in fp32 over the same storage, so they are also held
to ``repro_torch.testing.assert_rare_flips``.  Inside the port,
the bitwise contracts hold bitwise.

The kernel itself runs only on a card: those tests take the
``requires_cuda`` fixture and skip here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tolerance as tol

from repro.core.partition import pack_cell_waves
from repro.kernels import nomad_sgd as rk
from repro.kernels import ops as rops
from repro.kernels import policy as rpolicy

from repro_torch.kernels import nomad_sgd as tk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import policy as tpolicy
from repro_torch.kernels import ref as tref
from repro_torch.testing import assert_rare_flips

LR, LAM = 0.05, 0.05


@pytest.fixture
def requires_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _cell(seed, m_t, n_t, k, nnz, masked=0.2):
    rng = np.random.default_rng(seed)
    W = rng.normal(scale=0.3, size=(m_t, k)).astype(np.float32)
    H = rng.normal(scale=0.3, size=(n_t, k)).astype(np.float32)
    rows = rng.integers(0, m_t, nnz).astype(np.int32)
    cols = rng.integers(0, n_t, nnz).astype(np.int32)
    vals = rng.normal(size=nnz).astype(np.float32)
    mask = rng.random(nnz) >= masked
    return W, H, rows, cols, vals, mask


def _waves(rows, cols, vals, mask, n_waves=None, wave_width=None):
    _, wr, wc, wv, wm, _ = pack_cell_waves(
        rows[mask], cols[mask], vals[mask], n_waves=n_waves,
        wave_width=wave_width)
    return wr, wc, wv, wm


def _n_updates(mask, m_t, n_t):
    return max(mask.sum() / m_t, mask.sum() / n_t)


_SD = {"fp32": (np.float32, jnp.float32, torch.float32),
       "bf16": (None, jnp.bfloat16, torch.bfloat16)}


def _pair(W, H, policy):
    """The same factors as reference (jnp) and port (torch) inputs."""
    _, jd, td = _SD[policy]
    return ((jnp.asarray(W, jd), jnp.asarray(H, jd)),
            (torch.from_numpy(W).to(td), torch.from_numpy(H).to(td)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x).astype(np.float32)


def _check_close(got, want, start, policy, n_updates):
    """``got`` (torch) within the tolerance tier of ``want`` (jnp or
    torch) and, in bf16, differing from it on few of the elements the
    update changed from ``start``."""
    tol.assert_factors_close(_np(got), _np(want), dtype_policy=policy,
                             n_updates=n_updates)
    if policy == "bf16":
        assert_rare_flips(got.cpu(), torch.from_numpy(_np(want)).to(
            got.dtype), start.cpu(), what="bf16 storage")


@pytest.mark.parametrize("k", [8, 100])
@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_block_matches_reference_kernel(k, policy):
    W, H, rows, cols, vals, mask = _cell(k, 24, 12, k, 160)
    (jW, jH), (tW, tH) = _pair(W, H, policy)
    acc = policy != "fp32"
    want = rk.nomad_sgd_block(jW, jH, rows, cols, vals, mask, LR, LAM,
                              chunk=64, interpret=True, accum_fp32=acc)
    got = tk.nomad_sgd_block(tW, tH, *map(torch.from_numpy,
                                          (rows, cols, vals, mask)),
                             LR, LAM, chunk=64, accum_fp32=acc)
    for g, w, s0 in zip(got, want, (tW, tH)):
        assert g.dtype == tW.dtype
        _check_close(g, w, s0, policy, _n_updates(mask, 24, 12))


@pytest.mark.parametrize("k", [8, 100])
@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_waves_block_matches_reference_kernel(k, policy):
    W, H, rows, cols, vals, mask = _cell(k + 1, 24, 12, k, 160)
    wr, wc, wv, wm = _waves(rows, cols, vals, mask)
    (jW, jH), (tW, tH) = _pair(W, H, policy)
    acc = policy != "fp32"
    want = rk.nomad_sgd_waves_block(jW, jH, wr, wc, wv, wm, LR, LAM,
                                    wave_chunk=4, interpret=True,
                                    accum_fp32=acc)
    got = tk.nomad_sgd_waves_block(tW, tH, *map(torch.from_numpy,
                                                (wr, wc, wv, wm)),
                                   LR, LAM, wave_chunk=4, accum_fp32=acc)
    for g, w, s0 in zip(got, want, (tW, tH)):
        _check_close(g, w, s0, policy, _n_updates(mask, 24, 12))


def _grid_case(seed, p, k):
    cells = [_cell(seed * 10 + c, 20, 10, k, 90) for c in range(p)]
    packed = [pack_cell_waves(c[2][c[5]], c[3][c[5]], c[4][c[5]])
              for c in cells]
    nw = max(x[1].shape[0] for x in packed)
    ww = max(x[1].shape[1] for x in packed)
    waves = [_waves(*c[2:], n_waves=nw, wave_width=ww) for c in cells]
    Ws = np.stack([c[0] for c in cells])
    Hs = np.stack([c[1] for c in cells])
    return Ws, Hs, [np.stack(a) for a in zip(*waves)], cells


@pytest.mark.parametrize("k", [8, 100])
@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_waves_grid_matches_reference_kernel(k, policy):
    Ws, Hs, (wr, wc, wv, wm), cells = _grid_case(k, 3, k)
    (jW, jH), (tW, tH) = _pair(Ws, Hs, policy)
    acc = policy != "fp32"
    want = rk.nomad_sgd_waves_grid(jW, jH, wr, wc, wv, wm, LR, LAM,
                                   wave_chunk=4, interpret=True,
                                   accum_fp32=acc)
    got = tk.nomad_sgd_waves_grid(tW, tH, *map(torch.from_numpy,
                                               (wr, wc, wv, wm)),
                                  LR, LAM, wave_chunk=4, accum_fp32=acc)
    n_upd = max(_n_updates(c[5], 20, 10) for c in cells)
    for g, w, s0 in zip(got, want, (tW, tH)):
        assert tuple(g.shape) == tuple(w.shape)
        _check_close(g, w, s0, policy, n_upd)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_grid_equals_per_cell_equals_sequential_bitwise(seed, policy):
    Ws, Hs, (wr, wc, wv, wm), _ = _grid_case(seed, 4, 16)
    _, (tW, tH) = _pair(Ws, Hs, policy)
    acc = policy != "fp32"
    pad = [torch.from_numpy(a) for a in (wr, wc, wv, wm)]
    gW, gH = tk.nomad_sgd_waves_grid(tW, tH, *pad, LR, LAM, accum_fp32=acc)
    for c in range(4):
        bW, bH = tk.nomad_sgd_waves_block(tW[c], tH[c], *(a[c] for a in pad),
                                          LR, LAM, accum_fp32=acc)
        tol.assert_bitwise(gW[c].float().numpy(), bW.float().numpy(), "W")
        tol.assert_bitwise(gH[c].float().numpy(), bH.float().numpy(), "H")
        m = pad[3][c]
        sW, sH = tk.nomad_sgd_block(tW[c], tH[c], pad[0][c][m], pad[1][c][m],
                                    pad[2][c][m], m[m], LR, LAM,
                                    accum_fp32=acc)
        tol.assert_bitwise(sW.float().numpy(), bW.float().numpy(), "seq W")
        tol.assert_bitwise(sH.float().numpy(), bH.float().numpy(), "seq H")


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("cd", [None, torch.float32])
def test_csr_plain_equals_padded_plain_bitwise(seed, cd):
    Ws, Hs, (wr, wc, wv, wm), _ = _grid_case(seed + 5, 3, 12)
    sd = torch.float32 if cd is None else torch.bfloat16
    tW, tH = torch.from_numpy(Ws).to(sd), torch.from_numpy(Hs).to(sd)
    pad = [torch.from_numpy(a) for a in (wr, wc, wv, wm)]
    csr = tk.WaveCSR.from_padded(*pad)
    cW, cH = tk.block_sgd_waves_csr(tW.clone(), tH.clone(), csr, LR, LAM,
                                    compute_dtype=cd)
    for c in range(3):
        rW, rH = tref.block_sgd_waves(tW[c], tH[c], *(a[c] for a in pad),
                                      LR, LAM, compute_dtype=cd)
        assert torch.equal(cW[c], rW) and torch.equal(cH[c], rH)


def test_rare_flips_bound():
    from repro_torch.testing import FLIP_SLACK, assert_rare_flips, flips
    start = torch.zeros(4096, dtype=torch.bfloat16)
    want = torch.linspace(0.01, 1.0, 4096).bfloat16()
    got = want.clone()
    # one storage ulp away on a few elements, stepped through the bits
    got[:5] = (want[:5].view(torch.int16) + 1).view(torch.bfloat16)
    assert flips(got, want, start) == (5, 4096)
    assert assert_rare_flips(got, want, start) == (5, 4096)   # bound 2 + 4
    assert assert_rare_flips(got[:2], want[:2], start[:2]) == (2, 2)
    assert FLIP_SLACK == 2
    with pytest.raises(AssertionError, match="elements differ"):
        assert_rare_flips(got[:10], want[:10], start[:10])
    with pytest.raises(AssertionError, match="elements differ"):
        assert_rare_flips(start, want, start)          # no update at all
    with pytest.raises(AssertionError, match="non-finite"):
        assert_rare_flips(got / 0, want, start)


def test_csr_compaction_layout():
    rows = torch.tensor([[[1, 2, 0], [3, 0, 0], [0, 0, 0]],
                         [[0, 0, 0], [4, 5, 6], [0, 0, 0]]], dtype=torch.int32)
    mask = torch.tensor([[[1, 1, 0], [1, 0, 0], [0, 0, 0]],
                         [[0, 0, 0], [1, 1, 1], [0, 0, 0]]], dtype=torch.bool)
    csr = tk.WaveCSR.from_padded(rows, rows + 10, rows.float(), mask)
    assert csr.rows.tolist() == [1, 2, 3, 4, 5, 6]
    assert csr.cols.tolist() == [11, 12, 13, 14, 15, 16]
    assert csr.woff.tolist() == [0, 2, 3, 6]
    assert csr.cell_woff.tolist() == [0, 2, 3]
    assert csr.cells(1, 2).cell_woff.tolist() == [2, 3]


@pytest.mark.parametrize("wrapper", ["block", "waves_block", "waves_grid"])
def test_masked_entries_are_noops(wrapper):
    W, H, rows, cols, vals, _ = _cell(9, 16, 8, 8, 50)
    off = torch.zeros(50, dtype=torch.bool)
    tW, tH = torch.from_numpy(W), torch.from_numpy(H)
    r, c, v = map(torch.from_numpy, (rows, cols, vals))
    if wrapper == "block":
        out = tk.nomad_sgd_block(tW, tH, r, c, v, off, 1.0, 1.0)
    elif wrapper == "waves_block":
        out = tk.nomad_sgd_waves_block(tW, tH, r[:, None], c[:, None],
                                       v[:, None], off[:, None], 1.0, 1.0)
    else:
        out = tk.nomad_sgd_waves_grid(tW[None], tH[None], r[None, :, None],
                                      c[None, :, None], v[None, :, None],
                                      off[None, :, None], 1.0, 1.0)
        out = tuple(o[0] for o in out)
    assert torch.equal(out[0], tW) and torch.equal(out[1], tH)


def test_partial_mask_equals_dropping_masked_entries():
    W, H, rows, cols, vals, mask = _cell(11, 16, 8, 8, 80, masked=0.5)
    tW, tH = torch.from_numpy(W), torch.from_numpy(H)
    a = tk.nomad_sgd_block(tW, tH, *map(torch.from_numpy,
                                        (rows, cols, vals, mask)), LR, LAM)
    keep = torch.from_numpy(mask)
    b = tk.nomad_sgd_block(tW, tH, *(torch.from_numpy(x)[keep]
                                     for x in (rows, cols, vals)),
                           torch.ones(int(keep.sum()), dtype=torch.bool),
                           LR, LAM)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(tW, torch.from_numpy(W)), "inputs must not change"


def _one_cell_csr(n=4):
    z = torch.zeros(n, dtype=torch.int32)
    return tk.WaveCSR(rows=z, cols=z, vals=torch.zeros(n),
                      woff=torch.arange(n + 1, dtype=torch.int32),
                      cell_woff=torch.tensor([0, n], dtype=torch.int32))


@pytest.mark.parametrize("case", ["bf16_no_accum", "fp16_no_accum",
                                  "float64", "mixed_dtypes", "int64_rows",
                                  "noncontig", "cells_mismatch",
                                  "rank_mismatch"])
def test_wrapper_rejects_unsupported_inputs(case):
    Ws, Hs = torch.zeros(1, 3, 4), torch.zeros(1, 2, 4)
    csr, acc = _one_cell_csr(), False
    if case == "bf16_no_accum":
        Ws, Hs = Ws.bfloat16(), Hs.bfloat16()
    elif case == "fp16_no_accum":
        Ws, Hs = Ws.half(), Hs.half()
    elif case == "float64":
        Ws, Hs, acc = Ws.double(), Hs.double(), True
    elif case == "mixed_dtypes":
        Hs, acc = Hs.bfloat16(), True
    elif case == "int64_rows":
        csr = tk.WaveCSR(csr.rows.long(), *csr.arrays()[1:])
    elif case == "noncontig":
        Ws = torch.zeros(1, 4, 3).transpose(1, 2)
    elif case == "cells_mismatch":
        Ws, Hs = torch.zeros(2, 3, 4), torch.zeros(2, 2, 4)
    elif case == "rank_mismatch":
        Hs = torch.zeros(1, 2, 5)
    with pytest.raises((ValueError, TypeError)):
        tk.nomad_sgd_waves_csr(Ws, Hs, csr, LR, LAM, accum_fp32=acc)


def test_wrapper_rejects_out_of_range_indices():
    W, H = torch.zeros(3, 4), torch.zeros(2, 4)
    r = torch.tensor([0, 3], dtype=torch.int32)
    ok = torch.ones(2, dtype=torch.bool)
    with pytest.raises(ValueError):
        tk.nomad_sgd_block(W, H, r, r * 0, torch.zeros(2), ok, LR, LAM)


def test_cpu_tensors_never_count_launches():
    tk.reset_launches()
    W, H, rows, cols, vals, mask = _cell(3, 8, 8, 8, 20)
    tk.nomad_sgd_block(torch.from_numpy(W), torch.from_numpy(H),
                       *map(torch.from_numpy, (rows, cols, vals, mask)),
                       LR, LAM)
    assert all(w.launches == 0 for w in tk.WRAPPERS)


# --------------------------------------------------------------------- #
# policy and dispatch                                                   #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("kw", [
    dict(impl="nope"), dict(chunk=0), dict(wave_chunk=0), dict(sub_blocks=0),
    dict(dtype_policy="fp8"), dict(block_rows=-2)])
def test_policy_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        rpolicy.KernelPolicy(**kw)
    with pytest.raises(ValueError):
        tpolicy.KernelPolicy(**kw)


@pytest.mark.parametrize("impl,want", [("wave", "xla"),
                                       ("wave_pallas", "pallas")])
def test_policy_sub_block_downgrade_matches_reference(impl, want):
    with pytest.warns(UserWarning):
        a = tpolicy.KernelPolicy(impl=impl, sub_blocks=2)
    with pytest.warns(UserWarning):
        b = rpolicy.KernelPolicy(impl=impl, sub_blocks=2)
    assert a.impl == b.impl == want


def test_policy_fields_and_dtypes():
    ref_fields = [f.name for f in
                  rpolicy.KernelPolicy.__dataclass_fields__.values()]
    assert [f.name for f in tpolicy.KernelPolicy.__dataclass_fields__
            .values()] == ref_fields
    assert tpolicy.KernelPolicy() == tpolicy.KernelPolicy()
    bf = tpolicy.KernelPolicy(dtype_policy="bf16")
    assert bf.storage_dtype == torch.bfloat16 and bf.mixed
    assert bf.compute_dtype == torch.float32
    assert tpolicy.KernelPolicy().compute_dtype is None
    p = tpolicy.KernelPolicy(impl="wave_pallas")
    assert p.wants_grid(10, 10, "cuda") and not p.wants_grid(10, 10, "cpu")
    assert not tpolicy.KernelPolicy(block_rows=-1).wants_grid(1, 1, "cuda")
    assert tpolicy.KernelPolicy(block_rows=8).wants_grid(8, 4, "cpu")
    assert not tpolicy.KernelPolicy(block_rows=8).wants_grid(9, 4, "cuda")


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_autotune(backend):
    pol = tpolicy.KernelPolicy(impl="wave_pallas")
    t = pol.autotune(m_local=300, n_local=40, k=100, backend=backend)
    if backend == "cpu":
        r = rpolicy.KernelPolicy(impl="wave_pallas").autotune(
            m_local=300, n_local=40, k=100, backend=backend)
        assert (t.wave_chunk, t.block_rows) == (r.wave_chunk, r.block_rows)
    else:
        assert tpolicy._MEM_BUDGET["cuda"] == 232_448
        assert t.block_rows == 300 and 4 <= t.wave_chunk <= 64


def test_auto_resolves_by_device():
    assert tops._resolve(None, "auto", 1, 1, torch.device("cpu"))[1] == "xla"
    assert tops._resolve(None, "auto", 1, 1,
                         torch.device("cuda"))[1] == "pallas"


@pytest.mark.parametrize("impl", ["xla", "pallas", "wave", "wave_pallas",
                                  "auto"])
@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_block_sgd_dispatch_matches_reference(impl, policy):
    W, H, rows, cols, vals, mask = _cell(21, 16, 8, 8, 60)
    if impl in ("wave", "wave_pallas"):
        rows, cols, vals, mask = _waves(rows, cols, vals, mask)
    (jW, jH), (tW, tH) = _pair(W, H, policy)
    want = rops.block_sgd(jW, jH, rows, cols, vals, mask, LR, LAM,
                          policy=rpolicy.KernelPolicy(impl=impl,
                                                      dtype_policy=policy))
    got = tops.block_sgd(tW, tH, *map(torch.from_numpy,
                                      (rows, cols, vals, mask)), LR, LAM,
                         policy=tpolicy.KernelPolicy(impl=impl,
                                                     dtype_policy=policy))
    for g, w, s0 in zip(got, want, (tW, tH)):
        assert g.dtype == tW.dtype
        _check_close(g, w, s0, policy, _n_updates(mask, 16, 8))


@pytest.mark.parametrize("block_rows", [-1, 0, 64])
def test_block_sgd_cells_routes_agree_bitwise(block_rows):
    Ws, Hs, pad, _ = _grid_case(2, 3, 8)
    pol = tpolicy.KernelPolicy(impl="wave_pallas", block_rows=block_rows)
    tW, tH = torch.from_numpy(Ws), torch.from_numpy(Hs)
    pad = [torch.from_numpy(a) for a in pad]
    a = tops.block_sgd_cells(tW, tH, *pad, LR, LAM, policy=pol)
    b = tops.block_sgd_cells_csr(tW.clone(), tH.clone(),
                                 tk.WaveCSR.from_padded(*pad), LR, LAM,
                                 policy=pol)
    ref = tops.block_sgd_cells(tW, tH, *pad, LR, LAM,
                               policy=tpolicy.KernelPolicy(impl="wave"))
    for x, y, z in zip(a, b, ref):
        assert torch.equal(x, y) and torch.equal(x, z)


# --------------------------------------------------------------------- #
# on the card                                                           #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_kernel_matches_plain_on_card(requires_cuda, policy):
    Ws, Hs, pad, cells = _grid_case(4, 4, 100)
    sd = _SD[policy][2]
    acc = policy != "fp32"
    tW = torch.from_numpy(Ws).to(requires_cuda, sd)
    tH = torch.from_numpy(Hs).to(requires_cuda, sd)
    pad = [torch.from_numpy(a).to(requires_cuda) for a in pad]
    tk.reset_launches()
    gW, gH = tk.nomad_sgd_waves_grid(tW, tH, *pad, LR, LAM, accum_fp32=acc)
    torch.cuda.synchronize()
    assert tk.nomad_sgd_waves_grid.launches == 1
    cd = torch.float32 if acc else None
    for c in range(4):
        rW, rH = tref.block_sgd_waves(tW[c], tH[c], *(a[c] for a in pad),
                                      LR, LAM, compute_dtype=cd)
        n_upd = _n_updates(cells[c][5], 20, 10)
        _check_close(gW[c], rW.cpu(), tW[c], policy, n_upd)
        _check_close(gH[c], rH.cpu(), tH[c], policy, n_upd)
