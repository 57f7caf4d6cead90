"""The staged wave kernel's ring and forwarding, emulated step for step on
the CPU.

``csrc/nomad_sgd.cu`` cannot run here, so its staging is walked in
Python exactly as the kernel walks it: per cell, waves in blocks of
``BLOCK``; as each block begins the stager warp fills, into the slots of
the ratings before the block, a ring of ``R`` W-row slots for ratings
two blocks on and a ring of ``2R`` index entries, and its copies land by
the next block's end.  Each staged rating is classified by its ``prev`` link:
COPY (the previous writer of its row ran before the block), PUSH (the
writer runs in a later block and is staged: it writes its result into
this slot) or PULL (the writer may be running in this block, or is not
staged: read global memory when this rating runs).  A rating whose slot
does not hold it runs from global memory.  Every read asserts what the
kernel relies on: the index entry and the slot hold that rating, and
the copy has landed.

The emulation is held **bitwise** against the plain version
``block_sgd_waves_csr`` (a copy that forwarding keeps current is the
value the plain version gathers), and through it within the tolerance
tier of the JAX reference's ``ref.block_sgd_waves``; a control with
forwarding switched off (every slot copied when staged) must differ.
"""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import strategies
import tolerance as tol

from repro.core import partition as rpart
from repro.core.partition import pack_cell_waves
from repro.kernels import ref as rref

from repro_torch.core import nomad as tnomad
from repro_torch.core import partition as tpart
from repro_torch.kernels import nomad_sgd as tk
from repro_torch.kernels import ref as tref

COPY, PUSH, PULL = 0, 1, 2
BLOCK = tk.BLOCK
LR, LAM = 0.05, 0.05
#: ring sizes besides the plan's (256 at these shapes, so the ring never
#: wraps): small ones wrap, starve (a rating is staged a block or more
#: before it runs) and leave waves wider than the ring
SMALL_RINGS = (1, 2, 8, 32, 64)


def emulate(Ws, Hs, csr, lr, lam, R, *, forward=True, compute_dtype=None):
    """Apply ``csr`` to ``Ws``/``Hs`` in place as the kernel stages it
    with a ring of ``R`` slots.  ``forward=False`` copies every staged
    row from global memory (the control).  Returns the count of staged
    ratings by mode and of ratings run from global memory
    (``"direct"``)."""
    cd = compute_dtype if compute_dtype is not None else Ws.dtype
    lr_t, lam_t = tref._scalar(lr, cd, Ws.device), tref._scalar(lam, cd,
                                                                 Ws.device)
    rows, cols = csr.rows.tolist(), csr.cols.tolist()
    prev = csr.links().tolist()
    woff, cw = csr.woff.tolist(), csr.cell_woff.tolist()
    stats = Counter()
    for c in range(csr.n_cells):
        w_begin, w_end = cw[c], cw[c + 1]
        if w_begin >= w_end:
            continue
        base, end = woff[w_begin], woff[w_end]
        W, H = Ws[c], Hs[c]
        RI = tk.index_ring(R)
        slot_w = torch.zeros((max(R, 1), W.shape[1]), dtype=W.dtype)
        hold, mode, fwd = [-1] * R, [COPY] * R, [-1] * R
        idx = [None] * RI                  # (rating, landed)
        block_start = W.clone()            # W when the stager's block began

        def stage_index(lo, hi):
            for u in range(lo, hi):
                idx[(u - base) % RI] = [u, False]

        def stage_rows(lo, hi, applied, running):
            for u in range(lo, hi):
                held, landed = idx[(u - base) % RI]
                assert held == u and landed, "index entry not landed"
                s, p = (u - base) % R, prev[u]
                staged_p = (lo <= p < u) or (
                    p >= 0 and hold[(p - base) % R] == p)
                m = (COPY if p < applied or not forward else
                     PUSH if p >= running and staged_p else PULL)
                mode[s], hold[s], fwd[s] = m, u, -1
                if m == PUSH:
                    fwd[(p - base) % R] = s
                elif m == COPY:
                    # the copy reads global memory while the block runs:
                    # current only if no rating of the block writes the row
                    # (the control's stale case takes the block's start)
                    slot_w[s] = block_start[rows[u]]
                stats[m] += 1

        def land(upto):
            for e in idx:
                if e is not None and e[0] < upto:
                    e[1] = True

        ie = min(base + RI, end)
        stage_index(base, ie)
        land(ie)
        se = min(base + R, ie)
        stage_rows(base, se, base, base)
        ie_landed = ie
        for b0 in range(w_begin, w_end, BLOCK):
            b1 = min(b0 + BLOCK, w_end)
            done, nxt = woff[b0], woff[b1]
            block_start = W.clone()
            lo = max(se, woff[min(b1 + BLOCK, w_end)])
            lim = min(done + R, ie_landed, end)
            if lim > lo:
                stage_rows(lo, lim, done, nxt)
            se = max(lo, lim)
            ilo, ilim = max(ie, nxt), min(done + RI, end)
            if ilim > ilo:
                stage_index(ilo, ilim)
            ie_landed, ie = ie, max(ilo, ilim)
            for w in range(b0, b1):
                wa, wb = woff[w], woff[w + 1]
                w_in, targets = [], []
                for t in range(wa, wb):
                    s = (t - base) % R if R else 0
                    if R and hold[s] == t:
                        held, landed = idx[(t - base) % RI]
                        assert held == t and landed
                        w_in.append(W[rows[t]] if mode[s] == PULL
                                    else slot_w[s].clone())
                        targets.append(fwd[s])
                    else:
                        w_in.append(W[rows[t]])
                        targets.append(-1)
                        stats["direct"] += 1
                r = torch.tensor(rows[wa:wb])
                cc = torch.tensor(cols[wa:wb])
                w_new, h_new = tref.sgd_pair_batch(
                    torch.stack(w_in), H[cc], csr.vals[wa:wb].to(cd), lr_t,
                    lam_t, compute_dtype=compute_dtype)
                W[r] = w_new
                H[cc] = h_new
                for j, f in enumerate(targets):
                    if f >= 0:
                        slot_w[f] = w_new[j]
            # the stager waits for the copies of the block before, then
            # the barrier
            land(ie_landed)
    return stats


def csr_of_waves(cells):
    """A :class:`WaveCSR` from ``cells``: per cell a list of waves, each
    a list of ``(row, col, val)``."""
    rows, cols, vals, woff, cell_woff = [], [], [], [0], [0]
    for waves in cells:
        for wave in waves:
            for r, c, v in wave:
                rows.append(r)
                cols.append(c)
                vals.append(v)
            woff.append(len(rows))
        cell_woff.append(len(woff) - 1)
    return tk.WaveCSR(rows=torch.tensor(rows, dtype=torch.int32),
                      cols=torch.tensor(cols, dtype=torch.int32),
                      vals=torch.tensor(vals, dtype=torch.float32),
                      woff=torch.tensor(woff, dtype=torch.int32),
                      cell_woff=torch.tensor(cell_woff, dtype=torch.int32))


def factors(seed, n_cells, m_t, n_t, k, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    W = rng.normal(scale=0.3, size=(n_cells, m_t, k)).astype(np.float32)
    H = rng.normal(scale=0.3, size=(n_cells, n_t, k)).astype(np.float32)
    return torch.from_numpy(W).to(dtype), torch.from_numpy(H).to(dtype)


def run_both(csr, W0, H0, R, *, forward=True):
    """(emulated, plain, stats) from the same factors."""
    cd = None if W0.dtype == torch.float32 else torch.float32
    We, He = W0.clone(), H0.clone()
    stats = emulate(We, He, csr, LR, LAM, R, forward=forward,
                    compute_dtype=cd)
    Wp, Hp = tk.block_sgd_waves_csr(W0.clone(), H0.clone(), csr, LR, LAM,
                                    compute_dtype=cd)
    return (We, He), (Wp, Hp), stats


def assert_bitwise(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def ring_sizes(n_t, k, elem=4):
    return (tk.plan(n_t, k, elem).R,) + SMALL_RINGS


# -- against the plain version and the reference, on the strategies' cells


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_emulation_equals_plain_and_reference(seed, policy):
    """strategies.WAVE_CELL's ranges (k in {4, 8, 100}, up to 300
    ratings) on strategies.random_cell, packed by the reference's
    ``pack_cell_waves``: the emulation under the plan's R and small
    rings is bitwise the plain version, and within the tolerance tier of
    the reference's ``block_sgd_waves``."""
    rng = np.random.default_rng((seed, 0x57A6))
    k = (4, 8, 100)[seed % 3]
    nnz = int(rng.integers(1, 301))
    m_t, n_t = int(rng.integers(3, 25)), int(rng.integers(3, 20))
    W, H, rows, cols, vals = strategies.random_cell(rng, m_t, n_t, k, nnz)
    # N(0, 0.3) factors, as the port's kernel tests draw them: N(0, 1)
    # at k=100 diverges within a few updates
    W, H = (np.array(x, dtype=np.float32) * 0.3 for x in (W, H))
    _, wr, wc, wv, wm, _ = pack_cell_waves(rows, cols, vals)
    csr = tk.WaveCSR.from_padded(*(torch.from_numpy(a)[None]
                                   for a in (wr, wc, wv, wm)))
    jd = jnp.float32 if policy == "fp32" else jnp.bfloat16
    td = torch.float32 if policy == "fp32" else torch.bfloat16
    W0 = torch.from_numpy(W)[None].to(td)
    H0 = torch.from_numpy(H)[None].to(td)
    Wr, Hr = rref.block_sgd_waves(
        jnp.asarray(W, jd), jnp.asarray(H, jd), wr, wc, wv, wm, LR, LAM,
        compute_dtype=None if policy == "fp32" else jnp.float32)
    n_upd = max(nnz / m_t, nnz / n_t)
    for R in ring_sizes(n_t, k, W0.element_size()):
        got, plain, _ = run_both(csr, W0, H0, R)
        assert_bitwise(got, plain)
        for a, b in zip(got, (Wr, Hr)):
            tol.assert_factors_close(
                a[0].float().numpy(), np.asarray(b).astype(np.float32),
                dtype_policy=policy, n_updates=n_upd)


# -- adversarial layouts


def one_user_every_wave(n_waves=60, width=5, n_t=12, seed=0):
    """User 0 rates in every wave, beside ``width - 1`` others: every one
    of its ratings takes its row from the previous wave's."""
    rng = np.random.default_rng(seed)
    waves = []
    for j in range(n_waves):
        cs = rng.permutation(n_t)[:width]
        rs = [0] + list(rng.permutation(np.arange(1, 40))[:width - 1])
        waves.append([(int(r), int(c), float(rng.normal()))
                      for r, c in zip(rs, cs)])
    return csr_of_waves([waves]), 40, n_t


def repeats_at_the_edge(R, n_t=6, seed=1, ds=None, every=3):
    """One rating per wave; every ``every``-th rating ``u`` repeats the row
    of rating ``u - d`` for ``d`` just inside, at and just outside the
    ring (``R``) and a block (``BLOCK`` waves), or for ``d`` in ``ds``."""
    rng = np.random.default_rng(seed)
    if ds is None:
        ds = [d for d in (R - 1, R, R + 1, BLOCK - 1, BLOCK, BLOCK + 1)
              if d >= 1]
    span = max(R, BLOCK) + 1
    n = 6 * span + 8
    rows = list(range(1000, 1000 + n))
    for j, u in enumerate(range(2 * span + 2, n, every)):
        rows[u] = rows[u - ds[j % len(ds)]]
    uniq = {r: i for i, r in enumerate(dict.fromkeys(rows))}
    waves = [[(uniq[r], int(rng.integers(n_t)), float(rng.normal()))]
             for r in rows]
    return csr_of_waves([waves]), len(uniq), n_t


def wide_waves(width, n_waves=12, seed=2):
    """Waves of ``width`` ratings over few rows, so rows repeat across
    neighbouring waves and each wave is wider than a small ring."""
    rng = np.random.default_rng(seed)
    m_t = width + 3
    waves = []
    for _ in range(n_waves):
        rs = rng.permutation(m_t)[:width]
        cs = rng.permutation(width + 2)[:width]
        waves.append([(int(r), int(c), float(rng.normal()))
                      for r, c in zip(rs, cs)])
    return csr_of_waves([waves]), m_t, width + 2


def sequential_cells(seed=3):
    """Three cells, every rating its own wave (the sequential route),
    rows drawn from a few users so most ratings repeat one."""
    rng = np.random.default_rng(seed)
    cells = [[[(int(rng.integers(6)), int(rng.integers(5)),
                float(rng.normal()))] for _ in range(int(n))]
             for n in (40, 1, 25)]
    return csr_of_waves(cells), 6, 5


def with_empty_cells(seed=4):
    """Empty cells first, between and last, around two cells of waves."""
    csr, m_t, n_t = one_user_every_wave(n_waves=20, width=3, n_t=6,
                                        seed=seed)
    rng = np.random.default_rng(seed)
    cell = [[(int(r), int(c), float(rng.normal()))
             for r, c in zip(rng.permutation(m_t)[:3],
                             rng.permutation(n_t)[:3])]
            for _ in range(15)]
    return csr_of_waves([[], cell, [], [], cell[::-1], []]), m_t, n_t


ADVERSARIAL = {
    "one_user_every_wave": lambda R: one_user_every_wave(),
    "repeat_at_window_edge": lambda R: repeats_at_the_edge(max(R, 2)),
    # each rating repeats the row R - 1 before it: it comes in reach of
    # the ring while that writer may be running (PULL)
    "writer_running_when_staged": lambda R: repeats_at_the_edge(
        max(R, 2), ds=[max(R - 1, 1)], every=1),
    "wave_wider_than_ring": lambda R: wide_waves(2 * R + 3),
    "one_rating_per_wave": lambda R: sequential_cells(),
    "empty_cells": lambda R: with_empty_cells(),
}


@pytest.mark.parametrize("R", [256, *SMALL_RINGS])
@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_adversarial_layouts_bitwise(case, R):
    csr, m_t, n_t = ADVERSARIAL[case](R)
    W0, H0 = factors(sorted(ADVERSARIAL).index(case), csr.n_cells, m_t,
                     n_t, 8)
    got, plain, stats = run_both(csr, W0, H0, R)
    assert_bitwise(got, plain)
    if case == "one_user_every_wave" and R == 256:
        # user 0's 59 repeats all come from a later staged wave
        assert stats[PUSH] >= 59
    if case == "wave_wider_than_ring":
        assert stats["direct"] > 0
    if case == "repeat_at_window_edge" and R >= 32:
        assert stats[PUSH] > 0 and stats[COPY] > 0
    if case == "writer_running_when_staged" and R >= 32:
        assert stats[PULL] > 0


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_one_user_every_wave_bf16_and_fp32(policy):
    td = torch.float32 if policy == "fp32" else torch.bfloat16
    csr, m_t, n_t = one_user_every_wave(seed=5)
    W0, H0 = factors(5, 1, m_t, n_t, 100, td)
    got, plain, stats = run_both(csr, W0, H0, tk.plan(n_t, 100, 4).R)
    assert_bitwise(got, plain)
    assert stats[PUSH] > 0


@pytest.mark.parametrize("case", ["one_user_every_wave",
                                  "repeat_at_window_edge",
                                  "writer_running_when_staged",
                                  "one_rating_per_wave"])
def test_control_without_forwarding_differs(case):
    """Staged rows copied when staged, whatever their previous writer:
    stale rows, so the result must differ from the plain version."""
    R = 32
    csr, m_t, n_t = ADVERSARIAL[case](R)
    W0, H0 = factors(6, csr.n_cells, m_t, n_t, 8)
    got, plain, _ = run_both(csr, W0, H0, R, forward=False)
    assert not (torch.equal(got[0], plain[0])
                and torch.equal(got[1], plain[1]))


# -- the forward links and the layout around them


def brute_prev(csr):
    rows, woff, cw = csr.rows.tolist(), csr.woff.tolist(), \
        csr.cell_woff.tolist()
    out = [-1] * len(rows)
    for c in range(csr.n_cells):
        last = {}
        for t in range(woff[cw[c]], woff[cw[c + 1]]):
            out[t] = last.get(rows[t], -1)
            last[rows[t]] = t
    return out


@pytest.mark.parametrize("seed", range(6))
def test_same_row_prev_matches_brute_force(seed):
    rng = np.random.default_rng((seed, 0x9E))
    cells = []
    for _ in range(int(rng.integers(1, 5))):
        n_w = int(rng.integers(0, 12))
        cells.append([[(int(rng.integers(7)), int(rng.integers(9)), 0.0)
                       for _ in range(int(rng.integers(1, 4)))]
                      for _ in range(n_w)])
    csr = csr_of_waves(cells)
    assert csr.prev is None            # built when first needed
    assert csr.links().dtype == torch.int32
    assert csr.links().tolist() == brute_prev(csr)
    # a run of cells selected as views shares the links
    assert csr.cells(0, csr.n_cells).prev is csr.links()


@pytest.mark.parametrize("sequential", [False, True])
def test_wave_csr_links_and_flat_lists_match_reference_pack(sequential):
    """``wave_csr``'s flat lists are byte for byte the reference
    ``pack``'s (step-major, masked), and its ``prev`` the brute-force
    links."""
    rows, cols, vals = strategies.coo_problem(11, 30, 20, 350)
    kw = dict(p=3, waves=True, sub_blocks=1)
    ref = rpart.pack(rows, cols, vals.astype(np.float32), 30, 20, **kw)
    port = tpart.pack(rows, cols, vals.astype(np.float32), 30, 20, **kw)
    csr = tnomad.wave_csr(port, sequential=sequential)
    mask = np.swapaxes(ref.mask, 0, 1)
    for name in ("rows", "cols", "vals"):
        want = np.swapaxes(getattr(ref, name), 0, 1)[mask]
        got = getattr(csr, name).numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert csr.links().tolist() == brute_prev(csr)


# -- the plan


def test_plan_keeps_netflix_tenth_resident_and_full_netflix_global():
    for elem in (4, 2):
        p = tk.plan(228, 100, elem)
        assert p.resident and p.R == 256 and p.smem <= tk.MAX_SMEM
    assert tk.plan(228, 100, 4).smem == 205_888
    assert tk.plan(228, 100, 2).copy_bytes == 8
    full = tk.plan(2222, 100, 4)
    assert not full.resident and full.R == 256


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("n_t", [1, 228, 2222])
def test_plan_fits_for_every_k(elem, n_t):
    for k in range(1, tk.MAX_K + 1):
        p = tk.plan(n_t, k, elem)
        assert p.smem == tk.plan_smem(n_t, k, elem, p.resident, p.R)
        assert p.smem <= tk.MAX_SMEM and p.R in tk.RINGS
        assert (k * elem) % p.copy_bytes == 0
        if p.resident:
            assert p.R >= tk.RESIDENT_MIN_RING
    with pytest.raises(ValueError):
        tk.plan(n_t, tk.MAX_K + 1, elem)


def test_plan_copy_width_follows_alignment():
    assert tk.plan(10, 100, 4, align=8).copy_bytes == 8
    assert tk.plan(10, 101, 2).copy_bytes == 2
    assert tk.plan(10, 102, 2).copy_bytes == 4


@pytest.fixture
def requires_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def test_kernel_rings_agree_on_card(requires_cuda):
    """On the card: the kernel under its plan and through the profile
    entry at small rings (which wrap, forward and run wide waves from
    global memory) give the same bits."""
    csr, m_t, n_t = one_user_every_wave()
    W0, H0 = factors(7, 1, m_t, n_t, 100)
    W0, H0 = W0.to(requires_cuda), H0.to(requires_cuda)
    csr = csr.to(requires_cuda)
    want = tk.nomad_sgd_waves_csr(W0.clone(), H0.clone(), csr, LR, LAM)
    for R in SMALL_RINGS:
        for resident in (True, False):
            pl = tk.Plan(resident, R, 16,
                         tk.plan_smem(n_t, 100, 4, resident, R))
            W, H = W0.clone(), H0.clone()
            tk.wave_split(W, H, csr, LR, LAM, pl)
            assert torch.equal(W, want[0]) and torch.equal(H, want[1])
