"""The CUDA top-k kernel's selection, emulated step for step on the CPU.

``csrc/topk.cu`` cannot run here, so its selection is walked in numpy
exactly as the kernel walks it: 64-bit keys (score order, then
``0xFFFFFFFF - id``), CTAs of ``ub`` users over stripes of 256-item
chunks, a key entering a user's candidate buffer only above the user's
threshold (the last key of its running list), flushes of only those
candidates (for lists of up to 32 keys, in a warp's registers, 32
candidates at a time, a few by insertion, more by bitonic networks; for
longer ones a bitonic
sort padded to a power of two, then an insertion by rank that moves the
list's keys in place, from the back; truncated to ``L``), the
pairwise merge tournament over the stripes' lists and the decode.  The
result is held **bitwise**, ids and scores, against the port's dense
oracle and the JAX reference's ``_topk_xla`` on the same numpy inputs,
over catalogs chosen to reach every branch: ties, a rising catalog
(every item passes), a falling one, ``-inf`` and ``-0.0`` scores,
``k_top = n``, ``k_top`` above a stripe, a ragged user block, one stripe
and more stripes than chunks.  A control that ties towards the larger id
must be rejected by the same comparison.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import strategies
import torch

from repro.serve.topk import _topk_xla

from repro_torch.kernels import topk as tk
from repro_torch.serve import topk_dense_oracle

CHUNK = tk.CHUNK
WARP = 32
_TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}
_JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16}


def kernel_scores(W_u, H, hs):
    """The kernel's scores: the fp32 dot, the scale after it, one rounding
    to the score type; held in fp32 (``-0.0`` is left to the key)."""
    s = W_u.float() @ H.float().T
    if hs is not None:
        s = s * hs[None, :]
    return s.to(W_u.dtype).float().numpy()


def make_keys(scores, larger_id=False):
    """``csrc/topk.cu``'s ``make_key`` over a (U, n) fp32 array; the
    control ``larger_id`` puts the id itself in the low word."""
    b = scores.astype(np.float32).view(np.uint32).copy()
    b[(b & 0x7FFFFFFF) == 0] = 0
    order = np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint64)
    ids = np.arange(scores.shape[1], dtype=np.uint64)
    low = ids if larger_id else np.uint64(0xFFFFFFFF) - ids
    return (order << np.uint64(32)) | low[None, :]


def decode(keys, n, larger_id=False):
    """``topk_decode_kernel``: keys back to (fp32 score, id); key 0 and
    ``-inf`` report ``(-inf, n)``."""
    order = (keys >> np.uint64(32)).astype(np.uint32)
    b = np.where(order & 0x80000000, order & 0x7FFFFFFF, ~order)
    s = b.astype(np.uint32).view(np.float32).copy()
    low = (keys & np.uint64(0xFFFFFFFF)).astype(np.int64)
    ids = low if larger_id else 0xFFFFFFFF - low
    gone = (keys == 0) | (s == -np.inf)
    s[gone] = -np.inf
    ids[gone] = n
    return s, ids.astype(np.int32)


def bitonic_desc(cb, c):
    """``flush_user``'s sort of ``cb[:c]`` padded with key 0 to the next
    power of two: one stage at a time (a stage's pairs are disjoint, and
    each lane loads its pairs before it stores any, so the lanes' loop is
    one vector step)."""
    P = 1
    while P < c:
        P <<= 1
    cb[c:P] = 0
    size = 2
    while size <= P:
        stride = size >> 1
        while stride > 0:
            j = np.arange(P // 2)
            i = ((j & ~(stride - 1)) << 1) | (j & (stride - 1))
            a, b = cb[i].copy(), cb[i + stride].copy()
            swap = (a < b) == ((i & size) == 0)
            cb[i[swap]], cb[i[swap] + stride] = b[swap], a[swap]
            stride >>= 1
        size <<= 1


def warp_exchange(x, stride, desc):
    """``warp_exchange`` over the 32 lanes: lane and lane ^ stride keep
    the larger key where the lane's stride bit is clear and ``desc``."""
    lane = np.arange(WARP)
    o = x[lane ^ stride]
    keep_max = ((lane & stride) == 0) == desc
    return np.where(keep_max, np.maximum(x, o), np.minimum(x, o))


INSERT = 4      # csrc/topk.cu's kInsert


def flush_short(lb, cb, c):
    """``flush_short`` (lists of up to 32 keys): the list in registers,
    the candidates 32 at a time; a batch of at most ``INSERT`` inserted
    one by one at the rank a ballot counts, a larger one sorted across
    the warp and folded in by the larger of list[i] and candidate[31 -
    i]."""
    L = len(lb)
    lane = np.arange(WARP)
    x = np.zeros(WARP, np.uint64)
    x[:L] = lb
    for base in range(0, c, WARP):
        if c - base <= INSERT:
            for y in cb[base:c]:
                r = int(np.count_nonzero(x > y))
                up = np.concatenate([x[:1], x[:-1]])
                x = np.where(lane < r, x, np.where(lane == r, y, up))
            break
        y = np.zeros(WARP, np.uint64)
        batch = cb[base:min(c, base + WARP)]
        y[:len(batch)] = batch
        size = 2
        while size <= WARP:
            stride = size >> 1
            while stride:
                y = warp_exchange(y, stride, (lane & size) == 0)
                stride >>= 1
            size <<= 1
        x = np.maximum(x, y[::-1])
        stride = WARP // 2
        while stride:
            x = warp_exchange(x, stride, True)
            stride >>= 1
    lb[:] = x[:L]


def flush(lb, cb, c):
    """``flush_user`` (lists of more than 32 keys; shorter ones take
    :func:`flush_short`): sort the ``c`` candidates; rank the best ``cn``
    against the list; move each list key down by the number of kept
    candidates ranked at or above it, in place, from the back, 4 x 32
    keys per step, each step reading all its keys before writing any;
    then write the candidates into their places, all dropped past L."""
    bitonic_desc(cb, c)
    L = len(lb)
    cn = min(c, L)
    rk = []
    for j in range(cn):
        lo, hi = 0, L
        while lo < hi:
            mid = (lo + hi) >> 1
            if lb[mid] > cb[j]:
                lo = mid + 1
            else:
                hi = mid
        rk.append(lo)
    top_step = 1
    while top_step * 2 <= cn:
        top_step <<= 1
    for top in range(L, rk[0], -4 * WARP):
        moves = []
        for p in range(max(top - 4 * WARP, rk[0]), top):
            g, step = 0, top_step
            while step:
                if g + step <= cn and rk[g + step - 1] <= p:
                    g += step
                step >>= 1
            moves.append((p + g, lb[p]))
        for q, v in moves:
            if q < L:
                lb[q] = v
    for j in range(cn):
        if j + rk[j] < L:
            lb[j + rk[j]] = cb[j]


def stripe_lists(keys, k_top, ub, S, rng):
    """Pass 1 (``topk_stripe_kernel``): each CTA's running lists, as the
    (U, S, L) keys it writes.  After each chunk, the keys above a user's
    threshold, in an order the kernel's atomics leave open (here a random
    one), are flushed into its list."""
    U, n = keys.shape
    n_chunks = -(-n // CHUNK)
    cps, L = tk.stripe_shape(n, k_top, S)
    out = np.zeros((U, S, L), np.uint64)
    for u0 in range(0, U, ub):
        users = min(ub, U - u0)
        for s in range(S):
            lists = np.zeros((users, L), np.uint64)
            cand = np.zeros((users, CHUNK), np.uint64)
            for chunk in range(s * cps, min(s * cps + cps, n_chunks)):
                items = slice(chunk * CHUNK, min(n, (chunk + 1) * CHUNK))
                for u in range(users):
                    k = keys[u0 + u, items]
                    passed = rng.permutation(k[k > lists[u, L - 1]])
                    cand[u, :len(passed)] = passed
                    if len(passed):
                        (flush_short if L <= WARP else flush)(
                            lists[u], cand[u], len(passed))
            out[u0:u0 + users, s] = lists
    return out, L


def merge_round(lists, L, k_top):
    """``topk_merge_kernel``: lists 2j and 2j+1 of every user into list j
    of ``Lo = min(k_top, 2L)`` by the co-rank of each output."""
    U, nl, _ = lists.shape
    nlo, Lo = (nl + 1) // 2, min(k_top, 2 * L)
    out = np.zeros((U, nlo, Lo), np.uint64)
    i = np.arange(Lo)
    for u in range(U):
        for j in range(nlo):
            A = lists[u, 2 * j]
            if 2 * j + 1 >= nl:
                out[u, j, :min(L, Lo)] = A[:Lo]
                continue
            B = lists[u, 2 * j + 1]
            lo, hi = np.maximum(i - L, 0), np.minimum(i, L)
            while (lo < hi).any():
                act = lo < hi
                mid = (lo + hi) >> 1
                midc = np.minimum(mid, L - 1)
                cond = A[midc] >= B[np.clip(i - mid - 1, 0, L - 1)]
                lo = np.where(act & cond, mid + 1, lo)
                hi = np.where(act & ~cond, mid, hi)
            a, b = lo, i - lo
            Aa = A[np.minimum(a, L - 1)]
            Bb = B[np.minimum(b, L - 1)]
            take_a = (a < L) & ((b >= L) | (Aa >= Bb))
            out[u, j] = np.where(take_a, Aa, Bb)
    return out, Lo


def emulate(scores, k_top, ub, S, larger_id=False, seed=0):
    """The kernel's selection on fp32 ``scores`` (U, n): ``(scores,
    ids)`` of shape (U, k_top)."""
    keys = make_keys(scores, larger_id)
    lists, L = stripe_lists(keys, k_top, ub, S, np.random.default_rng(seed))
    while lists.shape[1] > 1:
        lists, L = merge_round(lists, L, k_top)
    return decode(lists[:, 0, :k_top], scores.shape[1], larger_id)


def _rising(n, k, falling=False):
    """Three users whose scores, (u + 1) * id, rise with the item id, so
    every item passes every threshold (or, ``falling``, fall with it)."""
    W = np.zeros((3, k), np.float32)
    W[:, 0] = [1, 2, 3]
    H = np.zeros((n, k), np.float32)
    H[:, 0] = np.arange(n)[::-1] if falling else np.arange(n)
    return W, H


def _signed_edges(seed, n):
    """Rank 1, so each score is one product: positive integer users
    against items of -1, 0, 1 and 2, a fifth of them ``-0.0`` (scored
    ``-0.0``, equal to ``+0.0``) and a seventh ``-inf``."""
    rng = np.random.default_rng(seed)
    W = rng.integers(1, 3, (5, 1)).astype(np.float32)
    H = rng.integers(-1, 3, (n, 1)).astype(np.float32)
    H[rng.choice(n, n // 5, replace=False)] = -0.0
    H[rng.choice(n, n // 7, replace=False)] = -np.inf
    return W, H


# name: (W_u, H, h_scale, storage, k_top, ub, S)
def _cases():
    ties = lambda s, U, n, k: strategies.topk_case(s, U, n, k, True)
    normal = lambda s, U, n, k: strategies.topk_case(s, U, n, k, False)
    rng = np.random.default_rng(9)
    Wi, Hi = ties(3, 6, 1100, 8)
    scale = rng.uniform(0.01, 1.0, 1100).astype(np.float32)
    return {
        "normal": (*normal(0, 5, 3000, 16), None, "fp32", 10, 4, 3),
        "normal_long_list": (*normal(10, 5, 3000, 16), None, "fp32", 60, 4,
                             2),
        "normal_bf16": (*normal(1, 4, 2000, 8), None, "bf16", 25, 2, 3),
        "ties": (*ties(2, 6, 2100, 8), None, "fp32", 50, 4, 3),
        "ties_int8": (Wi, Hi.astype(np.int8), scale, "int8", 30, 2, 2),
        "rising": (*_rising(1500, 3), None, "fp32", 40, 4, 2),
        "falling": (*_rising(1500, 3, falling=True), None, "fp32", 40, 4,
                    2),
        "neg_inf_and_neg_zero": (*_signed_edges(4, 900), None, "fp32", 900,
                                 8, 2),
        "k_top_n": (*ties(5, 3, 700, 4), None, "fp32", 700, 4, 2),
        "k_top_above_stripe": (*ties(6, 4, 2000, 8), None, "fp32", 700, 4,
                               4),
        "ragged_user_block": (*ties(7, 7, 1300, 8), None, "fp32", 20, 4, 2),
        "one_stripe": (*ties(8, 5, 1500, 8), None, "fp32", 30, 8, 1),
        "more_stripes_than_chunks": (*ties(9, 5, 600, 8), None, "fp32", 15,
                                     4, 5),
    }


CASES = _cases()


def _port(W_u, H, hs, storage):
    if storage == "int8":
        return (torch.from_numpy(W_u), torch.from_numpy(H),
                torch.from_numpy(hs))
    sd = _TORCH[storage]
    return torch.from_numpy(W_u).to(sd), torch.from_numpy(H).to(sd), None


def _reference(W_u, H, hs, storage, k_top):
    if storage == "int8":
        args = jnp.asarray(W_u), jnp.asarray(H), jnp.asarray(hs)
    else:
        args = (jnp.asarray(W_u, _JNP[storage]),
                jnp.asarray(H, _JNP[storage]), None)
    s, i = _topk_xla(*args, k_top=k_top, item_tile=512)
    return np.asarray(s).astype(np.float32) + np.float32(0.0), np.asarray(i)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("name", list(CASES))
def test_emulated_selection_matches_oracle_and_reference(name):
    W_u, H, hs, storage, k_top, ub, S = CASES[name]
    tW, tH, ths = _port(W_u, H, hs, storage)
    n = H.shape[0]
    cps, L = tk.stripe_shape(n, k_top, S)
    if name == "k_top_above_stripe":
        assert L < k_top
    if name == "more_stripes_than_chunks":
        assert S > -(-n // CHUNK)
    if name == "ragged_user_block":
        assert W_u.shape[0] % ub
    scores = kernel_scores(tW, tH, ths)
    if name == "neg_inf_and_neg_zero":
        assert np.signbit(scores[scores == 0]).any()
        assert (scores == -np.inf).any()
    s, i = emulate(scores, k_top, ub, S)
    es, ei = topk_dense_oracle(tW, tH, k_top, h_scale=ths)
    # the dense oracle keeps the ids of -inf scores; the scans and the
    # kernel report the sentinel n there
    np.testing.assert_array_equal(i, np.where(es == -np.inf, n, ei))
    np.testing.assert_array_equal(_bits(s), _bits(es))
    if name == "neg_inf_and_neg_zero":
        # the reference's lax.top_k ranks -0.0 below +0.0; its Pallas
        # kernel, which this kernel ports, and the port hold them one
        # score (ROADMAP Queue 3): so it gets the catalog with -0.0
        # written +0.0, which scores the same by that rule
        H = np.where(H == 0, np.float32(0.0), H)
    rs, ri = _reference(W_u, H, hs, storage, k_top)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(_bits(s), _bits(rs))
    if name == "neg_inf_and_neg_zero":
        assert (i == n).any() and (s == 0).any()
        assert not np.signbit(s[s == 0]).any()


def test_emulated_selection_ties_to_larger_id_is_rejected():
    W_u, H, hs, storage, k_top, ub, S = CASES["ties"]
    tW, tH, _ = _port(W_u, H, hs, storage)
    s, i = emulate(kernel_scores(tW, tH, None), k_top, ub, S,
                   larger_id=True)
    es, ei = topk_dense_oracle(tW, tH, k_top)
    np.testing.assert_array_equal(_bits(s), _bits(es))   # same scores ...
    assert not np.array_equal(i, ei)                      # ... other ids


@pytest.mark.parametrize("which", ["flush", "flush_short"])
def test_flush_keeps_the_best_of_list_and_candidates(which):
    rng = np.random.default_rng(1)
    fn = globals()[which]
    for L, c in ((1, 1), (10, 256), (32, 200), (40, 3), (100, 100),
                 (64, 33), (300, 256), (16, 3), (32, 5), (20, 36)):
        if which == "flush_short" and L > WARP:
            continue
        seen = rng.choice(2 ** 40, L + 600, replace=False).astype(np.uint64)
        lb = np.sort(seen[:L])[::-1].copy()
        pool = seen[L:]
        cand = pool[pool > lb[-1]][:c]
        cb = np.zeros(CHUNK, np.uint64)
        cb[:len(cand)] = rng.permutation(cand)
        fn(lb, cb, len(cand))
        want = np.sort(np.concatenate([seen[:L], cand]))[::-1][:L]
        np.testing.assert_array_equal(lb, want)


@pytest.mark.parametrize("U,n,k,k_top,sms", [
    (64, 624_961, 100, 10, 132), (64, 624_961, 100, 1000, 132),
    (1, 624_961, 100, 10, 132), (8, 624_961, 100, 10, 132),
    (64, 1777, 100, 10, 132), (64, 1777, 100, 1777, 132),
    (3, 200_000, 16, 200_000, 132), (1, 2_000_000, 16, 2_000_000, 4),
    (33, 5000, 7, 300, 4)])
def test_plan_fits_and_fills_the_card(U, n, k, k_top, sms):
    p = tk.plan(U, n, k, k_top, sms)
    n_chunks = -(-n // CHUNK)
    assert p.ub in tk.USER_BLOCKS and p.ub <= max(1, 1 << (U - 1).bit_length())
    assert p.smem == tk.stripe_smem(p.ub, p.L, k) <= tk.MAX_SMEM // 2
    assert (p.cps, p.L) == tk.stripe_shape(n, k_top, p.stripes)
    assert (p.stripes - 1) * p.cps < n_chunks <= p.stripes * p.cps
    # one wave of at most two CTAs per SM, and more than one per SM
    # where the catalog has the chunks for it
    blocks = -(-U // p.ub)
    if tk.stripe_smem(1, min(k_top, n_chunks // (2 * sms) * CHUNK), k) \
            > tk.MAX_SMEM // 2:
        # even one user's list does not fit: shorter stripes, more waves
        assert p.ub == 1 and p.L == p.cps * CHUNK < k_top
    else:
        assert blocks * p.stripes <= max(2 * sms, blocks)
        assert p.stripes == n_chunks or blocks * p.stripes > sms
    if k_top <= p.cps * CHUNK:
        assert p.L == k_top


@pytest.mark.parametrize("U,n,k_top,sms", [(9, 3000, 12, 2), (2, 700, 300, 3),
                                            (40, 1300, 7, 1)])
def test_emulated_selection_on_the_plan(U, n, k_top, sms):
    W_u, H = strategies.topk_case(U + n, U, n, 8, True)
    tW, tH = torch.from_numpy(W_u), torch.from_numpy(H)
    p = tk.plan(U, n, 8, k_top, sms)
    s, i = emulate(kernel_scores(tW, tH, None), k_top, p.ub, p.stripes)
    es, ei = topk_dense_oracle(tW, tH, k_top)
    np.testing.assert_array_equal(i, ei)
    np.testing.assert_array_equal(_bits(s), _bits(es))
