"""The port's serving tier against the JAX package's, on the same inputs.

On CPU tensors the top-k kernel's wrapper runs its plain version, so the
port's ``topk_scores`` (both scorers) is held against the reference's
``_topk_xla`` and its ``_topk_pallas`` in interpret mode.  On
integer-valued factors every summation order is exact, so ids and scores
must be **bitwise** equal, ties included; on normal factors the scores
agree within ``16 eps sqrt(k)`` (the k-dot is summed in another order)
and the ids wherever neighbouring scores are further apart than that.

Store and server contracts are the reference's, on a store on the CPU;
ids are held exactly against the port's own scores (the reference's
tests that demand bitwise equality with a jnp matmul fail under jax
0.9.0, ROADMAP.md Queue 3).  The kernel itself runs only on a card:
that test takes the ``requires_cuda`` fixture and skips here.
"""
import functools
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import strategies
import torch

import tolerance as tol

from repro import api as rapi
from repro import serve as rserve
from repro.checkpoint import save_fit_result as rsave_fit_result
from repro.serve.topk import _topk_pallas, _topk_xla

from repro_torch import api as tapi
from repro_torch import serve as tserve
from repro_torch.checkpoint import save_fit_result as tsave_fit_result
from repro_torch.convert import serving_factors
from repro_torch.kernels import topk as tk
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.launch import serve_mc
from repro_torch.serve import (FactorStore, FactorView, RecServer,
                               ServeConfig, ServeTimeout)

CPU = "cpu"
_JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
_TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def requires_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(seed, users, items, k_rank, storage, ties=True):
    """Numpy ``(W_u, H, h_scale)`` for one storage tier; int8 holds
    integer-valued f32 user rows against an int8 catalog with positive
    per-item scales."""
    W_u, H = strategies.topk_case(seed, users, items, k_rank, ties)
    if storage != "int8":
        return W_u, H, None
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.01, 1.0, items).astype(np.float32)
    return W_u, H.astype(np.int8), scale


def _ref_inputs(W_u, H, hs, storage):
    if storage == "int8":
        return jnp.asarray(W_u), jnp.asarray(H), jnp.asarray(hs)
    return (jnp.asarray(W_u, _JNP[storage]), jnp.asarray(H, _JNP[storage]),
            None)


def _port_inputs(W_u, H, hs, storage):
    if storage == "int8":
        return (torch.from_numpy(W_u), torch.from_numpy(H),
                torch.from_numpy(hs))
    sd = _TORCH[storage]
    return torch.from_numpy(W_u).to(sd), torch.from_numpy(H).to(sd), None


def _f32(x):
    """Scores as f32 with -0.0 made +0.0: the reference treats the two as
    one score, and its sums may carry either sign where the port's
    carry +0.0."""
    return np.asarray(x).astype(np.float32) + np.float32(0.0)


@functools.lru_cache(maxsize=None)
def _reference(seed, users, items, k_rank, k_top, item_tile, storage):
    W_u, H, hs = _case(seed, users, items, k_rank, storage)
    rW, rH, rhs = _ref_inputs(W_u, H, hs, storage)
    out = {}
    for name, fn in (("xla", _topk_xla), ("pallas", functools.partial(
            _topk_pallas, interpret=True))):
        s, i = fn(rW, rH, rhs, k_top=k_top, item_tile=item_tile)
        out[name] = (_f32(s), np.asarray(i))
    return out


SHAPES = [
    # seed, users, items, k_rank, k_top, item_tile
    (0, 4, 64, 8, 10, 16),      # tile divides catalog
    (1, 4, 53, 8, 10, 16),      # ragged last tile
    (2, 3, 7, 4, 7, 4),         # k_top == catalog
    (3, 8, 40, 16, 5, 64),      # single tile covers all
    (5, 5, 33, 4, 33, 8),       # ragged, full-catalog k_top
]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("shape", SHAPES)
def test_topk_matches_reference_bitwise(shape, storage, impl):
    seed, users, items, k_rank, k_top, item_tile = shape
    tW, tH, ths = _port_inputs(*_case(seed, users, items, k_rank, storage),
                               storage)
    s, i = tserve.topk_scores(tW, tH, k_top, policy=impl,
                              item_tile=item_tile, h_scale=ths)
    assert s.dtype == (torch.bfloat16 if storage == "bf16"
                       else torch.float32)
    assert i.dtype == torch.int32 and tuple(i.shape) == (users, k_top)
    got_s, got_i = tserve.topk.to_host(s), i.numpy()
    assert not np.signbit(got_s[got_s == 0]).any()      # +0.0 only
    for name, (ref_s, ref_i) in _reference(*shape, storage).items():
        np.testing.assert_array_equal(got_i, ref_i, err_msg=name)
        tol.assert_bitwise(got_s, ref_s, f"{name} scores")
    es, ei = tserve.topk_dense_oracle(tW, tH, k_top, h_scale=ths)
    np.testing.assert_array_equal(got_i, ei)
    tol.assert_bitwise(got_s, es, "dense oracle")


def test_kernel_wrapper_runs_plain_version_on_cpu():
    W_u, H, _ = _case(4, 6, 60, 3, "fp32")
    tk.reset_launches()
    a = tk.topk_scores_cuda(torch.from_numpy(W_u), torch.from_numpy(H),
                            k_top=12, item_tile=16)
    b = tk.topk_plain(torch.from_numpy(W_u), torch.from_numpy(H), k_top=12,
                      item_tile=7)
    assert tk.topk_scores_cuda.launches == 0      # no kernel on the CPU
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("seed,k_top", [(0, 1), (1, 7), (2, 40)])
def test_topk_normal_factors_within_tolerance(seed, k_top):
    users, items, k = 5, 90, 16
    W_u, H = strategies.topk_case(seed, users, items, k, False)
    kk = min(items, k_top + 1)       # one more: the gap below the last
    rs, ri = (np.asarray(x) for x in _topk_xla(
        jnp.asarray(W_u), jnp.asarray(H), None, k_top=kk, item_tile=32))
    s, i = tserve.topk_scores(W_u, H, k_top, item_tile=32)
    s, i = s.numpy(), i.numpy()
    bound = 16 * tol.EPS["fp32"] * np.sqrt(k)
    np.testing.assert_array_less(np.abs(s - rs[:, :k_top]),
                                 bound * (1 + np.abs(rs[:, :k_top])))
    scale = bound * (1 + np.abs(rs))
    gap = np.diff(rs, axis=1) * -1                       # >= 0
    apart = np.ones((users, kk), bool)
    apart[:, 1:] &= gap > 2 * scale[:, 1:]
    apart[:, :-1] &= gap > 2 * scale[:, :-1]
    sel = apart[:, :k_top]
    assert sel.mean() > 0.5                      # the check bites
    np.testing.assert_array_equal(i[sel], ri[:, :k_top][sel])


def test_topk_tie_break_is_smaller_id_and_zero_sign():
    W_u = np.ones((3, 4), np.float32)
    H = np.ones((20, 4), np.float32)
    for impl in ("xla", "pallas"):
        s, i = tserve.topk_scores(W_u, H, 5, policy=impl, item_tile=8)
        np.testing.assert_array_equal(
            i.numpy(), np.tile(np.arange(5, dtype=np.int32), (3, 1)))
        np.testing.assert_array_equal(s.numpy(), np.full((3, 5), 4.0))
    # -0.0 and +0.0 tie: the smaller id wins, whichever sign it has
    W_u = np.array([[1.0]], np.float32)
    H = np.array([[-0.0], [0.0], [-0.0], [-1.0]], np.float32)
    s, i = tserve.topk_scores(W_u, H, 3, item_tile=2)
    assert i.tolist() == [[0, 1, 2]]
    assert np.signbit(s.numpy()).tolist() == [[False, False, False]]


def test_topk_validates():
    W_u = np.ones((2, 4), np.float32)
    H = np.ones((10, 4), np.float32)
    with pytest.raises(ValueError, match="k_top"):
        tserve.topk_scores(W_u, H, 0)
    with pytest.raises(ValueError, match="k_top"):
        tserve.topk_scores(W_u, H, 11)
    with pytest.raises(ValueError, match="item_tile"):
        tserve.topk_scores(W_u, H, 3, item_tile=0)
    with pytest.raises(ValueError, match="rank mismatch"):
        tserve.topk_scores(W_u, np.ones((10, 5), np.float32), 3)
    with pytest.raises(TypeError, match="dtypes"):
        tk.topk_scores_cuda(torch.ones(2, 4), torch.ones(10, 4).double(),
                            k_top=3)


def test_serve_impl_policy_mapping():
    for impl, want in (("xla", "xla"), ("wave", "xla"), ("pallas", "pallas"),
                       ("wave_pallas", "pallas")):
        for dev in ("cpu", "cuda"):
            assert KernelPolicy.coerce(impl).serve_impl(dev) == want
    assert KernelPolicy.coerce("auto").serve_impl("cuda") == "pallas"
    assert KernelPolicy.coerce("auto").serve_impl("cpu") == "xla"


def test_defaults_resolve_to_kernel_on_cuda_and_plain_on_cpu():
    cfg = ServeConfig()
    assert cfg.kernel.impl == "auto"
    assert cfg.kernel.serve_impl(torch.device("cuda")) == "pallas"
    assert cfg.kernel.serve_impl(torch.device("cpu")) == "xla"
    args = serve_mc.build_parser().parse_args([])
    assert args.impl == "auto" and args.device is None
    assert ServeConfig(kernel=args.impl).kernel.serve_impl("cuda") == "pallas"


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        FactorStore()
    with pytest.raises(RuntimeError, match="cuda"):
        serve_mc.main(["--demo", "--smoke"])


# --------------------------------------------------------------------- #
# filtered path                                                          #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("seed", [1, 2])
def test_topk_filtered_matches_reference(seed, impl):
    rng = np.random.default_rng(seed)
    W_u, H = strategies.topk_case(seed, 12, 40, 6, True)
    exclude = [rng.choice(40, size=rng.integers(0, 15), replace=False)
               for _ in range(12)]
    s, i = tserve.topk_scores_filtered(W_u, H, 6, exclude=exclude,
                                       policy=impl, item_tile=16)
    rs, ri = rserve.topk_scores_filtered(W_u, H, 6, exclude=exclude,
                                         policy="xla", item_tile=16)
    np.testing.assert_array_equal(i, ri)
    tol.assert_bitwise(s, _f32(rs), "filtered scores")
    for u in range(12):
        assert not set(i[u].tolist()) & set(exclude[u].tolist())


def test_topk_filtered_exhausted_user_pads_with_sentinel():
    W_u, H = strategies.topk_case(4, 3, 8, 4, True)
    exclude = [np.arange(6), np.array([], np.int64), np.arange(8)]
    s, i = tserve.topk_scores_filtered(W_u, H, 4, exclude=exclude,
                                       item_tile=4)
    assert np.all(i[0, 2:] == 8) and np.all(np.isneginf(s[0, 2:]))
    assert np.all(i[1] < 8) and np.all(i[2] == 8)
    rs, ri = rserve.topk_scores_filtered(W_u, H, 4, exclude=exclude,
                                         policy="xla", item_tile=4)
    np.testing.assert_array_equal(i, ri)
    tol.assert_bitwise(s, _f32(rs), "filtered scores")


# --------------------------------------------------------------------- #
# FactorStore                                                            #
# --------------------------------------------------------------------- #

def _wh(m, n, k=4, fill=1.0):
    return (np.full((m, k), fill, np.float32),
            np.full((n, k), fill, np.float32))


def test_store_versions_are_monotone_and_on_its_device():
    store = FactorStore(CPU)
    with pytest.raises(RuntimeError, match="no published factors"):
        store.view()
    assert store.version is None
    for v in range(5):
        view = store.publish(*_wh(6, 3))
        assert view.version == v == store.version
    assert store.view().m == 6 and store.view().n == 3
    assert store.view().W.device.type == "cpu"
    with pytest.raises(ValueError, match="W and H"):
        store.publish(np.ones((4, 3), np.float32),
                      np.ones((5, 2), np.float32))


def test_view_pins_its_version_across_publishes():
    store = FactorStore(CPU)
    store.publish(*_wh(4, 3, fill=1.0))
    pinned = store.view()
    for v in range(1, 5):
        store.publish(*_wh(4, 3, fill=float(v + 1)))
    assert pinned.version == 0
    assert torch.equal(pinned.W, torch.ones(4, 4))
    assert store.view().version == 4


def test_catalog_maps_translate_and_reject():
    W, H = _wh(3, 4)
    view = FactorView(version=0, W=W, H=H,
                      user_ids=np.array([30, 10, 20]),
                      item_ids=np.array([7, 5, 6, 9]))
    np.testing.assert_array_equal(view.user_rows([10, 30, 20]), [1, 0, 2])
    with pytest.raises(KeyError, match="99"):
        view.user_rows([10, 99])
    np.testing.assert_array_equal(view.item_catalog(np.array([2, 0])),
                                  [6, 7])
    plain = FactorView(version=0, W=W, H=H)
    np.testing.assert_array_equal(plain.user_rows([2, 0]), [2, 0])
    with pytest.raises(KeyError):
        plain.user_rows([3])
    with pytest.raises(ValueError, match="shape"):
        FactorView(version=0, W=W, H=H, user_ids=np.array([1, 2]))
    with pytest.raises(ValueError, match="duplicate"):
        FactorView(version=0, W=W, H=H, user_ids=np.array([1, 1, 2]))


def test_hot_swap_atomicity_under_concurrent_publisher():
    """Version v publishes constant factors scoring k * (v+1) for every
    pair, so one torn element would betray itself."""
    k, m, n = 4, 8, 16
    store = FactorStore(CPU)
    store.publish(*_wh(m, n, fill=1.0))
    server = RecServer(store, ServeConfig(top_k=3, max_batch=8,
                                          max_wait_ms=0.5))
    stop = threading.Event()
    failures = []

    def publisher():
        v = 1
        while not stop.is_set():
            store.publish(np.full((m, k), 1.0, np.float32),
                          np.full((n, k), float(v + 1), np.float32))
            v += 1
            time.sleep(0.001)

    def client(cseed):
        rng = np.random.default_rng(cseed)
        for _ in range(40):
            rec = server.recommend(rng.integers(0, m, 2))
            if not np.all(rec.scores == k * (rec.version + 1.0)):
                failures.append((rec.version, rec.scores.copy()))

    pub = threading.Thread(target=publisher, daemon=True)
    with server:
        pub.start()
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in clients:
            t.start()
        for t in clients:
            t.join()
        stop.set()
        pub.join()
    assert not failures, f"mixed-version responses: {failures[:3]}"
    assert store.version > 0


def test_publish_refuses_non_finite_factors():
    rng = np.random.default_rng(0)
    W = rng.normal(size=(10, 3)).astype(np.float32)
    H = rng.normal(size=(6, 3)).astype(np.float32)
    Wbad, Hbad = W.copy(), H.copy()
    Wbad[2, 1] = np.nan
    Hbad[0, 0] = np.inf
    store = FactorStore(CPU)
    with pytest.raises(ValueError, match="non-finite W"):
        store.publish(Wbad, H)
    with pytest.raises(ValueError, match="non-finite H"):
        store.publish(torch.from_numpy(W), torch.from_numpy(Hbad))
    with pytest.raises(ValueError, match="non-finite W"):
        store.publish(np.asarray(jnp.asarray(Wbad, jnp.bfloat16)), H)
    assert store.version is None
    store.publish(W, H)
    with pytest.raises(ValueError):
        store.publish(Wbad, H, quantize="int8")   # caught pre-quantize
    assert store.version == 0


def test_quantize_int8_equals_reference_bitwise():
    rng = np.random.default_rng(5)
    A = (rng.normal(size=(40, 7)) * 3).astype(np.float32)
    A[3] = 0.0
    q, s = tserve.quantize_int8(A)
    rq, rs = rserve.quantize_int8(A)
    tol.assert_bitwise(q, rq, "q")
    tol.assert_bitwise(s, rs, "scale")
    # bf16 input: the port's tensor and the reference's bf16 array
    tq, ts = tserve.quantize_int8(torch.from_numpy(A).bfloat16())
    rq, rs = rserve.quantize_int8(jnp.asarray(A, jnp.bfloat16))
    tol.assert_bitwise(tq, rq, "bf16 q")
    tol.assert_bitwise(ts, rs, "bf16 scale")


def test_quantized_view_scores_equal_reference():
    """The reference's int8 view, carried into the port with
    ``convert.serving_factors``, scores bitwise as the reference scores
    it.  Each user row has absmax 127 * 2^e, so its scale is 2^e and its
    dequantized values are integers times 2^e: every dot against the int8
    catalog is exact, and the item scale rounds once after it."""
    rng = np.random.default_rng(3)
    m, n, k = 10, 33, 5
    W = rng.integers(-126, 127, (m, k)).astype(np.float32)
    W[:, 0] = 127.0
    W *= 2.0 ** rng.integers(-2, 3, (m, 1)).astype(np.float32)
    H = rng.normal(size=(n, k)).astype(np.float32)
    rview = rserve.FactorStore().publish(W, H, quantize="int8")
    fields = serving_factors(*(np.asarray(x) for x in (
        rview.W, rview.H)), w_scale=np.asarray(rview.w_scale),
        h_scale=np.asarray(rview.h_scale), device=CPU)
    view = FactorView(version=0, **fields)
    assert view.quantized and view.H.dtype == torch.int8
    store = FactorStore(CPU)
    own = store.publish(W, H, quantize="int8")
    for x, y in ((own.W, view.W), (own.H, view.H), (own.w_scale,
                                                    view.w_scale)):
        assert torch.equal(x, y)
    rec = RecServer(store, ServeConfig(top_k=4, item_tile=8)).score(
        np.arange(m))
    rrec = rserve.RecServer(rserve.FactorStore(), rserve.ServeConfig(
        top_k=4, item_tile=8, kernel="xla")).score(np.arange(m),
                                                   view=rview)
    np.testing.assert_array_equal(rec.items, rrec.items)
    np.testing.assert_array_equal(rec.scores, rrec.scores)
    Wdq = (view.W.float() * view.w_scale[:, None])
    es, ei = tserve.topk_dense_oracle(Wdq, view.H, 4, h_scale=view.h_scale)
    np.testing.assert_array_equal(rec.items, ei)
    tol.assert_bitwise(rec.scores, es, "int8 scores vs own oracle")


def test_publish_result_stores_in_policy_dtype():
    rng = np.random.default_rng(1)
    W = rng.integers(-2, 3, (6, 4)).astype(np.float32)
    H = rng.integers(-2, 3, (5, 4)).astype(np.float32)
    res = tapi.FitResult(W=W, H=H, trace_epochs=np.zeros(0),
                         trace_rmse=np.zeros(0), epochs_done=0,
                         config=tapi.NomadConfig(k=4, dtype_policy="bf16"))
    view = FactorStore.from_fit_result(res, CPU).view()
    assert view.W.dtype == torch.bfloat16
    tol.assert_bitwise(view.W.float().numpy(), W, "bf16 carrier")


# --------------------------------------------------------------------- #
# RecServer                                                              #
# --------------------------------------------------------------------- #

def _rand_store(m=20, n=12, k=4, seed=0):
    rng = np.random.default_rng(seed)
    store = FactorStore(CPU)
    store.publish(rng.normal(size=(m, k)).astype(np.float32),
                  rng.normal(size=(n, k)).astype(np.float32))
    return store


def test_server_answers_match_sync_score():
    store = _rand_store()
    server = RecServer(store, ServeConfig(top_k=5, max_batch=8,
                                          max_wait_ms=1.0, item_tile=4))
    with server:
        futs = [server.submit([u, (u + 3) % 20]) for u in range(10)]
        recs = [f.result(timeout=30) for f in futs]
    oracle = server.score(np.arange(20))
    view = store.view()
    es, ei = tserve.topk_dense_oracle(view.W, view.H, 5)
    np.testing.assert_array_equal(oracle.items, ei)
    tol.assert_bitwise(oracle.scores, es, "score vs own dense oracle")
    for u0, rec in enumerate(recs):
        assert rec.version == 0
        for j, u in enumerate([u0, (u0 + 3) % 20]):
            np.testing.assert_array_equal(rec.items[j], oracle.items[u])
            np.testing.assert_array_equal(rec.scores[j], oracle.scores[u])
    assert server.n_queries == 20 and server.n_batches <= 10


def test_server_request_validation():
    store = _rand_store()
    server = RecServer(store, ServeConfig(top_k=3, max_batch=4))
    with pytest.raises(RuntimeError, match="not started"):
        server.submit([1])
    with server:
        with pytest.raises(ValueError, match="empty"):
            server.submit([])
        with pytest.raises(ValueError, match="max_batch"):
            server.submit([0, 1, 2, 3, 4])
        assert server.submit([0, 19]).result(timeout=30).items.shape == (2,
                                                                          3)
        with pytest.raises(KeyError):
            server.recommend([99], timeout=30)
        assert server.recommend([0], timeout=30).version == 0
    with pytest.raises(RuntimeError, match="already started"):
        with server:
            server.start()
    with pytest.raises(TypeError, match="FactorStore"):
        RecServer(object())


def test_server_topk_clamped_to_catalog_and_config_validates():
    with RecServer(_rand_store(n=3), ServeConfig(top_k=10)) as server:
        assert server.recommend([0]).items.shape == (1, 3)
    for bad in (dict(top_k=0), dict(max_batch=0), dict(max_wait_ms=-1),
                dict(item_tile=0), dict(timeout_ms=0)):
        with pytest.raises(ValueError):
            ServeConfig(**bad)
    assert isinstance(ServeConfig(kernel="wave").kernel, KernelPolicy)


def test_expired_request_is_shed_with_typed_error():
    store = _rand_store()
    srv = RecServer(store, ServeConfig(top_k=3, timeout_ms=0.001,
                                       max_wait_ms=0.0))
    with srv:
        time.sleep(0.01)
        fut = srv.submit([1, 2])
        with pytest.raises(ServeTimeout):
            fut.result(timeout=5)
        assert srv.n_shed == 2
        assert srv.n_queries == 0 and srv.n_batches == 0
    srv2 = RecServer(store, ServeConfig(top_k=3, timeout_ms=60_000.0))
    with srv2:
        assert srv2.recommend([0, 1], timeout=30).items.shape == (2, 3)
        assert srv2.n_shed == 0


def test_server_filter_rated_matches_reference():
    rng = np.random.default_rng(9)
    m, n, k = 30, 50, 6
    W = rng.integers(-2, 3, (m, k)).astype(np.float32)
    H = rng.integers(-2, 3, (n, k)).astype(np.float32)
    rated = (rng.integers(0, m, 300), rng.integers(0, n, 300))
    store = FactorStore(CPU)
    view = store.publish(W, H, rated=rated)
    rview = rserve.FactorStore().publish(W, H, rated=rated)
    tol.assert_bitwise(view.rated_indptr, rview.rated_indptr, "indptr")
    tol.assert_bitwise(view.rated_items, rview.rated_items, "items")
    users = [0, 7, 19]
    rec = RecServer(store, ServeConfig(top_k=5, filter_rated=True,
                                       item_tile=16)).score(users)
    rrec = rserve.RecServer(rserve.FactorStore(), rserve.ServeConfig(
        top_k=5, filter_rated=True, item_tile=16, kernel="xla")).score(
            users, view=rview)
    np.testing.assert_array_equal(rec.items, rrec.items)
    np.testing.assert_array_equal(rec.scores, rrec.scores)
    for j, u in enumerate(users):
        assert not set(rec.items[j].tolist()) & set(
            view.rated_for([u])[0].tolist())
    with pytest.raises(ValueError, match="rated"):
        FactorView(W=view.W, H=view.H, version=1,
                   rated_indptr=np.array([0, 1]), rated_items=None)


def test_attach_subscribes_publish_result():
    class Session:
        def subscribe(self, cb):
            self.cb = cb
            return cb

    sess, store = Session(), FactorStore(CPU)
    cb = store.attach(sess)
    W, H = _wh(5, 4)
    cb(tapi.FitResult(W=W, H=H, trace_epochs=np.zeros(0),
                      trace_rmse=np.zeros(0), epochs_done=1))
    assert store.version == 0 and torch.equal(store.view().H,
                                              torch.from_numpy(H))


# --------------------------------------------------------------------- #
# the slice as a whole                                                   #
# --------------------------------------------------------------------- #

def test_serve_mc_demo_then_checkpoint_boot(tmp_path, capsys):
    d = str(tmp_path / "demo")
    server = serve_mc.main(["--demo", "--smoke", "--device", CPU,
                            "--ckpt-dir", d, "--top-k", "5"])
    assert server.n_queries == 201 and server.n_batches >= 1
    booted = serve_mc.main(["--smoke", "--device", CPU, "--ckpt-dir", d,
                            "--top-k", "5"])
    out = capsys.readouterr().out
    assert "booted from" in out and "step 1" in out
    assert "scorer xla on cpu" in out and booted.n_queries == 201
    view = booted.store.view()
    rec = booted.score(np.arange(view.m))
    es, ei = tserve.topk_dense_oracle(view.W, view.H, 5)
    np.testing.assert_array_equal(rec.items, ei)
    with pytest.raises(SystemExit):
        serve_mc.main(["--demo", "--smoke", "--device", CPU,
                       "--hot-swap", "2"])


@pytest.mark.parametrize("saver", ["reference", "port"])
def test_serving_path_ids_match_reference(tmp_path, saver):
    """Injected integer factors, checkpointed by either package, boot
    both servers; every user's recommendations agree exactly."""
    rng = np.random.default_rng(11)
    m, n, k = 40, 30, 4
    W = rng.integers(-2, 3, (m, k)).astype(np.float32)
    H = rng.integers(-2, 3, (n, k)).astype(np.float32)
    H[rng.integers(0, n, 10)] = H[rng.integers(0, n, 10)]   # ties
    common = dict(W=W, H=H, trace_epochs=np.arange(1, 3),
                  trace_rmse=np.array([0.5, 0.4]), epochs_done=2)
    d = str(tmp_path)
    if saver == "reference":
        rsave_fit_result(d, 2, rapi.FitResult(
            config=rapi.NomadConfig(k=k, p=2), **common))
    else:
        tsave_fit_result(d, 2, tapi.FitResult(
            config=tapi.NomadConfig(k=k, p=2), **common))
    users = np.arange(m)
    port = RecServer.from_checkpoint(d, ServeConfig(top_k=6, item_tile=8),
                                     device=CPU)
    ref = rserve.RecServer.from_checkpoint(d, rserve.ServeConfig(
        top_k=6, item_tile=8, kernel="xla"))
    with port, ref:
        got = [port.recommend(users[i:i + 4]) for i in range(0, m, 4)]
        want = [ref.recommend(users[i:i + 4]) for i in range(0, m, 4)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.items, b.items)
        np.testing.assert_array_equal(a.scores, b.scores)
        assert a.version == b.version == 0
    assert port.store.boot_step == 2


# --------------------------------------------------------------------- #
# on the card                                                           #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
def test_kernel_matches_plain_on_card(requires_cuda, storage):
    # besides small catalogs: stripes of several chunks, so flushes meet
    # a full list, short (20 keys, in registers) and long (50, 700);
    # k_top above a stripe's items (300 and 257 in stripes of one chunk);
    # ranks that are not a multiple of 4 (the scoring loop's scalar tail)
    for seed, users, items, k_rank, k_top in (
            (0, 1, 700, 16, 10), (1, 9, 1300, 16, 300),
            (2, 33, 600, 16, 600), (3, 5, 200_000, 7, 50),
            (4, 40, 300_000, 10, 700), (5, 2, 5000, 3, 257),
            (6, 3, 150_000, 5, 20)):
        W_u, H, hs = _case(seed, users, items, k_rank, storage)
        args = [None if x is None else x.to(requires_cuda)
                for x in _port_inputs(W_u, H, hs, storage)]
        p = tk.device_plan(args[0], args[1], k_top)
        assert p.stripes > 1
        tk.reset_launches()
        s, i = tk.topk_scores_cuda(*args, k_top=k_top)
        torch.cuda.synchronize()
        assert tk.topk_scores_cuda.launches == 1
        ps, pi = tk.topk_plain(*args, k_top=k_top)
        assert torch.equal(i, pi) and torch.equal(s, ps)
