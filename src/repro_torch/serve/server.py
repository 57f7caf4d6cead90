"""Recommendation request front end: microbatching queue over the
device-resident top-k scorer.

One worker thread drains a queue of per-request user-id lists into
microbatches (up to ``max_batch`` users, or whatever arrived within
``max_wait_ms`` of the first request — the classic latency/throughput
knob), grabs **one** :class:`~repro_torch.serve.store.FactorView` for
the whole batch (a batch is entirely version v), pads the user rows to a
power-of-two bucket (as the JAX package does to bound its re-traces; here
it bounds the shapes the scorer sees), and answers every request with
its slice of the batched top-k plus the version stamp it was scored
under.

    store = FactorStore.from_checkpoint("/ckpts/run1")
    server = RecServer(store, ServeConfig(top_k=10))
    with server:                       # start()/stop()
        rec = server.recommend([42, 7])    # blocking
        fut = server.submit([13])          # Future[Recommendation]

``RecServer.score(users)`` is the synchronous path (no queue, same
scorer) for tests/benchmarks that want the kernel without the threads.
With the default ``ServeConfig(kernel="auto")`` and a store on CUDA, the
scorer is the CUDA top-k kernel.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..kernels.policy import KernelPolicy
from .store import FactorStore, FactorView
from .topk import to_host, topk_scores, topk_scores_filtered

__all__ = ["ServeConfig", "ServeTimeout", "Recommendation", "RecServer"]


class ServeTimeout(TimeoutError):
    """A queued request's deadline (``ServeConfig.timeout_ms``) expired
    before its microbatch was scored; the request was shed instead of
    being served arbitrarily stale."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-tier knobs (frozen; validated at construction, like the
    solver configs).

    top_k        -- recommendation list length per user
    max_batch    -- microbatch user cap
    max_wait_ms  -- how long the worker holds the first request of a
                    batch open for stragglers (0 = score immediately)
    item_tile    -- catalog tile width the scorer streams over
    kernel       -- KernelPolicy / legacy impl string; ``serve_impl``
                    selects the plain scan or the CUDA top-k kernel
                    (``"auto"``: the kernel when the store is on CUDA)
    filter_rated -- exclude each user's already-rated items (the
                    published version's ``rated_indptr`` CSR map) from
                    the results, exactly; users with no map entry are
                    unfiltered.  Lists short of ``top_k`` admissible
                    items pad with item id -1 / -inf score.
    timeout_ms   -- request deadline: a queued request older than this
                    when its microbatch is assembled is shed with a
                    typed :class:`ServeTimeout` instead of being served
                    late (fail-fast under overload; ``None`` = wait
                    forever, the pre-deadline behavior)
    """
    top_k: int = 10
    max_batch: int = 64
    max_wait_ms: float = 2.0
    item_tile: int = 4096
    kernel: Union[str, KernelPolicy] = "auto"
    filter_rated: bool = False
    timeout_ms: Optional[float] = None

    def __post_init__(self):
        if self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if self.max_batch < 1:
            raise ValueError(
                f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_wait_ms < 0:
            raise ValueError(
                f"max_wait_ms must be >= 0, got {self.max_wait_ms}")
        if self.timeout_ms is not None and self.timeout_ms <= 0:
            raise ValueError(
                f"timeout_ms must be > 0 (or None), got "
                f"{self.timeout_ms}")
        if self.item_tile < 1:
            raise ValueError(
                f"item_tile must be >= 1, got {self.item_tile}")
        object.__setattr__(self, "kernel", KernelPolicy.coerce(self.kernel))


@dataclasses.dataclass(frozen=True)
class Recommendation:
    """One request's answer: per-user top-k item ids and scores, plus
    the factor version the whole request was scored under."""
    users: np.ndarray                   # (B,) the request's user ids
    items: np.ndarray                   # (B, top_k) external item ids
    scores: np.ndarray                  # (B, top_k) descending (bf16
                                        # scores as their fp32 carrier)
    version: int


class RecServer:
    """Microbatching recommendation server over a :class:`FactorStore`.

    Thread layout: callers enqueue; one worker thread batches, scores,
    and resolves futures.  Factor hot-swap happens on the publisher's
    thread (``store.publish``) and is picked up at the next microbatch —
    queries never block on training.
    """

    def __init__(self, store: FactorStore,
                 config: Optional[ServeConfig] = None):
        if not isinstance(store, FactorStore):
            raise TypeError(f"store must be FactorStore, got "
                            f"{type(store).__name__}")
        self.store = store
        self.config = config or ServeConfig()
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = object()           # queue sentinel
        self.n_queries = 0              # users answered (worker thread)
        self.n_batches = 0              # microbatches scored
        self.n_shed = 0                 # users shed past their deadline

    # ----------------------------------------------------------------- #
    # Synchronous scoring (shared by the worker loop)                    #
    # ----------------------------------------------------------------- #

    def score(self, users: Sequence[int],
              view: Optional[FactorView] = None) -> Recommendation:
        """Score ``users`` against one consistent factor version (the
        current one unless ``view`` is pinned).  Synchronous — no queue,
        no batching window."""
        cfg = self.config
        view = view or self.store.view()
        users = np.atleast_1d(np.asarray(users, dtype=np.int64))
        rows = view.user_rows(users)
        B = len(rows)
        # pad to the next power-of-two bucket: O(log max_batch) scorer
        # shapes across arbitrary batch compositions
        bucket = 1
        while bucket < B:
            bucket *= 2
        rows_p = np.pad(rows, (0, bucket - B))      # row 0 repeats: dropped
        idx = torch.from_numpy(rows_p).to(view.W.device)
        W_u = view.W.index_select(0, idx)
        h_scale = None
        if view.quantized:
            # dequantize the gathered user rows (B x k — cheap); H stays
            # int8 on device, its scale is applied per score in-kernel
            W_u = (W_u.float()
                   * view.w_scale.index_select(0, idx)[:, None])
            h_scale = view.h_scale
        k_top = min(cfg.top_k, view.n)
        if cfg.filter_rated and view.rated_indptr is not None:
            scores, item_rows = topk_scores_filtered(
                W_u, view.H, k_top, exclude=view.rated_for(rows_p),
                policy=cfg.kernel, item_tile=cfg.item_tile,
                h_scale=h_scale)
        else:
            scores, item_rows = topk_scores(W_u, view.H, k_top,
                                            policy=cfg.kernel,
                                            item_tile=cfg.item_tile,
                                            h_scale=h_scale)
        if isinstance(scores, torch.Tensor):
            scores, item_rows = to_host(scores), to_host(item_rows)
        scores = scores[:B]
        item_rows = item_rows[:B]
        # the filtered path pads exhausted rows with the sentinel n —
        # surface those as external id -1 rather than indexing the
        # catalog out of bounds
        sent = item_rows >= view.n
        items = np.where(sent, -1,
                         view.item_catalog(np.where(sent, 0, item_rows)))
        return Recommendation(users=users, items=items, scores=scores,
                              version=view.version)

    # ----------------------------------------------------------------- #
    # Asynchronous front end                                             #
    # ----------------------------------------------------------------- #

    def submit(self, users: Sequence[int]) -> "Future[Recommendation]":
        """Enqueue one request (one or more user ids); resolves to a
        :class:`Recommendation` scored under a single factor version."""
        if self._thread is None:
            raise RuntimeError("server not started; call start() or use "
                               "the context manager")
        users = np.atleast_1d(np.asarray(users, dtype=np.int64))
        if len(users) == 0:
            raise ValueError("empty request")
        if len(users) > self.config.max_batch:
            raise ValueError(
                f"request has {len(users)} users > max_batch="
                f"{self.config.max_batch}")
        fut: "Future[Recommendation]" = Future()
        self._queue.put((users, fut, time.perf_counter()))
        return fut

    def recommend(self, users: Sequence[int],
                  timeout: Optional[float] = None) -> Recommendation:
        """Blocking :meth:`submit`."""
        return self.submit(users).result(timeout=timeout)

    def start(self) -> "RecServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self.store.view()               # fail fast with no factors
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._thread is None:
            return
        self._queue.put(self._stop)
        self._thread.join()
        self._thread = None

    def __enter__(self) -> "RecServer":
        if self._thread is None:
            self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # ----------------------------------------------------------------- #
    # Worker loop                                                        #
    # ----------------------------------------------------------------- #

    def _drain_batch(self) -> Optional[List]:
        """Block for the first request, then collect follow-ups until
        the batch is full or ``max_wait_ms`` has passed."""
        first = self._queue.get()
        if first is self._stop:
            return None
        batch, users = [first], len(first[0])
        deadline = time.perf_counter() + self.config.max_wait_ms / 1e3
        while users < self.config.max_batch:
            wait = deadline - time.perf_counter()
            try:
                nxt = (self._queue.get(timeout=wait) if wait > 0
                       else self._queue.get_nowait())
            except queue.Empty:
                break
            if nxt is self._stop:
                self._queue.put(self._stop)     # re-arm for shutdown
                break
            if users + len(nxt[0]) > self.config.max_batch:
                self._queue.put(nxt)            # doesn't fit; next batch
                break
            batch.append(nxt)
            users += len(nxt[0])
        return batch

    def _shed_expired(self, batch: List) -> List:
        """Fail requests whose deadline passed while they queued — once
        shed here they never occupy scorer time (the fail-fast half of
        the latency contract)."""
        ttl = self.config.timeout_ms
        if ttl is None:
            return batch
        now, live = time.perf_counter(), []
        for req in batch:
            users, fut, t_in = req
            waited_ms = (now - t_in) * 1e3
            if waited_ms > ttl:
                self.n_shed += len(users)
                fut.set_exception(ServeTimeout(
                    f"request waited {waited_ms:.1f} ms in queue > "
                    f"timeout_ms={ttl}"))
            else:
                live.append(req)
        return live

    def _worker(self):
        while True:
            batch = self._drain_batch()
            if batch is None:
                return
            batch = self._shed_expired(batch)
            if not batch:
                continue
            view = self.store.view()    # ONE version for the whole batch
            users = np.concatenate([u for u, _, _ in batch])
            try:
                rec = self.score(users, view=view)
            except Exception as e:      # noqa: BLE001 — fail the futures
                for _, fut, _ in batch:
                    fut.set_exception(e)
                continue
            self.n_batches += 1
            self.n_queries += len(users)
            off = 0
            for u, fut, _ in batch:
                sl = slice(off, off + len(u))
                fut.set_result(Recommendation(
                    users=rec.users[sl], items=rec.items[sl],
                    scores=rec.scores[sl], version=rec.version))
                off += len(u)

    # ----------------------------------------------------------------- #
    # Boot                                                               #
    # ----------------------------------------------------------------- #

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str,
                        config: Optional[ServeConfig] = None,
                        step: Optional[int] = None,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> "RecServer":
        """Boot a server from the newest verified committed
        ``save_fit_result`` checkpoint (torn in-flight dirs skipped),
        with its store on ``device`` (``None`` = ``"cuda"``)."""
        return cls(FactorStore.from_checkpoint(ckpt_dir, step, device),
                   config)
