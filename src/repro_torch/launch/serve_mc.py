"""Matrix-completion serving CLI: checkpoint -> live top-k server.

Boots a :class:`repro_torch.serve.RecServer` from the newest verified
*committed* ``save_fit_result`` checkpoint (or trains a demo problem
first), then drives a client load against it and reports queries/s with
p50/p99 latency.  Runs on the card (``--device`` defaults to ``cuda``);
``--impl auto`` (the default) scores with the CUDA top-k kernel there.

    python -m repro_torch.launch.serve_mc --demo --smoke
    python -m repro_torch.launch.serve_mc --ckpt-dir ckpt --queries 2000

``--hot-swap`` needs the port's ``StreamingSession``, which is not
ported yet (ROADMAP.md Queue 1 item 6): it exits with an error saying
so.
"""
from __future__ import annotations

import argparse
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np


def run_load(server, user_pool: int, n_queries: int, *, clients: int = 4,
             users_per_query: int = 1, seed: int = 0,
             ) -> Tuple[float, float, float]:
    """Drive ``n_queries`` requests from ``clients`` threads; returns
    ``(queries_per_s, p50_ms, p99_ms)`` measured submit -> result."""
    rng = np.random.default_rng(seed)
    requests = rng.integers(0, user_pool, (n_queries, users_per_query))
    lat = np.zeros(n_queries)

    def one(i):
        t0 = time.perf_counter()
        server.recommend(requests[i])
        lat[i] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=clients) as pool:
        list(pool.map(one, range(n_queries)))
    dt = time.perf_counter() - t0
    return n_queries / dt, float(np.percentile(lat, 50) * 1e3), \
        float(np.percentile(lat, 99) * 1e3)


def _train_demo(args) -> Tuple[object, object]:
    """Train a small problem (and checkpoint it) so the server has
    something to boot from; returns (problem, result)."""
    from .. import api
    from ..checkpoint import save_fit_result
    from ..core.stepsize import PowerSchedule

    problem = api.MCProblem.synthetic(args.m, args.n, args.nnz, k=args.k,
                                      seed=0, noise=0.05, test_frac=0.1)
    config = api.NomadConfig(
        k=args.k, p=args.p, lam=0.05, epochs=args.epochs, seed=0,
        kernel=args.impl,
        stepsize=PowerSchedule(alpha=0.08, beta=0.05))
    t0 = time.perf_counter()
    result = api.solve(problem, config, device=args.device)
    print(f"trained m={args.m} n={args.n} nnz={problem.nnz} for "
          f"{args.epochs} epochs in {time.perf_counter() - t0:.1f}s "
          f"(rmse {result.rmse[-1]:.4f})")
    if args.ckpt_dir:
        save_fit_result(args.ckpt_dir, int(result.epochs_done), result)
        print(f"checkpointed to {args.ckpt_dir}")
    return problem, result


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Serve matrix-completion top-k recommendations")
    ap.add_argument("--ckpt-dir", default="",
                    help="boot from the newest committed checkpoint here")
    ap.add_argument("--demo", action="store_true",
                    help="train a synthetic problem first (checkpointed "
                         "to --ckpt-dir when set)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes + query count (CI)")
    ap.add_argument("--m", type=int, default=20_000)
    ap.add_argument("--n", type=int, default=4_000)
    ap.add_argument("--nnz", type=int, default=200_000)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--p", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--impl", default="auto",
                    choices=["auto", "xla", "pallas", "wave",
                             "wave_pallas"],
                    help="kernel policy; its serve_impl picks the plain "
                         "scan or the CUDA top-k kernel (auto: the "
                         "kernel on CUDA)")
    ap.add_argument("--device", default=None,
                    help="where training and serving run (default: "
                         "cuda; cpu runs the plain versions)")
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--item-tile", type=int, default=4096)
    ap.add_argument("--queries", type=int, default=2000)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--hot-swap", type=int, default=0, metavar="ROUNDS",
                    help="concurrent partial_fit rounds while serving "
                         "(not ported yet)")
    return ap


def main(argv: Optional[Sequence[str]] = None):
    """Run the CLI on ``argv`` (default: the process arguments); returns
    the stopped server, whose counters the caller may read."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.smoke:
        args.m, args.n, args.nnz = 600, 150, 6_000
        args.epochs, args.queries = 1, 200
    if not args.demo and not args.ckpt_dir:
        ap.error("pass --ckpt-dir (boot) and/or --demo (train first)")
    if args.hot_swap:
        ap.error("--hot-swap needs StreamingSession, which is not ported "
                 "yet: ROADMAP.md Queue 1 item 6 [stream/elastic/integrity]")

    from ..serve import FactorStore, RecServer, ServeConfig

    if args.demo:
        _, result = _train_demo(args)
        store = FactorStore.from_fit_result(result, args.device)
    else:
        store = FactorStore.from_checkpoint(args.ckpt_dir,
                                            device=args.device)
        print(f"booted from {args.ckpt_dir} step {store.boot_step} "
              f"(m={store.view().m}, n={store.view().n})")

    cfg = ServeConfig(top_k=args.top_k, max_batch=args.max_batch,
                      max_wait_ms=args.max_wait_ms,
                      item_tile=args.item_tile, kernel=args.impl)
    server = RecServer(store, cfg)
    with server:
        server.recommend([0])           # build the kernel, warm the caches
        qps, p50, p99 = run_load(server, store.view().m, args.queries,
                                 clients=args.clients)
    print(f"{args.queries} queries (top-{cfg.top_k}, "
          f"{server.n_batches} microbatches, 0 hot-swaps, "
          f"scorer {cfg.kernel.serve_impl(store.device)} on "
          f"{store.device}): {qps:.0f} q/s, p50 {p50:.2f} ms, "
          f"p99 {p99:.2f} ms")
    return server


if __name__ == "__main__":
    main()
