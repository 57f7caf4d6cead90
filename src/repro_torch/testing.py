"""Comparison helpers for the port's checks (its tests and
``chip_smoke.py``).

:func:`low_precision_tolerance` bounds two low-precision results that
both compute in fp32 and round once: the fp32 bound plus units in the
last place of the type.  :func:`flash_p_rounding_tolerance` adds what the
tensor-core flash kernel's one more rounding (of the probabilities,
before ``P V``) can cost.

The rest compares two implementations of the block-SGD update that both
compute in fp32 over the same low-precision factor storage.

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

import math

import torch

#: most elements the update changed on which the two may differ: their
#: share, and a count for tiny tensors (one flip and its echo)
FLIP_SHARE = 2.0 ** -10
FLIP_SLACK = 2

#: significand bits (the implicit one included) of the types :func:`ulp`
#: takes
_MANTISSA = {torch.bfloat16: 8, torch.float16: 11, torch.float32: 24}


def ulp(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The unit in the last place of ``dtype`` at each value of ``x``, in
    float64 (at 0 and below the normal range: at ``dtype``'s smallest
    normal)."""
    _, e = torch.frexp(x.double())
    e = torch.clamp(e, min=math.frexp(torch.finfo(dtype).tiny)[1])
    return torch.ldexp(torch.ones_like(e, dtype=torch.float64),
                       e - _MANTISSA[dtype])


def low_precision_tolerance(want: torch.Tensor, dtype: torch.dtype,
                            n_ulps: float = 2.0,
                            fp32_rel: float = 2e-5) -> torch.Tensor:
    """Per-element bound of two results that compute in fp32 and round
    once to ``dtype``: their fp32 values may differ by ``fp32_rel`` of
    ``1 + |want|`` (sums in another order, cancellation included), and
    rounding adds up to ``n_ulps`` units in the last place of ``dtype``
    at ``want``."""
    w = want.double()
    return n_ulps * ulp(w, dtype) + fp32_rel * (1 + w.abs())


#: machine epsilon (twice the unit roundoff) of the types the flash
#: kernel rounds its probabilities to
P_EPS = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


def flash_p_rounding_tolerance(want: torch.Tensor, abs_v_out: torch.Tensor,
                               dtype: torch.dtype) -> torch.Tensor:
    """Per-element bound of the bf16/fp16 flash kernel against its plain
    version ``want``:

        |got - want| <= 2e-5 (1 + |want|) + 2 ulps_T(want)
                        + eps_T * plain(q, k, |v|)

    where ``abs_v_out`` is ``plain(q, k, |v|)``, the plain version on the
    same q, k and ``v.abs()`` (computed in fp32), and ``eps_T``
    (:data:`P_EPS`) is ``dtype``'s machine epsilon.

    Derivation.  Per row, both compute ``o = sum_j p_j v_j / l`` with
    ``p_j = exp(s_j - m)`` and ``l = sum_j p_j`` in fp32.  The plain
    version keeps ``p_j`` in fp32; the kernel rounds each ``p_j`` once to
    ``dtype`` before the product with V (``l`` still sums the fp32
    values).  Rounding to nearest moves ``p_j`` by at most the unit
    roundoff ``u_T = eps_T / 2`` of it, so the output moves by at most
    ``u_T * sum_j p_j |v_j| / l``, which is ``u_T * plain(q, k, |v|)``
    exactly (the rescaling of the online softmax multiplies ``p_j`` and
    its error alike).  The rest is :func:`low_precision_tolerance`: the
    fp32 sums in another order, and each side rounding its output once.
    ``eps_T`` is twice ``u_T``, kept as margin.  Not covered: a ``p_j``
    below the type's normal range (``2^-14`` in fp16), whose rounding
    error is up to half the smallest subnormal (``2^-25``) rather than
    relative; it needs scores that differ by more than ``14 ln 2`` and
    then weighs ``2^-25`` per key.
    """
    return (low_precision_tolerance(want, dtype)
            + P_EPS[dtype] * abs_v_out.double())


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


def factor_digest(W, H) -> str:
    """sha256 of the factors' bytes, W then H, its first 16 hex digits:
    equal digests show two results bitwise equal."""
    import hashlib
    import numpy as np
    h = hashlib.sha256(np.ascontiguousarray(W).tobytes())
    h.update(np.ascontiguousarray(H).tobytes())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------- #
# Rank bodies for ``launch.mesh.spawn_ranks`` (importable by name: spawn   #
# pickles functions by reference), shared by the SPMD tests and           #
# ``chip_smoke.py``                                                        #
# ---------------------------------------------------------------------- #

def _rss_kb() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    return 0


class HostPeak:
    """Peak resident memory of this process from construction on, the
    largest of samples taken every 20 ms (the kernel's high-water marks,
    ``VmHWM`` and ``ru_maxrss``, cover the whole process, are carried
    across ``exec`` and cannot always be reset)."""

    def __init__(self):
        import threading
        self.peak_kb = _rss_kb()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()

    def _sample(self):
        while not self._stop.wait(0.02):
            self.peak_kb = max(self.peak_kb, _rss_kb())

    def gb(self) -> str:
        return f"{max(self.peak_kb, _rss_kb()) * 1024 / 1e9:.2f}"

    def close(self) -> None:
        self._stop.set()
        self._thread.join()


def _load(x):
    """An array, or the ``.npy`` file that holds it (mapped read-only)."""
    import numpy as np
    return np.load(x, mmap_mode="r") if isinstance(x, str) else x


def run_on_mesh(rank: int, p: int, runs, device=None) -> dict:
    """Rank body: each of ``runs`` on this rank's mesh
    (``make_mc_mesh(p, device=run.get("device", device))``), in order.
    A run is a dict with ``kind``:

    * ``"engine"``: ``NomadRingEngine(br, k, lam, stepsize, policy,
      mesh=)`` (``br`` a packing or a :func:`~repro_torch.core.partition.
      save_pack` directory), ``init_factors(W0, H0)`` (arrays or ``.npy``
      paths), ``train(epochs, test, dispatch=, record_every=)``; with
      ``log_steps`` the engine's per-step records come back;
    * ``"solve"``: ``api.solve(problem, config, mesh=)``;
    * ``"errors"``: the messages of ``make_mc_mesh(p + 1)`` and of an
      engine built on ``br`` (a packing for another ``p``).

    Returns, for run ``i``: ``digest{i}``, ``trace{i}``, ``finite{i}``,
    the wave kernel wrappers' launches (``launches{i}``) and the plain
    version's calls (``plain{i}``), the train and factors seconds, and
    ``W{i}``/``H{i}`` unless ``return_factors`` is False; and the mesh's
    transport, ``ready_at`` (``time.time()`` once the first mesh was
    made), the card's peak bytes and the process's peak RSS
    (:class:`HostPeak`)."""
    import time

    import numpy as np
    import torch

    from . import api
    from .core import partition as part
    from .core.nomad import NomadRingEngine
    from .kernels import nomad_sgd as ks
    from .launch.mesh import make_mc_mesh

    meshes, out = {}, {}
    peak = HostPeak()

    def mesh_for(dev):
        key = str(dev)
        if key not in meshes:
            meshes[key] = make_mc_mesh(p, device=dev)
            out.setdefault("ready_at", time.time())
            out.setdefault("transport", meshes[key].describe())
        return meshes[key]

    plain, calls = ks.block_sgd_waves_csr, [0]

    def counted(*a, **kw):
        calls[0] += 1
        return plain(*a, **kw)

    ks.block_sgd_waves_csr = counted
    try:
        for i, run in enumerate(runs):
            mesh = mesh_for(run.get("device", device))
            if run["kind"] == "errors":
                msgs = []
                try:
                    make_mc_mesh(p + 1, device=mesh.device)
                except ValueError as e:
                    msgs.append(str(e))
                try:
                    NomadRingEngine(br=run["br"], k=2, lam=0.0,
                                    stepsize=lambda e: 0.0, mesh=mesh)
                except ValueError as e:
                    msgs.append(str(e))
                out[f"errors{i}"] = msgs
                continue
            ks.reset_launches()
            calls[0] = 0
            t0 = time.perf_counter()
            if run["kind"] == "engine":
                br = run["br"]
                br = part.load_pack(br) if isinstance(br, str) else br
                eng = NomadRingEngine(
                    br=br, k=run["k"], lam=run["lam"],
                    stepsize=run["stepsize"], policy=run["policy"],
                    mesh=mesh, step_log=[] if run.get("log_steps") else None)
                eng.init_factors(_load(run["W0"]), _load(run["H0"]))
                test = run.get("test")
                if isinstance(test, str):
                    test = tuple(np.load(f"{test}_{c}.npy")
                                 for c in ("rows", "cols", "vals"))
                load_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                trace = eng.train(run["epochs"], test=test,
                                  dispatch=run.get("dispatch", "fused"),
                                  record_every=run.get("record_every", 1))
                if mesh.device.type == "cuda":
                    torch.cuda.synchronize(mesh.device)
                train_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                W, H = eng.factors()
                finite = eng.last_finite
                out[f"steps{i}"] = eng.step_log
                out[f"load_s{i}"] = load_s
            else:
                res = api.solve(run["problem"], run["config"], mesh=mesh)
                train_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                W, H = res.W, res.H
                trace = list(zip(res.trace_epochs.tolist(),
                                 res.trace_rmse.tolist()))
                finite = res.extras.get("divergence", {}).get("finite")
            out[f"factors_s{i}"] = time.perf_counter() - t0
            out[f"train_s{i}"] = train_s
            out[f"digest{i}"] = factor_digest(W, H)
            out[f"trace{i}"] = [(int(e), float(r)) for e, r in trace]
            out[f"finite{i}"] = finite
            out[f"launches{i}"] = {w.__name__: w.launches
                                   for w in ks.WRAPPERS}
            out[f"plain{i}"] = calls[0]
            if run.get("return_factors", True):
                out[f"W{i}"], out[f"H{i}"] = np.asarray(W), np.asarray(H)
            del W, H
    finally:
        ks.block_sgd_waves_csr = plain
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        out["card_peak_bytes"] = torch.cuda.max_memory_allocated()
    peak.close()
    out["host_peak_rss_gb"] = float(peak.gb())
    return out


def raise_on_rank(rank: int, p: int, bad: int) -> int:
    """Rank body: rank ``bad`` raises, the others return their rank."""
    if rank == bad:
        raise ValueError(f"rank {rank} was told to fail")
    return rank


def hang_on_rank(rank: int, p: int, bad: int, pid_dir: str) -> int:
    """Rank body: every rank writes its pid to ``pid_dir``; rank ``bad``
    then sleeps for ever, the others return their rank."""
    import os
    import time
    with open(os.path.join(pid_dir, f"rank{rank}.pid"), "w") as f:
        f.write(str(os.getpid()))
    while rank == bad:
        time.sleep(1)
    return rank
