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
import time

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


class KernelCounts:
    """The wave kernel wrappers' launches (``kernels.nomad_sgd.WRAPPERS``)
    and the calls of their plain version, ``block_sgd_waves_csr``, counted
    while the context is open (a counting stand-in replaces it; the
    stream impls call it straight from ``core.nomad``, uncounted)."""

    def __enter__(self):
        from .kernels import nomad_sgd as ks
        self._ks, self._plain, self.plain = ks, ks.block_sgd_waves_csr, 0

        def counted(*a, **kw):
            self.plain += 1
            return self._plain(*a, **kw)

        ks.block_sgd_waves_csr = counted
        return self

    def __exit__(self, *exc):
        self._ks.block_sgd_waves_csr = self._plain

    def reset(self) -> None:
        self._ks.reset_launches()
        self.plain = 0

    def launches(self) -> dict:
        return {w.__name__: w.launches for w in self._ks.WRAPPERS}


def _problem(spec):
    """An ``api.MCProblem``, or one built from a dict: ``m``, ``n`` and
    ``rows``/``cols``/``vals`` and ``test`` (a triple), arrays or ``.npy``
    paths."""
    import numpy as np

    from . import api
    if isinstance(spec, api.MCProblem):
        return spec
    test = spec.get("test")
    return api.MCProblem(
        *(np.asarray(_load(spec[c])) for c in ("rows", "cols", "vals")),
        m=spec["m"], n=spec["n"],
        test=None if test is None else tuple(np.asarray(_load(a))
                                             for a in test))


def _fit_result(spec):
    """An ``api.FitResult``, or one built from a dict of its fields
    (``W``/``H`` arrays or ``.npy`` paths)."""
    import numpy as np

    from . import api
    if spec is None or isinstance(spec, api.FitResult):
        return spec
    spec = dict(spec)
    for name in ("W", "H"):
        spec[name] = np.asarray(_load(spec[name]))
    return api.FitResult(**spec)


def session_ops(sess, script, counts: KernelCounts, make_mesh=None,
                keep_factors: bool = False) -> list:
    """Drive ``sess`` (an ``api.StreamingSession``) through ``script``,
    one record per op.  Ops: ``("fit", epochs)``, ``("arrive", batch)``
    (``sess.arrive(**batch)``), ``("leave", workers)``, ``("join",
    count)``, ``("kill", workers)`` and ``("bitflip", seed)`` (the newest
    checkpoint, by the session's lead rank on a mesh).  On a mesh each
    worker-set change moves the session onto ``make_mesh(ranks)``, the
    ranks ``McMesh.ranks_after`` gives; without one the engine keeps its
    device.  A record holds the factors' digest (the round's result,
    or the engine's factors after a change), the round's RMSE trace, the
    wave kernel's launches and the plain version's calls during the op,
    the session's timings of the op, ``p``, whether this rank held a
    worker, the mesh's ranks before the op, the training rounds it ran
    (a kill's replayed ones), the host seconds, after a kill the
    quarantined steps, and with ``keep_factors`` the factors themselves
    (``W``, ``H``)."""
    import os

    import numpy as np

    from .runtime.chaos import bitflip_checkpoint
    out = []
    for name, arg in script:
        counts.reset()
        sess.timings.clear()
        kw = {}
        if sess.mesh is not None and name in ("leave", "kill", "join"):
            change = {"join": arg} if name == "join" else {"leave": arg}
            kw["mesh"] = make_mesh(sess.mesh.ranks_after(**change))
        rec = {"op": name, "ranks_before": None if sess.mesh is None
               else list(sess.mesh.ranks)}
        rounds = len(sess.history)
        t0 = time.perf_counter()
        res = None
        if name == "fit":
            res = sess.fit(arg)
        elif name == "arrive":
            res = sess.arrive(**arg)
        elif name == "leave":
            sess.resize(leave=arg, **kw)
        elif name == "join":
            sess.resize(join=arg, **kw)
        elif name == "kill":
            sess.kill(*arg, **kw)
        elif name == "bitflip":
            def flip():
                return bitflip_checkpoint(sess.faults.checkpoint_dir,
                                          seed=arg)
            rec["flipped"] = (flip() if sess._launch is None
                              else sess._launch.on_lead(flip))
        else:
            raise ValueError(f"unknown op {name!r}")
        if res is not None:
            W, H = res.W, res.H
            rec["trace"] = [float(x) for x in res.trace_rmse]
        elif name != "bitflip":
            W, H = sess._eng.factors()
        if name != "bitflip":
            rec["digest"] = factor_digest(W, H)
            if keep_factors:
                rec["W"], rec["H"] = np.asarray(W), np.asarray(H)
        rec["seconds"] = time.perf_counter() - t0
        if name == "kill" and sess.faults is not None:
            rec["corrupt"] = sorted(
                f for f in os.listdir(sess.faults.checkpoint_dir)
                if f.endswith(".corrupt"))
        rec.update(launches=counts.launches(), plain=counts.plain,
                   timings=dict(sess.timings), p=sess.config.p,
                   member=sess.mesh is None or sess.mesh.member,
                   rounds=len(sess.history) - (0 if name == "kill"
                                               else rounds))
        out.append(rec)
    return out


def run_script(run: dict, counts: KernelCounts, mesh=None,
               device=None) -> dict:
    """One streaming, elastic or fault-tolerant run, on ``mesh`` (every
    rank of the launch alike) or, without one, on ``device`` — the same
    calls either way, so that the two are held against each other.
    ``run["kind"]``:

    * ``"session"``: ``StreamingSession(problem, config,
      warm_start=warm, faults=faults, mesh=)`` through ``script``
      (:func:`session_ops`, the factors kept with ``keep_factors``);
      ``pack``, a ``save_pack`` directory, seeds the problem's pack
      cache.  Returns ``ops``.
    * ``"partial_fit"``: ``partial_fit(mesh=)`` of each of ``batches`` in
      a chain from ``warm``.  Returns ``ops`` (digest, trace).
    * ``"faults"``: ``solve(faults=FaultPolicy(ckpt), mesh=)`` of ``cut``
      epochs, then of ``config.epochs``: a crash after ``cut`` epochs
      and the resume.  Returns ``ops`` (digest, trace, launches).
    * ``"chaos"``: ``ChaosHarness(session, events, seed=,
      mesh_factory=)`` (``make_mc_mesh`` of each new ``p`` on a mesh) over
      a session with ``faults``, after one ``fit``.  Returns
      ``digest``, ``rmse``, ``p_final`` and the recoveries' actions.
    """
    import dataclasses

    from . import api
    from .core import partition as part
    from .launch.mesh import make_mc_mesh
    from .runtime.chaos import ChaosHarness

    kind = run["kind"]
    prob = _problem(run["problem"])
    cfg = run["config"]
    warm = _fit_result(run.get("warm"))
    if run.get("pack"):
        api._seed_pack_cache(prob, part.load_pack(run["pack"]), cfg)
    dev = None if mesh is not None else device

    def new_mesh(ranks):
        return make_mc_mesh(len(ranks), ranks=ranks, device=mesh.device)

    def record(res, t0):
        return dict(digest=factor_digest(res.W, res.H),
                    trace=[float(x) for x in res.trace_rmse],
                    seconds=time.perf_counter() - t0,
                    launches=counts.launches(), plain=counts.plain)

    if kind == "session":
        sess = api.StreamingSession(prob, cfg, warm_start=warm,
                                    faults=run.get("faults"), mesh=mesh,
                                    device=dev)
        return {"ops": session_ops(sess, run["script"], counts, new_mesh,
                                   run.get("keep_factors", False))}
    if kind == "partial_fit":
        ops, res = [], warm
        for b in run["batches"]:
            counts.reset()
            t0 = time.perf_counter()
            res = api.partial_fit(res, prob.extend(**b), cfg, mesh=mesh,
                                  device=dev)
            prob = res.extras["problem"]
            ops.append(record(res, t0))
        return {"ops": ops}
    if kind == "faults":
        policy = api.FaultPolicy(checkpoint_dir=run["ckpt"],
                                 checkpoint_every=1)
        ops = []
        for epochs in (run["cut"], cfg.epochs):
            counts.reset()
            t0 = time.perf_counter()
            res = api.solve(prob, dataclasses.replace(cfg, epochs=epochs),
                            warm_start=warm, faults=policy, mesh=mesh,
                            device=dev)
            ops.append(record(res, t0))
        return {"ops": ops}
    if kind == "chaos":
        sess = api.StreamingSession(prob, cfg, warm_start=warm,
                                    faults=run["faults"], mesh=mesh,
                                    device=dev)
        sess.fit()
        factory = None if mesh is None else (
            lambda p_next: make_mc_mesh(p_next, device=mesh.device))
        counts.reset()
        report = ChaosHarness(sess, run["events"], seed=run.get("seed", 0),
                              mesh_factory=factory).run()
        W, H = sess._eng.factors()
        return dict(digest=factor_digest(W, H), rmse=report.rmse,
                    p_final=report.p_final, launches=counts.launches(),
                    plain=counts.plain,
                    actions=[r.action for r in report.recoveries],
                    rollbacks=sess.history[-1].extras.get(
                        "divergence", {}).get("rollbacks"))
    raise ValueError(f"unknown run kind {kind!r}")


#: the kinds of run :func:`run_on_mesh` hands to :func:`run_script`
SCRIPT_KINDS = ("session", "partial_fit", "faults", "chaos")


def run_on_mesh(rank: int, p: int, runs, device=None) -> dict:
    """Rank body: each of ``runs`` on this rank's mesh
    (``make_mc_mesh(run.get("p", p), device=run.get("device", device))``:
    the first ``p`` ranks of the launch), in order.  A run is a dict with
    ``kind``:

    * ``"engine"``: ``NomadRingEngine(br, k, lam, stepsize, policy,
      mesh=)`` (``br`` a packing or a :func:`~repro_torch.core.partition.
      save_pack` directory), ``init_factors(W0, H0)`` (arrays or ``.npy``
      paths), ``train(epochs, test, dispatch=, record_every=)``; with
      ``log_steps`` the engine's per-step records come back;
    * ``"solve"``: ``api.solve(problem, config, mesh=)``;
    * ``"errors"``: the messages of ``make_mc_mesh(p + 1)`` and of an
      engine built on ``br`` (a packing for another ``p``);
    * one of :data:`SCRIPT_KINDS`: :func:`run_script` on the mesh, its
      result under ``script{i}``.

    Returns, for run ``i``: ``digest{i}``, ``trace{i}``, ``finite{i}``,
    the wave kernel wrappers' launches (``launches{i}``) and the plain
    version's calls (``plain{i}``), the train and factors seconds, and
    ``W{i}``/``H{i}`` unless ``return_factors`` is False; the card's and
    the process's peaks during the run (``card_peak_bytes{i}``,
    ``host_peak_rss_gb{i}``) and its ``time.time()`` span (``span{i}``);
    and the mesh's transport, ``ready_at``
    (``time.time()`` once the first mesh was made), the card's peak
    bytes and the process's peak RSS (:class:`HostPeak`) over all runs."""
    import time

    import numpy as np
    import torch

    from . import api
    from .core import partition as part
    from .core.nomad import NomadRingEngine
    from .launch.mesh import make_mc_mesh

    meshes, out = {}, {}
    peak = HostPeak()
    card_max = 0

    def finish(i, on_card, mesh, run_peak):
        out[f"span{i}"] = (started, time.time())
        if on_card:
            out[f"card_peak_bytes{i}"] = torch.cuda.max_memory_allocated(
                mesh.device)
        run_peak.close()
        out[f"host_peak_rss_gb{i}"] = float(run_peak.gb())

    def mesh_for(dev, size):
        key = (str(dev), size)
        if key not in meshes:
            meshes[key] = make_mc_mesh(size, device=dev)
            out.setdefault("ready_at", time.time())
            out.setdefault("transport", meshes[key].describe())
        return meshes[key]

    with KernelCounts() as counts:
        for i, run in enumerate(runs):
            mesh = mesh_for(run.get("device", device), run.get("p", p))
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
            on_card = mesh.device.type == "cuda"
            if on_card:
                card_max = max(card_max, torch.cuda.max_memory_allocated(
                    mesh.device))
                torch.cuda.reset_peak_memory_stats(mesh.device)
            run_peak = HostPeak()
            counts.reset()
            started = time.time()
            if run["kind"] in SCRIPT_KINDS:
                out[f"script{i}"] = run_script(run, counts, mesh=mesh)
                finish(i, on_card, mesh, run_peak)
                continue
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
                if on_card:
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
            out[f"launches{i}"] = counts.launches()
            out[f"plain{i}"] = counts.plain
            finish(i, on_card, mesh, run_peak)
            if run.get("return_factors", True):
                out[f"W{i}"], out[f"H{i}"] = np.asarray(W), np.asarray(H)
            del W, H
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        out["card_peak_bytes"] = max(card_max,
                                     torch.cuda.max_memory_allocated())
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
