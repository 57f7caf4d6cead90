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

import contextlib
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
                      start: torch.Tensor, what: str = "",
                      share: float = FLIP_SHARE) -> tuple:
    """Raise unless both are finite and ``got`` differs from ``want`` on
    at most ``FLIP_SLACK + share * changed`` elements (:func:`flips`;
    ``share`` is :data:`FLIP_SHARE` unless the caller states its own);
    return ``(differing, changed)``."""
    if not (bool(torch.isfinite(got).all())
            and bool(torch.isfinite(want).all())):
        raise AssertionError(f"{what}: non-finite values")
    differing, changed = flips(got, want, start)
    if differing > FLIP_SLACK + share * changed:
        raise AssertionError(
            f"{what}: {differing} elements differ of {changed} updated "
            f"(bound {FLIP_SLACK} + {share:g} x updated)")
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


def run_mc_then_lm(rank: int, world: int, runs, lm_runs,
                   device=None) -> dict:
    """Rank body of one launch that carries a matrix-completion mesh and
    an LM mesh in turn: :func:`run_on_mesh` of ``runs``, then (its card
    memory returned) :func:`run_lm_on_mesh` of ``lm_runs`` on the same
    process group.  Returns the first's results with the second's under
    ``"lm"``, which also holds the ``time.time()`` it started and ended
    at (``started_at``, ``ended_at``)."""
    import time
    out = run_on_mesh(rank, world, runs, device)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    started = time.time()
    lm = run_lm_on_mesh(rank, world, lm_runs, device)
    out["lm"] = dict(lm, started_at=started, ended_at=time.time())
    return out


class FlashCounts:
    """Over a ``with`` block: the flash kernel's launches (its wrapper's
    own count, zeroed on entry) and the calls of its plain version."""

    def __enter__(self):
        from .kernels import flash_attn as kfa
        self._kfa, self._plain = kfa, kfa.flash_attention_plain
        self.launches = self.plain_calls = 0

        def counted(*a, **kw):
            self.plain_calls += 1
            return self._plain(*a, **kw)

        kfa.flash_attention_plain = counted
        kfa.reset_launches()
        return self

    def __exit__(self, *exc):
        self.launches = self._kfa.flash_attention.launches
        self._kfa.flash_attention_plain = self._plain
        return False


def card_window(dev, seen: int = 0):
    """On the card: ``(the largest peak before now, at least seen; the
    bytes allocated now)``, the peak statistics then reset, so that the
    next peak read is a window's own; elsewhere ``(seen, 0)``."""
    if dev.type != "cuda":
        return seen, 0
    seen = max(seen, torch.cuda.max_memory_allocated(dev))
    torch.cuda.reset_peak_memory_stats(dev)
    return seen, torch.cuda.memory_allocated(dev)


class StepLog:
    """A record of each call of a prefill or a decode step on ``mesh``,
    given to ``launch.serve.generate`` as its ``around``: ``calls``, each
    ``{"kind": "prefill" or "decode", calls, bytes_in, bytes_out}``, the
    mesh's counters that the call added, and on the card also
    ``allocated`` (bytes before it) and ``peak`` (its own peak: the
    card's peak statistics are reset before each call; :attr:`peak`
    keeps the largest seen before each reset)."""

    def __init__(self, mesh):
        from .launch.mesh import COUNTERS
        self.mesh, self.calls, self.peak = mesh, [], 0
        self._counters = COUNTERS

    @contextlib.contextmanager
    def __call__(self, kind: str):
        stats, dev = self.mesh.stats, self.mesh.device
        before = {k: stats[k] for k in self._counters}
        self.peak, allocated = card_window(dev, self.peak)
        yield
        rec = {"kind": kind,
               **{k: stats[k] - before[k] for k in self._counters}}
        if dev.type == "cuda":
            rec.update(allocated=allocated,
                       peak=torch.cuda.max_memory_allocated(dev))
        self.calls.append(rec)


def param_fingerprint(tensors) -> str:
    """sha256 of every tensor's name, shape, dtype and every 4,099th
    element's bytes (a module's ``state_dict`` or a name -> tensor
    mapping), its first 16 hex digits: two sets of weights with equal
    fingerprints are the same tensors (a sample, so that the weights of a
    full-width model need not cross to the host)."""
    import hashlib
    import numpy as np
    if isinstance(tensors, torch.nn.Module):
        tensors = tensors.state_dict()
    h = hashlib.sha256()
    for name in sorted(tensors):
        t = tensors[name]
        h.update(f"{name}{tuple(t.shape)}{t.dtype}".encode())
        sample = t.detach().reshape(-1)[::4099].contiguous().cpu()
        if sample.element_size() == 2:
            sample = sample.view(torch.int16)
        h.update(np.ascontiguousarray(sample.numpy()).tobytes())
    return h.hexdigest()[:16]


class MoeLog:
    """Over a ``with`` block, each MoE call's routes as ``models/moe.py``'s
    own ``routes`` decides them, ``(experts (T, k), kept (T, k))``
    (``routes``), and each ``moe_apply``'s aux (``aux``)."""

    def __enter__(self):
        from .models import moe
        self._moe, self._routes, self._apply = moe, moe.routes, moe.moe_apply
        self.routes, self.aux = [], []

        def routes(*a, **kw):
            out = self._routes(*a, **kw)
            self.routes.append((out[2], out[4]))
            return out

        def apply(*a, **kw):
            out = self._apply(*a, **kw)
            self.aux.append(out[1])
            return out

        moe.routes, moe.moe_apply = routes, apply
        return self

    def __exit__(self, *exc):
        self._moe.routes, self._moe.moe_apply = self._routes, self._apply
        return False


def route_digest(calls) -> str:
    """sha256 of ``(experts, kept)`` pairs (numpy or tensors), its first
    16 hex digits."""
    import hashlib
    import numpy as np
    h = hashlib.sha256()
    for e, k in calls:
        for a in (e, k):
            a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def serve_record(model, cfg, prompts, gen: int, ctx=None,
                 around=None) -> dict:
    """``launch.serve.generate`` of ``prompts`` (``gen`` greedy tokens,
    under inference mode) with what the sharded checks read, as numpy:
    ``tokens`` (B, gen) and ``logits`` (gen, B, V) fp32 (with ``ctx`` the
    rank's rows), ``routes`` (each MoE call's ``(experts int16, kept)``
    in call order: the prefill's layer by layer, then each decode step's),
    ``route_digests`` (:func:`route_digest` of each MoE layer's calls),
    ``aux_loss`` and ``dropped`` (the prefill's, summed over its MoE
    layers), ``ssm`` (each SSM layer's ``(conv, ssm)`` state after the
    last step, fp32); the timings, and the flash kernel's launches and
    plain calls (:class:`FlashCounts`); ``kv``: each attention layer's
    ``(k, v)`` decode cache after the last step, fp32 (with ``ctx`` the
    rank's block, ``launch.specs.local_kv_shape``).  ``around`` goes to
    ``generate`` (a :class:`StepLog`)."""
    from .launch import serve
    n_moe = sum(cfg.mlp_kind(i) == "moe" for i in range(cfg.n_layers))
    with torch.inference_mode(), FlashCounts() as fc, MoeLog() as log:
        toks, t = serve.generate(model, cfg, prompts, gen, ctx=ctx,
                                 keep_logits=True, around=around)
    routes = [(e.to(torch.int16).cpu().numpy(), k.cpu().numpy())
              for e, k in log.routes]
    pre = log.aux[:n_moe]
    return dict(
        tokens=toks.cpu().numpy(),
        logits=torch.stack(t["logits"]).float().cpu().numpy(),
        routes=routes,
        route_digests=[route_digest(routes[j::n_moe]) for j in range(n_moe)],
        aux_loss=float(sum(float(a["aux_loss"]) for a in pre)),
        dropped=float(sum(float(a["dropped"]) for a in pre)),
        ssm=[(c.conv.float().cpu().numpy(), c.ssm.float().cpu().numpy())
             for i, c in enumerate(t["cache"])
             if cfg.layer_kind(i) == "ssm"],
        prefill_s=t["prefill_s"], decode_s=t["decode_s"],
        flash_launches=fc.launches, plain_calls=fc.plain_calls,
        kv=[(c.k.float().cpu().numpy(), c.v.float().cpu().numpy())
            for i, c in enumerate(t["cache"]) if cfg.layer_kind(i) == "attn"])


def control_params(cfg, control: str):
    """The parameters a control of :func:`run_lm_on_mesh` serves with
    another model rank's blocks of (:func:`control_partner`): ``"wo"``
    layer 0's attention output, ``"out_proj"`` layer 0's Mamba output
    projection, ``"experts"`` the first MoE layer's experts (``gate``,
    ``up``, ``down``), ``"kv"`` the first attention layer's ``wk`` and
    ``wv`` (with their biases where the config has them)."""
    if control == "wo":
        return ["layers.0.mixer.wo.w"]
    if control == "kv":
        i = next(i for i in range(cfg.n_layers)
                 if cfg.layer_kind(i) == "attn")
        return [f"layers.{i}.mixer.{w}.{x}" for w in ("wk", "wv")
                for x in (("w", "b") if cfg.qkv_bias else ("w",))]
    if control == "out_proj":
        return ["layers.0.mixer.out_proj.w"]
    if control == "experts":
        i = next(i for i in range(cfg.n_layers) if cfg.mlp_kind(i) == "moe")
        return [f"layers.{i}.moe.{w}" for w in ("gate", "up", "down")]
    raise ValueError(f"unknown control {control!r}")


def control_partner(cfg, control: str, ctx) -> int:
    """The model rank whose blocks this rank serves a control with: the
    next one along the model axis; for ``"kv"``, where ``r`` model ranks
    share each KV head (``sharding.kv_share``), the next of the ``r``
    ranks of KV group 0 (a head's slices assembled in the wrong order),
    and every other rank its own."""
    from .distributed.sharding import kv_share
    t, n = ctx.tp_index, ctx.tp_size
    if control != "kv":
        return (t + 1) % n
    r = kv_share(cfg.n_kv_heads, n)
    return (t + 1) % r if t < r else t


def _controls(cfg, ctx):
    """The controls that apply to ``cfg`` on ``ctx``'s mesh."""
    from .distributed.sharding import kv_share
    out = ["wo" if cfg.layer_kind(0) == "attn" else "out_proj"]
    if any(cfg.mlp_kind(i) == "moe" for i in range(cfg.n_layers)):
        out.append("experts")
    if kv_share(cfg.n_kv_heads, ctx.tp_size) > 1:
        out.append("kv")
    return out


def _lm_weights(run: dict, cfg, ctx, dev):
    """``(the rank's blocks, its :func:`control_partner`'s blocks of each
    control's parameters (:func:`control_params`) by name, the blocks'
    fingerprint)`` for a ``"serve"`` run: the model is the reference's
    numpy tree (``run["params"]``) or drawn from ``run["seed"]`` on
    ``dev``, whole, then cut (``convert.shard_lm_params``)."""
    from .convert import lm_params_from_reference, shard_lm_params
    from .distributed.sharding import shard_param
    from .models import transformer as T
    if "params" in run:
        full = lm_params_from_reference(run["params"], cfg, device="cpu")
    else:
        full = T.init_params(torch.Generator(device=dev).manual_seed(
            run["seed"]), cfg, device=dev)
    model = shard_lm_params(full, cfg, ctx, device=dev)
    # the controls' blocks: their partners' along the model axis
    state = full.state_dict()
    other = {}
    for c in _controls(cfg, ctx):
        coords = ctx.mesh.coords[:-1] + (control_partner(cfg, c, ctx),)
        other.update({name: shard_param(name, state[name], ctx, coords).to(
            dev, copy=True) for name in control_params(cfg, c)})
    del full, state
    return model, other, param_fingerprint(model)


def split_train_step(state, batch, cfg, opt_cfg, *, ctx=None,
                     impl: str = "pallas", grad_accum: int = 1,
                     warmup: int = 100, total_steps: int = 10000):
    """One step of ``launch.train.make_train_step(cfg, ctx, opt_cfg,
    ...)`` made of the two public calls that step makes,
    ``launch.train.grads_and_metrics`` and then
    ``optim.adamw.adamw_update(ctx=ctx)``, so that a caller reads the
    step's gradients as the update was given them.  Returns ``(state,
    metrics, grads, (grads_s, update_s))``: the seconds of each part,
    the device synchronised between them."""
    from .launch import train as ltrain
    from .optim import adamw
    from .optim.schedule import cosine_warmup

    params = state["params"]
    dev = params.lm_head.w.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    grads, metrics = ltrain.grads_and_metrics(
        params, cfg, ltrain.to_device(batch, dev), ctx=ctx, impl=impl,
        grad_accum=grad_accum)
    sync()
    t1 = time.perf_counter()
    lr_scale = cosine_warmup(state["opt"]["step"], base_lr=1.0,
                             warmup=warmup, total=total_steps)
    _, _, opt_metrics = adamw.adamw_update(params, grads, state["opt"],
                                           opt_cfg, lr_scale=lr_scale,
                                           ctx=ctx)
    sync()
    return (state, {**metrics, **opt_metrics}, grads,
            (t1 - t0, time.perf_counter() - t1))


def row_oracle(model, cfg, batch, dp: int, *, impl: str = "pallas",
               aux_weight: float = 0.01):
    """The unsharded port's oracle of a training loss on a mesh with
    ``dp`` data rows: ``(grads, metrics)`` of ``model`` (whole, no ctx)
    on ``batch`` (the global batch, numpy arrays or tensors).  An MoE
    layer's capacity counts its call's tokens, so a dp-sharded model
    routes and drops each data row's rows on their own and its aux loss
    is the mean over dp of the rows' aux losses.  Where ``dp`` divides
    the batch, each data row's rows run through
    ``transformer.loss_and_metrics`` on their own and are combined as the
    sharded loss combines them: the cross-entropy by valid-label count
    (``n_r / N`` each; none when no label is valid) and the aux term by
    the mean over dp, ``aux_weight / dp`` each; the rows' gradients are
    summed in fp32.  Otherwise (a replicated batch) the whole batch is
    the one row.  ``grads`` are fp32 ``{name: tensor}``; ``metrics``
    ``{"loss", "xent", "aux_loss", "dropped"}`` floats, the global
    batch's."""
    from .launch import train as ltrain
    from .models import transformer as T
    named = dict(model.named_parameters())
    dev = next(iter(named.values())).device
    batch = ltrain.to_device(batch, dev)
    B = batch["inputs"].shape[0]
    n = dp if B % dp == 0 else 1
    rows = [{k: v[i * B // n:(i + 1) * B // n] for k, v in batch.items()}
            for i in range(n)]
    counts = [int((r["labels"] != -100).sum()) for r in rows]
    total = sum(counts)
    grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
             for k, p in named.items()}
    sums = dict.fromkeys(("xent", "aux_loss", "dropped"), 0.0)
    was = {k: p.requires_grad for k, p in named.items()}
    try:
        for p in named.values():
            p.requires_grad_(True)
        for r, c in zip(rows, counts):
            _, m = T.loss_and_metrics(model, cfg, r, impl=impl)
            w = c / total if total else 0.0
            loss = w * m["xent"] + aux_weight / n * m["aux_loss"]
            if loss.requires_grad:
                for a, g in zip(grads.values(), torch.autograd.grad(
                        loss, list(named.values()), allow_unused=True)):
                    if g is not None:
                        a.add_(g.float())
            sums["xent"] += w * float(m["xent"].detach())
            sums["aux_loss"] += float(m["aux_loss"].detach()) / n
            sums["dropped"] += float(m["dropped"].detach()) / n
    finally:
        for k, p in named.items():
            p.requires_grad_(was[k])
    sums["loss"] = sums["xent"] + aux_weight * sums["aux_loss"]
    return grads, sums


def unsum_over_tp(root: torch.Tensor, pick) -> int:
    """A control: in the backward of ``root``, each ``tp.copy_to_tp``
    (``f``) of its autograd graph that ``pick`` chooses (a function of
    the node: :func:`x_proj_partials`, :func:`combine_weights`) passes on
    the gradient it receives, this rank's own share, where the program
    passes the model group's sum (the sum is still taken, so the ranks
    stay in step).  The program runs as it is; only this graph's
    backward differs.  Returns how many ``f``s it chose."""
    from .distributed import tp
    seen, todo, n = set(), [root.grad_fn], 0
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if _backward_of(node) is tp._CopyTp and pick(node):
            node.register_hook(lambda grad_in, grad_out: (grad_out[0],))
            n += 1
        todo.extend(c for c, _ in node.next_functions)
    return n


def _backward_of(node):
    """The ``torch.autograd.Function`` whose backward autograd ``node``
    is (``None`` for a built-in op's)."""
    return getattr(node, "_forward_cls", None)


def x_proj_partials(node) -> bool:
    """:func:`unsum_over_tp`'s pick of the Mamba mixer's ``f`` after the
    sum of ``x_proj``'s partials (the one whose input is a
    ``tp.psum_tp``): each model rank's ``x_proj``, and what lies upstream,
    then gets only its own channels' share of the gradient."""
    from .distributed import tp
    return _backward_of(node.next_functions[0][0]) is tp._SumTp


def combine_weights(node) -> bool:
    """:func:`unsum_over_tp`'s pick of the MoE's ``f`` on its combine
    weights (the one from whose input the router's softmax is reached
    without crossing a collective of ``distributed.tp``): each model
    rank's router then gets only its own experts' share of the expert
    path's gradient, and the aux path's whole."""
    from .distributed import tp
    seen, todo = set(), [node.next_functions[0][0]]
    while todo:
        n = todo.pop()
        if n is None or n in seen or getattr(_backward_of(n), "__module__",
                                             None) == tp.__name__:
            continue
        if n.name() == "SoftmaxBackward0":
            return True
        seen.add(n)
        todo.extend(c for c, _ in n.next_functions)
    return False


def kind_norms(grads, ctx) -> dict:
    """``{str(spec): sharding.global_norm of the gradients of that spec
    kind}`` (``grads``: ``{state_dict name: this rank's block}``), the
    kinds in sorted order on every rank: each kind's part of the global
    norm, as the program computes it."""
    from .distributed.sharding import global_norm, spec_for
    kinds = {}
    for k, g in grads.items():
        kinds.setdefault(str(spec_for(k, g.dim(), ctx)), {})[k] = g
    return {kind: float(global_norm(kinds[kind], ctx))
            for kind in sorted(kinds)}


def block_rows(t: torch.Tensor, spec, ctx, rows=None):
    """A rank's block ``t`` of a tensor cut by ``spec`` (dim 0 of at most
    two), restricted to the global rows ``rows`` (a sorted numpy array of
    indices along dim 0; ``None``: all) that lie in the block, as an fp32
    numpy copy: what :func:`assemble_rows` puts back together.  ``ctx``
    may be ``None`` where ``spec`` leaves dim 0 whole."""
    import numpy as np
    if rows is None:
        return np.array(t.detach().float().cpu().numpy())
    n0 = t.shape[0]
    lo = 0 if spec[0] is None else ctx.mesh.index(spec[0]) * n0
    mine = rows[(rows >= lo) & (rows < lo + n0)] - lo
    return t.detach()[torch.from_numpy(mine).to(t.device)].float().cpu(
        ).numpy()


def unhalve(name: str, whole, n: int):
    """A whole tensor (numpy) put together block by block by
    :func:`assemble_rows` from the blocks of parameter ``name``, in the
    parameter's own layout: where ``name`` is a tensor whose last
    dimension ``sharding.shard_param`` cuts half by half (Mamba's
    ``in_proj``, each of ``n`` blocks ``[x block | z block]``), the
    columns reordered to ``[x | z]``; any other tensor as it is."""
    import re

    import numpy as np

    from .distributed.sharding import _HALVED
    if not re.search(_HALVED, name.replace(".", "/")):
        return whole
    blocks = np.split(whole, n, axis=-1)
    return np.concatenate([h for i in (0, 1)
                           for h in (np.split(b, 2, axis=-1)[i]
                                     for b in blocks)], axis=-1)


def assemble_rows(parts, coords, shape, spec, axis_names, mesh_shape,
                  rows=None):
    """The whole tensor (or its global ``rows``) from every rank's
    :func:`block_rows` (``parts``, in rank order, ranks at ``coords`` on
    a mesh of ``axis_names`` and ``mesh_shape``), fp32 numpy.  Returns
    ``(array, copies_equal)``: whether every rank that holds a block
    holds the same values (replicated copies equal)."""
    import numpy as np

    def size_index(axes, c):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        pos = [axis_names.index(a) for a in axis_names if a in axes]
        return (int(np.prod([mesh_shape[i] for i in pos])),
                int(np.ravel_multi_index([c[i] for i in pos],
                                         [mesh_shape[i] for i in pos])))
    n_rows = shape[0] if rows is None else len(rows)
    out = np.zeros((n_rows,) + tuple(shape[1:]), np.float32)
    seen = np.zeros(out.shape, bool)
    equal = True
    for part, c in zip(parts, coords):
        sl = []
        for dim, axes in enumerate(spec):
            n = shape[dim]
            if axes is None:
                sl.append((0, n))
            else:
                k, i = size_index(axes, c)
                sl.append((i * n // k, (i + 1) * n // k))
        if rows is None:
            idx = np.arange(sl[0][0], sl[0][1])
        else:
            idx = np.nonzero((rows >= sl[0][0]) & (rows < sl[0][1]))[0]
        key = (idx,) + tuple(slice(a, b) for a, b in sl[1:])
        old, had = out[key], seen[key]
        equal &= bool(np.array_equal(old[had], part[had]))
        out[key] = part
        seen[key] = True
    return out, equal


def loss_grads(params, cfg, batch, ctx, *, aux_weight: float = 0.01,
               only=None, unsum=None):
    """The gradients on a mesh of ``transformer.loss_and_metrics(ctx=)``
    at ``aux_weight`` (every label of ``batch`` ignored: the aux term
    alone), with respect to the parameters whose names hold one of
    ``only`` (``None``: all), after ``sharding.reduce_grads``: ``(grads
    (blocks; zeros where the loss does not reach), whether the loss had
    a gradient at all, metrics, how many f's unsum chose)``, attention
    through the flash kernel, as ``launch.train``'s step takes them.
    ``unsum`` (a pick of :func:`unsum_over_tp`) makes it a control.  The
    other parameters take no gradient, so the backward stops where it
    leaves the chosen ones."""
    from .distributed.sharding import reduce_grads
    from .launch import train as ltrain
    from .models import transformer as T
    named = dict(params.named_parameters())
    chosen = {k: p for k, p in named.items()
              if only is None or any(o in k for o in only)}
    was = {k: p.requires_grad for k, p in named.items()}
    try:
        for k, p in named.items():
            p.requires_grad_(k in chosen)
        share, m = T.loss_and_metrics(
            params, cfg, ltrain.to_device(batch, params.lm_head.w.device),
            ctx=ctx, impl="pallas", aux_weight=aux_weight)
        n = 0
        if share.requires_grad:
            n = 0 if unsum is None else unsum_over_tp(share, unsum)
            got = torch.autograd.grad(share, list(chosen.values()),
                                      allow_unused=True)
        else:
            got = [None] * len(chosen)
    finally:
        for k, p in named.items():
            p.requires_grad_(was[k])
    grads = reduce_grads({k: torch.zeros_like(p) if g is None else g
                          for (k, p), g in zip(chosen.items(), got)}, ctx)
    return (grads, bool(share.requires_grad),
            {k: float(m[k]) for k in ltrain.METRICS}, n)


def _grads_out(run: str, what: str, spec: dict, params, cfg, ctx,
               out: dict) -> None:
    """:func:`loss_grads` of a ``"train"`` case's ``extra`` ``spec``
    (``batch``, ``aux_weight``, ``only``, ``unsum``, ``cfg_kw``) under
    ``out[run + "." + what + ...]``: the blocks (``grad.<name>``),
    ``requires_grad``, ``metrics``, ``unsummed`` (how many f's),
    ``seconds`` and, on a card, ``card_peak_bytes`` (the pass's)."""
    import dataclasses

    from .distributed.sharding import spec_for
    dev = params.lm_head.w.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    grads, live, m, n = loss_grads(
        params, dataclasses.replace(cfg, **spec.get("cfg_kw", {})),
        spec["batch"], ctx, aux_weight=spec.get("aux_weight", 0.01),
        only=spec.get("only"), unsum=spec.get("unsum"))
    pre = f"{run}.{what}"
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        out[f"{pre}.card_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out[f"{pre}.seconds"] = time.perf_counter() - t0
    for k, g in grads.items():
        out[f"{pre}.grad.{k}"] = block_rows(g, spec_for(k, g.dim(), ctx),
                                            ctx)
    out[f"{pre}.requires_grad"] = live
    out[f"{pre}.metrics"] = m
    out[f"{pre}.unsummed"] = n


def _train_case(run: dict, mesh, ctx, out: dict) -> None:
    """A ``"train"`` case of :func:`run_lm_on_mesh`: see there."""
    import dataclasses

    from .convert import lm_params_from_reference, shard_lm_params
    from .distributed.sharding import spec_for
    from .launch import specs
    from .launch import train as ltrain
    from .launch.dryrun import nbytes
    from .launch.mesh import COUNTERS
    from .optim import adamw

    name, dev = run["name"], mesh.device
    cfg = dataclasses.replace(run["cfg"], tp_collectives=run["mode"],
                              **run.get("cfg_kw", {}))
    opt_cfg = adamw.AdamWConfig(**run.get("opt", {}))
    keep = run.get("keep")
    if "params" in run:
        full = lm_params_from_reference(run["params"], cfg, device="cpu")
        params = shard_lm_params(full, cfg, ctx, device=dev)
        del full
        state = {"params": params, "opt": adamw.adamw_init(params, opt_cfg)}
    else:
        state = ltrain.init_state(torch.Generator(device=dev).manual_seed(
            run["seed"]), cfg, opt_cfg, device=dev, ctx=ctx)
    want = specs.train_state_struct(cfg, ctx, opt_cfg)
    have = {"params": dict(state["params"].named_parameters()),
            **{o: state["opt"][o] for o in ("m", "v", "master")
               if o in state["opt"]}}
    wanted = {"params": want["params"],
              **{o: want["opt"][o] for o in ("m", "v", "master")
                 if o in want["opt"]}}
    bad = [f"{part}/{k}" for part, leaves in wanted.items()
           for k, leaf in leaves.items()
           if (tuple(have[part][k].shape), have[part][k].dtype)
           != (leaf.shape, leaf.dtype)]
    st, leaf = state["opt"]["step"], want["opt"]["step"]
    if set(have) != set(wanted) or (tuple(st.shape), st.dtype) != (
            leaf.shape, leaf.dtype):
        bad.append("parts or step")
    out[f"{name}.struct_mismatches"] = bad
    names = [k for k, _ in state["params"].named_parameters()]
    specs_of = {k: spec_for(k, p.dim(), ctx)
                for k, p in state["params"].named_parameters()}

    def window(prefix, tensors):
        for k in (names if keep is None else keep):
            rows = None if keep is None else keep[k]
            out[f"{name}.{prefix}.{k}"] = block_rows(tensors[k],
                                                     specs_of[k], ctx, rows)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    kw = dict(impl=run.get("impl", "pallas"),
              total_steps=run.get("total_steps", 10),
              warmup=run.get("warmup", 0),
              grad_accum=run.get("grad_accum", 1))
    step = ltrain.make_train_step(cfg, ctx, opt_cfg, **kw)
    for what, spec in run.get("extra", {}).items():
        # read before the step, on its state, outside its counters
        _grads_out(name, what, spec, state["params"], cfg, ctx, out)
    if dev.type == "cuda":
        # the step's peak, the state's resident blocks in it
        torch.cuda.reset_peak_memory_stats(dev)
    for k in mesh.stats:
        mesh.stats[k] = 0
    metrics, secs, wire, steps, peak = [], [], [], [], 0
    with FlashCounts() as fc:
        for i, batch in enumerate(run["batches"]):
            sync()
            w0 = mesh.stats["wire_s"]
            before = {k: mesh.stats[k] for k in COUNTERS}
            peak, allocated = card_window(dev, peak)
            t0 = time.perf_counter()
            if i == 0:
                # the first step through the calls make_train_step makes,
                # to read its gradients; the rest as a user runs them
                state, m, grads, split = split_train_step(
                    state, batch, cfg, opt_cfg, ctx=ctx, **kw)
            else:
                state, m = step(state, batch)
            sync()
            secs.append(time.perf_counter() - t0)
            wire.append(mesh.stats["wire_s"] - w0)
            steps.append({k: mesh.stats[k] - before[k] for k in COUNTERS})
            if dev.type == "cuda":
                steps[-1].update(allocated=allocated,
                                 peak=torch.cuda.max_memory_allocated(dev))
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                # read outside the steps' collective counters
                counted = dict(mesh.stats)
                window("grad", grads)
                out[f"{name}.kind_norms"] = kind_norms(grads, ctx)
                mesh.stats.update(counted)
                del grads
    out[f"{name}.names"] = names
    out[f"{name}.metrics"] = metrics
    out[f"{name}.step_s"] = secs
    out[f"{name}.step_split_s"] = list(split)
    out[f"{name}.step_wire_s"] = wire
    out[f"{name}.flash_launches"] = fc.launches
    out[f"{name}.plain_calls"] = fc.plain_calls
    out.update({f"{name}.{k}": v for k, v in mesh.stats.items()})
    for part in run.get("state_keys", ("params", "m", "v", "master")):
        window(part, have[part])
    out[f"{name}.step"] = int(state["opt"]["step"])
    out[f"{name}.steps"] = steps
    out[f"{name}.state_bytes"] = nbytes([state["params"].state_dict(),
                                         state["opt"]])
    if dev.type == "cuda":
        out[f"{name}.card_peak_bytes"] = max(
            peak, torch.cuda.max_memory_allocated(dev))


def _tp_grad_case(run: dict, ctx, put, arr, rng) -> None:
    """A ``"tp_grad"`` case of :func:`run_lm_on_mesh`: see there."""
    from .distributed import tp
    from .distributed.sharding import shard_tensor

    B, S, d, f, V = run["B"], 3, 8, 12, 16
    x, xf = arr(B, S, d), arr(B, S, f)
    w_col, w_row, b_col, b_row = arr(d, f), arr(f, d), arr(f), arr(d)
    table, logits = arr(V, d), arr(B, S, V, scale=3.0)
    ct_col, ct_row, ct_emb = arr(B, S, f), arr(B, S, d), arr(B, S, d)
    tokens = torch.from_numpy(rng.integers(0, V, (B, S))).to(x.device)
    labels = torch.from_numpy(rng.integers(0, V, (B, S))).to(x.device)
    labels[0, :2] = -100
    sharded = tp.batch_sharded(B, ctx)
    share = 1.0 if sharded else 1.0 / ctx.dp_size

    def block(t, *spec):
        return shard_tensor(t, spec, ctx).clone().requires_grad_(True)

    def rows(t):
        return tp.local_batch(t, ctx)

    xl, xfl = block(rows(x), None, None, None), block(
        rows(xf), None, None, ctx.tp)
    wc, wr = block(w_col, ctx.dp, ctx.tp), block(w_row, ctx.tp, ctx.dp)
    bc, br = block(b_col, ctx.tp), block(b_row, None)
    y = tp.col_parallel_dense(xl, wc, ctx, bc)
    y.backward(shard_tensor(rows(ct_col), (None, None, ctx.tp), ctx) * share)
    for key, t in (("x", xl), ("w", wc), ("b", bc)):
        put(f"col.{key}", t.grad)
    for mode in ("manual", "gspmd"):
        for t in (xfl, wr, br):
            t.grad = None
        y = tp.row_parallel_dense(xfl, wr, ctx, br, collectives=mode)
        y.backward(rows(ct_row) * share)
        for key, t in (("x", xfl), ("w", wr), ("b", br)):
            put(f"row_{mode}.{key}", t.grad)
    tab = block(table, ctx.tp, ctx.dp)
    emb = tp.vocab_parallel_embed(tab, rows(tokens), ctx)
    emb.backward(rows(ct_emb) * share)
    put("embed.table", tab.grad)
    lg = block(rows(logits), None, None, ctx.tp)
    loss, xent = tp.vocab_parallel_cross_entropy(lg, rows(labels), ctx,
                                                 sharded=sharded)
    loss.backward()
    put("xent.logits", lg.grad)
    put("xent.value", xent)
    put("xent.share", loss)


def _lm_case(run: dict, mesh, ctx, weights: dict, out: dict) -> None:
    """One case of :func:`run_lm_on_mesh`, its results under
    ``out[run["name"] + "." + ...]``."""
    import dataclasses

    import numpy as np

    from .distributed import ring, tp
    from .distributed.sharding import shard_tensor
    from .launch.dryrun import nbytes
    from .models import attention as A

    name, kind = run["name"], run["kind"]
    rng = np.random.default_rng(run.get("seed", 0))
    dev = mesh.device

    def put(key, t):
        out[f"{name}.{key}"] = t.detach().float().cpu().numpy()

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(dev, run.get("dtype", torch.float32))

    if kind == "ring":
        p, j = mesh.size("model"), mesh.index("model")
        x, w = arr(16 * p, 32), arr(32, 12 * p)
        xb, wc = x[16 * j:16 * (j + 1)], w[:, 12 * j:12 * (j + 1)]
        put("ag", ring.ring_ag_matmul(xb, wc, mesh, "model"))
        put("ag_ref", ring.ring_ag_matmul_ref(xb, wc, mesh, "model"))
        xc, wr = x[:, 8 * j:8 * (j + 1)], w[8 * j:8 * (j + 1)]
        put("rs", ring.ring_rs_matmul(xc, wr, mesh, "model"))
        put("rs_ref", ring.ring_rs_matmul_ref(xc, wr, mesh, "model"))
    elif kind == "tp":
        B, S, d, f, V = run["B"], 3, 8, 12, 16
        x, xf = arr(B, S, d), arr(B, S, f)
        w_col, w_row, b_col, b_row = arr(d, f), arr(f, d), arr(f), arr(d)
        table = arr(V, d)
        tokens = torch.from_numpy(rng.integers(0, V, (B, S))).to(dev)
        sharded = tp.batch_sharded(B, ctx)

        def block(t, *spec):
            return shard_tensor(t, spec, ctx).contiguous()
        xl, xfl = tp.local_batch(x, ctx), tp.local_batch(xf, ctx)
        xfl = block(xfl, None, None, ctx.tp)
        wc, wr = block(w_col, ctx.dp, ctx.tp), block(w_row, ctx.tp, ctx.dp)
        bc = block(b_col, ctx.tp)
        put("col", tp.col_parallel_dense(xl, wc, ctx, bc))
        for mode in ("manual", "gspmd"):
            put(f"row_{mode}", tp.row_parallel_dense(
                xfl, wr, ctx, b_row, collectives=mode))
        put("col_2dtp", tp.col_parallel_dense_2dtp(xl, wc, ctx, bc,
                                                   sharded=sharded))
        put("row_2dtp", tp.row_parallel_dense_2dtp(xfl, wr, ctx, b_row,
                                                   sharded=sharded))
        tab = block(table, ctx.tp, ctx.dp)
        put("embed", tp.vocab_parallel_embed(tab, tp.local_batch(tokens,
                                                                 ctx), ctx))
        put("embed_2dtp", tp.vocab_parallel_embed_2dtp(tab, tokens, ctx))
    elif kind == "tp_grad":
        _tp_grad_case(run, ctx, put, arr, rng)
    elif kind == "train":
        _train_case(run, mesh, ctx, out)
    elif kind == "decode_attention":
        B, Hq, Hkv, S, D, cur = 2, 4, 2, 64, 16, run["cur_len"]
        q = arr(B, Hq, D, scale=0.5)
        kc, vc = arr(B, S, Hkv, D, scale=0.5), arr(B, S, Hkv, D)
        n, j = mesh.size("model"), mesh.index("model")
        lo, hi = j * S // n, (j + 1) * S // n
        put("out", A.decode_attention_sharded(
            q, kc[:, lo:hi], vc[:, lo:hi], cur - lo, mesh, "model"))
    elif kind == "serve":
        cfg = dataclasses.replace(run["cfg"], tp_collectives=run["mode"])
        key = run.get("weights", "params")
        if key not in weights:
            weights[key] = _lm_weights(run, cfg, ctx, dev)
        model, other, fp = weights[key]
        swapped = {}
        names = control_params(cfg, run["swap"]) if run.get("swap") else []
        for pname in names:
            path, _, leaf = pname.rpartition(".")
            mod = model.get_submodule(path)
            swapped[pname] = (mod, leaf, getattr(mod, leaf))
            setattr(mod, leaf, torch.nn.Parameter(other[pname],
                                                  requires_grad=False))
        prompts = torch.from_numpy(np.asarray(run["prompts"])).to(dev)
        for k in mesh.stats:
            mesh.stats[k] = 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        log = StepLog(mesh)
        try:
            rec = serve_record(model, cfg, prompts, run["gen"], ctx=ctx,
                               around=log)
        finally:
            for mod, leaf, mine in swapped.values():
                setattr(mod, leaf, mine)
        out.update({f"{name}.{k}": v for k, v in dict(
            rec, fingerprint=fp, steps=log.calls,
            state_bytes=nbytes(model.state_dict()),
            **mesh.stats).items()})
        if dev.type == "cuda":
            out[f"{name}.card_peak_bytes"] = max(
                log.peak, torch.cuda.max_memory_allocated(dev))
    else:
        raise ValueError(f"unknown LM case kind {kind!r}")


def run_lm_on_mesh(rank: int, world: int, runs, device=None) -> dict:
    """Rank body: each of ``runs`` (dicts with ``name``, ``kind`` and
    ``mesh``, a ``(D, M)`` shape over the whole launch) on this rank's
    ``make_test_mesh(D, M, device=device)`` and its ``make_ctx``, in
    order (the meshes made once each, in the order the runs name them,
    on every rank).  Kinds:

    * ``"ring"``: ``ring_ag_matmul``/``ring_rs_matmul`` and their
      ``_ref`` versions over the model axis, on seeded X (16 M, 32) and
      W (32, 12 M) (``dtype`` optional);
    * ``"tp"``: each primitive of ``distributed.tp`` on seeded inputs
      with a batch of ``B``;
    * ``"tp_grad"``: the backward of ``col_parallel_dense``,
      ``row_parallel_dense`` (both ``collectives``),
      ``vocab_parallel_embed`` and ``vocab_parallel_cross_entropy`` on
      seeded inputs and cotangents with a batch of ``B`` (each rank's
      cotangent its block of the whole one, over ``dp`` where the batch
      is replicated, as the loss's share is): the gradient blocks, and
      the cross-entropy's value and share;
    * ``"train"``: ``launch.train.make_train_step(cfg, ctx, ...)`` under
      ``tp_collectives=mode`` (``cfg_kw`` replaces more fields) with
      AdamW ``opt`` (``AdamWConfig`` keywords), ``warmup``,
      ``total_steps``, ``grad_accum`` and ``impl``, one step for each of
      ``batches`` (global batches, numpy), from the rank's blocks of the
      reference's tree ``params`` or from ``init_state(seed, ctx=ctx)``:
      each step's metrics, seconds and its collectives' wire seconds
      (``step_wire_s``), the first step (:func:`split_train_step`, the
      later ones through ``make_train_step``) split into its gradients
      (forward, backward and the sums over dp) and its update
      (``step_split_s``), that step's gradients and the state after the
      last step (``state_keys`` of ``params``, ``m``, ``v``, ``master``)
      as :func:`block_rows` (the rows ``keep[name]`` of the tensors
      ``keep`` names, else every tensor whole), each spec kind's part of
      the first step's global gradient norm (:func:`kind_norms`), the
      state's leaves that
      differ from ``launch.specs.train_state_struct``
      (``struct_mismatches``), the flash launches and plain calls and the
      collective counters of the steps, the card's peak over the steps;
      ``extra`` (``{what: spec}``) first takes, on the same state and
      outside the steps' counters, each spec's :func:`loss_grads` (of the
      global ``batch`` at ``aux_weight``, ``only``, ``unsum``; ``cfg_kw``
      replaces fields for it alone) under ``<name>.<what>.``: the
      gradient blocks, whether the loss had a gradient at all
      (``requires_grad``), the metrics, the f's ``unsum`` chose
      (``unsummed``), the seconds and the card's peak over the pass;
    * ``"decode_attention"``: ``decode_attention_sharded`` over the
      model axis on a seeded cache (B 2, Hq 4, Hkv 2, S 64, D 16) at
      ``cur_len``;
    * ``"serve"``: :func:`serve_record` of ``prompts`` (``gen`` greedy
      tokens) with ``cfg`` under ``tp_collectives=mode``, on this rank's
      blocks of the reference's tree ``params`` or of the model drawn
      from ``seed`` on the device (built once per ``weights`` key, and
      dropped after the last run that names it);
      ``swap`` names a control (:func:`control_params`): the run serves
      with those blocks replaced by its :func:`control_partner`'s.

    Returns the rank's blocks of each result (numpy, fp32) under
    ``"<name>.<what>"``: a train run's as above, a serve run's :func:`serve_record` (tokens,
    logits, routes and their digests, the prefill's aux, SSM states,
    timings, flash launches and plain calls), the mesh's collective
    counters, the weights' fingerprint (:func:`param_fingerprint`) and
    the card's peak; each run's ``run_s`` (its seconds on this rank, the
    weights' draw included); and ``coords``, ``transport`` and
    ``ready_at`` (``time.time()`` once the first mesh was made)."""
    import time

    from .distributed.sharding import make_ctx
    from .launch.mesh import make_test_mesh
    meshes, weights, out = {}, {}, {}
    for i, run in enumerate(runs):
        shape = tuple(run["mesh"])
        if shape not in meshes:
            meshes[shape] = make_test_mesh(*shape, device=device)
            out.setdefault("ready_at", time.time())
        mesh = meshes[shape]
        out[f"{run['name']}.coords"] = mesh.coords
        t0 = time.perf_counter()
        _lm_case(run, mesh, make_ctx(mesh), weights, out)
        out[f"{run['name']}.run_s"] = time.perf_counter() - t0
        later = {r.get("weights", "params") for r in runs[i + 1:]}
        for key in set(weights) - later:
            del weights[key]
    out["transport"] = next(iter(meshes.values())).describe()
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
