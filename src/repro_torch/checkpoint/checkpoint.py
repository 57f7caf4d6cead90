"""Sharded, atomic, async checkpointing, in the JAX package's on-disk
layout, so checkpoints move between the two packages both ways.

Layout:   <dir>/step_<N>/shard_<r>.npz  +  <dir>/step_<N>/COMMITTED

* atomic commit: shards are written to ``step_<N>.tmp`` then renamed and
  stamped with a COMMITTED marker — a crash mid-write can never produce a
  checkpoint that restore would pick up (restart-after-failure safety).
* sharded: each process writes only the leaves it is responsible for
  (process 0 of every model-parallel group in multi-host runs; the single
  process here writes shard 0 with everything, same code path).
* async: ``AsyncCheckpointer`` snapshots tensors to host, then writes
  from a background thread — training continues during the write.
* resumable: ``latest_step`` scans for the newest COMMITTED step.
* verified: a ``manifest.json`` of crc32 sums is written with every
  step; restore skips (and quarantines) a step that fails it.

A tree is nested dicts and lists/tuples of numpy arrays or tensors; a
leaf's key is its path joined by ``/`` (``"W"``, ``"opt/m"``,
``"blocks/0"``), the keys JAX's pytree paths give.  Non-native dtypes
(bf16 & friends) are stored as f32 with a ``__dtype__/<key>`` sidecar.

``save_fit_result``/``restore_fit_result`` round-trip a full
``repro_torch.api.FitResult`` — factors, trace arrays, epochs done,
timings, and the exact solver config (``KernelPolicy``, the step-size
``PowerSchedule``, an ``OwnershipSchedule``) — so
``solve(problem, cfg, warm_start=restored)`` equals the uninterrupted
run bitwise.  A bf16 result's factors (the port keeps them as their fp32
carrier) are saved with the ``"bfloat16"`` sidecar, so the JAX package
restores them as bf16; a bf16 checkpoint restores here as the fp32
carrier, bit for bit.  Config fields of the runtime types
(``TransportConfig``, ``LinkEvent``, ``DegradedLink``) encode and decode
as the JAX package's do, and so does every solver config
(``NomadConfig``, ``DsgdConfig``, ``CcdConfig``, ``AlsConfig``,
``HogwildConfig``, ``AsyncSimConfig``); a config name neither package
defines raises "unknown config".

``save_train_state``/``restore_train_state`` do the same for an LM
train state (``repro_torch.launch.train``): it is written as the JAX
package's train-state tree (layers stacked on the period axis, AdamW's
m, v and master copy beside the parameters, ``opt/step``), through
``repro_torch.convert.train_state_to_reference``, so a checkpoint
written by either package's trainer restores in the other.

On an SPMD mesh (``mesh=``, a :class:`repro_torch.launch.mesh.McMesh`;
every rank of the launch makes the same call with the same, gathered,
result): :func:`save_fit_result` and :func:`gc_checkpoints` run on the
mesh's lead rank only while the others wait for it, and
:func:`restore_fit_result` lets the lead pick (and quarantine down to)
the newest verified step, which every rank then reads.  The directory
must be on one file system that every rank sees.  The layout is the
same, so a checkpoint written on a mesh restores without one, and in
the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

class CorruptCheckpointError(RuntimeError):
    """An explicitly-requested checkpoint step failed integrity
    verification (checksum mismatch, missing array, unreadable shard)."""


def _leaves(tree, prefix: Tuple = ()) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` pairs of a tree of nested dicts and lists/tuples,
    dict keys in sorted order (as JAX flattens them)."""
    if isinstance(tree, dict):
        return [kv for key in sorted(tree)
                for kv in _leaves(tree[key], prefix + (key,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _leaves(x, prefix + (i,))]
    return [("/".join(str(p) for p in prefix), tree)]


def _unflatten(tree, values: Dict[str, Any], prefix: Tuple = ()):
    """``tree``'s structure with each leaf replaced by ``values[key]``."""
    if isinstance(tree, dict):
        return {key: _unflatten(x, values, prefix + (key,))
                for key, x in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(x, values, prefix + (i,))
                          for i, x in enumerate(tree))
    return values["/".join(str(p) for p in prefix)]


def _host(leaf) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf as numpy, and the name of its dtype when numpy has no such
    dtype of its own (the array is then its f32 carrier)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), "bfloat16"
        return t.numpy(), None
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "fiub" or arr.dtype.name == "bfloat16":
        return arr.astype(np.float32), arr.dtype.name
    return arr, None


def _flatten(tree) -> Dict[str, np.ndarray]:
    """Flatten to numpy; non-native dtypes (bf16 & friends) are stored as
    f32 with a ``__dtype__/<key>`` sidecar so np.load round-trips."""
    flat = {}
    for key, leaf in _leaves(tree):
        arr, name = _host(leaf)
        if name is not None:
            flat["__dtype__/" + key] = np.array(name)
        flat[key] = arr
    return flat


def _cast_like(arr: np.ndarray, leaf):
    """``arr`` in ``leaf``'s type and dtype: a tensor for a tensor leaf
    (bf16 from its f32 carrier, exactly), numpy otherwise."""
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(leaf.dtype)
    return np.asarray(arr).astype(np.asarray(leaf).dtype)


def _array_crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    shard_id: int = 0, n_shards: int = 1,
                    extra: Optional[dict] = None) -> str:
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp_dir = step_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)
    flat = _flatten(tree)
    np.savez(os.path.join(tmp_dir, f"shard_{shard_id}.npz"), **flat)
    # per-array checksum manifest: verified on restore, so silent
    # on-disk corruption quarantines the step instead of booting garbage
    # factors
    manifest = {"shard": f"shard_{shard_id}.npz",
                "arrays": {key: {"crc": _array_crc(arr),
                                 "dtype": str(arr.dtype),
                                 "shape": list(arr.shape)}
                           for key, arr in flat.items()}}
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    meta = {"step": step, "n_shards": n_shards, "extra": extra or {}}
    with open(os.path.join(tmp_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    # atomic commit
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)
    with open(os.path.join(step_dir, "COMMITTED"), "w") as f:
        f.write("ok")
    return step_dir


def verify_checkpoint(ckpt_dir: str, step: int,
                      shard_id: int = 0) -> bool:
    """Integrity check of one committed step against its checksum
    manifest.  ``True`` for pre-integrity checkpoints (no manifest —
    nothing to verify against, backwards compatible); ``False`` on any
    checksum mismatch, missing/misshapen array, or unreadable shard
    (a bit flip that breaks the zip structure counts as corruption,
    not as an error)."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    man_path = os.path.join(step_dir, "manifest.json")
    if not os.path.exists(man_path):
        return True
    try:
        with open(man_path) as f:
            manifest = json.load(f)
        with np.load(os.path.join(step_dir,
                                  f"shard_{shard_id}.npz")) as data:
            for key, ent in manifest["arrays"].items():
                if key not in data.files:
                    return False
                arr = data[key]
                if (list(arr.shape) != ent["shape"]
                        or str(arr.dtype) != ent["dtype"]
                        or _array_crc(arr) != ent["crc"]):
                    return False
    except Exception:
        return False
    return True


def quarantine_checkpoint(ckpt_dir: str, step: int) -> str:
    """Move a corrupted step out of the restore scan's sight:
    ``step_<N>`` → ``step_<N>.corrupt``.  The suffixed name no longer
    parses as a step (``latest_step`` and ``gc_checkpoints`` both skip
    it), so restore falls back to the newest *verified* committed step —
    but the bytes stay on disk for postmortems."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    dst = step_dir + ".corrupt"
    if os.path.exists(dst):
        shutil.rmtree(dst)
    os.rename(step_dir, dst)
    return dst


def latest_verified_step(ckpt_dir: str) -> Optional[int]:
    """Newest committed step that passes :func:`verify_checkpoint`.
    Corrupted newer steps are quarantined as a side effect, so the scan
    converges and later callers don't re-verify known-bad dirs."""
    while True:
        step = latest_step(ckpt_dir)
        if step is None or verify_checkpoint(ckpt_dir, step):
            return step
        quarantine_checkpoint(ckpt_dir, step)


def committed_steps(ckpt_dir: str) -> list:
    """Sorted step numbers of every committed checkpoint in
    ``ckpt_dir``.  ``.tmp`` staging dirs, torn step dirs without a
    COMMITTED marker and unparseable ``step_*`` names (which includes
    quarantined ``step_<N>.corrupt`` dirs) are all skipped."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_") or name.endswith(".tmp") or \
                not os.path.exists(os.path.join(ckpt_dir, name,
                                                "COMMITTED")):
            continue
        try:
            steps.append(int(name.split("_")[1]))
        except (IndexError, ValueError):
            continue
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest *committed* step in ``ckpt_dir``, or ``None``.

    This is the serving/restore boot contract: ``.tmp`` staging dirs,
    torn step dirs without a COMMITTED marker (a crash mid-write — by
    the same reasoning ``gc_checkpoints`` leaves newer torn dirs alone,
    they may be writes in flight) and unparseable ``step_*`` names are
    all skipped, so a server booting while a training process is still
    publishing always lands on a complete checkpoint (regression-tested
    in tests/test_checkpoint.py and tests/test_serve.py)."""
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def gc_checkpoints(ckpt_dir: str, keep: int, *, mesh=None) -> None:
    """Delete all but the newest ``keep`` *committed* checkpoints (plus
    any leftover ``.tmp`` write staging older than them).

    Only committed steps count toward ``keep`` and only steps strictly
    older than the ``keep``-th-newest committed one are removed: a torn
    step directory from a crash mid-write (no COMMITTED marker) must
    never push the latest restorable checkpoint out of the window — GC
    deleting the very checkpoint a crashed run would restore from is
    the classic way "atomic" checkpointing loses data anyway.  On a
    ``mesh`` only its lead rank deletes; every rank returns once it has."""
    if mesh is not None:
        return mesh.on_lead(lambda: gc_checkpoints(ckpt_dir, keep))
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    if not os.path.isdir(ckpt_dir):
        return
    committed, torn = [], []
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_"):
            continue
        base = name[:-4] if name.endswith(".tmp") else name
        try:
            step = int(base.split("_")[1])
        except (IndexError, ValueError):
            continue
        if name.endswith(".tmp"):
            torn.append((step, name))
        elif os.path.exists(os.path.join(ckpt_dir, name, "COMMITTED")):
            committed.append((step, name))
        else:
            torn.append((step, name))
    committed.sort()
    if not committed:
        return
    cutoff = committed[-keep][0] if len(committed) >= keep \
        else committed[0][0]
    for step, name in committed[:-keep] if len(committed) > keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
    for step, name in torn:
        # torn dirs below the retained window are dead weight; newer
        # ones may be a write in flight — leave them alone
        if step < cutoff:
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def restore_checkpoint(ckpt_dir: str, tree_like: Any,
                       step: Optional[int] = None, shard_id: int = 0):
    """Restore into the structure of ``tree_like`` (shapes must match).
    Returns (tree, step) or (None, None) when nothing committed exists.
    Without an explicit ``step`` the newest *verified* committed step is
    loaded (corrupted ones are quarantined and skipped); an explicitly
    requested corrupted step raises :class:`CorruptCheckpointError`."""
    if step is None:
        step = latest_verified_step(ckpt_dir)
        if step is None:
            return None, None
    elif not verify_checkpoint(ckpt_dir, step):
        raise CorruptCheckpointError(
            f"checkpoint step {step} in {ckpt_dir} failed integrity "
            f"verification")
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    values = {}
    with np.load(os.path.join(step_dir, f"shard_{shard_id}.npz")) as data:
        for key, leaf in _leaves(tree_like):
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"checkpoint array {key!r} has shape "
                                 f"{arr.shape}, want {tuple(leaf.shape)}")
            values[key] = _cast_like(arr, leaf)
    return _unflatten(tree_like, values), step


# --------------------------------------------------------------------- #
# LM train states                                                         #
# --------------------------------------------------------------------- #

def save_train_state(ckpt_dir: str, step: int, state: dict, cfg,
                     extra: Optional[dict] = None) -> str:
    """Save an LM train state (``{"params": Transformer, "opt": ...}``) in
    the JAX package's train-state layout."""
    from ..convert import train_state_to_reference
    return save_checkpoint(ckpt_dir, step,
                           train_state_to_reference(state, cfg), extra=extra)


def restore_train_state(ckpt_dir: str, state_like: dict, cfg,
                        step: Optional[int] = None):
    """Restore an LM train state saved by either package into the
    structure of ``state_like`` (shapes and dtypes must match), on its
    device.  Returns ``(state, step)``, or ``(None, None)`` when nothing
    committed exists; corrupted steps as :func:`restore_checkpoint`."""
    from ..convert import train_state_from_reference, train_state_template
    tree, step = restore_checkpoint(
        ckpt_dir, train_state_template(state_like, cfg), step=step)
    if tree is None:
        return None, None
    return train_state_from_reference(
        tree, cfg, device=state_like["params"].lm_head.w.device), step


# --------------------------------------------------------------------- #
# FitResult round-trip (matrix-completion warm-start chains)              #
# --------------------------------------------------------------------- #

def _encode_value(v):
    """JSON-encode a config field value, tagging the frozen
    hyperparameter objects so restore (here or in the JAX package) can
    rebuild them."""
    from ..core.schedule import OwnershipSchedule
    from ..core.stepsize import PowerSchedule
    from ..kernels.policy import KernelPolicy
    from ..runtime.chaos import DegradedLink, LinkEvent
    from ..runtime.transport import TransportConfig
    if isinstance(v, PowerSchedule):
        return {"__type__": "PowerSchedule", **dataclasses.asdict(v)}
    if isinstance(v, KernelPolicy):
        return {"__type__": "KernelPolicy", **dataclasses.asdict(v)}
    if isinstance(v, TransportConfig):
        return {"__type__": "TransportConfig", **dataclasses.asdict(v)}
    if isinstance(v, LinkEvent):
        return {"__type__": "LinkEvent", **dataclasses.asdict(v)}
    if isinstance(v, DegradedLink):
        return {"__type__": "DegradedLink",
                "events": [_encode_value(e) for e in v.events],
                "delay_factor": v.delay_factor, **v.rates}
    if isinstance(v, OwnershipSchedule):
        return {"__type__": "OwnershipSchedule", "p": int(v.p),
                "name": v.name,
                "table": np.asarray(v.table).tolist(),
                "active": np.asarray(v.active).astype(int).tolist()}
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, (tuple, list)):
        return {"__type__": "tuple",
                "items": [_encode_value(x) for x in v]}
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise TypeError(
        f"cannot checkpoint config field of type {type(v).__name__}")


def _decode_value(v):
    if not (isinstance(v, dict) and "__type__" in v):
        return v
    from ..core.schedule import OwnershipSchedule
    from ..core.stepsize import PowerSchedule
    from ..kernels.policy import KernelPolicy
    from ..runtime.chaos import DegradedLink, LinkEvent
    from ..runtime.transport import TransportConfig
    t = v["__type__"]
    if t == "PowerSchedule":
        return PowerSchedule(alpha=v["alpha"], beta=v["beta"])
    if t == "KernelPolicy":
        return KernelPolicy(**{k: x for k, x in v.items()
                               if k != "__type__"})
    if t == "TransportConfig":
        return TransportConfig(**{k: x for k, x in v.items()
                                  if k != "__type__"})
    if t == "LinkEvent":
        return LinkEvent(**{k: x for k, x in v.items()
                            if k != "__type__"})
    if t == "DegradedLink":
        return DegradedLink(
            [_decode_value(e) for e in v["events"]],
            drop=v["drop"], dup=v["dup"], reorder=v["reorder"],
            corrupt=v["corrupt"], delay=v["delay"],
            delay_factor=v["delay_factor"])
    if t == "OwnershipSchedule":
        return OwnershipSchedule(
            p=v["p"], table=np.asarray(v["table"], dtype=np.int32),
            active=np.asarray(v["active"], dtype=bool), name=v["name"])
    if t == "tuple":
        return tuple(_decode_value(x) for x in v["items"])
    raise ValueError(f"unknown checkpoint value tag {t!r}")


def _encode_config(cfg) -> Optional[dict]:
    if cfg is None:
        return None
    return {"__config__": type(cfg).__name__,
            "fields": {f.name: _encode_value(getattr(cfg, f.name))
                       for f in dataclasses.fields(cfg)}}


def _decode_config(d):
    if d is None:
        return None
    from .. import api
    cls = getattr(api, d["__config__"], None)
    if cls is None or not (isinstance(cls, type)
                           and issubclass(cls, api.SolverConfig)):
        raise ValueError(
            f"checkpoint names unknown config {d['__config__']!r}; the "
            f"solver configs are {sorted(c.__name__ for c in api._SOLVERS)}")
    return cls(**{k: _decode_value(v) for k, v in d["fields"].items()})


def save_fit_result(ckpt_dir: str, step: int, result, *,
                    mesh=None) -> str:
    """Checkpoint a ``repro_torch.api.FitResult`` — factors, trace,
    epochs done, timings, the exact config (step-size schedule, kernel
    policy, ownership schedule) and a replayable ``extras['schedule']``
    if one is attached — atomically, in the standard ``step_<N>`` layout.
    Array payloads go to the npz shard, everything else to
    ``meta.json``.  A ``dtype_policy="bf16"`` result's fp32-carrier
    factors are saved as bf16 (carrier plus ``"bfloat16"`` sidecar, the
    JAX package's encoding).  Non-schedule ``extras`` are not
    persisted.  On a ``mesh`` only its lead rank writes; every rank
    returns once the step is committed."""
    if mesh is not None:
        return mesh.on_lead(lambda: save_fit_result(ckpt_dir, step, result))
    W, H = result.W, result.H
    if getattr(result.config, "dtype_policy", None) == "bf16":
        W, H = (torch.as_tensor(np.asarray(x, np.float32)).bfloat16()
                for x in (W, H))
    tree = {"W": W, "H": H,
            "trace_epochs": np.asarray(result.trace_epochs),
            "trace_rmse": np.asarray(result.trace_rmse)}
    meta = {
        "epochs_done": _encode_value(result.epochs_done),
        "wall_time": float(result.wall_time),
        "virtual_time": (None if result.virtual_time is None
                         else float(result.virtual_time)),
        "solver": result.solver,
        "config": _encode_config(result.config),
    }
    sched = result.extras.get("schedule")
    if sched is not None:
        meta["extras_schedule"] = _encode_value(sched)
    return save_checkpoint(ckpt_dir, step, tree,
                           extra={"fit_result": meta})


def restore_fit_result(ckpt_dir: str, step: Optional[int] = None, *,
                       mesh=None) -> Tuple[Any, Optional[int]]:
    """Inverse of :func:`save_fit_result`: returns ``(FitResult, step)``,
    or ``(None, None)`` when no committed step exists.  The restored
    result warm-starts ``solve`` bitwise-identically to the run it was
    saved from (same factors, same ``epochs_done`` for the step-size
    schedule, same config object graph).  bf16 factors come back as
    their fp32 carrier, as the port's ``FitResult`` holds them.

    Integrity: without an explicit ``step`` the newest
    *verified* committed step is restored — a corrupted latest
    checkpoint is quarantined (``step_<N>.corrupt``) and the scan falls
    back to the previous good one, so a bit-flipped checkpoint never
    boots.  An explicitly requested corrupted step raises
    :class:`CorruptCheckpointError`.  On a ``mesh`` the lead rank alone
    scans (and quarantines), and every rank restores the step it
    found."""
    if step is None:
        step = (latest_verified_step(ckpt_dir) if mesh is None else
                mesh.on_lead(lambda: latest_verified_step(ckpt_dir)))
        if step is None:
            return None, None
    elif not verify_checkpoint(ckpt_dir, step):
        raise CorruptCheckpointError(
            f"checkpoint step {step} in {ckpt_dir} failed integrity "
            f"verification")
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "meta.json")) as f:
        meta = json.load(f)["extra"]["fit_result"]
    from ..api import FitResult
    extras = {}
    if meta.get("extras_schedule") is not None:
        extras["schedule"] = _decode_value(meta["extras_schedule"])
    config = _decode_config(meta["config"])
    with np.load(os.path.join(step_dir, "shard_0.npz")) as data:
        arrays = {key: data[key] for key in
                  ("W", "H", "trace_epochs", "trace_rmse")}
        for key in ("W", "H"):
            # the ``__dtype__/<key>`` sidecar: bf16 is kept as its f32
            # carrier, which is what the port's FitResult holds
            tag = "__dtype__/" + key
            if tag in data.files and str(data[tag]) != "bfloat16":
                raise ValueError(f"checkpoint stores {key} as "
                                 f"{data[tag]}, which the port does not "
                                 "hold")

    return FitResult(
        W=arrays["W"], H=arrays["H"],
        trace_epochs=arrays["trace_epochs"],
        trace_rmse=arrays["trace_rmse"],
        epochs_done=meta["epochs_done"],
        wall_time=meta["wall_time"],
        virtual_time=meta["virtual_time"],
        solver=meta["solver"],
        config=config,
        extras=extras), step


class AsyncCheckpointer:
    """Snapshot-to-host then write-in-background checkpointer."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()
        host_tree = _unflatten(tree, {               # snapshot now
            key: (leaf.detach().cpu().clone()
                  if isinstance(leaf, torch.Tensor) else np.array(leaf))
            for key, leaf in _leaves(tree)})

        def _write():
            save_checkpoint(self.ckpt_dir, step, host_tree, extra=extra)
            self._gc()

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def _gc(self):
        gc_checkpoints(self.ckpt_dir, self.keep)
