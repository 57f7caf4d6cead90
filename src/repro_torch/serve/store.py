"""Live factor storage for the serving tier: double-buffered,
version-stamped, hot-swappable.

The protocol, as in the JAX package:

* a **version** is one immutable :class:`FactorView` — device-resident
  ``W``/``H`` tensors, the version stamp, and the versioned catalog maps
  (``user_ids``/``item_ids``) that translate external ids to factor rows
  for exactly this version's shapes;
* :meth:`FactorStore.publish` uploads the new factors to the store's
  device once, stages them into the *inactive* slot of a two-slot
  buffer, then swaps the current-view reference — one atomic reference
  assignment, no reader lock.  Readers call :meth:`FactorStore.view` and
  get whichever complete version was current at that instant; a view
  pins its tensors however many publishes follow;
* the version stamp increases monotonically, and every query response
  carries the stamp it was scored under.

Boot paths: :meth:`FactorStore.from_fit_result` and
:meth:`FactorStore.from_checkpoint` (the newest *verified committed*
``save_fit_result`` step).  :meth:`FactorStore.attach` subscribes to a
session with ``subscribe(callback)``; the port's own
``StreamingSession`` is not ported yet (ROADMAP.md Queue 1 item 6).

The store lives on one device: ``device=None`` means ``"cuda"``.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .._device import resolve_device
from ..convert import serving_array
from ..kernels.policy import KernelPolicy

__all__ = ["FactorView", "FactorStore", "quantize_int8"]


def _host_f32(A) -> np.ndarray:
    """``A`` as a float32 numpy array (a tensor is copied to the host;
    bf16 widens exactly)."""
    if isinstance(A, torch.Tensor):
        return A.detach().to("cpu", torch.float32).numpy()
    A = np.asarray(A)
    return A.astype(np.float32)


def quantize_int8(A):
    """Per-row symmetric absmax int8 quantization: ``A ~= q * scale[:,
    None]`` with ``q`` int8 in [-127, 127] and ``scale`` f32.  All-zero
    rows get scale 1 (their q is all-zero anyway), so dequantization
    never divides by or multiplies with a zero scale.  Numpy in, numpy
    out, the JAX package's arithmetic step for step."""
    A = _host_f32(A)
    absmax = np.max(np.abs(A), axis=1)
    scale = np.where(absmax == 0, 1.0, absmax / 127.0).astype(np.float32)
    q = np.clip(np.rint(A / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


def _finite(A) -> bool:
    if isinstance(A, torch.Tensor):
        return not A.is_floating_point() or bool(torch.isfinite(A).all())
    A = np.asarray(A)
    if A.dtype.kind not in "iub":
        A = A.astype(np.float32)
    return not np.issubdtype(A.dtype, np.floating) or bool(
        np.isfinite(A).all())


@dataclasses.dataclass(frozen=True)
class FactorView:
    """One immutable published factor version.

    ``W``/``H`` are tensors on the store's device (uploaded once at
    publish, shared by every query on this version).  ``user_ids``/
    ``item_ids`` map factor rows to external catalog ids; ``None`` means
    the identity.

    Optional per-version payloads:

    * ``w_scale``/``h_scale`` — per-row dequantization scales (f32
      tensors) when the version was published with ``quantize='int8'``;
    * ``rated_indptr``/``rated_items`` — a CSR map (numpy) of the items
      each user row had already rated at publish time, consumed by the
      exact candidate filter (``topk_scores_filtered``).
    """
    version: int
    W: torch.Tensor                     # (m, k) user factors
    H: torch.Tensor                     # (n, k) item factors
    user_ids: Optional[np.ndarray] = None   # (m,) row -> external user id
    item_ids: Optional[np.ndarray] = None   # (n,) row -> external item id
    w_scale: Optional[torch.Tensor] = None  # (m,) int8 dequant scales
    h_scale: Optional[torch.Tensor] = None  # (n,) int8 dequant scales
    rated_indptr: Optional[np.ndarray] = None   # (m + 1,) CSR offsets
    rated_items: Optional[np.ndarray] = None    # (total_nnz,) item rows

    @property
    def quantized(self) -> bool:
        return self.w_scale is not None

    def rated_for(self, rows) -> list:
        """Item rows already rated by each of ``rows`` (factor-row
        indices) under this version's rated map — empty arrays when no
        map was published."""
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        if self.rated_indptr is None:
            empty = np.zeros(0, dtype=np.int64)
            return [empty for _ in rows]
        ptr, items = self.rated_indptr, self.rated_items
        return [items[ptr[r]: ptr[r + 1]] for r in rows]

    @property
    def m(self) -> int:
        return int(self.W.shape[0])

    @property
    def n(self) -> int:
        return int(self.H.shape[0])

    @property
    def k(self) -> int:
        return int(self.W.shape[1])

    def user_rows(self, users: Sequence[int]) -> np.ndarray:
        """Factor rows for external user ids under *this* version's
        catalog map.  Unknown ids raise ``KeyError``."""
        users = np.atleast_1d(np.asarray(users, dtype=np.int64))
        if self.user_ids is None:
            bad = (users < 0) | (users >= self.m)
            if bad.any():
                raise KeyError(
                    f"unknown user ids {users[bad].tolist()} (version "
                    f"{self.version} has m={self.m} users)")
            return users
        rows = np.searchsorted(self._user_sorted, users)
        rows = np.clip(rows, 0, len(self._user_sorted) - 1)
        hit = self._user_sorted[rows] == users
        if not hit.all():
            raise KeyError(
                f"unknown user ids {users[~hit].tolist()} in version "
                f"{self.version}")
        return self._user_order[rows]

    def item_catalog(self, rows: np.ndarray) -> np.ndarray:
        """External item ids for factor rows (identity when unmapped)."""
        if self.item_ids is None:
            return rows
        return np.asarray(self.item_ids)[rows]

    def __post_init__(self):
        for name in ("W", "H", "w_scale", "h_scale"):
            t = getattr(self, name)
            if t is not None and not isinstance(t, torch.Tensor):
                object.__setattr__(self, name, serving_array(t, "cpu"))
        for name in ("user_ids", "item_ids"):
            ids = getattr(self, name)
            if ids is None:
                continue
            ids = np.asarray(ids, dtype=np.int64)
            want = self.m if name == "user_ids" else self.n
            if ids.shape != (want,):
                raise ValueError(
                    f"{name} must have shape ({want},), got {ids.shape}")
            if len(np.unique(ids)) != len(ids):
                raise ValueError(f"{name} contains duplicate ids")
            object.__setattr__(self, name, ids)
        if self.user_ids is not None:
            order = np.argsort(self.user_ids, kind="stable")
            object.__setattr__(self, "_user_order", order)
            object.__setattr__(self, "_user_sorted", self.user_ids[order])
        if (self.w_scale is None) != (self.h_scale is None):
            raise ValueError(
                "w_scale and h_scale must be published together")
        for name, want in (("w_scale", self.m), ("h_scale", self.n)):
            sc = getattr(self, name)
            if sc is not None and tuple(sc.shape) != (want,):
                raise ValueError(
                    f"{name} must have shape ({want},), got "
                    f"{tuple(sc.shape)}")
        if (self.rated_indptr is None) != (self.rated_items is None):
            raise ValueError(
                "rated_indptr and rated_items must be published together")
        if self.rated_indptr is not None:
            ptr = np.asarray(self.rated_indptr, dtype=np.int64)
            items = np.asarray(self.rated_items, dtype=np.int64)
            if ptr.shape != (self.m + 1,):
                raise ValueError(
                    f"rated_indptr must have shape ({self.m + 1},), got "
                    f"{ptr.shape}")
            if np.any(np.diff(ptr) < 0) or ptr[0] != 0 \
                    or ptr[-1] != len(items):
                raise ValueError("rated_indptr is not a valid CSR offset "
                                 "array for rated_items")
            if len(items) and (items.min() < 0 or items.max() >= self.n):
                raise ValueError(
                    f"rated_items contains rows outside [0, {self.n})")
            object.__setattr__(self, "rated_indptr", ptr)
            object.__setattr__(self, "rated_items", items)


class FactorStore:
    """Double-buffered, version-stamped factors for serving, on one
    device (``device=None`` means ``"cuda"``).

    Writers (one at a time — publishes are serialized by a lock) stage
    into the inactive buffer slot; readers take the current
    :class:`FactorView` with one un-locked reference read.
    """

    def __init__(self, device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._buffers = [None, None]    # the two publish slots
        self._view: Optional[FactorView] = None

    # ----------------------------------------------------------------- #
    # Writer side                                                        #
    # ----------------------------------------------------------------- #

    def publish(self, W, H, *, user_ids=None, item_ids=None,
                quantize: Optional[str] = None, rated=None,
                dtype: Optional[torch.dtype] = None) -> FactorView:
        """Stage ``(W, H)`` as the next version and swap it live.  The
        factors (numpy arrays or tensors) are uploaded to the store's
        device here, once, so queries never pay the transfer; ``dtype``
        casts them on the way (``None`` keeps theirs).  Returns the
        published view.

        ``quantize='int8'`` stores the factors as per-row-absmax int8
        with f32 dequantization scales (``w_scale``/``h_scale``).
        ``rated`` is an optional ``(user_rows, item_rows)`` COO pair of
        already-rated coordinates, compiled to the per-version CSR map
        the exact candidate filter consumes."""
        if quantize not in (None, "int8"):
            raise ValueError(
                f"quantize must be None or 'int8', got {quantize!r}")
        # integrity gate: a diverged round's factors must never go live.
        # Checked before quantization (int8 of NaN is garbage with no NaN
        # left to detect).
        for name, A in (("W", W), ("H", H)):
            if not _finite(A):
                raise ValueError(
                    f"refusing to publish non-finite {name}; quarantine "
                    "the diverged round instead")
        w_scale = h_scale = None
        if quantize == "int8":
            W, w_scale = quantize_int8(W)
            H, h_scale = quantize_int8(H)
            w_scale = serving_array(w_scale, self.device)
            h_scale = serving_array(h_scale, self.device)
            dtype = None
        W = serving_array(W, self.device, dtype)
        H = serving_array(H, self.device, dtype)
        if W.ndim != 2 or H.ndim != 2 or W.shape[1] != H.shape[1]:
            raise ValueError(
                f"W and H must be (m, k)/(n, k) with one k, got "
                f"{tuple(W.shape)}/{tuple(H.shape)}")
        rated_indptr = rated_items = None
        if rated is not None:
            u_rows = np.asarray(rated[0], dtype=np.int64)
            i_rows = np.asarray(rated[1], dtype=np.int64)
            if u_rows.shape != i_rows.shape:
                raise ValueError(
                    f"rated user/item arrays must match: "
                    f"{u_rows.shape} vs {i_rows.shape}")
            m = int(W.shape[0])
            order = np.lexsort((i_rows, u_rows))
            u_rows, i_rows = u_rows[order], i_rows[order]
            rated_indptr = np.zeros(m + 1, dtype=np.int64)
            np.add.at(rated_indptr, u_rows + 1, 1)
            rated_indptr = np.cumsum(rated_indptr)
            rated_items = i_rows
        with self._lock:
            version = 0 if self._view is None else self._view.version + 1
            view = FactorView(version=version, W=W, H=H,
                              user_ids=user_ids, item_ids=item_ids,
                              w_scale=w_scale, h_scale=h_scale,
                              rated_indptr=rated_indptr,
                              rated_items=rated_items)
            self._buffers[version % 2] = view
            self._view = view           # the atomic swap readers observe
        return view

    def publish_result(self, result, *, quantize: Optional[str] = None,
                       rated="auto") -> FactorView:
        """Publish a ``FitResult``'s factors, in the storage dtype of its
        config's ``dtype_policy`` (a bf16 run's fp32 carrier goes live as
        bf16, as the JAX package serves it).

        ``rated="auto"`` (default) publishes the rated-item map from the
        training problem the result carries (``extras["problem"]``) when
        one is present; pass ``None`` to skip the map, or an explicit
        ``(user_rows, item_rows)`` pair / ``MCProblem`` to override."""
        if rated == "auto":
            rated = result.extras.get("problem")
        if rated is not None and hasattr(rated, "rows"):
            rated = (rated.rows, rated.cols)    # an MCProblem
        dtype_policy = getattr(result.config, "dtype_policy", None)
        dtype = (None if dtype_policy is None
                 else KernelPolicy(dtype_policy=dtype_policy).storage_dtype)
        return self.publish(result.W, result.H, quantize=quantize,
                            rated=rated, dtype=dtype)

    def attach(self, session):
        """Subscribe to a streaming session (anything with
        ``subscribe(callback)``): every round's ``FitResult`` is
        published as the next version the moment the round completes.
        Returns the callback (pass it to ``session.unsubscribe`` to
        detach)."""
        return session.subscribe(self.publish_result)

    # ----------------------------------------------------------------- #
    # Reader side                                                        #
    # ----------------------------------------------------------------- #

    def view(self) -> FactorView:
        """The current version — one consistent, immutable snapshot."""
        view = self._view
        if view is None:
            raise RuntimeError(
                "FactorStore has no published factors yet; call "
                "publish()/publish_result() or boot from_checkpoint()")
        return view

    @property
    def version(self) -> Optional[int]:
        view = self._view
        return None if view is None else view.version

    # ----------------------------------------------------------------- #
    # Boot                                                               #
    # ----------------------------------------------------------------- #

    @classmethod
    def from_fit_result(cls, result, device: Optional[
            Union[str, torch.device]] = None) -> "FactorStore":
        store = cls(device)
        store.publish_result(result)
        return store

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, step: Optional[int] = None,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> "FactorStore":
        """Boot from the newest verified *committed* ``save_fit_result``
        step in ``ckpt_dir`` (torn in-flight step dirs are skipped, and a
        corrupted newest step is quarantined and skipped)."""
        from ..checkpoint import restore_fit_result
        result, found = restore_fit_result(ckpt_dir, step)
        if result is None:
            raise FileNotFoundError(
                f"no committed checkpoint in {ckpt_dir!r}")
        store = cls.from_fit_result(result, device)
        store.boot_step = found
        return store
