"""The worker mesh of NOMAD's SPMD executor and the LM's (data, model)
mesh over ``torch.distributed``, and a launcher that starts one process
per rank.

The JAX package's ``launch/mesh.py::make_mc_mesh`` builds a 1-D device
mesh with the axis ``"workers"`` for ``shard_map``.  Here one process is
one worker: :func:`make_mc_mesh` makes a :class:`McMesh` of ``p``
workers over ranks of the default process group (the launch): by
default its first ``p`` ranks, or the global ranks ``ranks=`` names, in
worker order, so that an elastic run keeps one launch while workers
leave and join (:func:`ranks_after`).  A launched rank outside the mesh
holds no worker; it still takes part in every collective, which go over
the whole launch with such a rank adding nothing (zeros, or ``True``),
so no sub-group is ever created.  Every rank of the launch makes the
same calls in the same order (SPMD over the host code).  The mesh
carries the rank's worker, ``p``, the rank's device and the transport
its H blocks travel by.  The transport is chosen once, from the
topology of the launch, and never changes:

* ``"nccl"`` — every rank has a card of its own (``cuda:rank %
  device_count``): NCCL point-to-point between the cards;
* ``"gloo-staged"`` — ranks share a card (more ranks than cards; NCCL
  refuses two ranks on one GPU): gloo, each block copied through a
  pinned host buffer on a copy stream;
* ``"gloo"`` — ``device="cpu"``: gloo on CPU tensors.

The LM's mesh (:class:`LmMesh`, :func:`make_test_mesh`, the JAX
package's ``make_test_mesh``) lays the launch's ranks out row-major on
``(data, model)`` (or ``(pod, data, model)``) axes and makes one process
group per data row and per model column (and one over all ranks), every
rank in the same order; its collectives take the axes they run over.
Its transport is :func:`choose_transport`'s, as above.

:class:`DryMesh` is one rank's view of an LM mesh of any size with no
process group, on the ``meta`` device: its collectives return what an
:class:`LmMesh`'s would (the same code, the same shapes and counters)
and record each one instead of sending it, for the dry-run
(``launch.dryrun``).  :func:`production_axes` names the port's
production mesh on H100 nodes, and the module holds the H100's peak
rates (:data:`PEAK_FLOPS_BF16`, :data:`HBM_BW`, :data:`NVLINK_BW`, ...):
the JAX package's ``launch/mesh.py`` holds a TPU v5e's.

:func:`spawn_ranks` runs a function in ``p`` processes started with the
``spawn`` method (never ``fork``), each in a process group over a
``file://`` store, and returns what each rank returned; it kills every
rank and raises, naming the rank, on a failure or a timeout.  Ranks
started another way (``torchrun``) initialise the group themselves,
with the backend :func:`choose_transport` names, and call
:func:`make_mc_mesh`.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

AXIS = "workers"
#: the process-group backend of each transport
BACKEND = {"nccl": "nccl", "gloo-staged": "gloo", "gloo": "gloo"}
#: environment variable naming a directory every rank of the launch sees
#: (:func:`spawn_ranks` sets it to its own temporary directory)
SHARED_DIR_ENV = "REPRO_TORCH_SHARED_DIR"

Device = Optional[Union[str, torch.device]]


def choose_transport(p: int, rank: int, device: Device = None
                     ) -> Tuple[str, torch.device]:
    """``(transport, device)`` of rank ``rank`` of ``p``: ``"cpu"`` means
    gloo on CPU tensors; otherwise (``None`` or ``"cuda"``) the rank
    takes ``cuda:rank % device_count``, over NCCL when every rank has a
    card of its own and over staged gloo when ranks share one.  Raises
    when CUDA is asked for and absent: no fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return "gloo", dev
    if dev.type != "cuda":
        raise RuntimeError(f"unsupported device {str(dev)!r}: the mesh runs "
                           "on 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the mesh's device is CUDA (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' for "
            "gloo on the CPU")
    n = torch.cuda.device_count()
    if dev.index is None:
        dev = torch.device("cuda", rank % n)
    return ("nccl" if n >= p else "gloo-staged"), dev


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the collectives carry it: 16-bit floats as int16 (their
    bytes, exactly), everything else as it is."""
    return t.view(torch.int16) if t.element_size() == 2 else t


def _flat(t: torch.Tensor) -> torch.Tensor:
    """A contiguous ``t`` as a flat view of its bytes (gloo carries no
    16-bit integers; bytes travel exactly in any type)."""
    return t.reshape(-1).view(torch.uint8)


class Transfer:
    """One block's hop: send ``send`` to worker ``dst`` and receive worker
    ``src``'s block into ``recv`` (never the same tensor); the peers are
    reached at their global ranks (``mesh.ranks``).  Built by
    :meth:`McMesh.transfer`; under ``"gloo-staged"`` the send is copied to
    a pinned host buffer on the mesh's copy stream first and posted by
    :meth:`post`, so that the caller can queue more work on the card
    before the host waits for that copy.  ``stage_s`` and ``wire_s`` are
    the host seconds spent waiting on the copies and on the network."""

    def __init__(self, mesh: "McMesh", send, dst: int, recv, src: int,
                 tag: int):
        self.dst, self.src, self.tag = dst, src, tag
        self.peers = mesh.ranks[dst], mesh.ranks[src]
        self.recv, self.works = recv, None
        self.stage_s = self.wire_s = 0.0
        if mesh.transport == "gloo-staged":
            self.host_send = mesh.pinned("send", tag, send)
            self.host_recv = mesh.pinned("recv", tag, recv)
            cs = mesh.copy_stream()
            cs.wait_stream(torch.cuda.current_stream(mesh.device))
            with torch.cuda.stream(cs):
                self.host_send.copy_(send, non_blocking=True)
            self.copied = cs.record_event()
        else:
            self.host_send = self.host_recv = None
            self._post(send, recv)

    def _post(self, send, recv) -> None:
        t0 = time.perf_counter()
        self.works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, _wire(send), self.peers[0], tag=self.tag),
            dist.P2POp(dist.irecv, _wire(recv), self.peers[1],
                       tag=self.tag)])
        self.wire_s += time.perf_counter() - t0

    def post(self) -> None:
        """Post the send and the receive, once the staged copy is done."""
        if self.works is None:
            t0 = time.perf_counter()
            self.copied.synchronize()
            self.stage_s += time.perf_counter() - t0
            self._post(self.host_send, self.host_recv)

    def wait(self) -> None:
        """Wait for both ends; the received block is then in ``recv``."""
        self.post()
        t0 = time.perf_counter()
        for w in self.works:
            w.wait()
        self.wire_s += time.perf_counter() - t0
        if self.host_recv is not None:
            t0 = time.perf_counter()
            self.recv.copy_(self.host_recv)      # returns once it landed
            self.stage_s += time.perf_counter() - t0


@dataclasses.dataclass(eq=False)
class McMesh:
    """The 1-D worker mesh as one rank of the launch sees it: ``p``, this
    rank's worker ``rank`` (``None`` when it holds none), its device, the
    transport (:func:`choose_transport`), the global rank of each worker
    (``ranks``, in worker order), the launch's size (``world``) and this
    process's global rank (``me``).  ``shared_dir``, when set, is a
    directory every rank sees (where a packing built once is handed to
    the others).  ``axis_names`` is the JAX mesh's."""
    p: int
    rank: Optional[int]
    device: torch.device
    transport: str
    ranks: Tuple[int, ...] = ()
    world: int = 0
    me: int = 0
    shared_dir: Optional[str] = None
    axis_names: Tuple[str, ...] = (AXIS,)
    _pinned: Dict[tuple, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)
    _stream: Optional[torch.cuda.Stream] = dataclasses.field(
        default=None, repr=False)

    def __post_init__(self):
        self.ranks = tuple(self.ranks) or tuple(range(self.p))
        self.world = self.world or self.p

    @property
    def member(self) -> bool:
        """Whether this rank holds a worker of the mesh."""
        return self.rank is not None

    @property
    def lead(self) -> bool:
        """Whether this rank is the mesh's lowest global rank: the one
        that writes what the launch shares (checkpoints, packings)."""
        return self.me == min(self.ranks)

    def describe(self) -> str:
        ranks = (f"{self.p} ranks" if self.p == self.world
                 else f"{self.p} of {self.world} ranks")
        if self.transport == "gloo":
            return f"gloo, {ranks} on the CPU"
        n = torch.cuda.device_count()
        cards = f"{n} card{'s' if n > 1 else ''}"
        if self.transport == "nccl":
            return f"nccl, {ranks} on {cards}"
        return f"gloo, staged, {ranks} on {cards}"

    # -- staging ------------------------------------------------------ #
    def pinned(self, role: str, tag: int, like: torch.Tensor
               ) -> torch.Tensor:
        """A pinned host buffer shaped like ``like``, one per (role, tag,
        shape, dtype), kept for the mesh's life."""
        key = (role, tag, tuple(like.shape), like.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(
                like.shape, dtype=like.dtype, pin_memory=True)
        return buf

    def copy_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    # -- point-to-point and collectives -------------------------------- #
    def transfer(self, send, dst: int, recv, src: int, tag: int = 0
                 ) -> Transfer:
        """Start one hop to worker ``dst`` from worker ``src``
        (:class:`Transfer`); ``tag`` tells apart the hops that are in
        flight together (the sub-blocks of a step)."""
        if send.data_ptr() == recv.data_ptr():
            raise ValueError("a hop never sends and receives one tensor")
        return Transfer(self, send, dst, recv, src, tag)

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.transport == "nccl" else t.detach().cpu()

    def all_gather(self, t: torch.Tensor, device: Device = "cpu"
                   ) -> torch.Tensor:
        """``(p, *t.shape)``: every worker's ``t``, in worker order, on
        ``device``.  Collective over the launch: a rank outside the mesh
        passes a tensor of the same shape, which is dropped."""
        src = self._host(t.contiguous())
        out = torch.empty((self.world, *src.shape), dtype=src.dtype,
                          device=src.device)
        if self.transport == "nccl":
            dist.all_gather_into_tensor(_wire(out), _wire(src))
        else:
            dist.all_gather([_wire(o) for o in out.unbind(0)], _wire(src))
        if self.ranks != tuple(range(self.world)):
            out = out[list(self.ranks)]
        return out.to(device)

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the launch, in place (a rank outside the mesh
        passes zeros)."""
        buf = self._host(t)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        if buf is not t:
            t.copy_(buf)
        return t

    def all_true(self, flag: bool) -> bool:
        """``flag`` AND-reduced over the launch (a rank outside the mesh
        passes ``True``)."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=self.device if self.transport == "nccl"
                         else "cpu")
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return bool(t.item())

    def barrier(self) -> None:
        """Wait for every rank of the launch."""
        dist.barrier()

    def on_lead(self, fn: Callable[[], Any]) -> Any:
        """``fn()`` run on the :attr:`lead` rank only, its (picklable)
        result given to every rank of the launch; when it raises, every
        rank raises (``RuntimeError`` naming the lead's error), so no
        rank waits for a result that never comes."""
        box: List[Any] = [None]
        if self.lead:
            try:
                box[0] = (True, fn())
            except Exception as e:              # handed to every rank
                box[0] = (False, f"{type(e).__name__}: {e}")
        dist.broadcast_object_list(box, src=min(self.ranks))
        ok, val = box[0]
        if not ok:
            raise RuntimeError(f"on the mesh's lead (rank "
                               f"{min(self.ranks)}): {val}")
        return val

    def ranks_after(self, leave: Sequence[int] = (), join: int = 0
                    ) -> Tuple[int, ...]:
        """:func:`ranks_after` of this mesh's ranks."""
        return ranks_after(self.ranks, self.world, leave=leave, join=join)


def ranks_after(ranks: Sequence[int], world: int, *,
                leave: Sequence[int] = (), join: int = 0
                ) -> Tuple[int, ...]:
    """The global ranks of the workers after a worker-set change, in the
    new worker order (the order ``TransitionSchedule`` numbers them in):
    the survivors keep their ranks, compacted (the workers ``leave``
    drop out), and ``join`` new workers take the lowest ranks of the
    launch's ``world`` that hold none.  After worker 3 of 8 leaves, worker
    4 becomes worker 3 on global rank 4; a worker that joins then lands
    on the idle rank 3."""
    gone = {int(q) for q in leave}
    kept = tuple(int(r) for q, r in enumerate(ranks) if q not in gone)
    idle = [r for r in range(world) if r not in kept]
    if join > len(idle):
        raise ValueError(f"{join} workers cannot join: {len(idle)} of the "
                         f"launch's {world} ranks hold no worker")
    return kept + tuple(idle[:join])


def make_mc_mesh(p: int, *, ranks: Optional[Sequence[int]] = None,
                 device: Device = None,
                 shared_dir: Optional[str] = None) -> McMesh:
    """The worker mesh of ``p`` workers over the default process group
    (axis ``"workers"``), as this rank sees it: worker ``q`` runs on
    global rank ``ranks[q]`` (default: the first ``p`` ranks), on
    ``device`` (:func:`choose_transport`, for the launch's size).
    Collective: every rank of the launch calls it with the same ``p``
    and ``ranks``, members or not.  ``shared_dir`` (default: the
    :data:`SHARED_DIR_ENV` environment variable) is a directory every
    rank sees.  Raises if no process group is initialised, if it has
    fewer than ``p`` ranks, if ``ranks`` are not ``p`` distinct ranks of
    it, or if its backend is not the transport's."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mc_mesh needs an initialised default process group "
            "(torch.distributed.init_process_group, spawn_ranks or "
            "torchrun)")
    world = dist.get_world_size()
    if world < p:
        raise ValueError(f"the process group has {world} ranks, the mesh "
                         f"wants p={p}")
    ranks = tuple(range(p)) if ranks is None else tuple(int(r)
                                                         for r in ranks)
    if len(ranks) != p or len(set(ranks)) != p or not all(
            0 <= r < world for r in ranks):
        raise ValueError(f"ranks={ranks} are not {p} distinct ranks of the "
                         f"process group's {world}")
    me = dist.get_rank()
    transport, dev = choose_transport(world, me, device)
    backend = dist.get_backend()
    if backend != BACKEND[transport]:
        raise RuntimeError(f"transport {transport!r} needs the "
                           f"{BACKEND[transport]!r} backend, the process "
                           f"group runs {backend!r}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.barrier()      # every rank holds its mesh before the first hop
    return McMesh(p=p, rank=ranks.index(me) if me in ranks else None,
                  device=dev, transport=transport, ranks=ranks, world=world,
                  me=me, shared_dir=shared_dir or os.environ.get(
                      SHARED_DIR_ENV))


# ---------------------------------------------------------------------- #
# The LM's (data, model) mesh                                              #
# ---------------------------------------------------------------------- #

Axes = Union[str, Tuple[str, ...]]

#: the collectives' kinds, by the names XLA's HLO gives them (the JAX
#: package's ``launch/hlo_analysis.py`` counts them under these names)
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
#: the counters of :attr:`LmMesh.stats` that a :class:`DryMesh` keeps as
#: the real mesh does
COUNTERS = ("calls", "bytes_in", "bytes_out")

# NVIDIA H100 SXM5 80GB, per GPU.  The tensor-core and vector peaks and
# the HBM rate are the H100 data sheet's (dense, no sparsity); NVLink 4
# is 18 links of 50 GB/s both ways (900 GB/s, the same sheet), half of it
# each way; between nodes each GPU has one 400 Gb/s NDR InfiniBand port
# (the DGX H100 reference architecture), 50 GB/s each way.
#: dense bf16/fp16 tensor-core FLOP/s (fp32 accumulate)
PEAK_FLOPS_BF16 = 989e12
#: fp32 FLOP/s outside the tensor cores
PEAK_FLOPS_FP32 = 67e12
#: HBM3 bytes/s
HBM_BW = 3.35e12
#: NVLink bytes/s each way, within a node
NVLINK_BW = 450e9
#: InfiniBand bytes/s each way, between nodes
NET_BW = 50e9


def production_axes(multi_pod: bool = False) -> Dict[str, int]:
    """The port's production LM mesh on H100 nodes of 8 GPUs: tp 8, the
    model axis within one node's NVLink domain, and dp over 32 nodes
    (256 GPUs), or two pods of that (512).  The JAX package's
    ``make_production_mesh`` is a TPU v5e pod's (16, 16) and (2, 16,
    16); :class:`DryMesh` takes those too."""
    axes = {"data": 32, "model": 8}
    return {"pod": 2, **axes} if multi_pod else axes


@dataclasses.dataclass(eq=False)
class LmMesh:
    """A mesh of ranks for the LM, as one rank sees it: the axes
    (``axis_names``, the model axis last) and their sizes (``shape``),
    this rank's coordinate on each (``coords``; global rank = the
    row-major index of ``coords``, so the ranks of one model group are
    neighbours), its device and the transport (:func:`choose_transport`).
    ``groups`` holds, for the dp axes, the model axis and all axes, the
    process group of the ranks that share this rank's other coordinates
    (none where that group has one rank).

    The collectives (:meth:`all_reduce`, :meth:`all_gather`,
    :meth:`reduce_scatter`, :meth:`all_to_all`, :meth:`send_recv`) run
    over the group of the ``axes`` they are given; over one rank they
    return their input.  Under ``"gloo-staged"`` every operand is copied
    to a pinned host buffer and the result back; where nothing is summed
    the tensors travel as their bytes.  ``stats`` counts the calls, the
    bytes handed in and out, and the host seconds of staging (``stage_s``),
    of pinning new staging buffers (``pin_s``) and of the collective
    itself (``wire_s``; under ``"nccl"`` the time to enqueue it)."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]
    device: torch.device
    transport: str
    groups: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict, repr=False)
    stats: Dict[str, float] = dataclasses.field(default_factory=lambda: dict(
        calls=0, bytes_in=0, bytes_out=0, stage_s=0.0, pin_s=0.0,
        wire_s=0.0))
    _pinned: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)

    def _key(self, axes: Axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if not set(axes) <= set(self.axis_names):
            raise ValueError(f"axes {axes} are not all of the mesh's "
                             f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axes: Axes) -> int:
        """The number of ranks along ``axes`` (a name or a tuple)."""
        return int(np.prod([self.shape[self.axis_names.index(a)]
                            for a in self._key(axes)]))

    def index(self, axes: Axes) -> int:
        """This rank's row-major index along ``axes``: its rank in their
        group (``P(("pod", "data"))`` numbers shards the same way)."""
        key = self._key(axes)
        pos = [self.axis_names.index(a) for a in key]
        return int(np.ravel_multi_index([self.coords[i] for i in pos],
                                        [self.shape[i] for i in pos]))

    def describe(self) -> str:
        shape = "x".join(map(str, self.shape))
        names = ",".join(self.axis_names)
        if self.transport == "gloo":
            return f"gloo, ({names})={shape} on the CPU"
        n = torch.cuda.device_count()
        cards = f"{n} card{'s' if n > 1 else ''}"
        staged = "" if self.transport == "nccl" else " staged,"
        return (f"{BACKEND[self.transport]},{staged} ({names})={shape} "
                f"on {cards}")

    # -- staging ---------------------------------------------------------
    def _group(self, key):
        if key not in self.groups:
            raise RuntimeError(f"the mesh holds no process group for {key} "
                               "(a mesh made without one spans one rank)")
        return self.groups[key]

    def _buffer(self, role: str, shape, dtype) -> torch.Tensor:
        """A pinned host buffer of ``shape`` and ``dtype``: a view of the
        role's one pinned arena, kept for the mesh's life and pinned anew
        only when a larger one is asked for, so that a run of many shapes
        (a training step's gathers and reduce-scatters) pins each role's
        largest once.  Pinning is slow (about a second a GB where four
        ranks share a host), and a collective's result is copied to the
        device before it returns, so the next call may reuse the arena."""
        n = int(np.prod(shape)) * dtype.itemsize
        arena = self._pinned.get(role)
        if arena is None or arena.numel() < n:
            # release the smaller arena before pinning its successor
            self._pinned.pop(role, None)
            del arena
            t0 = time.perf_counter()
            arena = self._pinned[role] = torch.empty(n, dtype=torch.uint8,
                                                     pin_memory=True)
            self.stats["pin_s"] += time.perf_counter() - t0
        return arena[:n].view(dtype).view(tuple(shape))

    def _host(self, t: torch.Tensor, role: str) -> torch.Tensor:
        """``t`` where the collective reads it: a pinned host copy under
        ``"gloo-staged"``, else ``t`` itself (contiguous)."""
        t = t.contiguous()
        if self.transport != "gloo-staged":
            return t
        buf = self._buffer(role, t.shape, t.dtype)
        t0 = time.perf_counter()
        buf.copy_(t)
        self.stats["stage_s"] += time.perf_counter() - t0
        return buf

    def _back(self, host: torch.Tensor) -> torch.Tensor:
        """A collective's result on this rank's device."""
        if self.transport != "gloo-staged":
            return host
        t0 = time.perf_counter()
        out = host.to(self.device)
        self.stats["stage_s"] += time.perf_counter() - t0
        return out

    def _run(self, kind: str, key: Tuple[str, ...], fn, inp: torch.Tensor,
             out: torch.Tensor) -> None:
        """Run the collective ``fn`` of ``kind`` (:data:`KINDS`) over the
        group of ``key`` and count it in :attr:`stats`."""
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            # newer torch names all_gather_into_tensor/reduce_scatter_tensor
            # otherwise; these names hold on every version the port runs on
            warnings.simplefilter("ignore", FutureWarning)
            fn()
        self.stats["wire_s"] += time.perf_counter() - t0
        self._count(inp, out)

    def _count(self, inp: torch.Tensor, out: torch.Tensor
               ) -> Tuple[int, int]:
        """Count one collective of ``inp`` and ``out`` in :attr:`stats`;
        returns their bytes."""
        b_in = inp.numel() * inp.element_size()
        b_out = out.numel() * out.element_size()
        self.stats["calls"] += 1
        self.stats["bytes_in"] += b_in
        self.stats["bytes_out"] += b_out
        return b_in, b_out

    # -- collectives -----------------------------------------------------
    def all_reduce(self, t: torch.Tensor, axes: Axes, op: str = "sum"
                   ) -> torch.Tensor:
        """``t`` summed (``op="sum"``) or maxed (``"max"``) over the group
        of ``axes``, in ``t``'s dtype; a new tensor."""
        key = self._key(axes)
        if self.size(key) == 1:
            return t
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        buf = self._host(t, "reduce")
        if buf is t:
            buf = t.clone()
        self._run("all-reduce", key, lambda: dist.all_reduce(
            buf, op=red, group=self._group(key)), buf, buf)
        return self._back(buf)

    def all_gather(self, t: torch.Tensor, axes: Axes, dim: int = 0
                   ) -> torch.Tensor:
        """Every rank's ``t`` of the group of ``axes``, concatenated along
        ``dim`` in group order."""
        key = self._key(axes)
        n = self.size(key)
        if n == 1:
            return t
        src = self._host(t, "gather_in")
        out = self._out((n, *src.shape), src, "gather_out")
        self._run("all-gather", key, lambda: dist.all_gather_into_tensor(
            _flat(out), _flat(src), group=self._group(key)), src, out)
        dim %= t.dim()
        out = self._back(out).movedim(0, dim)
        shape = list(t.shape)
        shape[dim] *= n
        return out.reshape(shape)

    def reduce_scatter(self, t: torch.Tensor, axes: Axes, dim: int = 0
                       ) -> torch.Tensor:
        """``t`` summed over the group of ``axes`` (in ``t``'s dtype), this
        rank's block of it along ``dim``."""
        key = self._key(axes)
        n = self.size(key)
        if n == 1:
            return t
        dim %= t.dim()
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} is not "
                             f"divisible by the group's {n} ranks")
        src = self._host(t.movedim(dim, 0), "scatter_in")
        out = self._out((src.shape[0] // n, *src.shape[1:]), src,
                        "scatter_out")
        self._run("reduce-scatter", key, lambda: dist.reduce_scatter_tensor(
            out.view(-1), src.view(-1), group=self._group(key)), src, out)
        return self._back(out).movedim(0, dim)

    def all_to_all(self, t: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``t``'s dim 0 holds one block for each rank of the group of
        ``axes``, in group order; returns the blocks the ranks sent this
        rank, in the same order (block ``i`` from rank ``i``)."""
        key = self._key(axes)
        n = self.size(key)
        if n == 1:
            return t
        if t.shape[0] != n:
            raise ValueError(f"dim 0 of {tuple(t.shape)} must be the "
                             f"group's {n} ranks")
        src = self._host(t, "a2a_in")
        out = self._out(src.shape, src, "a2a_out")
        self._run("all-to-all", key, lambda: dist.all_to_all_single(
            _flat(out), _flat(src), group=self._group(key)), src, out)
        return self._back(out)

    def send_recv(self, send: torch.Tensor, axes: Axes, dst: int,
                  src: int) -> torch.Tensor:
        """Send ``send`` to the rank of index ``dst`` along ``axes`` and
        receive a tensor of its shape from the rank of index ``src``
        (``batch_isend_irecv`` over the group)."""
        key = self._key(axes)
        s = self._host(send, "p2p_in")
        out = self._out(s.shape, s, "p2p_out")

        def post():
            group = self._group(key)
            peers = dist.get_process_group_ranks(group)
            for w in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, _flat(s), peers[dst], group=group),
                    dist.P2POp(dist.irecv, _flat(out), peers[src],
                               group=group)]):
                w.wait()
        self._run("collective-permute", key, post, s, out)
        return self._back(out)

    def _out(self, shape, like: torch.Tensor, role: str) -> torch.Tensor:
        """An output buffer for a collective over ``like``: pinned and kept
        under ``"gloo-staged"``, else new on ``like``'s device."""
        if self.transport == "gloo-staged":
            return self._buffer(role, shape, like.dtype)
        return torch.empty(shape, dtype=like.dtype, device=like.device)


def _lm_groups(axis_names, shape, me: int) -> Dict[Tuple[str, ...], Any]:
    """The process groups of an LM mesh that hold rank ``me``: for the dp
    axes (all but the last), the model axis and all axes, every group of
    ranks that differ only along them, made by every rank in one order
    (``dist.new_group`` is collective); a group of one rank is skipped."""
    coords = np.array(np.unravel_index(np.arange(int(np.prod(shape))),
                                       shape)).T
    out = {}
    for key in dict.fromkeys((tuple(axis_names[:-1]), (axis_names[-1],),
                              tuple(axis_names))):
        along = [axis_names.index(a) for a in key]
        if int(np.prod([shape[i] for i in along])) == 1:
            continue
        rest = [i for i in range(len(shape)) if i not in along]
        seen = {}
        for r, c in enumerate(coords):
            seen.setdefault(tuple(c[rest]), []).append(r)
        for ranks in seen.values():
            g = dist.new_group(ranks)
            if me in ranks:
                out[key] = g
    return out


def _lm_axes(axes: Dict[str, int]) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """An LM mesh's axis names and sizes; the last axis must be
    ``"model"``, each size at least 1."""
    names, shape = tuple(axes), tuple(int(n) for n in axes.values())
    if not names or names[-1] != "model" or len(set(names)) != len(names) \
            or not all(n >= 1 for n in shape):
        raise ValueError(f"LM mesh axes {axes}: the last must be 'model', "
                         "each size at least 1")
    return names, shape


def make_lm_mesh(axes: Dict[str, int], *, device: Device = None) -> LmMesh:
    """An LM mesh of the sizes ``axes`` (``{"data": D, "model": M}``, or
    with ``"pod"`` first), the model axis last, over the whole default
    process group, whose size must be their product; with none
    initialised, a mesh of one rank (no group, no collective).  The rank's
    device and transport come from :func:`choose_transport` (``None`` =
    CUDA; it raises when there is none: no fallback).  Collective: every
    rank of the launch calls it with the same sizes."""
    names, shape = _lm_axes(axes)
    n = int(np.prod(shape))
    if not (dist.is_available() and dist.is_initialized()):
        if n != 1:
            raise RuntimeError(f"an LM mesh of {n} ranks needs an "
                               "initialised default process group "
                               "(spawn_ranks, torchrun or "
                               "init_process_group)")
        transport, dev = choose_transport(1, 0, device)
        return LmMesh(names, shape, (0,) * len(shape), dev, transport)
    world, me = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(f"the LM mesh {dict(axes)} holds {n} ranks, the "
                         f"process group {world}")
    transport, dev = choose_transport(world, me, device)
    backend = dist.get_backend()
    if backend != BACKEND[transport]:
        raise RuntimeError(f"transport {transport!r} needs the "
                           f"{BACKEND[transport]!r} backend, the process "
                           f"group runs {backend!r}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    groups = _lm_groups(names, shape, me)
    coords = tuple(int(c) for c in np.unravel_index(me, shape))
    return LmMesh(names, shape, coords, dev, transport, groups)


def make_test_mesh(n_data: int, n_model: int, *, device: Device = None
                   ) -> LmMesh:
    """The ``(data, model)`` mesh of ``n_data x n_model`` ranks
    (:func:`make_lm_mesh`), as the JAX package's ``make_test_mesh``."""
    return make_lm_mesh({"data": n_data, "model": n_model}, device=device)


@dataclasses.dataclass(eq=False)
class DryMesh(LmMesh):
    """One rank of an LM mesh of any axes, traced shape-only: the rank's
    ``coords``, the ``meta`` device, the transport ``"dry"`` and no
    process group.  Its collectives are :class:`LmMesh`'s, with the same
    result shapes (meta tensors) and the same :attr:`stats` counts, but
    nothing is sent: each appends ``(kind, axes, group size, payload
    bytes)`` to :attr:`ledger` (:data:`KINDS`; the payload is the larger
    of the bytes handed in and out, the JAX package's
    ``hlo_analysis`` measure).  ``make_ctx`` takes it as it takes an
    :class:`LmMesh`.

    ``tokens`` feeds the one shape the program takes from its data: the
    rows of the vocabulary-parallel embedding's gradient
    (``distributed.tp``), which are the rows some dp rank's tokens look
    up.  It holds the token ids of each global (micro)batch that the
    traced run embeds under autograd, in order; each such embedding takes
    the next (:meth:`take_tokens`).  Where it runs out, a bound is taken:
    every token in the rank's vocabulary shard, all distinct.

    ``drop`` (a control) leaves the collective of that index (in call
    order) out of the ledger and the counters: a comparison with a real
    run must reject it."""
    ledger: List[Tuple[str, Tuple[str, ...], int, int]] = dataclasses.field(
        default_factory=list, repr=False)
    tokens: List[np.ndarray] = dataclasses.field(default_factory=list,
                                                 repr=False)
    drop: Optional[int] = None
    seen: int = 0

    def describe(self) -> str:
        shape = "x".join(map(str, self.shape))
        return (f"dry, ({','.join(self.axis_names)})={shape}, the rank at "
                f"{self.coords} on the meta device")

    def _group(self, key):
        return None

    def _run(self, kind: str, key: Tuple[str, ...], fn, inp: torch.Tensor,
             out: torch.Tensor) -> None:
        """Count the collective as :meth:`LmMesh._run` does and record it
        in :attr:`ledger` (unless it is the one to :attr:`drop`); ``fn``
        is not called."""
        self.seen += 1
        if self.seen - 1 == self.drop:
            return
        self.ledger.append((kind, key, self.size(key),
                            max(self._count(inp, out))))

    def take_tokens(self) -> Optional[np.ndarray]:
        """The next (micro)batch's token ids of :attr:`tokens`, or
        ``None`` when there are none left."""
        return self.tokens.pop(0) if self.tokens else None


def make_dry_mesh(axes: Dict[str, int], coords: Optional[Sequence[int]] = None
                  ) -> DryMesh:
    """The :class:`DryMesh` of the rank at ``coords`` (default: rank 0) of
    a mesh of the sizes ``axes`` (``{"data": D, "model": M}``, or with
    ``"pod"`` first; the model axis last)."""
    names, shape = _lm_axes(axes)
    coords = (0,) * len(shape) if coords is None else tuple(
        int(c) for c in coords)
    if len(coords) != len(shape) or not all(
            0 <= c < n for c, n in zip(coords, shape)):
        raise ValueError(f"coords {coords} are not a rank of {axes}")
    return DryMesh(names, shape, coords, torch.device("meta"), "dry")


# ---------------------------------------------------------------------- #
# Launching ranks                                                          #
# ---------------------------------------------------------------------- #

class RankError(RuntimeError):
    """A rank raised, exited without a result, or ran out of time."""


def _stash(out: Any, tmp: str, rank: int) -> Any:
    """A rank's result for the queue: the numpy arrays among a dict's
    values go through ``.npy`` files in ``tmp``."""
    if not isinstance(out, dict):
        return out
    stashed = {}
    for key, val in out.items():
        if isinstance(val, np.ndarray):
            path = os.path.join(tmp, f"rank{rank}_{key}.npy")
            np.save(path, val)
            val = ("__npy__", path)
        stashed[key] = val
    return stashed


def _unstash(out: Any) -> Any:
    if not isinstance(out, dict):
        return out
    return {k: (np.load(v[1]) if isinstance(v, tuple) and len(v) == 2
                and v[0] == "__npy__" else v) for k, v in out.items()}


def _rank_main(fn, rank: int, p: int, store: str, tmp: str, device: Device,
               timeout: float, results) -> None:
    torch.set_num_threads(1)
    try:
        with open(os.path.join(tmp, "args.pkl"), "rb") as f:
            args = pickle.load(f)
        transport, dev = choose_transport(p, rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            BACKEND[transport], init_method=store, rank=rank, world_size=p,
            timeout=datetime.timedelta(seconds=timeout))
        out = fn(rank, p, *args)
        results.put((rank, True, _stash(out, tmp, rank), time.monotonic()))
    except BaseException:
        results.put((rank, False, traceback.format_exc(), time.monotonic()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, p: int, *args, timeout: float, device: Device = None
                ) -> List[Any]:
    """Run ``fn(rank, p, *args)`` in ``p`` spawned processes, each in a
    process group of ``p`` ranks (backend from :func:`choose_transport` for
    ``device``, a ``file://`` store in a temporary directory, ``timeout`` on
    every collective), with one intra-op thread
    (``torch.set_num_threads(1)``, ``OMP_NUM_THREADS=1``) and the temporary
    directory as the ranks' shared directory (:data:`SHARED_DIR_ENV`).
    ``fn`` must be
    importable by name (spawn pickles functions by reference); ``args``
    reach the ranks pickled in a file.  Returns each rank's result in rank
    order: numpy arrays among a returned dict's values travel through files,
    everything else through a queue, pickled.  Every rank is on this host:
    gloo's and NCCL's sockets use the loopback interface unless
    ``GLOO_SOCKET_IFNAME``/``NCCL_SOCKET_IFNAME`` say otherwise.

    Any rank that raises, exits without a result or outlives ``timeout``
    seconds makes this kill every rank and raise :class:`RankError` (naming
    the rank, with its traceback where it sent one).  No rank outlives the
    call."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        store = "file://" + os.path.join(tmp, "store")
        # the arguments go through a file: a child reads what spawn sends
        # it only after importing the main module, so a large argument
        # sent that way would start the ranks one after the other
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(args, f)
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, name=f"rank{r}", args=(
            fn, r, p, store, tmp, device, timeout, results))
            for r in range(p)]
        # the children's environment: one OpenMP thread, and the
        # loopback interface for gloo's and NCCL's sockets (every rank is
        # on this host), unless the caller chose one
        env = {"OMP_NUM_THREADS": "1", SHARED_DIR_ENV: tmp,
               "GLOO_SOCKET_IFNAME": os.environ.get("GLOO_SOCKET_IFNAME",
                                                    "lo"),
               "NCCL_SOCKET_IFNAME": os.environ.get("NCCL_SOCKET_IFNAME",
                                                    "lo")}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            for pr in procs:
                pr.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    del os.environ[k]
                else:
                    os.environ[k] = v
        try:
            out = _collect(procs, results, p, timeout)
            for pr in procs:
                pr.join(timeout=30)
            for r, pr in enumerate(procs):
                if pr.exitcode != 0:
                    raise RankError(f"rank {r} exited with code "
                                    f"{pr.exitcode} after its result")
            return [_unstash(o) for o in out]
        finally:
            for pr in procs:
                if pr.is_alive():
                    pr.kill()
            for pr in procs:
                pr.join()
            results.close()
            results.join_thread()


#: seconds a rank that has exited may take to deliver what it sent
_GRACE_S = 2.0


def _collect(procs, results, p: int, timeout: float) -> List[Any]:
    """Each rank's payload, in rank order, or :class:`RankError`.

    A rank stamps what it sends with ``time.monotonic()`` (one clock for
    every process of the host), and the deadline is judged by that stamp,
    not by when this process reads the message: a result or an error
    sent after the deadline counts as late, even when a starved parent
    reads it before it has seen the deadline pass (a rank whose collective
    timed out because another was late then is not reported as the
    failure), and one sent in time counts, even when read late."""
    deadline = time.monotonic() + timeout
    got: Dict[int, Any] = {}
    gone: Dict[int, float] = {}
    while len(got) < p:
        try:
            rank, ok, payload, sent = results.get(timeout=0.2)
        except queue.Empty:
            now = time.monotonic()
            if now > deadline:
                late = sorted(set(range(p)) - set(got))
                raise RankError(f"ranks {late} did not finish within "
                                f"{timeout} s; every rank was killed")
            for r, pr in enumerate(procs):
                if r in got or pr.exitcode is None:
                    continue
                gone.setdefault(r, now)
                if now - gone[r] > _GRACE_S:
                    raise RankError(f"rank {r} exited with code "
                                    f"{pr.exitcode} without a result")
            continue
        if sent > deadline:
            continue
        if not ok:
            raise RankError(f"rank {rank} raised:\n{payload}")
        got[rank] = payload
    return [got[r] for r in range(p)]
