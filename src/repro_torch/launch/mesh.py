"""The worker mesh of NOMAD's SPMD executor over ``torch.distributed``,
and a launcher that starts one process per rank.

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
        results.put((rank, True, _stash(out, tmp, rank)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
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
    deadline = time.monotonic() + timeout
    got: Dict[int, Any] = {}
    gone: Dict[int, float] = {}
    while len(got) < p:
        try:
            rank, ok, payload = results.get(timeout=0.2)
        except queue.Empty:
            now = time.monotonic()
            for r, pr in enumerate(procs):
                if r in got or pr.exitcode is None:
                    continue
                gone.setdefault(r, now)
                if now - gone[r] > _GRACE_S:
                    raise RankError(f"rank {r} exited with code "
                                    f"{pr.exitcode} without a result")
            if now > deadline:
                late = sorted(set(range(p)) - set(got))
                raise RankError(f"ranks {late} did not finish within "
                                f"{timeout} s; every rank was killed")
            continue
        if not ok:
            raise RankError(f"rank {rank} raised:\n{payload}")
        got[rank] = payload
    return [got[r] for r in range(p)]
