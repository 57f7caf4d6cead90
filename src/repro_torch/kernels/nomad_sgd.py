"""The NOMAD block-SGD update as one hand-written CUDA kernel
(``csrc/nomad_sgd.cu``) and its wrappers.

The JAX package has three Pallas kernels for this update —
``nomad_sgd_waves_grid`` (one schedule step, ``p`` cells),
``nomad_sgd_waves_block`` (one cell) and ``nomad_sgd_block`` (one cell,
strictly sequential) — which are one computation: the waves of a cell
applied in order, where every rating of the sequential list is its own
wave.  Here they are one CUDA kernel over a **CSR of waves**
(:class:`WaveCSR`) and four wrappers:

* :func:`nomad_sgd_waves_csr` — the CSR entry point, in place.  The
  engine calls it once per schedule step with that step's cells (the
  ratings come straight from the packed wave-major lists, never from the
  padded 4-D wave layout, which is mostly holes).
* :func:`nomad_sgd_waves_grid`, :func:`nomad_sgd_waves_block`,
  :func:`nomad_sgd_block` — the JAX package's signatures and functional
  contract (they return new tensors).  Each compacts its padded input to
  the CSR first — masked lanes dropped, (wave, lane) order kept, empty
  waves dropped — which is exact because masked lanes are no-ops.  The
  compaction runs on whatever device the inputs are on.

On a CUDA tensor a wrapper launches the kernel on the current stream
(and does not synchronise) or raises; on a CPU tensor, and only there, it
runs :func:`block_sgd_waves_csr`, the plain PyTorch version of the same
CSR update.  Each wrapper counts its kernel launches in its ``launches``
attribute, a plain integer.

The kernel keeps each cell's H block resident in shared memory, and a
stager warp stages the W rows, indices and wave offsets of the ratings
two blocks of waves ahead into rings through ``cp.async``, beside the
other warps' updates (``csrc/nomad_sgd.cu`` describes the design); a
repeated W row is forwarded exactly through :attr:`WaveCSR.prev`.
:func:`plan` picks the ring's size, the copy width and whether H fits,
and the C side refuses a plan that differs from its layout.  The TPU
kernels' ``chunk``/``wave_chunk`` knobs (VMEM blocking) are accepted for
signature parity and not read.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from . import _build
from . import ref as _ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def same_row_prev(rows, woff, cell_woff) -> torch.Tensor:
    """For each rating, the position of the last rating before it of the
    same cell with the same W row, or -1 (int32, on ``rows``' device):
    a stable sort by (cell, row), then a shift.  Positions are absolute
    in the flat lists; ratings outside the cells get -1."""
    n = rows.numel()
    dev = rows.device
    bounds = woff.long()[cell_woff.long()]
    pos = torch.arange(n, device=dev)
    cell = torch.searchsorted(bounds, pos, right=True)
    inside = (pos >= bounds[0]) & (pos < bounds[-1])
    key = torch.where(inside, (cell << 32) | rows.long(), -1 - pos)
    order = torch.sort(key, stable=True).indices
    same = key[order[1:]] == key[order[:-1]]
    prev = torch.full((n,), -1, dtype=torch.int64, device=dev)
    prev[order[1:][same]] = order[:-1][same]
    return prev.int()


@dataclasses.dataclass(frozen=True)
class WaveCSR:
    """The ratings of a batch of cells as a CSR of conflict-free waves.

    ``rows``/``cols`` (int32, local indices into each cell's W shard and
    H block) and ``vals`` (float32) list the ratings wave-major;
    ``woff[w] .. woff[w+1]`` are the ratings of wave ``w`` and
    ``cell_woff[c] .. cell_woff[c+1]`` the waves of cell ``c``.  Offsets
    are absolute, so :meth:`cells` selects a run of cells without
    copying the rating arrays.  ``prev`` (int32, :func:`same_row_prev`)
    links each rating to the last earlier one of its cell with the same
    W row: the kernel forwards that row.  It is built by :meth:`links`,
    once and on the device the ratings are on, when the kernel first
    needs it.
    """
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    woff: torch.Tensor
    cell_woff: torch.Tensor
    prev: Optional[torch.Tensor] = None

    def links(self) -> torch.Tensor:
        """``prev``, built on first use."""
        if self.prev is None:
            object.__setattr__(self, "prev", same_row_prev(
                self.rows, self.woff, self.cell_woff))
        return self.prev

    @property
    def n_cells(self) -> int:
        return self.cell_woff.shape[0] - 1

    def cells(self, lo: int, hi: int) -> "WaveCSR":
        """Cells ``lo .. hi-1`` (views, no copy; the links are built once,
        on the whole)."""
        return dataclasses.replace(self, prev=self.links(),
                                   cell_woff=self.cell_woff[lo:hi + 1])

    def arrays(self):
        """``(rows, cols, vals, woff, cell_woff)``, the tensors
        themselves (``dataclasses.astuple`` would deep-copy them)."""
        return self.rows, self.cols, self.vals, self.woff, self.cell_woff

    def to(self, device) -> "WaveCSR":
        return WaveCSR(*(t.to(device) for t in self.arrays()),
                       prev=None if self.prev is None
                       else self.prev.to(device))

    @classmethod
    def from_padded(cls, rows, cols, vals, mask) -> "WaveCSR":
        """Compact padded ``(n_cells, n_waves, wave_width)`` wave arrays:
        keep the unmasked lanes in (cell, wave, lane) order and drop
        empty waves."""
        mask = mask.bool()
        cnt = mask.sum(-1)                       # (n_cells, n_waves)
        keep = cnt > 0
        woff = torch.zeros(int(keep.sum()) + 1, dtype=torch.int32,
                           device=mask.device)
        torch.cumsum(cnt[keep], 0, out=woff[1:])
        cell_woff = torch.zeros(mask.shape[0] + 1, dtype=torch.int32,
                                device=mask.device)
        torch.cumsum(keep.sum(-1), 0, out=cell_woff[1:])
        return cls(rows=rows[mask].to(torch.int32),
                   cols=cols[mask].to(torch.int32),
                   vals=vals[mask].to(torch.float32),
                   woff=woff, cell_woff=cell_woff)

    def check_bounds(self, m_tile: int, n_tile: int) -> None:
        """Raise unless every index lies inside the cell's tiles (the
        kernel trusts them).  One host sync on a CUDA CSR."""
        for name, idx, size in (("rows", self.rows, m_tile),
                                ("cols", self.cols, n_tile)):
            if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= size):
                raise ValueError(f"{name} index out of range [0, {size})")


def block_sgd_waves_csr(Ws, Hs, csr: WaveCSR, lr, lam,
                        compute_dtype=None):
    """Plain PyTorch version of the kernel, in place: for each cell, its
    waves in order, each one gather -> ``ref.sgd_pair_batch`` ->
    scatter.  ``Ws``/``Hs`` are ``(csr.n_cells, m_tile, k)`` /
    ``(csr.n_cells, n_tile, k)``."""
    cd = compute_dtype if compute_dtype is not None else Ws.dtype
    lr = _ref._scalar(lr, cd, Ws.device)
    lam = _ref._scalar(lam, cd, Ws.device)
    cell_woff = csr.cell_woff.tolist()
    for c in range(csr.n_cells):
        woff = csr.woff[cell_woff[c]:cell_woff[c + 1] + 1].tolist()
        if len(woff) < 2:
            continue
        base, end = woff[0], woff[-1]
        rows = csr.rows[base:end].long()
        cols = csr.cols[base:end].long()
        vals = csr.vals[base:end].to(cd)
        W, H = Ws[c], Hs[c]
        for lo, hi in zip(woff[:-1], woff[1:]):
            r = rows[lo - base:hi - base]
            cc = cols[lo - base:hi - base]
            w_new, h_new = _ref.sgd_pair_batch(
                W[r], H[cc], vals[lo - base:hi - base], lr, lam,
                compute_dtype=compute_dtype)
            W[r] = w_new
            H[cc] = h_new
    return Ws, Hs


def _check(Ws, Hs, csr: WaveCSR, accum_fp32: bool) -> None:
    if Ws.dim() != 3 or Hs.dim() != 3:
        raise ValueError(f"Ws/Hs must be (cells, rows, k), got "
                         f"{tuple(Ws.shape)} / {tuple(Hs.shape)}")
    if Ws.shape[0] != csr.n_cells or Hs.shape[0] != csr.n_cells:
        raise ValueError(f"{csr.n_cells} cells of ratings for "
                         f"{Ws.shape[0]}/{Hs.shape[0]} factor blocks")
    if Ws.shape[2] != Hs.shape[2]:
        raise ValueError(f"rank mismatch: W k={Ws.shape[2]}, "
                         f"H k={Hs.shape[2]}")
    if Ws.dtype != Hs.dtype or Ws.dtype not in _DTYPE_CODE:
        raise TypeError(f"factor dtypes {Ws.dtype}/{Hs.dtype}: need one of "
                        f"{tuple(_DTYPE_CODE)}")
    if Ws.dtype != torch.float32 and not accum_fp32:
        raise ValueError(f"{Ws.dtype} factor storage needs accum_fp32=True "
                         "(updates accumulate in fp32)")
    for name, t, dt in (("rows", csr.rows, torch.int32),
                        ("cols", csr.cols, torch.int32),
                        ("vals", csr.vals, torch.float32),
                        ("woff", csr.woff, torch.int32),
                        ("cell_woff", csr.cell_woff, torch.int32)):
        if t.dtype != dt or t.dim() != 1:
            raise TypeError(f"{name} must be 1-D {dt}, got {t.dim()}-D "
                            f"{t.dtype}")
    if not csr.rows.shape == csr.cols.shape == csr.vals.shape:
        raise ValueError("rows/cols/vals length mismatch")
    if csr.prev is not None and not (
            csr.prev.dtype == torch.int32 and csr.prev.shape == csr.rows.shape
            and csr.prev.device == csr.rows.device
            and csr.prev.is_contiguous()):
        raise ValueError("prev must be contiguous int32 like rows")
    dev = Ws.device
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}")
    for name, t in (("Hs", Hs), *zip(
            ("rows", "cols", "vals", "woff", "cell_woff"),
            csr.arrays())):
        if t.device != dev:
            raise RuntimeError(f"{name} is on {t.device}, Ws on {dev}")
    for name, t in (("Ws", Ws), ("Hs", Hs), *zip(
            ("rows", "cols", "vals", "woff", "cell_woff"),
            csr.arrays())):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


#: as ``csrc/nomad_sgd.cu`` has them: the shared memory a block may use,
#: the largest rank, the ring sizes the plan tries (powers of two, the
#: largest first), the least ring beside a resident H block, the wave
#: offsets staged ahead
MAX_SMEM = 232_448
MAX_K = 1024
RINGS = (256, 128, 64, 32, 16, 8)
RESIDENT_MIN_RING = 64
WAVE_RING = 256
#: waves per block: the stager warp stages while the other warps run a
#: block, for the blocks after it
BLOCK = 8


class Plan(NamedTuple):
    """How one launch lays out a CTA's shared memory: the H block
    ``resident`` or not, a ring of ``R`` W-row slots (and ``2R`` index
    entries), W rows copied ``copy_bytes`` at a time, ``smem`` bytes in
    all."""
    resident: bool
    R: int
    copy_bytes: int
    smem: int

    def describe(self) -> str:
        return (f"H_{'resident' if self.resident else 'global'} R={self.R} "
                f"copy={self.copy_bytes}B smem={self.smem}")


def index_ring(R: int) -> int:
    """Index entries staged beside ``R`` W-row slots
    (``csrc/nomad_sgd.cu``'s ``index_ring``)."""
    return 2 * R


def plan_smem(n_tile: int, k: int, elem: int, resident: bool,
              R: int) -> int:
    """``csrc/nomad_sgd.cu``'s ``layout(...).total``: the H block (if
    resident) and ``R`` W-row slots, each rounded up to 16 bytes, 12
    bytes of slot state per slot, 16 bytes per index entry
    (:func:`index_ring`) and the ring of :data:`WAVE_RING` wave
    offsets."""
    row = -(-k * elem // 16) * 16
    h = -(-n_tile * k * elem // 16) * 16 if resident else 0
    return h + R * row + 12 * R + 16 * index_ring(R) + 4 * WAVE_RING


def copy_width(k: int, elem: int, align: int) -> int:
    """Bytes per copy of a W row: the largest of 16, 8 and 4 that divides
    the row and the rows' alignment ``align``, else 2 (16-bit rows of odd
    length, copied without ``cp.async``)."""
    for c in (16, 8, 4):
        if (k * elem) % c == 0 and align % c == 0:
            return c
    return 2


@functools.lru_cache(maxsize=256)
def plan(n_tile: int, k: int, elem: int, align: int = 16) -> Plan:
    """The layout of a launch over cells of ``n_tile`` H rows of rank
    ``k`` in ``elem``-byte storage, W rows aligned to ``align`` bytes: H
    resident iff it fits beside a ring of at least
    :data:`RESIDENT_MIN_RING` slots, then the largest ring of
    :data:`RINGS` that fits in :data:`MAX_SMEM`.  Raises if none fits."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    cw = copy_width(k, elem, align)
    for resident in (True, False):
        for R in RINGS:
            if resident and R < RESIDENT_MIN_RING:
                break
            smem = plan_smem(n_tile, k, elem, resident, R)
            if smem <= MAX_SMEM:
                return Plan(resident, R, cw, smem)
    raise ValueError(f"no ring fits k={k} in {MAX_SMEM} bytes")


def launch_plan(Ws, Hs) -> Plan:
    """:func:`plan` for factor blocks ``Ws``/``Hs``, their alignment
    taken from ``Ws``' address and cell stride."""
    elem = Ws.element_size()
    bits = Ws.data_ptr() | (Ws.stride(0) * elem) | 16
    return plan(int(Hs.shape[1]), int(Ws.shape[2]), elem, bits & -bits)


def _launch(Ws, Hs, csr: WaveCSR, lr: float, lam: float) -> None:
    lib = _build.load("nomad_sgd")
    pl = launch_plan(Ws, Hs)
    with torch.cuda.device(Ws.device):
        err = lib.nomad_sgd_waves(
            Ws.data_ptr(), Hs.data_ptr(), *(t.data_ptr() for t in (
                csr.rows, csr.cols, csr.vals, csr.links(), csr.woff,
                csr.cell_woff)),
            csr.n_cells, Ws.stride(0), Hs.stride(0), Hs.shape[1],
            Ws.shape[2], float(lr), float(lam), _DTYPE_CODE[Ws.dtype],
            int(pl.resident), pl.R, pl.copy_bytes, pl.smem,
            torch.cuda.current_stream(Ws.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nomad_sgd_waves launch failed ({pl.describe()})"
                           f": cudaError {err}")


#: the segments of a wave that ``nomad_sgd_waves_profile`` samples, in
#: the order of its output slots
SPLIT = ("index", "rows", "update", "stage", "wait", "barrier")
#: the slots of the stager warp's wait at the barrier and of warp 0's
#: butterfly
STAGER_BARRIER, BUTTERFLY = 10, 11


def wave_split(Ws, Hs, csr: WaveCSR, lr, lam, pl: Plan):
    """Where one cell's waves spend their time on the card: one launch of
    the kernel's clock-sampling build (``nomad_sgd_waves_profile``, fp32)
    under the plan ``pl`` on the one cell of ``csr``, in place.  Lane 0
    of warp 0 sums ``clock64()`` cycles over its waves for the index
    fetch, the row fetch, the butterfly, the update and the barrier; lane
    0 of the stager warp for its staging, its copy wait and its barrier
    (:data:`SPLIT`, ``butterfly``, ``stager_barrier``; all per wave).  A
    timing tool: no engine path calls it, and it
    counts no launch.  Returns the cycles per wave of each segment, the
    waves and trips, the total cycles, and the launch's milliseconds by
    CUDA events (which convert cycles to time)."""
    _check(Ws, Hs, csr, False)
    if Ws.device.type != "cuda" or csr.n_cells != 1 \
            or Ws.dtype != torch.float32:
        raise ValueError("wave_split profiles one fp32 cell on a CUDA "
                         "device")
    lib = _build.load("nomad_sgd")
    prof = torch.zeros(12, dtype=torch.int64, device=Ws.device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(Ws.device):
        start.record()
        err = lib.nomad_sgd_waves_profile(
            Ws.data_ptr(), Hs.data_ptr(), *(t.data_ptr() for t in (
                csr.rows, csr.cols, csr.vals, csr.links(), csr.woff,
                csr.cell_woff)),
            1, Ws.stride(0), Hs.stride(0), Hs.shape[1], Ws.shape[2],
            float(lr), float(lam), int(pl.resident), pl.R, pl.copy_bytes,
            pl.smem, prof.data_ptr(),
            torch.cuda.current_stream(Ws.device).cuda_stream)
        stop.record()
    if err != 0:
        raise RuntimeError(f"nomad_sgd_waves_profile failed "
                           f"({pl.describe()}): cudaError {err}")
    torch.cuda.synchronize(Ws.device)
    acc = prof.tolist()
    waves = max(acc[6], 1)
    out = {f"{name}_cycles": acc[i] / waves for i, name in enumerate(SPLIT)}
    out.update(waves=acc[6], trips=acc[7], cycles=acc[8],
               stager_barrier_cycles=acc[STAGER_BARRIER] / waves,
               butterfly_cycles=acc[BUTTERFLY] / waves,
               ms=start.elapsed_time(stop))
    return out


def _apply(wrapper, Ws, Hs, csr: WaveCSR, lr, lam, accum_fp32: bool):
    """Apply ``csr`` to ``Ws``/``Hs`` in place: the kernel on CUDA
    tensors (counted on ``wrapper.launches``), the plain version on CPU
    tensors."""
    _check(Ws, Hs, csr, accum_fp32)
    if Ws.device.type == "cpu":
        block_sgd_waves_csr(Ws, Hs, csr, lr, lam,
                            compute_dtype=torch.float32 if accum_fp32
                            else None)
        return
    _launch(Ws, Hs, csr, lr, lam)
    wrapper.launches += 1


def _fresh(t: torch.Tensor) -> torch.Tensor:
    if not t.is_contiguous():
        raise ValueError("factor blocks must be contiguous")
    out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    return out.copy_(t)


def nomad_sgd_waves_csr(Ws, Hs, csr: WaveCSR, lr, lam, *,
                        accum_fp32: bool = False):
    """One kernel launch that applies the waves of ``csr.n_cells`` cells
    **in place** to ``Ws (n_cells, m_tile, k)`` / ``Hs (n_cells, n_tile,
    k)`` — cell ``c`` owns ``Ws[c]``/``Hs[c]``, and the cells must touch
    pairwise-disjoint factor rows (a schedule step's generalized
    diagonal).  Index bounds are the caller's to check
    (:meth:`WaveCSR.check_bounds`, once per packing).  Returns
    ``(Ws, Hs)``."""
    _apply(nomad_sgd_waves_csr, Ws, Hs, csr, lr, lam, accum_fp32)
    return Ws, Hs


def nomad_sgd_waves_grid(Ws, Hs, rows, cols, vals, mask, lr, lam, *,
                         wave_chunk: int = 8, accum_fp32: bool = False):
    """One schedule step's batch of cells, one launch.  ``Ws (p, m_tile,
    k)``, ``Hs (p, n_tile, k)``; ``rows/cols/vals/mask (p, n_waves,
    wave_width)``.  Returns new ``(Ws, Hs)``."""
    csr = WaveCSR.from_padded(rows, cols, vals, mask)
    csr.check_bounds(Ws.shape[1], Hs.shape[1])
    Ws, Hs = _fresh(Ws), _fresh(Hs)
    _apply(nomad_sgd_waves_grid, Ws, Hs, csr, lr, lam, accum_fp32)
    return Ws, Hs


def nomad_sgd_waves_block(W, H, rows, cols, vals, mask, lr, lam, *,
                          wave_chunk: int = 8, accum_fp32: bool = False):
    """One cell's waves: ``W (m_tile, k)``, ``H (n_tile, k)``,
    ``rows/cols/vals/mask (n_waves, wave_width)``.  Returns new
    ``(W, H)``."""
    csr = WaveCSR.from_padded(rows[None], cols[None], vals[None], mask[None])
    csr.check_bounds(W.shape[0], H.shape[0])
    Ws, Hs = _fresh(W)[None], _fresh(H)[None]
    _apply(nomad_sgd_waves_block, Ws, Hs, csr, lr, lam, accum_fp32)
    return Ws[0], Hs[0]


def nomad_sgd_block(W, H, rows, cols, vals, mask, lr, lam, *,
                    chunk: int = 1024, accum_fp32: bool = False):
    """One cell, strictly sequential over a flat ``(nnz,)`` masked rating
    list: every unmasked rating becomes its own wave.  Returns new
    ``(W, H)``."""
    csr = WaveCSR.from_padded(rows[None, :, None], cols[None, :, None],
                              vals[None, :, None], mask[None, :, None])
    csr.check_bounds(W.shape[0], H.shape[0])
    Ws, Hs = _fresh(W)[None], _fresh(H)[None]
    _apply(nomad_sgd_block, Ws, Hs, csr, lr, lam, accum_fp32)
    return Ws[0], Hs[0]


#: every wrapper that launches the kernel (each has a ``launches`` count)
WRAPPERS = (nomad_sgd_waves_csr, nomad_sgd_waves_grid, nomad_sgd_waves_block,
            nomad_sgd_block)
for _w in WRAPPERS:
    _w.launches = 0
del _w


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0


block_sgd_ref = _ref.block_sgd_ref        # re-export for convenience
block_sgd_waves = _ref.block_sgd_waves    # re-export for convenience
