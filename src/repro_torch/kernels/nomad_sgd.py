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

The TPU kernels' ``chunk``/``wave_chunk`` knobs (VMEM blocking) are
accepted for signature parity and not read: a CTA walks its cell's waves
in one loop, with no resident tiles.
"""
from __future__ import annotations

import dataclasses

import torch

from . import _build
from . import ref as _ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@dataclasses.dataclass(frozen=True)
class WaveCSR:
    """The ratings of a batch of cells as a CSR of conflict-free waves.

    ``rows``/``cols`` (int32, local indices into each cell's W shard and
    H block) and ``vals`` (float32) list the ratings wave-major;
    ``woff[w] .. woff[w+1]`` are the ratings of wave ``w`` and
    ``cell_woff[c] .. cell_woff[c+1]`` the waves of cell ``c``.  Offsets
    are absolute, so :meth:`cells` selects a run of cells without
    copying the rating arrays.
    """
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    woff: torch.Tensor
    cell_woff: torch.Tensor

    @property
    def n_cells(self) -> int:
        return self.cell_woff.shape[0] - 1

    def cells(self, lo: int, hi: int) -> "WaveCSR":
        """Cells ``lo .. hi-1`` (views, no copy)."""
        return dataclasses.replace(self, cell_woff=self.cell_woff[lo:hi + 1])

    def arrays(self):
        """``(rows, cols, vals, woff, cell_woff)``, the tensors
        themselves (``dataclasses.astuple`` would deep-copy them)."""
        return self.rows, self.cols, self.vals, self.woff, self.cell_woff

    def to(self, device) -> "WaveCSR":
        return WaveCSR(*(t.to(device) for t in self.arrays()))

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


def _launch(Ws, Hs, csr: WaveCSR, lr: float, lam: float) -> None:
    lib = _build.load("nomad_sgd")
    k = Ws.shape[2]
    if k > lib.nomad_sgd_max_k():
        raise ValueError(f"k={k} exceeds the kernel's "
                         f"{lib.nomad_sgd_max_k()}")
    with torch.cuda.device(Ws.device):
        err = lib.nomad_sgd_waves(
            Ws.data_ptr(), Hs.data_ptr(), csr.rows.data_ptr(),
            csr.cols.data_ptr(), csr.vals.data_ptr(), csr.woff.data_ptr(),
            csr.cell_woff.data_ptr(), csr.n_cells, Ws.stride(0),
            Hs.stride(0), k, float(lr), float(lam), _DTYPE_CODE[Ws.dtype],
            torch.cuda.current_stream(Ws.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nomad_sgd_waves launch failed: cudaError {err}")


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
