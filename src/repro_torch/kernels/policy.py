"""Kernel execution policy for the NOMAD block-SGD update.

``KernelPolicy`` is the single, validated description of *how* a block of
ratings is executed: which kernel implementation, its tiling knobs, the
sub-block pipelining factor, and the factor precision policy.  Invalid
combinations fail (or downgrade, with a warning) at *construction* time,
once, with one message.

Same fields, impl names, validation and downgrade as the JAX package's
policy, so configs carry over unchanged.  The impls map onto the port as:

* ``'xla'`` / ``'wave'``   — plain PyTorch ops (:mod:`.ref`);
* ``'pallas'`` / ``'wave_pallas'`` — the hand-written CUDA kernel
  (:mod:`.nomad_sgd`) on CUDA tensors, its plain version on CPU tensors;
* ``'auto'`` — ``'pallas'`` on CUDA, ``'xla'`` elsewhere.

:meth:`KernelPolicy.serve_impl` maps the same impls onto the serving
top-k scorer.

The object is a frozen (hashable) dataclass, so it can serve as a
memoization key for packed layouts (``MCProblem.packed``).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple, Union

import torch

IMPLS: Tuple[str, ...] = ("auto", "xla", "pallas", "wave", "wave_pallas")

#: impls that consume the conflict-free wave layout
WAVE_IMPLS: Tuple[str, ...] = ("wave", "wave_pallas")

#: factor storage precisions.  Anything below fp32 stores W/H
#: low-precision and accumulates the SGD update in fp32.
DTYPE_POLICIES: Tuple[str, ...] = ("fp32", "bf16", "fp16")

#: the sequential fallback each wave impl downgrades to when the
#: pipelined sub-block layout is requested (the wave layout is colored
#: over whole cells; slicing an H block into sub-blocks would split
#: waves across permute steps and break the serializability proof)
_WAVE_DOWNGRADE = {"wave": "xla", "wave_pallas": "pallas"}

#: per-backend fast-memory budget (bytes) the autotuner sizes the grid
#: kernel's resident blocks against.  ``"cuda"`` is Hopper's shared
#: memory per block: 227 KB (232,448 bytes) of the SM's 256 KB, usable
#: above 48 KB as dynamic shared memory only.  (The CUDA wave kernel
#: keeps nothing resident in shared memory today — it streams each
#: wave's rows through registers — so the budget only sizes the
#: ``wave_chunk`` recorded in the policy.)  ``"cpu"`` is the JAX
#: package's figure, so a CPU autotune gives the same knobs there and
#: here.
_MEM_BUDGET = {"cuda": 232_448, "cpu": 1 << 20}

_STORAGE = {"fp32": torch.float32, "bf16": torch.bfloat16,
            "fp16": torch.float16}


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """How one block-SGD update executes.

    impl         -- 'auto' | 'xla' | 'pallas' | 'wave' | 'wave_pallas'
                    (sequential rating list vs. conflict-free wave layout,
                    plain PyTorch vs. the CUDA kernel)
    chunk        -- rating chunk of the JAX package's sequential kernel;
                    kept for config parity, the CUDA kernel does not read
                    it
    wave_chunk   -- wave chunk of the JAX package's wave kernels; kept for
                    config and checkpoint parity, the CUDA kernel does
                    not read it (a CTA walks its cell's waves in one loop)
    sub_blocks   -- item sub-blocks per H block for the pipelined SPMD
                    permute overlap; 1 = whole-block
    dtype_policy -- 'fp32' | 'bf16' | 'fp16': factor *storage* precision.
                    Below fp32 the SGD update gathers rows, upcasts,
                    accumulates in fp32 and downcasts on scatter.
    block_rows   -- grid selector for the engine's kernel impls
                    (``wave_pallas``, ``pallas``): 0 = auto (one
                    launch per schedule step for all its cells when the
                    factors are on CUDA, per-cell otherwise), -1 = never
                    batch the cells, > 0 = batch whenever the per-cell
                    factor blocks fit (max(m_local, n_local) <=
                    block_rows).
    """
    impl: str = "auto"
    chunk: int = 1024
    wave_chunk: int = 8
    sub_blocks: int = 1
    dtype_policy: str = "fp32"
    block_rows: int = 0

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(
                f"impl={self.impl!r} not in {IMPLS}")
        if self.chunk < 1 or self.wave_chunk < 1:
            raise ValueError("chunk and wave_chunk must be >= 1")
        if self.sub_blocks < 1:
            raise ValueError(f"sub_blocks must be >= 1, got {self.sub_blocks}")
        if self.dtype_policy not in DTYPE_POLICIES:
            raise ValueError(
                f"dtype_policy={self.dtype_policy!r} not in {DTYPE_POLICIES}")
        if self.block_rows < -1:
            raise ValueError(
                f"block_rows must be -1 (never), 0 (auto) or a positive "
                f"row bound, got {self.block_rows}")
        if self.wave and self.sub_blocks > 1:
            # The wave coloring spans whole cells; the pipelined layout
            # slices each H block into sub_blocks permute stages, which
            # would split waves across stages and void the conflict-free
            # guarantee.  Downgrade to the sequential lowering of the
            # same family instead of hard-failing.
            repl = _WAVE_DOWNGRADE[self.impl]
            warnings.warn(
                f"impl={self.impl!r} does not support sub_blocks > 1 "
                f"(the wave layout is colored over whole cells); "
                f"downgrading to impl={repl!r} for the pipelined SPMD "
                "path", UserWarning, stacklevel=2)
            object.__setattr__(self, "impl", repl)

    # ------------------------------------------------------------------ #
    @property
    def wave(self) -> bool:
        """True if this policy consumes the wave layout."""
        return self.impl in WAVE_IMPLS

    @property
    def mixed(self) -> bool:
        """True if factors are stored below fp32 (bounded-error tier)."""
        return self.dtype_policy != "fp32"

    @property
    def storage_dtype(self) -> torch.dtype:
        """torch dtype the factor shards are stored in."""
        return _STORAGE[self.dtype_policy]

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        """Accumulation dtype for the SGD update, or ``None`` when
        storage is already fp32 (no cast is ever inserted)."""
        if not self.mixed:
            return None
        return torch.float32

    def wants_grid(self, m_local: int, n_local: int,
                   device: Union[str, torch.device]) -> bool:
        """Whether the kernel updates all cells of a schedule step in one
        launch (``block_rows`` semantics above; the engine asks it for
        ``wave_pallas`` and ``pallas`` alike); with ``block_rows=0``
        that is exactly "the factors are on CUDA"."""
        if self.block_rows == -1:
            return False
        if self.block_rows > 0:
            return max(m_local, n_local) <= self.block_rows
        return torch.device(device).type == "cuda"

    def autotune(self, *, m_local: int, n_local: int, k: int,
                 backend: Optional[str] = None) -> "KernelPolicy":
        """Pick occupancy knobs for a cell shape on the current (or
        given) backend: ``wave_chunk`` sized so the resident W/H blocks
        plus one rating chunk fit the backend's fast-memory budget, and
        ``block_rows`` pinned so dispatch decisions are explicit in the
        returned policy.  Pure function of (shape, backend)."""
        if backend is None:
            backend = "cuda" if torch.cuda.is_available() else "cpu"
        budget = _MEM_BUDGET.get(backend, _MEM_BUDGET["cpu"])
        bytes_per = {"fp32": 4, "bf16": 2, "fp16": 2}[self.dtype_policy]
        kp = -(-max(k, 1) // 128) * 128          # LANE-padded rank
        resident = (m_local + n_local) * kp * bytes_per
        # leftover budget feeds the streamed rating chunk: 3 int32 index
        # planes + 1 fp32 value plane + bool mask, wave_width <= p-wide
        wave_bytes = max(1, 16 * max(m_local, n_local) // 8)
        spare = max(budget - resident, budget // 8)
        wave_chunk = int(min(64, max(4, spare // max(wave_bytes, 1) // 64)))
        block_rows = (-1 if backend == "cpu"
                      else max(m_local, n_local))
        return dataclasses.replace(
            self, wave_chunk=wave_chunk, block_rows=block_rows)

    def serve_impl(self, device: Union[str, torch.device]) -> str:
        """Which serving top-k scorer this policy selects for factors on
        ``device`` (:mod:`repro_torch.serve.topk`): ``'pallas'``, the
        CUDA top-k kernel, for the kernel train impls; ``'xla'``, the
        plain tiled scan, otherwise; ``'auto'`` follows the train
        dispatch rule of :mod:`.ops` (the kernel when the factors are on
        CUDA).  The JAX package's ``serve_impl`` is a property that
        resolves ``'auto'`` by backend; here the device of the factors
        decides, so it takes the device."""
        if self.impl == "auto":
            return "pallas" if torch.device(device).type == "cuda" else "xla"
        return "pallas" if self.impl in ("pallas", "wave_pallas") else "xla"

    @classmethod
    def coerce(cls, value: Union[str, "KernelPolicy", None], *,
               sub_blocks: int = 1,
               dtype_policy: str = "fp32") -> "KernelPolicy":
        """Build a policy from a legacy ``impl`` string (or pass one
        through).  ``sub_blocks`` / ``dtype_policy`` merge in when the
        value is a string or when the given policy still has the
        default; a *conflicting* explicit pair fails here rather than
        silently preferring one."""
        if value is None:
            value = "auto"
        if isinstance(value, str):
            return cls(impl=value, sub_blocks=sub_blocks,
                       dtype_policy=dtype_policy)
        if isinstance(value, KernelPolicy):
            out = value
            if sub_blocks != 1 and sub_blocks != out.sub_blocks:
                if out.sub_blocks != 1:
                    raise ValueError(
                        f"conflicting sub_blocks: policy says "
                        f"{out.sub_blocks}, caller says {sub_blocks}")
                out = dataclasses.replace(out, sub_blocks=sub_blocks)
            if dtype_policy != "fp32" and dtype_policy != out.dtype_policy:
                if out.dtype_policy != "fp32":
                    raise ValueError(
                        f"conflicting dtype_policy: policy says "
                        f"{out.dtype_policy!r}, caller says "
                        f"{dtype_policy!r}")
                out = dataclasses.replace(out, dtype_policy=dtype_policy)
            return out
        raise TypeError(f"cannot coerce {type(value).__name__} to "
                        "KernelPolicy")

    # ------------------------------------------------------------------ #
    def check_packed(self, br, *, pipelined: bool = True) -> None:
        """Validate that a ``BlockedRatings`` carries the layouts this
        policy executes (wave layout present, sub-block pre-partition
        matching).  Raises ``ValueError`` with an actionable message."""
        if self.wave and br.wave_cnt is None:
            raise ValueError(
                f"impl={self.impl!r} needs the wave layout; call "
                "partition.pack(..., waves=True) or "
                "MCProblem.packed(..., waves=True)")
        if (pipelined and self.sub_blocks > 1
                and br.sub_blocks != self.sub_blocks):
            raise ValueError(
                f"policy sub_blocks={self.sub_blocks} but ratings were "
                f"packed with sub_blocks={br.sub_blocks}; call "
                "partition.pack(..., sub_blocks=...) to match")
