"""Model configuration.

One frozen dataclass covers all assigned architecture families:
dense / moe / hybrid (attention+SSM interleave) / ssm / audio / vlm.
``[audio]``/``[vlm]`` configs describe the transformer *backbone* only; the
modality frontend is stubbed (``embed_input=False`` — inputs are
precomputed frame/patch embeddings, per the task spec).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                   # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int                      # dense-MLP width (0 for pure SSM)
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    rope_theta: float = 1e6
    rope_kind: str = "rope"        # rope | mrope
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0              # per-expert FFN width
    n_shared_experts: int = 0
    first_dense_layers: int = 0    # leading dense layers before MoE stack
    moe_every: int = 1             # a layer is MoE iff layer_idx % moe_every
    capacity_factor: float = 1.25  #   == moe_every - 1 (jamba: every 2nd)

    # --- SSM / hybrid ---
    attn_every: int = 0            # hybrid: 1 attention layer per this many
    attn_offset: int = 0           #   (jamba: 8, offset 3); 0 = all attention
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0           # 0 -> ceil(d_model / 16)

    # --- frontend / misc ---
    embed_input: bool = True       # False: inputs are precomputed embeddings
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True
    # compile-shape knobs (the depth-probe in launch/dryrun.py forces
    # scan_unroll so cost_analysis sees every layer's ops; see DESIGN.md §8)
    scan_unroll: bool = False
    attn_chunk: int = 1024
    ssm_chunk: int = 256
    # 'gspmd': let the partitioner insert TP collectives (baseline);
    # 'manual': shard_map row-parallel matmuls + vocab-parallel embedding
    # with bf16 psums (Perf iteration C1)
    tp_collectives: str = "gspmd"

    # ------------------------------------------------------------------ #
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    def layer_kind(self, idx: int) -> str:
        """'attn' | 'ssm' for the mixer of layer ``idx``."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid" and self.attn_every:
            return ("attn" if idx % self.attn_every == self.attn_offset
                    else "ssm")
        return "attn"

    def mlp_kind(self, idx: int) -> str:
        """'moe' | 'dense' for the FFN of layer ``idx``."""
        if self.family == "ssm":
            return "none" if self.d_ff == 0 else "dense"
        if self.n_experts and idx >= self.first_dense_layers:
            if (idx - self.first_dense_layers) % self.moe_every == \
                    self.moe_every - 1:
                return "moe"
        return "dense"

    @property
    def period(self) -> int:
        """Length of the repeating layer pattern (for stacked-scan)."""
        if self.family == "hybrid" and self.attn_every:
            base = self.attn_every
        else:
            base = 1
        if self.n_experts:
            base = _lcm(base, self.moe_every)
        return base

    @property
    def n_prologue(self) -> int:
        """Leading layers handled outside the scan (e.g. Kimi's first
        dense layer)."""
        return self.first_dense_layers

    @property
    def n_periods(self) -> int:
        body = self.n_layers - self.n_prologue
        assert body % self.period == 0, (self.name, body, self.period)
        return body // self.period

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline cross-checks)."""
        d, hd = self.d_model, self.head_dim
        total = 0
        if self.embed_input:
            total += self.vocab_size * d
        total += self.vocab_size * d  # lm head (untied)
        for i in range(self.n_layers):
            total += d  # pre-mixer norm
            if self.layer_kind(i) == "attn":
                total += d * hd * (self.n_heads + 2 * self.n_kv_heads)
                total += self.n_heads * hd * d
                if self.qkv_bias:
                    total += hd * (self.n_heads + 2 * self.n_kv_heads)
            else:
                di, N, r = self.d_inner, self.ssm_state, self.dt_rank
                total += d * 2 * di + self.ssm_conv * di + di  # conv w+b
                total += di * (r + 2 * N) + r * di + di
                total += di * N + di + di * d
            if self.mlp_kind(i) != "none":
                total += d  # pre-mlp norm
            if self.mlp_kind(i) == "moe":
                total += d * self.n_experts  # router
                total += self.n_experts * 3 * d * self.d_expert
                total += self.n_shared_experts * 3 * d * self.d_expert
            elif self.mlp_kind(i) == "dense":
                total += 3 * d * self.d_ff
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top_k + shared experts)."""
        if not self.n_experts:
            return self.param_count()
        total = self.param_count()
        for i in range(self.n_layers):
            if self.mlp_kind(i) == "moe":
                inactive = (self.n_experts - self.top_k)
                total -= inactive * 3 * self.d_model * self.d_expert
        return total


def _lcm(a: int, b: int) -> int:
    import math
    return a * b // math.gcd(a, b)
