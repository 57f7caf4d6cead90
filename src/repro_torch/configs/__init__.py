"""Architecture registry: one module per assigned architecture, each
exporting ``CONFIG`` (full size) and ``smoke_config()`` (reduced same-family
config for CPU tests), plus the paper's own matrix-completion configs
(``nomad_mf``).  A copy of the JAX package's registry: the config modules
are data only.
"""
from __future__ import annotations

import importlib
from typing import Dict

from ..models.config import ModelConfig

ARCHS = [
    "qwen2_5_32b",
    "deepseek_67b",
    "llama3_405b",
    "mistral_large_123b",
    "qwen3_moe_30b_a3b",
    "kimi_k2_1t_a32b",
    "jamba_1_5_large_398b",
    "falcon_mamba_7b",
    "musicgen_large",
    "qwen2_vl_72b",
]

# canonical --arch ids (dashes) -> module names
ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_")
    mod = importlib.import_module(f".{mod_name}", __package__)
    return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_")
    mod = importlib.import_module(f".{mod_name}", __package__)
    return mod.smoke_config()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}


# ------------------------------------------------------------------ #
# Shapes assigned to the LM-family archs (seq_len, global_batch).      #
# ------------------------------------------------------------------ #
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

# long_500k needs sub-quadratic attention: only SSM/hybrid archs run it;
# pure full-attention archs record a documented skip.
LONG_CONTEXT_ARCHS = {"falcon_mamba_7b", "jamba_1_5_large_398b"}


def cells():
    """All (arch, shape) dry-run cells, with skip annotations."""
    out = []
    for a in ARCHS:
        for s in SHAPES:
            skip = (s == "long_500k" and a not in LONG_CONTEXT_ARCHS)
            out.append((a, s, skip))
    return out
