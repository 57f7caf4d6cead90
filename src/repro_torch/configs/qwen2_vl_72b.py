"""Qwen2-VL-72B [arXiv:2409.12191; dense backbone + M-RoPE].

Backbone only: the vision tower is a stub — ``input_specs`` supplies
precomputed patch embeddings (embed_input=False) plus (t, h, w) position
triples for M-RoPE.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064, embed_input=False,
    rope_kind="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
)


def smoke_config():
    return ModelConfig(
        name="qwen2-vl-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, embed_input=False,
        rope_kind="mrope", mrope_sections=(2, 3, 3), remat=False,
        dtype="float32")
