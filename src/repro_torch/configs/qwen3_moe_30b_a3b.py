"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B; MoE 128e top-8, d_expert=768]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936, rope_theta=1e6,
    n_experts=128, top_k=8, d_expert=768,
)


def smoke_config():
    return ModelConfig(
        name="qwen3-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=256, n_experts=8, top_k=2, d_expert=64,
        remat=False, dtype="float32")
