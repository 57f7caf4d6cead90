"""Kimi-K2 (1T total / 32B active) [arXiv:2501.kimi2 per task spec;
MoE 384e top-8, first layer dense, 1 shared expert]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=2048, vocab_size=163840, rope_theta=5e4,
    n_experts=384, top_k=8, d_expert=2048, n_shared_experts=1,
    first_dense_layers=1,
)


def smoke_config():
    return ModelConfig(
        name="kimi-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=256, n_experts=8, top_k=2, d_expert=64,
        n_shared_experts=1, first_dense_layers=1, remat=False,
        dtype="float32")
