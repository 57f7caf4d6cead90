"""Mistral-Large-2407 (123B) [hf:mistralai/Mistral-Large-Instruct-2407]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=32768, rope_theta=1e6,
)


def smoke_config():
    return ModelConfig(
        name="mistral-smoke", family="dense",
        n_layers=2, d_model=48, n_heads=6, n_kv_heads=2, head_dim=8,
        d_ff=96, vocab_size=128, remat=False, dtype="float32")
