"""Llama-3-405B [arXiv:2407.21783; dense, GQA kv=8, 128k vocab]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, head_dim=128,
    d_ff=53248, vocab_size=128256, rope_theta=5e5,
)


def smoke_config():
    return ModelConfig(
        name="llama3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=160, vocab_size=256, remat=False, dtype="float32")
