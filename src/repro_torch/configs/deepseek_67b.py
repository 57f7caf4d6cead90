"""DeepSeek-67B [arXiv:2401.02954; dense llama-arch, GQA kv=8]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=102400, rope_theta=1e4,
)


def smoke_config():
    return ModelConfig(
        name="deepseek-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=256, remat=False, dtype="float32")
