"""MusicGen-Large [arXiv:2306.05284; decoder-only over EnCodec tokens].

Backbone only: the EnCodec frontend is a stub — ``input_specs`` supplies
precomputed frame embeddings (embed_input=False), labels are codebook
token ids over the 2048-entry vocab.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048, embed_input=False, rope_theta=1e4,
)


def smoke_config():
    return ModelConfig(
        name="musicgen-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=64, embed_input=False, remat=False,
        dtype="float32")
