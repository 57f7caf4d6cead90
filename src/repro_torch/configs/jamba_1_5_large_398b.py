"""Jamba-1.5-Large (398B) [arXiv:2403.19887; hybrid Mamba+attention 1:7
interleave, MoE 16e top-2 every other layer]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536, rope_theta=1e6,
    n_experts=16, top_k=2, d_expert=24576, moe_every=2,
    attn_every=8, attn_offset=3,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
)


def smoke_config():
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=256, n_experts=4, top_k=2, d_expert=96,
        moe_every=2, attn_every=8, attn_offset=3,
        ssm_state=8, ssm_conv=4, ssm_expand=2, remat=False,
        dtype="float32")
