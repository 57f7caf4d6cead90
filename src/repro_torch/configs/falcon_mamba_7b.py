"""Falcon-Mamba-7B [arXiv:2410.05355; pure Mamba-1, attention-free].

The paper's technique (nomadic-ownership scheduling of *attention/
factorization* state) is inapplicable here — see DESIGN.md
§Arch-applicability; the arch is implemented without it.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=65024,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
)


def smoke_config():
    return ModelConfig(
        name="falcon-mamba-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, head_dim=0,
        d_ff=0, vocab_size=256, ssm_state=8, ssm_conv=4, ssm_expand=2,
        remat=False, dtype="float32")
