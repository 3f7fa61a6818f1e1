"""Zamba2-7B [arXiv:2411.15242; unverified]: 81L d=3584 32H (kv=32)
d_ff=14336 vocab=32000, ssm_state=64; Mamba2 backbone with a shared
attention block every 6 layers (hybrid)."""

from repro_torch.core.linear import MonarchSpec
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    d_model=3584,
    n_layers=81,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    head_dim=112,
    layer_kind="hybrid",
    shared_attn_every=6,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    ffn_type="swiglu",
    norm_type="rmsnorm",
    tie_embeddings=True,
    monarch=MonarchSpec(enable=True, policy="paper"),
)
