"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base]: 24L
d=1024 16H (GQA kv=8) vocab=49155; 32 routed experts top-8, expert d_ff=512."""

from repro_torch.core.linear import MonarchSpec
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    d_model=1024,
    n_layers=24,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    moe=MoEConfig(n_experts=32, top_k=8, n_shared=0, d_expert=512),
    ffn_type="swiglu",
    norm_type="rmsnorm",
    tie_embeddings=True,
    monarch=MonarchSpec(enable=True, policy="paper"),
)
