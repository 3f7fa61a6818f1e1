"""InternVL2-76B [arXiv:2404.16821; unverified]: LM backbone 80L d=8192 64H
(GQA kv=8) d_ff=28672 vocab=128256 (Llama3-70B-style); InternViT frontend is
a stub (precomputed patch embeddings via input_specs, DESIGN.md Sec. 6)."""

from repro_torch.core.linear import MonarchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    d_model=8192,
    n_layers=80,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    head_dim=128,
    frontend="vision",
    n_frontend_tokens=256,
    ffn_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=500000.0,
    tie_embeddings=False,
    monarch=MonarchSpec(enable=True, policy="paper"),
)
