"""MiniCPM-2B [arXiv:2404.06395; hf]: 40L d=2304 36H (MHA) d_ff=5760
vocab=122753; llama-like (SwiGLU/RMSNorm), WSD schedule in the trainer."""

from repro_torch.core.linear import MonarchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    d_model=2304,
    n_layers=40,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,
    head_dim=64,
    ffn_type="swiglu",
    norm_type="rmsnorm",
    tie_embeddings=True,
    monarch=MonarchSpec(enable=True, policy="paper"),
)
