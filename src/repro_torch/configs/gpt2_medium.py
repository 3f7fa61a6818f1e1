"""GPT-2-medium (paper model): 24L d=1024 16H d_ff=4096 vocab=50257."""

from repro_torch.core.linear import MonarchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gpt2-medium",
    d_model=1024,
    n_layers=24,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=50257,
    head_dim=64,
    ffn_type="gelu",
    norm_type="layernorm",
    tie_embeddings=True,
    monarch=MonarchSpec(enable=True, policy="paper"),
)
