"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B]: 32L d=4096 32H (MHA kv=32)
d_ff=13440 vocab=92416; qwen1.5 architecture (SwiGLU, RMSNorm)."""

from repro_torch.core.linear import MonarchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    d_model=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    head_dim=128,
    ffn_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=1000000.0,
    tie_embeddings=False,
    monarch=MonarchSpec(enable=True, policy="paper"),
)
