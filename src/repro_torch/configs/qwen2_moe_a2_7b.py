"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d=2048 16H (kv=16)
vocab=151936; 60 routed experts top-4 + 4 shared, expert d_ff=1408.
Expert stack padded 60->64 for even 16-way expert parallelism."""

from repro_torch.core.linear import MonarchSpec
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    d_model=2048,
    n_layers=24,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    head_dim=128,
    moe=MoEConfig(n_experts=60, top_k=4, n_shared=4, d_expert=1408,
                  pad_to=64),
    ffn_type="swiglu",
    norm_type="rmsnorm",
    tie_embeddings=True,
    monarch=MonarchSpec(enable=True, policy="paper"),
)
