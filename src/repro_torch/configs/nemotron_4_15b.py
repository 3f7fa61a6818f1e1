"""Nemotron-4 15B [arXiv:2402.16819; unverified]: 32L d=6144 48H (GQA kv=8)
d_ff=24576 vocab=256000; squared-ReLU FFN, untied embeddings."""

from repro_torch.core.linear import MonarchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    d_model=6144,
    n_layers=32,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    head_dim=128,
    ffn_type="relu2",
    norm_type="layernorm",
    tie_embeddings=False,
    rope_theta=10000.0,
    monarch=MonarchSpec(enable=True, policy="paper"),
)
