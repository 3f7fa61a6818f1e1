"""Gemma2-27B [arXiv:2408.00118; hf]: 46L d=4608 32H (GQA kv=16) d_ff=36864
vocab=256000; alternating local(4096)/global attention, logit softcaps,
GeGLU, sandwich norms, head_dim=128."""

from repro_torch.core.linear import MonarchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    d_model=4608,
    n_layers=46,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab=256000,
    head_dim=128,
    attn_pattern=("local", "global"),
    window=4096,
    logit_softcap=50.0,
    final_softcap=30.0,
    ffn_type="geglu",
    norm_type="rmsnorm",
    sandwich_norm=True,
    tie_embeddings=True,
    monarch=MonarchSpec(enable=True, policy="paper"),
)
