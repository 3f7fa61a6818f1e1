"""SeamlessM4T-large-v2 [arXiv:2308.11596; hf]: 24L enc + 24L dec d=1024
16H (kv=16) d_ff=8192 vocab=256206; encoder-decoder, audio frontend stubbed
(precomputed frame embeddings via input_specs, DESIGN.md Sec. 6)."""

from repro_torch.core.linear import MonarchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    d_model=1024,
    n_layers=24,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    head_dim=64,
    encdec=True,
    n_enc_layers=24,
    frontend="audio",
    n_frontend_tokens=1024,
    ffn_type="gelu",
    norm_type="layernorm",
    tie_embeddings=True,
    monarch=MonarchSpec(enable=True, policy="paper"),
)
