"""Mamba2-2.7B [arXiv:2405.21060; unverified]: 64L d=2560 (attention-free)
vocab=50280, ssm_state=128; SSD (state-space duality)."""

from repro_torch.core.linear import MonarchSpec
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    d_model=2560,
    n_layers=64,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    head_dim=64,
    layer_kind="mamba",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    norm_type="rmsnorm",
    tie_embeddings=True,
    monarch=MonarchSpec(enable=True, policy="paper"),
)
