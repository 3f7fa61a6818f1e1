"""BERT-large-shaped LM (paper model): 24L d=1024 16H d_ff=4096
vocab=30522.  The reference uses it in its D2S examples and kernel
benches; its CIM simulator has its own encoder workload description
(``repro_torch.cim.workload.bert_large``)."""

from repro_torch.core.linear import MonarchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="bert-large-lm",
    d_model=1024,
    n_layers=24,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=30522,
    head_dim=64,
    ffn_type="gelu",
    norm_type="layernorm",
    tie_embeddings=True,
    monarch=MonarchSpec(enable=True, policy="paper"),
)
