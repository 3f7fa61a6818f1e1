"""Model configuration covering all assigned architectures + paper models.

One ``ModelConfig`` describes any member of the zoo: dense decoder LMs (GQA,
local/global alternation, logit softcap), MoE (shared + routed experts),
SSM (Mamba2/SSD), hybrid (Zamba2: Mamba backbone + shared attention block),
encoder-decoder (Seamless/BART), and modality-stub backbones (audio/vision).
``monarch`` makes the paper's technique a first-class switch: every
parameterized matmul above ``monarch.min_dim`` is Monarch-factorized.

Copied from ``repro.models.config`` so a configuration means the same in
both packages; the port's model code serves every family it describes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

from repro_torch.core.linear import MonarchSpec


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int            # routed experts
    top_k: int
    n_shared: int = 0         # always-on shared experts (Qwen2-MoE style)
    d_expert: Optional[int] = None  # expert hidden dim (defaults to d_ff)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    pad_to: Optional[int] = None  # pad expert stack for even EP sharding
                                  # (e.g. 60 -> 64 on a 16-way mesh axis);
                                  # padded experts are router-masked
    group_size: int = 512         # tokens per routing group (GShard-style):
                                  # capacity is per-group, so dispatch cost
                                  # stays LINEAR in total tokens (a (T,E,C)
                                  # tensor with C ~ T would be quadratic)

    @property
    def n_slots(self) -> int:
        return self.pad_to or self.n_experts


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256
    a_init_range: tuple[float, float] = (1.0, 16.0)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None

    # attention details
    attn_pattern: tuple[str, ...] = ("global",)  # repeats over layers:
                                                 # "global" | "local"
    window: int = 4096
    logit_softcap: Optional[float] = None        # gemma2 attn softcap
    final_softcap: Optional[float] = None        # gemma2 output softcap
    rope_theta: float = 10000.0
    qk_norm: bool = False
    # perf-loop knobs (EXPERIMENTS.md Sec. Perf):
    attn_chunk: Optional[int] = None  # KV-chunked (flash-style) attention:
                                      # bounds score materialization to S x C
    fast_decode_scores: bool = False  # bf16 scores + additive mask in decode
    paged_kernel: bool = False        # paged decode attention via the Pallas
                                      # gather kernel (kernels/paged.py)

    # FFN / block details
    ffn_type: str = "swiglu"                     # swiglu|gelu|geglu|relu2
    norm_type: str = "rmsnorm"                   # rmsnorm|layernorm
    sandwich_norm: bool = False                  # gemma2 pre+post norms
    tie_embeddings: bool = True

    # mixture of experts (None = dense FFN)
    moe: Optional[MoEConfig] = None

    # state-space (None = no mamba layers)
    ssm: Optional[SSMConfig] = None
    layer_kind: str = "attn"          # "attn" | "mamba" | "hybrid"
    shared_attn_every: int = 0        # hybrid: shared attn block cadence
    # encoder-decoder
    encdec: bool = False
    n_enc_layers: int = 0
    # modality frontend stub: extra embedded inputs prepended to the sequence
    frontend: Optional[str] = None    # None | "audio" | "vision"
    n_frontend_tokens: int = 0        # patch/frame count at input_specs time

    # paper technique
    monarch: MonarchSpec = dataclasses.field(default_factory=MonarchSpec)
    # decode fast path: initialize Q/K/V (and gated-FFN up/gate) as single
    # widened projections so each weight visit amortizes more work (the CIM
    # co-activation analogue).  Existing checkpoints convert exactly via
    # models/fuse.py:fuse_model without this flag.
    fused_proj: bool = False

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # pad the embedding/logits vocab so it tiles the TP axis (padded slots
    # are masked to -inf in the head); e.g. granite 49155 -> 49408
    pad_vocab_to_multiple: int = 256

    # remat ("none" | "full" | "dots") — activation checkpointing policy.
    # "full" (recompute everything per scanned layer) is the default so
    # every assigned config fits 16 GB/chip; "dots" is a perf-loop knob.
    remat: str = "full"

    def __post_init__(self) -> None:
        if self.n_heads and self.d_model % self.n_heads and self.head_dim is None:
            raise ValueError("d_model not divisible by n_heads; set head_dim")
        if self.layer_kind in ("mamba", "hybrid") and self.ssm is None:
            raise ValueError(f"{self.layer_kind} model requires ssm config")

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def vocab_padded(self) -> int:
        m = self.pad_vocab_to_multiple
        return ((self.vocab + m - 1) // m) * m

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid memory)."""
        return self.layer_kind in ("mamba", "hybrid")

    def attn_kind(self, layer: int) -> str:
        return self.attn_pattern[layer % len(self.attn_pattern)]

    # ---- parameter accounting (roofline MODEL_FLOPS, DESIGN.md Sec. 7) ----

    def _mm(self, din: int, dout: int) -> int:
        """Parameters of one parameterized matmul under the active scheme
        (Monarch-factorized when the spec applies, else dense)."""
        if self.monarch.applies(din, dout):
            from repro_torch.core.monarch import make_dims

            return make_dims(din, dout, policy=self.monarch.policy,
                             nblocks=self.monarch.nblocks).params
        return din * dout

    def param_count(self) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd, h, kv = self.hd, self.n_heads, self.n_kv_heads
        per_attn = (self._mm(d, h * hd) + 2 * self._mm(d, kv * hd)
                    + self._mm(h * hd, d))
        gated = self.ffn_type in ("swiglu", "geglu")
        per_ffn_dense = self._mm(d, ff) * (2 if gated else 1) + self._mm(ff, d)
        if self.moe is not None:
            de = self.moe.d_expert or ff
            per_expert = self._mm(d, de) * (2 if gated else 1) + self._mm(de, d)
            per_ffn = (
                (self.moe.n_slots + self.moe.n_shared) * per_expert
                + d * self.moe.n_slots
            )
            active_ffn = (
                (self.moe.top_k + self.moe.n_shared) * per_expert
                + d * self.moe.n_slots
            )
        else:
            per_ffn = active_ffn = per_ffn_dense
        if self.layer_kind == "attn":
            per_layer = per_attn + per_ffn
            active_layer = per_attn + active_ffn
            n_attn_like = self.n_layers + self.n_enc_layers
            total = per_layer * self.n_layers + per_layer * self.n_enc_layers
            active = active_layer * self.n_layers + active_layer * self.n_enc_layers
            if self.encdec:  # decoder cross-attention
                total += per_attn * self.n_layers
                active += per_attn * self.n_layers
        else:
            s = self.ssm
            d_inner = s.expand * d
            nheads = d_inner // s.head_dim
            d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + nheads
            per_mamba = (
                self._mm(d, d_in_proj)                                   # in_proj
                + s.d_conv * (d_inner + 2 * s.n_groups * s.d_state)      # conv
                + nheads * 2                                             # A, D
                + self._mm(d_inner, d)                                   # out_proj
            )
            if self.layer_kind == "hybrid":
                n_attn = self.n_layers // max(self.shared_attn_every, 1)
                total = per_mamba * self.n_layers + per_attn + per_ffn * 0
                total += n_attn * 0  # shared weights counted once
                active = per_mamba * self.n_layers + per_attn * n_attn
            else:
                total = active = per_mamba * self.n_layers
        emb = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        return total + emb

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k only)."""
        if self.moe is None:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        de = self.moe.d_expert or ff
        gated = self.ffn_type in ("swiglu", "geglu")
        per_expert = self._mm(d, de) * (2 if gated else 1) + self._mm(de, d)
        inactive = (self.moe.n_slots - self.moe.top_k) * per_expert * self.n_layers
        return self.param_count() - inactive

    def reduced(self, seed_layers: int = 2) -> "ModelConfig":
        """Small same-family config for CPU smoke tests (one fwd/train step)."""
        changes: dict[str, Any] = dict(
            d_model=128,
            n_layers=max(seed_layers, 2 if self.shared_attn_every == 0
                         else self.shared_attn_every + 1),
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256,
            vocab=512,
            head_dim=32,
            window=16,
            n_enc_layers=2 if self.encdec else 0,
            n_frontend_tokens=4 if self.frontend else 0,
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                n_shared=min(self.moe.n_shared, 1), d_expert=64,
            )
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=32, chunk=8,
            )
        if self.monarch.enable:
            changes["monarch"] = dataclasses.replace(self.monarch, min_dim=64)
        changes["dtype"] = "float32"
        return dataclasses.replace(self, **changes)


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig"]
