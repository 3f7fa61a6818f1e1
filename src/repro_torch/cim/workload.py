"""Transformer workload descriptions for the CIM simulator.

The paper evaluates BERT-large (encoder-only, ctx 512), BART-large
(encoder-decoder, ctx 1024) and GPT-2-medium (decoder-only, ctx 1024); the
assigned-architecture configs (repro_torch.configs) export the same description via
``cim_workload()`` so every arch can be pushed through the CIM flow too.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

from repro_torch.core.monarch import MonarchDims, make_dims


@dataclasses.dataclass(frozen=True)
class MatmulDesc:
    """One parameterized matmul (weights live on CIM arrays)."""

    name: str
    din: int
    dout: int
    input_id: str          # matmuls sharing input_id may be co-activated
    count: int = 1         # identical instances per layer (e.g. per expert)


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    """One repeated layer: parameterized matmuls + fixed DPU ops.

    ``fixed_ops`` maps Table-I op kind -> count per token per layer.
    ``stages`` lists sequential groups of matmul names; matmuls inside a
    group are independent (parallel arrays), groups are sequential.
    """

    matmuls: tuple[MatmulDesc, ...]
    stages: tuple[tuple[str, ...], ...]
    fixed_ops: tuple[tuple[str, int], ...]
    count: int = 1  # how many such layers


@dataclasses.dataclass(frozen=True)
class ModelDesc:
    name: str
    d_model: int
    seq_len: int
    n_heads: int
    layers: tuple[LayerDesc, ...]
    vocab: int = 0
    tied_head: bool = True

    @property
    def n_layers(self) -> int:
        return sum(l.count for l in self.layers)

    def para_matmul_params(self) -> int:
        return sum(
            m.din * m.dout * m.count * l.count for l in self.layers for m in l.matmuls
        )

    def monarch_params(self, policy: str = "paper") -> int:
        total = 0
        for l in self.layers:
            for m in l.matmuls:
                dims = make_dims(m.din, m.dout, policy=policy)
                total += dims.params * m.count * l.count
        return total

    def embedding_params(self) -> int:
        return self.vocab * self.d_model

    def para_matmul_flops(self) -> int:
        """Per forward pass of seq_len tokens (dense)."""
        return 2 * self.seq_len * self.para_matmul_params()

    def monarch_flops(self, policy: str = "paper") -> int:
        return 2 * self.seq_len * self.monarch_params(policy)

    def nonpara_matmul_flops(self) -> int:
        """Attention scores + AV (activation-only matmuls, untransformed)."""
        attn_layers = sum(
            l.count for l in self.layers if any("wq" in m.name for m in l.matmuls)
        )
        cross = sum(
            l.count for l in self.layers if any("xq" in m.name for m in l.matmuls)
        )
        per_layer = 2 * 2 * self.seq_len * self.seq_len * self.d_model
        return (attn_layers + cross) * per_layer

    def head_flops(self) -> int:
        return 2 * self.seq_len * self.vocab * self.d_model


def _attn_ffn_layer(d: int, ff: int, cross: bool, act: str, count: int) -> LayerDesc:
    mm = [
        MatmulDesc("wq", d, d, "x_attn"),
        MatmulDesc("wk", d, d, "x_attn"),
        MatmulDesc("wv", d, d, "x_attn"),
        MatmulDesc("wo", d, d, "attn_out"),
        MatmulDesc("ffn1", d, ff, "x_ffn"),
        MatmulDesc("ffn2", ff, d, "ffn_mid"),
    ]
    stages = [("wq", "wk", "wv"), ("wo",), ("ffn1",), ("ffn2",)]
    fixed = [("layernorm", 2), ("add", 2), (act, 1), ("comm", 2)]
    if cross:
        mm += [
            MatmulDesc("xq", d, d, "x_cross"),
            MatmulDesc("xk", d, d, "enc_out"),
            MatmulDesc("xv", d, d, "enc_out"),
            MatmulDesc("xo", d, d, "cross_out"),
        ]
        stages = [("wq", "wk", "wv"), ("wo",), ("xq", "xk", "xv"), ("xo",),
                  ("ffn1",), ("ffn2",)]
        fixed = [("layernorm", 3), ("add", 3), (act, 1), ("comm", 3)]
    return LayerDesc(
        matmuls=tuple(mm), stages=tuple(stages), fixed_ops=tuple(fixed), count=count
    )


def bert_large() -> ModelDesc:
    return ModelDesc(
        name="bert-large",
        d_model=1024,
        seq_len=512,
        n_heads=16,
        vocab=30522,
        layers=(_attn_ffn_layer(1024, 4096, cross=False, act="gelu", count=24),),
    )


def gpt2_medium() -> ModelDesc:
    return ModelDesc(
        name="gpt2-medium",
        d_model=1024,
        seq_len=1024,
        n_heads=16,
        vocab=50257,
        layers=(_attn_ffn_layer(1024, 4096, cross=False, act="gelu", count=24),),
    )


def bart_large() -> ModelDesc:
    return ModelDesc(
        name="bart-large",
        d_model=1024,
        seq_len=1024,
        n_heads=16,
        vocab=50265,
        layers=(
            _attn_ffn_layer(1024, 4096, cross=False, act="gelu", count=12),
            _attn_ffn_layer(1024, 4096, cross=True, act="gelu", count=12),
        ),
    )


def decode_kv_bytes_per_token(cfg, kv_bits: int = 32) -> float:
    """Bytes of KV cache one token appends (and every later decode step
    re-reads) across the stack, at the STORED width of the serving pool's
    pages: ``kv_bits`` is 32 for fp32 pages, 16 bf16, 8 int8.  Shared by
    both serving cost models — the HBM roofline streams these bytes per
    gathered key, and the CIM DPU term clocks its digital attention
    matmuls on the same movement (weights sit in the arrays; the KV stream
    is what scales with context) — so admission, chunking and preemption
    decisions all shift when the pool compresses.  The int8 pool's
    per-(page, head) fp32 scales are O(1/page_size) of the rows and are
    deliberately left out of the per-token figure."""
    return 2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * (kv_bits / 8.0)


def decode_workload(cfg, seq_len: int = 512,
                    fused_proj: bool = False) -> ModelDesc:
    """ModelDesc for one decode step of a ``repro_torch.models.config.ModelConfig``
    attention stack — the workload the serving scheduler's CIM cost model
    pushes through ``simulate`` to price a batch's per-token latency/energy.

    Covers GQA projections and (gated) FFN matmuls; MoE / SSM stacks fall
    back to their dense-FFN equivalent for costing purposes.
    ``fused_proj`` prices the decode fast path (models/fuse.py): Q/K/V and
    FFN up/gate are single widened matmuls, so each stage is one
    co-activated array group instead of three, matching what the runtime
    actually dispatches.
    """
    d, hd = cfg.d_model, cfg.hd
    h, kv, ff = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    gated = cfg.ffn_type in ("swiglu", "geglu")
    if fused_proj:
        up = MatmulDesc("ffn1g" if gated else "ffn1", d,
                        2 * ff if gated else ff, "x_ffn")
        if h == kv:  # full QKV fusion (models/fuse.py)
            attn_in = [MatmulDesc("wqkv", d, (h + 2 * kv) * hd, "x_attn")]
        else:        # GQA: the runtime keeps wq separate and fuses K/V only
            attn_in = [MatmulDesc("wq", d, h * hd, "x_attn"),
                       MatmulDesc("wkv", d, 2 * kv * hd, "x_attn")]
        mm = attn_in + [
            MatmulDesc("wo", h * hd, d, "attn_out"),
            up,
            MatmulDesc("ffn2", ff, d, "ffn_mid"),
        ]
        stages = [tuple(m.name for m in attn_in), ("wo",), (up.name,),
                  ("ffn2",)]
    else:
        mm = [
            MatmulDesc("wq", d, h * hd, "x_attn"),
            MatmulDesc("wk", d, kv * hd, "x_attn"),
            MatmulDesc("wv", d, kv * hd, "x_attn"),
            MatmulDesc("wo", h * hd, d, "attn_out"),
            MatmulDesc("ffn1", d, ff, "x_ffn"),
            MatmulDesc("ffn2", ff, d, "ffn_mid"),
        ]
        stages = [("wq", "wk", "wv"), ("wo",), ("ffn1",), ("ffn2",)]
        if gated:
            mm.append(MatmulDesc("ffng", d, ff, "x_ffn"))
            stages = [("wq", "wk", "wv"), ("wo",), ("ffn1", "ffng"),
                      ("ffn2",)]
    layer = LayerDesc(
        matmuls=tuple(mm),
        stages=tuple(stages),
        fixed_ops=(("layernorm", 2), ("add", 2), ("gelu", 1), ("comm", 2)),
        count=cfg.n_layers,
    )
    return ModelDesc(
        name=f"{cfg.name}-decode",
        d_model=d,
        seq_len=seq_len,
        n_heads=h,
        vocab=cfg.vocab,
        layers=(layer,),
    )


PAPER_MODELS = {"bert-large": bert_large, "bart-large": bart_large,
                "gpt2-medium": gpt2_medium}


__all__ = [
    "MatmulDesc",
    "LayerDesc",
    "ModelDesc",
    "bert_large",
    "bart_large",
    "gpt2_medium",
    "decode_workload",
    "decode_kv_bytes_per_token",
    "PAPER_MODELS",
]
