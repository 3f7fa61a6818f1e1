"""Decode fast-path preparation and the per-layer decode step (port of
``repro.models.decode_path``).

``prepare_decode_params`` applies the two load-time levers once: exact
projection fusion (``models/fuse.py``: Q/K/V collapse into one widened
Monarch matmul) and per-block int8/int4 quantization of the Monarch factors
(``core/quant.py``), which the kernels dequantize on chip.  The prepared
tree keeps the stacked leading layer axis.

``decode_step_layerwise`` is the reference's per-layer decode step: a
Python loop that slices each layer from the stacked trees and runs it
alone, the same operations as ``transformer.decode_step``.  The reference
keeps it as a parity oracle and as the dispatch-chain baseline its
compiled step is timed against; in the port, ``decode_step`` is what the
legacy engine captures as one CUDA graph, and this loop is issued op by
op.  ``layer_slice`` returns views, so the ring is written in place.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core import quant as qn
from repro_torch.models import fuse as F
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def prepare_decode_params(params: Any, cfg: ModelConfig, *,
                          fuse: bool = True,
                          bits: Optional[int] = None) -> Any:
    """Fused projections, then (optionally) int8/int4 per-block quantized
    Monarch factors.  Exact for fusion; the quantization error is bounded
    per block (``quant.quant_error_stats``).  Runs on the tensors' own
    device."""
    if fuse:
        params = F.fuse_model(params)
    if bits is not None:
        params = qn.quantize_tree(params, bits)
    return params


def layer_slice(tree: Any, i: int) -> Any:
    """Layer ``i``'s slice of a layer-stacked parameter or cache tree
    (views, no copies)."""
    return T.layer_params(tree, i)


def decode_step_layerwise(params: Any, tokens: torch.Tensor, cache: dict,
                          cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """Per-layer twin of ``transformer.decode_step`` for attention stacks:
    each layer sliced from the stacked trees and run on its own, the ring
    written in place and ``pos`` advanced by one.  Returns (fp32 logits
    (B, Vp), the same cache)."""
    if cfg.layer_kind != "attn":
        raise ValueError("the layerwise decode covers attention stacks")
    dtype = T._dtype(cfg)
    pos = cache["pos"]
    x = L.embed(params["embedding"], tokens[:, None], cfg, dtype)
    for i, win in enumerate(T.layer_windows(cfg)):
        x = T.attn_block_apply(
            layer_slice(params["decoder"]["layers"], i), x, cfg, window=win,
            cache=layer_slice(cache["layers"], i), pos=pos)
    x = L.norm_apply(params["ln_f"], x, cfg.norm_type)
    logits = L.unembed(params["embedding"], x, cfg)
    pos.add_(1)
    return logits[:, 0], cache


def decode_weight_bytes(params: Any) -> int:
    """Weight bytes the decode step streams per token step (the whole
    decoder + head): the quantity the int8/int4 path compresses."""
    return qn.tree_weight_bytes(params)


__all__ = ["prepare_decode_params", "decode_step_layerwise", "layer_slice",
           "decode_weight_bytes"]
