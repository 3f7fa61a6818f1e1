"""Decode fast-path preparation (port of ``repro.models.decode_path``,
``prepare_decode_params`` and ``decode_weight_bytes``).

``prepare_decode_params`` applies the two load-time levers once: exact
projection fusion (``models/fuse.py``: Q/K/V collapse into one widened
Monarch matmul) and per-block int8/int4 quantization of the Monarch factors
(``core/quant.py``), which the kernels dequantize on chip.  The prepared
tree keeps the stacked leading layer axis.  The reference's per-layer
``decode_step_layerwise`` needs the ring cache and is not ported yet.
"""

from __future__ import annotations

from typing import Any, Optional

from repro_torch.core import quant as qn
from repro_torch.models import fuse as F
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


def decode_weight_bytes(params: Any) -> int:
    """Weight bytes the decode step streams per token step (the whole
    decoder + head): the quantity the int8/int4 path compresses."""
    return qn.tree_weight_bytes(params)


__all__ = ["prepare_decode_params", "decode_weight_bytes"]
