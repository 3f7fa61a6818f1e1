"""KV-page width bookkeeping (subset of ``repro.core.quant``).

Only what the serving engine needs to size its pool is here.  Factor and
KV-page quantization, and the kernels that dequantize on chip, come with
the port of the quantized kernels (``monarch_fused_q``, ``bdmm_q`` and the
int8-page span kernel).
"""

from __future__ import annotations

from typing import Any

BITS_BY_NAME = {"int8": 8, "int4": 4}  # engine/CLI mode names -> bit widths

# engine/pool ``kv_dtype`` mode names -> stored bytes per KV element
KV_DTYPE_BYTES = {"fp32": 4.0, "bf16": 2.0, "int8": 1.0}


def kv_page_bytes(n_layers: int, n_kv_heads: int, head_dim: int,
                  page_size: int, kv_dtype: str = "fp32") -> int:
    """Physical bytes one KV page pins across the whole stack: k+v rows at
    the stored width, plus (int8 only) the per-(page, head) fp32 scales."""
    try:
        itemsize = KV_DTYPE_BYTES[kv_dtype]
    except KeyError:
        raise ValueError(
            f"kv_dtype must be one of {sorted(KV_DTYPE_BYTES)}, "
            f"got {kv_dtype!r}") from None
    data = 2 * n_layers * n_kv_heads * head_dim * page_size * itemsize
    scales = 2 * n_layers * n_kv_heads * 4 if kv_dtype == "int8" else 0
    return int(data) + scales


def is_quantized(params: Any) -> bool:
    """A quantized Monarch container: int8/int4 factors plus scales."""
    return isinstance(params, dict) and "Lq" in params and "Rq" in params


__all__ = ["BITS_BY_NAME", "KV_DTYPE_BYTES", "kv_page_bytes",
           "is_quantized"]
