"""Assigned input shapes and meta-tensor input specs per (arch, shape)
(port of ``repro.configs.shapes``).

Shapes (LM-family, per the assignment):
  train_4k    seq_len=4096    global_batch=256   -> train_step
  prefill_32k seq_len=32768   global_batch=32    -> serve prefill
  decode_32k  seq_len=32768   global_batch=128   -> serve decode (1 token,
                                                    KV/state cache of 32k)
  long_500k   seq_len=524288  global_batch=1     -> decode; requires
                                                    sub-quadratic memory ->
                                                    SSM/hybrid only

Frontend conventions: for [vlm]/[audio] archs the modality tokens are
*part of* the assigned sequence length -- the frontend embeddings are
precomputed stand-ins supplied by ``input_specs``.

The reference's ``jax.ShapeDtypeStruct`` stand-ins are meta tensors
here: a shape and a dtype, no storage.  The decode cache comes from
``transformer.init_decode_cache(..., device="meta")``, so it has the
port's layout, whose Mamba ``conv`` state is stored in fp32 where the
reference's is in the model dtype (``models/mamba2.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    step: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def _spec(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def cell_supported(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Is (arch, shape) a live cell?  Returns (ok, reason-if-skipped)."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "long_500k needs sub-quadratic attention/state memory; "
            f"{cfg.name} is a pure full-attention architecture (skip per "
            "assignment; DESIGN.md Sec. 6)"
        )
    return True, ""


def input_specs(cfg: ModelConfig, shape: str,
                dtype: torch.dtype = torch.bfloat16) -> dict[str, Any]:
    """Meta-tensor stand-ins for every model input of one cell.

    For ``train``/``prefill`` this is the token batch (plus frontend
    embeddings); for ``decode`` it is the one-token batch -- the cache is
    constructed separately by ``decode_cache_specs`` (it is carried state,
    not an input of the request).
    """
    cell = SHAPES[shape]
    B, S = cell.global_batch, cell.seq_len
    i32 = torch.int32
    if cell.step in ("train", "prefill"):
        if cfg.encdec:
            s_enc = min(cfg.n_frontend_tokens, S // 2) or S // 2
            s_dec = S - s_enc
            specs = {
                "enc_embeds": _spec((B, s_enc, cfg.d_model), dtype),
                "tokens": _spec((B, s_dec), i32),
            }
            if cell.step == "train":
                specs["labels"] = _spec((B, s_dec), i32)
            return specs
        if cfg.frontend == "vision":
            n_patch = min(cfg.n_frontend_tokens, S // 2)
            specs = {
                "patch_embeds": _spec((B, n_patch, cfg.d_model), dtype),
                "tokens": _spec((B, S - n_patch), i32),
            }
            if cell.step == "train":
                specs["labels"] = _spec((B, S - n_patch), i32)
            return specs
        specs = {"tokens": _spec((B, S), i32)}
        if cell.step == "train":
            specs["labels"] = _spec((B, S), i32)
        return specs
    # decode: one new token per request
    return {"tokens": _spec((B,), i32)}


def decode_cache_specs(cfg: ModelConfig, shape: str) -> Any:
    """The decode cell's cache as meta tensors (seq_len = cache length)."""
    cell = SHAPES[shape]
    from repro_torch.models import transformer as T

    return T.init_decode_cache(cfg, cell.global_batch, cell.seq_len,
                               device="meta")


def enc_out_specs(cfg: ModelConfig, shape: str,
                  dtype: torch.dtype = torch.bfloat16):
    """Cross-attention memory for enc-dec decode cells (encoder output)."""
    if not cfg.encdec:
        return None
    cell = SHAPES[shape]
    return _spec((cell.global_batch, cfg.n_frontend_tokens, cfg.d_model),
                 dtype)


__all__ = [
    "SHAPES",
    "ShapeCell",
    "cell_supported",
    "input_specs",
    "decode_cache_specs",
    "enc_out_specs",
]
