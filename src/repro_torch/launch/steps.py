"""The serving steps (port of the serving half of ``repro.launch.steps``).

``make_prefill_step`` and ``make_decode_step`` return the functions the
reference jits for its server: parameters are kept fp32 (the master copy)
and cast to the model's compute dtype at the top of each step
(``_compute_cast``: fp32 leaves to bf16 for a bf16 config).  The reference
lets XLA fuse those casts into their first consumers; here the cast is
one copy of the fp32 leaves a call.

The reference's prefill step returns the last position's logits only,
and its ``prefill_with_cache`` takes no ``enc_out``: an encoder-decoder
model is served by ``transformer._encode``, then its prompt token by
token through ``make_decode_step(cfg)(params, tok, cache, enc_out)``
into a ring, then the new tokens the same way.  The training steps and
the shardings are not ported.
"""

from __future__ import annotations

import torch

from repro_torch import tree_map
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def _compute_cast(params, cfg: ModelConfig):
    """fp32 leaves cast to bf16 for a bf16 config; any other leaf (an int8
    or int4 container's, a bf16 one) as it is."""
    if cfg.dtype != "bfloat16":
        return params

    def cast(p):
        return p.to(torch.bfloat16) if p.dtype == torch.float32 else p

    return tree_map(cast, params)


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch)`` -> the last position's fp32 logits
    (B, Vp) of a full forward (``transformer.prefill``)."""
    def prefill_step(params, batch):
        return T.prefill(_compute_cast(params, cfg), batch, cfg)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_step(params, tokens, cache, enc_out=None)`` -> (fp32 logits
    (B, Vp), the cache advanced in place); an encoder-decoder model
    cross-attends ``enc_out``."""
    def decode_step(params, tokens, cache, enc_out=None):
        p = _compute_cast(params, cfg)
        if cfg.encdec:
            return T.decode_step(p, tokens, cache, cfg, enc_out=enc_out)
        return T.decode_step(p, tokens, cache, cfg)

    return decode_step


__all__ = ["make_prefill_step", "make_decode_step"]
