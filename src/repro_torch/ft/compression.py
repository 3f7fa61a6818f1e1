"""Gradient compression with error feedback (port of
``repro.ft.compression``): int8 quantization of each gradient leaf with one
scale, the quantization residual kept locally and re-injected at the next
step (Seide et al. 2014 / Karimireddy et al. 2019).

A train-step transform: ``compressed_gradients`` maps the raw gradients to
what an int8-compressed all-reduce would carry.  The port has one data
rank, so nothing is reduced; on a deployment with a ``"data"`` axis the
compress/decompress pair would bracket the gradients' all-reduce.
"""

from __future__ import annotations

import torch

from repro_torch import tree_map


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_state_init(params):
    """Error-feedback residual buffers, fp32 zeros, one per parameter
    leaf."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params)


@torch.no_grad()
def compressed_gradients(grads, ef_state):
    """Returns (decompressed grads, new error-feedback state)."""

    def one(g, e):
        g32 = g.to(torch.float32) + e
        deq = _dequantize(*_quantize_int8(g32))
        return deq.to(g.dtype), g32 - deq

    pairs = tree_map(one, grads, ef_state)
    return (tree_map(lambda t: t[0], pairs),
            tree_map(lambda t: t[1], pairs))


__all__ = ["compress_state_init", "compressed_gradients"]
