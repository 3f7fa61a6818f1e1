"""Gradient compression with error feedback (port of
``repro.ft.compression``): int8 quantization of each gradient leaf with one
scale, the quantization residual kept locally and re-injected at the next
step (Seide et al. 2014 / Karimireddy et al. 2019).

A train-step transform: ``compressed_gradients`` maps the raw gradients to
what an int8-compressed all-reduce would carry.  Under a ``("data",
"model")`` mesh (``launch.steps``) the gradients are a rank's shards of
the summed gradients and the error feedback is kept per shard; each
leaf's scale is its WHOLE leaf's (``leaf_max`` maps the shards' abs-max
to the leaf's), so a shard is quantized as one process quantizes the
leaf.
"""

from __future__ import annotations

import torch

from repro_torch import tree_map


def _quantize_int8(x: torch.Tensor, amax=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    scale = (torch.max(torch.abs(x)) if amax is None else amax) / 127.0 \
        + 1e-12
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
def compressed_gradients(grads, ef_state, leaf_max=None):
    """Returns (decompressed grads, new error-feedback state).
    ``leaf_max``: None, or a map from the leaves' abs-max over this
    rank's shards (in sorted leaf order) to their whole leaves'."""
    from repro_torch.optim.adamw import leaves_with_paths

    g32s = tree_map(lambda g, e: g.to(torch.float32) + e, grads, ef_state)
    amax = None
    if leaf_max is not None:
        paths = leaves_with_paths(g32s)
        got = leaf_max([torch.max(torch.abs(t)) for _, t in paths])
        amax = {path: m for (path, _), m in zip(paths, got)}

    def walk(g, g32, prefix=()):
        if isinstance(g, dict):
            return {k: walk(g[k], g32[k], prefix + (k,)) for k in g}
        deq = _dequantize(*_quantize_int8(
            g32, None if amax is None else amax[prefix]))
        return deq.to(g.dtype), g32 - deq

    pairs = walk(grads, g32s)
    return (tree_map(lambda t: t[0], pairs),
            tree_map(lambda t: t[1], pairs))


__all__ = ["compress_state_init", "compressed_gradients"]
