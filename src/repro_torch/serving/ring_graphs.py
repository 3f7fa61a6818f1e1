"""The legacy engine's decode step as CUDA graphs: the port's counterpart of
the reference's ``_ring_decode_jit`` (``repro/serving/engine.py:220-223``),
which compiles ``transformer.decode_step`` with the ring cache donated.

:class:`RingDecode` is called as that jitted step is, ``(params, tokens,
cache) -> (logits, cache)``.  With graphs (on the card), each ring it is
handed -- one a (batch size, ``max_len``) -- gets one graph through
:class:`~repro_torch.serving.step_graphs.StepGraphs`, under its rules: the
ring's first step runs eagerly on a static copy of the token input and
is then captured on that buffer; every later step copies its tokens into
the buffer and replays; the launches a replay runs are counted as the
eager step's; a failed capture or replay raises.  The ring (K, V, a
Mamba stack's ``conv`` and ``ssm`` states and ``pos``) and the params are
the graph's state, read and written in place, so a ring must be handed the same params and the same cache every
time (the legacy engine keeps one ring a batch size): anything else
raises.  The logits are the graph's static output, valid until that
ring's next step.

The prefill (``_ring_prefill_jit``'s counterpart) stays eager: the
reference retraces it for every prompt shape.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serving.step_graphs import StepGraphs


def _copy_in(tokens: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The graph's static token input: a copy of ``tokens``, or ``tokens``
    copied into it."""
    return tokens.clone() if out is None else out.copy_(tokens)


def _ring_len(cache: dict) -> int:
    """The ring's ``max_len`` (0 for a Mamba stack, which keeps no ring)."""
    attn = cache.get("layers", {}).get("attn") \
        or cache.get("groups", {}).get("attn")
    return attn["k"].shape[-3] if attn else 0


class RingDecode:
    """``transformer.decode_step`` of ``cfg``, eager, or with ``graphs``
    one graph a ring (``new_graph`` makes a graph object, as
    :class:`StepGraphs` takes it; by default a CUDA graph)."""

    def __init__(self, cfg: ModelConfig, graphs: bool,
                 new_graph: Optional[Callable[[], object]] = None):
        self.cfg = cfg
        self.graphs = (StepGraphs(self._step, new_graph=new_graph)
                       if graphs else None)
        self._bound: dict = {}     # (B, max_len) -> (params, cache)

    def _step(self, tokens: torch.Tensor, ring) -> tuple:
        params, cache = self._bound[ring]
        logits, _ = T.decode_step(params, tokens, cache, self.cfg)
        return (logits,)

    def __call__(self, params, tokens: torch.Tensor, cache: dict):
        if self.graphs is None:
            return T.decode_step(params, tokens, cache, self.cfg)
        ring = (tokens.shape[0], _ring_len(cache))
        bound = self._bound.setdefault(ring, (params, cache))
        if bound[0] is not params or bound[1] is not cache:
            raise ValueError(
                f"the decode graph of ring {ring} was captured on other "
                f"params or another cache: hand it the same ones")
        (logits,) = self.graphs.run(ring, tokens, _copy_in)
        return logits, cache


__all__ = ["RingDecode"]
