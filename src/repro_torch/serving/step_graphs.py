"""The engine step as CUDA graphs: the port's counterpart of the
reference's ``_mixed_step_jit`` (``repro/serving/engine.py:175-180``), which
compiles a whole engine iteration -- embed, every layer, unembed, the key
split and the token draw -- into one program with the pool donated.

The engine's shapes are static within a span bucket (B = ``max_slots``
rows, S = ``_bucket(max span)`` tokens, a page table ``max_pages_per_seq``
wide), and whether any row may draw at a temperature > 0 is known on the
host (the reference decides it with a ``lax.cond``), so a bucket is the
pair (S, draw) and :class:`StepGraphs` holds one graph a bucket (a greedy
batch replays a graph without the draw, still with the key split):

* **Capture after the first step.**  A bucket's first step runs eagerly on
  its new static input buffer, and that run IS the step; the bucket is then
  captured on the same buffer.  A capture executes nothing, so the pool is
  written once.  The eager run has also launched every kernel the capture
  records once (lazy module loads and shared-memory attributes happen
  outside the capture).
* **Replay.**  A later step of the bucket uploads its packed buffer into
  the static one (the engine's pinned ring, ``non_blocking``) and replays.
  The chained token, the slots' keys and the pool are read and written
  in place, so nothing is rebound.  All graphs share one memory pool and replay strictly in
  turn on one stream.
* **Outputs.**  A graph's outputs are static: the next replay of the same
  graph overwrites them.  The sampled tokens are read one step late (the
  harvest lag), so :meth:`StepGraphs.run` returns a clone of them, taken on
  the same stream right after the replay; the logits it returns are the
  static tensor, valid until the bucket's next replay.
* **Launch counts.**  ``kernels.LAUNCHES`` counts on the host, so a capture
  counts launches that never ran and a replay counts none.  The capture's
  counts are taken back and become the bucket's launches, which every
  replay adds: ``kernels.launches()`` reads the same per step as eagerly.

A failed capture or replay raises; nothing falls back to eager steps.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.kernels import _build, paged


class CudaStepGraph:
    """One captured step on the card (``torch.cuda.CUDAGraph`` in the
    shared memory pool ``mempool``).

    Python's garbage collector is held off during the capture: a
    collection there may free an engine nobody holds any more (an engine
    and its graphs form a reference cycle), and CUDA refuses to destroy
    that engine's graphs while a stream captures, which invalidates the
    capture.  ``torch.cuda.graph`` collects just before it begins."""

    def __init__(self, mempool):
        self._graph = torch.cuda.CUDAGraph()
        self._mempool = mempool

    def capture(self, fn: Callable):
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self._graph, pool=self._mempool):
                return fn()
        finally:
            if collecting:
                gc.enable()

    def replay(self) -> None:
        self._graph.replay()


@dataclasses.dataclass
class _Bucket:
    graph: object
    inputs: torch.Tensor           # the static packed input buffer
    sampled: torch.Tensor          # static outputs
    logits: torch.Tensor
    launches: dict[str, int]       # kernel launches a replay runs
    keep: tuple                    # buffers the graph's kernels use


class StepGraphs:
    """One graph a bucket over ``step(packed, bucket) -> (sampled,
    logits)``, the engine step on a packed device buffer (with the chained
    token and the keys updated in place); a bucket is any hashable key,
    the engine's (S, draw).  ``new_graph`` makes a graph object with
    ``capture(fn) -> outputs`` and ``replay()``; by default a
    :class:`CudaStepGraph` in one memory pool shared by every bucket.

    ``captures`` and ``replays`` count the graph work; ``replay_s`` is the
    host's time inside the replays (launching a graph, not running it)."""

    def __init__(self, step: Callable,
                 new_graph: Optional[Callable[[], object]] = None):
        if new_graph is None:
            mempool = torch.cuda.graph_pool_handle()
            new_graph = lambda: CudaStepGraph(mempool)  # noqa: E731
        self._step = step
        self._new_graph = new_graph
        self._buckets: dict = {}
        self.captures = 0
        self.replays = 0
        self.replay_s = 0.0

    @property
    def buckets(self) -> list:
        return sorted(self._buckets)

    def run(self, S, packed: np.ndarray,
            upload: Callable) -> tuple[torch.Tensor, torch.Tensor]:
        """One step of bucket ``S`` on the host's ``packed`` int32 buffer,
        moved to the card by ``upload(packed, out=None)`` (a new device
        tensor, or a copy into ``out``).  Returns (sampled tokens, owned by
        the caller; logits, valid until the bucket's next step)."""
        b = self._buckets.get(S)
        if b is None:
            buf = upload(packed)
            out = self._step(buf, S)      # eager: this run is the step
            self._capture(S, buf)
            return out
        upload(packed, out=b.inputs)
        t0 = time.perf_counter()
        b.graph.replay()
        self.replay_s += time.perf_counter() - t0
        for name, n in b.launches.items():
            _build.LAUNCHES[name] += n
        self.replays += 1
        return b.sampled.clone(), b.logits

    def _capture(self, S, buf: torch.Tensor) -> None:
        before = dict(_build.LAUNCHES)
        graph = self._new_graph()
        sampled, logits = graph.capture(lambda: self._step(buf, S))
        launched = {name: n - before.get(name, 0)
                    for name, n in _build.LAUNCHES.items()
                    if n != before.get(name, 0)}
        for name, n in launched.items():   # the capture ran nothing
            _build.LAUNCHES[name] -= n
        # the span kernel's workspace: a later, larger launch may replace
        # it, and the graph launches on it for as long as it lives
        self._buckets[S] = _Bucket(graph, buf, sampled, logits, launched,
                                   paged.workspaces())
        self.captures += 1


__all__ = ["StepGraphs", "CudaStepGraph"]
