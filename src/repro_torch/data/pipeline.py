"""Deterministic synthetic LM data pipeline (a copy of
``repro.data.pipeline``, which is numpy only: the batches are bitwise the
reference's).  A train step puts them on its own device.

Generates a *learnable* token stream (a mixture of k-gram templates with
noise) so the end-to-end example's loss demonstrably falls, plus the
machinery a real pipeline needs: host-sharded slicing (each data-parallel
host reads only its rows), document packing with EOS separators, loss
masking, and a double-buffered prefetch iterator.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_templates: int = 64       # k-gram patterns the model can learn
    template_len: int = 16
    noise: float = 0.05
    eos_id: int = 0
    host_index: int = 0         # this host's position in the data axis
    host_count: int = 1


def _templates(cfg: DataConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed)
    return rng.integers(1, cfg.vocab, size=(cfg.n_templates, cfg.template_len))


def synthetic_stream(cfg: DataConfig) -> Iterator[np.ndarray]:
    """Yields packed (local_batch, seq_len+1) token rows forever.

    Documents are sampled template repetitions with flip noise, packed
    back-to-back with EOS separators (GPT-style packing)."""
    assert cfg.global_batch % cfg.host_count == 0
    local_batch = cfg.global_batch // cfg.host_count
    temps = _templates(cfg)
    rng = np.random.default_rng((cfg.seed, cfg.host_index))
    while True:
        rows = np.empty((local_batch, cfg.seq_len + 1), dtype=np.int32)
        for b in range(local_batch):
            buf = []
            while len(buf) < cfg.seq_len + 1:
                t = temps[rng.integers(0, cfg.n_templates)]
                reps = rng.integers(1, 4)
                doc = np.tile(t, reps)
                flip = rng.random(doc.shape) < cfg.noise
                doc = np.where(flip, rng.integers(1, cfg.vocab, doc.shape), doc)
                buf.extend(doc.tolist())
                buf.append(cfg.eos_id)
            rows[b] = np.asarray(buf[: cfg.seq_len + 1], dtype=np.int32)
        yield rows


def make_batches(cfg: DataConfig, prefetch: int = 2) -> Iterator[dict]:
    """Prefetched {tokens, labels, loss_mask} batches (next-token shift)."""
    stream = synthetic_stream(cfg)

    def produce(rows: np.ndarray) -> dict:
        tokens = rows[:, :-1]
        labels = rows[:, 1:]
        mask = (labels != cfg.eos_id).astype(np.float32)
        return {"tokens": tokens, "labels": labels, "loss_mask": mask}

    if prefetch <= 0:
        for rows in stream:
            yield produce(rows)
        return

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        for rows in stream:
            if stop.is_set():
                return
            q.put(produce(rows))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()


__all__ = ["DataConfig", "synthetic_stream", "make_batches"]
