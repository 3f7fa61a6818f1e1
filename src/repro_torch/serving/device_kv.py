"""DeviceKV: the device-resident half of the paged KV pool, mesh-aware
(port of ``repro.serving.device_kv``).

Ownership contract (the other half lives in ``kv_pool.PagedKVPool``):

  * **Replicated on host** — page tables, the refcounted prefix trie, free
    lists, cursors.  The host pool plans in *logical* pages and never sees
    a shard, so preemption, COW planning, prefix matching and admission
    are the same decisions at every ``tp``.
  * **Sharded on device** — each rank holds its own local pool: page
    buffers ``(L, P, page, KV / kv_shard, hd)`` and, for int8 pages, scale
    rows ``(L, P, KV / kv_shard)``, the KV heads of its slice of the
    ``"model"`` axis.  A KV-head count the axis does not divide leaves the
    pool whole on every rank (``kv_shard == 1``) — GQA-correct, never
    uneven.
  * **Who may write a page** — only the mixed step's span writes and
    ``cow_copy_pages``.  Both work on the page axis (axis 1), which is
    never split, so every rank does the same page-granular writes on its
    own heads: no traffic between ranks for writes or COW forks.
  * **Transfer** — ``export()`` gathers every rank's heads into host
    tensors (the form is independent of ``tp``); ``load()`` re-slices a
    host tree onto this rank.  Both are collective-free on one rank and
    ``export`` is a collective under a split pool: every rank calls it.
  * ``check_shards()`` is the per-rank invariant: each leaf holds
    ``KV / kv_shard`` heads and the whole page axis, on the rank's device.

Without a plan (no mesh) the class is a thin owner of the single-device
pool.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tree_map
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import api


def kv_shard_size(cfg: ModelConfig, tp: int) -> int:
    """How many ways the pool's KV-head axis is split on a ``tp``-way
    ``"model"`` axis: ``tp`` when it divides both ``n_kv_heads`` and
    ``n_heads``, else 1 (replicated).  ``sharding.params.tp_plan`` applies
    it once, at load."""
    return tp if (api.divides(cfg.n_kv_heads, tp)
                  and api.divides(cfg.n_heads, tp)) else 1


def _kv_axis(leaf: torch.Tensor) -> int:
    return 3 if leaf.ndim == 5 else 2   # pages (L,P,pg,KV,hd); scales (L,P,KV)


class DeviceKV:
    """Owner of this rank's device-side paged pool (pages + int8 scales).

    The engine reads and writes ``self.pool`` in place; DeviceKV adds the
    placement (this rank's heads, as ``plan``, a
    ``sharding.params.TPPlan``, says), transfer (``export``/``load``) and
    the per-rank invariant."""

    def __init__(self, cfg: ModelConfig, n_pages: int, page_size: int,
                 kv_dtype: Optional[str] = None, plan=None,
                 device=None):
        self.cfg = cfg
        self.n_pages = n_pages
        self.page_size = page_size
        self.mesh = None if plan is None else plan.mesh
        self.kv_shard = 1 if plan is None else plan.kv_shard
        self.local_kv_heads = cfg.n_kv_heads // self.kv_shard
        self.pool = T.init_paged_pool(cfg, n_pages, page_size,
                                      kv_dtype=kv_dtype, device=device,
                                      n_kv_heads=self.local_kv_heads)

    def _heads(self):
        rank = 0 if self.mesh is None else self.mesh.rank
        return rank * self.local_kv_heads, self.local_kv_heads

    def export(self) -> dict:
        """Every rank's heads, gathered into one host tree (the same tree
        at every ``tp``).  A collective when the pool is split."""
        def one(leaf):
            if self.kv_shard > 1:
                leaf = api.all_gather_cat(leaf, self.mesh, dim=_kv_axis(leaf))
            return leaf.cpu()

        return tree_map(one, self.pool)

    def load(self, host_pool: dict) -> None:
        """Copy this rank's heads of a whole host tree into the pool."""
        lo, n = self._heads()

        def one(dst, src):
            if self.kv_shard > 1:
                src = src.narrow(_kv_axis(src), lo, n)
            dst.copy_(src)

        def walk(dst, src):
            for k, v in dst.items():
                if isinstance(v, dict):
                    walk(v, src[k])
                else:
                    one(v, src[k])

        walk(self.pool, host_pool)

    def check_shards(self) -> None:
        """Per-rank invariant: every leaf holds this rank's ``KV /
        kv_shard`` heads and the whole page axis, on the pool's device."""
        dev = None
        leaves: list = []
        tree_map(leaves.append, self.pool)
        for leaf in leaves:
            dev = dev or leaf.device
            assert leaf.device == dev, "pool leaves on different devices"
            assert leaf.shape[1] == self.n_pages, \
                f"page axis {leaf.shape[1]} != {self.n_pages}: pages split"
            assert leaf.shape[_kv_axis(leaf)] == self.local_kv_heads, \
                (tuple(leaf.shape), self.local_kv_heads)
        if self.mesh is not None and self.mesh.group is not None:
            assert dev == self.mesh.device, (dev, self.mesh.device)


__all__ = ["DeviceKV", "kv_shard_size"]
