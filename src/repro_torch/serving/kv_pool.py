"""Refcounted, prefix-sharing paged KV pool: fixed-size pages, per-sequence
page tables, and a radix/prefix trie over token IDs that lets sequences with
identical prompt prefixes share physical pages (copy-on-write for partial
pages).

This is the host-side bookkeeping half of the paged cache (the device half
— the per-layer page arrays — lives in ``models.transformer.init_paged_pool``
and is owned by the engine).  Memory is reserved per sequence in page
granules, so short and long sequences coexist without padding every slot to
``max_len``.

The pool is dtype-aware for *accounting*: the engine's ``kv_dtype`` flag
("fp32" | "bf16" | "int8") decides how many bytes each page physically pins
(int8 pages carry per-(page, head) fp32 scales on the device side), and a
byte-budgeted engine converts the budget into a page count — an int8 pool
gets ~4x the pages of an equal-budget fp32 pool, which is exactly the
headroom that turns prefix sharing into capacity (fewer preemptions at the
same byte budget).  Allocation itself stays page-granular and
width-oblivious; ``PoolStats`` reports the physical bytes.

Ownership contract (the refactor away from exclusive free-list ownership):

  * every live page carries a *sequence refcount* — the number of page
    tables containing it.  ``free(seq_id)`` decrements instead of releasing;
    a page returns to the free list only when no sequence holds it AND the
    trie does not cache it;
  * full pages whose tokens are entirely known are *committed* to the trie
    (``commit_prefix``) as the prefill cursor crosses their boundary: the
    trie maps page-sized token chunks to the physical page holding their KV.
    Committed pages outlive their sequence — after the last holder frees
    them they stay cached (reclaimable) until pool pressure evicts them
    LRU, leaves first;
  * a new sequence's prompt is matched against the trie
    (``match_prefix``/``acquire_prefix``): every matched full page is
    shared by refcount increment — zero new pages, zero prefill tokens.
    At least one token is always left to recompute (the sampler needs its
    logits), so a fully-cached prompt *forks* its last page copy-on-write:
    a private page is allocated, the shared page's rows are copied on
    device, and only the final token is recomputed.  The same COW fork
    serves partially-filled cached pages (a committed prompt tail shorter
    than one page);
  * writes are confined to pages with sequence refcount 1 that are not
    full-committed (``assert_writable``); shared pages are immutable
    history.  A sequence may keep appending to its own partially-committed
    tail page — the trie records how many rows were committed and later
    matches only those.

Page 0 is reserved as the sink page: free decode slots point their whole
page table at it, so their (masked, discarded) writes never touch live data.

Invariants (property-tested in tests/test_serving.py):
  * for every page, the number of page tables containing it equals its
    sequence refcount; trie-cached pages are additionally marked cached;
  * no page is simultaneously free and referenced (or cached);
  * free + live (referenced or cached) == n_pages - 1 (the sink is neither);
  * allocation fails cleanly (``PoolOOM``) rather than oversubscribing —
    after transparently reclaiming LRU cached-only pages.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional

SINK_PAGE = 0


class PoolOOM(RuntimeError):
    """No free (or reclaimable) pages for the requested reservation."""


@dataclasses.dataclass(frozen=True)
class PoolStats:
    n_pages: int           # usable pages (sink excluded)
    free_pages: int        # immediately free + reclaimable cached-only
    allocated_pages: int   # distinct live pages (referenced or cached)
    n_seqs: int
    utilization: float     # live tokens / reserved logical capacity
    shared_pages: int      # pages held by >= 2 sequences
    unique_pages: int      # distinct pages held by >= 1 sequence
    cached_pages: int      # trie-cached pages no sequence holds (reclaimable)
    prefix_hit_tokens: int    # cumulative tokens served from the trie
    prefix_hit_rate: float    # hit tokens / tokens looked up (0.0 before
                              # any request has been admitted)
    # dtype-aware physical accounting: what the pages actually weigh, so a
    # byte-budgeted deployment can compare fp32/bf16/int8 pools directly
    kv_dtype: str = "fp32"    # stored page width ("fp32" | "bf16" | "int8")
    page_bytes: int = 0       # physical bytes per page (k+v rows across the
                              # stack, plus int8 per-(page, head) scales)
    pool_bytes: int = 0       # page_bytes * usable pages (sink excluded)
    allocated_bytes: int = 0  # page_bytes * allocated_pages
    # high-water marks: the most pages (referenced or cached) the pool ever
    # held at once, and their physical weight — what a capacity planner
    # sizes against, since exit-time occupancy hides the mid-run peak
    peak_pages: int = 0
    peak_bytes: int = 0
    # LRU reclaim pressure: cached-only pages evicted from the trie because
    # an allocation needed them (0 == the cache never had to shrink)
    cache_evictions: int = 0
    # tensor parallelism: how many mesh shards split the KV-head axis
    # (DeviceKV), and what ONE shard physically stores per logical page —
    # page_bytes stays the GLOBAL footprint across all shards, so capacity
    # planning per device reads shard_page_bytes
    kv_shard: int = 1
    shard_page_bytes: int = 0


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Result of a trie lookup over a token sequence.

    ``n_tokens`` tokens of KV already live in the pool: ``pages`` full pages
    acquired by refcount (no new pages, no recompute), plus — when ``cow``
    is set — one copy-on-write fork: ``cow = (src_page, n_rows)`` means a
    fresh private page must be allocated and ``src_page``'s first ``n_rows``
    rows copied into it on device.  ``n_tokens`` is always capped at one
    less than the sequence length: the last token is recomputed so its
    logits can seed sampling.
    """

    n_tokens: int
    pages: tuple[int, ...]        # shared full pages, logical order
    cow: Optional[tuple[int, int]] = None   # (src_page, copied rows)
    # matched pages no sequence currently references: acquiring them turns
    # reclaimable capacity into held capacity, so admission budgets must
    # charge for them exactly like a fresh draw (``free_pages`` counted
    # them as allocatable)
    n_reclaimed: int = 0

    @property
    def n_shared(self) -> int:
        return len(self.pages)

    @property
    def n_cow_pages(self) -> int:
        return 0 if self.cow is None else 1


NO_MATCH = PrefixMatch(n_tokens=0, pages=())


class _Node:
    """One full committed page: ``chunk`` (page_size token ids) -> page."""

    __slots__ = ("chunk", "page", "children", "parent", "stamp", "partial")

    def __init__(self, chunk, page, parent, stamp):
        self.chunk = chunk
        self.page = page
        self.parent = parent
        self.stamp = stamp
        self.children: dict[tuple, "_Node"] = {}
        self.partial: Optional[_Partial] = None


class _Partial:
    """A committed prompt tail shorter than one page, attached to the node
    of its last full page (or the root).  Matched via COW fork only."""

    __slots__ = ("tokens", "page", "n_rows", "stamp")

    def __init__(self, tokens, page, n_rows, stamp):
        self.tokens = tokens
        self.page = page
        self.n_rows = n_rows
        self.stamp = stamp


class PagedKVPool:
    """Refcounted page allocator with prefix-trie sharing and COW forks."""

    def __init__(self, n_pages: int, page_size: int,
                 max_pages_per_seq: Optional[int] = None,
                 kv_dtype: str = "fp32", page_bytes: int = 0,
                 kv_shard: int = 1):
        if n_pages < 2:
            raise ValueError("need at least one usable page beyond the sink")
        self.n_pages = n_pages
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        # physical accounting only — allocation is page-granular regardless
        # of width; the engine sizes n_pages from a byte budget, so an int8
        # pool simply has ~4x the pages of an equal-budget fp32 pool.
        # ``kv_shard`` (DeviceKV) records how many mesh shards split each
        # page's KV-head axis: allocation stays LOGICAL (global pages,
        # identical at every tp), only the byte reporting divides.
        self.kv_dtype = kv_dtype
        self.page_bytes = page_bytes
        self.kv_shard = max(int(kv_shard), 1)
        # LIFO free list keeps recently-freed (cache-warm) pages hot
        self._free: list[int] = list(range(n_pages - 1, SINK_PAGE, -1))
        self._tables: dict[int, list[int]] = {}   # seq_id -> page ids
        self._lengths: dict[int, int] = {}        # seq_id -> live tokens
        self._ref: dict[int, int] = {}            # page -> holding sequences
        self._cached: dict[int, object] = {}      # page -> _Node | _Partial
        self._root = _Node(chunk=None, page=None, parent=None, stamp=-1)
        self._stamp = itertools.count()           # LRU clock
        self._reclaimable = 0   # cached pages with seq refcount 0 (O(1))
        # cumulative counters (stats / benchmarks)
        self.prefix_hit_tokens = 0
        self.prefix_lookup_tokens = 0
        self.pages_allocated_total = 0            # fresh pages drawn
        self.cow_forks = 0
        self.cache_evictions = 0                  # LRU trie reclaims
        self.peak_pages = 0                       # high-water live pages

    # -- queries -----------------------------------------------------------

    @property
    def free_pages(self) -> int:
        """Allocatable pages: immediately free plus cached-only pages the
        trie would evict under pressure (reclaimable).  O(1) — the counter
        is maintained across ref/cache transitions (and cross-checked in
        ``check_invariants``) because this property sits in the scheduler's
        per-span, per-request hot paths."""
        return len(self._free) + self._reclaimable

    def pages_for(self, n_tokens: int) -> int:
        return max(1, math.ceil(n_tokens / self.page_size))

    def can_allocate(self, n_tokens: int) -> bool:
        n = self.pages_for(n_tokens)
        if self.max_pages_per_seq is not None and n > self.max_pages_per_seq:
            return False
        return n <= self.free_pages

    def page_table(self, seq_id: int) -> list[int]:
        return list(self._tables[seq_id])

    def refcount(self, page: int) -> int:
        """Sequence refcount of a page (0 for free or cached-only pages)."""
        return self._ref.get(page, 0)

    def is_cached(self, page: int) -> bool:
        return page in self._cached

    def release_yield(self, seq_id: int) -> int:
        """Pages that would become allocatable if ``seq_id`` freed now:
        those only this sequence holds (shared pages stay with their other
        holders, so evicting a sharing victim reclaims less than its table
        length — the scheduler's preemption loop must count this, not
        ``len(page_ids)``)."""
        return sum(1 for p in self._tables[seq_id] if self._ref[p] == 1)

    def stats(self) -> PoolStats:
        counts: dict[int, int] = {}
        for t in self._tables.values():
            for p in t:
                counts[p] = counts.get(p, 0) + 1
        unique = len(counts)
        shared = sum(1 for c in counts.values() if c >= 2)
        cached_only = sum(1 for p in self._cached if p not in counts)
        capacity = sum(len(t) for t in self._tables.values()) * self.page_size
        live = sum(self._lengths.values())
        # guard BOTH counters: before any admission (or with sharing off)
        # nothing has been looked up, and the rate must read 0.0 — not raise
        # and not NaN from a 0/0
        lk = self.prefix_lookup_tokens
        rate = self.prefix_hit_tokens / lk if lk > 0 else 0.0
        allocated = unique + cached_only
        return PoolStats(
            n_pages=self.n_pages - 1,
            free_pages=self.free_pages,
            allocated_pages=allocated,
            n_seqs=len(self._tables),
            utilization=live / capacity if capacity else 1.0,
            shared_pages=shared,
            unique_pages=unique,
            cached_pages=cached_only,
            prefix_hit_tokens=self.prefix_hit_tokens,
            prefix_hit_rate=rate,
            kv_dtype=self.kv_dtype,
            page_bytes=self.page_bytes,
            pool_bytes=self.page_bytes * (self.n_pages - 1),
            allocated_bytes=self.page_bytes * allocated,
            peak_pages=self.peak_pages,
            peak_bytes=self.page_bytes * self.peak_pages,
            cache_evictions=self.cache_evictions,
            kv_shard=self.kv_shard,
            shard_page_bytes=self.page_bytes // self.kv_shard,
        )

    # -- page supply (free list + LRU trie reclaim) ------------------------

    def _pop_free(self) -> int:
        while not self._free:
            self._evict_cached_lru()
        self.pages_allocated_total += 1
        page = self._free.pop()
        # every draw passes through here, so the live-page high-water mark
        # (referenced + cached == everything off the free list) is exact
        live = self.n_pages - 1 - len(self._free)
        if live > self.peak_pages:
            self.peak_pages = live
        return page

    def _draw(self, n: int) -> list[int]:
        """Atomically draw ``n`` fresh pages (evicting cache as needed); on
        failure the already-popped pages go straight back."""
        got: list[int] = []
        try:
            for _ in range(n):
                got.append(self._pop_free())
        except PoolOOM:
            self._free.extend(reversed(got))
            self.pages_allocated_total -= len(got)
            raise
        return got

    def _evict_cached_lru(self) -> None:
        """Evict the least-recently-used *leaf* trie entry (a childless,
        partial-less node, or any partial).  Preference goes to entries
        whose page no sequence holds — evicting those yields a free page.
        When only sequence-held leaves remain they are merely UNCACHED (the
        holder keeps its page; the cache forgets it): that removes the
        blocker below a 0-ref interior page, which a later call then frees.
        Sequence-held pages can sit deeper in the trie than unheld ones —
        commit registers a walking sequence's pages wherever the path has
        gaps — so this uncache-to-unblock step is what makes every 0-ref
        cached page eventually reclaimable."""
        best, best_free = None, None   # (stamp, kind, node) candidates
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            pt = node.partial
            if pt is not None:
                cand = (pt.stamp, "partial", node)
                if best is None or cand[0] < best[0]:
                    best = cand
                if self._ref.get(pt.page, 0) == 0 and (
                        best_free is None or cand[0] < best_free[0]):
                    best_free = cand
            if (node is not self._root and not node.children
                    and node.partial is None):
                cand = (node.stamp, "node", node)
                if best is None or cand[0] < best[0]:
                    best = cand
                if self._ref.get(node.page, 0) == 0 and (
                        best_free is None or cand[0] < best_free[0]):
                    best_free = cand
        pick = best_free or best
        if pick is None:
            raise PoolOOM("pool exhausted: no free or reclaimable pages")
        self.cache_evictions += 1
        _, kind, node = pick
        if kind == "partial":
            self._drop_partial(node)
        else:
            del node.parent.children[node.chunk]
            del self._cached[node.page]
            if self._ref.get(node.page, 0) == 0:
                self._reclaimable -= 1
                self._free.append(node.page)

    def _drop_partial(self, node: _Node) -> None:
        page = node.partial.page
        node.partial = None
        del self._cached[page]
        if self._ref.get(page, 0) == 0:
            self._reclaimable -= 1
            self._free.append(page)

    # -- allocation --------------------------------------------------------

    def allocate(self, seq_id: int, n_tokens: int) -> list[int]:
        """Reserve fresh private pages for ``n_tokens`` (no prefix sharing)
        and return the page table."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id} already allocated")
        n = self.pages_for(n_tokens)
        if self.max_pages_per_seq is not None and n > self.max_pages_per_seq:
            raise PoolOOM(
                f"{n} pages exceed per-seq limit {self.max_pages_per_seq}")
        if n > self.free_pages:
            raise PoolOOM(f"need {n} pages, {self.free_pages} free")
        pages = self._draw(n)
        for p in pages:
            self._ref[p] = 1
        self._tables[seq_id] = pages
        self._lengths[seq_id] = 0
        return list(pages)

    def extend(self, seq_id: int, n_tokens: int) -> list[int]:
        """Grow a sequence's reservation to cover ``n_tokens`` total."""
        table = self._tables[seq_id]
        need = self.pages_for(n_tokens) - len(table)
        if need <= 0:
            return []
        if (self.max_pages_per_seq is not None
                and len(table) + need > self.max_pages_per_seq):
            raise PoolOOM("per-seq page limit exceeded")
        if need > self.free_pages:
            raise PoolOOM(f"need {need} pages, {self.free_pages} free")
        new = self._draw(need)
        for p in new:
            self._ref[p] = 1
        table.extend(new)
        return new

    def advance(self, seq_id: int, n_tokens: int = 1) -> None:
        """Record ``n_tokens`` more live tokens (utilization accounting)."""
        self._lengths[seq_id] += n_tokens

    def free(self, seq_id: int) -> None:
        """Release a sequence: refcounts decrement; a page returns to the
        free list only when no other sequence holds it and it is not
        trie-cached (cached pages stay reclaimable)."""
        if seq_id not in self._tables:
            raise KeyError(f"free of unknown sequence {seq_id}")
        pages = self._tables.pop(seq_id)
        self._lengths.pop(seq_id)
        for p in reversed(pages):
            r = self._ref[p] - 1
            if r > 0:
                self._ref[p] = r
            else:
                del self._ref[p]
                if p in self._cached:
                    self._reclaimable += 1
                else:
                    self._free.append(p)

    # -- prefix trie: match / acquire / commit / COW -----------------------

    def _walk(self, tokens) -> tuple[list[_Node], int]:
        """Longest full-page trie path for ``tokens``: (nodes, matched)."""
        ps = self.page_size
        node, path = self._root, []
        i = 0
        while (i + 1) * ps <= len(tokens):
            child = node.children.get(tuple(tokens[i * ps:(i + 1) * ps]))
            if child is None:
                break
            path.append(child)
            node = child
            i += 1
        return path, i * ps

    def match_prefix(self, tokens) -> PrefixMatch:
        """Pure lookup: how much of ``tokens`` the trie can serve.  Capped at
        ``len(tokens) - 1`` — the last token is always recomputed so its
        logits can seed sampling; when the cap lands inside a matched or
        partially-committed page the match carries a COW fork."""
        return self._match(list(tokens))[0]

    def _match(self, tokens: list) -> tuple[PrefixMatch, list[_Node]]:
        """One trie walk serving both the public lookup and acquire (which
        also needs the node path for LRU stamping)."""
        cap = len(tokens) - 1
        if cap <= 0:
            return NO_MATCH, []
        path, matched = self._walk(tokens)
        pages = [n.page for n in path]
        cow = None
        if matched > cap:
            # fully-cached page-aligned prompt: fork the last page and
            # recompute only the final token into the private copy
            src = pages.pop()
            matched -= self.page_size
            cow = (src, cap - matched)
            matched = cap
        else:
            tail = path[-1] if path else self._root
            pt = tail.partial
            if pt is not None and matched < cap:
                rest = tokens[matched:matched + pt.n_rows]
                c = 0
                while c < len(rest) and rest[c] == pt.tokens[c]:
                    c += 1
                c = min(c, cap - matched)
                if c > 0:
                    cow = (pt.page, c)
                    matched += c
        if matched == 0:
            return NO_MATCH, path
        m = PrefixMatch(
            n_tokens=matched, pages=tuple(pages), cow=cow,
            n_reclaimed=sum(1 for p in pages if self._ref.get(p, 0) == 0))
        return m, path

    def acquire_prefix(self, seq_id: int, tokens
                       ) -> tuple[list[int], int, list[tuple[int, int]]]:
        """Start a sequence's page table from the trie match over its known
        tokens: shared full pages refcount++, a COW fork draws one fresh
        page.  Returns ``(page_table, n_cached_tokens, cow_copies)`` where
        each cow copy is ``(src_page, dst_page)`` for the engine to execute
        on the device arrays before any forward touches the fork."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id} already allocated")
        tokens = list(tokens)
        m, path = self._match(tokens)
        for node in path[:m.n_shared]:
            node.stamp = next(self._stamp)
        pages = list(m.pages)
        for p in pages:
            prev = self._ref.get(p, 0)
            if prev == 0:      # was cached-only: no longer reclaimable
                self._reclaimable -= 1
            self._ref[p] = prev + 1
        matched = m.n_tokens
        cow_ops: list[tuple[int, int]] = []
        if m.cow is not None:
            # the guard runs AFTER the shared refs land: pages that were
            # reclaimable a moment ago may be exactly the ones just ref'd
            if self.free_pages < 1:
                matched = m.n_shared * self.page_size  # degrade: no fork
            else:
                src, _rows = m.cow
                ent = self._cached.get(src)
                if isinstance(ent, (_Node, _Partial)):
                    ent.stamp = next(self._stamp)
                dst = self._pop_free()
                self._ref[dst] = 1
                pages.append(dst)
                if dst != src:
                    cow_ops.append((src, dst))
                # else: LRU eviction reclaimed the (unreferenced) source
                # itself — the fork ADOPTS it in place, rows already live
                self.cow_forks += 1
        self._tables[seq_id] = pages
        # matched tokens are live KV from day one (utilization accounting)
        self._lengths[seq_id] = matched
        self.prefix_hit_tokens += matched
        self.prefix_lookup_tokens += max(len(tokens) - 1, 0)
        return list(pages), matched, cow_ops

    def commit_prefix(self, seq_id: int, tokens, upto: int) -> None:
        """Register the sequence's pages whose tokens are fully known up to
        cursor position ``upto``: every full page becomes a trie node, and —
        when ``upto`` reaches the end of ``tokens`` mid-page — the tail
        becomes a partial entry (matched via COW fork).  Idempotent; pages
        already on the trie path are left with their original owners."""
        table = self._tables[seq_id]
        ps = self.page_size
        tokens = list(tokens)
        upto = min(upto, len(tokens))
        node = self._root
        for i in range(upto // ps):
            chunk = tuple(tokens[i * ps:(i + 1) * ps])
            child = node.children.get(chunk)
            if child is None:
                page = table[i]
                if page in self._cached:
                    # already cached under another path entry — never alias
                    # one physical page to two trie positions
                    return
                child = _Node(chunk=chunk, page=page, parent=node,
                              stamp=next(self._stamp))
                node.children[chunk] = child
                self._cached[page] = child
            else:
                child.stamp = next(self._stamp)
            node = child
        n_full = upto // ps
        n_rows = upto - n_full * ps
        if upto == len(tokens) and n_rows:
            page = table[n_full]
            old = node.partial
            if page in self._cached:
                return
            if old is not None and old.n_rows >= n_rows:
                return
            if old is not None:
                self._drop_partial(node)
            node.partial = _Partial(tokens=tuple(tokens[n_full * ps:upto]),
                                    page=page, n_rows=n_rows,
                                    stamp=next(self._stamp))
            self._cached[page] = node.partial

    # -- write confinement -------------------------------------------------

    def assert_writable(self, seq_id: int, lo: int, hi: int) -> None:
        """Prove a span write at positions [lo, hi) only touches pages this
        sequence exclusively owns: refcount 1, not committed as a full trie
        page, and not overlapping the committed rows of a partial entry.
        Raises RuntimeError on violation — shared history is immutable."""
        if hi <= lo:
            return
        table = self._tables[seq_id]
        ps = self.page_size
        for li in range(lo // ps, (hi - 1) // ps + 1):
            p = table[li]
            if self._ref.get(p, 0) != 1:
                raise RuntimeError(
                    f"write [{lo},{hi}) touches page {p} shared by "
                    f"{self._ref.get(p, 0)} sequences (COW fork missing)")
            ent = self._cached.get(p)
            if isinstance(ent, _Node):
                raise RuntimeError(
                    f"write [{lo},{hi}) touches full committed page {p}")
            if isinstance(ent, _Partial):
                if max(lo, li * ps) < li * ps + ent.n_rows:
                    raise RuntimeError(
                        f"write [{lo},{hi}) overlaps {ent.n_rows} committed "
                        f"rows of partial page {p}")

    # -- snapshot / restore ------------------------------------------------

    def export_state(self) -> dict:
        """Serialize the full host-side pool state to a JSON-safe dict.

        The trie is flattened into a node list in parent-before-child order
        (root at index 0, ``parent`` as a list index) with partial entries
        inlined on their owning node.  Derived structures — ``_ref``
        (refcount == table holders, the invariant), ``_cached``,
        ``_reclaimable``, the LRU clock — are NOT serialized; ``from_state``
        rebuilds them and cross-checks with ``check_invariants``, so a
        snapshot can never smuggle in drifted refcounts.
        """
        order: list[_Node] = [self._root]
        stack = [self._root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                order.append(child)      # parent always precedes its children
                stack.append(child)
        index = {id(n): i for i, n in enumerate(order)}
        trie = []
        for n in order:
            rec = {
                "parent": index[id(n.parent)] if n.parent is not None else -1,
                "chunk": None if n.chunk is None else [int(t) for t in n.chunk],
                "page": None if n.page is None else int(n.page),
                "stamp": int(n.stamp),
                "partial": None,
            }
            if n.partial is not None:
                pt = n.partial
                rec["partial"] = {"tokens": [int(t) for t in pt.tokens],
                                  "page": int(pt.page),
                                  "n_rows": int(pt.n_rows),
                                  "stamp": int(pt.stamp)}
            trie.append(rec)
        return {
            "n_pages": self.n_pages,
            "page_size": self.page_size,
            "max_pages_per_seq": self.max_pages_per_seq,
            "kv_dtype": self.kv_dtype,
            "page_bytes": self.page_bytes,
            "kv_shard": self.kv_shard,
            "free": [int(p) for p in self._free],
            "tables": [[int(s), [int(p) for p in t]]
                       for s, t in self._tables.items()],
            "lengths": [[int(s), int(n)] for s, n in self._lengths.items()],
            "trie": trie,
            "counters": {
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "prefix_lookup_tokens": self.prefix_lookup_tokens,
                "pages_allocated_total": self.pages_allocated_total,
                "cow_forks": self.cow_forks,
                "cache_evictions": self.cache_evictions,
                "peak_pages": self.peak_pages,
            },
        }

    @classmethod
    def from_state(cls, state: dict) -> "PagedKVPool":
        """Rebuild a pool from ``export_state`` output and verify it: trie,
        refcounts, reclaimable counter, and LRU clock are reconstructed,
        then ``check_invariants`` runs before the pool is handed back."""
        pool = cls(state["n_pages"], state["page_size"],
                   max_pages_per_seq=state["max_pages_per_seq"],
                   kv_dtype=state["kv_dtype"], page_bytes=state["page_bytes"],
                   kv_shard=state.get("kv_shard", 1))
        pool._free = [int(p) for p in state["free"]]
        pool._tables = {int(s): [int(p) for p in t]
                        for s, t in state["tables"]}
        pool._lengths = {int(s): int(n) for s, n in state["lengths"]}
        pool._ref = {}
        for t in pool._tables.values():
            for p in t:
                pool._ref[p] = pool._ref.get(p, 0) + 1
        max_stamp = -1
        nodes: list[_Node] = [pool._root]
        for rec in state["trie"][1:]:
            parent = nodes[rec["parent"]]
            node = _Node(chunk=tuple(rec["chunk"]), page=int(rec["page"]),
                         parent=parent, stamp=int(rec["stamp"]))
            parent.children[node.chunk] = node
            pool._cached[node.page] = node
            max_stamp = max(max_stamp, node.stamp)
            nodes.append(node)
        for rec, node in zip(state["trie"], nodes):
            if rec["partial"] is not None:
                pt = rec["partial"]
                node.partial = _Partial(tokens=tuple(pt["tokens"]),
                                        page=int(pt["page"]),
                                        n_rows=int(pt["n_rows"]),
                                        stamp=int(pt["stamp"]))
                pool._cached[node.partial.page] = node.partial
                max_stamp = max(max_stamp, node.partial.stamp)
        pool._reclaimable = sum(1 for p in pool._cached
                                if pool._ref.get(p, 0) == 0)
        pool._stamp = itertools.count(max_stamp + 1)
        c = state["counters"]
        pool.prefix_hit_tokens = c["prefix_hit_tokens"]
        pool.prefix_lookup_tokens = c["prefix_lookup_tokens"]
        pool.pages_allocated_total = c["pages_allocated_total"]
        pool.cow_forks = c["cow_forks"]
        pool.cache_evictions = c["cache_evictions"]
        pool.peak_pages = c["peak_pages"]
        pool.check_invariants()
        return pool

    # -- invariants --------------------------------------------------------

    def check_invariants(self) -> None:
        """Raise AssertionError if the pool state is inconsistent."""
        counts: dict[int, int] = {}
        for t in self._tables.values():
            for p in t:
                counts[p] = counts.get(p, 0) + 1
        assert SINK_PAGE not in counts, "sink page in a table"
        assert SINK_PAGE not in self._free, "sink page on free list"
        assert SINK_PAGE not in self._cached, "sink page cached"
        assert counts == self._ref, (
            f"refcounts drifted from table holders: {counts} != {self._ref}")
        live = set(self._ref) | set(self._cached)
        assert not live.intersection(self._free), "page both free and live"
        assert len(self._free) == len(set(self._free)), "free list dup"
        assert len(self._free) + len(live) == self.n_pages - 1, "pages leaked"
        assert self._reclaimable == sum(
            1 for p in self._cached if self._ref.get(p, 0) == 0), \
            "reclaimable counter drifted"
        # trie structure: every reachable entry is marked cached, chunk and
        # partial shapes are sound, and nothing cached is unreachable
        seen: set[int] = set()
        stack = [self._root]
        while stack:
            node = stack.pop()
            if node is not self._root:
                assert len(node.chunk) == self.page_size, "short trie chunk"
                assert self._cached.get(node.page) is node, "uncached node"
                assert node.page not in seen, "page double-cached"
                seen.add(node.page)
            pt = node.partial
            if pt is not None:
                assert 1 <= pt.n_rows < self.page_size, "bad partial rows"
                assert len(pt.tokens) == pt.n_rows, "partial token drift"
                assert self._cached.get(pt.page) is pt, "uncached partial"
                assert pt.page not in seen, "page double-cached"
                seen.add(pt.page)
            stack.extend(node.children.values())
        assert seen == set(self._cached), "cached pages unreachable from trie"


__all__ = ["PagedKVPool", "PoolOOM", "PoolStats", "PrefixMatch", "NO_MATCH",
           "SINK_PAGE"]
