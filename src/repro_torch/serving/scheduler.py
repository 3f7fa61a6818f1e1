"""Iteration-level scheduler: every engine step is ONE mixed forward, and
the scheduler decides the token span each sequence contributes to it.

``plan_step`` packs the step under four budgets:

  * decode spans are mandatory — every RUNNING sequence gets 1 token (plus
    the KV page that token needs, allocated incrementally as the cursor
    crosses page boundaries);
  * PREFILLING sequences get a prompt chunk of up to ``chunk_size`` tokens,
    shrunk to whatever free pages remain (a sequence that gets 0 simply
    stalls this step — its pages stay warm);
  * WAITING requests are admitted FIFO into free slots, contributing their
    first chunk this very step (there is no separate prefill forward);
  * an optional step-latency budget priced by the cost model bounds how
    much prefill work rides along with the decode batch.

Admission is *prefix-cache aware* (``SchedulerConfig.prefix_sharing``): a
WAITING request's known tokens are matched against the pool's prefix trie,
and only the unmatched tail needs a chunk.  Budgets count only the UNIQUE
new pages an admission consumes — shared full pages are refcount bumps
(zero pages, zero tokens) and a copy-on-write fork is exactly one page —
so at equal prompt length a cache-hit request admits earlier and packs
denser than a miss: its chunk is smaller, its page draw near zero, and the
cost model prices its cached tokens at ~zero weight-read / CIM-cycle
latency (``prefill_ns(n, cached_tokens=...)``).

Because pages are allocated as each cursor advances (no conservative
prompt + max_new reservation), the pool can run dry mid-flight.  The plan
then *preempts*: the lowest-priority (most recently admitted)
PREFILLING/RUNNING sequence is evicted back to WAITING — page refcounts
released, emitted tokens kept, prefix re-matched on resume — and planning
retries with the reclaimed pages.  With sharing, evicting a victim yields
only the pages no SURVIVING sequence still holds: pages shared with
residents stay resident, while a page held only by the victims chosen so
far is credited exactly once (incremental pending-release accounting — a
per-victim ``release_yield`` would credit a page two victims share to
neither).  Preemption also
fires when nothing at all could be scheduled (liveness): the victim's
pages let the highest-priority stalled sequence make progress.

Two cost models ship:

``HBMCostModel`` — the classic weight-streaming roofline: one step reads
every weight byte once (amortized over the whole batch) plus each
sequence's KV history, so marginal decode cost per extra sequence is tiny
and the scheduler batches as wide as it can.  Prefill pays the weight pass
plus per-token compute, so longer chunks genuinely cost more and the
latency budget binds on chunk size.

``CIMCostModel`` — prices the step with the paper's CIM simulator
(``cim.simulator.simulate`` over ``cim.workload.decode_workload``): weights
are *stationary* in the arrays, so there is no weight-read amortization —
each token bit-serially streams its activations through the same DAC/ADC
cycles and per-step latency grows ~linearly with the tokens in the step.
Under a latency SLO this makes the CIM scheduler interleave *smaller*
prefill chunks into the decode batch than the HBM heuristic would — batch
composition driven by simulated per-token latency/energy, which is exactly
the knob the paper's framework exposes.

Both are copies of the reference's, with every default, and price a step
as the reference's do (``simulate`` is ``repro_torch.cim``'s copy of the
simulator); neither holds a preset of a particular card: a caller passes
its device's rates (``bandwidth_gbps``, ``compute_gflops``).  Without a
cost model the latency budget is off.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Protocol, Sequence as Seq, runtime_checkable

from repro_torch.serving.kv_pool import NO_MATCH, PagedKVPool
from repro_torch.serving.request import Request, RequestState, Sequence


@runtime_checkable
class CostModel(Protocol):
    """What the scheduler needs from a step-pricing model.

    The latency and energy signatures are deliberately symmetric: BOTH
    prefill methods take the ``cached_tokens`` discount (prefix-trie hits
    cost neither weight reads nor CIM cycles, in nanojoules as much as in
    nanoseconds).  ``tests/test_telemetry.py`` holds the shipped models to
    this exact protocol — the ``prefill_nj`` signature had drifted
    (implementations grew the kwarg, the protocol did not) and only a
    conformance test keeps that from re-happening.
    """

    def decode_step_ns(self, n_seqs: int, avg_ctx: float) -> float:
        """Predicted latency of one decode step over ``n_seqs`` sequences."""
        ...

    def prefill_ns(self, n_tokens: int, cached_tokens: int = 0) -> float:
        """Predicted latency of prefilling ``n_tokens`` prompt tokens, of
        which ``cached_tokens`` are served from shared prefix pages (page
        table pointer updates: no weight read, no CIM cycles — near-zero)."""
        ...

    def decode_step_nj(self, n_seqs: int, avg_ctx: float) -> float:
        """Predicted energy of one decode step (0 if not modeled)."""
        ...

    def prefill_nj(self, n_tokens: int, cached_tokens: int = 0) -> float:
        """Predicted energy of prefilling ``n_tokens``, with the same
        cached-token discount as ``prefill_ns`` (0 if not modeled)."""
        ...


def tp_allreduce_bytes_per_token(cfg, tp: int) -> float:
    """Ring all-reduce traffic one shard moves per token at tensor
    parallelism ``tp``: two partial-sum reductions per layer (the attention
    output projection and the Monarch stage-2 contraction, both sharded on
    their contraction dim by the ``sharding/params.py`` Megatron-pair
    rules), each a ``d_model``-wide fp32 ring all-reduce costing
    ``2 * (tp - 1) / tp`` elements sent per element reduced — the software
    twin of the paper's inter-array reduction bus, which merges per-array
    partial sums before the next stage."""
    if tp <= 1:
        return 0.0
    return 2.0 * (tp - 1) / tp * cfg.d_model * 4.0 * 2 * cfg.n_layers


@dataclasses.dataclass
class HBMCostModel:
    """Bytes-moved roofline for a weight-streaming (GPU/HBM) backend.

    Tensor parallelism (``tp`` > 1) divides the per-shard weight stream by
    ``tp`` and the KV stream by ``kv_shard`` (the KV-head split — equals
    ``tp`` when it divides ``n_kv_heads``, else 1/replicated, matching
    ``DeviceKV``), and adds a per-token all-reduce term priced at the
    reduction-bus bandwidth: each step is as slow as its slowest shard, so
    the roofline prices ONE shard's bytes plus its collective traffic."""

    n_params: int                 # active parameters per token
    kv_bytes_per_token: float     # 2 * n_layers * n_kv_heads * hd * dtype
    bytes_per_param: float = 2.0
    bandwidth_gbps: float = 400.0
    compute_gflops: float = 50_000.0   # prefill matmul throughput
    tp: int = 1                   # model-axis shards (weights / compute)
    kv_shard: int = 1             # KV-head shards (pool pages)
    allreduce_bytes_per_token: float = 0.0
    reduce_bandwidth_gbps: float = 300.0   # inter-shard reduction bus
    # kernel-vs-dense attention pricing: the fused paged span kernel DMAs
    # each page into VMEM exactly once, while the dense-gather fallback
    # first materializes a contiguous (B, T, KV, hd) copy in HBM —
    # ``kv_gather_overhead`` is that extra KV traffic as a fraction of the
    # stream (1.0 = the copy is written and re-read once).  Default 0.0
    # keeps the historical pricing for every existing caller; the tp bench
    # sweep sets it to price the shard-mapped kernel's win honestly.
    paged_kernel: bool = False
    kv_gather_overhead: float = 0.0

    def _allreduce_ns(self, n_tokens: float) -> float:
        if self.allreduce_bytes_per_token <= 0.0:
            return 0.0
        return (n_tokens * self.allreduce_bytes_per_token
                / self.reduce_bandwidth_gbps)

    def _kv_factor(self) -> float:
        return 1.0 if self.paged_kernel else 1.0 + self.kv_gather_overhead

    def decode_step_ns(self, n_seqs: int, avg_ctx: float) -> float:
        weight_bytes = self.n_params * self.bytes_per_param / self.tp
        kv_bytes = (n_seqs * avg_ctx * self.kv_bytes_per_token
                    / self.kv_shard * self._kv_factor())
        return ((weight_bytes + kv_bytes) / self.bandwidth_gbps
                + self._allreduce_ns(n_seqs))

    def prefill_ns(self, n_tokens: int, cached_tokens: int = 0) -> float:
        # one weight pass (amortized over the chunk) + per-token compute:
        # the cost must grow with the token count or a chunk-size budget
        # never binds (2 flops per param per token, GFLOP/s == flops/ns).
        # Cached tokens are prefix-trie hits — their KV already sits in the
        # pool, so they cost neither the weight pass nor any compute: a
        # fully-cached chunk is priced at zero (page-table pointer updates)
        computed = max(n_tokens - cached_tokens, 0)
        if computed == 0:
            return 0.0
        weight_ns = (self.n_params * self.bytes_per_param
                     / (self.tp * self.bandwidth_gbps))
        compute_ns = (2.0 * self.n_params * computed
                      / (self.tp * self.compute_gflops))
        return weight_ns + compute_ns + self._allreduce_ns(computed)

    def shard_decode_bytes_per_token(self, avg_ctx: float,
                                     n_seqs: int = 1) -> dict:
        """What ONE shard reads from its local memory per decoded token —
        the number the tp sweep in ``BENCH_serving.json`` tracks: weight
        bytes amortized over the batch and divided ``tp`` ways, KV history
        bytes divided ``kv_shard`` ways, plus the all-reduce bytes the
        shard sends (collective traffic, not local HBM — reported
        separately so the ~Nx local reduction at tp=N stays visible)."""
        weight = self.n_params * self.bytes_per_param / (
            self.tp * max(n_seqs, 1))
        kv = avg_ctx * self.kv_bytes_per_token / self.kv_shard
        return {"weight_bytes": weight, "kv_bytes": kv,
                "weight_kv_bytes": weight + kv,
                "kv_gather_bytes": kv * (self._kv_factor() - 1.0),
                "allreduce_bytes": self.allreduce_bytes_per_token}

    def decode_step_nj(self, n_seqs: int, avg_ctx: float) -> float:
        return 0.0

    def prefill_nj(self, n_tokens: int, cached_tokens: int = 0) -> float:
        return 0.0

    @classmethod
    def from_model_config(cls, cfg, kv_dtype: str = "bf16", tp: int = 1,
                          **kw) -> "HBMCostModel":
        """``kv_dtype`` prices the KV stream at the serving pool's STORED
        page width ("fp32" | "bf16" | "int8"): decoding against an int8
        pool gathers a quarter of the fp32 bytes per context token, so the
        roofline admits wider batches / longer contexts before the KV term
        dominates the weight pass.  Default bf16 preserves the historical
        2 bytes/KV-element pricing.  ``tp`` prices a tensor-parallel engine:
        weights split ``tp`` ways, KV split ``kv_shard`` ways (``tp`` when
        it divides ``n_kv_heads``, else replicated — the ``DeviceKV`` rule),
        and the two per-layer partial-sum all-reduces priced on the
        reduction bus."""
        from repro_torch.cim.workload import decode_kv_bytes_per_token
        from repro_torch.core.quant import KV_DTYPE_BYTES

        kvb = decode_kv_bytes_per_token(
            cfg, kv_bits=int(8 * KV_DTYPE_BYTES[kv_dtype]))
        if tp > 1:
            kw.setdefault("kv_shard",
                          tp if cfg.n_kv_heads % tp == 0 else 1)
            kw.setdefault("allreduce_bytes_per_token",
                          tp_allreduce_bytes_per_token(cfg, tp))
        return cls(n_params=cfg.active_param_count(),
                   kv_bytes_per_token=kvb, tp=tp, **kw)

    @classmethod
    def from_params(cls, cfg, params, **kw) -> "HBMCostModel":
        """Price weight traffic by the ACTUAL parameter tree's dtypes, so a
        quantized (int8 / packed-int4) decode path admits wider batches: the
        per-step weight read is the compressed footprint, not 4 bytes/param.
        ``bytes_per_param`` = total tree bytes / modeled param count (scales
        and fp32 residue like norms/embedding keep it honest).  Forward
        ``kv_dtype=`` to additionally price the KV stream at the pool's
        stored page width."""
        from repro_torch.core.quant import tree_weight_bytes

        bpp = tree_weight_bytes(params) / max(cfg.param_count(), 1)
        return cls.from_model_config(cfg, bytes_per_param=bpp, **kw)


class CIMCostModel:
    """Step cost from the paper's CIM simulator (Table-I composition).

    ``per_token_ns``/``per_token_nj`` come from one ``simulate`` call over
    the model's decode workload under the chosen mapping strategy; decoding
    ``n`` sequences costs ``n x`` that (weights-stationary arrays process
    each sequence's bit-serial activation stream in turn), plus a DPU term
    for the non-parameterized attention matmuls that grows with context.

    ``tp`` > 1 models ``tp`` parallel array groups each holding 1/tp of
    every projection's block-rows (the paper's per-array residency): the
    bit-serial stream time divides by ``tp``, the DPU's KV stream divides
    by ``kv_shard``, and partial sums cross the inter-array reduction bus
    (``reduce_bus_gbps``) twice per layer.
    """

    def __init__(self, model_cfg, strategy: str = "sparse",
                 cim_cfg=None, seq_len: int = 512,
                 attn_dpu_ns_per_key: float = 0.05,
                 weight_bits: int = 8, fused_proj: bool = False,
                 kv_bits: int = 32, tp: int = 1,
                 reduce_bus_gbps: float = 128.0,
                 paged_kernel: bool = False,
                 kv_gather_overhead: float = 0.0):
        import dataclasses as _dc

        from repro_torch.cim.simulator import simulate
        from repro_torch.cim.spec import CIMConfig
        from repro_torch.cim.workload import (decode_kv_bytes_per_token,
                                              decode_workload)

        self.strategy = strategy
        cfg = cim_cfg or CIMConfig()
        # weight precision <-> ADC resolution (cim/spec.py): lower-precision
        # cells never need a finer conversion than their own bit width
        if weight_bits < cfg.weight_bits:
            cfg = _dc.replace(cfg, weight_bits=weight_bits)
        self._cfg = cfg
        desc = decode_workload(model_cfg, seq_len=seq_len,
                               fused_proj=fused_proj)
        r = simulate(desc, strategy, self._cfg)
        self.per_token_ns = r.latency_ns_per_token
        self.per_token_nj = r.energy_nj_per_token
        # the DPU runs the non-parameterized attention matmuls off-array: its
        # per-key time tracks the bytes it streams from the paged KV pool,
        # so an int8 pool (kv_bits=8) clocks a quarter of the fp32 movement
        # (decode_kv_bytes_per_token is the shared pricing convention)
        self.kv_bits = kv_bits
        width_ratio = (decode_kv_bytes_per_token(model_cfg, kv_bits)
                       / decode_kv_bytes_per_token(model_cfg, 32))
        self.attn_dpu_ns_per_key = attn_dpu_ns_per_key * width_ratio
        # tensor parallelism: tp array groups stream concurrently, the DPU
        # scans only its local KV heads, partial sums ride the reduction bus
        self.model_cfg = model_cfg
        self.weight_bits = weight_bits
        self.tp = max(int(tp), 1)
        self.kv_shard = (self.tp if self.tp > 1
                         and model_cfg.n_kv_heads % self.tp == 0 else 1)
        self.reduce_bus_gbps = reduce_bus_gbps
        self.allreduce_bytes_per_token = tp_allreduce_bytes_per_token(
            model_cfg, self.tp)
        self.per_token_ns = (self.per_token_ns / self.tp
                             + self.allreduce_bytes_per_token
                             / self.reduce_bus_gbps)
        self.attn_dpu_ns_per_key /= self.kv_shard
        # kernel-vs-dense pricing, mirroring HBMCostModel: the dense-gather
        # fallback streams the gathered KV copy through the DPU once more
        self.paged_kernel = paged_kernel
        self.kv_gather_overhead = kv_gather_overhead
        if not paged_kernel:
            self.attn_dpu_ns_per_key *= 1.0 + kv_gather_overhead

    def decode_step_ns(self, n_seqs: int, avg_ctx: float) -> float:
        attn = self.attn_dpu_ns_per_key * avg_ctx
        return n_seqs * (self.per_token_ns + attn)

    def prefill_ns(self, n_tokens: int, cached_tokens: int = 0) -> float:
        # cached tokens never stream through the DAC/ADC arrays — a prefix
        # hit costs zero bit-serial cycles, only page-table pointer updates
        return max(n_tokens - cached_tokens, 0) * self.per_token_ns

    def shard_decode_bytes_per_token(self, avg_ctx: float,
                                     n_seqs: int = 1) -> dict:
        """One array group's local traffic per decoded token, mirroring
        ``HBMCostModel.shard_decode_bytes_per_token`` so the bench's tp
        sweep can compare both backends on the same axes: weight bytes at
        the stored cell precision split ``tp`` ways, DPU-streamed KV bytes
        split ``kv_shard`` ways, reduction-bus bytes reported alongside."""
        from repro_torch.cim.workload import decode_kv_bytes_per_token

        weight = (self.model_cfg.active_param_count()
                  * self.weight_bits / 8.0) / (self.tp * max(n_seqs, 1))
        kv = (avg_ctx * decode_kv_bytes_per_token(self.model_cfg,
                                                  self.kv_bits)
              / self.kv_shard)
        gather = (0.0 if self.paged_kernel
                  else kv * self.kv_gather_overhead)
        return {"weight_bytes": weight, "kv_bytes": kv,
                "weight_kv_bytes": weight + kv,
                "kv_gather_bytes": gather,
                "allreduce_bytes": self.allreduce_bytes_per_token}

    def decode_step_nj(self, n_seqs: int, avg_ctx: float) -> float:
        return n_seqs * self.per_token_nj

    def prefill_nj(self, n_tokens: int, cached_tokens: int = 0) -> float:
        # CIM prices every token streamed through the arrays, prefill or
        # decode alike — chunk composition shows up in energy, not just time
        return max(n_tokens - cached_tokens, 0) * self.per_token_nj


def _common_prefix(a, b) -> int:
    """Length of the shared leading run of two token sequences."""
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


@dataclasses.dataclass
class SchedulerConfig:
    max_slots: int = 8            # slot-batch width of the jitted mixed step
    chunk_size: int = 64          # max prefill tokens one sequence gets/step
    max_step_tokens: int = 2048   # total span tokens per step (decode+chunks)
    step_latency_budget_ns: Optional[float] = None
    # admissions match the pool's prefix trie: cached tokens are skipped and
    # budgets count only the unique new pages a request actually consumes
    prefix_sharing: bool = True
    # trie-aware admission grouping: park a WAITING request whose >=1-page
    # prefix is being computed by a resident prefill or an earlier admission
    # in the same plan, so only the leader computes it and the follower
    # admits as a cache hit.  Needs prefix_sharing; off = strict FIFO.
    prefix_grouping: bool = True
    # graceful degradation: when the allocatable-page fraction drops below
    # this threshold, prefill chunks are capped at one page's worth of
    # tokens — slower prefill instead of a preemption storm.  0.0 disables
    # (the default: all-default workloads plan exactly as before).
    degrade_free_frac: float = 0.0


@dataclasses.dataclass
class StepPlan:
    """One engine iteration, fully decided.

    ``spans``: (sequence, n_tokens) for already-admitted sequences, priority
    order — 1 for RUNNING decodes, a chunk for PREFILLING.  ``admissions``:
    (request, first_chunk) for WAITING requests joining this step (in
    priority-then-FIFO order).  ``preemptions``: sequences to evict back to
    WAITING *before* executing the spans, lowest priority first; their spans
    do not appear in ``spans``.  ``sheds``: WAITING requests past their
    ``max_queue_wait_s`` budget that still could not be admitted — the
    engine aborts them (FINISHED/SHED) instead of queueing them forever.
    ``degraded`` counts prefill chunks capped by pool-pressure degradation.
    ``prefix_deferred`` counts WAITING requests parked THIS plan because an
    earlier admission (or a resident prefill) is about to commit a shared
    prefix they will then admit against as a trie hit — deferral, not
    starvation: the leader is in the same plan, so the follower's hit
    arrives within a bounded number of steps.
    """

    spans: list[tuple[Sequence, int]] = dataclasses.field(default_factory=list)
    admissions: list[tuple[Request, int]] = dataclasses.field(
        default_factory=list)
    preemptions: list[Sequence] = dataclasses.field(default_factory=list)
    sheds: list[Request] = dataclasses.field(default_factory=list)
    degraded: int = 0
    prefix_deferred: int = 0

    @property
    def n_decodes(self) -> int:
        return sum(1 for s, _ in self.spans
                   if s.request.state is RequestState.RUNNING)

    @property
    def prefill_tokens(self) -> int:
        return (sum(n for s, n in self.spans
                    if s.request.state is RequestState.PREFILLING)
                + sum(n for _, n in self.admissions))

    @property
    def total_tokens(self) -> int:
        return sum(n for _, n in self.spans) + sum(
            n for _, n in self.admissions)


class IterationScheduler:
    """Packs decode tokens + prefill chunks into one mixed step under
    slot / page / token / latency budgets, preempting on page pressure."""

    def __init__(self, cfg: SchedulerConfig,
                 cost_model: Optional[CostModel] = None):
        self.cfg = cfg
        self.cost_model = cost_model

    # -- planning ------------------------------------------------------------

    def plan_step(self, waiting: Seq[Request], running: Seq[Sequence],
                  pool: PagedKVPool,
                  now: Optional[float] = None) -> StepPlan:
        """Decide this iteration's spans, admissions, preemptions and sheds.

        With ``now`` (the engine's clock), admission control runs on top of
        packing: any WAITING request that the pack could NOT admit and whose
        queue wait exceeds its ``max_queue_wait_s`` budget is shed — removed
        from consideration and reported in ``plan.sheds`` — and the step is
        re-packed without it (shed requests hold no pages, so the repack can
        only admit more, never less).  ``now=None`` (the legacy signature)
        disables shedding entirely.
        """
        waiting = list(waiting)
        sheds: list[Request] = []
        while True:
            plan = self._plan_once(waiting, running, pool)
            if now is None:
                break
            admitted = {r.req_id for r, _ in plan.admissions}
            expired = [
                r for r in waiting
                if r.req_id not in admitted
                and r.sampling.max_queue_wait_s is not None
                and r.t_enqueued >= 0
                and now - r.t_enqueued > r.sampling.max_queue_wait_s]
            if not expired:
                break
            sheds.extend(expired)
            drop = {r.req_id for r in expired}
            waiting = [r for r in waiting if r.req_id not in drop]
        plan.sheds = sheds
        return plan

    def _plan_once(self, waiting: Seq[Request], running: Seq[Sequence],
                   pool: PagedKVPool) -> StepPlan:
        """One shed-free planning round.

        Preemption loop: try to pack with the current residents; if a
        mandatory decode cannot get its next page, or nothing at all can be
        scheduled while work exists, evict the lowest-priority resident
        (lowest ``SamplingParams.priority``, most recent ``admit_order``
        within a class) and retry with its pages reclaimed.
        """
        order = sorted(running, key=lambda s: (-s.request.sampling.priority,
                                               s.admit_order))
        preempted: list[Sequence] = []
        extra_pages = 0
        pending: dict[int, int] = {}   # page -> releases from chosen victims
        match_memo: dict[int, object] = {}   # req_id -> PrefixMatch (per plan)
        while True:
            cand = order[:len(order) - len(preempted)]
            plan = self._pack(waiting, cand, pool, extra_pages, match_memo)
            if plan is not None:
                # already lowest-priority-first (victims were taken from the
                # back): the engine appendlefts in this order, so an OLDER
                # victim ends up ahead of a younger one in the queue
                plan.preemptions = list(preempted)
                return plan
            if not cand:
                raise RuntimeError(
                    "nothing schedulable with an empty batch — the pool "
                    "cannot host a single chunk (pool too small)")
            victim = cand[-1]
            preempted.append(victim)
            # with prefix sharing only EXCLUSIVE pages come back — but
            # "exclusive" must be judged against the releases of the
            # victims already chosen this plan: a page held only by two
            # victims frees up once BOTH go, and crediting it to neither
            # would walk the eviction pointlessly far up the priority list
            for p in victim.page_ids:
                if pool.refcount(p) - pending.get(p, 0) == 1:
                    extra_pages += 1
                pending[p] = pending.get(p, 0) + 1

    def _pack(self, waiting: Seq[Request], cand: list[Sequence],
              pool: PagedKVPool, extra_pages: int,
              match_memo: Optional[dict] = None) -> Optional[StepPlan]:
        """One packing attempt over ``cand`` (priority order).  Returns None
        when packing needs a preemption: a decode span is page-starved, or
        zero tokens were scheduled while residents exist."""
        cfg = self.cfg
        free = pool.free_pages + extra_pages
        budget = cfg.max_step_tokens
        plan = StepPlan()
        # graceful degradation: under pool pressure, cap prefill chunks at
        # one page's worth — shrinking each sequence's footprint growth per
        # step buys time for decodes to finish and release pages, instead
        # of letting a full-size chunk trigger a preemption storm
        pressure = (cfg.degrade_free_frac > 0.0
                    and free < cfg.degrade_free_frac * (pool.n_pages - 1))
        cap = min(pool.page_size, cfg.chunk_size) if pressure \
            else cfg.chunk_size

        # 1. mandatory decodes: every RUNNING sequence advances one token
        decodes = [s for s in cand if s.request.state is RequestState.RUNNING]
        n_ctx = sum(s.length for s in decodes)
        for seq in decodes:
            need = pool.pages_for(seq.num_computed + 1) - len(seq.page_ids)
            if need > free:
                return None  # page-starved decode: preempt and retry
            free -= need
            budget -= 1
            plan.spans.append((seq, 1))
        n_dec = len(decodes)
        avg_ctx = (n_ctx / n_dec) if n_dec else 0.0

        # 2. prefill chunks for resident PREFILLING sequences, priority order
        for seq in cand:
            if seq.request.state is not RequestState.PREFILLING:
                continue
            chunk = self._chunk_for(seq.remaining_prefill, budget, free,
                                    len(seq.page_ids) * pool.page_size
                                    - seq.num_computed, pool.page_size,
                                    plan, n_dec, avg_ctx, cap=cap)
            if chunk <= 0:
                continue  # stalls this step; pages stay warm
            if pressure and chunk == cap \
                    and cap < min(cfg.chunk_size, seq.remaining_prefill):
                plan.degraded += 1
            need = pool.pages_for(seq.num_computed + chunk) \
                - len(seq.page_ids)
            free -= need
            budget -= chunk
            plan.spans.append((seq, chunk))

        # 3. Admissions into free slots, first chunk rides this step, in
        # priority-then-FIFO order (all-default priorities == plain FIFO;
        # the sort is stable so ties keep queue order).
        # A prefix-trie hit shrinks the admission to its unmatched tail:
        # shared full pages are refcount bumps (no pages, no tokens), a COW
        # fork draws exactly one page, and only the remaining tokens need a
        # chunk — so cache-hit requests admit (and finish prefill) far
        # earlier than equal-length misses under the same budgets.
        free_slots = cfg.max_slots - len(cand)
        ps = pool.page_size
        if match_memo is None:
            match_memo = {}
        # trie-aware admission grouping: prefixes being computed RIGHT NOW —
        # by a resident prefill or by an admission earlier in this plan —
        # are not in the trie yet, so two requests sharing a prompt would
        # both compute it.  A follower sharing at least one full
        # page-aligned prefix with a leader beyond what the trie already
        # serves is parked (``plan.prefix_deferred``) and re-considered next
        # plan, by which point the leader has committed those pages and the
        # follower admits as a cache hit (refcount bumps + one COW fork).
        # Deferral never starves: the leader is in this same plan, and the
        # moment no leader covers the follower it admits normally.
        grouping = cfg.prefix_sharing and cfg.prefix_grouping
        leaders: list = [seq.request.known_tokens for seq in cand
                         if seq.request.state is RequestState.PREFILLING
                         ] if grouping else []
        admit_order = sorted(waiting,
                             key=lambda r: -r.sampling.priority)
        for req in admit_order:
            if free_slots <= 0:
                break
            target = len(req.prompt) + len(req.output_tokens)
            if not cfg.prefix_sharing:
                hit = NO_MATCH
            elif req.req_id in match_memo:
                # the trie cannot change while one plan is being packed, and
                # plan_step re-packs once per preemption victim — walk once
                hit = match_memo[req.req_id]
            else:
                hit = match_memo[req.req_id] = pool.match_prefix(
                    req.known_tokens)
            cached = hit.n_tokens
            if leaders:
                toks = req.known_tokens
                shared = max(_common_prefix(toks, L) for L in leaders)
                # cap at len-1 (the trie never serves the final token) and
                # page-align: only FULL pages become trie nodes mid-prefill
                if (min(shared, len(toks) - 1) // ps) * ps > cached:
                    plan.prefix_deferred += 1
                    continue
            n_table = math.ceil(cached / ps)    # match pages, fork included
            slack = n_table * ps - cached       # room left in the fork page
            # the fork draws a page, and every matched page no sequence
            # holds flips from reclaimable (counted in free) to held —
            # both charge the budget like fresh draws
            fixed = hit.n_cow_pages + hit.n_reclaimed
            if fixed > free:
                break  # the hit itself exceeds the remaining capacity
            chunk = self._chunk_for(target - cached, budget, free - fixed,
                                    slack, ps, plan, n_dec, avg_ctx,
                                    cached=cached, cap=cap)
            if chunk <= 0:
                break  # strict in-order: no skip-ahead, no starvation
            if pressure and chunk == cap \
                    and cap < min(cfg.chunk_size, target - cached):
                plan.degraded += 1
            free -= fixed + max(
                0, math.ceil((cached + chunk) / ps) - n_table)
            budget -= chunk
            free_slots -= 1
            plan.admissions.append((req, chunk))
            if grouping:
                leaders.append(req.known_tokens)

        if plan.total_tokens == 0 and cand:
            return None  # residents exist but none can move: preempt
        return plan

    def _chunk_for(self, remaining: int, budget: int, free_pages: int,
                   slack_tokens: int, page_size: int, plan: StepPlan,
                   n_dec: int, avg_ctx: float, cached: int = 0,
                   cap: Optional[int] = None) -> int:
        """Largest prefill chunk for one sequence under the chunk / step-token
        / page / latency budgets.  ``slack_tokens`` is the headroom already
        covered by the sequence's allocated (or prefix-matched) pages;
        ``cached`` is the prefix-hit length the cost model prices at ~zero;
        ``cap`` (default ``chunk_size``) is the degradation ceiling."""
        if cap is None:
            cap = self.cfg.chunk_size
        chunk = min(cap, remaining, max(budget, 0))
        # shrink to the pages actually available
        chunk = min(chunk, slack_tokens + free_pages * page_size)
        if chunk <= 0:
            return 0
        if (self.cost_model is not None
                and self.cfg.step_latency_budget_ns is not None
                and plan.total_tokens > 0):
            # this chunk rides on top of the decode batch + earlier chunks;
            # shrink until the priced step fits (a step that contains nothing
            # else skips the check — minimum progress beats the SLO)
            base = plan.prefill_tokens
            while chunk > 0:
                projected = self._prefill_ns(base + chunk + cached, cached)
                if n_dec:
                    projected += self.cost_model.decode_step_ns(n_dec, avg_ctx)
                if projected <= self.cfg.step_latency_budget_ns:
                    break
                chunk //= 2
        return chunk

    def _prefill_ns(self, n_tokens: int, cached: int) -> float:
        """Price a prefill, passing the cached-token discount only to cost
        models that understand it (third-party models predate the kwarg)."""
        if cached:
            try:
                return self.cost_model.prefill_ns(n_tokens,
                                                  cached_tokens=cached)
            except TypeError:
                pass
        return self.cost_model.prefill_ns(n_tokens)

    # -- accounting -----------------------------------------------------------

    def step_cost(self, n_decodes: int, avg_ctx: float,
                  prefill_tokens: int) -> tuple[float, float]:
        """(latency_ns, energy_nj) estimate for one executed mixed step."""
        if self.cost_model is None:
            return (0.0, 0.0)
        lat, nrg = 0.0, 0.0
        if n_decodes:
            lat += self.cost_model.decode_step_ns(n_decodes, avg_ctx)
            nrg += self.cost_model.decode_step_nj(n_decodes, avg_ctx)
        if prefill_tokens:
            lat += self.cost_model.prefill_ns(prefill_tokens)
            # getattr: third-party cost models predate prefill energy
            nrg += getattr(self.cost_model, "prefill_nj",
                           lambda n: 0.0)(prefill_tokens)
        return (lat, nrg)


__all__ = ["CostModel", "HBMCostModel", "CIMCostModel", "SchedulerConfig",
           "StepPlan", "IterationScheduler"]
