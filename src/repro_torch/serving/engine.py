"""Continuous-batching engine over the paged KV pool (port of
``repro.serving.engine.ContinuousBatchingEngine``).

Every iteration is ONE mixed forward (``models.transformer.paged_mixed_step``):
each scheduled sequence contributes a variable-length token span — a
prefill chunk, the tail of a chunked prompt, or a single decode token —
sized by the same host-side scheduler as the reference's
(``scheduler.plan_step``), so the two engines plan identical steps for
identical traffic.  What carries over unchanged:

  * iteration-level scheduling, incremental page allocation, preemption
    back to WAITING under pool pressure (greedy output stays
    token-identical: recompute on resume);
  * prompt-prefix sharing through the pool's refcounted trie, with
    copy-on-write page forks copied on device before the fork's first
    forward, and span writes confined to exclusively-owned pages by
    ``pool.assert_writable`` on the host and the ``write_start`` mask on
    the device;
  * device-token chaining and a one-step harvest lag: step N+1 is
    dispatched before step N's samples are read back; the read-back
    (``.cpu()`` at harvest) is the engine's only wait on the device (and,
    on preemption only, the read of the victim's PRNG key);
  * sampling: greedy at ``temperature <= 0``, else a threefry Gumbel draw
    bitwise equal to ``jax.random.categorical``'s, one PRNG stream a
    request from ``PRNGKey(seed)`` (``core.prng``).  Each slot's key lives
    on the device, filled at admission (``resume_key`` after a preemption)
    and split on every step; a row that samples keeps the carry.  The
    draw and the split are one kernel call (``kernels.sample``);
  * deadlines, cancellation, admission-control shedding, and the
    registry-backed ``stats``, lifecycle histograms and trace spans;
  * the kernel-dispatch counters (``kernel_dispatches``,
    ``dense_fallback_<reason>``), re-derived per step from the same
    ``kernels.ops.paged_dispatch`` the layers consult;
  * the compressed decode path: ``fuse_projections`` (exact QKV fusion)
    and ``quantize="int8"|"int4"`` (per-block factor quantization) are
    applied once at load, on the engine's device
    (``models.decode_path.prepare_decode_params``), and
    ``kv_dtype="int8"`` stores the pool as int8 pages with per-(page, head)
    fp32 scales (``core.quant``).  The factors are dequantized on chip by
    ``monarch_fused_q`` / ``bdmm_q`` under ``backend="pallas"``, and the
    pages by the int8 span kernel under ``use_paged_kernel``.

Per step the host uploads one packed int32 buffer (span tokens, starts,
span lengths, flags, fork points, page tables) from pinned memory without
blocking, so the upload never waits for the device; a step's copy-on-write
fork list, and its admitted slots' temperatures and keys, take the same
path.

**CUDA graphs** (the counterpart of the reference's ``_mixed_step_jit``):
on a CUDA device at tp = 1, every step of a bucket -- its span bucket, and
whether any row may draw at a temperature > 0, which the host knows as the
reference's ``lax.cond`` decides it on the device -- after its first
replays one captured graph of the whole step (``serving.step_graphs``):
the packed buffer lands in the bucket's static input, the chained device
token and the slots' keys and temperatures are persistent buffers read
and written in place, and the sampled
tokens are cloned out of the graph before the harvest reads them a step
later.  There is no switch, as the reference always jits.  Under a mesh
the step stays eager: gloo's collectives run on the host, between the
kernels, and a graph cannot hold them.  On the CPU the same step runs
eagerly.

**Tensor parallelism** (``mesh=``, a ``launch.mesh.Mesh`` with ``data =
1`` and ``model = tp``): the engine is SPMD — every rank is a process
that builds its own engine from the same full params and receives the
same ``add_request``/``cancel`` calls; the mesh must have joined its world
(``launch.mesh.make_host_mesh``), and its device is the engine's.  What
splits is decided once at load (``sharding.params.tp_plan``), and the
params are sliced by that plan (``shard_params``: Megatron pairs on the
Monarch block axes, a vocab-parallel tied embedding).  The rank's pool
holds its KV heads (``DeviceKV``; the page axis is never split, so host
planning stays in logical pages, identical at every tp), a
``pool_bytes`` budget is one
rank's memory (``1 + pool_bytes // shard_page_bytes`` pages), and its
attention runs the span kernel per rank (B7) or, for a pool left whole,
the dense gather (counted ``dense_fallback_gqa_replicated``).  The
logits come out whole on every rank, so every rank samples the same
tokens.  The host loop is REPLICATED rather than planned on rank 0 and
broadcast: its decisions depend on its inputs and on the clock alone
(request ids, the trie's LRU stamps and the scheduler are deterministic
counters), so rank 0 broadcasts one clock reading at the start of each
step and every rank's deadlines, shedding and timestamps read that value
until the next step (a request added between steps is stamped with the
last step's reading; a ``cancel`` between steps is one of the calls
every rank receives).  That costs one small host broadcast a step where
planning on rank 0 would cost a packed-plan broadcast plus host code to
replay it.  Under a mesh ``quantize``/``fuse_projections`` raise
``NotImplementedError`` (not ported yet).

Not ported yet (they raise ``NotImplementedError``): ``fault_injector``,
``heartbeat`` and snapshot/restore.  The legacy ``ServeEngine`` is not
ported either.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import math
import os
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device, tree_to
from repro_torch.core import prng
from repro_torch.core.quant import (BITS_BY_NAME, KV_DTYPE_BYTES,
                                    kv_page_bytes)
from repro_torch.kernels.paged import reserve_workspace
from repro_torch.kernels.sample import sample_tokens
from repro_torch.models import transformer as T
from repro_torch.models.decode_path import prepare_decode_params
from repro_torch.models.config import ModelConfig
from repro_torch.launch.mesh import rank_device
from repro_torch.serving.device_kv import DeviceKV
from repro_torch.serving.kv_pool import PagedKVPool, PoolOOM, SINK_PAGE
from repro_torch.serving.metrics import (Calibration, EngineStats,
                                         LATENCY_MS_BUCKETS, MetricsRegistry,
                                         TOKEN_BUCKETS)
from repro_torch.serving.request import (FinishReason, Request, RequestState,
                                         SamplingParams, Sequence)
from repro_torch.serving.scheduler import (CostModel, IterationScheduler,
                                           SchedulerConfig, StepPlan)
from repro_torch.serving.step_graphs import StepGraphs
from repro_torch.serving.tracing import NULL_TRACER, ChromeTracer
from repro_torch.sharding.api import broadcast_time
from repro_torch.sharding.params import shard_params, tp_plan


@dataclasses.dataclass
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0     # 0 => greedy
    eos_id: Optional[int] = None
    seed: int = 0


def _bucket(n: int, lo: int = 1) -> int:
    return max(lo, 1 << (n - 1).bit_length())


def _mixed_step(params, pool, cfg: ModelConfig, chunk_tok, tok_dev, use_dev,
                start, span, pt, wstart, sample_mask, temps, keys,
                draw: bool, plan=None):
    """ONE unified engine iteration over the slot batch.

    ``chunk_tok`` (B, S) carries host-known span tokens (prefill chunks);
    rows flagged ``use_dev`` are decodes whose single input token is the
    previous step's on-device sample (``tok_dev``), so the dispatch chain
    never waits on a host read-back.  Every row's key (``keys`` (B, 2)
    int32 words) splits into a draw key and a carry (the reference's
    ``_split_rows``); rows whose span reaches the end of their known
    tokens (``sample_mask``) take the token drawn at their temperature
    (``temps``, greedy at <= 0; every row is greedy unless ``draw``, the
    host's view of the reference's ``lax.cond``) and keep the carry,
    everyone else keeps their device token and key.  ``wstart`` (B,) is
    each row's copy-on-write fork point.  Returns (sampled, new device
    tokens, logits); the pool and ``keys`` are updated in place."""
    tokens = chunk_tok.clone()
    tokens[:, 0] = torch.where(use_dev, tok_dev, chunk_tok[:, 0])
    logits, _ = T.paged_mixed_step(params, tokens, start, span, pt, pool,
                                   cfg, write_start=wstart, plan=plan)
    sampled = sample_tokens(logits, temps, keys, sample_mask, draw)
    return sampled, torch.where(sample_mask, sampled, tok_dev), logits


def _packed_step(params, pool, cfg: ModelConfig, tok: torch.Tensor,
                 keys: torch.Tensor, temps: torch.Tensor,
                 packed: torch.Tensor, bucket: tuple[int, bool], plan=None):
    """:func:`_mixed_step` on one step's packed int32 buffer (``B * S`` span
    tokens, then starts, span lengths, use-device flags, sample flags and
    fork points, B each, then the (B, MP) page tables) of ``bucket = (S,
    draw)``, with the chained device token ``tok`` (B,) and the slots'
    ``keys`` updated in place and their temperatures ``temps`` read: the
    function each step graph captures, and the eager step.  Returns
    (sampled, logits)."""
    S, draw = bucket
    B = tok.shape[0]
    o = B * S
    cols = [packed[o + i * B:o + (i + 1) * B] for i in range(5)]
    sampled, new_tok, logits = _mixed_step(
        params, pool, cfg, packed[:o].view(B, S), tok, cols[2].bool(),
        cols[0], cols[1], packed[o + 5 * B:].view(B, -1), cols[4],
        cols[3].bool(), temps, keys, draw, plan=plan)
    tok.copy_(new_tok)
    return sampled, logits


class _Uploader:
    """One non-blocking host-to-device copy of a packed int32 buffer per
    step, through a ring of pinned staging buffers (a buffer is reused
    only after its previous copy has finished)."""

    RING = 3

    def __init__(self, device: torch.device):
        self.device = device
        self.pinned = device.type == "cuda"
        self._bufs: list = [None] * self.RING
        self._events: list = [None] * self.RING
        self._i = 0

    def __call__(self, host: np.ndarray,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``host`` on the device: a new tensor, or copied into ``out``."""
        if not self.pinned:
            if out is None:
                return torch.from_numpy(host.copy())
            return out.copy_(torch.from_numpy(host))
        i = self._i
        self._i = (i + 1) % self.RING
        if self._events[i] is not None:
            self._events[i].synchronize()
        buf = self._bufs[i]
        if buf is None or buf.numel() < host.size:
            buf = self._bufs[i] = torch.empty(
                max(host.size, 1024), dtype=torch.int32, pin_memory=True)
        buf[:host.size].numpy()[:] = host
        if out is None:
            out = buf[:host.size].to(self.device, non_blocking=True)
        else:
            out.copy_(buf[:host.size], non_blocking=True)
        ev = self._events[i] = torch.cuda.Event()
        ev.record()
        return out


class ContinuousBatchingEngine:
    """Iteration-scheduled serving over a paged KV pool (attn stacks)."""

    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 8,
                 page_size: int = 16, max_len: int = 512,
                 n_pages: Optional[int] = None,
                 pool_bytes: Optional[int] = None,
                 chunk_size: Optional[int] = None,
                 scheduler_cfg: Optional[SchedulerConfig] = None,
                 cost_model: Optional[CostModel] = None,
                 use_paged_kernel: bool = False,
                 quantize: Optional[str] = None,
                 fuse_projections: bool = False,
                 prefix_sharing: bool = True,
                 kv_dtype: Optional[str] = None,
                 metrics: bool = True,
                 trace: Union[bool, str, os.PathLike, None] = None,
                 fault_injector=None,
                 heartbeat=None, heartbeat_rank: int = 0,
                 mesh=None,
                 device: DeviceLike = None):
        if cfg.layer_kind != "attn":
            raise ValueError("continuous batching needs an attn stack")
        if quantize is not None and quantize not in BITS_BY_NAME:
            raise ValueError(
                f"quantize must be one of {sorted(BITS_BY_NAME)} or None, "
                f"got {quantize!r}")
        unported = {"fault_injector": fault_injector is not None,
                    "heartbeat": heartbeat is not None}
        for name, used in unported.items():
            if used:
                raise NotImplementedError(f"{name} is not ported yet")
        if mesh is not None and (quantize or fuse_projections):
            raise NotImplementedError(
                "quantized or fused factors under tensor parallelism are "
                "not ported yet")
        if use_paged_kernel:
            cfg = dataclasses.replace(cfg, paged_kernel=True)
        self.cfg = cfg
        self.mesh = mesh
        self.tp = 1 if mesh is None else mesh.model
        self.plan = None
        if mesh is not None:
            if mesh.group is None:
                raise ValueError(
                    "the mesh has no process group (a shape alone): join "
                    "the world with launch.mesh.make_host_mesh")
            if device is not None and rank_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            self.device = mesh.device
            self.plan = tp_plan(params, cfg, mesh)
            params = shard_params(params, self.plan)
        else:
            self.device = resolve_device(device)
            params = tree_to(params, self.device)
        if fuse_projections or quantize:
            params = prepare_decode_params(
                params, cfg, fuse=fuse_projections,
                bits=BITS_BY_NAME.get(quantize))
        self.params = params
        self.weight_bits = BITS_BY_NAME.get(quantize, 32)
        self.page_size = page_size
        self.max_len = max_len
        self.max_pages_per_seq = math.ceil(max_len / page_size)
        if kv_dtype is not None and kv_dtype not in KV_DTYPE_BYTES:
            raise ValueError(
                f"kv_dtype must be one of {sorted(KV_DTYPE_BYTES)} or None, "
                f"got {kv_dtype!r}")
        self.kv_dtype = kv_dtype or (
            "bf16" if cfg.dtype == "bfloat16" else "fp32")
        page_bytes = kv_page_bytes(cfg.n_layers, cfg.n_kv_heads, cfg.hd,
                                   page_size, self.kv_dtype)
        # what one rank stores of a logical page: a pool_bytes budget is
        # one rank's memory, so a split pool holds ~kv_shard x the pages
        kv_shard = 1 if self.plan is None else self.plan.kv_shard
        shard_page_bytes = kv_page_bytes(
            cfg.n_layers, cfg.n_kv_heads // kv_shard, cfg.hd, page_size,
            self.kv_dtype)
        if n_pages is not None and pool_bytes is not None:
            raise ValueError(
                "pass n_pages (a page count) OR pool_bytes (a byte budget "
                "the kv_dtype converts into pages), not both")
        if n_pages is None:
            if pool_bytes is not None:
                n_pages = 1 + max(1, pool_bytes // shard_page_bytes)
            else:  # worst case: every slot at max_len, plus sink
                n_pages = 1 + max_slots * self.max_pages_per_seq
        self.pool_host = PagedKVPool(n_pages, page_size,
                                     self.max_pages_per_seq,
                                     kv_dtype=self.kv_dtype,
                                     page_bytes=page_bytes,
                                     kv_shard=kv_shard)
        self.kv = DeviceKV(cfg, n_pages, page_size, kv_dtype=kv_dtype,
                           plan=self.plan, device=self.device)
        self.prefix_sharing = prefix_sharing
        sc = scheduler_cfg or SchedulerConfig()
        sc = dataclasses.replace(sc, max_slots=max_slots,
                                 prefix_sharing=prefix_sharing)
        if chunk_size is not None:
            sc = dataclasses.replace(sc, chunk_size=chunk_size)
        self.scheduler = IterationScheduler(sc, cost_model)

        S, MP = max_slots, self.max_pages_per_seq
        self.max_slots = S
        # the chained device token: one buffer, read and written in place;
        # likewise each slot's PRNG key (int32 words) and temperature, set
        # at admission (a host copy of the temperatures picks the bucket)
        self._tok = torch.zeros((S,), dtype=torch.int32, device=self.device)
        self._keys = torch.zeros((S, 2), dtype=torch.int32,
                                 device=self.device)
        self._temp = torch.zeros((S,), dtype=torch.float32,
                                 device=self.device)
        self._temp_host = np.zeros((S,), np.float32)
        # host-side truth of the page tables and COW fork points: uploaded
        # with every step's packed buffer
        self._pt = np.full((S, MP), SINK_PAGE, np.int32)
        self._wstart = np.zeros((S,), np.int32)
        self._upload = _Uploader(self.device)
        # the last dispatched step's logits (max_slots, Vp) on the device
        # (a graph replay overwrites them at its bucket's next step) and
        # its rows with a span
        self.step_logits: Optional[torch.Tensor] = None
        self.step_rows = np.zeros((S,), bool)
        # one step of bucket (S, draw): _step(packed device buffer, bucket);
        # it holds no reference to the engine, so that the engine and its
        # graphs' memory are freed as soon as nothing holds the engine
        self._step = functools.partial(_packed_step, self.params, self.pool,
                                       self.cfg, self._tok, self._keys,
                                       self._temp, plan=self.plan)
        self.step_graphs: Optional[StepGraphs] = None
        if self.device.type == "cuda" and mesh is None:
            self.step_graphs = StepGraphs(self._step)
            if self._kernel_decision() == "kernel":
                # one workspace for the span kernel at every bucket, before
                # the first capture (kernels/paged.py: reserve_workspace)
                buckets = [1 << i for i in range(
                    _bucket(sc.chunk_size).bit_length())]
                reserve_workspace(self.device, S, cfg.n_heads, cfg.hd,
                                  page_size, MP, buckets)

        self.waiting: collections.deque[Request] = collections.deque()
        self.running: dict[int, Sequence] = {}          # slot -> Sequence
        self._free_slots = list(range(S - 1, -1, -1))
        self._admit_stamp = itertools.count()           # priority order
        self._pending: list[dict] = []                  # un-harvested steps
        self.step_idx = 0

        # -- observability: registry-backed stats, spans, calibration ------
        self.registry = MetricsRegistry()
        self.stats = EngineStats(self.registry)
        self.metrics_enabled = bool(metrics)
        if trace:
            path = trace if isinstance(trace, (str, os.PathLike)) else None
            self.tracer = ChromeTracer(path=path)
        else:
            self.tracer = NULL_TRACER
        self.calibration = Calibration(
            "engine_step", self.registry if self.metrics_enabled else None)
        # (step_idx, req_id, kind, n_tokens) per executed span
        self.dispatch_log: list[tuple[int, int, str, int]] = []
        if self.metrics_enabled:
            h, g = self.registry.histogram, self.registry.gauge
            self._h_ttft = h("request.ttft_ms", LATENCY_MS_BUCKETS)
            self._h_itl = h("request.itl_ms", LATENCY_MS_BUCKETS)
            self._h_queue_wait = h("request.queue_wait_ms",
                                   LATENCY_MS_BUCKETS)
            self._h_e2e = h("request.e2e_ms", LATENCY_MS_BUCKETS)
            self._h_cached = h("request.cached_tokens", TOKEN_BUCKETS)
            self._h_cow = h("request.cow_pages", (0.0, 1.0, 2.0, 4.0))
            self._h_batch = h("step.batch_size",
                              (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0))
            self._h_chunk = h("step.prefill_tokens", TOKEN_BUCKETS)
            self._g_queue = g("sched.queue_depth")
            self._g_free = g("pool.free_pages")
            self._g_shared = g("pool.shared_pages")
            self._g_cached = g("pool.cached_pages")
            self._g_held = g("pool.held_pages")
            self._g_evict = g("pool.cache_evictions")
        if mesh is None:
            self._clock = time.perf_counter
        else:  # rank 0's reading, refreshed at the start of every step
            self._step_time = broadcast_time(time.perf_counter(), mesh)
            self._clock = lambda: self._step_time
        # requests finished outside the step loop (``cancel()``) surface
        # through the next ``step()``'s return value
        self._overflow: list[Request] = []

    @property
    def pool(self) -> dict:
        """This rank's device pool (owned by ``self.kv``)."""
        return self.kv.pool

    # -- request intake ----------------------------------------------------

    def _check_fits(self, req: Request) -> None:
        if req.max_total_len > self.max_len:
            raise PoolOOM(
                f"prompt+max_new={req.max_total_len} exceeds max_len="
                f"{self.max_len}")
        need = self.pool_host.pages_for(req.max_total_len)
        if need > self.pool_host.n_pages - 1:
            raise PoolOOM(
                f"request needs {need} pages; pool has "
                f"{self.pool_host.n_pages - 1} total")

    def add_request(self, prompt, sampling: Optional[SamplingParams] = None,
                    on_token=None) -> Request:
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        req = Request(prompt=prompt, sampling=sampling or SamplingParams(),
                      on_token=on_token)
        if req.sampling.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self._check_fits(req)
        if self.prefix_sharing:
            req.num_cached_tokens = self.pool_host.match_prefix(
                req.known_tokens).n_tokens
        req.arrived_step = self.step_idx
        req.t_arrival = req.t_enqueued = req.mark("arrived", self._clock())
        self.waiting.append(req)
        if self.metrics_enabled:
            self._g_queue.set(len(self.waiting))
        return req

    def has_work(self) -> bool:
        return bool(self.waiting or self.running or self._pending
                    or self._overflow)

    # -- one scheduler iteration -------------------------------------------

    def step(self) -> list[Request]:
        """Plan and dispatch ONE mixed forward (decode tokens + prefill
        chunks), harvest the previous one, evict finished sequences.
        Returns requests finished this call."""
        self.step_idx += 1
        if self.mesh is not None:
            self._step_time = broadcast_time(time.perf_counter(), self.mesh)
        t0 = time.perf_counter()
        pred0 = self.stats["sim_latency_ns"]
        with self.tracer.span("step", step=self.step_idx):
            finished = self._step_inner()
        if self.metrics_enabled:
            pred = self.stats["sim_latency_ns"] - pred0
            if pred > 0:
                self.calibration.record(pred,
                                        (time.perf_counter() - t0) * 1e9)
        return finished

    def _step_inner(self) -> list[Request]:
        finished: list[Request] = []
        if self._overflow:
            finished.extend(self._overflow)
            self._overflow.clear()
        finished.extend(self._sweep_deadlines(self._clock()))

        plan = self._plan()
        if plan.preemptions:
            # land every in-flight step before tearing a victim down, then
            # replan: the drain may have freed enough pages
            finished.extend(self.drain())
            plan = self._plan()
            if plan.preemptions:
                for seq in plan.preemptions:
                    self._preempt(seq)
                plan = self._plan()
                assert not plan.preemptions, "preemption did not converge"

        for req in plan.sheds:
            try:
                self.waiting.remove(req)
            except ValueError:
                continue   # cancelled between plan and execution
            self._finish_abort(req, FinishReason.SHED)
            finished.append(req)
        if plan.degraded:
            self.stats["degraded_chunks"] += plan.degraded
        if plan.prefix_deferred:
            self.stats["prefix_deferrals"] += plan.prefix_deferred

        spans = list(plan.spans)
        # reserve the mandatory decodes' pages before admissions touch the
        # pool (an admission's COW fork may draw pages the plan did not
        # charge it for; only prefill spans can shrink in _dispatch)
        for seq, n in spans:
            if seq.request.state is RequestState.RUNNING:
                new = self.pool_host.extend(seq.req_id, seq.num_computed + n)
                if new:
                    seq.page_ids.extend(new)
        spans.extend(self._admit(plan.admissions))
        if spans:
            self._dispatch(spans)

        # harvest everything but the step just dispatched (one-step lag)
        keep_last = 1 if spans else 0
        while len(self._pending) > keep_last:
            finished.extend(self._harvest(self._pending.pop(0)))
        return finished

    # -- deadlines / cancellation ------------------------------------------

    def drain(self) -> list[Request]:
        """Harvest every in-flight dispatched step (device sync)."""
        done: list[Request] = []
        while self._pending:
            done.extend(self._harvest(self._pending.pop(0)))
        return done

    def cancel(self, req_id: int,
               reason: FinishReason = FinishReason.ABORTED) -> bool:
        """Abort a request by id.  A resident sequence is torn down only
        after ``drain()``.  Returns False for an unknown or finished id."""
        for req in list(self.waiting):
            if req.req_id == req_id:
                self.waiting.remove(req)
                self._finish_abort(req, reason)
                self._overflow.append(req)
                return True
        seq = next((s for s in self.running.values()
                    if s.req_id == req_id), None)
        if seq is None:
            return False
        self._overflow.extend(self.drain())
        req = seq.request
        if (req.state is RequestState.FINISHED
                or self.running.get(seq.slot) is not seq):
            return False   # the drain finished it before the cancel landed
        self._finish_abort(req, reason)
        self._evict(seq)
        self._overflow.append(req)
        return True

    def _sweep_deadlines(self, now: float) -> list[Request]:
        done: list[Request] = []
        for req in [r for r in self.waiting if self._expired(r, now)]:
            self.waiting.remove(req)
            self._finish_abort(req, FinishReason.TIMEOUT, now)
            done.append(req)
        victims = [s for s in self.running.values()
                   if self._expired(s.request, now)]
        if victims:
            done.extend(self.drain())
            for seq in victims:
                if (seq.request.state is RequestState.FINISHED
                        or self.running.get(seq.slot) is not seq):
                    continue   # the drain finished it first
                self._finish_abort(seq.request, FinishReason.TIMEOUT, now)
                self._evict(seq)
                done.append(seq.request)
        return done

    @staticmethod
    def _expired(req: Request, now: float) -> bool:
        dl = req.sampling.deadline_s
        return (dl is not None and req.t_arrival >= 0
                and now - req.t_arrival > dl)

    _ABORT_COUNTER = {FinishReason.ABORTED: "aborts",
                      FinishReason.TIMEOUT: "timeouts",
                      FinishReason.SHED: "sheds"}

    def _finish_abort(self, req: Request, reason: FinishReason,
                      now: Optional[float] = None) -> None:
        if now is None:
            now = self._clock()
        req.mark(reason.value, now)
        req.finish(reason, self.step_idx, now)
        self.stats[self._ABORT_COUNTER[reason]] += 1
        self.stats["finished"] += 1
        self.tracer.instant("abort", req_id=req.req_id, reason=reason.value)

    def run(self) -> list[Request]:
        """Drive steps until every request has finished."""
        done: list[Request] = []
        while self.has_work():
            done.extend(self.step())
        return done

    def generate(self, prompts, gen: GenerationConfig) -> torch.Tensor:
        """Compat API: (B, S) prompts -> (B, max_new_tokens) int32 tokens on
        the CPU (rows that hit EOS early are zero-padded)."""
        prompts = np.asarray(prompts)
        B = prompts.shape[0]
        if gen.max_new_tokens < 1:
            return torch.zeros((B, 0), dtype=torch.int32)
        reqs = [self.add_request(
            prompts[b],
            SamplingParams(max_new_tokens=gen.max_new_tokens,
                           temperature=gen.temperature, eos_id=gen.eos_id,
                           seed=gen.seed + b))
            for b in range(B)]
        self.run()
        out = np.zeros((B, gen.max_new_tokens), np.int32)
        for b, r in enumerate(reqs):
            out[b, :len(r.output_tokens)] = r.output_tokens
        return torch.from_numpy(out)

    # -- internals ---------------------------------------------------------

    def _plan(self) -> StepPlan:
        with self.tracer.span("plan", step=self.step_idx):
            return self.scheduler.plan_step(
                list(self.waiting), list(self.running.values()),
                self.pool_host, now=self._clock())

    def _admit(self, admissions: list[tuple[Request, int]]
               ) -> list[tuple[Sequence, int]]:
        """Move admitted requests into slots; their first chunks join this
        step's spans.  With prefix sharing the page table starts from the
        trie match (shared full pages by refcount, a partial page by a COW
        fork copied on device here, before the step that writes into it)."""
        if not admissions:
            return []
        with self.tracer.span("admit", step=self.step_idx,
                              n=len(admissions)):
            return self._admit_inner(admissions)

    def _admit_inner(self, admissions: list[tuple[Request, int]]
                     ) -> list[tuple[Sequence, int]]:
        spans: list[tuple[Sequence, int]] = []
        cow_ops: list[tuple[int, int]] = []
        rows: list[int] = []
        keys: list[np.ndarray] = []
        for req, chunk in admissions:
            try:
                self.waiting.remove(req)
            except ValueError:
                raise AssertionError(
                    f"admitted request {req.req_id} is not in the queue")
            req.state = RequestState.PREFILLING
            if req.admitted_step < 0:
                req.admitted_step = self.step_idx
            target = len(req.known_tokens)
            n_cow = 0
            if self.prefix_sharing:
                pages, matched, cow = self.pool_host.acquire_prefix(
                    req.req_id, req.known_tokens)
                chunk = min(chunk, target - matched)
                cow_ops.extend(cow)
                n_cow = len(cow)
                self.stats["prefix_hit_tokens"] = \
                    self.pool_host.prefix_hit_tokens
                self.stats["cow_forks"] = self.pool_host.cow_forks
            else:
                pages, matched = self.pool_host.allocate(req.req_id,
                                                         chunk), 0
            req.num_computed_tokens = matched
            req.num_cached_tokens = matched
            now = self._clock()
            if req.t_admitted < 0:
                req.t_admitted = now
            req.mark("resumed" if req.num_preemptions else "admitted", now)
            if self.metrics_enabled:
                self._h_queue_wait.observe((now - req.t_enqueued) * 1e3)
                self._h_cached.observe(matched)
                self._h_cow.observe(n_cow)
            slot = self._free_slots.pop()
            seq = Sequence(request=req, slot=slot, page_ids=pages,
                           prefill_target=target,
                           admit_order=next(self._admit_stamp),
                           t_admitted=now)
            self.running[slot] = seq
            spans.append((seq, chunk))
            self._wstart[slot] = matched
            rows.append(slot)
            self._temp_host[slot] = req.sampling.temperature
            keys.append(np.asarray(req.resume_key, np.uint32)
                        if req.resume_key is not None
                        else prng.prng_key(req.sampling.seed).numpy()
                        .astype(np.uint32))
        # the admitted slots' temperatures and keys, through the pinned
        # upload: [slots, temperature bits, key words]
        n = len(rows)
        idx = np.asarray(rows, np.int32)
        dev = self._upload(np.concatenate([
            idx, self._temp_host[idx].view(np.int32),
            np.stack(keys).view(np.int32).reshape(-1)]))
        slots = dev[:n].long()
        self._temp.index_copy_(0, slots, dev[n:2 * n].view(torch.float32))
        self._keys.index_copy_(0, slots, dev[2 * n:].view(n, 2))
        if cow_ops:
            # whole-page device copies; rows past the fork point are stale
            # source data, masked by causality until overwritten
            n = _bucket(len(cow_ops))
            src = np.full((n,), SINK_PAGE, np.int32)  # pad: sink onto itself
            dst = np.full((n,), SINK_PAGE, np.int32)
            for i, (s, d) in enumerate(cow_ops):
                src[i], dst[i] = s, d
            dev = self._upload(np.concatenate([src, dst]))
            T.cow_copy_pages(self.pool, dev[:n], dev[n:])
        if self.metrics_enabled:
            self._g_queue.set(len(self.waiting))
        return spans

    def _dispatch(self, spans: list[tuple[Sequence, int]]) -> None:
        """Grow page tables to cover every span, build the (slot, span)
        batch, and dispatch the mixed step."""
        with self.tracer.span("dispatch", step=self.step_idx,
                              spans=len(spans)):
            self._dispatch_inner(spans)

    def _dispatch_inner(self, spans: list[tuple[Sequence, int]]) -> None:
        B = self.max_slots
        Sb = _bucket(max(n for _, n in spans))
        chunk_tok = np.zeros((B, Sb), np.int32)
        start = np.zeros((B,), np.int32)
        span = np.zeros((B,), np.int32)          # 0 = inert row (sink writes)
        use_dev = np.zeros((B,), np.int32)
        sample = np.zeros((B,), np.int32)
        harvest: list[tuple[int, Sequence]] = []
        n_dec, dec_ctx, prefill_toks, n_rows = 0, 0, 0, 0

        for seq, n in spans:
            req = seq.request
            nc = seq.num_computed
            if req.state is not RequestState.RUNNING:
                # prefill chunk: absorb planning drift by shrinking the span
                # to the pages actually on hand; 0 stalls the row this step
                cover = (len(seq.page_ids) * self.page_size - nc
                         + self.pool_host.free_pages * self.page_size)
                n = min(n, max(cover, 0))
                if n <= 0:
                    continue
            new = self.pool_host.extend(req.req_id, nc + n)
            if new:
                seq.page_ids.extend(new)
            self.pool_host.assert_writable(req.req_id, nc, nc + n)
            s = seq.slot
            start[s] = nc
            span[s] = n
            if req.state is RequestState.RUNNING:   # decode: device token
                use_dev[s] = 1
                sample[s] = 1
                n_dec += 1
                dec_ctx += nc
                self.stats["decode_tokens"] += 1
                if self.metrics_enabled:
                    self.dispatch_log.append(
                        (self.step_idx, req.req_id, "decode", 1))
            else:                                    # prefill chunk
                chunk_tok[s, :n] = req.known_tokens[nc:nc + n]
                reaches_end = nc + n >= seq.prefill_target
                sample[s] = reaches_end
                prefill_toks += n
                self.stats["prefill_tokens"] += n
                if self.metrics_enabled:
                    self.dispatch_log.append(
                        (self.step_idx, req.req_id, "prefill", n))
                if reaches_end:
                    req.state = RequestState.RUNNING
                if self.prefix_sharing:
                    self.pool_host.commit_prefix(req.req_id,
                                                 req.known_tokens, nc + n)
            req.num_computed_tokens = nc + n
            self.pool_host.advance(req.req_id, n)
            n_rows += 1
            if sample[s]:
                harvest.append((s, seq))

        for seq in self.running.values():
            ids = seq.page_ids
            row = self._pt[seq.slot]
            row[:len(ids)] = ids
            row[len(ids):] = SINK_PAGE

        lat, nrg = self.scheduler.step_cost(
            n_dec, (dec_ctx / n_dec) if n_dec else 0.0, prefill_toks)
        self.stats["sim_latency_ns"] += lat
        self.stats["sim_energy_nj"] += nrg
        self.stats["mixed_steps"] += 1

        decision = self._kernel_decision()
        if decision == "kernel":
            self.stats["kernel_dispatches"] += 1
        else:
            self.stats["dense_fallbacks"] += 1
            self.stats[f"dense_fallback_{decision}"] += 1

        if self.metrics_enabled or self.tracer.enabled:
            ps = self.pool_host.stats()
            if self.metrics_enabled:
                self._h_batch.observe(n_rows)
                self._h_chunk.observe(prefill_toks)
                self._g_free.set(ps.free_pages)
                self._g_shared.set(ps.shared_pages)
                self._g_cached.set(ps.cached_pages)
                self._g_held.set(ps.unique_pages)
                self._g_evict.set(ps.cache_evictions)
            if self.tracer.enabled:
                self.tracer.counter(
                    "pool_pages", free=ps.free_pages, shared=ps.shared_pages,
                    cached=ps.cached_pages)

        packed = np.concatenate([chunk_tok.reshape(-1), start, span, use_dev,
                                 sample, self._wstart, self._pt.reshape(-1)])
        bucket = (Sb, bool((self._temp_host[sample > 0] > 0.0).any()))
        if self.step_graphs is not None:
            sampled, logits = self.step_graphs.run(bucket, packed,
                                                   self._upload)
        else:
            sampled, logits = self._step(self._upload(packed), bucket)
        self.step_logits, self.step_rows = logits, span > 0
        self._pending.append({"sampled": sampled, "slots": harvest,
                              "step": self.step_idx})


    def _kernel_decision(self) -> str:
        """The kernel-vs-dense decision the mixed step takes:
        ``kernels.ops.paged_dispatch`` with exactly the arguments
        ``models.layers._paged_attend`` derives from the shapes."""
        from repro_torch.kernels.ops import paged_dispatch

        cfg = self.cfg
        return paged_dispatch(
            cfg.hd, self.page_size, paged_kernel=cfg.paged_kernel,
            softcap=cfg.logit_softcap is not None,
            pool_replicated=self.plan is not None
            and self.plan.pool_replicated)

    def _harvest(self, entry: dict) -> list[Request]:
        step = entry.get("step", -1)
        with self.tracer.span("harvest", step=step):
            with self.tracer.span("sync", step=step):
                sampled = entry["sampled"].cpu().numpy()  # waits on device
            # token stamps are taken after the device sync (see request.py)
            now = self._clock()
            finished = []
            for slot, seq in entry["slots"]:
                req = seq.request
                if req.state is not RequestState.RUNNING:
                    continue  # finished by an earlier harvest, or preempted
                if self.running.get(slot) is not seq:
                    continue  # slot was recycled after an eviction
                self._emit(seq, int(sampled[slot]), now)
                if req.state is RequestState.FINISHED:
                    finished.append(req)
            return finished

    def _emit(self, seq: Sequence, token: int,
              now: Optional[float] = None) -> None:
        req = seq.request
        req.emit(token)
        self.stats["tokens_out"] += 1
        if now is None:
            now = self._clock()
        if len(req.output_tokens) == 1:
            req.t_first_token = now
            req.mark("first_token", now)
            if self.metrics_enabled:
                self._h_ttft.observe((now - req.t_arrival) * 1e3)
        elif self.metrics_enabled and req.t_last_token > 0:
            self._h_itl.observe((now - req.t_last_token) * 1e3)
        req.t_last_token = now
        sp = req.sampling
        if sp.eos_id is not None and token == sp.eos_id:
            req.finish(FinishReason.EOS, self.step_idx, now)
        elif len(req.output_tokens) >= sp.max_new_tokens:
            req.finish(FinishReason.LENGTH, self.step_idx, now)
        if req.state is RequestState.FINISHED:
            self.stats["finished"] += 1
            if self.metrics_enabled:
                self._h_e2e.observe((now - req.t_arrival) * 1e3)
            self._evict(seq)

    def _evict(self, seq: Sequence) -> None:
        self.pool_host.free(seq.req_id)
        self.running.pop(seq.slot)
        self._free_slots.append(seq.slot)
        self._pt[seq.slot] = SINK_PAGE

    def _preempt(self, seq: Sequence) -> None:
        """Evict a PREFILLING/RUNNING sequence back to WAITING: pages freed,
        cursor reset (recompute on resume), emitted tokens and the PRNG
        stream kept.  The victim rejoins at the FRONT of the queue."""
        req = seq.request
        # the harvest drain ran before any preemption, so the slot's key is
        # the settled carry (one read from the device, on preemption only)
        req.resume_key = self._keys[seq.slot].cpu().numpy().view(
            np.uint32).copy()
        self._evict(seq)
        req.num_computed_tokens = 0
        req.state = RequestState.WAITING
        req.num_preemptions += 1
        req.t_enqueued = req.mark("preempted", self._clock())
        self.stats["preemptions"] += 1
        self.tracer.instant("preempt", req_id=req.req_id)
        self.waiting.appendleft(req)

    # -- not ported yet ----------------------------------------------------

    def snapshot(self, include_kv: bool = True) -> dict:
        raise NotImplementedError("engine snapshots are not ported yet")

    def save_snapshot(self, directory, include_kv: bool = True) -> dict:
        raise NotImplementedError("engine snapshots are not ported yet")

    @classmethod
    def restore(cls, snap: dict, cfg: ModelConfig, params, **engine_kw):
        raise NotImplementedError("engine snapshots are not ported yet")


__all__ = ["ContinuousBatchingEngine", "GenerationConfig"]
