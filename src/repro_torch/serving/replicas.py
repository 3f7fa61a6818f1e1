"""Data-parallel serving: R engine replicas behind one admission router
(port of ``repro.serving.replicas``; the same routing, health, failover,
migration, quarantine and fleet-snapshot contract).

Tensor parallelism scales ONE engine's step; this layer scales REQUEST
throughput by running ``n_replicas`` independent
:class:`ContinuousBatchingEngine` instances — each with its own KV pool,
prefix trie, scheduler and step graphs — behind a shared admission point
that routes every request once, at intake.  Replicas correspond to slices
of the mesh's "data" axis, or simply to extra host parallelism on one
device.

**Replicas on one card** step in turn on one stream, as the reference's
host loop does: each engine captures its graphs into a memory pool of its
own, and every engine's span kernel launches on the module-level
workspace of ``kernels.paged`` (each graph holding the buffers it was
captured on), which is safe only because no two replicas' steps run at
once.  The one-step harvest lag still overlaps one replica's host
planning with the device work the others queued.

Router / affinity contract
==========================

* **Who owns the shared queue.** The router does — but only up to the
  routing decision.  ``add_request`` picks a replica *immediately* and
  hands the request to that replica's own waiting queue; there is no
  router-side holding pen, so every queue invariant (FIFO order,
  priorities, shedding budgets, deadline sweeps, preemption re-queueing)
  keeps exactly one owner: the replica engine.  The router records
  ``req_id -> replica`` and forwards ``cancel``; requests it never saw
  (added directly on a replica) still cancel through that replica.

* **Routing policy.** ``routing="affinity"`` (default) scores each replica
  by ``pool_host.match_prefix(prompt).n_tokens`` — a pure trie lookup, no
  pool mutation — and sends the request to the replica already holding the
  longest committed prefix (ties broken toward the least-loaded, then the
  lowest index).  A zero-score prompt falls back to the least-loaded
  replica.  ``routing="round_robin"`` bypasses scoring (the benchmark
  baseline).  ``router.affinity_hits`` counts only routings where the
  winning score was a real, positive trie match, so it can never exceed
  the number of actual trie matches.

* **How replica-local tries diverge.** Prefix pages commit to the trie of
  whichever replica computed them, and replicas never exchange pages — so
  the tries drift apart by construction, and affinity routing is what
  keeps the drift USEFUL: repeats of a prompt family land where the family
  already lives, concentrating (rather than replicating) the cache.  The
  cross-replica hit rate is therefore workload-dependent; the in-replica
  hit semantics (COW, refcounts, eviction) are untouched.

* **Metrics.** Each replica keeps its own registry (its counters stay
  authoritative); ``sync_metrics`` fans them — counters, gauges AND
  histograms — into the router's single registry under ``replica<i>.``
  prefixes next to the ``router.*`` counters, and ``stats()`` returns the
  summed engine counters plus the per-replica breakdown.

Replica fault-tolerance contract
================================

Every replica carries a health state the router sweeps once per
``step()``:

  HEALTHY   routed + stepped.           DEGRADED  stepped, never routed.
  DRAINING  stepped until empty.        DOWN      never routed or stepped.

* **Detection.** Each replica is attached to a :class:`FleetSupervisor`
  (``ft/coordinator.py``) under a distinct heartbeat rank.  A replica goes
  DOWN when (a) its ``step()`` raises — the exception is captured, never
  poisons the other replicas' loop — or (b) it goes heartbeat-silent: its
  own ``step_idx`` runs ``silence_steps_down`` steps past the step it last
  reported (deterministic, no wall clock), or the registry's wall-clock
  timeout expires.  A replica the :class:`StragglerMonitor` flags is
  DEGRADED until its rolling window recovers.

* **Failover — what is preserved.** If the failed rank has a published
  snapshot (``publish_snapshots`` / ``FleetSupervisor.publish``), the slot
  is rebuilt from it in place under a fresh rank: token-identical per the
  snapshot recovery contract for every request the snapshot holds.  The
  router then reconciles: requests it already reported finished are
  cancelled inside the restored engine (never re-served, never
  re-reported), and requests admitted after the publish fall through to
  migration.

* **Migration — what is recomputed.** Without a snapshot, every orphaned
  request (prompt, emitted tokens, budgets, priority) moves to a healthy
  survivor as WAITING via ``engine.readmit`` — the
  recompute-on-resume contract.  Sampled requests rebuild their PRNG carry
  host-side by replaying ``len(output_tokens)`` splits from
  ``PRNGKey(seed)``, so even a token lost in the crashed step's in-flight
  dispatch is re-drawn identically.  Only KV recompute work is paid again;
  greedy AND sampled outputs stay token-identical.

* **Quarantine — what is dropped.** A migration charges the request's
  retry budget (``max_request_retries``); a request whose replica dies
  twice under it is treated as poison and finishes ABORTED instead of
  taking a third replica down.  ``router.quarantined`` counts them and
  ``quarantined`` holds their ids.

* **Elasticity.** ``drain_replica(i)`` stops routing to a replica and
  either migrates its residents out immediately or lets it finish them;
  the emptied replica detaches (rank released, snapshot dropped).
  ``scale_to(n)`` grows the fleet with fresh empty engines of the same
  geometry (DOWN slots are revived in place first) or shrinks it by
  draining the highest slots, returning the same :class:`ElasticPlan`
  shape the training-side remesh planner emits.

* **Snapshot/restore of the FLEET.** ``snapshot()`` (format v2) captures
  per-replica engine snapshots for live slots plus the router's owner
  table, health states, down causes, retry ledger, quarantine set and
  ``router.*`` counters — restore reproduces the degraded fleet exactly
  (DOWN slots come back as empty same-geometry placeholders that are
  never routed or stepped).  v1 snapshots restore as an all-HEALTHY
  fleet.
"""

from __future__ import annotations

import enum
import time
from typing import Optional

import numpy as np

from repro_torch.core import prng
from repro_torch.ft.coordinator import ElasticPlan, FleetSupervisor
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.request import (FinishReason, Request, RequestState,
                                   SamplingParams)
from repro_torch.serving.snapshot import (GEOMETRY_KEYS,
                                          engine_kwargs_from_config)
from repro_torch.serving.tracing import NULL_TRACER, ChromeTracer

ROUTING_POLICIES = ("affinity", "round_robin")

SNAPSHOT_FORMAT_V1 = "replicated-engine-snapshot-v1"
SNAPSHOT_FORMAT_V2 = "replicated-engine-snapshot-v2"


class ReplicaHealth(enum.Enum):
    HEALTHY = "healthy"      # routed and stepped
    DEGRADED = "degraded"    # stepped (keeps its residents), never routed
    DRAINING = "draining"    # stepped until empty, then detached
    DOWN = "down"            # never routed or stepped

    @property
    def live(self) -> bool:
        return self is not ReplicaHealth.DOWN


def _replay_key(seed: int, n_drawn: int) -> np.ndarray:
    """The per-request PRNG carry after ``n_drawn`` sampled tokens,
    reconstructed host-side.  The engine starts each request's stream at
    ``PRNGKey(seed)`` and advances one split per emitted token (draw
    ``split(k)[0]``, carry ``split(k)[1]``), so the carry is pure function
    of (seed, tokens emitted) — exactly what crash migration needs when
    the device-side carry died with the replica.  Threefry on the host
    (``core.prng``), bitwise ``jax.random``'s."""
    key = prng.prng_key(seed)
    for _ in range(n_drawn):
        key = prng.split(key, 2)[1]
    return key.numpy().astype(np.uint32)


class ReplicatedEngine:
    """R independent engine replicas behind prefix-affinity admission,
    with per-replica health, failover and elastic resizing (see module
    docstring for the full contract)."""

    def __init__(self, cfg, params, *, n_replicas: int = 2,
                 routing: str = "affinity", replicas=None,
                 supervisor: Optional[FleetSupervisor] = None,
                 max_request_retries: int = 2,
                 silence_steps_down: int = 8,
                 trace: bool = False, **engine_kw):
        if routing not in ROUTING_POLICIES:
            raise ValueError(
                f"routing must be one of {ROUTING_POLICIES}, got {routing!r}")
        self._cfg = cfg
        self._params = params
        self._engine_kw = dict(engine_kw)
        if replicas is not None:           # restore path: adopt as-is
            self.replicas = list(replicas)
        else:
            if n_replicas < 1:
                raise ValueError("n_replicas must be >= 1")
            self.replicas = [
                ContinuousBatchingEngine(cfg, params, **engine_kw)
                for _ in range(n_replicas)]
        self.routing = routing
        self.supervisor = supervisor or FleetSupervisor()
        self.max_request_retries = max_request_retries
        self.silence_steps_down = silence_steps_down
        self.tracer = (ChromeTracer(process_name="replica-router")
                       if trace else NULL_TRACER)
        # parallel to self.replicas: health state + heartbeat rank per slot
        self._health: list[ReplicaHealth] = [
            ReplicaHealth.HEALTHY for _ in self.replicas]
        self._ranks: list[int] = [self.supervisor.attach(rep)
                                  for rep in self.replicas]
        self._down_cause: dict[int, str] = {}
        self._owner: dict[int, int] = {}       # req_id -> replica index
        self._requests: dict[int, Request] = {}  # router-admitted handles
        self._retries: dict[int, int] = {}     # req_id -> replica deaths
        self._quarantined: set[int] = set()
        self._reported: set[int] = set()       # ids already handed to callers
        self._router_overflow: list[Request] = []  # finished outside step()
        self._rr = 0                           # round-robin cursor
        self.registry = MetricsRegistry()
        c = self.registry.counter
        self._c_routed = c("router.routed")
        self._c_affinity = c("router.affinity_hits")
        self._c_affinity_tokens = c("router.affinity_hit_tokens")
        self._c_least_loaded = c("router.least_loaded")
        self._c_round_robin = c("router.round_robin")
        self._c_cancels = c("router.cancels")
        self._c_failovers = c("router.failovers")
        self._c_migrations = c("router.migrations")
        self._c_quarantined = c("router.quarantined")
        self._c_restored = c("router.restored_replicas")
        self._c_drains = c("router.drains")
        self._c_scale_events = c("router.scale_events")

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    # -- health ------------------------------------------------------------

    def health(self, i: int) -> ReplicaHealth:
        return self._health[i]

    def down_cause(self, i: int) -> Optional[str]:
        """Why a DOWN slot went down (None while it is live)."""
        return self._down_cause.get(i)

    @property
    def quarantined(self) -> set[int]:
        """Request ids dropped as poison (finished ABORTED)."""
        return set(self._quarantined)

    def _healthy(self) -> list[int]:
        return [i for i, h in enumerate(self._health)
                if h is ReplicaHealth.HEALTHY]

    def _live(self) -> list[int]:
        return [i for i, h in enumerate(self._health) if h.live]

    # -- routing -----------------------------------------------------------

    def _load(self, i: int) -> int:
        """A replica's unfinished work: queued + resident requests."""
        rep = self.replicas[i]
        return len(rep.waiting) + len(rep.running)

    def route(self, prompt) -> tuple[int, int]:
        """The routing decision for ``prompt`` WITHOUT admitting it:
        ``(replica_index, matched_tokens)`` where ``matched_tokens`` > 0
        only for a real affinity hit.  ``add_request`` is exactly this
        followed by the chosen replica's own ``add_request``; exposing the
        pure half lets tests verify hit accounting independently.  Only
        HEALTHY replicas are candidates — DEGRADED/DRAINING/DOWN replicas
        never receive new work."""
        cand = self._healthy()
        if not cand:
            raise RuntimeError(
                "no healthy replicas to route to "
                f"(health={[h.value for h in self._health]})")
        if self.routing == "round_robin":
            return cand[self._rr % len(cand)], 0
        toks = [int(t) for t in np.asarray(prompt).reshape(-1)]
        scores = {i: self.replicas[i].pool_host.match_prefix(toks).n_tokens
                  for i in cand}
        best = max(scores.values())
        if best > 0:
            idx = min((i for i in cand if scores[i] == best),
                      key=lambda i: (self._load(i), i))
            return idx, best
        return min(cand, key=lambda i: (self._load(i), i)), 0

    def add_request(self, prompt, sampling: Optional[SamplingParams] = None,
                    on_token=None) -> Request:
        idx, matched = self.route(prompt)
        self._c_routed.set(self._c_routed.value + 1)
        if self.routing == "round_robin":
            self._rr += 1
            self._c_round_robin.set(self._c_round_robin.value + 1)
        elif matched > 0:
            self._c_affinity.set(self._c_affinity.value + 1)
            self._c_affinity_tokens.set(
                self._c_affinity_tokens.value + matched)
        else:
            self._c_least_loaded.set(self._c_least_loaded.value + 1)
        req = self.replicas[idx].add_request(prompt, sampling=sampling,
                                             on_token=on_token)
        self._owner[req.req_id] = idx
        self._requests[req.req_id] = req
        return req

    def owner_of(self, req_id: int) -> Optional[int]:
        """Replica index a routed request lives on (None once finished)."""
        return self._owner.get(req_id)

    # -- serving loop ------------------------------------------------------

    def has_work(self) -> bool:
        return bool(self._router_overflow) or any(
            self.replicas[i].has_work() for i in self._live())

    def step(self) -> list[Request]:
        """One router iteration: step every live replica that has work,
        in turn on one stream (each replica's one-step harvest lag hides
        the others' host planning), capture any replica whose step raises
        (it goes DOWN and fails over instead of poisoning the loop), sweep
        health, and return all requests finished this call."""
        finished: list[Request] = []
        if self._router_overflow:
            finished.extend(self._router_overflow)
            self._router_overflow.clear()
        for i in range(len(self.replicas)):
            rep = self.replicas[i]
            h = self._health[i]
            if h is ReplicaHealth.DOWN:
                continue
            if not rep.has_work():
                if h is ReplicaHealth.DRAINING:
                    self._detach(i)          # drained dry: release the slot
                continue
            t0 = time.perf_counter()
            try:
                finished.extend(rep.step())
            except Exception as e:           # noqa: BLE001 — fleet boundary
                self._fail_replica(i, cause=f"{type(e).__name__}: {e}")
                continue
            # a fault-injected straggler inflates its REPORTED step time —
            # real sleeps would slow the test suite for nothing
            self.supervisor.report_step_time(
                self._ranks[i],
                (time.perf_counter() - t0)
                * getattr(rep, "straggle_factor", 1.0))
            if self._health[i] is ReplicaHealth.DRAINING \
                    and not rep.has_work():
                self._detach(i)              # drained dry this very step
        self._health_sweep()
        if self._router_overflow:            # failover during this step
            finished.extend(self._router_overflow)
            self._router_overflow.clear()
        for r in finished:
            self._forget(r.req_id)
        return finished

    def _health_sweep(self) -> None:
        """Post-step health transitions: heartbeat-silent replicas go DOWN
        (step-lag first — deterministic — then the wall-clock timeout),
        straggler-flagged replicas DEGRADED, recovered ones HEALTHY."""
        for i in self._live():
            rep = self.replicas[i]
            lag = rep.step_idx - self.supervisor.heartbeat.last_step(
                self._ranks[i])
            if lag >= self.silence_steps_down:
                self._fail_replica(i, cause="heartbeat_silence")
        rank_to_idx = {self._ranks[i]: i for i in self._live()}
        for rank in self.supervisor.failed_ranks(now=time.perf_counter()):
            i = rank_to_idx.get(rank)
            if i is not None:
                self._fail_replica(i, cause="heartbeat_timeout")
        flagged = set(self.supervisor.straggler_ranks())
        for i in self._live():
            if self._health[i] is ReplicaHealth.HEALTHY \
                    and self._ranks[i] in flagged:
                self._health[i] = ReplicaHealth.DEGRADED
                self.tracer.instant("replica_degraded", replica=i)
            elif self._health[i] is ReplicaHealth.DEGRADED \
                    and self._ranks[i] not in flagged:
                self._health[i] = ReplicaHealth.HEALTHY
                self.tracer.instant("replica_recovered", replica=i)

    def drain(self) -> list[Request]:
        done: list[Request] = list(self._router_overflow)
        self._router_overflow.clear()
        for i in self._live():
            done.extend(self.replicas[i].drain())
        for r in done:
            self._forget(r.req_id)
        return done

    def serve_all(self, max_steps: int = 100_000) -> list[Request]:
        """Step until every queue is empty; returns finish order."""
        out: list[Request] = []
        for _ in range(max_steps):
            if not self.has_work():
                return out
            out.extend(self.step())
        raise RuntimeError(f"replicas did not converge in {max_steps} steps")

    def cancel(self, req_id: int,
               reason: FinishReason = FinishReason.ABORTED) -> bool:
        idx = self._owner.get(req_id)
        if idx is not None:
            ok = self.replicas[idx].cancel(req_id, reason)
            if ok:
                self._forget(req_id)
                self._c_cancels.set(self._c_cancels.value + 1)
            return ok
        # not router-admitted (or already forgotten): try every live
        # replica — a second cancel of a finished id stays a no-op, as on
        # the engine.  DOWN replicas are skipped: a crashed engine's
        # cancel-side drain could re-raise the very fault that killed it.
        for i in self._live():
            if self.replicas[i].cancel(req_id, reason):
                self._c_cancels.set(self._c_cancels.value + 1)
                return True
        return False

    # -- failover ----------------------------------------------------------

    def _forget(self, req_id: int) -> None:
        """A request has been handed to the caller as finished: drop every
        router reference and remember the id (the reconcile after a
        snapshot failover must never re-serve it)."""
        self._owner.pop(req_id, None)
        self._requests.pop(req_id, None)
        self._reported.add(req_id)

    def _fail_replica(self, i: int, cause: str) -> None:
        """Mark replica ``i`` DOWN and fail over: restore from its last
        published snapshot when one exists, else migrate its orphaned
        requests to the survivors (module docstring: failover contract)."""
        rep = self.replicas[i]
        rank = self._ranks[i]
        self._health[i] = ReplicaHealth.DOWN
        self._down_cause[i] = cause
        self._c_failovers.set(self._c_failovers.value + 1)
        self.tracer.instant("replica_down", replica=i, cause=cause)
        snap = self.supervisor.snapshot_for(rank)
        if snap is not None:
            extra = {k: v for k, v in self._engine_kw.items()
                     if k not in GEOMETRY_KEYS}
            new_eng, new_rank = self.supervisor.recover(
                rank, self._cfg, self._params, **extra)
            self.replicas[i] = new_eng
            self._ranks[i] = new_rank
            self._health[i] = ReplicaHealth.HEALTHY
            self._down_cause.pop(i, None)
            self._c_restored.set(self._c_restored.value + 1)
            self.tracer.instant("replica_restored", replica=i, rank=new_rank)
            orphans = self._reconcile_restored(i, new_eng)
        else:
            self.supervisor.detach(rank)
            # the crashed engine's HOST queues are still readable — collect
            # every request it was serving (including direct-adds the
            # router never routed): residents in admission order, then the
            # FIFO queue, then finished-but-unreported overflow
            orphans = [s.request for s in sorted(
                rep.running.values(), key=lambda s: s.admit_order)]
            orphans.extend(rep.waiting)
            orphans.extend(rep._overflow)
        self._migrate_orphans(orphans, from_step=rep.step_idx)
        if self._health[i] is ReplicaHealth.DOWN:
            # defensively forget anything still pointing at the dead slot
            for rid in [r for r, idx in self._owner.items() if idx == i]:
                self._forget(rid)

    def _reconcile_restored(self, i: int, eng) -> list[Request]:
        """Align a just-restored replica with what the router already saw.
        Returns the orphans the snapshot does NOT cover (admitted after the
        publish) for migration."""
        live: dict[int, Request] = {}
        for r in eng.waiting:
            live[r.req_id] = r
        for s in eng.running.values():
            live[s.req_id] = s.request
        for r in eng._overflow:
            live[r.req_id] = r
        # (a) requests the router already reported finished: the snapshot
        # predates the finish — cancel quietly, never re-serve or re-report
        for rid in [r for r in live if r in self._reported]:
            eng.cancel(rid)
            eng._overflow = [r for r in eng._overflow if r.req_id != rid]
            live.pop(rid)
        orphans: list[Request] = []
        for rid, idx in list(self._owner.items()):
            if idx != i:
                continue
            if rid in live:
                # adopt the restored engine's request objects as the
                # router's handles (the snapshot rebuilt new ones)
                self._requests[rid] = live[rid]
            else:
                # admitted after the snapshot was published: not in the
                # restore — treat exactly like a crash orphan
                orphans.append(self._requests[rid])
        return orphans

    def _migrate_orphans(self, orphans: list[Request],
                         from_step: int) -> None:
        for req in orphans:
            rid = req.req_id
            if rid in self._reported:
                continue
            if req.state is RequestState.FINISHED:
                # finished inside the crashed step but the return value was
                # lost with the exception: its tokens are all emitted, so
                # just surface it
                self._report_finished(req)
                continue
            self._retries[rid] = self._retries.get(rid, 0) + 1
            if self._retries[rid] >= self.max_request_retries:
                self._quarantine(req, from_step)
                continue
            target = self._least_loaded_healthy()
            if target is None:
                raise RuntimeError(
                    f"no healthy replicas to migrate request {rid} to")
            if req.sampling.temperature > 0:
                # the device-side PRNG carry died with the replica; replay
                # it from the seed so the continuation (including a token
                # lost in the crashed step's in-flight dispatch) re-draws
                # identically
                req.resume_key = _replay_key(req.sampling.seed,
                                             len(req.output_tokens))
            self.replicas[target].readmit(req)
            self._owner[rid] = target
            self._requests[rid] = req
            self._c_migrations.set(self._c_migrations.value + 1)
            self.tracer.instant("migrate", req_id=rid, to=target)

    def _quarantine(self, req: Request, step: int) -> None:
        """Poison quarantine: a request that has now killed (or ridden
        down) ``max_request_retries`` replicas finishes ABORTED instead of
        taking another one down."""
        self._quarantined.add(req.req_id)
        self._c_quarantined.set(self._c_quarantined.value + 1)
        self.tracer.instant("quarantine", req_id=req.req_id)
        req.finish(FinishReason.ABORTED, step)
        self._report_finished(req)

    def _report_finished(self, req: Request) -> None:
        self._forget(req.req_id)
        self._router_overflow.append(req)

    def _least_loaded_healthy(self) -> Optional[int]:
        cand = self._healthy()
        if not cand:
            return None
        return min(cand, key=lambda i: (self._load(i), i))

    # -- elasticity --------------------------------------------------------

    def drain_replica(self, i: int, migrate: bool = True) -> None:
        """Stop routing to replica ``i`` and empty it.  ``migrate=True``
        (default) moves its residents and queue to the survivors NOW (no
        retry charge — a drain is planned, not a failure) and detaches the
        slot; ``migrate=False`` leaves it DRAINING to finish its own work,
        after which ``step()`` detaches it."""
        if not self._health[i].live:
            raise ValueError(f"replica {i} is DOWN; nothing to drain")
        rep = self.replicas[i]
        self._health[i] = ReplicaHealth.DRAINING
        self._c_drains.set(self._c_drains.value + 1)
        self.tracer.instant("replica_draining", replica=i, migrate=migrate)
        if not migrate:
            return
        # land in-flight device work first (the preemption contract), then
        # evict every resident back to WAITING with its PRNG carry captured
        self._router_overflow.extend(rep.drain())
        for seq in sorted(rep.running.values(), key=lambda s: s.admit_order):
            rep._preempt(seq)
        self._router_overflow.extend(rep._overflow)
        rep._overflow.clear()
        pending = list(rep.waiting)
        rep.waiting.clear()
        for req in pending:
            target = self._least_loaded_healthy()
            if target is None:
                raise RuntimeError(
                    f"no healthy replicas to drain request {req.req_id} to")
            self.replicas[target].readmit(req)
            self._owner[req.req_id] = target
            self._requests[req.req_id] = req
            self._c_migrations.set(self._c_migrations.value + 1)
        self._detach(i)

    def _detach(self, i: int) -> None:
        """Release an emptied replica's slot: rank, straggler history and
        published snapshot are dropped; the slot is DOWN (cause "drained")
        until ``scale_to`` revives it."""
        self._health[i] = ReplicaHealth.DOWN
        self._down_cause[i] = "drained"
        self.supervisor.detach(self._ranks[i])
        self.tracer.instant("replica_detached", replica=i)

    def scale_to(self, n: int) -> ElasticPlan:
        """Elastically resize the fleet to ``n`` live replicas.  Growing
        revives DOWN slots in place with fresh empty engines of the same
        geometry, then appends new slots; shrinking drains the
        highest-indexed live replicas (migrating their work).  Returns the
        same :class:`ElasticPlan` shape the training-side remesh planner
        emits."""
        if n < 1:
            raise ValueError("scale_to needs n >= 1")
        live = self._live()
        old = len(live)
        resume_step = max((self.replicas[i].step_idx for i in live),
                          default=0)
        if n == old:
            return ElasticPlan(old, old, (), (), resume_step, "none")
        self._c_scale_events.set(self._c_scale_events.value + 1)
        if n > old:
            need = n - old
            for i in range(len(self.replicas)):
                if need == 0:
                    break
                if not self._health[i].live:
                    self.replicas[i] = ContinuousBatchingEngine(
                        self._cfg, self._params, **self._engine_kw)
                    self._ranks[i] = self.supervisor.attach(self.replicas[i])
                    self._health[i] = ReplicaHealth.HEALTHY
                    self._down_cause.pop(i, None)
                    need -= 1
            for _ in range(need):
                rep = ContinuousBatchingEngine(
                    self._cfg, self._params, **self._engine_kw)
                self.replicas.append(rep)
                self._ranks.append(self.supervisor.attach(rep))
                self._health.append(ReplicaHealth.HEALTHY)
            self.tracer.instant("scale", old=old, new=n, action="grow")
            return ElasticPlan(old, n, (), (), resume_step, "grow")
        evicted = []
        for i in sorted(self._live(), reverse=True)[:old - n]:
            evicted.append(self._ranks[i])
            self.drain_replica(i, migrate=True)
        self.tracer.instant("scale", old=old, new=n, action="shrink")
        return ElasticPlan(old, n, (), tuple(evicted), resume_step, "shrink")

    def publish_snapshots(self, include_kv: bool = True) -> None:
        """Publish every live replica's snapshot to the supervisor as its
        failover recovery point (each engine drains its own in-flight
        dispatch chain first)."""
        for i in self._live():
            self.supervisor.publish(
                self._ranks[i],
                self.replicas[i].snapshot(include_kv=include_kv))

    # -- observability -----------------------------------------------------

    def sync_metrics(self) -> MetricsRegistry:
        """Fan every replica metric — counters, gauges and histograms —
        into the router registry (``replica<i>.<name>``) next to the
        ``router.*`` counters, and return the registry.  Values are
        copied, not moved — the replica registries stay authoritative."""
        for i, rep in enumerate(self.replicas):
            self.registry.merge(rep.registry, prefix=f"replica{i}.")
        return self.registry

    def stats(self) -> dict:
        """Summed engine counters across replicas, the per-replica
        breakdown, the router's own counters, and fleet health."""
        per = [dict(rep.stats.as_dict()) for rep in self.replicas]
        total: dict = {}
        for d in per:
            for k, v in d.items():
                total[k] = total.get(k, 0) + v
        router = {m.name: m.value for m in self.registry
                  if m.kind == "counter" and m.name.startswith("router.")}
        return {"aggregate": total, "replicas": per, "router": router,
                "health": [h.value for h in self._health],
                "quarantined": sorted(self._quarantined)}

    # -- snapshot / restore ------------------------------------------------

    def snapshot(self, include_kv: bool = True) -> dict:
        """Serialize the FLEET: per-replica engine snapshots for live
        slots (None for DOWN slots — a crashed engine is never snapshot),
        plus the router state needed to reproduce a degraded fleet."""
        live = self._live()
        if not live:
            raise RuntimeError("cannot snapshot a fleet with every "
                               "replica DOWN")
        reps = [self.replicas[i].snapshot(include_kv=include_kv)
                if self._health[i].live else None
                for i in range(len(self.replicas))]
        config = next(r for r in reps if r is not None)["config"]
        return {
            "format": SNAPSHOT_FORMAT_V2,
            "routing": self.routing,
            "rr_cursor": self._rr,
            "owner": dict(self._owner),
            "health": [h.value for h in self._health],
            "down_causes": {str(i): c for i, c in self._down_cause.items()},
            "retries": {str(k): v for k, v in self._retries.items()},
            "quarantined": sorted(self._quarantined),
            "router_counters": {
                m.name: m.value for m in self.registry
                if m.kind == "counter" and m.name.startswith("router.")},
            "config": dict(config),
            "replicas": reps,
        }

    @classmethod
    def restore(cls, snap: dict, cfg, params, **engine_kw
                ) -> "ReplicatedEngine":
        fmt = snap.get("format")
        if fmt not in (SNAPSHOT_FORMAT_V1, SNAPSHOT_FORMAT_V2):
            raise ValueError(f"unknown snapshot format {fmt!r}")
        if fmt == SNAPSHOT_FORMAT_V1:
            # pre-health snapshots: every slot has an engine snapshot and
            # the fleet restores all-HEALTHY
            config = snap["replicas"][0]["config"]
            health = [ReplicaHealth.HEALTHY.value] * len(snap["replicas"])
        else:
            config = snap["config"]
            health = snap["health"]
        extra = {k: v for k, v in engine_kw.items() if k not in GEOMETRY_KEYS}
        reps = []
        for s, h in zip(snap["replicas"], health):
            if s is None or h == ReplicaHealth.DOWN.value:
                # DOWN slot: an empty placeholder of the fleet's geometry —
                # never routed or stepped, revivable by scale_to
                reps.append(ContinuousBatchingEngine(
                    cfg, params, **engine_kwargs_from_config(config),
                    **extra))
            else:
                reps.append(ContinuousBatchingEngine.restore(
                    s, cfg, params, **extra))
        eng = cls(cfg, params, routing=snap["routing"], replicas=reps,
                  **extra)
        # geometry rides along for the fresh engines scale_to builds later
        eng._engine_kw = {**extra, **engine_kwargs_from_config(config)}
        for i, h in enumerate(health):
            eng._health[i] = ReplicaHealth(h)
            if not eng._health[i].live:
                eng.supervisor.detach(eng._ranks[i])
        if fmt == SNAPSHOT_FORMAT_V2:
            eng._down_cause = {int(k): v
                               for k, v in snap["down_causes"].items()}
            eng._retries = {int(k): int(v)
                            for k, v in snap["retries"].items()}
            eng._quarantined = set(snap["quarantined"])
            eng._reported = set(snap["quarantined"])
            for name, v in snap["router_counters"].items():
                eng.registry.counter(name).set(v)
        eng._rr = snap["rr_cursor"]
        eng._owner = {int(k): int(v) for k, v in snap["owner"].items()}
        # re-point the router's request handles at the rebuilt objects
        for i in eng._live():
            rep = eng.replicas[i]
            for req in list(rep.waiting) + [s.request for s in
                                            rep.running.values()] \
                    + list(rep._overflow):
                if eng._owner.get(req.req_id) == i:
                    eng._requests[req.req_id] = req
        return eng


__all__ = ["ReplicatedEngine", "ReplicaHealth", "ROUTING_POLICIES"]
