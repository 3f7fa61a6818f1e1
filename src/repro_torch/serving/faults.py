"""Fault-injection harness for the serving engine (port of
``repro.serving.faults``: the same schedule, the same seeded draws, the
same log, so both packages' injectors fire the same faults at the same
steps).

``FaultInjector`` is a seeded, schedulable chaos source the engine calls
into at fixed hook points (``ContinuousBatchingEngine(fault_injector=...)``)
— never the other way around, so production engines with no injector pay a
single ``is not None`` check per hook.  Faults are scheduled by engine step
index, which makes every chaos run reproducible: same seed + same schedule
=> same failure at the same point in the token stream.

Fault kinds:

  * ``pool_exhaustion`` — steal up to ``frac`` of the allocatable pages
    into fault-owned reservations (negative seq ids, invisible to the
    engine) for ``hold_steps`` steps.  The scheduler sees the shrunken
    pool and must degrade/preempt; when the hold releases, progress
    resumes and — per the preemption contract (recompute on resume) —
    greedy outputs are token-identical to an unfaulted run.
  * ``dispatch_failure`` — raise ``DispatchFailure`` at the top of the
    engine's dispatch (before any host bookkeeping).  The engine recovers
    by draining in-flight work and preempting all residents
    (recompute-on-resume), counted in ``stats["dispatch_failures"]``.
  * ``crash_before_harvest`` / ``crash_after_harvest`` — raise
    ``SimulatedCrash`` out of ``step()`` at the two sides of the harvest
    loop, modeling a process death with (resp. without) un-harvested
    device work in flight.  Recovery is a snapshot restore
    (``serving/snapshot.py``).
  * ``clock_skew`` — jump the engine's ``_clock`` forward by ``skew_s``
    seconds.  Deadline sweeps and queue-wait shedding fire early; wall
    time measured by the calibration does not (it reads raw
    ``perf_counter``).  Under a mesh ``_clock`` reads rank 0's broadcast
    reading of the step, and every rank's injector (each rank receives
    the same calls) skews that value alike, so the ranks' sweeps agree.
  * ``heartbeat_silence`` — drop the engine's heartbeat reporting (models
    a worker that keeps burning CPU but stops talking to the control
    plane).  The engine itself keeps stepping; detection is the FLEET's
    job — ``ReplicatedEngine`` marks a replica DOWN once its reported
    heartbeat step lags its own ``step_idx`` past the router's
    ``silence_steps_down`` budget (deterministic, no wall clock) or once
    the registry's wall-clock timeout expires.
  * ``straggle`` — multiply the step times this engine's replica reports
    to the fleet ``StragglerMonitor`` by ``factor`` (optionally for
    ``hold_steps`` steps).  A flagged replica is DEGRADED: it keeps
    serving its residents but ``route()`` sends it no new work until its
    rolling window recovers.

``assert_recovery_invariants`` is the post-fault oracle the chaos tests
and the ``serve_throughput.py`` robustness sweep share: pool refcounts
equal table holders, no page is held by a sequence the engine no longer
tracks (leak check), and the slot accounting is exact.
``assert_fleet_invariants`` lifts it to a replica fleet: every non-DOWN
replica passes the single-engine oracle, and the router's ``_owner``
table references only live, unreported requests on live replicas.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.serving.kv_pool import PoolOOM

FAULT_KINDS = ("pool_exhaustion", "dispatch_failure", "crash_before_harvest",
               "crash_after_harvest", "clock_skew", "heartbeat_silence",
               "straggle")


class InjectedFault(RuntimeError):
    """Base class for every injected failure."""

    def __init__(self, kind: str, msg: str = ""):
        self.kind = kind
        super().__init__(msg or kind)


class DispatchFailure(InjectedFault):
    """The mixed-step dispatch 'failed' before enqueueing device work.
    The engine catches this and recovers by preempting all residents."""

    def __init__(self, msg: str = ""):
        super().__init__("dispatch_failure", msg)


class SimulatedCrash(InjectedFault):
    """A simulated process death: propagates out of ``engine.step()``.
    Recovery is a snapshot restore, never a catch-and-continue."""


@dataclasses.dataclass
class _Event:
    step: int
    kind: str
    kw: dict
    fired: bool = False


class FaultInjector:
    """Seeded, schedulable fault source (see module docstring).

    ``schedule(step, kind, **kw)`` arms one fault; ``random_schedule``
    draws a reproducible set from the seeded generator.  The engine calls
    ``on_step`` / ``on_dispatch`` / ``on_harvest``; ``log`` records every
    fault that actually fired as ``(step, kind, detail)`` so tests can
    assert the chaos they asked for really happened.
    """

    # fault-owned pool reservations use negative seq ids so they can never
    # collide with (non-negative) request ids
    FAULT_SEQ_BASE = -1000

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.events: list[_Event] = []
        self.log: list[tuple[int, str, object]] = []
        self._held: list[tuple[int, int]] = []   # (release_step, fault_seq)
        self._straggles: list[int] = []          # straggle release steps
        self._n_fault_seqs = 0

    def schedule(self, step: int, kind: str, **kw) -> "FaultInjector":
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; "
                             f"choose from {FAULT_KINDS}")
        self.events.append(_Event(step=step, kind=kind, kw=kw))
        return self

    def random_schedule(self, n_faults: int, max_step: int,
                        kinds: Optional[tuple] = None) -> "FaultInjector":
        """Arm ``n_faults`` reproducibly-random faults in steps
        [2, max_step].  Crash kinds are excluded unless asked for — they
        need a snapshot-restore harness around the run loop."""
        if kinds is None:
            kinds = tuple(k for k in FAULT_KINDS if not k.startswith("crash"))
        for _ in range(n_faults):
            step = int(self.rng.integers(2, max(max_step, 3)))
            self.schedule(step, str(self.rng.choice(kinds)))
        return self

    @property
    def fired(self) -> list[tuple[int, str, object]]:
        return list(self.log)

    # -- engine hooks ------------------------------------------------------

    def on_step(self, engine) -> None:
        """Start-of-step hook: releases expired pool holds, then fires any
        ``pool_exhaustion`` / ``clock_skew`` armed for this step."""
        step = engine.step_idx
        for rel, sid in list(self._held):
            if step >= rel:
                engine.pool_host.free(sid)
                self._held.remove((rel, sid))
                self.log.append((step, "pool_release", sid))
        for rel in list(self._straggles):
            if step >= rel:
                engine.straggle_factor = 1.0
                self._straggles.remove(rel)
                self.log.append((step, "straggle_release", None))
        for ev in self.events:
            if ev.fired or ev.step != step:
                continue
            if ev.kind == "pool_exhaustion":
                ev.fired = True
                self._exhaust(engine, ev)
            elif ev.kind == "clock_skew":
                ev.fired = True
                skew = float(ev.kw.get("skew_s", 3600.0))
                base = engine._clock
                engine._clock = lambda b=base, s=skew: b() + s
                self.log.append((step, "clock_skew", skew))
            elif ev.kind == "heartbeat_silence":
                ev.fired = True
                engine.heartbeat = None
                self.log.append((step, "heartbeat_silence", None))
            elif ev.kind == "straggle":
                ev.fired = True
                factor = float(ev.kw.get("factor", 8.0))
                engine.straggle_factor = factor
                hold = ev.kw.get("hold_steps")
                if hold is not None:
                    self._straggles.append(step + int(hold))
                self.log.append((step, "straggle", factor))

    def on_dispatch(self, engine) -> None:
        """Called at the top of the engine's dispatch, before any host
        bookkeeping — a raised fault leaves pool/cursor state untouched."""
        for ev in self.events:
            if (not ev.fired and ev.step == engine.step_idx
                    and ev.kind == "dispatch_failure"):
                ev.fired = True
                self.log.append((engine.step_idx, "dispatch_failure", None))
                raise DispatchFailure(
                    f"injected dispatch failure at step {engine.step_idx}")

    def on_harvest(self, engine, when: str) -> None:
        """``when`` is "before" or "after" the harvest loop."""
        kind = f"crash_{when}_harvest"
        for ev in self.events:
            if (not ev.fired and ev.step == engine.step_idx
                    and ev.kind == kind):
                ev.fired = True
                self.log.append((engine.step_idx, kind, None))
                raise SimulatedCrash(
                    kind, f"injected crash {when} harvest at step "
                          f"{engine.step_idx}")

    # -- pool pressure -----------------------------------------------------

    def _exhaust(self, engine, ev: _Event) -> None:
        pool = engine.pool_host
        frac = float(ev.kw.get("frac", 1.0))
        hold = int(ev.kw.get("hold_steps", 4))
        take = min(int(frac * pool.free_pages), pool.free_pages)
        cap = pool.max_pages_per_seq or max(take, 1)
        stolen = 0
        while take > 0:
            n = min(take, cap)
            self._n_fault_seqs += 1
            sid = self.FAULT_SEQ_BASE - self._n_fault_seqs
            try:
                pool.allocate(sid, n * pool.page_size)
            except PoolOOM:
                break
            self._held.append((engine.step_idx + hold, sid))
            stolen += n
            take -= n
        self.log.append((engine.step_idx, "pool_exhaustion", stolen))

    def release_all(self, engine) -> None:
        """Hand every fault-held page back (test teardown helper)."""
        for _, sid in self._held:
            engine.pool_host.free(sid)
        self._held.clear()

    @property
    def holds_pages(self) -> bool:
        return bool(self._held)


def assert_recovery_invariants(engine) -> None:
    """Post-fault oracle: raises AssertionError unless the engine + pool
    state is exactly consistent.

      * pool ``check_invariants`` (refcount == table holders, free+live ==
        n_pages-1, trie reachability);
      * every pool reservation belongs to a resident sequence (or a
        fault-injector hold, which uses negative seq ids) — anything else
        is a leaked page table;
      * resident sequences' page_ids mirror the pool's tables, and slot
        accounting is exact (free slots + running == max_slots);
      * on a tensor-parallel engine, every device pool leaf still sits at
        the ``DeviceKV`` contract's placement with the expected per-shard
        KV-head slice (``DeviceKV.check_shards``).
    """
    pool = engine.pool_host
    pool.check_invariants()
    kv = getattr(engine, "kv", None)
    if kv is not None:
        kv.check_shards()
    running = {s.req_id: s for s in engine.running.values()}
    for slot, seq in engine.running.items():
        assert seq.slot == slot, (slot, seq.slot)
        assert list(seq.page_ids) == pool.page_table(seq.req_id), \
            f"seq {seq.req_id} page_ids drifted from the pool table"
    for sid in list(pool._tables):
        assert sid < 0 or sid in running, \
            f"leaked pages: seq {sid} holds pages but is not resident"
    assert sorted(engine._free_slots + list(engine.running)) == \
        list(range(engine.max_slots)), "slot accounting drifted"


def assert_fleet_invariants(router) -> None:
    """Post-fault oracle for a ``ReplicatedEngine``: every non-DOWN
    replica passes ``assert_recovery_invariants`` (so zero leaked pages on
    every survivor), and the router's ``_owner`` table points only at
    live, unreported requests hosted on live replicas — never at a DOWN
    replica, a finished-and-reported request, a migrated-away copy, or a
    quarantined id."""
    from repro_torch.serving.replicas import ReplicaHealth

    live_ids: dict[int, set[int]] = {}
    for i, rep in enumerate(router.replicas):
        if router.health(i) is ReplicaHealth.DOWN:
            continue
        assert_recovery_invariants(rep)
        live_ids[i] = ({r.req_id for r in rep.waiting}
                       | {s.req_id for s in rep.running.values()}
                       | {r.req_id for r in rep._overflow})
    pending = {r.req_id for r in router._router_overflow}
    for rid, idx in router._owner.items():
        assert idx in live_ids, \
            f"owner table points request {rid} at DOWN replica {idx}"
        assert rid in live_ids[idx] or rid in pending, \
            f"owner table references request {rid} absent from replica {idx}"
    leaked = set(router._owner) & router.quarantined
    assert not leaked, f"quarantined requests still owned: {sorted(leaked)}"


__all__ = ["FaultInjector", "InjectedFault", "DispatchFailure",
           "SimulatedCrash", "FAULT_KINDS", "assert_recovery_invariants",
           "assert_fleet_invariants"]
