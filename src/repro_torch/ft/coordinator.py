"""Cluster control plane of the port (``repro.ft.coordinator``'s, host
code only): heartbeats, failure detection, elastic remesh plans, straggler
mitigation, and the serving engines' supervisors.

On a real deployment each host runs the worker side (report_heartbeat per
step) and rank 0 runs the coordinator; here the logic is in-process and unit
tested, and the serving engines report to it every step.  Recovery
contract:

  failure detected -> pick the largest feasible mesh from the survivors ->
  restore the latest checkpoint resharded onto the new mesh (checkpoints are
  mesh-agnostic, repro_torch.checkpoint) -> rescale the data pipeline's host
  sharding -> continue.

Straggler mitigation follows the backup-worker pattern: ranks whose rolling
step time exceeds ``threshold x`` the fleet median are flagged; the plan
swaps them for hot spares when available, else shrinks the mesh like a
failure (better 1/16 fewer chips than a 2x slower global step).
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Optional


class HeartbeatRegistry:
    def __init__(self, timeout_s: float = 60.0):
        self.timeout_s = timeout_s
        self._last: dict[int, float] = {}
        self._step: dict[int, int] = {}
        self._claimed: set[int] = set()

    def claim(self, rank: Optional[int] = None) -> int:
        """Reserve a rank in this registry.  ``rank=None`` hands out the
        lowest free rank; an explicit rank that is already claimed raises —
        two supervisors silently sharing one rank would shadow each other's
        liveness stamps, turning a dead worker invisible."""
        if rank is None:
            rank = 0
            while rank in self._claimed:
                rank += 1
        elif rank in self._claimed:
            raise ValueError(
                f"rank {rank} already claimed in this registry; pass "
                f"rank=None to auto-assign a free one")
        self._claimed.add(rank)
        return rank

    def release(self, rank: int) -> None:
        """Drop a claimed rank's liveness state (detach)."""
        self._claimed.discard(rank)
        self._last.pop(rank, None)
        self._step.pop(rank, None)

    def report(self, rank: int, step: int, now: Optional[float] = None):
        self._last[rank] = time.monotonic() if now is None else now
        self._step[rank] = step

    def failed_ranks(self, now: Optional[float] = None) -> list[int]:
        now = time.monotonic() if now is None else now
        return sorted(
            r for r, t in self._last.items() if now - t > self.timeout_s
        )

    def last_step(self, rank: int) -> int:
        """The newest step this rank reported (0 if it never reported)."""
        return self._step.get(rank, 0)

    def fleet_step(self) -> int:
        return min(self._step.values()) if self._step else 0


class StragglerMonitor:
    """Rolling per-rank step times; flags ranks slower than
    ``threshold x`` the fleet median."""

    def __init__(self, window: int = 16, threshold: float = 1.5):
        self.window = window
        self.threshold = threshold
        self._times: dict[int, deque] = defaultdict(
            lambda: deque(maxlen=window))

    def report(self, rank: int, step_time_s: float):
        self._times[rank].append(step_time_s)

    def _avg(self, rank: int) -> float:
        t = self._times[rank]
        return sum(t) / len(t) if t else 0.0

    def stragglers(self) -> list[int]:
        if len(self._times) < 2:
            return []
        avgs = sorted(self._avg(r) for r in self._times)
        median = avgs[len(avgs) // 2]
        if median <= 0:
            return []
        return sorted(
            r for r in self._times if self._avg(r) > self.threshold * median
        )


class EngineSupervisor:
    """Liveness watchdog + snapshot custodian for a serving engine.

    Bridges the training-side control plane to serving fault tolerance
    (``serving/snapshot.py``): ``attach`` wires an engine's per-step
    heartbeat into a ``HeartbeatRegistry``, ``publish`` keeps the latest
    engine snapshot, and when the engine goes quiet past the timeout
    (``engine_failed``), ``recover`` rebuilds a replacement engine from
    that snapshot — token-identical for every surviving request, per the
    recovery contract in ``serving/snapshot.py``.
    """

    def __init__(self, timeout_s: float = 60.0, rank: Optional[int] = None,
                 heartbeat: Optional[HeartbeatRegistry] = None):
        self.heartbeat = heartbeat or HeartbeatRegistry(timeout_s=timeout_s)
        # claim the rank in the (possibly shared) registry: supervisors
        # sharing one registry get distinct ranks automatically, and an
        # explicit collision raises instead of silently shadowing stamps
        self.rank = self.heartbeat.claim(rank)
        self.last_snapshot: Optional[dict] = None

    def attach(self, engine) -> None:
        """Point the engine's heartbeat at this supervisor; every
        ``engine.step()`` then refreshes the liveness stamp."""
        engine.heartbeat = self.heartbeat
        engine.heartbeat_rank = self.rank
        engine.heartbeat.report(self.rank, engine.step_idx)

    def publish(self, snapshot: dict) -> None:
        """Record the engine's newest snapshot as the recovery point."""
        self.last_snapshot = snapshot

    def engine_failed(self, now: Optional[float] = None) -> bool:
        """True once the attached engine has missed the heartbeat timeout."""
        return self.rank in self.heartbeat.failed_ranks(now)

    def recover(self, cfg, params, **engine_kw):
        """Rebuild the engine from the last published snapshot (raises if
        none was ever published) and re-attach its heartbeat."""
        if self.last_snapshot is None:
            raise RuntimeError(
                "no snapshot published; nothing to recover from")
        from repro_torch.serving.snapshot import restore_engine

        engine = restore_engine(self.last_snapshot, cfg, params, **engine_kw)
        self.attach(engine)
        return engine


class FleetSupervisor:
    """Per-replica liveness, straggler detection and snapshot custody for a
    replica fleet (``serving/replicas.py``).

    Generalizes :class:`EngineSupervisor` across R engines: ONE shared
    :class:`HeartbeatRegistry` hands each attached engine a distinct rank
    (``attach`` auto-claims; explicit collisions raise), ONE
    :class:`StragglerMonitor` compares per-replica step times against the
    fleet median, and ``publish``/``snapshot_for`` keep one recovery point
    per rank.  The router drives it: it reports step times, sweeps
    ``failed_ranks``/``straggler_ranks`` into replica health transitions,
    and calls ``recover`` (snapshot failover) or migrates requests itself
    when no snapshot was ever published.
    """

    def __init__(self, timeout_s: float = 60.0, straggler_window: int = 8,
                 straggler_threshold: float = 3.0):
        self.heartbeat = HeartbeatRegistry(timeout_s=timeout_s)
        self.stragglers = StragglerMonitor(window=straggler_window,
                                           threshold=straggler_threshold)
        self._snapshots: dict[int, dict] = {}

    def attach(self, engine, rank: Optional[int] = None) -> int:
        """Claim a (distinct) rank for the engine and wire its per-step
        heartbeat into the shared registry; returns the rank."""
        rank = self.heartbeat.claim(rank)
        engine.heartbeat = self.heartbeat
        engine.heartbeat_rank = rank
        engine.heartbeat.report(rank, engine.step_idx)
        return rank

    def detach(self, rank: int) -> None:
        """Forget a rank entirely: liveness stamps, straggler history, and
        its published snapshot."""
        self.heartbeat.release(rank)
        self.stragglers._times.pop(rank, None)
        self._snapshots.pop(rank, None)

    def publish(self, rank: int, snapshot: dict) -> None:
        """Record a rank's newest snapshot as its recovery point."""
        self._snapshots[rank] = snapshot

    def snapshot_for(self, rank: int) -> Optional[dict]:
        return self._snapshots.get(rank)

    def failed_ranks(self, now: Optional[float] = None) -> list[int]:
        return self.heartbeat.failed_ranks(now)

    def report_step_time(self, rank: int, step_time_s: float) -> None:
        self.stragglers.report(rank, step_time_s)

    def straggler_ranks(self) -> list[int]:
        return self.stragglers.stragglers()

    def recover(self, rank: int, cfg, params, **engine_kw):
        """Rebuild a failed rank's engine from its last published snapshot
        (raises if none exists) and re-attach it under a FRESH rank — the
        dead rank's stamps are purged, never reused.  Returns
        ``(engine, new_rank)``; the recovery point carries over."""
        snap = self._snapshots.get(rank)
        if snap is None:
            raise RuntimeError(
                f"no snapshot published for rank {rank}; nothing to "
                f"recover from")
        from repro_torch.serving.snapshot import restore_engine

        engine = restore_engine(snap, cfg, params, **engine_kw)
        self.detach(rank)
        new_rank = self.attach(engine)
        self._snapshots[new_rank] = snap
        return engine, new_rank


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """What the runtime does after failures/stragglers are confirmed."""

    old_data_parallel: int
    new_data_parallel: int
    replaced_by_spares: tuple[int, ...]
    evicted_ranks: tuple[int, ...]
    resume_step: int
    action: str  # "none" | "swap_spares" | "shrink" | "halt"

    @property
    def mesh_changed(self) -> bool:
        return self.new_data_parallel != self.old_data_parallel


def plan_elastic_remesh(
    data_parallel: int,
    model_parallel: int,
    bad_ranks: list[int],
    n_spares: int = 0,
    resume_step: int = 0,
    min_data_parallel: int = 1,
) -> ElasticPlan:
    """Choose the recovery action for ``bad_ranks`` failed/straggling hosts.

    Spares substitute 1:1 first.  Remaining losses shrink the data axis to
    the largest size that (a) the surviving host count supports and (b)
    keeps the global batch divisible (power-of-two style divisor ladder) —
    model_parallel is never shrunk (TP is latency-critical and weights are
    already sharded that way)."""
    if not bad_ranks:
        return ElasticPlan(data_parallel, data_parallel, (), (),
                           resume_step, "none")
    spared = tuple(bad_ranks[:n_spares])
    evicted = tuple(bad_ranks[n_spares:])
    if not evicted:
        return ElasticPlan(data_parallel, data_parallel, spared, (),
                           resume_step, "swap_spares")
    survivors = data_parallel - len(evicted)
    new_dp = survivors
    while new_dp >= min_data_parallel and data_parallel % new_dp != 0:
        new_dp -= 1
    if new_dp < min_data_parallel:
        return ElasticPlan(data_parallel, 0, spared, evicted, resume_step,
                           "halt")
    return ElasticPlan(data_parallel, new_dp, spared, evicted, resume_step,
                       "shrink")


__all__ = [
    "HeartbeatRegistry",
    "EngineSupervisor",
    "FleetSupervisor",
    "StragglerMonitor",
    "ElasticPlan",
    "plan_elastic_remesh",
]
