"""The port's replicated engine (``serving.replicas``) and its fleet fault
tolerance (``ft.coordinator.FleetSupervisor``) against the JAX reference,
on the CPU.

Counterparts of ``tests/test_replicas.py`` (routing, affinity, round
robin, property-tested router interleavings and owner-table chaos,
deadlines and cancels through the router, fleet snapshot/restore, metrics
fan-in) and of ``tests/test_replica_ft.py`` (health transitions, crash
failover by migration and by snapshot restore, poison quarantine,
heartbeat-silence and straggler detection, elastic drain and scale,
degraded-fleet snapshots, supervisor rank claims).  Greedy and sampled
fleet outputs are held to the reference's runs on the same seeded params:
a single reference engine for agreement across replica counts, the
reference's unfaulted fleet for the failover runs.  ``_replay_key``, the
host-side PRNG carry a migration rebuilds, is bitwise ``jax.random``'s
after 0 to 64 splits."""

import jax
import numpy as np
import pytest

from _hypothesis_compat import given, settings, st  # optional dep

import repro.serving as js
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.ft.coordinator import (EngineSupervisor, FleetSupervisor,
                                        HeartbeatRegistry,
                                        plan_elastic_remesh)
from repro_torch.models.config import ModelConfig
from repro_torch.serving import (FaultInjector, ReplicaHealth,
                                 ReplicatedEngine, SamplingParams,
                                 assert_fleet_invariants)
from repro_torch.serving.replicas import _replay_key
from repro_torch.serving.request import FinishReason

FIELDS = dict(name="rep", d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
              d_ff=128, vocab=256, dtype="float32")
CFG = ModelConfig(**FIELDS)
JCFG = JModelConfig(**FIELDS)

GEOM = dict(max_slots=4, page_size=4, n_pages=64, max_len=64)
KW = dict(GEOM, device="cpu")


@pytest.fixture(scope="module")
def both():
    """(reference params, the port's copy of them on the CPU)."""
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


@pytest.fixture(scope="module")
def params(both):
    return both[1]


def _prompts(n, lo=6, hi=12, seed=0, families=0):
    """``n`` random prompts; with ``families`` > 0 each starts with one of
    that many shared 8-token stems."""
    rng = np.random.RandomState(seed)
    stems = [list(map(int, rng.randint(1, CFG.vocab - 1, 8)))
             for _ in range(max(families, 1))]
    out = []
    for i in range(n):
        tail = list(map(int, rng.randint(1, CFG.vocab - 1,
                                         rng.randint(lo, hi))))
        out.append((stems[i % families] + tail) if families else tail)
    return out


def _collect(eng, ids, max_steps=3000):
    outs = {}
    steps = 0
    while len(outs) < len(ids):
        for r in eng.step():
            outs[r.req_id] = (list(r.output_tokens), r.finish_reason)
        steps += 1
        assert steps < max_steps, "replicated engine did not converge"
    return outs


def _run_fleet(eng, prompts, sampling, max_steps=3000):
    """Admit all prompts, serve to completion; outputs keyed by addition
    index."""
    reqs = [eng.add_request(p, sampling=sampling(i) if callable(sampling)
                            else sampling) for i, p in enumerate(prompts)]
    for _ in range(max_steps):
        if not eng.has_work():
            break
        eng.step()
    assert not eng.has_work(), "fleet did not converge"
    return {i: (list(r.output_tokens), r.finish_reason.value)
            for i, r in enumerate(reqs)}


def _reference_fleet(both, prompts, sampling, n_replicas, **kw):
    """The reference fleet's outputs (finish reasons as strings)."""
    eng = js.ReplicatedEngine(JCFG, both[0], n_replicas=n_replicas,
                              **GEOM, **kw)
    return _run_fleet(eng, prompts, sampling)


def _port(out):
    return {i: (t, fr if isinstance(fr, str) else fr.value)
            for i, (t, fr) in out.items()}


def _arm_crash(rep, in_steps=1):
    inj = FaultInjector(seed=0)
    inj.schedule(rep.step_idx + in_steps, "crash_before_harvest")
    rep.faults = inj
    return inj


def _serve_out(eng, reqs):
    for _ in range(3000):
        if not eng.has_work():
            break
        eng.step()
    return {i: (list(r.output_tokens), r.finish_reason.value)
            for i, r in enumerate(reqs)}


# ---------------------------------------------------------------------------
# the host-side PRNG carry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 100, 2 ** 31 + 5])
def test_replay_key_is_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    for n in range(65):
        got = _replay_key(seed, n)
        assert got.dtype == np.uint32
        assert np.array_equal(got, np.asarray(key, np.uint32)), n
        key = jax.random.split(key, 2)[1]


# ---------------------------------------------------------------------------
# greedy agreement across replica counts (test_replicas.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_replicas", [2, 4])
def test_replicas_greedy_agreement(both, n_replicas):
    """Routing never changes what is generated: the port's fleet of R
    replicas serves a single reference engine's greedy tokens."""
    prompts = _prompts(8, seed=1, families=3)
    sp = SamplingParams(max_new_tokens=8, temperature=0.0)
    base = _reference_fleet(both, prompts, js.SamplingParams(
        max_new_tokens=8, temperature=0.0), 1)
    eng = ReplicatedEngine(CFG, both[1], n_replicas=n_replicas, **KW)
    ids = [eng.add_request(p, sampling=sp).req_id for p in prompts]
    outs = _collect(eng, ids)
    assert [outs[i][0] for i in ids] == [base[i][0] for i in range(8)]
    per = eng.stats()["replicas"]
    assert sum(d["finished"] for d in per) == len(prompts)


def test_replicas_affinity_routes_families_together(params):
    sp = SamplingParams(max_new_tokens=4, temperature=0.0)
    prompts = _prompts(12, seed=2, families=3)

    def run(routing):
        eng = ReplicatedEngine(CFG, params, n_replicas=2, routing=routing,
                               **KW)
        done = set()
        for p in prompts:
            eng.add_request(p, sampling=sp)
            for _ in range(2):
                done.update(r.req_id for r in eng.step())
        done.update(r.req_id for r in eng.serve_all())
        assert len(done) == len(prompts)
        hit = sum(rep.pool_host.stats().prefix_hit_tokens
                  for rep in eng.replicas)
        return eng, hit

    aff, aff_hits = run("affinity")
    rr, rr_hits = run("round_robin")
    router = aff.stats()["router"]
    assert router["router.affinity_hits"] > 0
    assert router["router.affinity_hit_tokens"] > 0
    assert aff_hits > rr_hits
    assert rr.stats()["router"]["router.round_robin"] == len(prompts)


def test_replicas_round_robin_counters(params):
    sp = SamplingParams(max_new_tokens=2, temperature=0.0)
    eng = ReplicatedEngine(CFG, params, n_replicas=3, routing="round_robin",
                           **KW)
    ids = [eng.add_request(p, sampling=sp).req_id
           for p in _prompts(6, seed=3)]
    assert [eng.owner_of(i) for i in ids] == [0, 1, 2, 0, 1, 2]
    _collect(eng, ids)
    r = eng.stats()["router"]
    assert r["router.routed"] == 6
    assert r["router.round_robin"] == 6
    assert r["router.affinity_hits"] == 0


# ---------------------------------------------------------------------------
# router interleavings (property)
# ---------------------------------------------------------------------------


def _interleave(eng, prompts, draw_steps, draw_cancel, draw_victim):
    sp = SamplingParams(max_new_tokens=3, temperature=0.0)
    live, done, cancelled = [], {}, set()
    real_matches = 0
    for p in prompts:
        _, matched = eng.route(p)
        real_matches += 1 if matched > 0 else 0
        live.append(eng.add_request(p, sampling=sp).req_id)
        for _ in range(draw_steps()):
            for r in eng.step():
                done[r.req_id] = r.finish_reason
        if live and draw_cancel():
            victim = live[draw_victim(len(live))]
            if victim not in done and eng.cancel(victim):
                cancelled.add(victim)
    for r in eng.serve_all():
        done[r.req_id] = r.finish_reason
    assert set(live) <= (set(done) | cancelled), "a request starved"
    assert not eng.has_work()
    router = eng.stats()["router"]
    assert router["router.affinity_hits"] <= real_matches
    assert router["router.routed"] == len(prompts)
    for rid in cancelled:
        assert done.get(rid) in (None, FinishReason.ABORTED)


@settings(deadline=None, max_examples=10)
@given(st.data())
def test_router_interleavings_no_starvation(params, data):
    eng = ReplicatedEngine(CFG, params, n_replicas=2, **KW)
    _interleave(eng, _prompts(6, seed=7, families=2),
                lambda: data.draw(st.integers(0, 3), label="steps"),
                lambda: data.draw(st.booleans(), label="cancel"),
                lambda n: data.draw(st.integers(0, n - 1), label="victim"))


def test_router_interleavings_seeded(params):
    rng = np.random.RandomState(11)
    for trial in range(4):
        eng = ReplicatedEngine(CFG, params, n_replicas=2, **KW)
        _interleave(eng, _prompts(6, seed=20 + trial, families=2),
                    lambda: rng.randint(0, 4), lambda: rng.rand() < 0.4,
                    lambda n: rng.randint(n))


OPS = ["step", "cancel", "fail", "publish", "restore", "none"]


def _chaos(eng, params, prompts, pick_op, pick_int):
    sp = SamplingParams(max_new_tokens=3, temperature=0.0)
    for p in prompts:
        eng.add_request(p, sampling=sp)
        op = pick_op()
        if op == "step":
            for _ in range(pick_int(1, 3)):
                eng.step()
        elif op == "cancel":
            owned = sorted(eng._owner)
            if owned:
                eng.cancel(owned[pick_int(0, len(owned) - 1)])
        elif op == "publish":
            eng.publish_snapshots()
        elif op == "fail":
            healthy = eng._healthy()
            if len(healthy) > 1:
                eng._fail_replica(healthy[pick_int(0, len(healthy) - 1)],
                                  cause="injected")
        elif op == "restore":
            eng = ReplicatedEngine.restore(eng.snapshot(), CFG, params,
                                           device="cpu")
        assert_fleet_invariants(eng)
    eng.serve_all()
    assert_fleet_invariants(eng)
    assert not eng._owner, "owner table must empty once all work is done"
    assert not eng.has_work()


@settings(deadline=None, max_examples=8)
@given(st.data())
def test_owner_table_integrity_under_chaos(params, data):
    eng = ReplicatedEngine(CFG, params, n_replicas=3, **KW)
    _chaos(eng, params, _prompts(8, seed=13, families=2),
           lambda: data.draw(st.sampled_from(OPS), label="op"),
           lambda lo, hi: data.draw(st.integers(lo, hi), label="n"))


def test_owner_table_integrity_seeded(params):
    rng = np.random.RandomState(17)
    for trial in range(3):
        eng = ReplicatedEngine(CFG, params, n_replicas=3, **KW)
        _chaos(eng, params, _prompts(8, seed=70 + trial, families=2),
               lambda: OPS[rng.randint(6)],
               lambda lo, hi: rng.randint(lo, hi + 1))


def test_router_deadline_sweeps_on_owner(params):
    eng = ReplicatedEngine(CFG, params, n_replicas=2, **KW)
    doomed = eng.add_request(_prompts(1, seed=30)[0], sampling=SamplingParams(
        max_new_tokens=4, temperature=0.0, deadline_s=0.0))
    alive = eng.add_request(_prompts(1, seed=31)[0], sampling=SamplingParams(
        max_new_tokens=4, temperature=0.0))
    outs = _collect(eng, [doomed.req_id, alive.req_id])
    assert outs[doomed.req_id][1] == FinishReason.TIMEOUT
    assert outs[alive.req_id][1] == FinishReason.LENGTH
    assert eng.stats()["aggregate"]["timeouts"] == 1


def test_router_cancel_unknown_and_finished(params):
    eng = ReplicatedEngine(CFG, params, n_replicas=2, **KW)
    req = eng.add_request(_prompts(1, seed=40)[0], sampling=SamplingParams(
        max_new_tokens=2, temperature=0.0))
    assert eng.owner_of(req.req_id) is not None
    _collect(eng, [req.req_id])
    assert eng.owner_of(req.req_id) is None
    assert not eng.cancel(req.req_id)
    assert not eng.cancel(10_000_000)


# ---------------------------------------------------------------------------
# snapshot / restore / metrics fan-in
# ---------------------------------------------------------------------------


def test_replicas_snapshot_restore_midflight(both):
    """A fleet snapshot mid-flight (v2) restores to the reference fleet's
    tokens, owner table intact."""
    prompts = _prompts(4, seed=50, families=2)
    want = _reference_fleet(both, prompts, js.SamplingParams(
        max_new_tokens=6, temperature=0.0), 2)
    eng = ReplicatedEngine(CFG, both[1], n_replicas=2, **KW)
    ids = [eng.add_request(p, sampling=SamplingParams(
        max_new_tokens=6, temperature=0.0)).req_id for p in prompts]
    done = {}
    for _ in range(3):
        for r in eng.step():
            done[r.req_id] = (list(r.output_tokens), r.finish_reason)
    snap = eng.snapshot()
    assert snap["format"] == "replicated-engine-snapshot-v2"
    assert snap["health"] == ["healthy", "healthy"]
    assert "router.routed" in snap["router_counters"]
    back = ReplicatedEngine.restore(snap, CFG, both[1], device="cpu")
    assert back.n_replicas == 2
    assert back._owner == eng._owner
    done.update(_collect(back, [i for i in ids if i not in done]))
    assert [done[i][0] for i in ids] == [want[k][0] for k in range(4)]


def test_replicas_metrics_fan_in(params):
    eng = ReplicatedEngine(CFG, params, n_replicas=2, **KW)
    ids = [eng.add_request(p, sampling=SamplingParams(
        max_new_tokens=3, temperature=0.0)).req_id
        for p in _prompts(4, seed=60, families=2)]
    _collect(eng, ids)
    names = {m.name for m in eng.sync_metrics()}
    assert "router.routed" in names
    for i in range(2):
        assert f"replica{i}.finished" in names or \
            f"replica{i}.engine.finished" in names
    assert eng.stats()["aggregate"]["finished"] == 4
    assert sum(d["finished"] for d in eng.stats()["replicas"]) == 4


def test_replicas_validation():
    with pytest.raises(ValueError):
        ReplicatedEngine(CFG, None, routing="random")
    with pytest.raises(ValueError):
        ReplicatedEngine(CFG, None, n_replicas=0)


def test_fleet_snapshot_v1_restores_all_healthy(params):
    """A v1 fleet snapshot (per-replica snapshots, no health) restores as
    an all-HEALTHY fleet that finishes every request."""
    eng = ReplicatedEngine(CFG, params, n_replicas=2, **KW)
    reqs = [eng.add_request(p, sampling=SamplingParams(
        max_new_tokens=4, temperature=0.0)) for p in _prompts(4, seed=61)]
    eng.step()
    v2 = eng.snapshot()
    v1 = {"format": "replicated-engine-snapshot-v1",
          "routing": v2["routing"], "rr_cursor": v2["rr_cursor"],
          "owner": v2["owner"], "replicas": v2["replicas"]}
    back = ReplicatedEngine.restore(v1, CFG, params, device="cpu")
    assert [back.health(i) for i in range(2)] == [ReplicaHealth.HEALTHY] * 2
    done = {r.req_id: r for r in back.serve_all()}
    assert all(done[r.req_id].finish_reason is FinishReason.LENGTH
               for r in reqs)
    with pytest.raises(ValueError, match="format"):
        ReplicatedEngine.restore({"format": "v0"}, CFG, params)


# ---------------------------------------------------------------------------
# health states + routing (test_replica_ft.py)
# ---------------------------------------------------------------------------


def test_route_never_selects_non_healthy(params):
    eng = ReplicatedEngine(CFG, params, n_replicas=3,
                           routing="round_robin", **KW)
    assert [eng.health(i) for i in range(3)] == [ReplicaHealth.HEALTHY] * 3
    eng._health[0] = ReplicaHealth.DEGRADED
    eng._health[2] = ReplicaHealth.DRAINING
    for k in range(6):
        idx, _ = eng.route(_prompts(1, seed=k)[0])
        eng._rr += 1
        assert idx == 1
    eng._health[1] = ReplicaHealth.DOWN
    with pytest.raises(RuntimeError, match="no healthy replicas"):
        eng.route(_prompts(1, seed=9)[0])


def test_step_exception_marks_down_not_poison(params):
    eng = ReplicatedEngine(CFG, params, n_replicas=2,
                           routing="round_robin", **KW)
    sp = SamplingParams(max_new_tokens=6, temperature=0.0)
    reqs = [eng.add_request(p, sampling=sp) for p in _prompts(6, seed=1)]
    _arm_crash(eng.replicas[0], in_steps=2)
    _serve_out(eng, reqs)
    assert eng.health(0) is ReplicaHealth.DOWN
    assert "SimulatedCrash" in eng.down_cause(0)
    assert eng.health(1) is ReplicaHealth.HEALTHY
    assert all(r.finish_reason in (FinishReason.LENGTH, FinishReason.EOS)
               for r in reqs)
    assert eng.stats()["router"]["router.failovers"] == 1
    assert eng.stats()["router"]["router.migrations"] > 0
    assert_fleet_invariants(eng)


# ---------------------------------------------------------------------------
# failover: migration (no snapshot) and snapshot restore
# ---------------------------------------------------------------------------


def test_migration_failover_greedy_token_identical(both):
    prompts = _prompts(8, seed=2, families=2)
    base = _reference_fleet(both, prompts, js.SamplingParams(
        max_new_tokens=8, temperature=0.0), 4)
    eng = ReplicatedEngine(CFG, both[1], n_replicas=4, **KW)
    reqs = [eng.add_request(p, sampling=SamplingParams(
        max_new_tokens=8, temperature=0.0)) for p in prompts]
    for _ in range(2):
        eng.step()
    victim = next(i for i in range(4) if eng.replicas[i].has_work())
    _arm_crash(eng.replicas[victim], in_steps=1)
    assert _serve_out(eng, reqs) == base
    assert eng.health(victim) is ReplicaHealth.DOWN
    assert eng.stats()["router"]["router.restored_replicas"] == 0
    assert_fleet_invariants(eng)


def test_migration_failover_sampled_token_identical(both):
    """The device-side PRNG carry dies with the replica; migration
    rebuilds it on the host (``_replay_key``) and the sampled streams
    continue as the reference's unfaulted fleet serves them."""
    prompts = _prompts(6, seed=3, families=2)
    base = _reference_fleet(both, prompts, lambda i: js.SamplingParams(
        max_new_tokens=8, temperature=0.9, seed=100 + i), 2)
    eng = ReplicatedEngine(CFG, both[1], n_replicas=2, **KW)
    reqs = [eng.add_request(p, sampling=SamplingParams(
        max_new_tokens=8, temperature=0.9, seed=100 + i))
        for i, p in enumerate(prompts)]
    for _ in range(3):
        eng.step()
    victim = next(i for i in range(2) if eng.replicas[i].has_work())
    _arm_crash(eng.replicas[victim], in_steps=1)
    assert _serve_out(eng, reqs) == base
    assert eng.stats()["router"]["router.migrations"] > 0
    assert_fleet_invariants(eng)


def test_snapshot_failover_restores_in_place(both):
    prompts = _prompts(8, seed=4, families=2)
    base = _reference_fleet(both, prompts, js.SamplingParams(
        max_new_tokens=8, temperature=0.0), 2)
    eng = ReplicatedEngine(CFG, both[1], n_replicas=2, **KW)
    reqs = [eng.add_request(p, sampling=SamplingParams(
        max_new_tokens=8, temperature=0.0)) for p in prompts]
    idx_by_rid = {r.req_id: i for i, r in enumerate(reqs)}
    done = {}

    def step():
        for r in eng.step():
            done[idx_by_rid[r.req_id]] = (list(r.output_tokens),
                                          r.finish_reason.value)

    for _ in range(2):
        step()
    eng.publish_snapshots()
    for _ in range(2):
        step()
    victim = next(i for i in range(2) if eng.replicas[i].has_work())
    _arm_crash(eng.replicas[victim], in_steps=1)
    for _ in range(3000):
        if not eng.has_work():
            break
        step()
    assert eng.health(victim) is ReplicaHealth.HEALTHY
    r = eng.stats()["router"]
    assert r["router.failovers"] == 1
    assert r["router.restored_replicas"] == 1
    assert done == base
    assert_fleet_invariants(eng)


def test_quarantine_poison_request_after_two_kills(params):
    eng = ReplicatedEngine(CFG, params, n_replicas=3,
                           routing="round_robin", max_request_retries=2,
                           **KW)
    sp = SamplingParams(max_new_tokens=16, temperature=0.0)
    reqs = [eng.add_request(p, sampling=sp) for p in _prompts(6, seed=5)]
    poison = reqs[0]
    first = eng.owner_of(poison.req_id)
    _arm_crash(eng.replicas[first], in_steps=1)
    eng.step()
    assert eng.health(first) is ReplicaHealth.DOWN
    second = eng.owner_of(poison.req_id)
    assert second is not None and second != first
    _arm_crash(eng.replicas[second], in_steps=1)
    _serve_out(eng, reqs)
    assert poison.finish_reason is FinishReason.ABORTED
    assert poison.req_id in eng.quarantined
    r = eng.stats()["router"]
    assert r["router.quarantined"] == 1
    assert r["router.failovers"] == 2
    for other in reqs[1:]:
        assert other.finish_reason in (FinishReason.LENGTH, FinishReason.EOS)
    assert_fleet_invariants(eng)


# ---------------------------------------------------------------------------
# detection: heartbeat silence + stragglers
# ---------------------------------------------------------------------------


def test_heartbeat_silence_goes_down_by_step_lag(params):
    eng = ReplicatedEngine(CFG, params, n_replicas=2,
                           routing="round_robin", silence_steps_down=3,
                           **KW)
    sp = SamplingParams(max_new_tokens=24, temperature=0.0)
    reqs = [eng.add_request(p, sampling=sp) for p in _prompts(4, seed=6)]
    inj = FaultInjector(seed=0)
    inj.schedule(eng.replicas[0].step_idx + 1, "heartbeat_silence")
    eng.replicas[0].faults = inj
    _serve_out(eng, reqs)
    assert "heartbeat_silence" in [k for _, k, _ in inj.fired]
    assert eng.health(0) is ReplicaHealth.DOWN
    assert eng.down_cause(0) == "heartbeat_silence"
    for r in reqs:
        assert r.finish_reason in (FinishReason.LENGTH, FinishReason.EOS)
    assert_fleet_invariants(eng)


def test_straggler_degraded_then_recovers(params):
    sup = FleetSupervisor(straggler_window=4, straggler_threshold=3.0)
    eng = ReplicatedEngine(CFG, params, n_replicas=3,
                           routing="round_robin", supervisor=sup, **KW)
    for p in _prompts(6, seed=7):
        eng.add_request(p, sampling=SamplingParams(max_new_tokens=48,
                                                   temperature=0.0))
    inj = FaultInjector(seed=0)
    inj.schedule(eng.replicas[0].step_idx + 1, "straggle", factor=100.0,
                 hold_steps=4)
    eng.replicas[0].faults = inj
    saw_degraded = False
    for _ in range(3000):
        if not eng.has_work():
            break
        eng.step()
        if eng.health(0) is ReplicaHealth.DEGRADED:
            saw_degraded = True
            idx, _ = eng.route(_prompts(1, seed=8)[0])
            assert idx != 0
    assert saw_degraded, "straggle fault never flagged the replica"
    assert eng.health(0) is ReplicaHealth.HEALTHY
    assert eng.replicas[0].straggle_factor == 1.0
    assert_fleet_invariants(eng)


# ---------------------------------------------------------------------------
# elasticity: drain + scale
# ---------------------------------------------------------------------------


def test_drain_replica_migrates_and_detaches(both):
    prompts = _prompts(8, seed=9, families=2)
    base = _reference_fleet(both, prompts, js.SamplingParams(
        max_new_tokens=8, temperature=0.0), 2)
    eng = ReplicatedEngine(CFG, both[1], n_replicas=2, **KW)
    reqs = [eng.add_request(p, sampling=SamplingParams(
        max_new_tokens=8, temperature=0.0)) for p in prompts]
    for _ in range(2):
        eng.step()
    eng.drain_replica(0, migrate=True)
    assert eng.health(0) is ReplicaHealth.DOWN
    assert eng.down_cause(0) == "drained"
    assert not eng.replicas[0].has_work()
    assert _serve_out(eng, reqs) == base
    assert eng.stats()["router"]["router.drains"] == 1
    assert_fleet_invariants(eng)


def test_drain_replica_finishes_residents_without_migration(params):
    eng = ReplicatedEngine(CFG, params, n_replicas=2,
                           routing="round_robin", **KW)
    sp = SamplingParams(max_new_tokens=6, temperature=0.0)
    reqs = [eng.add_request(p, sampling=sp) for p in _prompts(4, seed=10)]
    eng.drain_replica(0, migrate=False)
    assert eng.health(0) is ReplicaHealth.DRAINING
    extra = eng.add_request(_prompts(1, seed=11)[0], sampling=sp)
    assert eng.owner_of(extra.req_id) == 1
    _serve_out(eng, reqs)
    assert eng.health(0) is ReplicaHealth.DOWN
    for r in reqs + [extra]:
        assert r.finish_reason in (FinishReason.LENGTH, FinishReason.EOS)
    assert_fleet_invariants(eng)


def test_scale_to_grow_and_shrink(params):
    eng = ReplicatedEngine(CFG, params, n_replicas=2,
                           routing="round_robin", **KW)
    sp = SamplingParams(max_new_tokens=4, temperature=0.0)
    plan = eng.scale_to(4)
    assert (plan.old_data_parallel, plan.new_data_parallel) == (2, 4)
    assert plan.action == "grow"
    assert eng.n_replicas == 4
    assert all(eng.health(i) is ReplicaHealth.HEALTHY for i in range(4))
    assert all(rep.device.type == "cpu" for rep in eng.replicas)
    reqs = [eng.add_request(p, sampling=sp) for p in _prompts(8, seed=12)]
    assert len({eng.owner_of(r.req_id) for r in reqs}) == 4
    for _ in range(2):
        eng.step()
    plan = eng.scale_to(1)
    assert plan.action == "shrink"
    assert len(plan.evicted_ranks) == 3
    assert eng.stats()["health"].count("healthy") == 1
    _serve_out(eng, reqs)
    for r in reqs:
        assert r.finish_reason in (FinishReason.LENGTH, FinishReason.EOS)
    assert eng.scale_to(1).action == "none"
    assert_fleet_invariants(eng)


def test_scale_to_revives_down_slot_in_place(params):
    eng = ReplicatedEngine(CFG, params, n_replicas=2,
                           routing="round_robin", **KW)
    sp = SamplingParams(max_new_tokens=6, temperature=0.0)
    reqs = [eng.add_request(p, sampling=sp) for p in _prompts(4, seed=13)]
    _arm_crash(eng.replicas[0], in_steps=1)
    eng.step()
    assert eng.health(0) is ReplicaHealth.DOWN
    plan = eng.scale_to(2)
    assert plan.action == "grow"
    assert eng.n_replicas == 2
    assert eng.health(0) is ReplicaHealth.HEALTHY
    assert eng.replicas[0].max_slots == KW["max_slots"]
    _serve_out(eng, reqs)
    for r in reqs:
        assert r.finish_reason in (FinishReason.LENGTH, FinishReason.EOS)
    assert_fleet_invariants(eng)


# ---------------------------------------------------------------------------
# degraded-fleet snapshot round trip
# ---------------------------------------------------------------------------


def test_snapshot_v2_roundtrips_degraded_fleet(params):
    eng = ReplicatedEngine(CFG, params, n_replicas=3,
                           routing="round_robin", **KW)
    sp = SamplingParams(max_new_tokens=8, temperature=0.0)
    reqs = [eng.add_request(p, sampling=sp) for p in _prompts(6, seed=14)]
    _arm_crash(eng.replicas[1], in_steps=1)
    eng.step()
    assert eng.health(1) is ReplicaHealth.DOWN
    snap = eng.snapshot()
    assert snap["format"] == "replicated-engine-snapshot-v2"
    assert snap["health"] == ["healthy", "down", "healthy"]
    assert snap["replicas"][1] is None
    back = ReplicatedEngine.restore(snap, CFG, params, device="cpu")
    assert back.health(1) is ReplicaHealth.DOWN
    assert "SimulatedCrash" in back.down_cause(1)
    assert back._retries == eng._retries
    assert back.quarantined == eng.quarantined
    assert (back.stats()["router"]["router.failovers"]
            == eng.stats()["router"]["router.failovers"])
    done = {r.req_id: r for r in back.serve_all()}
    for r in reqs:
        fin = done[r.req_id]
        assert fin.finish_reason in (FinishReason.LENGTH, FinishReason.EOS)
        assert fin.output_tokens == r.output_tokens or fin is not r
    assert_fleet_invariants(back)


# ---------------------------------------------------------------------------
# metrics fan-in, router.cancels, supervisor rank claims
# ---------------------------------------------------------------------------


def test_sync_metrics_copies_gauges_and_histograms(params):
    eng = ReplicatedEngine(CFG, params, n_replicas=2,
                           routing="round_robin", **KW)
    for p in _prompts(4, seed=15):
        eng.add_request(p, sampling=SamplingParams(max_new_tokens=3,
                                                   temperature=0.0))
    eng.serve_all()
    by_name = {m.name: m for m in eng.sync_metrics()}
    for i in range(2):
        g = by_name[f"replica{i}.pool.free_pages"]
        assert g.kind == "gauge" and g.n > 0
        h = by_name[f"replica{i}.request.e2e_ms"]
        assert h.kind == "histogram" and h.count > 0
        src = {m.name: m for m in eng.replicas[i].registry}
        assert h.counts == src["request.e2e_ms"].counts
    c0 = by_name["replica0.request.e2e_ms"].count
    assert {m.name: m for m in eng.sync_metrics()}[
        "replica0.request.e2e_ms"].count == c0


def test_router_cancels_counter_both_paths(params):
    eng = ReplicatedEngine(CFG, params, n_replicas=2,
                           routing="round_robin", **KW)
    sp = SamplingParams(max_new_tokens=12, temperature=0.0)
    routed = eng.add_request(_prompts(1, seed=16)[0], sampling=sp)
    direct = eng.replicas[1].add_request(_prompts(1, seed=17)[0],
                                         sampling=sp)
    assert eng.cancel(routed.req_id)
    assert eng.cancel(direct.req_id)
    assert eng.stats()["router"]["router.cancels"] == 2
    assert not eng.cancel(routed.req_id)
    assert eng.stats()["router"]["router.cancels"] == 2
    eng.serve_all()
    assert routed.finish_reason is FinishReason.ABORTED
    assert direct.finish_reason is FinishReason.ABORTED


def test_supervisor_rank_claims():
    reg = HeartbeatRegistry(timeout_s=60.0)
    a = EngineSupervisor(heartbeat=reg)
    b = EngineSupervisor(heartbeat=reg)
    assert (a.rank, b.rank) == (0, 1)
    with pytest.raises(ValueError, match="already claimed"):
        EngineSupervisor(heartbeat=reg, rank=0)
    assert EngineSupervisor(heartbeat=reg, rank=7).rank == 7
    reg.release(1)
    assert EngineSupervisor(heartbeat=reg).rank == 1


def test_fleet_supervisor_rank_claims():
    sup = FleetSupervisor()

    class _Eng:   # attach only touches heartbeat fields
        step_idx = 0
        heartbeat = None
        heartbeat_rank = 0

    r0 = sup.attach(_Eng())
    r1 = sup.attach(_Eng())
    assert (r0, r1) == (0, 1)
    with pytest.raises(ValueError, match="already claimed"):
        sup.attach(_Eng(), rank=r0)
    sup.detach(r0)
    assert sup.attach(_Eng()) == 0


@pytest.mark.parametrize("case", [
    (8, 1, [], 0, "none", 8), (8, 1, [3], 1, "swap_spares", 8),
    (8, 1, [3, 5], 0, "shrink", 4), (4, 2, [0, 1, 2, 3], 0, "halt", 0),
    (6, 1, [2], 0, "shrink", 3)])
def test_plan_elastic_remesh_is_the_references(case):
    from repro.ft.coordinator import plan_elastic_remesh as jplan

    dp, mp, bad, spares, action, new_dp = case
    mine = plan_elastic_remesh(dp, mp, bad, n_spares=spares, resume_step=7)
    theirs = jplan(dp, mp, bad, n_spares=spares, resume_step=7)
    assert (mine.action, mine.new_data_parallel) == (action, new_dp)
    assert mine.__dict__ == theirs.__dict__
    assert mine.mesh_changed == (new_dp != dp)
