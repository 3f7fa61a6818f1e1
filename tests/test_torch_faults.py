"""Chaos tests of the port's serving fault tolerance (``serving.faults``
and the engine's hooks) against the JAX reference, on the CPU.

Counterparts of ``tests/test_faults.py``: cancellation at every lifecycle
stage (with the harvest-lag drain), deadline sweeps, queue-wait shedding
and chunk degradation under pool pressure, priority ordering, the seeded
``FaultInjector`` (pool exhaustion, dispatch failure, clock skew, crashes)
and property-tested free-after-cancel interleavings.  Every scenario ends
with ``assert_recovery_invariants``, and wherever requests survive their
tokens are held to the reference engine's unfaulted run on the same seeded
params.  Beyond the counterparts: the injector draws the reference's
schedule for every seed, and the same schedule on the same trace fires
the reference's log, fault by fault, with the same tokens; heartbeats
reach their registry every step; ``readmit`` adopts a request as the
reference's does."""

import jax
import numpy as np
import pytest

from _hypothesis_compat import given, settings, st  # optional dep

import _torch_tp_worker as W
import repro.serving as js
import repro_torch.serving as ts
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.ft.coordinator import HeartbeatRegistry
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.config import ModelConfig
from repro_torch.serving import (ContinuousBatchingEngine, DispatchFailure,
                                 FaultInjector, FinishReason, PagedKVPool,
                                 Request, SamplingParams, SchedulerConfig,
                                 SimulatedCrash, assert_recovery_invariants)
from repro_torch.serving.faults import FAULT_KINDS
from repro_torch.serving.scheduler import IterationScheduler

FIELDS = dict(name="t", d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
              d_ff=128, vocab=256, dtype="float32")
CFG = ModelConfig(**FIELDS)
JCFG = JModelConfig(**FIELDS)

PROMPTS = [list(range(5, 15)), list(range(30, 38)), [7, 9, 11]]


def _params():
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


@pytest.fixture(scope="module")
def params():
    """(reference params, the port's copy of them on the CPU)."""
    return _params()


def _engine(params, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_len", 128)
    return ContinuousBatchingEngine(CFG, params[1], device="cpu", **kw)


def _jengine(params, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_len", 128)
    return js.ContinuousBatchingEngine(JCFG, params[0], **kw)


@pytest.fixture(scope="module")
def reference(params):
    """The reference engine's greedy tokens on the 3-request workload,
    unfaulted."""
    eng = _jengine(params)
    reqs = [eng.add_request(p, js.SamplingParams(max_new_tokens=8))
            for p in PROMPTS]
    eng.run()
    return [list(r.output_tokens) for r in reqs]


# ---------------------------------------------------------------------------
# cancellation
# ---------------------------------------------------------------------------


def test_cancel_waiting_request(params):
    eng = _engine(params, max_slots=1)
    a = eng.add_request(PROMPTS[0], SamplingParams(max_new_tokens=4))
    b = eng.add_request(PROMPTS[1], SamplingParams(max_new_tokens=4))
    eng.step()
    assert eng.cancel(b.req_id)
    assert b.finish_reason is FinishReason.ABORTED
    assert b.output_tokens == []
    assert eng.stats["aborts"] == 1
    assert b in eng.step()
    eng.run()
    assert a.finish_reason is FinishReason.LENGTH
    assert_recovery_invariants(eng)


def test_cancel_running_request_frees_pages(params, reference):
    eng = _engine(params)
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=8))
            for p in PROMPTS]
    eng.step()
    eng.step()
    victim = reqs[0]
    held_before = len(eng.pool_host._tables)
    assert eng.cancel(victim.req_id)
    assert victim.finish_reason is FinishReason.ABORTED
    assert len(eng.pool_host._tables) == held_before - 1
    assert_recovery_invariants(eng)
    eng.run()
    assert [list(r.output_tokens) for r in reqs[1:]] == reference[1:]
    assert any(ev == "aborted" for ev, _ in victim.events)


def test_cancel_unknown_and_double_cancel(params):
    eng = _engine(params)
    req = eng.add_request(PROMPTS[2], SamplingParams(max_new_tokens=2))
    assert not eng.cancel(99999)
    assert eng.cancel(req.req_id)
    assert not eng.cancel(req.req_id)
    assert eng.stats["aborts"] == 1
    eng.run()
    assert_recovery_invariants(eng)


def test_cancel_after_drain_finished_is_noop(params, reference):
    """A cancel that races a finishing request loses: the drain inside
    cancel() lands the final token first, and cancel returns False."""
    eng = _engine(params)
    req = eng.add_request(PROMPTS[2], SamplingParams(max_new_tokens=1))
    eng.step()
    assert not eng.cancel(req.req_id)
    assert req.finish_reason is FinishReason.LENGTH
    assert req.output_tokens == reference[2][:1]
    assert eng.step() == [req]
    assert_recovery_invariants(eng)


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------


def test_deadline_expires_queued_request(params):
    eng = _engine(params, max_slots=1)
    a = eng.add_request(PROMPTS[0], SamplingParams(max_new_tokens=4))
    b = eng.add_request(PROMPTS[1], SamplingParams(max_new_tokens=4,
                                                   deadline_s=0.0))
    eng.run()
    assert a.finish_reason is FinishReason.LENGTH
    assert b.finish_reason is FinishReason.TIMEOUT
    assert b.output_tokens == []
    assert eng.stats["timeouts"] == 1
    assert_recovery_invariants(eng)


def test_deadline_expires_mid_decode(params, reference):
    eng = _engine(params)
    doomed = eng.add_request(PROMPTS[0], SamplingParams(max_new_tokens=8,
                                                        deadline_s=1e-6))
    others = [eng.add_request(p, SamplingParams(max_new_tokens=8))
              for p in PROMPTS[1:]]
    eng.step()
    eng.run()
    assert doomed.finish_reason is FinishReason.TIMEOUT
    assert doomed.req_id not in eng.pool_host._tables
    assert [list(r.output_tokens) for r in others] == reference[1:]
    assert_recovery_invariants(eng)


def test_clock_skew_fires_deadlines(params):
    fi = FaultInjector().schedule(3, "clock_skew", skew_s=3600.0)
    eng = _engine(params, fault_injector=fi)
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=16,
                                              deadline_s=600.0))
            for p in PROMPTS]
    eng.run()
    assert eng.stats["timeouts"] == len(reqs)
    assert all(r.finish_reason is FinishReason.TIMEOUT for r in reqs)
    assert "clock_skew" in [k for _, k, _ in fi.fired]
    assert_recovery_invariants(eng)


# ---------------------------------------------------------------------------
# overload shedding + degradation
# ---------------------------------------------------------------------------


def test_queue_wait_shed_under_overload(params):
    eng = _engine(params, max_slots=2)
    reqs = [eng.add_request(list(range(4 + i, 14 + i)),
                            SamplingParams(max_new_tokens=4,
                                           max_queue_wait_s=0.0))
            for i in range(4)]
    eng.run()
    served = [r for r in reqs if r.finish_reason is FinishReason.LENGTH]
    shed = [r for r in reqs if r.finish_reason is FinishReason.SHED]
    assert len(served) + len(shed) == 4
    assert eng.stats["sheds"] == len(shed) > 0
    assert all(r.output_tokens == [] for r in shed)
    assert all(len(r.output_tokens) == 4 for r in served)
    assert_recovery_invariants(eng)


def test_no_shed_without_budget(params):
    eng = _engine(params, max_slots=1)
    reqs = [eng.add_request(list(range(4 + i, 10 + i)),
                            SamplingParams(max_new_tokens=2))
            for i in range(5)]
    eng.run()
    assert eng.stats["sheds"] == 0
    assert all(r.finish_reason is FinishReason.LENGTH for r in reqs)
    assert_recovery_invariants(eng)


def test_degrade_caps_chunks_under_pressure():
    cfg = SchedulerConfig(chunk_size=32, max_slots=4, prefix_sharing=False,
                          degrade_free_frac=0.5)
    sched = IterationScheduler(cfg)
    pool = PagedKVPool(n_pages=9, page_size=4)
    pool.allocate(999, 24)
    req = Request(prompt=list(range(40)),
                  sampling=SamplingParams(max_new_tokens=4))
    plan = sched.plan_step([req], [], pool)
    assert plan.admissions
    _, chunk = plan.admissions[0]
    assert chunk <= pool.page_size
    assert plan.degraded >= 1
    plan2 = sched.plan_step([req], [], PagedKVPool(n_pages=33, page_size=4))
    assert plan2.admissions[0][1] == cfg.chunk_size
    assert plan2.degraded == 0


def test_degraded_run_token_identical(params):
    """Chunk degradation changes packing, never tokens: the degraded port
    run serves the reference's undegraded tokens."""
    prompts = [list(range(2, 34)), list(range(50, 80)), list(range(7, 27))]

    def run(make, pk, frac):
        eng = make(params, max_len=64, n_pages=17,
                   scheduler_cfg=pk.SchedulerConfig(chunk_size=16,
                                                    degrade_free_frac=frac))
        reqs = [eng.add_request(p, pk.SamplingParams(max_new_tokens=8))
                for p in prompts]
        eng.run()
        return eng, [list(r.output_tokens) for r in reqs]

    _, ref = run(_jengine, js, 0.0)
    eng, outs = run(_engine, ts, 0.9)
    assert eng.stats["degraded_chunks"] > 0
    assert outs == ref
    assert_recovery_invariants(eng)


def test_priority_orders_admission(params):
    eng = _engine(params, max_slots=1)
    lo = eng.add_request(PROMPTS[0], SamplingParams(max_new_tokens=2))
    hi = eng.add_request(PROMPTS[1], SamplingParams(max_new_tokens=2,
                                                    priority=5))
    eng.run()
    assert hi.admitted_step < lo.admitted_step
    assert_recovery_invariants(eng)


# ---------------------------------------------------------------------------
# fault injector
# ---------------------------------------------------------------------------


def test_injector_rejects_unknown_kind():
    with pytest.raises(ValueError):
        FaultInjector().schedule(1, "meteor_strike")


def test_random_schedule_reproducible():
    a = FaultInjector(seed=7).random_schedule(5, max_step=20)
    b = FaultInjector(seed=7).random_schedule(5, max_step=20)
    assert [(e.step, e.kind) for e in a.events] == \
        [(e.step, e.kind) for e in b.events]
    assert all(e.kind in FAULT_KINDS and not e.kind.startswith("crash")
               for e in a.events)


def test_pool_exhaustion_recovers_token_identical(params, reference):
    fi = FaultInjector().schedule(2, "pool_exhaustion", frac=1.0,
                                  hold_steps=3)
    eng = _engine(params, fault_injector=fi)
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=8))
            for p in PROMPTS]
    eng.run()
    fi.release_all(eng)
    assert any(k == "pool_exhaustion" for _, k, _ in fi.fired)
    assert [list(r.output_tokens) for r in reqs] == reference
    assert_recovery_invariants(eng)


def test_dispatch_failure_recovers_token_identical(params, reference):
    fi = FaultInjector().schedule(3, "dispatch_failure")
    eng = _engine(params, fault_injector=fi)
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=8))
            for p in PROMPTS]
    eng.run()
    assert eng.stats["dispatch_failures"] == 1
    assert eng.stats["preemptions"] >= 1
    assert [list(r.output_tokens) for r in reqs] == reference
    assert_recovery_invariants(eng)


@pytest.mark.parametrize("when", ["before", "after"])
def test_crash_raises_out_of_step(params, when):
    fi = FaultInjector().schedule(2, f"crash_{when}_harvest")
    eng = _engine(params, fault_injector=fi)
    eng.add_request(PROMPTS[0], SamplingParams(max_new_tokens=8))
    eng.step()
    with pytest.raises(SimulatedCrash):
        eng.step()
    assert fi.fired == [(2, f"crash_{when}_harvest", None)]


def test_dispatch_failure_exception_type():
    err = DispatchFailure("boom")
    assert err.kind == "dispatch_failure"
    assert isinstance(err, RuntimeError)


# ---------------------------------------------------------------------------
# free-after-cancel interleavings (property)
# ---------------------------------------------------------------------------


def test_double_free_raises():
    pool = PagedKVPool(n_pages=5, page_size=4)
    pool.allocate(1, 8)
    pool.free(1)
    with pytest.raises(KeyError):
        pool.free(1)


_PORT_PARAMS = []


@settings(deadline=None, max_examples=25)
@given(st.lists(st.tuples(st.integers(0, 2), st.integers(0, 3)),
                min_size=1, max_size=10),
       st.integers(0, 2))
def test_cancel_interleavings_never_leak(actions, cancel_idx):
    """Random interleavings of step / cancel / add against a small engine:
    whatever the order, no pool pages leak and invariants hold.  (The
    reference's twin takes a ``params=None`` default, which hypothesis
    refuses; the params are built once per process here instead.)"""
    if not _PORT_PARAMS:
        _PORT_PARAMS.append(_params()[1])
    eng = ContinuousBatchingEngine(CFG, _PORT_PARAMS[0], max_slots=2,
                                   page_size=8, max_len=64, device="cpu")
    reqs = [eng.add_request([3 + i, 5 + i, 7 + i],
                            SamplingParams(max_new_tokens=3))
            for i in range(3)]
    for op, arg in actions:
        if op == 0:
            eng.step()
        elif op == 1:
            eng.cancel(reqs[arg % 3].req_id)
        else:
            reqs.append(eng.add_request([11, 13 + arg],
                                        SamplingParams(max_new_tokens=2)))
        assert_recovery_invariants(eng)
    eng.cancel(reqs[cancel_idx].req_id)
    eng.run()
    assert_recovery_invariants(eng)
    assert not eng.pool_host._tables
    for r in reqs:
        assert r.finish_reason is not None


def test_cancel_interleavings_never_leak_seeded(params):
    """Numpy-seeded twin of the property above, so the coverage survives
    without hypothesis."""
    rng = np.random.RandomState(5)
    for _ in range(6):
        eng = _engine(params, max_slots=2, max_len=64)
        reqs = [eng.add_request([3 + i, 5 + i, 7 + i],
                                SamplingParams(max_new_tokens=3))
                for i in range(3)]
        for _ in range(rng.randint(1, 11)):
            op, arg = rng.randint(3), rng.randint(4)
            if op == 0:
                eng.step()
            elif op == 1:
                eng.cancel(reqs[arg % 3].req_id)
            else:
                reqs.append(eng.add_request(
                    [11, 13 + arg], SamplingParams(max_new_tokens=2)))
            assert_recovery_invariants(eng)
        eng.cancel(reqs[rng.randint(3)].req_id)
        eng.run()
        assert_recovery_invariants(eng)
        assert not eng.pool_host._tables
        assert all(r.finish_reason is not None for r in reqs)


# ---------------------------------------------------------------------------
# the reference's injector, log and tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_random_schedule_is_the_references(seed):
    a = FaultInjector(seed=seed).random_schedule(8, max_step=30)
    b = js.FaultInjector(seed=seed).random_schedule(8, max_step=30)
    assert [(e.step, e.kind, e.kw) for e in a.events] == \
        [(e.step, e.kind, e.kw) for e in b.events]
    kinds = tuple(FAULT_KINDS)
    a = FaultInjector(seed=seed).random_schedule(8, 30, kinds=kinds)
    b = js.FaultInjector(seed=seed).random_schedule(8, 30, kinds=kinds)
    assert [(e.step, e.kind) for e in a.events] == \
        [(e.step, e.kind) for e in b.events]


SCHEDULES = {
    "random": lambda fi: fi.random_schedule(6, max_step=12),
    "mixed": lambda fi: fi.schedule(2, "pool_exhaustion", frac=0.6,
                                    hold_steps=2)
    .schedule(4, "dispatch_failure").schedule(5, "straggle", factor=4.0,
                                              hold_steps=2)
    .schedule(6, "heartbeat_silence").schedule(7, "pool_exhaustion",
                                               frac=1.0, hold_steps=3),
}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_fault_log_and_tokens_are_the_references(params, schedule):
    """The same seeded schedule on the same trace, in both packages:
    the same faults fire at the same steps with the same details (pages
    stolen, factors), the engines count the same recoveries, and every
    request serves the same tokens, greedy and sampled."""
    out = {}
    for name, make, pk in (("jax", _jengine, js),
                           ("torch", _engine, ts)):
        fi = SCHEDULES[schedule](pk.FaultInjector(seed=3))
        eng = make(params, fault_injector=fi)
        reqs = [eng.add_request(p, pk.SamplingParams(
            max_new_tokens=10, temperature=0.7 if i == 1 else 0.0, seed=i))
            for i, p in enumerate(PROMPTS + [list(range(60, 75))])]
        eng.run()
        fi.release_all(eng)
        assert not eng.has_work()
        out[name] = (list(fi.log), [list(r.output_tokens) for r in reqs],
                     {k: eng.stats[k] for k in (
                         "dispatch_failures", "preemptions", "timeouts",
                         "mixed_steps")})
        if name == "torch":
            assert_recovery_invariants(eng)
    assert out["torch"] == out["jax"]
    assert out["torch"][0], "the schedule fired nothing"


def test_heartbeat_reports_every_step_until_silenced(params):
    reg = HeartbeatRegistry(timeout_s=5.0)
    fi = FaultInjector().schedule(3, "heartbeat_silence")
    eng = _engine(params, heartbeat=reg, heartbeat_rank=4,
                  fault_injector=fi)
    eng.add_request(PROMPTS[0], SamplingParams(max_new_tokens=6))
    eng.step()
    assert reg.last_step(4) == 1
    eng.step()
    assert reg.last_step(4) == 2
    eng.run()
    assert eng.heartbeat is None
    assert reg.last_step(4) == 2 and eng.step_idx > 3


def test_readmit_matches_the_reference(params, reference):
    """A request preempted off one engine and adopted by another through
    ``readmit`` (its cursor reset) serves the reference's tokens; a
    finished request cannot be readmitted, an oversized one raises."""
    a = _engine(params)
    reqs = [a.add_request(p, SamplingParams(max_new_tokens=8))
            for p in PROMPTS]
    a.step()
    a.step()
    a._overflow.extend(a.drain())
    for seq in sorted(a.running.values(), key=lambda s: s.admit_order):
        a._preempt(seq)
    b = _engine(params)
    moved = list(a.waiting)
    a.waiting.clear()
    for r in moved:
        assert b.readmit(r) is r
        assert r.num_computed_tokens == 0 and r.events[-1][0] == "migrated"
    b.run()
    assert [list(r.output_tokens) for r in reqs] == reference
    with pytest.raises(ValueError, match="already finished"):
        b.readmit(reqs[0])
    big = Request(prompt=list(range(200)),
                  sampling=SamplingParams(max_new_tokens=4))
    with pytest.raises(ts.PoolOOM):
        b.readmit(big)


def test_faults_under_a_mesh_act_alike_on_every_rank(params):
    """Two gloo ranks, each with its own injector on the same schedule:
    the clock skew acts on the broadcast clock every rank reads, so both
    ranks time out the same requests at the same step; pool exhaustion
    and a dispatch failure recover alike; every rank's reasons, tokens and
    log equal a tp = 1 port engine's and the reference engine's."""
    job = {"cfg": CFG, "geom": dict(max_slots=4, page_size=8, max_len=128),
           "params": jax.tree_util.tree_map(np.asarray, params[0]),
           "prompts": PROMPTS + [list(range(60, 75))],
           "sampling": [dict(max_new_tokens=10, seed=i,
                             temperature=0.7 if i == 1 else 0.0,
                             deadline_s=600.0 if i >= 2 else None)
                        for i in range(4)],
           "schedule": [(2, "pool_exhaustion", {"frac": 1.0,
                                                "hold_steps": 2}),
                        (4, "dispatch_failure", {}),
                        (6, "clock_skew", {"skew_s": 3600.0})]}
    ranks = run_ranks(W.faults_on_mesh, 2, backend="gloo", device="cpu",
                      args=(job,), timeout_s=240)
    tp1 = W.run_faults(ContinuousBatchingEngine, FaultInjector,
                       SamplingParams, assert_recovery_invariants, job,
                       params=params[1], device="cpu")
    ref = W.run_faults(js.ContinuousBatchingEngine, js.FaultInjector,
                       js.SamplingParams, js.assert_recovery_invariants,
                       dict(job, cfg=JCFG), params=params[0])
    assert tp1 == ref
    assert ranks[0] == ranks[1] == tp1
    assert tp1["reasons"][2:] == ["timeout", "timeout"]
    assert tp1["stats"]["dispatch_failures"] == 1
