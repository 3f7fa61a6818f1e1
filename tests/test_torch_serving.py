"""The port's serving runtime against the JAX reference.

Host side: the same scheduler inputs give the same ``plan_step`` outputs,
and the two engines, stepped in lockstep over one request trace, dispatch
the same spans and leave the same pool state after every step.

Device side: greedy tokens equal the JAX ``ContinuousBatchingEngine``'s on
``get_config("gpt2-medium").reduced()`` with the kernels on (Monarch
``backend="pallas"``, ``use_paged_kernel=True``), through chunked
prefill, preemption under a tiny pool, and prefix sharing with a
copy-on-write fork (mirroring tests/test_serving.py)."""

import dataclasses

import jax
import numpy as np
import pytest

import repro.serving as jserving
import repro_torch.serving as tserving
from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy

PACKAGES = {"jax": jserving, "torch": tserving}


# ---------------------------------------------------------------------------
# plan_step on fixed scheduler inputs
# ---------------------------------------------------------------------------


def _scenario(pk, name):
    """Build one scheduler input in package ``pk``; returns the plan and
    an id -> position map so plans compare across packages."""
    order = {}

    def req(plen=8, max_new=8, base=0):
        r = pk.Request(prompt=list(range(base, base + plen)),
                       sampling=pk.SamplingParams(max_new_tokens=max_new))
        order[r.req_id] = len(order)
        return r

    def seq(pool, plen=8, computed=0, state="RUNNING", slot=0, o=0):
        r = req(plen=plen)
        r.state = getattr(pk.RequestState, state)
        r.num_computed_tokens = computed
        pages = pool.allocate(r.req_id, max(computed, 1))
        return pk.Sequence(request=r, slot=slot, page_ids=pages,
                           prefill_target=plen, admit_order=o)

    if name == "pack":
        pool = pk.PagedKVPool(n_pages=64, page_size=8)
        sched = pk.IterationScheduler(pk.SchedulerConfig(
            max_slots=8, chunk_size=4, max_step_tokens=10))
        running = [seq(pool, computed=8, slot=0, o=0),
                   seq(pool, computed=8, slot=1, o=1),
                   seq(pool, plen=32, computed=4, state="PREFILLING",
                       slot=2, o=2)]
        waiting = [req(plen=16, base=100)]
    elif name == "pages":
        pool = pk.PagedKVPool(n_pages=3, page_size=8)
        sched = pk.IterationScheduler(pk.SchedulerConfig(max_slots=3))
        running, waiting = [], [req(base=10 * i) for i in range(5)]
    elif name == "deferral":
        pool = pk.PagedKVPool(n_pages=64, page_size=8)
        sched = pk.IterationScheduler(pk.SchedulerConfig(max_slots=8,
                                                         chunk_size=32))
        running = []
        waiting = [req(plen=32) for _ in range(3)] + [req(plen=32, base=500)]
    elif name == "preempt":
        pool = pk.PagedKVPool(n_pages=4, page_size=4)
        sched = pk.IterationScheduler(pk.SchedulerConfig(max_slots=4))
        running = [seq(pool, plen=4, computed=4, slot=i, o=i)
                   for i in range(3)]
        waiting = [req(plen=4, base=50)]
    else:  # liveness: everyone stalls, the youngest prefill is evicted
        pool = pk.PagedKVPool(n_pages=5, page_size=4)
        sched = pk.IterationScheduler(pk.SchedulerConfig(max_slots=4,
                                                         chunk_size=8))
        running = [seq(pool, plen=32, computed=8, state="PREFILLING",
                       slot=i, o=i) for i in range(2)]
        waiting = []
    plan = sched.plan_step(waiting, running, pool)
    return plan, pool, order


def _plan_key(plan, order):
    return {
        "spans": [(order[s.req_id], n) for s, n in plan.spans],
        "admissions": [(order[r.req_id], n) for r, n in plan.admissions],
        "preemptions": [order[s.req_id] for s in plan.preemptions],
        "degraded": plan.degraded,
        "prefix_deferred": plan.prefix_deferred,
        "total": plan.total_tokens,
    }


@pytest.mark.parametrize("name", ["pack", "pages", "deferral", "preempt",
                                  "liveness"])
def test_plan_step_identical(name):
    got = {k: _scenario(pk, name) for k, pk in PACKAGES.items()}
    keys = {k: _plan_key(plan, order) for k, (plan, _, order) in got.items()}
    assert keys["torch"] == keys["jax"]
    assert dataclasses.asdict(got["torch"][1].stats()) == \
        dataclasses.asdict(got["jax"][1].stats())


# ---------------------------------------------------------------------------
# engines in lockstep, kernels on
# ---------------------------------------------------------------------------


def _kernels_on(cfg):
    return dataclasses.replace(
        cfg, monarch=dataclasses.replace(cfg.monarch, backend="pallas"))


@pytest.fixture(scope="module")
def model():
    jc = _kernels_on(jget_config("gpt2-medium").reduced())
    tc = _kernels_on(tget_config("gpt2-medium").reduced())
    jp = JT.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jc, tc, jp, tp


def _prompts(vocab):
    rng = np.random.default_rng(10)
    return [rng.integers(0, vocab, n) for n in (3, 24, 5, 18, 2)]


def _shared_prefix_prompts(vocab, n=4, prefix_len=14, tail=3):
    """n prompts sharing a prefix, then a repeat of the second and an
    extension of the first: both match a committed partial page, which
    forks copy-on-write."""
    sys_p = list(np.random.default_rng(40).integers(0, vocab, prefix_len))
    prompts = [np.asarray(sys_p + [(17 * i + j) % vocab
                                   for j in range(tail + i % 2)])
               for i in range(n)]
    return prompts + [prompts[1], np.concatenate([prompts[0], [5, 6]])]


TRACES = {
    # chunked prefill with join/evict churn (2 slots, 5 requests)
    "chunked": (dict(max_slots=2, page_size=4, max_len=48, chunk_size=16),
                "plain", 0),
    # a deliberately tiny pool forces preemptions mid-flight
    "preemption": (dict(max_slots=4, page_size=4, max_len=48, n_pages=9,
                        chunk_size=8), "plain", 0),
    # staggered shared-prefix arrivals: trie hits and a COW fork
    "prefix_cow": (dict(max_slots=4, page_size=4, max_len=48,
                        chunk_size=8), "shared", 1),
}


def _run_lockstep(model, kw, prompts_kind, stagger):
    jc, tc, jp, tp = model
    engines = {
        "jax": jserving.ContinuousBatchingEngine(
            jc, jp, use_paged_kernel=True, **kw),
        "torch": tserving.ContinuousBatchingEngine(
            tc, tp, use_paged_kernel=True, device="cpu", **kw)}
    prompts = (_prompts(jc.vocab) if prompts_kind == "plain"
               else _shared_prefix_prompts(jc.vocab))
    reqs = {k: [] for k in engines}
    ids = {k: {} for k in engines}

    def add(i):
        for k, eng in engines.items():
            pk = PACKAGES[k]
            r = eng.add_request(prompts[i],
                                pk.SamplingParams(max_new_tokens=6))
            reqs[k].append(r)
            ids[k][r.req_id] = i

    def snapshot(k):
        eng = engines[k]
        pool = eng.pool_host
        log = [(s, ids[k][rid], kind, n) for s, rid, kind, n
               in eng.dispatch_log]
        tables = sorted((ids[k][s.req_id], tuple(pool.page_table(s.req_id)))
                        for s in eng.running.values())
        return (log, tables, dataclasses.asdict(pool.stats()),
                [list(r.output_tokens) for r in reqs[k]],
                [r.state.value for r in reqs[k]])

    pending = list(range(len(prompts)))
    if not stagger:
        while pending:
            add(pending.pop(0))
    steps = 0
    while pending or any(e.has_work() for e in engines.values()):
        if pending and (stagger == 0 or steps % 3 == 0):
            add(pending.pop(0))
        for eng in engines.values():
            eng.step()
        steps += 1
        assert snapshot("torch") == snapshot("jax"), f"step {steps}"
        assert steps < 500
    for k, eng in engines.items():
        eng.pool_host.check_invariants()
        assert eng.pool_host.free_pages == eng.pool_host.n_pages - 1
    return engines, reqs


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_engine_greedy_tokens_identical_to_reference(model, trace):
    kw, prompts_kind, stagger = TRACES[trace]
    engines, reqs = _run_lockstep(model, kw, prompts_kind, stagger)
    assert [r.output_tokens for r in reqs["torch"]] == \
        [r.output_tokens for r in reqs["jax"]]
    assert all(len(r.output_tokens) == 6 for r in reqs["torch"])
    ts = engines["torch"].stats
    js = engines["jax"].stats
    for key in ("mixed_steps", "decode_tokens", "prefill_tokens",
                "tokens_out", "preemptions", "prefix_hit_tokens", "cow_forks",
                "kernel_dispatches", "dense_fallbacks"):
        assert ts[key] == js[key], key
    assert ts["kernel_dispatches"] == ts["mixed_steps"]
    if trace == "preemption":
        assert ts["preemptions"] > 0
    if trace == "prefix_cow":
        assert ts["prefix_hit_tokens"] > 0 and ts["cow_forks"] > 0


def test_cancel_deadline_shed_and_trace_match_reference(model):
    """Lifecycle aborts on one trace in both engines: a request past its
    deadline times out, one that cannot be admitted within its queue-wait
    budget is shed, a running one is cancelled after draining; the rest
    finish with the same tokens, the pools end empty, and the port's trace
    brackets every engine phase."""
    jc, tc, jp, tp = model
    prompts = _prompts(jc.vocab)
    out = {}
    for k, pk in PACKAGES.items():
        eng = pk.ContinuousBatchingEngine(
            *((jc, jp) if k == "jax" else (tc, tp)), max_slots=2,
            page_size=4, max_len=48, chunk_size=8, use_paged_kernel=True,
            trace=True, **({} if k == "jax" else {"device": "cpu"}))
        sp = [pk.SamplingParams(max_new_tokens=6) for _ in prompts]
        sp[2] = pk.SamplingParams(max_new_tokens=6, deadline_s=0.0)
        sp[4] = pk.SamplingParams(max_new_tokens=6, max_queue_wait_s=0.0)
        reqs = [eng.add_request(p, s) for p, s in zip(prompts, sp)]
        eng.step()
        eng.step()
        assert eng.cancel(reqs[1].req_id)
        assert not eng.cancel(reqs[1].req_id)
        eng.run()
        eng.pool_host.check_invariants()
        assert eng.pool_host.free_pages == eng.pool_host.n_pages - 1
        out[k] = ([(r.finish_reason.value, r.output_tokens) for r in reqs],
                  {key: eng.stats[key] for key in
                   ("aborts", "timeouts", "sheds", "finished")})
        if k == "torch":
            spans = eng.tracer.span_counts()
    assert out["torch"] == out["jax"]
    reasons = [r for r, _ in out["torch"][0]]
    assert reasons == ["length", "aborted", "timeout", "length", "shed"]
    assert {"step", "plan", "admit", "dispatch", "harvest",
            "sync"} <= set(spans)


def test_generate_compat_and_not_ported_options(model):
    jc, tc, jp, tp = model
    eng = tserving.ContinuousBatchingEngine(tc, tp, max_slots=2, page_size=4,
                                            max_len=32, device="cpu")
    out = eng.generate(np.asarray([[1, 2, 3], [4, 5, 6]]),
                       tserving.GenerationConfig(max_new_tokens=3))
    assert tuple(out.shape) == (2, 3)
    # sampling at temperature > 0 is ported: a sampled request now runs
    req = eng.add_request([1, 2], tserving.SamplingParams(
        max_new_tokens=3, temperature=0.7, seed=5))
    eng.run()
    assert req.finish_reason is tserving.FinishReason.LENGTH
    assert len(req.output_tokens) == 3
    assert all(0 <= t < tc.vocab for t in req.output_tokens)
    for kw in ({"fault_injector": object()}, {"heartbeat": object()}):
        with pytest.raises(NotImplementedError):
            tserving.ContinuousBatchingEngine(tc, tp, device="cpu", **kw)
    with pytest.raises(NotImplementedError):
        eng.snapshot()


@pytest.mark.parametrize("kw", [{"quantize": "int8"},
                                {"fuse_projections": True},
                                {"quantize": "int4",
                                 "fuse_projections": True}])
def test_mesh_with_quantized_or_fused_factors_is_not_ported(model, kw):
    """Tensor parallelism serves float factors only: a mesh together with
    quantized or fused factors raises before anything is sharded."""
    from repro_torch.launch.mesh import Mesh

    _, tc, _, tp = model
    mesh = Mesh(model=2, rank=0, device="cpu")
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        tserving.ContinuousBatchingEngine(tc, tp, mesh=mesh, **kw)
