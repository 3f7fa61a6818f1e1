"""The port's step-pricing models (``HBMCostModel``, ``CIMCostModel``) and
the plans they drive, against the reference's, on the CPU.

Both models are copies of the reference's and price through copies of its
CIM stack, so every method is held to 1e-12 relative (in practice equal)
on each ported configuration x KV page dtype x tp in {1, 2}, with and
without the paged kernel's pricing.  The port's scheduler then plans the
same spans and chunks as the reference's on the budgeted plans of
``tests/test_serving.py:435-476`` and under each real model with a budget
that binds, and the port's engine on the CPU records the same predicted
nanoseconds for each step as the reference's engine
(``tests/test_telemetry.py:405``)."""

import dataclasses
import math

import jax
import numpy as np
import pytest

import repro.serving as jserving
import repro_torch.serving as tserving
from repro.configs import get_config as jget_config
from repro.core.quant import quantize_tree as jquantize_tree
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from repro.serving.kv_pool import PagedKVPool as JPagedKVPool
from repro.serving.request import (Request as JRequest,
                                   RequestState as JRequestState,
                                   SamplingParams as JSamplingParams,
                                   Sequence as JSequence)
from _torch_numpy_params import both
from repro_torch.configs import PORTED_ARCHS
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.quant import quantize_tree as tquantize_tree
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.serving.kv_pool import PagedKVPool as TPagedKVPool
from repro_torch.serving.request import (Request as TRequest,
                                         RequestState as TRequestState,
                                         SamplingParams as TSamplingParams,
                                         Sequence as TSequence)

REL = 1e-12
KV_BITS = {"fp32": 32, "bf16": 16, "int8": 8}
# the small stack of tests/test_telemetry.py and tests/test_serving.py
SMALL = dict(name="t", d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, vocab=256, dtype="float32")
DECODES = [(1, 1.0), (3, 17.5), (8, 512.0), (64, 4096.0)]
PREFILLS = [(1, 0), (64, 0), (64, 63), (512, 100), (16, 16)]


def _close(a, b) -> bool:
    return math.isclose(a, b, rel_tol=REL, abs_tol=0.0)


def _same_prices(t, j) -> None:
    """Every pricing method of two cost models, on one grid."""
    for n, ctx in DECODES:
        assert _close(t.decode_step_ns(n, ctx), j.decode_step_ns(n, ctx))
        assert _close(t.decode_step_nj(n, ctx), j.decode_step_nj(n, ctx))
        tb = t.shard_decode_bytes_per_token(ctx, n_seqs=n)
        jb = j.shard_decode_bytes_per_token(ctx, n_seqs=n)
        assert sorted(tb) == sorted(jb)
        assert all(_close(tb[k], jb[k]) for k in jb), (tb, jb)
    for n, cached in PREFILLS:
        assert _close(t.prefill_ns(n, cached_tokens=cached),
                      j.prefill_ns(n, cached_tokens=cached))
        assert _close(t.prefill_nj(n, cached_tokens=cached),
                      j.prefill_nj(n, cached_tokens=cached))


# ---------------------------------------------------------------------------
# prices: each ported config x KV dtype x tp x paged kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("kv_dtype", sorted(KV_BITS))
@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_hbm_prices_identical(arch, kv_dtype, tp, paged):
    kw = dict(kv_dtype=kv_dtype, tp=tp, paged_kernel=paged,
              kv_gather_overhead=1.0)
    t = tserving.HBMCostModel.from_model_config(tget_config(arch), **kw)
    j = jserving.HBMCostModel.from_model_config(jget_config(arch), **kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert _close(tserving.scheduler.tp_allreduce_bytes_per_token(
        tget_config(arch), tp), jserving.scheduler.tp_allreduce_bytes_per_token(
        jget_config(arch), tp))
    _same_prices(t, j)
    assert isinstance(t, tserving.CostModel)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("kv_dtype", sorted(KV_BITS))
@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_cim_prices_identical(arch, kv_dtype, tp, paged):
    kw = dict(kv_bits=KV_BITS[kv_dtype], tp=tp, paged_kernel=paged,
              kv_gather_overhead=1.0)
    try:
        j = jserving.CIMCostModel(jget_config(arch), **kw)
    except ValueError as e:   # the reference's own refusal, e.g. a Mamba
        # stack's d_ff = 0 FFN: the port refuses it alike
        with pytest.raises(ValueError, match=str(e)):
            tserving.CIMCostModel(tget_config(arch), **kw)
        return
    t = tserving.CIMCostModel(tget_config(arch), **kw)
    for attr in ("strategy", "per_token_ns", "per_token_nj", "kv_bits",
                 "attn_dpu_ns_per_key", "weight_bits", "tp", "kv_shard",
                 "reduce_bus_gbps", "allreduce_bytes_per_token",
                 "paged_kernel", "kv_gather_overhead"):
        assert getattr(t, attr) == getattr(j, attr), attr
    _same_prices(t, j)
    assert isinstance(t, tserving.CostModel)


@pytest.mark.parametrize("options", [
    dict(strategy="linear"), dict(strategy="dense"),
    dict(strategy="sparse", weight_bits=4, fused_proj=True),
    dict(strategy="sparse", seq_len=64, attn_dpu_ns_per_key=0.2),
])
def test_cim_options_identical(options):
    t = tserving.CIMCostModel(tget_config("gpt2-medium"), **options)
    j = jserving.CIMCostModel(jget_config("gpt2-medium"), **options)
    assert (t.per_token_ns, t.per_token_nj) == (j.per_token_ns,
                                                j.per_token_nj)
    _same_prices(t, j)


@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_hbm_from_params_identical(arch, bits):
    """Weight bytes priced from the actual tree: fp32 factors, or int8 /
    packed int4 containers.  The tree is the reference's layout drawn with
    numpy (``tests/_torch_numpy_params.py``): the prices read only its
    shapes and dtypes, and the reference's own initializer takes 5-25 s a
    model here for the MoE and Mamba stacks."""
    jc, tc = jget_config(arch).reduced(), tget_config(arch).reduced()
    jp, tp_ = both(jc)
    if bits is not None:
        jp, tp_ = jquantize_tree(jp, bits), tquantize_tree(tp_, bits)
    t = tserving.HBMCostModel.from_params(tc, tp_, kv_dtype="int8",
                                          bandwidth_gbps=3350.0)
    j = jserving.HBMCostModel.from_params(jc, jp, kv_dtype="int8",
                                          bandwidth_gbps=3350.0)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    _same_prices(t, j)


# ---------------------------------------------------------------------------
# the plans a budget makes
# ---------------------------------------------------------------------------


class _FlatCost:
    """tests/test_serving.py:437's model: 10 ns a decode, 1 a token."""

    def decode_step_ns(self, n, ctx):
        return 10.0 * n

    def prefill_ns(self, n, cached_tokens=0):
        return 1.0 * n

    def decode_step_nj(self, n, ctx):
        return 0.0

    def prefill_nj(self, n, cached_tokens=0):
        return 0.0


class _HugeCost(_FlatCost):
    """tests/test_serving.py:461's model: every step far over budget."""

    def decode_step_ns(self, n, ctx):
        return 1e9

    def prefill_ns(self, n, cached_tokens=0):
        return 1e9


PKG = {"reference": (jserving, JPagedKVPool, JRequest, JRequestState,
                     JSamplingParams, JSequence, JModelConfig),
       "port": (tserving, TPagedKVPool, TRequest, TRequestState,
                TSamplingParams, TSequence, TModelConfig)}


def _plan(pkg: str, cost, budget, chunk, decodes: int, prefills: int,
          waiting: list[int]):
    """One ``plan_step`` of package ``pkg``: ``decodes`` RUNNING and
    ``prefills`` PREFILLING sequences resident (8 of 32 prompt tokens
    computed), ``waiting`` prompt lengths queued; the plan as
    (kind, prompt length, tokens) rows."""
    sv, Pool, Req, State, Sampling, Seq, _ = PKG[pkg]
    pool = Pool(n_pages=64, page_size=8)
    running = []
    for i in range(decodes + prefills):
        plen = 8 if i < decodes else 32
        req = Req(prompt=list(range(100 * i, 100 * i + plen)),
                  sampling=Sampling(max_new_tokens=8))
        req.state = State.RUNNING if i < decodes else State.PREFILLING
        req.num_computed_tokens = 8
        running.append(Seq(request=req, slot=i,
                           page_ids=pool.allocate(req.req_id, 8),
                           prefill_target=plen, admit_order=i))
    queue = [Req(prompt=list(range(1000 * (i + 1), 1000 * (i + 1) + n)),
                 sampling=Sampling(max_new_tokens=8))
             for i, n in enumerate(waiting)]
    sc = sv.SchedulerConfig(max_slots=8, chunk_size=chunk,
                            step_latency_budget_ns=budget)
    plan = sv.IterationScheduler(sc, cost).plan_step(queue, running, pool)
    return ([("span", len(s.request.prompt), n) for s, n in plan.spans]
            + [("admit", len(r.prompt), n) for r, n in plan.admissions]
            + [("preempt", len(s.request.prompt), 0)
               for s in plan.preemptions])


def _models(kind: str):
    if kind == "flat":
        return _FlatCost(), _FlatCost()
    if kind == "huge":
        return _HugeCost(), _HugeCost()
    cfgs = [PKG[p][6](**SMALL) for p in ("reference", "port")]
    if kind == "hbm":
        return tuple(PKG[p][0].HBMCostModel.from_model_config(c)
                     for p, c in zip(("reference", "port"), cfgs))
    return tuple(PKG[p][0].CIMCostModel(c, strategy="sparse", seq_len=64)
                 for p, c in zip(("reference", "port"), cfgs))


@pytest.mark.parametrize("case", [
    # tests/test_serving.py:448: a 32-token chunk would cost 42 > 26
    ("flat", 26.0, 32, 1, 0, [32]),
    # tests/test_serving.py:467: minimum progress beats the SLO
    ("huge", 1.0, 64, 0, 0, [8]),
    ("flat", 40.0, 16, 2, 1, [32, 24, 8]),
    ("hbm", None, 64, 2, 1, [64, 40]),
    ("cim", None, 64, 2, 1, [64, 40]),
])
def test_budgeted_plans_identical(case):
    kind, budget, chunk, decodes, prefills, waiting = case
    jcost, tcost = _models(kind)
    if budget is None:
        # two decodes and ~5 prefill tokens: the budget binds
        budget = jcost.decode_step_ns(2, 8.0) + jcost.prefill_ns(5)
    want = _plan("reference", jcost, budget, chunk, decodes, prefills,
                 waiting)
    got = _plan("port", tcost, budget, chunk, decodes, prefills, waiting)
    assert got == want
    unbudgeted = _plan("port", tcost, None, chunk, decodes, prefills, waiting)
    assert (got != unbudgeted) == (kind != "huge")
    if kind == "flat" and chunk == 32:
        assert [n for k, _, n in got if k == "admit"] == [16]


# ---------------------------------------------------------------------------
# the engines: predicted ns per step, and a budgeted serve's chunks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_params():
    jp = JT.init_params(jax.random.PRNGKey(0), PKG["reference"][6](**SMALL))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


def _shared_prefix_prompts(n=4, prefix_len=16, tail=3):
    """tests/test_telemetry.py's prompts: a shared 16-token prefix."""
    sys_p = list(np.random.default_rng(40).integers(0, SMALL["vocab"],
                                                    prefix_len))
    return [np.asarray(sys_p + [(17 * i + j) % SMALL["vocab"]
                                for j in range(tail + i % 2)], np.int32)
            for i in range(n)]


def _run_contended(pkg: str, params, cost, budget=None):
    """tests/test_telemetry.py:276's run (a starved pool: preemption,
    copy-on-write and resume), with ``cost`` and an optional budget: the
    tokens, each step's predicted ns, and the spans (step, request,
    kind, tokens)."""
    sv = PKG[pkg][0]
    cfg = PKG[pkg][6](**SMALL)
    kw = dict(device="cpu") if pkg == "port" else {}
    sc = sv.SchedulerConfig(max_slots=4, chunk_size=8,
                            step_latency_budget_ns=budget)
    eng = sv.ContinuousBatchingEngine(
        cfg, params, max_slots=4, page_size=4, max_len=48, n_pages=11,
        scheduler_cfg=sc, cost_model=cost, **kw)
    reqs = []
    for p in _shared_prefix_prompts():
        reqs.append(eng.add_request(p, PKG[pkg][4](max_new_tokens=6)))
        eng.step()
    eng.run()
    eng.pool_host.check_invariants()
    index = {r.req_id: i for i, r in enumerate(reqs)}
    return ([list(r.output_tokens) for r in reqs], eng.calibration.predicted,
            [(s, index[rid], kind, n) for s, rid, kind, n in eng.dispatch_log],
            {k: eng.stats[k] for k in ("mixed_steps", "preemptions",
                                       "prefix_hit_tokens", "cow_forks",
                                       "sim_latency_ns", "sim_energy_nj")})


@pytest.mark.parametrize("kind", ["hbm", "cim"])
@pytest.mark.parametrize("budgeted", [False, True])
def test_engine_predictions_and_chunks_identical(small_params, kind,
                                                 budgeted):
    jcost, tcost = _models(kind)
    budget = (jcost.decode_step_ns(2, 8.0) + jcost.prefill_ns(3)
              if budgeted else None)
    jtok, jpred, jlog, jstats = _run_contended("reference", small_params[0],
                                               jcost, budget)
    ttok, tpred, tlog, tstats = _run_contended("port", small_params[1],
                                               tcost, budget)
    assert ttok == jtok
    assert tlog == jlog
    assert len(tpred) == len(jpred) == tstats["mixed_steps"] > 0
    assert all(_close(a, b) for a, b in zip(tpred, jpred))
    assert {k: v for k, v in tstats.items() if not k.startswith("sim_")} \
        == {k: v for k, v in jstats.items() if not k.startswith("sim_")}
    assert all(_close(tstats[k], jstats[k])
               for k in ("sim_latency_ns", "sim_energy_nj"))
    assert tstats["preemptions"] > 0 and tstats["prefix_hit_tokens"] > 0
    if budgeted:
        # the budget shrank some prefill chunk below chunk_size
        assert any(k == "prefill" and 0 < n < 8 for _, _, k, n in tlog)
