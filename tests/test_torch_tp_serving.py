"""The port's tensor-parallel serving against the JAX reference's tp = 1
engine.

The reference's own contract (tests/test_tp_serving.py) is that greedy
tokens at tp > 1 equal tp = 1.  Its tp > 1 engine gives no tokens on this
host (the vocab-sharded embedding gather raises under jax 0.9), so the
port's tp = 2 and tp = 4 engines are held against the reference's tp = 1
engine on the same params (numpy, in the reference's layout:
``tests/_torch_numpy_params.py``), in the reference's ``tp_test`` shape
(d = 128, 2 layers, 8/8 heads, d_ff = 256, vocab 512), with Monarch and
with dense linears: a plain trace, a tiny pool that preempts, a shared
prefix that forks a page copy-on-write, and int8 KV pages.

A trace whose outcome reads the clock (a cancel, deadlines, shedding;
rank 0 alone sleeps past the limits) checks that every rank still makes
the same decisions at the same step: rank 0's clock is the one every
rank reads.

Each world of ranks is spawned once per module (``launch.mesh.run_ranks``:
one process per rank over gloo on the CPU, a ``FileStore`` under
``tmp_path``), and every assertion is a test of its own.  The ranks run
the port's plain kernel versions (B7's plain version where the pool is
split, the dense gather where it is not).  Tokens are held exactly; one
mixed step's logits at 1e-5 (both sides sum in fp32, in other orders).
"""

import concurrent.futures

import jax
import numpy as np
import pytest
import torch

import _torch_tp_worker as W
from _torch_numpy_params import numpy_params
import repro.serving as jserving
from repro.core.linear import MonarchSpec as JSpec
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JConfig
from repro_torch.core.linear import MonarchSpec as TSpec
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.serving import ContinuousBatchingEngine, SamplingParams

SHAPE = dict(d_model=128, n_layers=2, n_heads=8, n_kv_heads=8, d_ff=256,
             vocab=512, dtype="float32")
LOGITS = dict(rtol=1e-5, atol=1e-5)
WORLD_TIMEOUT_S = 240
REFERENCE_THREADS = 4


def _configs(name, monarch, **over):
    shape = {**SHAPE, **over}
    jspec = JSpec(enable=monarch, min_dim=64)
    tspec = TSpec(enable=monarch, min_dim=64, backend="pallas")
    return (JConfig(name=name, monarch=jspec, **shape),
            TConfig(name=name, monarch=tspec, **shape))


def _traces(vocab):
    shared = list(range(1, 17))   # two full pages, then a COW-forcing reuse
    base = dict(max_slots=4, page_size=8, n_pages=64, max_len=64,
                use_paged_kernel=True)
    return {
        "plain": dict(engine=base, prompts=W.prompts(vocab, 4), max_new=8,
                      export=True),
        "preemption": dict(engine=dict(max_slots=3, page_size=4, n_pages=14,
                                       max_len=48, chunk_size=8,
                                       use_paged_kernel=True),
                           prompts=W.prompts(vocab, 6, 10, 16, seed=3),
                           max_new=10),
        "prefix_cow": dict(engine=base, first=shared + [99],
                           prompts=[shared + [100 + i] for i in range(3)]
                           + [shared], max_new=8),
        "int8_kv": dict(engine={**base, "kv_dtype": "int8"},
                        prompts=W.prompts(vocab, 4, seed=5), max_new=8),
        "budget": dict(engine=dict(max_slots=2, page_size=8, max_len=32,
                                   pool_bytes=1 << 20, use_paged_kernel=True),
                       prompts=W.prompts(vocab, 2, seed=2), max_new=4),
        # the compressed decode path, prepared whole and then sharded:
        # fused QKV (or K/V) and up/gate, int8 or packed-int4 factors
        "int8_fused": dict(engine={**base, "quantize": "int8",
                                   "fuse_projections": True},
                           prompts=W.prompts(vocab, 4, seed=6), max_new=8),
        "int4_fused": dict(engine={**base, "quantize": "int4",
                                   "fuse_projections": True},
                           prompts=W.prompts(vocab, 4, seed=7), max_new=8),
        "int8_fused_int8_kv": dict(
            engine={**base, "quantize": "int8", "fuse_projections": True,
                    "kv_dtype": "int8"},
            prompts=W.prompts(vocab, 4, seed=8), max_new=8),
    }


# the clock trace's (see _torch_tp_worker.drive_clock): only rank 0's
# pause passes the limits
CLOCK_TRACE = dict(engine=dict(max_slots=2, page_size=8, n_pages=64,
                               max_len=64, use_paged_kernel=True),
                   max_new=16, limit_s=3.0, pause_s=4.0, cancel_at=2,
                   pause_at=5)
CLOCK_REASONS = ["aborted", "timeout", "length", "timeout", "length", "shed",
                 "length"]


def _step_inputs():
    rng = np.random.default_rng(7)
    B, S, mpp = 3, 12, 3
    return dict(tokens=rng.integers(0, SHAPE["vocab"], (B, S)).astype(
                    np.int32),
                start=np.zeros((B,), np.int32),
                span=np.array([12, 7, 1], np.int32),
                table=(1 + np.arange(B * mpp, dtype=np.int32)).reshape(B, mpp),
                n_pages=1 + B * mpp, page_size=8)


JOBS = {
    # name: (configs, seed, traces (None: all), tp)
    "monarch": (_configs("tp_test", True), 0, None, 2),
    "dense": (_configs("tp_test_dense", False), 0,
              ("plain", "preemption", "prefix_cow", "int8_kv",
               "int8_fused"), 2),
    # GQA at tp=2: the 2 KV heads split, so the fused [k | v] splits part
    # by part, and the pool with them
    "gqa_tp2": (_configs("tp_gqa", True, n_kv_heads=2), 1,
                ("int8_fused",), 2),
    # tp=4: MHA through B7 on 2 heads a rank; GQA whose 2 KV heads the
    # axis does not divide: the pool (and a fused wkv) stays whole on
    # every rank
    "monarch_tp4": (_configs("tp_test", True), 0, ("plain", "preemption"), 4),
    "gqa_tp4": (_configs("tp_gqa", True, n_kv_heads=2), 1,
                ("plain", "prefix_cow", "int8_fused"), 4),
    # dense GQA: the fused wqkv is [q | k | v] at 8 : 2 : 2 heads (int8
    # leaves dense weights float); its KV heads split at tp=2, stay whole
    # at tp=4
    "dense_gqa_tp2": (_configs("tp_gqa_dense", False, n_kv_heads=2), 1,
                      ("int8_fused",), 2),
    "dense_gqa_tp4": (_configs("tp_gqa_dense", False, n_kv_heads=2), 1,
                      ("int8_fused",), 4),
}
# jobs whose KV heads the axis does not divide: the pool stays whole
WHOLE_POOL = ("gqa_tp4", "dense_gqa_tp4")


@pytest.fixture(scope="module")
def setup():
    """Each job's configs, numpy params in the reference's layout (drawn
    once a (config, seed): ``tests/_torch_numpy_params.py``) and traces."""
    out, drawn = {}, {}
    for job, ((jcfg, tcfg), seed, names, tp) in JOBS.items():
        if (jcfg, seed) not in drawn:
            drawn[jcfg, seed] = numpy_params(jcfg, seed)
        traces = _traces(tcfg.vocab)
        names = names or tuple(traces)
        out[job] = (jcfg, tcfg, drawn[jcfg, seed],
                    {n: traces[n] for n in names}, tp)
    return out


def _reference_trace(jcfg, jp, tr):
    eng = jserving.ContinuousBatchingEngine(jcfg, jp, **tr["engine"])
    return {"tokens": W.drive(eng, jserving.SamplingParams, tr),
            "stats": {k: eng.stats[k] for k in W.STAT_KEYS},
            "n_pages": eng.pool_host.n_pages}


_jmixed_step = jax.jit(JT.paged_mixed_step, static_argnums=6)


def _reference_step(jcfg, jp):
    st = _step_inputs()
    pool = JT.init_paged_pool(jcfg, st["n_pages"], st["page_size"])
    lg, _ = _jmixed_step(jp, st["tokens"], st["start"], st["span"],
                         st["table"], pool, jcfg)
    return np.asarray(lg)


def _reference(setup):
    """The JAX reference's tp = 1 engine on every job's traces, and one
    mixed step's logits.  A trace of a (config, params, trace) already
    run for another job is reused; the rest run on REFERENCE_THREADS
    threads (each its own engine; XLA compiles outside the GIL)."""
    runs, tasks = {}, {}
    for job, (jcfg, _, np_params, traces, _) in setup.items():
        for name in (*traces, "step_logits"):
            key = (jcfg, id(np_params), name)
            runs[job, name] = key
            tasks.setdefault(key, (jcfg, np_params, traces.get(name)))
    device = {}
    for jcfg, np_params, _ in tasks.values():
        if id(np_params) not in device:
            device[id(np_params)] = jax.tree_util.tree_map(
                jax.numpy.asarray, np_params)

    def run(key):
        jcfg, np_params, tr = tasks[key]
        jp = device[id(np_params)]
        return (_reference_step(jcfg, jp) if tr is None
                else _reference_trace(jcfg, jp, tr))

    with concurrent.futures.ThreadPoolExecutor(REFERENCE_THREADS) as pool:
        done = dict(zip(tasks, pool.map(run, tasks)))
    out: dict = {}
    for (job, name), key in runs.items():
        out.setdefault(job, {})[name] = done[key]
    return out


def _world(setup, tp, workdir):
    jobs = {job: (tcfg, np_params, traces, _step_inputs())
            for job, (_, tcfg, np_params, traces, t) in setup.items()
            if t == tp}
    if tp == 2:
        _, tcfg, np_params, _, _ = setup["monarch"]
        clock = dict(CLOCK_TRACE, prompts=W.prompts(tcfg.vocab, 7, seed=9))
        jobs["clock"] = (tcfg, np_params, {"clock": clock}, None)
    return jobs, run_ranks(W.serve_jobs, tp, backend="gloo", device="cpu",
                           args=(jobs,), timeout_s=WORLD_TIMEOUT_S,
                           workdir=workdir)


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """Every job's ranks (one world per tp, each spawned once) and the
    reference's runs.  The worlds' processes run while this process runs
    the reference."""
    tps = sorted({s[4] for s in setup.values()})
    with concurrent.futures.ThreadPoolExecutor(len(tps)) as pool:
        futs = [pool.submit(_world, setup, tp,
                            tmp_path_factory.mktemp(f"tp{tp}"))
                for tp in tps]
        ref = _reference(setup)
        worlds = {}
        for tp, fut in zip(tps, futs):
            jobs, ranks = fut.result()
            for job in jobs:
                worlds[job] = [r[job] for r in ranks]
            worlds[f"modules_tp{tp}"] = [r["jax_or_reference_loaded"]
                                         for r in ranks]
    return worlds, ref


@pytest.fixture(scope="module")
def worlds(runs):
    return runs[0]


@pytest.fixture(scope="module")
def reference(runs):
    return runs[1]


CASES = [(job, name) for job, (_, _, names, _) in JOBS.items()
         for name in (names or tuple(_traces(SHAPE["vocab"])))]


@pytest.mark.parametrize("job,trace", CASES)
def test_greedy_tokens_equal_reference_tp1(worlds, reference, job, trace):
    want = reference[job][trace]["tokens"]
    for r, res in enumerate(worlds[job]):
        assert res[trace]["tokens"] == want, f"rank {r}"
    assert all(len(t) > 0 for t in want)


@pytest.mark.parametrize("job,trace", CASES)
def test_every_rank_plans_and_counts_alike(worlds, reference, job, trace):
    """Replicated host loops agree: every rank's counters equal rank 0's,
    and the scheduling counters equal the reference's at tp = 1."""
    ranks = [res[trace] for res in worlds[job]]
    for res in ranks[1:]:
        assert res["stats"] == ranks[0]["stats"]
        assert res["n_pages"] == ranks[0]["n_pages"]
    want = reference[job][trace]["stats"]
    for key in ("mixed_steps", "decode_tokens", "prefill_tokens",
                "tokens_out", "preemptions", "prefix_hit_tokens",
                "cow_forks"):
        assert ranks[0]["stats"][key] == want[key], key
    if trace == "preemption":
        assert want["preemptions"] > 0, "setup no longer forces preemption"
    if trace == "prefix_cow":
        assert want["prefix_hit_tokens"] > 0 and want["cow_forks"] > 0


@pytest.mark.parametrize("job", [j for j in JOBS if j not in WHOLE_POOL])
def test_split_pool_runs_the_sharded_kernel_every_step(worlds, job):
    for res in worlds[job]:
        for trace, r in res.items():
            if trace == "step_logits":
                continue
            st = r["stats"]
            assert st["kernel_dispatches"] == st["mixed_steps"] > 0, trace
            assert st["dense_fallbacks"] == 0, trace
            assert r["kv_shard"] == r["tp"] == JOBS[job][3]
            heads = JOBS[job][0][1].n_kv_heads // r["tp"]
            assert set(r["local_heads"].values()) == {heads}


def test_gqa_pool_stays_whole_while_weights_split(worlds):
    """n_kv_heads = 2 at tp = 4: the pool is whole on every rank and
    attention takes the dense gather ("gqa_replicated" every step), while
    the query heads, the FFN and the vocab still split."""
    hd = SHAPE["d_model"] // SHAPE["n_heads"]
    for res in worlds["gqa_tp4"]:
        for trace in ("plain", "prefix_cow", "int8_fused"):
            r = res[trace]
            st = r["stats"]
            assert r["tp"] == 4 and r["kv_shard"] == 1
            assert st["kernel_dispatches"] == 0
            assert st["dense_fallback_gqa_replicated"] == \
                st["mixed_steps"] > 0
            assert set(r["local_heads"].values()) == {2}
            assert r["local_out"]["wq"] == 2 * hd          # 8 heads / 4
            if trace == "int8_fused":                      # whole [k | v]
                assert r["local_out"]["wkv"] == 2 * 2 * hd
            else:
                assert r["local_out"]["wk"] == 2 * hd      # whole: 2 KV
            assert r["local_out"]["wo"] == SHAPE["d_model"]


def test_fused_factors_split_part_by_part(worlds):
    """A rank's fused projection is each part's slice side by side: at
    tp = 2 the MHA ``wqkv`` holds 4 of each of q, k and v's 8 heads, the
    GQA ``wkv`` 1 of each of k and v's 2, the FFN's ``w1g`` half of up and
    half of gate; a dense GQA ``wqkv`` cuts each part at its own width."""
    hd = SHAPE["d_model"] // SHAPE["n_heads"]
    for res in worlds["monarch"]:
        for trace in ("int8_fused", "int4_fused", "int8_fused_int8_kv"):
            out = res[trace]["local_out"]
            assert out["wqkv"] == 3 * 4 * hd and out["wo"] == SHAPE[
                "d_model"]
            assert res[trace]["ffn_out"]["w1g"] == SHAPE["d_ff"]
    for res in worlds["gqa_tp2"]:
        out = res["int8_fused"]["local_out"]
        assert out["wq"] == 4 * hd and out["wkv"] == 2 * hd
        assert res["int8_fused"]["kv_shard"] == 2
    # dense GQA [q | k | v]: 4 + 1 + 1 heads at tp = 2, 2 + 2 + 2 at tp =
    # 4 (the KV heads whole)
    for job, kv_shard in (("dense_gqa_tp2", 2), ("dense_gqa_tp4", 1)):
        for res in worlds[job]:
            assert res["int8_fused"]["local_out"]["wqkv"] == 6 * hd
            assert res["int8_fused"]["kv_shard"] == kv_shard


@pytest.mark.parametrize("job", list(JOBS))
def test_one_mixed_step_logits_match_reference(worlds, reference, job):
    want = reference[job]["step_logits"]
    for res in worlds[job]:
        np.testing.assert_allclose(res["step_logits"].numpy(), want,
                                   **LOGITS)


def test_pool_budget_is_per_shard(worlds, setup):
    """A fixed pool_bytes is ONE rank's memory: at tp = 2 the engine holds
    ~2x the logical pages of the tp = 1 engine."""
    _, tcfg, np_params, traces, tp = setup["monarch"]
    from repro_torch.convert import params_from_numpy

    e1 = ContinuousBatchingEngine(tcfg, params_from_numpy(
        np_params, device="cpu"), device="cpu", **traces["budget"]["engine"])
    for res in worlds["monarch"]:
        r = res["budget"]
        assert r["pool_kv_shard"] == tp
        assert r["n_pages"] >= tp * (e1.pool_host.n_pages - 1)
        assert r["shard_page_bytes"] * tp == r["page_bytes"]


def test_export_gathers_every_rank_and_loads_back(worlds, setup):
    """``DeviceKV.export`` gathers the KV heads of every rank into one host
    tree, ``load`` slices it back, and the gathered pool holds what the
    tp = 1 engine's pool holds after the same trace."""
    _, tcfg, np_params, traces, _ = setup["monarch"]
    from repro_torch.convert import params_from_numpy

    e1 = ContinuousBatchingEngine(tcfg, params_from_numpy(
        np_params, device="cpu"), device="cpu", **traces["plain"]["engine"])
    W.drive(e1, SamplingParams, traces["plain"])
    want = e1.pool["layers"]["attn"]
    for res in worlds["monarch"]:
        ex = res["plain"]["export"]
        assert ex["round_trip"] and ex["local_equals_slice"]
        got = ex["pool"]["layers"]["attn"]
        for k in want:   # page 0 is the sink padding writes land on
            assert got[k].shape == want[k].shape
            np.testing.assert_allclose(got[k][:, 1:].numpy(),
                                       want[k][:, 1:].numpy(), **LOGITS)


def test_clock_decisions_agree_on_every_rank(worlds):
    """Cancel, deadlines and shedding under tensor parallelism: every rank
    gives the same finish reasons, tokens and lifecycle counters, though
    only rank 0's own clock passed the limits."""
    ranks = [res["clock"] for res in worlds["clock"]]
    for res in ranks[1:]:
        assert res["tokens"] == ranks[0]["tokens"]
        assert res["stats"] == ranks[0]["stats"]
        assert res["n_pages"] == ranks[0]["n_pages"]


def test_clock_trace_cancels_times_out_and_sheds(worlds):
    """The trace reaches every clock decision it is there to test."""
    res = worlds["clock"][0]["clock"]
    assert [r for r, _ in res["tokens"]] == CLOCK_REASONS
    st = res["stats"]
    assert (st["aborts"], st["timeouts"], st["sheds"]) == (1, 2, 1)
    assert st["finished"] == len(CLOCK_REASONS)
    n = [len(t) for _, t in res["tokens"]]
    full = CLOCK_TRACE["max_new"]
    assert n[2] == n[4] == n[6] == full
    assert 0 < n[0] < full and 0 < n[1] < full
    assert n[3] == n[5] == 0


@pytest.mark.parametrize("tp", [2, 4])
def test_ranks_load_no_jax_and_no_reference(worlds, tp):
    assert worlds[f"modules_tp{tp}"] == [[]] * tp


def test_tp_engine_refuses_what_is_not_ported():
    from repro_torch.launch.mesh import Mesh, make_host_mesh

    # the "data" axis is training's: the engine refuses it (its
    # data-parallel serving is the replica router), a rank outside the
    # data x model world is refused
    mesh = Mesh(model=2, rank=3, data=2, device="cpu")
    assert (mesh.data_rank, mesh.model_rank) == (1, 1)
    with pytest.raises(ValueError, match="data"):
        ContinuousBatchingEngine(_configs("tp_test", True)[1], {}, mesh=mesh)
    with pytest.raises(ValueError, match="rank"):
        Mesh(model=2, rank=4, data=2, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        make_host_mesh(model=2, rank=0, backend="mpi", store=None,
                       device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        make_host_mesh(model=2, rank=0, backend="nccl", store=None,
                       device="cpu")
    with pytest.raises(ValueError, match="rank"):
        Mesh(model=2, rank=2, device="cpu")


def test_tp_engine_runs_only_on_a_joined_mesh_on_its_device():
    """A mesh's device resolves like every entry point's (``cuda`` unless
    the CPU is named), and the engine serves only on a mesh that joined
    its world: a mesh built from shapes alone is refused, never served on
    a device the caller did not ask for."""
    from repro_torch.launch.mesh import Mesh

    tcfg = _configs("tp_test", True)[1]
    assert Mesh(model=2, device="cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        assert Mesh(model=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Mesh(model=2)
    with pytest.raises(ValueError, match="process group"):
        ContinuousBatchingEngine(tcfg, {}, mesh=Mesh(model=2, device="cpu"))
    with pytest.raises((RuntimeError, ValueError)):   # no CUDA / no group
        ContinuousBatchingEngine(tcfg, {}, mesh=Mesh(model=2, rank=0))
