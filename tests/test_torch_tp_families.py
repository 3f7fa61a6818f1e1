"""Tensor parallelism for every family of the port, against the JAX
reference's tp = 1 runs and the port's own tp = 1 runs.

The reference splits the stacked experts, the Mamba leaves, the encoder
and the cross-attention over its ``"model"`` axis
(``repro/sharding/params.py``); its tp > 1 runs give no tokens on this
host (``tests/test_torch_tp_serving.py``), so the port's tp = 2 ranks are
held to its tp = 1 runs on the same numpy params
(``tests/_torch_numpy_params.py``), at ``.reduced()`` widths:

* (a) granite-moe-1b-a400m and qwen2-moe-a2.7b (64 slots over 4 experts:
  padded slots; one shared expert), and qwen2-moe with int8 factors and
  fused projections, through the continuous-batching engine: greedy
  tokens equal the reference's, one mixed step's fp32 logits within
  ``PARITY`` (1e-5) of the port's tp = 1, every MoE route identical, and
  each rank holding exactly its ``n_slots / 2`` slots;
* (b) seamless-m4t-large-v2's and internvl2-76b's text streams through
  the engine: tokens equal the reference's;
* (c) mamba2-2.7b, zamba2-7b and seamless-m4t-large-v2 (with
  ``enc_out``) through ``make_prefill_step`` / ``make_decode_step`` (the
  prompt token by token, then 8 greedy steps): logits within 1e-5 of
  tp = 1, tokens equal the reference's steps, each rank's ``conv`` /
  ``ssm`` states put back together within 1e-5 of tp = 1's; internvl2's
  patch prefill; and a zamba2 with one KV head, whose ring (and K/V
  projections) stay whole on every rank while its query heads split.

One 2-rank world (``launch.mesh.run_ranks``, gloo on the CPU, one thread a
rank) runs every job while this process runs the reference's on threads
and the port's tp = 1 runs.  The ``tp_plan`` tests need no ranks: every
config at full width (shapes only, ``FakeTensorMode``) is planned at tp =
2 and 4, and the reduced trees' slices are put back together.
"""

import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import _torch_tp_families_worker as W
import repro.serving as jserving
from _torch_numpy_params import numpy_params
from repro.configs import get_config as jget_config
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro_torch import tree_map
from repro_torch.configs import PORTED_ARCHS
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.models import transformer as TT
from repro_torch.models.decode_path import prepare_decode_params
from repro_torch.sharding.params import (_leaves, shard_params, split_parts,
                                         tp_plan)

TP = 2
PARITY = 1e-5                                # relative, fp32 logits
LOGITS = dict(rtol=1e-4, atol=1e-4)          # tests/test_torch_models.py
WORLD_TIMEOUT_S = 300
# the reference's runs on 2 threads and the port's tp = 1 run on one, so
# that the fixture adds few busy cores to tier-1's workers
REFERENCE_THREADS = 2
GRANITE, QWEN = "granite-moe-1b-a400m", "qwen2-moe-a2.7b"
MAMBA, ZAMBA = "mamba2-2.7b", "zamba2-7b"
SEAMLESS, INTERNVL = "seamless-m4t-large-v2", "internvl2-76b"


def _cfgs(arch, **over):
    """(jax cfg, torch cfg) at ``.reduced()``, the kernels on (their plain
    versions here)."""
    out = []
    for get in (jget_config, tget_config):
        c = get(arch).reduced()
        out.append(dataclasses.replace(
            c, paged_kernel=True,
            monarch=dataclasses.replace(c.monarch, backend="pallas"),
            **over))
    return out


ENGINE = dict(max_slots=2, page_size=4, max_len=48, chunk_size=4,
              use_paged_kernel=True)
INT8_FUSED = dict(quantize="int8", fuse_projections=True)


def _step_inputs(vocab):
    rng = np.random.default_rng(7)
    B, S, mpp = 3, 12, 3
    return dict(tokens=rng.integers(0, vocab, (B, S)).astype(np.int32),
                start=np.zeros((B,), np.int32),
                span=np.array([12, 7, 1], np.int32),
                table=(1 + np.arange(B * mpp, dtype=np.int32)).reshape(
                    B, mpp),
                n_pages=1 + B * mpp, page_size=8)


# name: (arch, config overrides, engine options)
ENGINE_JOBS = {
    "granite_moe": (GRANITE, {}, {}),
    "qwen2_moe": (QWEN, {}, {}),
    "qwen2_moe_int8_fused": (QWEN, {}, INT8_FUSED),
    "seamless_text": (SEAMLESS, {}, {}),
    "internvl2_text": (INTERNVL, {}, {}),
}
MOE_JOBS = [j for j, (a, _, _) in ENGINE_JOBS.items() if a in (GRANITE,
                                                              QWEN)]
# name: (arch, config overrides, new tokens, inputs)
STEP_JOBS = {
    "mamba2_steps": (MAMBA, {}, 8, ()),
    "zamba2_steps": (ZAMBA, {}, 8, ()),
    "seamless_steps": (SEAMLESS, {}, 8, ("enc_embeds",)),
    "internvl2_patch_prefill": (INTERNVL, {}, 0, ("patch_embeds",)),
    # one KV head on a 2-way axis: the query heads split, the ring and
    # the K/V projections stay whole (the designed difference from the
    # reference's sequence-split ring)
    "zamba2_whole_ring": (ZAMBA, {"n_kv_heads": 1}, 8, ()),
}
REFERENCE_STEPS = ("mamba2_steps", "zamba2_steps", "seamless_steps")
SSM_JOBS = ("mamba2_steps", "zamba2_steps", "zamba2_whole_ring")


@functools.lru_cache(maxsize=None)
def _model(arch, over=()):
    """(jax cfg, torch cfg, numpy params), drawn once."""
    jc, tc = _cfgs(arch, **dict(over))
    return jc, tc, numpy_params(jc, 0)


def _jobs() -> dict:
    jobs = {}
    for name, (arch, over, opts) in ENGINE_JOBS.items():
        _, tc, npp = _model(arch, tuple(over.items()))
        jobs[name] = dict(kind="engine", cfg=tc, params=npp,
                          engine={**ENGINE, **opts},
                          prompts=W.prompts(tc.vocab, 4, 3, 5, seed=1),
                          max_new=5, step=_step_inputs(tc.vocab))
    for name, (arch, over, new, extra) in STEP_JOBS.items():
        _, tc, npp = _model(arch, tuple(over.items()))
        rng = np.random.default_rng(3)
        job = dict(kind="steps", cfg=tc, params=npp, new=new,
                   tokens=rng.integers(0, tc.vocab, (2, 8)).astype(np.int32))
        for k in extra:
            n = 6 if k == "enc_embeds" else tc.n_frontend_tokens
            job[k] = rng.standard_normal((2, n, tc.d_model)).astype(
                np.float32)
        jobs[name] = job
    return jobs


# ---------------------------------------------------------------------------
# the reference's tp = 1 runs
# ---------------------------------------------------------------------------


def _reference_engine(name, job):
    arch, over, opts = ENGINE_JOBS[name]
    jc, _, npp = _model(arch, tuple(over.items()))
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    eng = jserving.ContinuousBatchingEngine(jc, jp, **job["engine"])
    sp = jserving.SamplingParams(max_new_tokens=job["max_new"])
    reqs = [eng.add_request(np.asarray(p), sp) for p in job["prompts"]]
    eng.run()
    return [list(r.output_tokens) for r in reqs]


def _reference_steps(name, job):
    arch, over, _, _ = STEP_JOBS[name]
    jc, _, npp = _model(arch, tuple(over.items()))
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    toks = jnp.asarray(job["tokens"])
    batch = {"tokens": toks}
    enc = None
    if "enc_embeds" in job:
        batch["enc_embeds"] = jnp.asarray(job["enc_embeds"])
        enc = jax.jit(JT._encode, static_argnums=(2, 3))(
            JS._compute_cast(jp, jc), batch, jc, False)
    step = jax.jit(JS.make_decode_step(jc))
    B, S = job["tokens"].shape
    cache = JT.init_decode_cache(jc, B, S + job["new"])
    for t in range(S):
        lg, cache = (step(jp, toks[:, t], cache, enc) if enc is not None
                     else step(jp, toks[:, t], cache))
    new = []
    for i in range(job["new"]):
        tok = jnp.argmax(lg[:, :jc.vocab], axis=-1).astype(jnp.int32)
        new.append(np.asarray(tok))
        if i < job["new"] - 1:
            lg, cache = (step(jp, tok, cache, enc) if enc is not None
                         else step(jp, tok, cache))
    return np.stack(new, 1).tolist()


def _reference(jobs):
    tasks = {n: (_reference_engine, j) for n, j in jobs.items()
             if n in ENGINE_JOBS}
    tasks.update({n: (_reference_steps, jobs[n]) for n in REFERENCE_STEPS})
    with concurrent.futures.ThreadPoolExecutor(REFERENCE_THREADS) as pool:
        futs = {n: pool.submit(fn, n, j) for n, (fn, j) in tasks.items()}
        return {n: f.result() for n, f in futs.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank world's runs, the reference's and the port's tp = 1
    runs.  The world's processes run while this process runs the rest."""
    jobs = _jobs()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(run_ranks, W.run_jobs, TP, backend="gloo",
                            device="cpu", args=(jobs,),
                            timeout_s=WORLD_TIMEOUT_S,
                            workdir=tmp_path_factory.mktemp("tp_families"))
        ref = _reference(jobs)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            tp1 = W.run_jobs(None, jobs)
        finally:
            torch.set_num_threads(threads)
        ranks = world.result()
    return jobs, ranks, ref, tp1


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


# ---------------------------------------------------------------------------
# (a), (b): the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("job", list(ENGINE_JOBS))
def test_engine_tokens_equal_reference_tp1(runs, job):
    _, ranks, ref, tp1 = runs
    assert all(len(t) > 0 for t in ref[job])
    assert tp1[job]["tokens"] == ref[job]
    for r in ranks:
        assert r[job]["tokens"] == ref[job], f"rank {r['rank']}"


@pytest.mark.parametrize("job", list(ENGINE_JOBS))
def test_engine_step_logits_within_parity_of_tp1(runs, job):
    _, ranks, _, tp1 = runs
    want = tp1[job]["step_logits"]
    for r in ranks:
        got = r[job]["step_logits"]
        assert got.shape == want.shape
        assert _rel(got, want) <= PARITY, f"rank {r['rank']}"


@pytest.mark.parametrize("job", list(ENGINE_JOBS))
def test_engine_splits_the_pool_and_runs_b7_every_step(runs, job):
    """Every job's KV heads divide by 2: each rank's pool holds half of
    them and every step runs the span kernel per rank (its plain version
    here), never the dense gather."""
    _, ranks, _, _ = runs
    for r in ranks:
        st = r[job]["stats"]
        assert r[job]["kv_shard"] == TP
        assert st["kernel_dispatches"] == st["mixed_steps"] > 0
        assert st["dense_fallbacks"] == 0


@pytest.mark.parametrize("job", MOE_JOBS)
def test_moe_routes_identical_to_tp1(runs, job):
    """Every rank routes every token: every MoE call of the serve and of
    the mixed step picks the tp = 1 slots and keeps the same (token, slot)
    pairs after capacity."""
    _, ranks, _, tp1 = runs
    for key in ("routes", "step_routes"):
        want = tp1[job][key]
        assert len(want) > 0
        for r in ranks:
            got = r[job][key]
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert torch.equal(a["idx"], b["idx"])
                assert torch.equal(a["kept"], b["kept"])


@pytest.mark.parametrize("job", MOE_JOBS)
def test_each_rank_holds_exactly_its_slots(runs, job):
    """Rank r's expert leaves are slots [r E/2, (r+1) E/2) of the whole
    (prepared) stack, each expert's factors whole; the padded slots of
    qwen2-moe (4 experts in 64 slots) land on rank 1."""
    jobs, ranks, _, _ = runs
    arch, over, opts = ENGINE_JOBS[job]
    _, tc, npp = _model(arch, tuple(over.items()))
    whole = params_from_numpy(npp, device="cpu")
    if opts:
        whole = prepare_decode_params(whole, tc, fuse=True, bits=8)
    experts = dict(_leaves(whole["decoder"]["layers"]["moe"]["experts"]))
    E = tc.moe.n_slots
    for r in ranks:
        mine = dict(_leaves(r[job]["experts"]))
        assert mine.keys() == experts.keys()
        for path, leaf in experts.items():
            ax = leaf.dim() - (3 if path.endswith("/w") else 4)
            want = leaf.narrow(ax, r["rank"] * E // TP, E // TP)
            assert torch.equal(mine[path], want), path
    if opts:
        assert any(p.startswith("w1g/") for p in experts)


# ---------------------------------------------------------------------------
# (c): the serving steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("job", REFERENCE_STEPS)
def test_step_tokens_equal_reference_steps(runs, job):
    _, ranks, ref, tp1 = runs
    assert tp1[job]["tokens"] == ref[job]
    for r in ranks:
        assert r[job]["tokens"] == ref[job], f"rank {r['rank']}"


@pytest.mark.parametrize("job", list(STEP_JOBS))
def test_step_logits_within_parity_of_tp1(runs, job):
    """The prefill step's logits and every decode step's."""
    _, ranks, _, tp1 = runs
    want = [tp1[job]["prefill"], *tp1[job].get("logits", [])]
    for r in ranks:
        got = [r[job]["prefill"], *r[job].get("logits", [])]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            assert _rel(a, b) <= PARITY, f"rank {r['rank']}"


def test_patch_prefill_matches_reference(runs):
    """internvl2's patch prefill at tp = 1 is the reference's (the ranks
    are held to it within PARITY above)."""
    jobs, _, _, tp1 = runs
    jc, _, npp = _model(INTERNVL)
    job = jobs["internvl2_patch_prefill"]
    want = jax.jit(JS.make_prefill_step(jc))(
        jax.tree_util.tree_map(jnp.asarray, npp),
        {"tokens": jnp.asarray(job["tokens"]),
         "patch_embeds": jnp.asarray(job["patch_embeds"])})
    np.testing.assert_allclose(tp1["internvl2_patch_prefill"][
        "prefill"].numpy(), np.asarray(want), **LOGITS)


def _conv_parts(leaf, cfg):
    s = cfg.ssm
    gn = s.n_groups * s.d_state
    return leaf[..., :-2 * gn], leaf[..., -2 * gn:]


@pytest.mark.parametrize("job", SSM_JOBS)
def test_ssm_states_reassemble_to_tp1(runs, job):
    """Each rank's ``conv`` state holds its ``x`` channels and ``B``/``C``
    whole, its ``ssm`` state its H / 2 heads; put back together they are
    tp = 1's states within 1e-5."""
    jobs, ranks, _, tp1 = runs
    cfg = jobs[job]["cfg"]
    want = tp1[job]["states"]
    for path in want:
        if path.endswith("conv"):
            xs, bcs = zip(*(_conv_parts(r[job]["states"][path], cfg)
                            for r in ranks))
            got = torch.cat([torch.cat(xs, -1), bcs[0]], -1)
            for bc in bcs[1:]:
                assert torch.equal(bc, bcs[0])
        elif path.endswith("ssm"):
            got = torch.cat([r[job]["states"][path] for r in ranks], -3)
        else:
            continue
        assert got.shape == want[path].shape, path
        assert _rel(got, want[path]) <= PARITY, path


def test_ring_splits_its_kv_heads_or_stays_whole(runs):
    """zamba2's (4 KV heads) and seamless's rings hold 2 KV heads a rank;
    the one-KV-head zamba2's ring is whole on every rank, and equal on
    both, where the reference would split its sequence axis."""
    jobs, ranks, _, tp1 = runs
    for job, heads in (("zamba2_steps", 2), ("seamless_steps", 2),
                       ("zamba2_whole_ring", 1)):
        rings = {p: v for p, v in tp1[job]["states"].items()
                 if p.endswith(("/k", "/v"))}
        assert rings
        for path, want in rings.items():
            local = [r[job]["states"][path] for r in ranks]
            assert {t.shape[-2] for t in local} == {heads}, path
            got = local[0] if heads == want.shape[-2] else torch.cat(
                local, -2)
            if heads == want.shape[-2]:
                assert torch.equal(local[0], local[1]), path
            assert _rel(got, want) <= PARITY, path


def test_ranks_load_no_jax_and_no_reference(runs):
    assert [r["jax_or_reference_loaded"] for r in runs[1]] == [[]] * TP


# ---------------------------------------------------------------------------
# tp_plan: every config, no ranks
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """The full-width config and its parameter tree as fake tensors
    (shapes only, nothing allocated)."""
    cfg = tget_config(arch)
    with FakeTensorMode():
        return cfg, TT.init_params(cfg, seed=0, device="cpu")


def _mesh(tp, rank=0):
    return Mesh(model=tp, rank=rank, device="cpu")


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_tp_plan_plans_every_config(arch, tp):
    """Nothing is refused, and each family splits what the reference
    splits over "model"."""
    cfg, tree = _shapes(arch)
    plan = tp_plan(tree, cfg, _mesh(tp))
    g = plan.groups()
    assert g["vocab"] and g["mlp"]
    assert g.get("experts", False) == (cfg.moe is not None)
    assert g.get("ssm_heads", False) == (cfg.ssm is not None)
    assert g["heads"] == (cfg.layer_kind != "mamba")
    assert g["kv_heads"] == (cfg.n_kv_heads % tp == 0
                             and cfg.layer_kind != "mamba")
    paths = dict(_leaves(tree))
    if cfg.encdec:   # the encoder's and the cross-attention's heads
        for path in ("encoder/layers/attn/wq/R", "decoder/layers/xattn/wq/R",
                     "decoder/layers/xattn/wk/R", "encoder/layers/ffn/w1/R"):
            assert split_parts(path, paths[path].shape, plan)[1][0][1], path
        for path in ("encoder/layers/attn/wo/L", "decoder/layers/xattn/wo/L"):
            assert split_parts(path, paths[path].shape, plan)[0] == -3
    if cfg.moe is not None:
        assert split_parts("decoder/layers/moe/router/w",
                           paths["decoder/layers/moe/router/w"].shape,
                           plan) is None
        leaf = paths["decoder/layers/moe/experts/w1/L"]
        assert split_parts("decoder/layers/moe/experts/w1/L", leaf.shape,
                           plan) == (-4, ((cfg.moe.n_slots, True),))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
def test_mamba_part_widths(arch, tp):
    """A rank's Mamba leaves at full width: conv over its x channels and
    the whole B and C, its heads of A_log / dt_bias / D and of the norm,
    out_proj's input blocks split on head boundaries, in_proj whole."""
    cfg, tree = _shapes(arch)
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H, gn = d_inner // s.head_dim, s.n_groups * s.d_state
    plan = tp_plan(tree, cfg, _mesh(tp))
    assert plan.ssm_heads and plan.ssm_bc == gn
    local = dict(_leaves(shard_params(tree, plan)))
    whole = dict(_leaves(tree))
    stem = ("decoder/layers/mamba" if arch == MAMBA
            else "decoder/groups/mamba")
    assert local[f"{stem}/conv_w"].shape[-1] == d_inner // tp + 2 * gn
    assert local[f"{stem}/conv_b"].shape[-1] == d_inner // tp + 2 * gn
    for name in ("A_log", "dt_bias", "D"):
        assert local[f"{stem}/{name}"].shape[-1] == H // tp
    assert local[f"{stem}/norm_scale"].shape[-1] == d_inner // tp
    L = local[f"{stem}/out_proj/L"]
    k, p = whole[f"{stem}/out_proj/L"].shape[-3], L.shape[-1]
    assert L.shape[-3] == k // tp and p == s.head_dim
    for name in ("L", "R"):
        assert local[f"{stem}/in_proj/{name}"].shape == \
            whole[f"{stem}/in_proj/{name}"].shape


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch,opts", [(GRANITE, False), (QWEN, False),
                                       (QWEN, True)])
def test_expert_slices_concatenate_back_bitwise(arch, opts, tp):
    """Every rank's slots, concatenated in rank order on the expert axis,
    are the whole stack bit for bit (fused int8 too); the router and the
    shared experts' whole leaves are the same on every rank."""
    _, tc, npp = _model(arch)
    whole = params_from_numpy(npp, device="cpu")
    if opts:
        whole = prepare_decode_params(whole, tc, fuse=True, bits=8)
    ranks = [dict(_leaves(shard_params(whole, tp_plan(whole, tc,
                                                      _mesh(tp, r)))))
             for r in range(tp)]
    for path, leaf in _leaves(whole):
        if "/experts/" in path:
            ax = leaf.dim() - (3 if path.endswith("/w") else 4)
            got = torch.cat([r[path] for r in ranks], ax)
            assert torch.equal(got, leaf), path
            assert ranks[0][path].shape[ax] == tc.moe.n_slots // tp
        elif "/router/" in path:
            assert all(torch.equal(r[path], leaf) for r in ranks), path


@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
def test_mamba_conv_slices_reassemble(arch):
    """The ranks' conv leaves: their x channels in rank order, then the
    B and C channels every rank holds whole, are the whole leaf."""
    _, tc, npp = _model(arch)
    whole = params_from_numpy(npp, device="cpu")
    ranks = [dict(_leaves(shard_params(whole, tp_plan(whole, tc,
                                                      _mesh(TP, r)))))
             for r in range(TP)]
    for path, leaf in _leaves(whole):
        if path.endswith(("conv_w", "conv_b")):
            xs, bcs = zip(*(_conv_parts(r[path], tc) for r in ranks))
            assert all(torch.equal(b, bcs[0]) for b in bcs)
            assert torch.equal(torch.cat([*xs, bcs[0]], -1), leaf), path


def test_decode_cache_under_a_plan():
    """``init_decode_cache(plan=)``: a Mamba state a rank's, a ring split
    where the KV heads split, whole where they do not."""
    for arch, over, ring_heads in ((ZAMBA, {}, 2), (ZAMBA, {"n_kv_heads": 1},
                                                    1)):
        _, tc, npp = _model(arch, tuple(over.items()))
        params = params_from_numpy(npp, device="cpu")
        plan = tp_plan(params, tc, _mesh(TP))
        cache = TT.init_decode_cache(tc, 3, 16, device="cpu", plan=plan)
        whole = TT.init_decode_cache(tc, 3, 16, device="cpu")
        s = tc.ssm
        gn = s.n_groups * s.d_state
        conv = cache["groups"]["mamba"]["conv"]
        assert conv.shape[-1] == (whole["groups"]["mamba"]["conv"].shape[-1]
                                  - 2 * gn) // TP + 2 * gn
        assert cache["groups"]["mamba"]["ssm"].shape[-3] * TP == \
            whole["groups"]["mamba"]["ssm"].shape[-3]
        assert cache["groups"]["attn"]["k"].shape[-2] == ring_heads
        assert plan.kv_heads == (ring_heads * TP == tc.n_kv_heads)
        assert tree_map(lambda t: t.dtype, cache) == tree_map(
            lambda t: t.dtype, whole)
