"""The port's mixture-of-experts layers against the JAX reference, on the
CPU: granite-moe-1b-a400m (32 experts, top-8, GQA) and qwen2-moe-a2.7b (60
experts padded to 64 slots, top-4, 4 shared), both at ``.reduced()`` (4
experts, top-2; qwen2 keeps its 64 slots and one shared expert).

* ``moe_apply`` equals the reference's within fp32 2e-5, output and
  load-balance loss, through capacity drops, several routing groups,
  padded slots, the shared expert, and a router with exact ties (the
  port's stable sort takes the lower slot first, as ``jax.lax.top_k``).
* The expert-stacked wrappers' plain paths (float, int8, int4; fused and
  staged) are ``torch.equal`` to a loop over the experts.
* Fusion and quantization of an expert-stacked tree equal the
  reference's, scale for scale.
* The continuous-batching engine serves the reference engine's tokens
  with int8 factors and fused projections, and with int8 KV pages too (>=
  the reference's 95% bar for int8 pages).  The float greedy trace is
  ``tests/test_torch_configs_serving.py``'s; the sampled traces and the
  legacy ``ServeEngine`` are ``tests/test_torch_families.py``'s.
* At tp = 2 the plan splits the experts over "model" (expert
  parallelism; served at tp = 2 in ``tests/test_torch_tp_families.py``).
* A dense-attention MoE step (``paged_kernel=False``: padding queries
  read the sink page) equals the reference's, pool, logits and routes:
  colliding sink writes keep the last write in row-major order, as the
  reference's ``.at[].set`` does on the CPU (``layers.last_writes``).
* chip_smoke.py's route check, rehearsed on constructed routes: a token
  displaced from its capacity slot by another token's flip at a near tie
  passes as a near tie; a flip without one fails.

The reference's ``moe_apply`` runs on its einsum backend here (its Pallas
kernels under ``vmap`` run in the forward and engine tests); the port's
runs on both of its backends (the kernel backend's plain versions on the
CPU)."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as jserving
import repro_torch.serving as tserving
from repro.configs import get_config as jget_config
from repro.core.quant import quantize_tree as jquantize_tree
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.fuse import fuse_model as jfuse_model
from repro_torch import tree_map
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.quant import quantize_monarch
from repro_torch.core.quant import quantize_tree as tquantize_tree
from repro_torch.kernels import monarch as KM
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.fuse import fuse_model as tfuse_model
from repro_torch.sharding.params import split_parts, tp_plan
from _torch_numpy_params import both

F32 = dict(rtol=2e-5, atol=2e-5)
INT8_KV_TOKEN_AGREEMENT = 0.95        # tests/test_kv_quant.py:352
MOE_ARCHS = ["granite-moe-1b-a400m", "qwen2-moe-a2.7b"]


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _cfgs(arch, backend="pallas", **moe):
    """(jax cfg, torch cfg) at ``.reduced()``, MoE fields replaced."""
    out = []
    for get in (jget_config, tget_config):
        c = get(arch).reduced()
        c = dataclasses.replace(
            c, paged_kernel=True,
            moe=dataclasses.replace(c.moe, **moe),
            monarch=dataclasses.replace(c.monarch, backend=backend))
        out.append(c)
    return out


_MODELS: dict = {}


def _model(arch):
    """(jax cfg, torch cfg, jax params, torch params) at ``.reduced()``,
    the params from numpy (``tests/_torch_numpy_params.py``), built once
    a module run."""
    if arch not in _MODELS:
        jc, tc = _cfgs(arch)
        _MODELS[arch] = (jc, tc, *both(jc))
    return _MODELS[arch]


def _moe_params(arch):
    """Layer 0's MoE block of the model's params, both packages."""
    _, _, jp, tp = _model(arch)
    return (jax.tree_util.tree_map(
        lambda a: a[0], jp["decoder"]["layers"]["moe"]),
        tree_map(lambda t: t[0], tp["decoder"]["layers"]["moe"]))


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

# (B, S, group size, capacity factor): one group; several groups (18
# tokens in groups of 8 halve to groups of 2); capacity so small that
# tokens are dropped
CASES = {"one_group": (2, 9, 512, 1.25),
         "nine_groups": (2, 9, 8, 1.25),
         "capacity_drops": (4, 16, 512, 0.3)}


def _jmoe(jp, x, jc):
    """The reference's ``moe_apply`` (einsum backend), jitted: one
    compile instead of one a primitive."""
    return jax.jit(lambda p, v: JL.moe_apply(p, v, jc))(jp, jnp.asarray(x))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_reference(arch, case):
    """Both of the port's backends against the reference's output and
    load-balance loss."""
    B, S, group, cf = CASES[case]
    jc, tc = _cfgs(arch, "einsum", group_size=group, capacity_factor=cf)
    jc = dataclasses.replace(jc, monarch=tc.monarch)
    jp, tp = _moe_params(arch)
    x = np.random.default_rng(1).standard_normal(
        (B, S, jc.d_model)).astype(np.float32)
    want, waux = _jmoe(jp, x, jc)
    for backend in ("einsum", "pallas"):
        got, gaux = TL.moe_apply(tp, torch.from_numpy(x), tc,
                                 backend=backend)
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        np.testing.assert_allclose(float(gaux["lb_loss"]),
                                   float(waux["lb_loss"]), **F32)
    # what the case is there for: the routes and the capacity it met
    mc = tc.moe
    T = B * S
    sg = min(group, T)
    while T % sg:
        sg //= 2
    xt = torch.from_numpy(x).reshape(T // sg, sg, -1)
    logits = (xt @ tp["router"]["w"]).float()
    _, gates, idx = TL._route(logits, mc)
    cap = max(4, int(cf * sg * mc.top_k / mc.n_experts))
    dispatch, _ = TL._dispatch(idx, gates, mc.n_slots, cap, torch.float32)
    kept = int(dispatch.sum())
    assert int(idx.max()) < mc.n_experts       # padded slots never chosen
    if case == "capacity_drops":
        assert kept < 0.8 * T * mc.top_k
    if case == "nine_groups":
        assert T // sg == 9
    assert (mc.n_slots, mc.n_shared) == (
        (64, 1) if arch.startswith("qwen2") else (4, 0))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_ties_take_the_lower_slot_first(arch):
    """Three router columns equal: every token's probabilities tie
    exactly on those slots, and both packages pick the lowest of them in
    the same order (``lax.top_k``'s rule)."""
    jc, tc = _cfgs(arch, "einsum")
    jc = dataclasses.replace(jc, monarch=tc.monarch)
    jp, _ = _moe_params(arch)
    w = np.asarray(jp["router"]["w"]).copy()
    w[:, 2] = w[:, 1]
    w[:, 3] = w[:, 1]
    jp = {**jp, "router": {"w": jnp.asarray(w)}}
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    x = np.random.default_rng(2).standard_normal(
        (2, 12, jc.d_model)).astype(np.float32)
    logits = jnp.asarray(x).reshape(1, 24, -1) @ jp["router"]["w"]
    if jc.moe.n_slots > jc.moe.n_experts:
        ok = jnp.arange(jc.moe.n_slots) < jc.moe.n_experts
        logits = jnp.where(ok, logits, -1e30)
    jprobs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, jidx = jax.lax.top_k(jprobs, jc.moe.top_k)
    probs, _, idx = TL._route(torch.from_numpy(np.asarray(logits)),
                              tc.moe)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    # the tie decides: some token's two choices are the tied slots 1, 2
    assert bool(((idx[..., 0] == 1) & (idx[..., 1] == 2)).any())
    assert not bool((idx == 3).any())
    want, waux = _jmoe(jp, x, jc)
    got, gaux = TL.moe_apply(tp, torch.from_numpy(x), tc)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(float(gaux["lb_loss"]),
                               float(waux["lb_loss"]), **F32)


def test_serving_steps_skip_the_load_balance_loss():
    _, tc, _, _ = _model("qwen2-moe-a2.7b")
    _, tp = _moe_params("qwen2-moe-a2.7b")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 5, tc.d_model)).astype(np.float32))
    y, aux = TL.moe_apply(tp, x, tc)
    y2, aux2 = TL.moe_apply(tp, x, tc, lb_loss=False)
    assert torch.equal(y, y2) and aux2 == {} and aux["lb_loss"].ndim == 0


# ---------------------------------------------------------------------------
# the expert-stacked wrappers
# ---------------------------------------------------------------------------


def _stack(E, k, q, p, s, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(E, k, q, p, generator=g),
            torch.randn(E, q, s, k, generator=g) / k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,T", [(3, 4), (5, 42), (1, 9)])
def test_expert_wrappers_plain_equal_a_loop(E, T, dtype):
    """Float, int8 and int4 factors: the stacked wrapper (its plain path
    here) is the per-expert wrapper, expert by expert, bitwise; so is
    ``ops.monarch_mm(_q)`` on the stacked factors."""
    L, R = _stack(E, 4, 8, 16, 6)
    x = torch.randn(E, T, 64).to(dtype)
    y = KM.monarch_fused_experts(x, L, R)
    loop = torch.stack([KM.monarch_fused(x[e], L[e], R[e])
                        for e in range(E)])
    assert y.dtype == dtype and torch.equal(y, loop)
    assert torch.equal(ops.monarch_mm(x, L, R), y)
    assert torch.equal(KM.monarch_fused_experts_plain(x, L, R), y)
    for bits in (8, 4):
        qc = quantize_monarch({"L": L, "R": R}, bits)
        args = (qc["Lq"], qc["Ls"], qc["Rq"], qc["Rs"])
        yq = KM.monarch_fused_q_experts(x, *args)
        loopq = torch.stack([KM.monarch_fused_q(x[e], *(a[e] for a in args))
                             for e in range(E)])
        assert torch.equal(yq, loopq)
        assert torch.equal(ops.monarch_mm_q(x, *args), yq)
        assert KM.quant_dims(x.shape, *args) == \
            KM.quant_dims(x[0].shape, *(a[0] for a in args)) == \
            (4, 8, 16, 6, bits)


def test_staged_expert_shapes_loop_the_staged_branch():
    """Factors whose intermediate does not fit take the staged branch,
    expert by expert: equal to ``ops.monarch_mm`` of each expert."""
    E, k, q, p, s = 2, 128, 128, 2, 2
    assert not KM.fused_fits((k, q, p), (q, s, k))
    L, R = _stack(E, k, q, p, s)
    x = torch.randn(E, 3, k * p)
    y = ops.monarch_mm(x, L, R)
    assert torch.equal(y, torch.stack([ops.monarch_mm(x[e], L[e], R[e])
                                       for e in range(E)]))
    qc = quantize_monarch({"L": L, "R": R}, 8)
    args = (qc["Lq"], qc["Ls"], qc["Rq"], qc["Rs"])
    assert torch.equal(ops.monarch_mm_q(x, *args), torch.stack(
        [ops.monarch_mm_q(x[e], *(a[e] for a in args)) for e in range(E)]))


def test_expert_wrappers_refuse_mismatched_stacks():
    L, R = _stack(3, 4, 8, 16, 6)
    with pytest.raises(ValueError):
        KM.monarch_fused_experts(torch.randn(2, 4, 64), L, R)
    with pytest.raises(ValueError):
        KM.monarch_fused_experts(torch.randn(3, 4, 64), L, R[:2])
    with pytest.raises(ValueError):
        KM.monarch_fused(torch.randn(3, 4, 64), L, R)
    qc = quantize_monarch({"L": L, "R": R}, 8)
    with pytest.raises(ValueError):
        KM.quant_dims((4, 64), qc["Lq"], qc["Ls"][:2], qc["Rq"], qc["Rs"])


@pytest.mark.parametrize("arch,bits", [("granite-moe-1b-a400m", 8),
                                       ("qwen2-moe-a2.7b", 4)])
def test_fused_and_quantized_expert_trees_equal_reference(arch, bits):
    """``fuse_model`` then ``quantize_tree`` over a block with stacked
    experts and shared experts: the port's tree is the reference's, key
    for key, values and scales bitwise."""
    jp, tp = _moe_params(arch)
    want = jquantize_tree(jfuse_model({"moe": jp}), bits)
    got = tquantize_tree(tfuse_model({"moe": tp}), bits)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g: dict = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            flat_g[path] = node
    walk(got, ())
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        g = flat_g[tuple(p.key for p in path)]
        assert np.array_equal(g.numpy(), np.asarray(leaf))
    experts = got["moe"]["experts"]
    assert set(experts) == {"w1g", "w2"} and experts["w1g"]["Lq"].dim() == 4


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _prompts(vocab):
    """Short prompts: few span buckets, so few compiles of the reference's
    step."""
    rng = np.random.default_rng(10)
    return [rng.integers(0, vocab, n) for n in (3, 4, 2, 4, 3)]


def _serve(pk, cfg, params, **kw):
    eng = pk.ContinuousBatchingEngine(cfg, params, use_paged_kernel=True,
                                      max_slots=2, page_size=4, max_len=48,
                                      chunk_size=4, **kw)
    reqs = [eng.add_request(p, pk.SamplingParams(max_new_tokens=5))
            for p in _prompts(cfg.vocab)]
    eng.run()
    eng.pool_host.check_invariants()
    return eng, [list(r.output_tokens) for r in reqs]


ENGINE_CASES = [("granite-moe-1b-a400m", "int8_fused"),
                ("qwen2-moe-a2.7b", "int8_fused"),
                ("granite-moe-1b-a400m", "int8_fused_int8_kv"),
                ("qwen2-moe-a2.7b", "int8_fused_int8_kv")]
OPTIONS = {"int8_fused": dict(quantize="int8", fuse_projections=True),
           "int8_fused_int8_kv": dict(quantize="int8", fuse_projections=True,
                                      kv_dtype="int8")}


@pytest.mark.parametrize("arch,mode", ENGINE_CASES)
def test_engine_tokens_equal_reference(arch, mode):
    """int8 factors, fused projections (the experts' up and gate fuse
    into ``w1g``, one expert-batched launch each on the card), with and
    without int8 KV pages."""
    jc, tc, jp, tp = _model(arch)
    opts = OPTIONS[mode]
    jeng, jout = _serve(jserving, jc, jp, **opts)
    teng, tout = _serve(tserving, tc, tp, device="cpu", **opts)
    assert all(len(o) == 5 for o in tout)
    if mode == "int8_fused_int8_kv":
        flat = [(a, b) for oa, ob in zip(tout, jout) for a, b in zip(oa, ob)]
        agree = sum(a == b for a, b in flat) / len(flat)
        assert agree >= INT8_KV_TOKEN_AGREEMENT, agree
    else:
        assert tout == jout
    for key in ("mixed_steps", "kernel_dispatches", "dense_fallbacks"):
        assert teng.stats[key] == jeng.stats[key], key
    moe = teng.params["decoder"]["layers"]["moe"]
    assert set(moe["experts"]) == {"w1g", "w2"}
    assert "Lq" in moe["experts"]["w1g"] and "w" in moe["router"]


def test_sink_writes_keep_the_last_in_row_major_order():
    """The reference's ``.at[].set`` keeps the last of duplicate writes on
    the CPU, in row-major order of the index arrays; ``last_writes`` names
    that write for every write to the same (page, offset)."""
    a = jnp.zeros((3, 4)).at[jnp.asarray([[1, 2, 1], [1, 0, 1]]),
                             jnp.asarray([[3, 0, 3], [3, 1, 3]])].set(
        jnp.asarray([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]))
    assert float(a[1, 3]) == 6.0 and float(a[2, 0]) == 2.0
    pt = torch.tensor([[1, 0], [2, 0]], dtype=torch.int32)
    q_pos = torch.tensor([[0, 1, 2, 3], [1, 2, 3, 4]])
    phys, off = TL.paged_write_targets(pt, q_pos, 2,
                                       span_len=torch.tensor([4, 1]))
    last = TL.last_writes(phys, off, 2)
    # row 0 writes page 1, then the sink (its table's 0) at offsets 0, 1;
    # row 1 page 2 at offset 1, then its padding the sink at 0, 1, 0
    assert phys.tolist() == [[1, 1, 0, 0], [2, 0, 0, 0]]
    assert off.tolist() == [[0, 1, 0, 1], [1, 0, 1, 0]]
    assert last.tolist() == [0, 1, 7, 6, 4, 7, 6, 7]


def test_dense_attention_moe_step_equals_reference():
    """ROADMAP §C 4's case: a .reduced() qwen2-moe-a2.7b step with
    ``paged_kernel=False`` (the dense gather), rows with padding (a short
    span, an empty one) whose table entries past the span are the sink,
    so their padding queries read the sink rows their colliding writes
    left.  The pool (sink page included), the logits and every layer's
    routes (padding tokens' included, which take capacity) are the
    reference's."""
    jc, tc, jp, tp = _model("qwen2-moe-a2.7b")
    jc = dataclasses.replace(jc, paged_kernel=False)
    tc = dataclasses.replace(tc, paged_kernel=False)
    B, S, pg = 3, 8, 4
    toks = np.random.default_rng(12).integers(0, jc.vocab, (B, S)).astype(
        np.int32)
    table = np.array([[1, 2, 0, 0], [3, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    start = np.zeros(B, np.int32)
    spans = np.array([8, 3, 0], np.int32)
    jpool = JT.init_paged_pool(jc, 4, pg)
    tpool = TT.init_paged_pool(tc, 4, pg, device="cpu")
    jroutes, troutes = [], []
    top_k, route = jax.lax.top_k, TL._route

    def rec_top_k(x, k):     # traced inside the reference's layer scan
        out = top_k(x, k)
        jax.debug.callback(lambda i: jroutes.append(np.asarray(i)), out[1])
        return out

    def rec_route(logits, mc):
        out = route(logits, mc)
        troutes.append(out[2].numpy())
        return out

    jax.lax.top_k, TL._route = rec_top_k, rec_route
    try:
        want, jpool = JT.paged_mixed_step(
            jp, *map(jnp.asarray, (toks, start, spans, table)), jpool, jc)
        got, _ = TT.paged_mixed_step(
            tp, *map(torch.from_numpy, (toks, start, spans, table)), tpool,
            tc)
    finally:
        jax.lax.top_k, TL._route = top_k, route
    assert len(troutes) == len(jroutes) == tc.n_layers
    for t, j in zip(troutes, jroutes):
        assert t.tolist() == j.tolist()
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(_np(tpool["layers"]["attn"][name]),
                                   _np(jpool["layers"]["attn"][name]), **F32)


def test_moe_at_tp2_needs_expert_parallelism():
    """At tp = 2 the plan splits the stacked experts over "model" (the
    reference's ``("experts", ...)`` rules): every expert leaf on its slot
    axis, each expert's factors whole; the router stays whole."""
    _, tc, _, tp = _model("granite-moe-1b-a400m")
    plan = tp_plan(tp, tc, types.SimpleNamespace(model=2))
    assert plan.experts and plan.groups()["experts"]
    moe = "decoder/layers/moe"
    E = tc.moe.n_slots
    for name in ("w1", "wg", "w2"):
        for kind, ax in (("L", -4), ("R", -4)):
            leaf = tp["decoder"]["layers"]["moe"]["experts"][name][kind]
            assert split_parts(f"{moe}/experts/{name}/{kind}", leaf.shape,
                               plan) == (ax, ((E, True),))
    router = tp["decoder"]["layers"]["moe"]["router"]["w"]
    assert split_parts(f"{moe}/router/w", router.shape, plan) is None


def test_init_params_stacks_the_experts():
    """The port's own initializer lays an MoE block out as the
    reference's: the same keys and shapes, experts on a leading slot
    axis."""
    from repro_torch.models import transformer as TT

    jc, tc, _, _ = _model("qwen2-moe-a2.7b")
    mine = TT.init_params(tc, seed=0, device="cpu")
    shapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape),
        jax.eval_shape(lambda k: JT.init_params(k, jc),
                       jax.random.PRNGKey(0)))
    assert tree_map(lambda t: tuple(t.shape), mine) == shapes
    assert mine["decoder"]["layers"]["moe"]["experts"]["w1"]["L"].shape[
        :2] == (tc.n_layers, tc.moe.n_slots)


def _chip_smoke():
    """chip_smoke.py as a module (its functions only: ``main`` runs under
    ``__main__``)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _route_record(probs, k: int, cap: int) -> dict:
    """One ``moe_apply`` call's route as chip_smoke records it, from the
    router's probabilities (G, s, E): the port's top-k and capacity."""
    mc = types.SimpleNamespace(n_slots=probs.shape[-1],
                               n_experts=probs.shape[-1], top_k=k)
    _, gates, idx = TL._route(torch.log(probs), mc)
    d, _ = TL._dispatch(idx, gates, probs.shape[-1], cap, torch.float32)
    return {"probs": probs, "idx": idx, "k": k,
            "kept": d.sum(-1) > 0}


# one group, token 0 at a near tie between experts 0 and 1 (4e-6 apart:
# the CPU takes 1, the card 0), token 1 sure of expert 0; top-1 and one
# capacity slot, so the card's token 0 takes expert 0's slot first and
# drops token 1, whose own route is the same on both sides
_TIE = [0.350004, 0.35, 0.2, 0.099996]
_SURE = [0.6, 0.2, 0.1, 0.1]


def test_route_check_takes_a_capacity_drop_behind_a_near_tie():
    """A token pushed out of its capacity slot by another token's flip at
    a near tie is a near tie too: its gap is the flipping token's."""
    cs = _chip_smoke()
    card = torch.tensor([[_TIE, _SURE]])
    cpu = torch.tensor([[_TIE[1::-1] + _TIE[2:], _SURE]])
    rep = cs._route_check([_route_record(card, 1, 1)],
                          [_route_record(cpu, 1, 1)], "rehearsal")
    kinds = [(d["token"], d["kind"], d["near_tie"])
             for d in rep["differences"]]
    assert kinds == [(0, "top_k", True), (1, "capacity", True)]
    assert rep["differences"][1]["gap"] == rep["differences"][0]["gap"]
    assert 0 < rep["differences"][1]["gap"] <= rep["differences"][1][
        "margin"]
    assert rep["first_difference"] == 0


def test_route_check_fails_a_difference_without_a_near_tie():
    """The same flip where the card's probabilities equal the CPU's (a
    margin of 0) is no near tie: the check fails."""
    cs = _chip_smoke()
    cpu_probs = torch.tensor([[_TIE[1::-1] + _TIE[2:], _SURE]])
    card = _route_record(torch.tensor([[_TIE, _SURE]]), 1, 1)
    card["probs"] = cpu_probs
    with pytest.raises(SystemExit, match="without a near tie"):
        cs._route_check([card], [_route_record(cpu_probs, 1, 1)],
                        "rehearsal")
