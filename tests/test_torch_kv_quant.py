"""The port's int8 KV pages against the JAX reference: page quantization
and the in-place scatter write (bitwise), the int8-page span kernel's plain
version against the reference's Pallas kernel (interpret mode), the int8
pool through the paged mixed step, and the engine's compressed decode path
(``quantize=``, ``fuse_projections=True``, ``kv_dtype="int8"``) against
the reference engine.

Integer page values and scales are compared bitwise where both sides get
the same inputs, on every page but the sink (page 0), where padding
writes land in an order neither framework fixes; through a model, where
the K/V rows themselves differ by ~1e-7, within one int8 step and 1e-5
relative.  Attention outputs are held at the reference kernel tests'
tolerances (2e-5 fp32, 2e-2 bf16), logits at 1e-4 as in
tests/test_torch_models.py, and greedy tokens exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as jserving
import repro_torch.serving as tserving
from repro.configs import get_config as jget_config
from repro.core import quant as jq
from repro.kernels import ref as jref
from repro.kernels.paged import paged_attention as jpaged_attention
from repro.kernels.paged import paged_attention_span as jpaged_span
from repro.models import transformer as JT
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import quant as tq
from repro_torch.kernels import launches
from repro_torch.kernels import ref as tref
from repro_torch.kernels.paged import (GLOBAL_WINDOW, paged_attention,
                                       paged_attention_span,
                                       paged_attention_span_plain,
                                       paged_attention_span_split_plain)
from repro_torch.models import transformer as TT

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
LOGITS = dict(rtol=1e-4, atol=1e-4)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# page quantization and the scatter write: bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 2, 16), (3, 4, 2, 8), (1, 1, 4)])
def test_quantize_kv_page_bitwise(shape):
    rng = np.random.default_rng(0)
    rows = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    rows[..., 0, :] = 0.0       # an all-zero head takes scale 1.0
    jv, js = jq.quantize_kv_page(jnp.asarray(rows))
    tv, ts = tq.quantize_kv_page(_t(rows))
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tq.dequantize_kv_pages(tv, ts).numpy(),
        np.asarray(jq.dequantize_kv_pages(jv, js)))


def _kv_write_both(state, phys, off, rows, rescale=None):
    """One write in both packages; the port's writes in place."""
    (jp, js), (tp, ts) = state
    jp, js = jq.quantize_kv_write(
        jp, js, jnp.asarray(phys, jnp.int32), jnp.asarray(off, jnp.int32),
        jnp.asarray(rows, jnp.float32),
        rescale_phys=None if rescale is None else jnp.asarray(rescale))
    got = tq.quantize_kv_write(
        tp, ts, _t(np.asarray(phys, np.int32)), _t(np.asarray(off, np.int32)),
        _t(np.asarray(rows, np.float32)),
        rescale_phys=None if rescale is None else _t(np.asarray(rescale)))
    assert got[0] is tp and got[1] is ts
    np.testing.assert_array_equal(tp.numpy()[1:], np.asarray(jp)[1:])
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    return (jp, js), (tp, ts)


def _empty(P=6, pg=4, KV=2, hd=8):
    return ((jnp.zeros((P, pg, KV, hd), jnp.int8), jnp.zeros((P, KV))),
            (torch.zeros((P, pg, KV, hd), dtype=torch.int8),
             torch.zeros((P, KV))))


def test_quantize_kv_write_growth_rescale_and_recycled_page_reset():
    """A row written small, then a 16x larger row on the same page: the
    scale grows and the stored row is rescaled; a later offset-0 write is
    the page's first after recycling and resets its scale."""
    state = _empty()
    small = np.full((1, 1, 2, 8), 0.5, np.float32)
    big = np.full((1, 1, 2, 8), 8.0, np.float32)
    state = _kv_write_both(state, [[1]], [[0]], small)
    s0 = float(state[1][1][1, 0])
    state = _kv_write_both(state, [[1]], [[1]], big)
    assert float(state[1][1][1, 0]) > s0
    state = _kv_write_both(state, [[1]], [[0]], small)
    assert float(state[1][1][1, 0]) == pytest.approx(0.5 / tq.KV_QMAX)


def test_quantize_kv_write_spans_and_shared_page_untouched():
    """Ragged spans across page boundaries with sink-redirected padding
    and a de-duplicated rescale set; a page outside every span (a shared
    one) keeps every bit, its scales too."""
    rng = np.random.default_rng(1)
    state = _empty(P=8)
    warm = rng.standard_normal((1, 4, 2, 8)).astype(np.float32)
    state = _kv_write_both(state, [[3, 3, 3, 3]], [[0, 1, 2, 3]], warm)
    before = (state[1][0][3].clone(), state[1][1][3].clone())
    for step in range(2):
        # row 0 fills pages 6-7 three rows a step; row 1 pages 1-2, its
        # third position padding (sink-redirected)
        rows = (rng.standard_normal((2, 3, 2, 8))
                * (1.0 + 3 * step)).astype(np.float32)
        pos = [3 * step, 1 + 3 * step]
        phys = [[6 + (pos[0] + i) // 4 for i in range(3)],
                [1 + (pos[1] + i) // 4 if i < 2 else 0 for i in range(3)]]
        off = [[(p + i) % 4 for i in range(3)] for p in pos]
        rescale = [[6 + pos[0] // 4, 7 + pos[0] // 4],
                   [1 + pos[1] // 4, 2 + pos[1] // 4]]
        state = _kv_write_both(state, phys, off, rows, rescale)
    assert torch.equal(state[1][0][3], before[0])
    assert torch.equal(state[1][1][3], before[1])
    # a huge write on another page leaves the shared page alone too
    state = _kv_write_both(state, [[2]], [[0]],
                           np.full((1, 1, 2, 8), 100.0, np.float32))
    assert torch.equal(state[1][0][3], before[0])


# ---------------------------------------------------------------------------
# int8-page span kernel: plain version against the Pallas kernel
# ---------------------------------------------------------------------------


def _quantized_fixture(B=3, KV=2, hd=16, pg=4, MP=5, seed=0):
    rng = np.random.default_rng(seed)
    P = 1 + B * MP
    kq, ks = jq.quantize_kv_page(
        jnp.asarray(rng.standard_normal((P, pg, KV, hd)), jnp.float32))
    vq, vs = jq.quantize_kv_page(
        jnp.asarray(rng.standard_normal((P, pg, KV, hd)), jnp.float32))
    pt = rng.permutation(np.arange(1, P)).reshape(B, MP).astype(np.int32)
    arrays = tuple(np.asarray(a) for a in (kq, ks, vq, vs)) + (pt,)
    return rng, arrays


SPANS = {"straddle": (6, [2, 4, 17], [5, 4, 1]),
         "inert_row": (4, [3, 0, 12], [2, 0, 4])}


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [GLOBAL_WINDOW, 3])
@pytest.mark.parametrize("case", sorted(SPANS))
def test_span_int8_pages_match_reference_kernel(case, window, q_dtype):
    S, start, span = SPANS[case]
    rng, (kq, ks, vq, vs, pt) = _quantized_fixture(seed=3)
    q = rng.standard_normal((3, S, 4, 16)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[q_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[q_dtype]
    st, sl = np.asarray(start, np.int32), np.asarray(span, np.int32)
    want = jpaged_span(jnp.asarray(q).astype(jdt), jnp.asarray(kq),
                       jnp.asarray(vq), jnp.asarray(pt), jnp.asarray(st),
                       jnp.asarray(sl), jnp.asarray(window, jnp.int32),
                       k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    targs = (_t(q).to(tdt), _t(kq), _t(vq), _t(pt), _t(st), _t(sl))
    before = launches()
    got = paged_attention_span(*targs, window, k_scales=_t(ks),
                               v_scales=_t(vs))
    assert launches() == before, "the CPU path must not count launches"
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if q_dtype == "float32" else BF16))
    for b in range(3):
        assert (got.float().numpy()[b, span[b]:] == 0).all()
    # the int8 plain version IS the float plain version on dequantized
    # pages, and the port's oracle agrees with the reference's
    deq = (tq.dequantize_kv_pages(_t(kq), _t(ks)),
           tq.dequantize_kv_pages(_t(vq), _t(vs)))
    assert torch.equal(
        paged_attention_span_plain(*targs, window, _t(ks), _t(vs)),
        paged_attention_span_plain(targs[0], *deq, *targs[3:], window))
    np.testing.assert_allclose(
        tref.paged_attention_span_q_ref(
            targs[0].float(), _t(kq), _t(vq), _t(ks), _t(vs), *targs[3:],
            window).numpy(),
        _np(jref.paged_attention_span_q_ref(
            jnp.asarray(q).astype(jdt).astype(jnp.float32), jnp.asarray(kq), jnp.asarray(vq),
            jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(pt),
            jnp.asarray(st), jnp.asarray(sl), window)), **F32)


@pytest.mark.parametrize("pps", [None, 1, 2])
@pytest.mark.parametrize("window", [GLOBAL_WINDOW, 3])
@pytest.mark.parametrize("case", sorted(SPANS))
def test_split_merge_int8_pages_match_reference_kernel(case, window, pps):
    """The span kernel's split and merge (its plain mirror) over int8 pages
    against the reference's int8 Pallas kernel; the mirror dequantizes as
    the kernel's page reader does, so on dequantized pages it is the float
    mirror exactly."""
    S, start, span = SPANS[case]
    rng, (kq, ks, vq, vs, pt) = _quantized_fixture(seed=13)
    q = rng.standard_normal((3, S, 4, 16)).astype(np.float32)
    st, sl = np.asarray(start, np.int32), np.asarray(span, np.int32)
    want = jpaged_span(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
                       jnp.asarray(pt), jnp.asarray(st), jnp.asarray(sl),
                       jnp.asarray(window, jnp.int32),
                       k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    targs = (_t(q), _t(kq), _t(vq), _t(pt), _t(st), _t(sl))
    got = paged_attention_span_split_plain(*targs, window, _t(ks), _t(vs),
                                           pps=pps)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    for b in range(3):
        assert (got.numpy()[b, span[b]:] == 0).all()
    deq = (tq.dequantize_kv_pages(_t(kq), _t(ks)),
           tq.dequantize_kv_pages(_t(vq), _t(vs)))
    assert torch.equal(got, paged_attention_span_split_plain(
        targs[0], *deq, *targs[3:], window, pps=pps))


def test_single_query_int8_pages_match_reference_and_reject_half_scales():
    rng, (kq, ks, vq, vs, pt) = _quantized_fixture(seed=5)
    q = rng.standard_normal((3, 4, 16)).astype(np.float32)
    lengths = np.asarray([1, 7, 20], np.int32)
    want = jpaged_attention(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
                            jnp.asarray(pt), jnp.asarray(lengths),
                            jnp.asarray(GLOBAL_WINDOW, jnp.int32),
                            k_scales=jnp.asarray(ks),
                            v_scales=jnp.asarray(vs))
    got = paged_attention(_t(q), _t(kq), _t(vq), _t(pt), _t(lengths),
                          k_scales=_t(ks), v_scales=_t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    with pytest.raises(ValueError, match="together"):
        paged_attention(_t(q), _t(kq), _t(vq), _t(pt), _t(lengths),
                        k_scales=_t(ks))


# ---------------------------------------------------------------------------
# the int8 pool through the model
# ---------------------------------------------------------------------------


def _kernels_on(cfg):
    return dataclasses.replace(
        cfg, paged_kernel=True,
        monarch=dataclasses.replace(cfg.monarch, backend="pallas"))


@pytest.fixture(scope="module")
def model():
    jc = _kernels_on(jget_config("gpt2-medium").reduced())
    tc = _kernels_on(tget_config("gpt2-medium").reduced())
    jp = JT.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jc, tc, jp, tp


def _assert_int8_pools_close(jpool, tpool):
    """Every page but the sink within one int8 step, every scale within
    1e-5 relative: the two models' K/V rows differ by ~1e-7 relative (other
    summation orders), which moves a scale by as much and can tip a value
    at a rounding tie to the neighbouring integer."""
    ja, ta = jpool["layers"]["attn"], tpool["layers"]["attn"]
    assert sorted(ja) == sorted(ta)
    for name in ("k_pages", "v_pages"):
        diff = np.abs(ta[name][:, 1:].numpy().astype(np.int32)
                      - np.asarray(ja[name])[:, 1:].astype(np.int32))
        assert diff.max() <= 1 and diff.mean() < 1e-3, name
    for name in ("k_scales", "v_scales"):
        np.testing.assert_allclose(ta[name].numpy(), np.asarray(ja[name]),
                                   rtol=1e-5, atol=0)


def test_int8_pool_layout_and_cow_copies_pages_with_scales(model):
    """``init_paged_pool`` stacks (L, P, KV) scale buffers with the page
    axis at 1, so ``cow_copy_pages`` copies page bytes and scales together,
    as the reference's does."""
    jc, tc, _, _ = model
    jpool = JT.init_paged_pool(jc, 6, 4, kv_dtype="int8")
    tpool = TT.init_paged_pool(tc, 6, 4, kv_dtype="int8", device="cpu")
    want = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), jpool)
    got = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]), tpool)
    assert got == want
    assert tuple(tpool["layers"]["attn"]["k_scales"].shape) == (
        tc.n_layers, 6, tc.n_kv_heads)
    rng = np.random.default_rng(8)
    for name, a in tpool["layers"]["attn"].items():
        v = (rng.integers(-127, 128, a.shape).astype(np.int8)
             if a.dtype == torch.int8
             else rng.random(a.shape).astype(np.float32))
        jpool["layers"]["attn"][name] = jnp.asarray(v)
        tpool["layers"]["attn"][name] = _t(v)
    src, dst = np.asarray([2, 4, 0]), np.asarray([4, 5, 0])
    want = JT.cow_copy_pages(jpool, jnp.asarray(src), jnp.asarray(dst))
    got = TT.cow_copy_pages(tpool, _t(src), _t(dst))
    for name in got["layers"]["attn"]:
        np.testing.assert_array_equal(
            got["layers"]["attn"][name].numpy(),
            np.asarray(want["layers"]["attn"][name]))
    # page 4 now holds page 2's scales, page 5 page 4's from before
    before = np.asarray(jpool["layers"]["attn"]["k_scales"])
    ks = got["layers"]["attn"]["k_scales"].numpy()
    np.testing.assert_array_equal(ks[:, 4], before[:, 2])
    np.testing.assert_array_equal(ks[:, 5], before[:, 4])


@pytest.mark.parametrize("paged_kernel", [True, False])
def test_int8_pool_mixed_steps_match_reference(model, paged_kernel):
    """Ragged prefill chunks, then decode steps, into an int8 pool: the
    pages (but the sink) and scales stay within one step and 1e-5 of the
    reference's, and the logits agree, on the span kernel and on the
    dense fallback."""
    jc, tc, jp, tp = model
    jc = dataclasses.replace(jc, paged_kernel=paged_kernel)
    tc = dataclasses.replace(tc, paged_kernel=paged_kernel)
    B, pg, MP = 3, 4, 6
    jpool = JT.init_paged_pool(jc, 1 + B * MP, pg, kv_dtype="int8")
    tpool = TT.init_paged_pool(tc, 1 + B * MP, pg, kv_dtype="int8",
                               device="cpu")
    table = np.asarray([[1 + b * MP + j for j in range(MP)]
                        for b in range(B)], np.int32)
    rng = np.random.default_rng(6)
    start = np.zeros(B, np.int32)
    for spans in ([5, 3, 0], [3, 5, 4], [1, 1, 1], [1, 1, 1]):
        toks = rng.integers(0, jc.vocab, (B, max(spans))).astype(np.int32)
        sp = np.asarray(spans, np.int32)
        jl, jpool = JT.paged_mixed_step(
            jp, jnp.asarray(toks), jnp.asarray(start), jnp.asarray(sp),
            jnp.asarray(table), jpool, jc)
        tl, tpool = TT.paged_mixed_step(
            tp, _t(toks), _t(start), _t(sp), _t(table), tpool, tc)
        live = sp > 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **LOGITS)
        start = start + sp
        _assert_int8_pools_close(jpool, tpool)


# ---------------------------------------------------------------------------
# the engine's compressed decode path against the reference engine
# ---------------------------------------------------------------------------


def _prompts(vocab):
    rng = np.random.default_rng(10)
    return [rng.integers(0, vocab, n) for n in (3, 24, 5, 18, 2)]


def _repeat_prompts(vocab):
    """A prompt, its repeat once it is committed (a copy-on-write fork of
    the partial tail page), and an extension of it."""
    p = list(np.random.default_rng(40).integers(0, vocab, 14))
    return [np.asarray(p), np.asarray(p), np.asarray(p + [5, 6])]


TRACES = {
    "plain": (dict(max_slots=4, page_size=4, max_len=48, chunk_size=8),
              "plain", 0),
    "preemption": (dict(max_slots=4, page_size=4, max_len=48, n_pages=9,
                        chunk_size=8), "plain", 0),
    "prefix_cow": (dict(max_slots=4, page_size=4, max_len=48,
                        chunk_size=8), "repeat", 4),
}


def _serve(pk, cfg, params, kw, prompts_kind, stagger, **engine_kw):
    eng = pk.ContinuousBatchingEngine(cfg, params, **kw, **engine_kw)
    prompts = (_prompts(cfg.vocab) if prompts_kind == "plain"
               else _repeat_prompts(cfg.vocab))
    reqs, steps = [], 0
    while prompts or eng.has_work():
        if prompts and (stagger == 0 or steps % stagger == 0):
            while prompts:
                reqs.append(eng.add_request(
                    prompts.pop(0), pk.SamplingParams(max_new_tokens=5)))
                if stagger:
                    break
        eng.step()
        steps += 1
        assert steps < 500
    eng.pool_host.check_invariants()
    assert eng.pool_host.free_pages == eng.pool_host.n_pages - 1
    return eng, [list(r.output_tokens) for r in reqs]


STAT_KEYS = ("mixed_steps", "decode_tokens", "prefill_tokens", "tokens_out",
             "preemptions", "prefix_hit_tokens", "cow_forks",
             "kernel_dispatches", "dense_fallbacks")


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_engine_int8_kv_and_factors_match_reference(model, trace):
    """``quantize="int8"``, ``fuse_projections=True``, ``kv_dtype="int8"``
    with every kernel on: the port engine's greedy tokens and counters
    equal the reference engine's."""
    jc, tc, jp, tp = model
    kw, kind, stagger = TRACES[trace]
    opts = dict(quantize="int8", fuse_projections=True, kv_dtype="int8",
                use_paged_kernel=True)
    jeng, jout = _serve(jserving, jc, jp, kw, kind, stagger, **opts)
    teng, tout = _serve(tserving, tc, tp, kw, kind, stagger, device="cpu",
                        **opts)
    assert tout == jout
    assert all(len(o) == 5 for o in tout)
    for key in STAT_KEYS:
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.weight_bits == jeng.weight_bits == 8
    assert teng.kv_dtype == "int8"
    assert "wqkv" in teng.params["decoder"]["layers"]["attn"]
    assert teng.stats["kernel_dispatches"] == teng.stats["mixed_steps"]
    if trace == "preemption":
        assert teng.stats["preemptions"] > 0
    if trace == "prefix_cow":
        assert teng.stats["prefix_hit_tokens"] > 0
        assert teng.stats["cow_forks"] > 0


def test_equal_byte_budget_gives_int8_twice_the_pages(model):
    _, tc, _, tp = model
    budget = 24 * tq.kv_page_bytes(tc.n_layers, tc.n_kv_heads, tc.hd, 4,
                                   "fp32")
    common = dict(max_slots=2, page_size=4, max_len=32, pool_bytes=budget,
                  device="cpu")
    e32 = tserving.ContinuousBatchingEngine(tc, tp, **common)
    e8 = tserving.ContinuousBatchingEngine(tc, tp, kv_dtype="int8", **common)
    n32, n8 = e32.pool_host.n_pages - 1, e8.pool_host.n_pages - 1
    assert n32 == 24 and n8 >= 2 * n32
    assert e8.pool_host.stats().pool_bytes <= budget
    assert e8.pool["layers"]["attn"]["k_pages"].dtype == torch.int8
