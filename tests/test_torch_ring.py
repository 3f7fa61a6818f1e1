"""The ring KV cache, the decode-step family and the legacy ``ServeEngine``
of the port against the JAX reference on the CPU.

At ``.reduced()`` gpt2-medium (MHA, LayerNorm, GELU), codeqwen1.5-7b (MHA,
SwiGLU), nemotron-4-15b (GQA 4 / 2, squared ReLU) and nemotron-4-15b with
local / global layers (window 6), with the reference's own initialized
params carried across by ``params_from_numpy``; the port runs its kernels'
plain versions (Monarch ``backend="pallas"``), the reference its einsum
path.  fp32 logits and ring contents are held to 2e-5 (the two frameworks
sum in other orders), tokens exactly:

* the ring ``attention_apply`` (with writes past ``max_len``, which both
  packages drop) and ``init_decode_cache``;
* ``prefill_with_cache`` then three ``decode_step``s, ``prefill`` against
  ``forward``'s last logits, ``decode_step_layerwise`` (``torch.equal``
  to ``decode_step`` in the port, 2e-5 to the reference's), fused and
  int8 / int4 factors through ``decode_step``, paged chunks against the
  ring;
* ``ServeEngine``: greedy and sampled tokens, EOS trimming, ``_prefill =
  None`` and a run past ``max_len`` equal the reference's; its tokens
  equal the continuous-batching engine's; the decode graph's bookkeeping
  through the host stand-in of ``tests/test_torch_step_graphs.py``;
* X3's block draw (``sample_block_plain``) bitwise
  ``jax.random.categorical`` on a (B, V) block;
* the ``serve_decode`` example's ``main`` on the CPU, both engines, and
  at a Mamba ``--arch`` (which always takes the legacy engine).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as jserving
import repro_torch.serving as tserving
from repro.configs import get_config as jget_config
from repro.models import decode_path as JDP
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import tree_map
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import prng
from repro_torch.kernels.sample import sample_block, sample_block_plain
from repro_torch.models import decode_path as TDP
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serving.ring_graphs import RingDecode
from test_torch_step_graphs import _HostGraph

FP32 = dict(rtol=2e-5, atol=2e-5)
# the reference's ring steps, jitted as its engine jits them (cfg static)
_jprefill = jax.jit(JT.prefill_with_cache, static_argnums=3)
_jdecode = jax.jit(JT.decode_step, static_argnums=3)
_jlayerwise = jax.jit(JDP.decode_step_layerwise, static_argnums=3)
_jprepare = jax.jit(JDP.prepare_decode_params, static_argnums=1,
                    static_argnames=("fuse", "bits"))
_jattention = jax.jit(JL.attention_apply, static_argnums=2,
                      static_argnames=("window",))
ARCHS = ["gpt2-medium", "codeqwen1.5-7b", "nemotron-4-15b",
         "nemotron-4-15b:local"]
_MODELS: dict = {}


def _config(get, arch):
    base, _, variant = arch.partition(":")
    cfg = get(base).reduced()
    if variant == "local":   # local / global layers, window 6
        cfg = dataclasses.replace(cfg, attn_pattern=("local", "global"),
                                  window=6)
    return cfg


def _model(arch):
    """(jax cfg, torch cfg, jax params, torch params), built once."""
    if arch not in _MODELS:
        jc = _config(jget_config, arch)
        tc = _config(tget_config, arch)
        tc = dataclasses.replace(tc, monarch=dataclasses.replace(
            tc.monarch, backend="pallas"))
        jp = JT.init_params(jax.random.PRNGKey(0), jc)
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
        _MODELS[arch] = (jc, tc, jp, tp)
    return _MODELS[arch]


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _close(a, b, **kw):
    np.testing.assert_allclose(_np(a), _np(b), **(kw or FP32))


def _ring_close(tcache, jcache):
    for name in ("k", "v"):
        _close(tcache["layers"]["attn"][name], jcache["layers"]["attn"][name])
    assert np.array_equal(_np(tcache["pos"]), _np(jcache["pos"]))


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


# ---------------------------------------------------------------------------
# the model functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_ring_attention_apply_and_cache_init(arch):
    """One layer's attention over a ring holding earlier rows: row 0
    writes 5 rows at 3..7, row 1 at 10..14 of a 12-row ring, whose last 3
    both packages drop (every query of row 1 then attends the whole
    ring)."""
    jc, tc, jp, tp = _model(arch)
    B, S, T = 2, 5, 12
    kv, hd = tc.n_kv_heads, tc.hd
    empty = TL.attention_cache_init(tc, B, T, torch.float32)
    want = JL.attention_cache_init(jc, B, T, jnp.float32)
    for name in ("k", "v"):
        assert tuple(empty[name].shape) == want[name].shape
        assert not empty[name].any()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, S, tc.d_model)).astype(np.float32)
    k0, v0 = (rng.normal(size=(B, T, kv, hd)).astype(np.float32)
              for _ in range(2))
    pos = np.array([3, 10], np.int32)
    win = int(JT._layer_windows(jc)[0])
    ja = jax.tree_util.tree_map(lambda a: a[0],
                                jp["decoder"]["layers"]["attn"])
    jout, jnew = _jattention(
        ja, jnp.asarray(x), jc, window=win,
        cache={"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
        pos=jnp.asarray(pos))
    cache = {"k": torch.from_numpy(k0.copy()),
             "v": torch.from_numpy(v0.copy())}
    tout, tnew = TL.attention_apply(
        TT.layer_params(tp["decoder"]["layers"]["attn"], 0),
        torch.from_numpy(x), tc, window=win, cache=cache,
        pos=torch.from_numpy(pos))
    assert tnew is cache                     # written in place
    _close(tout, jout)
    for name, old in (("k", k0), ("v", v0)):
        _close(cache[name], jnew[name])
        # rows outside the writes are untouched, the dropped ones too
        assert np.array_equal(_np(cache[name])[0, :3], old[0, :3])
        assert np.array_equal(_np(cache[name])[0, 8:], old[0, 8:])
        assert np.array_equal(_np(cache[name])[1, :10], old[1, :10])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_with_cache_then_decode_steps(arch):
    jc, tc, jp, tp = _model(arch)
    B, S, T = 2, 7, 16
    rng = np.random.default_rng(2)
    toks = rng.integers(0, tc.vocab, (B, S)).astype(np.int32)
    steps = rng.integers(0, tc.vocab, (3, B)).astype(np.int32)
    jcache = JT.init_decode_cache(jc, B, T)
    tcache = TT.init_decode_cache(tc, B, T, device="cpu")
    for name in ("k", "v"):
        jleaf = jcache["layers"]["attn"][name]
        tleaf = tcache["layers"]["attn"][name]
        assert tuple(tleaf.shape) == jleaf.shape == (
            tc.n_layers, B, T, tc.n_kv_heads, tc.hd)
        assert tleaf.dtype == torch.float32 and not tleaf.any()
    assert tcache["pos"].dtype == torch.int32
    jl, jcache = _jprefill(jp, jnp.asarray(toks), jcache, jc)
    tl, same = TT.prefill_with_cache(tp, torch.from_numpy(toks), tcache, tc)
    assert same is tcache
    _close(tl, jl)
    for tok in steps:
        jl, jcache = _jdecode(jp, jnp.asarray(tok), jcache, jc)
        tl, _ = TT.decode_step(tp, torch.from_numpy(tok), tcache, tc)
        _close(tl, jl)
    _ring_close(tcache, jcache)
    assert _np(tcache["pos"]).tolist() == [S + 3] * B


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_is_forwards_last_logits(arch):
    jc, tc, jp, tp = _model(arch)
    toks = np.random.default_rng(3).integers(0, tc.vocab, (2, 9)).astype(
        np.int32)
    got = TT.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    _close(got, JT.prefill(jp, {"tokens": jnp.asarray(toks)}, jc))
    full, _ = TT.forward(tp, {"tokens": torch.from_numpy(toks)}, tc,
                         train=False)
    assert torch.equal(got, full[:, -1])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_layerwise_is_decode_step(arch):
    jc, tc, jp, tp = _model(arch)
    B, T = 2, 16
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tc.vocab, (B, 5)).astype(np.int32)
    tok = rng.integers(0, tc.vocab, (B,)).astype(np.int32)
    cache = TT.init_decode_cache(tc, B, T, device="cpu")
    TT.prefill_with_cache(tp, torch.from_numpy(toks), cache, tc)
    c1, c2 = _clone(cache), _clone(cache)
    l1, _ = TT.decode_step(tp, torch.from_numpy(tok), c1, tc)
    l2, same = TDP.decode_step_layerwise(tp, torch.from_numpy(tok), c2, tc)
    assert same is c2
    assert torch.equal(l1, l2)
    for name in ("k", "v"):
        assert torch.equal(c1["layers"]["attn"][name],
                           c2["layers"]["attn"][name])
    assert torch.equal(c1["pos"], c2["pos"])
    jcache = JT.init_decode_cache(jc, B, T)
    _, jcache = _jprefill(jp, jnp.asarray(toks), jcache, jc)
    jl, jcache = _jlayerwise(jp, jnp.asarray(tok), jcache, jc)
    _close(l2, jl)
    _ring_close(c2, jcache)
    # a layer's slice is a view of the stacked tree
    sl = TDP.layer_slice(cache["layers"], 1)["attn"]["k"]
    assert sl.data_ptr() == cache["layers"]["attn"]["k"][1].data_ptr()


PREPARED = [("gpt2-medium", True, None), ("gpt2-medium", True, 8),
            ("gpt2-medium", False, 4), ("nemotron-4-15b", True, 8),
            ("codeqwen1.5-7b", True, 4)]


@pytest.mark.parametrize("arch,fuse,bits", PREPARED)
def test_fused_and_quantized_factors_through_decode_step(arch, fuse, bits):
    """Prepared params (``prepare_decode_params``: fused QKV, or Q plus
    fused K/V under GQA, and up/gate; int8 / packed int4 factors) drive
    the ring's prefill and decode steps as the reference's do."""
    jc, tc, jp, tp = _model(arch)
    jq = _jprepare(jp, jc, fuse=fuse, bits=bits)
    tq = TDP.prepare_decode_params(tp, tc, fuse=fuse, bits=bits)
    attn = tq["decoder"]["layers"]["attn"]
    if fuse:
        assert ("wqkv" in attn) == (tc.n_kv_heads == tc.n_heads)
        assert ("wkv" in attn) == (tc.n_kv_heads != tc.n_heads)
    if bits:
        assert attn["wo"]["Lq"].dtype == torch.int8
    B, T = 2, 16
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tc.vocab, (B, 6)).astype(np.int32)
    jcache = JT.init_decode_cache(jc, B, T)
    tcache = TT.init_decode_cache(tc, B, T, device="cpu")
    jl, jcache = _jprefill(jq, jnp.asarray(toks), jcache, jc)
    tl, _ = TT.prefill_with_cache(tq, torch.from_numpy(toks), tcache, tc)
    _close(tl, jl)
    for tok in rng.integers(0, tc.vocab, (2, B)).astype(np.int32):
        jl, jcache = _jdecode(jq, jnp.asarray(tok), jcache, jc)
        tl, _ = TT.decode_step(tq, torch.from_numpy(tok), tcache, tc)
        _close(tl, jl)
    _ring_close(tcache, jcache)


@pytest.mark.parametrize("arch", ["gpt2-medium", "nemotron-4-15b:local"])
def test_paged_chunks_match_the_ring(arch):
    """Chunked prefill through ``paged_mixed_step`` (3 + 3 + 2) gives the
    ring prefill's logits, and span-1 steps give ``decode_step``'s."""
    _, tc, _, tp = _model(arch)
    B, S, pg, MP = 2, 8, 4, 8
    prompts = torch.from_numpy(np.random.default_rng(6).integers(
        0, tc.vocab, (B, S)).astype(np.int32))
    cache = TT.init_decode_cache(tc, B, 32, device="cpu")
    ring, _ = TT.prefill_with_cache(tp, prompts, cache, tc)
    pool = TT.init_paged_pool(tc, 1 + B * MP, pg, device="cpu")
    pt = torch.tensor([[1 + b * MP + j for j in range(MP)]
                       for b in range(B)], dtype=torch.int32)
    start = torch.zeros(B, dtype=torch.int32)
    for c0 in range(0, S, 3):
        n = min(3, S - c0)
        paged, _ = TT.paged_mixed_step(
            tp, prompts[:, c0:c0 + n], start,
            torch.full((B,), n, dtype=torch.int32), pt, pool, tc)
        start = start + n
    _close(ring, paged)
    tok = torch.argmax(ring, -1).to(torch.int32)
    for _ in range(3):
        ring, _ = TT.decode_step(tp, tok, cache, tc)
        paged, _ = TT.paged_mixed_step(
            tp, tok[:, None], start, torch.ones(B, dtype=torch.int32), pt,
            pool, tc)
        _close(ring, paged)
        start = start + 1
        tok = torch.argmax(ring, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# ServeEngine
# ---------------------------------------------------------------------------

RUNS = {
    # name: (batch, prompt length, GenerationConfig fields, max_len)
    "greedy": (3, 6, dict(max_new_tokens=8), 32),
    "sampled": (3, 6, dict(max_new_tokens=8, temperature=0.8, seed=5), 32),
    # positions 10..21 of a 16-row ring: the last six writes dropped
    "past_max_len": (2, 10, dict(max_new_tokens=12), 16),
    "sampled_past_max_len": (2, 10, dict(max_new_tokens=12, temperature=1.1,
                                         seed=2 ** 40 + 7), 16),
}
ENGINE_CASES = ([("gpt2-medium", r) for r in RUNS]
                + [("nemotron-4-15b", r) for r in RUNS if r != "sampled"]
                + [("nemotron-4-15b:local", "greedy"),
                   ("codeqwen1.5-7b", "sampled")])


def _prompts(vocab, B, S, seed=7):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _both(arch, max_len, prefill=True):
    jc, tc, jp, tp = _model(arch)
    je = jserving.ServeEngine(jc, jp, max_len=max_len)
    te = tserving.ServeEngine(tc, tp, max_len=max_len, device="cpu")
    if not prefill:
        je._prefill = te._prefill = None
    return je, te


@pytest.mark.parametrize("arch,run", ENGINE_CASES)
def test_serve_engine_tokens_equal_reference(arch, run):
    B, S, gkw, max_len = RUNS[run]
    je, te = _both(arch, max_len)
    p = _prompts(te.cfg.vocab, B, S)
    want = np.asarray(je.generate(jnp.asarray(p),
                                  jserving.GenerationConfig(**gkw)))
    got = te.generate(p, tserving.GenerationConfig(**gkw))
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert got.numpy().tolist() == want.tolist()
    # the ring is reused and zeroed: a second generate gives the same
    again = te.generate(torch.from_numpy(p), tserving.GenerationConfig(**gkw))
    assert torch.equal(again, got)


@pytest.mark.parametrize("arch", ["gpt2-medium", "nemotron-4-15b"])
def test_serve_engine_without_prefill_runs_the_prompt_token_by_token(arch):
    for gkw in (dict(max_new_tokens=6),
                dict(max_new_tokens=6, temperature=0.7, seed=3)):
        je, te = _both(arch, 32, prefill=False)
        p = _prompts(te.cfg.vocab, 2, 5, seed=8)
        want = np.asarray(je.generate(jnp.asarray(p),
                                      jserving.GenerationConfig(**gkw)))
        got = te.generate(p, tserving.GenerationConfig(**gkw))
        assert got.numpy().tolist() == want.tolist()
        _, with_prefill = _both(arch, 32)
        assert torch.equal(with_prefill.generate(
            p, tserving.GenerationConfig(**gkw)), got)


def test_serve_engine_eos_trimming_and_empty_generate():
    """EOS trims at the first column where every row has met it (the
    reference's cumsum / all(axis=0) rule), and not at all while a row has
    not; zero new tokens give a (B, 0) block."""
    je, te = _both("gpt2-medium", 32)
    p = _prompts(te.cfg.vocab, 2, 6, seed=9)
    full = te.generate(p, tserving.GenerationConfig(max_new_tokens=10))
    cases = [(p[:1], int(full[0, 3])), (p, int(full[0, 2])),
             (p, int(full[1, 4])), (p, -5)]
    trimmed = 0
    for prompts, eos in cases:
        g = dict(max_new_tokens=10, eos_id=eos)
        want = np.asarray(je.generate(jnp.asarray(prompts),
                                      jserving.GenerationConfig(**g)))
        got = te.generate(prompts, tserving.GenerationConfig(**g))
        assert got.numpy().tolist() == want.tolist()
        trimmed += got.shape[1] < 10
    assert trimmed >= 1
    z = te.generate(p, tserving.GenerationConfig(max_new_tokens=0))
    assert tuple(z.shape) == (2, 0)


@pytest.mark.parametrize("arch", ["gpt2-medium", "nemotron-4-15b"])
def test_serve_engine_equals_continuous_batching(arch):
    """Each prompt alone through ``ServeEngine`` gives the tokens the
    continuous-batching engine gives it among the others (greedy;
    staggered joins, chunked prefill)."""
    _, tc, _, tp = _model(arch)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, tc.vocab, n) for n in (3, 24, 5, 18, 2)]
    eng = tserving.ContinuousBatchingEngine(
        tc, tp, max_slots=2, page_size=4, max_len=48, chunk_size=16,
        device="cpu")
    reqs = [eng.add_request(p, tserving.SamplingParams(max_new_tokens=6))
            for p in prompts]
    eng.run()
    single = tserving.ServeEngine(tc, tp, max_len=48, device="cpu")
    for p, r in zip(prompts, reqs):
        got = single.generate(p[None], tserving.GenerationConfig(
            max_new_tokens=6))[0]
        assert got.tolist() == list(r.output_tokens)


def _ring_leaves(eng):
    leaves: list = []
    for cache in eng._rings.values():
        tree_map(leaves.append, cache)
    return leaves


def test_decode_graph_bookkeeping_through_the_host_stand_in():
    """With graphs (a host stand-in for a CUDA graph), each ring's first
    decode step runs eagerly and is captured, every later one replays it:
    the tokens are the eager engine's, greedy and sampled, over two
    ``generate`` calls and two batch sizes; the prompt-by-token path
    replays the same graph; another cache for a captured ring raises."""
    _, tc, _, tp = _model("nemotron-4-15b")
    eager = tserving.ServeEngine(tc, tp, max_len=24, device="cpu")
    graphed = tserving.ServeEngine(tc, tp, max_len=24, device="cpu")
    graphed._decode = RingDecode(tc, graphs=True, new_graph=lambda: _HostGraph(
        lambda: _ring_leaves(graphed)))
    g = graphed._decode.graphs
    steps = 0
    for B, gkw in ((3, dict(max_new_tokens=6)),
                   (3, dict(max_new_tokens=6, temperature=0.9, seed=1)),
                   (1, dict(max_new_tokens=4))):
        p = _prompts(tc.vocab, B, 5, seed=B)
        want = eager.generate(p, tserving.GenerationConfig(**gkw))
        assert torch.equal(graphed.generate(
            p, tserving.GenerationConfig(**gkw)), want)
        steps += gkw["max_new_tokens"] - 1
    assert g.buckets == [(1, 24), (3, 24)]
    assert (g.captures, g.replays) == (2, steps - 2)
    graphed._prefill = eager._prefill = None
    p = _prompts(tc.vocab, 3, 4, seed=11)
    gc = tserving.GenerationConfig(max_new_tokens=3)
    assert torch.equal(graphed.generate(p, gc), eager.generate(p, gc))
    assert (g.captures, g.replays) == (2, steps - 2 + 4 + 2)
    other = TT.init_decode_cache(tc, 3, 24, device="cpu")
    with pytest.raises(ValueError, match="captured"):
        graphed._decode(graphed.params, torch.zeros(3, dtype=torch.int32),
                        other)


# ---------------------------------------------------------------------------
# X3's block draw
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 - 1, 2 ** 40 + 7])
@pytest.mark.parametrize("B,V", [(1, 50), (3, 512), (8, 1000)])
def test_block_draw_is_jax_categorical_on_the_block(seed, B, V):
    """``jax.random.categorical(key, logits / t)`` over a (B, V) block
    under one key draws row b's column j from the flat count b * V + j:
    the plain block draw gives its tokens, for the key itself and for a
    split's ``sub``; greedy is the argmax; a row at t <= 0 stays greedy."""
    rng = np.random.default_rng(seed % 1000 + B)
    lg = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    _, sub = jax.random.split(key)
    tkey = prng.prng_key(seed)
    tsub = prng.split(tkey)[1]
    for t in (0.8, 1.3):
        temps = torch.full((B,), t)
        for jk, tk in ((key, tkey), (sub, tsub)):
            want = np.asarray(jax.random.categorical(
                jk, jnp.asarray(lg) / t, axis=-1))
            got = sample_block(torch.from_numpy(lg), temps,
                               prng.to_i32(tk)[None], True)
            assert got.dtype == torch.int32
            assert got.numpy().tolist() == want.tolist()
    greedy = sample_block_plain(torch.from_numpy(lg), torch.zeros(B),
                                prng.to_i32(tkey)[None], False)
    assert greedy.numpy().tolist() == lg.argmax(-1).tolist()
    mixed = torch.full((B,), 0.8)
    mixed[0] = 0.0
    got = sample_block_plain(torch.from_numpy(lg), mixed,
                             prng.to_i32(tkey)[None], True)
    assert int(got[0]) == int(lg[0].argmax())


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--requests", "3", "--new-tokens", "4"],
    ["--engine", "legacy", "--requests", "2", "--new-tokens", "5",
     "--temperature", "0.8"],
    ["--engine", "legacy", "--requests", "2", "--new-tokens", "3",
     "--quantize", "int8", "--fuse"],
    # a Mamba stack always serves through the legacy engine
    ["--arch", "mamba2-2_7b", "--requests", "2", "--new-tokens", "3"],
])
def test_serve_decode_example_on_the_cpu(argv, capsys):
    from repro_torch.examples import serve_decode

    assert serve_decode.main(["--device", "cpu", "--arch", "gpt2-medium",
                              *argv]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("serve OK")
    assert "kernel launches: {}" in out        # the CPU counts no launch
