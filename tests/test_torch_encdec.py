"""Encoder-decoder (seamless-m4t-large-v2: the stubbed audio frontend) and
the stubbed vision frontend (internvl2-76b) of the port against the JAX
reference on the CPU.

The same numpy parameters in the reference's layout
(``tests/_torch_numpy_params.py``) and the same numpy inputs go through
both packages at ``.reduced()``, the port's kernels as their plain
versions (Monarch ``backend="pallas"``, the span kernel on).  fp32
modules agree to 2e-5, logits to ``LOGITS`` (1e-4), tokens exactly:

* cross-attention (``attention_apply(kv_input=...)``, separate and with
  K and V fused) and the bidirectional encoder (``_encode``);
* seamless's forward from ``enc_embeds`` and from ``enc_tokens``, and a
  chain of ``decode_step(enc_out=...)`` through the ring;
* ``launch.steps.make_prefill_step`` / ``make_decode_step``, in fp32 and
  with a bf16 config (fp32 params cast to bf16 at each step; bf16's 2e-2
  of the logits' scale);
* internvl2's forward with ``patch_embeds`` prepended and cut off;
* ``fuse_model`` on seamless: the self-attention's Q, K and V fuse, the
  cross-attention's K and V only, and the logits do not move;
* both engines at both configs serve the text stream (no ``enc_out``:
  the cross-attention attends the block's own tokens, as the
  reference's engines do) with the reference's tokens;
* at tp = 2 the plan splits the encoder and the cross-attention as the
  decoder (served at tp = 2 in ``tests/test_torch_tp_families.py``).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as jserving
import repro_torch.serving as tserving
from _torch_numpy_params import both
from repro.configs import get_config as jget_config
from repro.launch import steps as JS
from repro.models import fuse as JF
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import tree_map
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import steps as TS
from repro_torch.models import fuse as TF
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.sharding.params import split_parts, tp_plan

FP32 = dict(rtol=2e-5, atol=2e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)   # tests/test_torch_models.py
# bf16 (tests/test_kernels.py:17-19's 2e-2), of the logits' scale: the two
# frameworks round their bf16 intermediates at different points, so a
# logit near zero may sit one rounding of a larger one away
BF16_OF_SCALE = 2e-2
SEAMLESS, INTERNVL = "seamless-m4t-large-v2", "internvl2-76b"
# the reference's functions jitted (cfg and train static): one compile
# each instead of one a primitive
_jdecode = jax.jit(JT.decode_step, static_argnums=3)
_jforward = jax.jit(JT.forward, static_argnums=(2, 3))
_jencode = jax.jit(JT._encode, static_argnums=(2, 3))
_jattention = jax.jit(JL.attention_apply, static_argnums=2)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t.astype(jnp.float32))


def _close(a, b, **kw):
    np.testing.assert_allclose(_np(a), _np(b), **(kw or FP32))


def _kernels_on(cfg):
    return dataclasses.replace(
        cfg, paged_kernel=True,
        monarch=dataclasses.replace(cfg.monarch, backend="pallas"))


_MODELS: dict = {}


def _model(arch, dtype="float32"):
    """(jax cfg, torch cfg, jax params, torch params) at ``.reduced()``
    (in ``dtype``), from one numpy tree, built once."""
    if (arch, dtype) not in _MODELS:
        jc = dataclasses.replace(_kernels_on(jget_config(arch).reduced()),
                                 dtype=dtype)
        tc = dataclasses.replace(_kernels_on(tget_config(arch).reduced()),
                                 dtype=dtype)
        jp, tp = both(jc)
        _MODELS[arch, dtype] = (jc, tc, jp, tp)
    return _MODELS[arch, dtype]


def _frames(cfg, B=2, n=6, seed=5):
    return np.random.default_rng(seed).standard_normal(
        (B, n, cfg.d_model)).astype(np.float32)


def _tokens(cfg, B=2, S=7, seed=4):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
def test_cross_attention_matches_reference(fused):
    """Layer 0's ``xattn`` of the reduced seamless: q from the decoder
    stream (7 positions), K and V from 6 encoder frames, every key
    visible, no RoPE; with ``wkv`` fused as ``fuse_model`` fuses it."""
    jc, tc, jp, tp = _model(SEAMLESS)
    jx = jax.tree_util.tree_map(lambda a: a[0],
                                jp["decoder"]["layers"]["xattn"])
    tx = tree_map(lambda a: a[0], tp["decoder"]["layers"]["xattn"])
    if fused:
        jx = JF.fuse_attention(jx, allow_qkv=False)
        tx = TF.fuse_attention(tx, allow_qkv=False)
        assert set(tx) == {"wq", "wkv", "wo"}
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 7, jc.d_model)).astype(np.float32)
    enc = _frames(jc)
    want, _ = _jattention(jx, jnp.asarray(h), jc,
                                 kv_input=jnp.asarray(enc))
    got, cache = TL.attention_apply(tx, torch.from_numpy(h), tc,
                                    kv_input=torch.from_numpy(enc),
                                    backend="pallas")
    assert cache is None and tuple(got.shape) == (2, 7, jc.d_model)
    _close(got, want)


@pytest.mark.parametrize("source", ["enc_embeds", "enc_tokens"])
def test_encoder_matches_reference(source):
    jc, tc, jp, tp = _model(SEAMLESS)
    x = _frames(jc) if source == "enc_embeds" else _tokens(jc, S=6, seed=6)
    want = _jencode(jp, {source: jnp.asarray(x)}, jc, False)
    got = TT._encode(tp, {source: torch.from_numpy(x)}, tc)
    _close(got, want)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["enc_embeds", "enc_tokens"])
def test_seamless_forward_matches_reference(source):
    jc, tc, jp, tp = _model(SEAMLESS)
    enc = _frames(jc) if source == "enc_embeds" else _tokens(jc, S=6, seed=6)
    toks = _tokens(jc)
    want, _ = _jforward(jp, {"tokens": jnp.asarray(toks),
                              source: jnp.asarray(enc)}, jc, False)
    got, aux = TT.forward(tp, {"tokens": torch.from_numpy(toks),
                               source: torch.from_numpy(enc)}, tc,
                          train=False)
    assert got.shape == want.shape == (2, 7, jc.vocab_padded)
    _close(got, want, **LOGITS)
    assert float(aux["lb_loss"]) == 0.0


def test_seamless_decode_chain_with_enc_out():
    """``_encode``, then the decoder prompt token by token through
    ``decode_step(enc_out=...)`` into the ring: every step's logits are
    the reference's, and the last is the forward's last position."""
    jc, tc, jp, tp = _model(SEAMLESS)
    enc, toks = _frames(jc), _tokens(jc)
    jenc = _jencode(jp, {"enc_embeds": jnp.asarray(enc)}, jc, False)
    tenc = TT._encode(tp, {"enc_embeds": torch.from_numpy(enc)}, tc)
    jcache = JT.init_decode_cache(jc, 2, 12)
    tcache = TT.init_decode_cache(tc, 2, 12, device="cpu")
    for t in range(toks.shape[1]):
        jl, jcache = _jdecode(jp, jnp.asarray(toks[:, t]), jcache, jc,
                              enc_out=jenc)
        tl, _ = TT.decode_step(tp, torch.from_numpy(toks[:, t]), tcache, tc,
                               enc_out=tenc)
        _close(tl, jl, **LOGITS)
    full, _ = TT.forward(tp, {"tokens": torch.from_numpy(toks),
                              "enc_embeds": torch.from_numpy(enc)}, tc,
                         train=False)
    _close(tl, full[:, -1], **LOGITS)
    for name in ("k", "v"):
        _close(tcache["layers"]["attn"][name], jcache["layers"]["attn"][name])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_steps_match_reference(dtype):
    """``make_prefill_step``'s logits and ``make_decode_step``'s chain with
    ``enc_out`` (the encoder run in the step's own compute dtype), fp32
    params: in a bf16 config both packages cast them to bf16 first."""
    jc, tc, jp, tp = _model(SEAMLESS, dtype)

    def check(got, want):
        if dtype == "float32":
            _close(got, want, **LOGITS)
        else:
            err = np.abs(_np(got) - _np(want)).max()
            assert err <= BF16_OF_SCALE * np.abs(_np(want)).max(), err

    enc, toks = _frames(jc), _tokens(jc)
    batch_j = {"tokens": jnp.asarray(toks), "enc_embeds": jnp.asarray(enc)}
    batch_t = {"tokens": torch.from_numpy(toks),
               "enc_embeds": torch.from_numpy(enc)}
    want = jax.jit(JS.make_prefill_step(jc))(jp, batch_j)
    got = TS.make_prefill_step(tc)(tp, batch_t)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(
        want.shape)
    check(got, want)
    cast = TS._compute_cast(tp, tc)
    leaves: list = []
    tree_map(leaves.append, cast)
    want_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert {a.dtype for a in leaves} == {want_dt}
    jenc = _jencode(JS._compute_cast(jp, jc), batch_j, jc, False)
    tenc = TT._encode(cast, batch_t, tc)
    jstep, tstep = jax.jit(JS.make_decode_step(jc)), TS.make_decode_step(tc)
    jcache = JT.init_decode_cache(jc, 2, 12)
    tcache = TT.init_decode_cache(tc, 2, 12, device="cpu")
    for t in range(2):
        jl, jcache = jstep(jp, jnp.asarray(toks[:, t]), jcache, jenc)
        tl, _ = tstep(tp, torch.from_numpy(toks[:, t]), tcache, tenc)
        check(tl, jl)
    assert int(tcache["pos"][0]) == 2


def test_internvl2_forward_with_patch_embeds():
    jc, tc, jp, tp = _model(INTERNVL)
    toks = _tokens(jc)
    patches = _frames(jc, n=jc.n_frontend_tokens)
    for batch in ({}, {"patch_embeds": patches}):
        want, _ = _jforward(jp, {"tokens": jnp.asarray(toks),
                                 **{k: jnp.asarray(v)
                                    for k, v in batch.items()}},
                            jc, False)
        got, _ = TT.forward(tp, {"tokens": torch.from_numpy(toks),
                                 **{k: torch.from_numpy(v)
                                    for k, v in batch.items()}},
                            tc, train=False)
        assert got.shape == want.shape == (2, 7, jc.vocab_padded)
        _close(got, want, **LOGITS)
    # the reference's prefill is its forward's last position
    _close(TT.prefill(tp, {"tokens": torch.from_numpy(toks),
                           "patch_embeds": torch.from_numpy(patches)}, tc),
           want[:, -1], **LOGITS)


def test_fuse_encdec_fuses_cross_attention_kv_only():
    jc, tc, jp, tp = _model(SEAMLESS)
    fused = TF.fuse_model(tp)
    dec = fused["decoder"]["layers"]
    assert set(dec["attn"]) == {"wqkv", "wo"}
    assert set(dec["xattn"]) == {"wq", "wkv", "wo"}
    assert set(fused["encoder"]["layers"]["attn"]) == {"wqkv", "wo"}
    assert set(JF.fuse_model(jp)["decoder"]["layers"]["xattn"]) == \
        set(dec["xattn"])
    batch = {"tokens": torch.from_numpy(_tokens(jc)),
             "enc_embeds": torch.from_numpy(_frames(jc))}
    _close(TT.forward(fused, batch, tc, train=False)[0],
           TT.forward(tp, batch, tc, train=False)[0])


# ---------------------------------------------------------------------------
# the engines: the text stream
# ---------------------------------------------------------------------------

_RUNS = {"greedy": dict(max_new_tokens=6),
         "sampled": dict(max_new_tokens=6, temperature=0.8, seed=5)}


@pytest.mark.parametrize("run", sorted(_RUNS))
@pytest.mark.parametrize("arch", [SEAMLESS, INTERNVL])
def test_serve_engine_tokens_equal_reference(arch, run):
    jc, tc, jp, tp = _model(arch)
    je = jserving.ServeEngine(jc, jp, max_len=16)
    te = tserving.ServeEngine(tc, tp, max_len=16, device="cpu")
    p = _tokens(jc, B=3, S=5, seed=7).astype(np.int32)
    gkw = _RUNS[run]
    want = np.asarray(je.generate(jnp.asarray(p),
                                  jserving.GenerationConfig(**gkw)))
    got = te.generate(p, tserving.GenerationConfig(**gkw))
    assert got.numpy().tolist() == want.tolist()


def _serve_text(pk, cfg, params, **engine_kw):
    """The continuous-batching engine (two slots, pages of 4, chunks of
    16) over five prompts of 9 to 16 tokens, 5 new tokens each: every step
    pads to the span bucket 16 or 1, so the reference's mixed step
    compiles twice.  Returns (engine, tokens a request)."""
    eng = pk.ContinuousBatchingEngine(cfg, params, use_paged_kernel=True,
                                      max_slots=2, page_size=4, max_len=48,
                                      chunk_size=16, **engine_kw)
    rng = np.random.default_rng(10)
    reqs = [eng.add_request(rng.integers(0, cfg.vocab, n),
                            pk.SamplingParams(max_new_tokens=5))
            for n in (16, 9, 13, 11, 16)]
    steps = 0
    while eng.has_work():
        eng.step()
        steps += 1
        assert steps < 500
    eng.pool_host.check_invariants()
    assert eng.pool_host.free_pages == eng.pool_host.n_pages - 1
    return eng, [list(r.output_tokens) for r in reqs]


@pytest.mark.parametrize("arch", [SEAMLESS, INTERNVL])
def test_continuous_batching_tokens_equal_reference(arch):
    jc, tc, jp, tp = _model(arch)
    jeng, jout = _serve_text(jserving, jc, jp)
    teng, tout = _serve_text(tserving, tc, tp, device="cpu")
    assert tout == jout and all(len(o) == 5 for o in tout)
    assert teng.stats["mixed_steps"] == jeng.stats["mixed_steps"]


def test_encdec_at_tp2_is_not_ported():
    """At tp = 2 the plan splits the encoder's attention and FFN and the
    cross-attention's heads as the decoder's self-attention: column-
    parallel wq / wk / wv / w1, row-parallel wo / w2."""
    _, tc, _, tp = _model(SEAMLESS)
    plan = tp_plan(tp, tc, types.SimpleNamespace(model=2))
    assert plan.heads and plan.kv_heads and plan.mlp
    for stack, block, name, ax in (
            ("encoder", "attn", "wq", -3), ("encoder", "attn", "wo", -1),
            ("encoder", "ffn", "w1", -3), ("encoder", "ffn", "w2", -1),
            ("decoder", "xattn", "wq", -3), ("decoder", "xattn", "wk", -3),
            ("decoder", "xattn", "wv", -3), ("decoder", "xattn", "wo", -1)):
        leaf = tp[stack]["layers"][block][name]["R"]
        got = split_parts(f"{stack}/layers/{block}/{name}/R", leaf.shape,
                          plan)
        assert got == (ax, ((leaf.shape[ax], True),)), (stack, block, name)
