"""Mamba2 (SSD) and the Zamba2 hybrid stack of the port against the JAX
reference on the CPU.

The same numpy inputs (and, for the models, the same numpy parameters in
the reference's layout, ``tests/_torch_numpy_params.py``) go through
``repro.models.mamba2`` / ``repro.models.transformer`` and their
counterparts in ``repro_torch``.  fp32 modules agree to 2e-5, logits to
``LOGITS`` (1e-4, ``tests/test_torch_models.py``), tokens exactly:

* ``ssd_chunked`` at chunks 4, 8 and 16, continued from an ``init_state``
  (outputs and final states), and the sequential ``ssd_reference``;
* ``mamba_apply`` on its chunked path and on its recurrent S = 1 step,
  whose ``conv`` and ``ssm`` states the port writes in place; at bf16
  activations over fp32 parameters (which the reference's stacks refuse,
  and its step alone runs) the fp32-stored conv state is read at the
  reference's window dtype, on either Monarch path;
* decode equals forward for a Mamba and a hybrid stack (the reference's
  ``_decode_consistency``, ``tests/test_models.py:68-103``), each decode
  step's logits also the reference's;
* the ``.reduced()`` mamba2-2.7b and zamba2-7b forwards (kernels' plain
  versions, Monarch ``backend="pallas"``);
* ``ServeEngine`` greedy and sampled tokens equal the reference's (the
  prompt token by token, ``_prefill = None``), and with the decode step
  as a graph (the host stand-in of ``tests/test_torch_step_graphs.py``)
  equal the eager engine's: the graph writes the states in place;
* ``ContinuousBatchingEngine`` refuses a Mamba or hybrid stack with the
  reference's ``ValueError``, and a prompt that is not a multiple of the
  chunk raises in the chunked path, as the reference's assert does; at
  tp = 2 the plan splits a Mamba stack's SSM heads (served at tp = 2
  in ``tests/test_torch_tp_families.py``).
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
from repro.models import mamba2 as JM
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import SSMConfig as JSSMConfig
from repro_torch import tree_map
from repro_torch.configs import get_config as tget_config
from repro_torch.models import mamba2 as TM
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.models.config import SSMConfig as TSSMConfig
from repro_torch.serving.ring_graphs import RingDecode
from repro_torch.sharding.params import split_parts, tp_plan
from test_torch_step_graphs import _HostGraph

FP32 = dict(rtol=2e-5, atol=2e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)   # tests/test_torch_models.py
# the reference's functions jitted (cfg, chunk and train static): one
# compile each instead of one a primitive
_jdecode = jax.jit(JT.decode_step, static_argnums=3)
_jforward = jax.jit(JT.forward, static_argnums=(2, 3))
_jssd = jax.jit(JM.ssd_chunked, static_argnames=("chunk",))
_jmamba = jax.jit(JM.mamba_apply, static_argnums=2,
                  static_argnames=("backend",))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _close(a, b, **kw):
    np.testing.assert_allclose(_np(a), _np(b), **(kw or FP32))


def _ssd_inputs(seed, b=2, S=16, H=4, P=8, G=2, N=16):
    """The reference test's shapes (tests/test_models.py:31-36), drawn
    with numpy: x, dt = softplus(normal) > 0, A < 0, B, C."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, S, H, P)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(f)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(f)
    B = rng.standard_normal((b, S, G, N)).astype(f)
    C = rng.standard_normal((b, S, G, N)).astype(f)
    return x, dt, A, B, C


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_reference(chunk):
    """Outputs and final states, over the whole sequence and continued
    from the first half's state."""
    args = _ssd_inputs(chunk)
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    jy, js = _jssd(*jargs, chunk=chunk)
    ty, ts = TM.ssd_chunked(*targs, chunk=chunk)
    _close(ty, jy)
    _close(ts, js)
    assert ty.dtype == torch.float32 and tuple(ts.shape) == (2, 4, 8, 16)
    half = [a[:, :8] if a.ndim > 1 else a for a in args]
    rest = [a[:, 8:] if a.ndim > 1 else a for a in args]
    _, js1 = _jssd(*[jnp.asarray(a) for a in half], chunk=chunk)
    _, ts1 = TM.ssd_chunked(*[torch.from_numpy(a) for a in half],
                            chunk=chunk)
    jy2, js2 = _jssd(*[jnp.asarray(a) for a in rest], chunk=chunk,
                              init_state=js1)
    ty2, ts2 = TM.ssd_chunked(*[torch.from_numpy(a) for a in rest],
                              chunk=chunk, init_state=ts1)
    _close(ty2, jy2)
    _close(ts2, js2)
    _close(ts2, ts)         # the continued state is the whole pass's
    _close(torch.cat([TM.ssd_chunked(*[torch.from_numpy(a) for a in half],
                                     chunk=chunk)[0], ty2], 1), ty)


def test_ssd_reference_matches_reference():
    args = _ssd_inputs(1)
    want = JM.ssd_reference(*[jnp.asarray(a) for a in args])
    got = TM.ssd_reference(*[torch.from_numpy(a) for a in args])
    _close(got, want)
    _close(TM.ssd_chunked(*[torch.from_numpy(a) for a in args], chunk=4)[0],
           got)
    with pytest.raises(AssertionError):     # S not a multiple of the chunk
        TM.ssd_chunked(*[torch.from_numpy(a[:, :10] if a.ndim > 1 else a)
                         for a in args], chunk=4)


def test_softplus_is_jax_softplus():
    x = np.concatenate([np.linspace(-40, 40, 801),
                        [-100.0, 25.0, 30.0, 100.0]]).astype(np.float32)
    _close(TM.softplus(torch.from_numpy(x)), jax.nn.softplus(x),
           rtol=1e-6, atol=1e-30)


# ---------------------------------------------------------------------------
# the Mamba block
# ---------------------------------------------------------------------------

_MODELS: dict = {}


def _reduced(arch):
    """(jax cfg, torch cfg (kernels' plain versions), jax params, torch
    params) at ``.reduced()``, from one numpy tree, built once."""
    if arch not in _MODELS:
        jc = jget_config(arch).reduced()
        tc = tget_config(arch).reduced()
        tc = dataclasses.replace(tc, monarch=dataclasses.replace(
            tc.monarch, backend="pallas"))
        jp, tp = both(jc)
        _MODELS[arch] = (jc, tc, jp, tp)
    return _MODELS[arch]


@pytest.mark.parametrize("path", ["chunked", "recurrent"])
def test_mamba_apply_matches_reference(path):
    """Layer 0 of the reduced mamba2-2.7b: the chunked path over 16
    positions (two chunks of 8), and the recurrent step from a random
    state, whose new ``conv`` and ``ssm`` states the port writes into the
    cache it was given."""
    jc, tc, jp, tp = _reduced("mamba2-2.7b")
    jl = jax.tree_util.tree_map(lambda a: a[0],
                                jp["decoder"]["layers"]["mamba"])
    tl = tree_map(lambda a: a[0], tp["decoder"]["layers"]["mamba"])
    rng = np.random.default_rng(2)
    S = 16 if path == "chunked" else 1
    x = rng.standard_normal((2, S, jc.d_model)).astype(np.float32)
    if path == "chunked":
        want, _ = _jmamba(jl, jnp.asarray(x), jc)
        got, cache = TM.mamba_apply(tl, torch.from_numpy(x), tc,
                                    backend="pallas")
        assert cache is None
        _close(got, want)
        return
    one = TM.mamba_cache_init(tc, 2, device="cpu")
    state = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in one.items()}
    want, jnew = _jmamba(jl, jnp.asarray(x), jc,
                                cache={k: jnp.asarray(v)
                                       for k, v in state.items()})
    tcache = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    conv, ssm = tcache["conv"], tcache["ssm"]
    got, tnew = TM.mamba_apply(tl, torch.from_numpy(x), tc, cache=tcache,
                               backend="pallas")
    assert tnew is tcache and tnew["conv"] is conv and tnew["ssm"] is ssm
    _close(got, want)
    for k in ("conv", "ssm"):
        _close(tnew[k], jnew[k])
    assert tnew["ssm"].dtype == torch.float32


def _bf16(arch):
    """The reduced config at bf16 activations, its parameters fp32."""
    jc, tc, jp, tp = _reduced(arch)
    return (dataclasses.replace(jc, dtype="bfloat16"),
            dataclasses.replace(tc, dtype="bfloat16"), jp, tp)


def test_bf16_over_fp32_params_refused_by_the_reference_served_here():
    """At bf16 activations over fp32 parameters the reference's stacks do
    not run: their layer scan's carry turns fp32, a ``TypeError`` (so its
    serving steps cast the parameters first, ``_compute_cast``).  The
    port's ``ServeEngine`` serves them, its conv state stored in fp32."""
    jc, tc, jp, tp = _bf16("mamba2-2.7b")
    with pytest.raises(TypeError, match="carry"):
        JT.decode_step(jp, jnp.zeros((2,), jnp.int32),
                       JT.init_decode_cache(jc, 2, 8), jc)
    eng = tserving.ServeEngine(tc, tp, max_len=8, device="cpu")
    out = eng.generate(np.zeros((2, 3), np.int32),
                       tserving.GenerationConfig(max_new_tokens=2))
    assert tuple(out.shape) == (2, 2)
    ring = eng._rings[2]["layers"]
    assert ring["conv"].dtype == ring["ssm"].dtype == torch.float32
    assert bool(torch.isfinite(ring["conv"]).all())


@pytest.mark.parametrize("backend", ["einsum", "pallas"])
def test_bf16_step_over_fp32_params_keeps_the_window_unrounded(backend):
    """The reference's recurrent step alone runs at bf16 activations over
    fp32 parameters, and its conv state takes the window's dtype after
    the first step: fp32 where the in projection gives fp32 (the einsum
    path), bf16 where it gives the activations' dtype (the kernel's).
    The port stores the state in fp32 and reads it at that dtype: three
    chained steps of layer 0 from a zero state equal the reference's, the
    states to fp32 2e-5, the outputs to 2e-2 of their scale (the gated
    norm casts to bf16)."""
    jc, tc, jp, tp = _bf16("mamba2-2.7b")
    jl = jax.tree_util.tree_map(lambda a: a[0],
                                jp["decoder"]["layers"]["mamba"])
    tl = tree_map(lambda a: a[0], tp["decoder"]["layers"]["mamba"])
    jcache = JM.mamba_cache_init(jc, 2, jnp.bfloat16)
    tcache = TM.mamba_cache_init(tc, 2, device="cpu")
    xs = np.random.default_rng(9).standard_normal((3, 2, 1, jc.d_model))
    for x in xs.astype(np.float32):
        want, jcache = _jmamba(jl, jnp.asarray(x, jnp.bfloat16), jc,
                               cache=jcache, backend=backend)
        got, _ = TM.mamba_apply(tl, torch.from_numpy(x).bfloat16(), tc,
                                cache=tcache, backend=backend)
        assert jcache["conv"].dtype == (jnp.float32 if backend == "einsum"
                                        else jnp.bfloat16)
        for k in ("conv", "ssm"):     # fp32 arithmetic on both sides
            _close(tcache[k], jcache[k])
        # the output passes the gated norm's cast to bf16: 2e-2 of its scale
        want = np.asarray(want, np.float32)
        assert np.abs(_np(got) - want).max() <= 2e-2 * np.abs(want).max()


# ---------------------------------------------------------------------------
# stacks: decode == forward, and the reduced configs' logits
# ---------------------------------------------------------------------------

_BASE = dict(d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab=128, dtype="float32")   # tests/test_models.py:17-18
_STACKS = {"mamba": dict(layer_kind="mamba"),
           "hybrid": dict(n_layers=5, layer_kind="hybrid",
                          shared_attn_every=2)}


@pytest.mark.parametrize("kind", sorted(_STACKS))
def test_decode_matches_forward(kind):
    """The reference's ``_decode_consistency``: S decode steps give the
    forward's logits (2e-3, its tolerance); each step's logits are the
    reference's (1e-4) and so is the final cache (2e-5)."""
    kw = {**_BASE, **_STACKS[kind]}
    jc = JModelConfig(name="m", ssm=JSSMConfig(d_state=16, head_dim=32,
                                               chunk=8), **kw)
    tc = TModelConfig(name="m", ssm=TSSMConfig(d_state=16, head_dim=32,
                                               chunk=8), **kw)
    jp, tp = both(jc, seed=3)
    B, S = 2, 8
    toks = np.random.default_rng(1).integers(0, jc.vocab, (B, S))
    full, _ = TT.forward(tp, {"tokens": torch.from_numpy(toks)}, tc,
                         train=False)
    jcache = JT.init_decode_cache(jc, B, S + 4)
    tcache = TT.init_decode_cache(tc, B, S + 4, device="cpu")
    steps = []
    for t in range(S):
        jl, jcache = _jdecode(jp, jnp.asarray(toks[:, t]), jcache, jc)
        tl, _ = TT.decode_step(tp, torch.from_numpy(toks[:, t]), tcache, tc)
        _close(tl, jl, **LOGITS)
        steps.append(tl)
    _close(torch.stack(steps, 1), full, rtol=2e-3, atol=2e-3)
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
    tflat: dict = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            tflat[path] = node

    walk(tcache, ())
    assert len(jleaves) == len(tflat)
    for path, leaf in jleaves:
        key = tuple(p.key for p in path)
        assert tuple(tflat[key].shape) == leaf.shape
        _close(tflat[key], leaf)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_reduced_forward_matches_reference(arch):
    jc, tc, jp, tp = _reduced(arch)
    toks = np.random.default_rng(4).integers(0, jc.vocab, (2, 16))
    want, _ = _jforward(jp, {"tokens": jnp.asarray(toks)}, jc, False)
    got, aux = TT.forward(tp, {"tokens": torch.from_numpy(toks)}, tc,
                          train=False)
    assert got.shape == want.shape == (2, 16, jc.vocab_padded)
    _close(got, want, **LOGITS)
    assert float(aux["lb_loss"]) == 0.0
    if arch == "zamba2-7b":   # one group of 6, its shared block, a tail
        assert TT.hybrid_groups(tc) == (1, 1)
        assert set(tp["decoder"]) == {"groups", "shared_attn", "tail"}
        assert tp["decoder"]["groups"]["mamba"]["A_log"].shape[:2] == (1, 6)
    with pytest.raises(AssertionError):   # 12 positions, chunks of 8
        TT.forward(tp, {"tokens": torch.from_numpy(toks[:, :12])}, tc)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

_RUNS = {"greedy": dict(max_new_tokens=6),
         "sampled": dict(max_new_tokens=6, temperature=0.8, seed=5)}


@pytest.mark.parametrize("run", sorted(_RUNS))
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_serve_engine_tokens_equal_reference(arch, run):
    jc, tc, jp, tp = _reduced(arch)
    je = jserving.ServeEngine(jc, jp, max_len=16)
    te = tserving.ServeEngine(tc, tp, max_len=16, device="cpu")
    assert je._prefill is None and te._prefill is None
    p = np.random.default_rng(7).integers(0, jc.vocab, (3, 5)).astype(
        np.int32)
    gkw = _RUNS[run]
    want = np.asarray(je.generate(jnp.asarray(p),
                                  jserving.GenerationConfig(**gkw)))
    got = te.generate(p, tserving.GenerationConfig(**gkw))
    assert got.numpy().tolist() == want.tolist()
    # the states are zeroed at every generate: a second gives the same
    assert torch.equal(te.generate(p, tserving.GenerationConfig(**gkw)),
                       got)


def test_decode_graph_writes_the_states_in_place():
    """zamba2's decode step as a graph (the host stand-in): the prompt
    token by token and the new tokens all replay one graph, whose ring
    and Mamba states are its static state, and the tokens are the eager
    engine's."""
    _, tc, _, tp = _reduced("zamba2-7b")
    eager = tserving.ServeEngine(tc, tp, max_len=16, device="cpu")
    graphed = tserving.ServeEngine(tc, tp, max_len=16, device="cpu")

    def leaves():
        out: list = []
        for cache in graphed._rings.values():
            tree_map(out.append, cache)
        return out

    graphed._decode = RingDecode(tc, graphs=True, new_graph=lambda:
                                 _HostGraph(leaves))
    p = np.random.default_rng(8).integers(0, tc.vocab, (2, 4))
    for gkw in _RUNS.values():
        gc = tserving.GenerationConfig(**gkw)
        assert torch.equal(graphed.generate(p, gc), eager.generate(p, gc))
    g = graphed._decode.graphs
    assert g.buckets == [(2, 16)]
    assert (g.captures, g.replays) == (1, 2 * (4 + 6 - 1) - 1)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_continuous_batching_refuses_ssm_stacks(arch):
    jc, tc, jp, tp = _reduced(arch)
    with pytest.raises(ValueError) as jerr:
        jserving.ContinuousBatchingEngine(jc, jp)
    with pytest.raises(ValueError) as terr:
        tserving.ContinuousBatchingEngine(tc, tp, device="cpu")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="attn layers"):
        TT.init_paged_pool(tc, 4, 4, device="cpu")


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_ssm_stacks_at_tp2_are_not_ported(arch):
    """At tp = 2 the plan splits the Mamba leaves' SSM heads over "model"
    as the reference's rules do (conv_w / conv_b's x channels, A_log,
    dt_bias, D, norm_scale, out_proj's input blocks), keeps the B and C
    channels and in_proj whole, and splits a hybrid's shared attention."""
    _, tc, _, tp = _reduced(arch)
    plan = tp_plan(tp, tc, types.SimpleNamespace(model=2))
    assert plan.ssm_heads and plan.groups()["ssm_heads"]
    if arch == "zamba2-7b":
        assert plan.heads and plan.kv_heads
    s = tc.ssm
    d_inner, gn = s.expand * tc.d_model, s.n_groups * s.d_state
    stem = "layers" if arch == "mamba2-2.7b" else "groups"
    mamba = tp["decoder"][stem]["mamba"]
    path = f"decoder/{stem}/mamba"
    assert split_parts(f"{path}/conv_w", mamba["conv_w"].shape, plan) == (
        -1, ((d_inner, True), (gn, False), (gn, False)))
    for name in ("A_log", "dt_bias", "D", "norm_scale"):
        n = mamba[name].shape[-1]
        assert split_parts(f"{path}/{name}", mamba[name].shape, plan) == (
            -1, ((n, True),))
    assert split_parts(f"{path}/out_proj/L", mamba["out_proj"]["L"].shape,
                       plan)[0] == -3
    assert split_parts(f"{path}/in_proj/L", mamba["in_proj"]["L"].shape,
                       plan) is None
