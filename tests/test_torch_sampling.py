"""Threefry sampling in the port (``core.prng``, ``kernels.sample``,
the engine at temperature > 0) against ``jax.random`` and the reference
engine, on the CPU.

* Keys, splits, random bits and uniforms are bitwise ``jax.random``'s, on
  seeds 0, 2**32 - 1 and 2**40 + 7 (cut to its low 32 bits with 64-bit
  types off, as jax cuts it) and others, at vocab sizes 512 and 50432.
* The Gumbel noise is NOT bitwise (about a quarter of the values differ):
  XLA's CPU ``log`` and PyTorch's differ by one ulp on some inputs.  Each
  of the noise's two logs is held within one ulp of XLA's, and the noise
  within one ulp of its own value plus 2**-23 (one ulp of the inner log y
  moves -log(y) by at most ulp(y) / y <= 2**-23).
* Categorical draws are identical, and the engine's draw
  (``sample_tokens_plain``: the reference's ``_split_rows`` then
  ``_sample_rows``) gives the reference's tokens and carried keys.
* The engine at temperature 0.9 serves the reference engine's tokens on
  the reference's per-request seed determinism trace
  (``tests/test_serving.py:1012``), through preemption (``resume_key``)
  and through a copy-on-write fork, and ``generate`` seeds row b with
  ``seed + b`` as the reference does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as jserving
import repro_torch.serving as tserving
from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro.serving.engine import _sample_rows, _split_rows
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import prng
from repro_torch.kernels.sample import (gumbel_noise, sample_tokens,
                                        sample_tokens_plain)

SEEDS = [0, 1, 7, 2 ** 31, 2 ** 32 - 1, 2 ** 40 + 7]
VOCABS = [512, 50432]
PACKAGES = {"jax": jserving, "torch": tserving}


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32).astype(np.int64)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 steps (same-sign values)."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS + [-1, 12345678901])
def test_prng_key_is_jax_prngkey(seed):
    assert np.array_equal(prng.prng_key(seed).numpy(),
                          _u32(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [2, 3, 8])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_is_bitwise(seed, num):
    key = jax.random.PRNGKey(seed)
    want = _u32(jax.random.split(key, num))
    got = prng.split(prng.prng_key(seed), num).numpy()
    assert np.array_equal(got, want)
    # split of a batch of keys, one row each (the engine's _split_rows)
    keys = jnp.stack([key, jax.random.PRNGKey(seed + 1)])
    want = _u32(jax.vmap(lambda k: jax.random.split(k, num))(keys))
    got = prng.split(torch.from_numpy(_u32(keys)), num).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("V", VOCABS)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_are_bitwise(seed, V):
    key = jax.random.PRNGKey(seed)
    tkey = prng.prng_key(seed)
    assert np.array_equal(prng.random_bits(tkey, V).numpy(),
                          _u32(jax.random.bits(key, (V,), jnp.uint32)))
    tiny = float(np.finfo(np.float32).tiny)
    for lo, hi in ((0.0, 1.0), (tiny, 1.0)):
        want = np.asarray(jax.random.uniform(key, (V,), minval=lo,
                                             maxval=hi))
        got = prng.uniform(tkey, V, lo, hi).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("V", VOCABS)
@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_noise_within_one_ulp_of_each_log(seed, V):
    """Not bitwise: the two logs are each within one ulp of XLA's, so
    the noise differs by at most what one ulp of the inner log moves."""
    key = jax.random.PRNGKey(seed)
    u = prng.uniform(prng.prng_key(seed), V, prng.TINY, 1.0)
    want = np.asarray(jax.random.gumbel(key, (V,)))
    inner_j = np.array(jnp.log(jnp.asarray(u.numpy())))
    inner_t = torch.log(u).numpy()
    assert _ulps(inner_t, inner_j).max() <= 1
    outer_t = (-torch.log(-torch.from_numpy(inner_j))).numpy()
    assert _ulps(outer_t, want).max() <= 1
    got = prng.gumbel(prng.prng_key(seed), V).numpy()
    w = want.astype(np.float64)
    bound = np.spacing(np.abs(want)).astype(np.float64) + 2.0 ** -23
    assert (np.abs(got.astype(np.float64) - w) <= bound).all()
    # the debug entry's CPU path is the same noise
    keys = prng.to_i32(prng.prng_key(seed)[None])
    assert torch.equal(gumbel_noise(keys, V)[0], torch.from_numpy(got))


def _logits(B, V, seed, scale=3.0):
    return (scale * np.random.default_rng(seed).standard_normal((B, V))
            ).astype(np.float32)


@pytest.mark.parametrize("V", VOCABS)
def test_categorical_draws_identical(V):
    keys = np.stack([_u32(jax.random.PRNGKey(s)) for s in SEEDS])
    for r in range(4):
        lg = _logits(len(SEEDS), V, r, scale=1.0 + r)
        want = np.asarray(jax.vmap(jax.random.categorical)(
            jnp.asarray(keys.astype(np.uint32)), jnp.asarray(lg)))
        got = prng.categorical(torch.from_numpy(keys),
                               torch.from_numpy(lg)).numpy()
        assert np.array_equal(got, want)


@pytest.mark.parametrize("draw", [False, True])
@pytest.mark.parametrize("V", VOCABS)
def test_sample_tokens_plain_is_split_then_sample_rows(V, draw):
    """The engine's draw against the reference's ``_split_rows`` and
    ``_sample_rows``: tokens, and the carry kept where the row samples;
    greedy rows (temperature <= 0) take the argmax, ties to the first
    index.  Without ``draw`` every row is greedy."""
    B = len(SEEDS)
    keys_np = np.stack([_u32(jax.random.PRNGKey(s)) for s in SEEDS])
    temps_np = np.asarray([0.9, 0.0, 0.5, 1.3, -1.0, 0.9][:B], np.float32)
    if not draw:
        temps_np[:] = 0.0
    mask_np = np.asarray([1, 1, 0, 1, 1, 0][:B], bool)
    lg = _logits(B, V, 9)
    lg[1, [3, 7]] = lg[1].max() + 1.0   # a tie: the first index wins
    jkeys = jnp.asarray(keys_np.astype(np.uint32))
    jtemps = jnp.asarray(temps_np)
    draw_k, carry = _split_rows(jkeys)
    want = np.asarray(_sample_rows(jnp.asarray(lg), jtemps, draw_k))
    want_keys = np.where(mask_np[:, None], _u32(carry), keys_np)
    keys = prng.to_i32(torch.from_numpy(keys_np))
    got = sample_tokens(torch.from_numpy(lg), torch.from_numpy(temps_np),
                        keys, torch.from_numpy(mask_np), draw)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert got[1] == 3
    assert np.array_equal(prng.from_i32(keys).numpy(), want_keys)
    again = prng.to_i32(torch.from_numpy(keys_np))
    assert torch.equal(sample_tokens_plain(
        torch.from_numpy(lg), torch.from_numpy(temps_np), again,
        torch.from_numpy(mask_np), draw), got)


def test_i32_words_round_trip():
    words = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1])
    bits = prng.to_i32(words)
    assert bits.dtype == torch.int32
    assert bits.tolist() == [0, 1, 2 ** 31 - 1, -2 ** 31, -1]
    assert torch.equal(prng.from_i32(bits), words)


# ---------------------------------------------------------------------------
# the engines at temperature > 0
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


def _engine(k, model, **kw):
    jc, tc, jp, tp = model
    if k == "jax":
        return jserving.ContinuousBatchingEngine(jc, jp, **kw)
    return tserving.ContinuousBatchingEngine(tc, tp, device="cpu", **kw)


def test_per_request_seed_determinism_matches_reference(model):
    """``tests/test_serving.py::test_per_request_seed_determinism``'s
    three runs in both engines: the same tokens run by run; and within
    the port, the same seed gives the same tokens whatever the batch and
    chunk size, another seed other tokens."""
    vocab = model[0].vocab
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(4), (8,), 0,
                                           vocab))
    other = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (5,), 0,
                                          vocab))
    out = {}
    for k, pk in PACKAGES.items():
        def run_with(arrivals, **kw):
            eng = _engine(k, model, max_slots=4, page_size=4, max_len=32,
                          **kw)
            reqs = [eng.add_request(p, sp) for p, sp in arrivals]
            eng.run()
            return reqs

        sp7 = pk.SamplingParams(max_new_tokens=6, temperature=0.9, seed=7)
        a = run_with([(prompt, sp7)])[0]
        b = run_with([(other, pk.SamplingParams(max_new_tokens=6)),
                      (prompt, sp7)], chunk_size=3)[1]
        c = run_with([(prompt, pk.SamplingParams(
            max_new_tokens=6, temperature=0.9, seed=8))])[0]
        out[k] = [a.output_tokens, b.output_tokens, c.output_tokens]
    assert out["torch"] == out["jax"]
    a, b, c = out["torch"]
    assert a == b and c != a


def _sampled_trace(k, model, prompts, stagger, **kw):
    pk = PACKAGES[k]
    eng = _engine(k, model, use_paged_kernel=True, **kw)
    reqs, pending, steps = [], list(prompts), 0
    while pending or eng.has_work():
        if pending and (stagger == 0 or steps % stagger == 0):
            while pending:
                i = len(reqs)
                reqs.append(eng.add_request(pending.pop(0), pk.SamplingParams(
                    max_new_tokens=6, temperature=0.9 if i % 3 else 0.0,
                    seed=100 + i)))
                if stagger:
                    break
        eng.step()
        steps += 1
        assert steps < 500
    eng.pool_host.check_invariants()
    return eng, reqs


def test_sampled_tokens_through_preemption_match_reference(model):
    """A pool too small for the demand preempts sampling requests mid
    stream; on resume each continues from its ``resume_key``."""
    prompts = [np.random.default_rng(10).integers(0, model[0].vocab, n)
               for n in (3, 24, 5, 18, 2)]
    kw = dict(max_slots=4, page_size=4, max_len=48, n_pages=9, chunk_size=8)
    jeng, jreqs = _sampled_trace("jax", model, prompts, 0, **kw)
    teng, treqs = _sampled_trace("torch", model, prompts, 0, **kw)
    assert [r.output_tokens for r in treqs] == \
        [r.output_tokens for r in jreqs]
    assert teng.stats["preemptions"] == jeng.stats["preemptions"] > 0
    resumed = [(t, j) for t, j in zip(treqs, jreqs) if t.num_preemptions]
    assert resumed and all(
        np.array_equal(t.resume_key, np.asarray(j.resume_key))
        and t.resume_key.dtype == np.uint32 for t, j in resumed)


def test_sampled_tokens_through_copy_on_write_match_reference(model):
    vocab = model[0].vocab
    sys_p = list(np.random.default_rng(40).integers(0, vocab, 14))
    prompts = [np.asarray(sys_p + [(17 * i + j) % vocab
                                   for j in range(3 + i % 2)])
               for i in range(4)]
    prompts += [prompts[1], np.concatenate([prompts[0], [5, 6]])]
    kw = dict(max_slots=4, page_size=4, max_len=48, chunk_size=8)
    jeng, jreqs = _sampled_trace("jax", model, prompts, 3, **kw)
    teng, treqs = _sampled_trace("torch", model, prompts, 3, **kw)
    assert [r.output_tokens for r in treqs] == \
        [r.output_tokens for r in jreqs]
    assert teng.stats["cow_forks"] == jeng.stats["cow_forks"] > 0


def test_generate_seeds_each_row_as_the_reference(model):
    prompts = np.random.default_rng(2).integers(0, model[0].vocab, (3, 6))
    out = {}
    for k, pk in PACKAGES.items():
        eng = _engine(k, model, max_slots=4, page_size=4, max_len=32)
        out[k] = np.asarray(eng.generate(prompts, pk.GenerationConfig(
            max_new_tokens=5, temperature=0.7, seed=11)))
    assert np.array_equal(out["torch"], out["jax"])
    assert len({tuple(r) for r in out["torch"]}) > 1
