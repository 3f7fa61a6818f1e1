"""The engines at the four reference configurations whose layers the
port has (bert-large-lm, codeqwen1.5-7b, minicpm-2b, nemotron-4-15b),
against the JAX reference engine on the CPU.

At each ``.reduced()`` configuration, with the kernels on (Monarch
``backend="pallas"``, ``use_paged_kernel=True``) and the reference's own
initialized params carried across by ``params_from_numpy``:

* the greedy tokens and counters are identical on a plain trace, and for
  nemotron-4-15b's GQA also through preemption and a copy-on-write fork;
* nemotron-4-15b's compressed engine (int8 factors, fused K and V, int8
  KV pages) agrees on >= 95% of its greedy tokens, the reference's bar
  for int8 pages (``tests/test_kv_quant.py:352``)."""

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

INT8_KV_TOKEN_AGREEMENT = 0.95        # tests/test_kv_quant.py:352
ARCHS = ["bert-large-lm", "codeqwen1.5-7b", "minicpm-2b", "nemotron-4-15b"]


def _kernels_on(cfg):
    return dataclasses.replace(
        cfg, paged_kernel=True,
        monarch=dataclasses.replace(cfg.monarch, backend="pallas"))


_MODELS: dict = {}


def _model(arch):
    """(jax cfg, torch cfg, jax params, torch params) at ``.reduced()``,
    built once a module run."""
    if arch not in _MODELS:
        jc = _kernels_on(jget_config(arch).reduced())
        tc = _kernels_on(tget_config(arch).reduced())
        jp = JT.init_params(jax.random.PRNGKey(0), jc)
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
        _MODELS[arch] = (jc, tc, jp, tp)
    return _MODELS[arch]


def _prompts(vocab):
    rng = np.random.default_rng(10)
    return [rng.integers(0, vocab, n) for n in (3, 24, 5, 18, 2)]


def _shared_prefix_prompts(vocab):
    """Prompts sharing a 14-token prefix, then a repeat of the second and
    an extension of the first: both match a committed partial page, which
    forks copy-on-write."""
    sys_p = list(np.random.default_rng(40).integers(0, vocab, 14))
    prompts = [np.asarray(sys_p + [(17 * i + j) % vocab
                                   for j in range(3 + i % 2)])
               for i in range(4)]
    return prompts + [prompts[1], np.concatenate([prompts[0], [5, 6]])]


TRACES = {
    "plain": (dict(max_slots=2, page_size=4, max_len=48, chunk_size=16),
              "plain", 0),
    "preemption": (dict(max_slots=4, page_size=4, max_len=48, n_pages=9,
                        chunk_size=8), "plain", 0),
    "prefix_cow": (dict(max_slots=4, page_size=4, max_len=48,
                        chunk_size=8), "shared", 1),
}
STAT_KEYS = ("mixed_steps", "decode_tokens", "prefill_tokens", "tokens_out",
             "preemptions", "prefix_hit_tokens", "cow_forks",
             "kernel_dispatches", "dense_fallbacks")


def _serve(pk, cfg, params, trace, **engine_kw):
    kw, kind, stagger = TRACES[trace]
    eng = pk.ContinuousBatchingEngine(cfg, params, use_paged_kernel=True,
                                      **kw, **engine_kw)
    prompts = (_prompts(cfg.vocab) if kind == "plain"
               else _shared_prefix_prompts(cfg.vocab))
    reqs, steps = [], 0
    while prompts or eng.has_work():
        if prompts and (stagger == 0 or steps % 3 == 0):
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


@pytest.mark.parametrize("arch,trace", [
    *((a, "plain") for a in ARCHS),
    ("nemotron-4-15b", "preemption"), ("nemotron-4-15b", "prefix_cow")])
def test_engine_greedy_tokens_identical_to_reference(arch, trace):
    jc, tc, jp, tp = _model(arch)
    jeng, jout = _serve(jserving, jc, jp, trace)
    teng, tout = _serve(tserving, tc, tp, trace, device="cpu")
    assert tout == jout
    assert all(len(o) == 5 for o in tout)
    for key in STAT_KEYS:
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.stats["kernel_dispatches"] == teng.stats["mixed_steps"]
    if trace == "preemption":
        assert teng.stats["preemptions"] > 0
    if trace == "prefix_cow":
        assert teng.stats["cow_forks"] > 0


def test_nemotron_int8_engine_agrees_with_reference():
    """int8 factors, fused projections (K and V only under GQA, as the
    reference fuses them) and int8 KV pages, every kernel on: >= 95% of
    the greedy tokens identical to the reference engine's."""
    jc, tc, jp, tp = _model("nemotron-4-15b")
    opts = dict(quantize="int8", fuse_projections=True, kv_dtype="int8")
    jeng, jout = _serve(jserving, jc, jp, "plain", **opts)
    teng, tout = _serve(tserving, tc, tp, "plain", device="cpu", **opts)
    attn = teng.params["decoder"]["layers"]["attn"]
    assert "wkv" in attn and "wq" in attn and "wqkv" not in attn
    assert teng.kv_dtype == "int8" and teng.weight_bits == 8
    flat = [(a, b) for oa, ob in zip(tout, jout) for a, b in zip(oa, ob)]
    agree = sum(a == b for a, b in flat) / len(flat)
    assert len(flat) == 25 and agree >= INT8_KV_TOKEN_AGREEMENT, agree
    for key in ("mixed_steps", "kernel_dispatches", "dense_fallbacks"):
        assert teng.stats[key] == jeng.stats[key], key
