"""The port's attention-stack model against the JAX reference: norms, RoPE,
FFNs, the full forward, and the paged mixed step on
``get_config("gpt2-medium").reduced()`` with the kernels switched on
(``backend="pallas"``, ``paged_kernel=True``), the reference's own
initialized params carried across by ``params_from_numpy``.

Logits are held at 1e-4: both sides compute in fp32 from the same params,
but sum in other orders (XLA's and PyTorch's CPU matmuls, the Pallas
interpret-mode kernels against the port's plain versions) through two
layers and the unembedding; the observed gap is ~2e-6, and 1e-4 is the
reference's own tolerance for a paged step against its ring-cache path
(tests/test_serving.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jget_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import tree_map
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

LOGITS = dict(rtol=1e-4, atol=1e-4)
F32 = dict(rtol=2e-5, atol=2e-5)


def _kernels_on(cfg):
    return dataclasses.replace(
        cfg, paged_kernel=True,
        monarch=dataclasses.replace(cfg.monarch, backend="pallas"))


def _pair_cfg(**changes):
    jc = dataclasses.replace(jget_config("gpt2-medium").reduced(), **changes)
    tc = dataclasses.replace(tget_config("gpt2-medium").reduced(), **changes)
    return _kernels_on(jc), _kernels_on(tc)


@pytest.fixture(scope="module")
def model():
    jc, tc = _pair_cfg()
    jp = JT.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jc, tc, jp, tp


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_apply_matches(kind):
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((2, 5, 64)) + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    if kind == "rmsnorm":
        p.pop("bias")
    want = JL.norm_apply(jax.tree_util.tree_map(jnp.asarray, p),
                         jnp.asarray(x), kind)
    got = TL.norm_apply(tree_map(torch.from_numpy, p), torch.from_numpy(x),
                        kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_matches(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 4, 5, 6], [40, 41, 42, 43, 44, 45, 46]])
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_gelu_default_differs_and_tanh_matches():
    """``jax.nn.gelu`` defaults to the tanh approximation and
    ``F.gelu`` to exact erf; the port uses ``approximate="tanh"``."""
    x = np.linspace(-4, 4, 101).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    exact = F.gelu(torch.from_numpy(x)).numpy()
    tanh = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    assert np.abs(exact - want).max() > 1e-6
    np.testing.assert_allclose(tanh, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ffn_type", ["gelu", "swiglu", "geglu", "relu2"])
def test_ffn_apply_matches(ffn_type):
    jc, tc = _pair_cfg(ffn_type=ffn_type)
    jp = JL.ffn_init(jax.random.PRNGKey(3), jc)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    x = np.random.default_rng(2).standard_normal((2, 3, 128)).astype(
        np.float32)
    want = JL.ffn_apply(jp, jnp.asarray(x), jc, backend="pallas")
    got = TL.ffn_apply(tp, torch.from_numpy(x), tc, backend="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------


def test_forward_matches_with_kernels_on(model):
    jc, tc, jp, tp = model
    toks = np.random.default_rng(4).integers(0, jc.vocab, (2, 9))
    want, _ = JT.forward(jp, {"tokens": jnp.asarray(toks)}, jc, train=False)
    got, _ = TT.forward(tp, {"tokens": torch.from_numpy(toks)}, tc,
                        train=False)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def test_forward_matches_rmsnorm_gqa_local_window():
    """The other branches of the same code: RMSNorm (with the sqrt(d)
    embedding scale), swiglu, GQA (KV=2) and local/global alternation,
    through the einsum backend."""
    jc, tc = _pair_cfg(norm_type="rmsnorm", ffn_type="swiglu", n_kv_heads=2,
                       attn_pattern=("local", "global"), window=3)
    jc = dataclasses.replace(jc, monarch=dataclasses.replace(
        jc.monarch, backend="einsum"))
    tc = dataclasses.replace(tc, monarch=dataclasses.replace(
        tc.monarch, backend="einsum"))
    jp = JT.init_params(jax.random.PRNGKey(5), jc)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    toks = np.random.default_rng(5).integers(0, jc.vocab, (2, 8))
    want, _ = JT.forward(jp, {"tokens": jnp.asarray(toks)}, jc, train=False)
    got, _ = TT.forward(tp, {"tokens": torch.from_numpy(toks)}, tc,
                        train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def _pools(jc, tc, n_pages, pg):
    return (JT.init_paged_pool(jc, n_pages, pg),
            TT.init_paged_pool(tc, n_pages, pg, device="cpu"))


def _assert_pools_close(jpool, tpool):
    """Every page but the sink (page 0, where padding writes race)."""
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(
            tpool["layers"]["attn"][name][:, 1:].numpy(),
            np.asarray(jpool["layers"]["attn"][name])[:, 1:], **F32)


def test_paged_mixed_step_prefill_then_decode_matches(model):
    """Ragged chunked prefill (spans 5, 3 and 0 in one batch), then span-1
    decode steps: logits and every written page agree."""
    jc, tc, jp, tp = model
    B, pg, MP = 3, 4, 6
    jpool, tpool = _pools(jc, tc, 1 + B * MP, pg)
    table = np.asarray([[1 + b * MP + j for j in range(MP)]
                        for b in range(B)], np.int32)
    rng = np.random.default_rng(6)
    start = np.zeros(B, np.int32)
    for spans in ([5, 3, 0], [3, 5, 4]):
        toks = rng.integers(0, jc.vocab, (B, 8)).astype(np.int32)
        sp = np.asarray(spans, np.int32)
        jl, jpool = JT.paged_mixed_step(
            jp, jnp.asarray(toks), jnp.asarray(start), jnp.asarray(sp),
            jnp.asarray(table), jpool, jc)
        tl, tpool = TT.paged_mixed_step(
            tp, torch.from_numpy(toks), torch.from_numpy(start),
            torch.from_numpy(sp), torch.from_numpy(table), tpool, tc)
        live = sp > 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **LOGITS)
        start = start + sp
    _assert_pools_close(jpool, tpool)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for _ in range(2):
        one = np.ones(B, np.int32)
        jl, jpool = JT.paged_mixed_step(
            jp, jnp.asarray(tok[:, None]), jnp.asarray(start),
            jnp.asarray(one), jnp.asarray(table), jpool, jc)
        tl, tpool = TT.paged_mixed_step(
            tp, torch.from_numpy(tok[:, None]), torch.from_numpy(start),
            torch.from_numpy(one), torch.from_numpy(table), tpool, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
        start = start + 1
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    _assert_pools_close(jpool, tpool)


def test_write_start_confines_writes_like_reference(model):
    """A span crossing its row's copy-on-write fork point writes only the
    positions at or past it (the rest go to the sink) — the same pages
    change in both packages, to the same values."""
    jc, tc, jp, tp = model
    pg = 4
    jpool, tpool = _pools(jc, tc, 5, pg)
    table = np.asarray([[1, 2, 3, 4]], np.int32)
    toks = np.random.default_rng(7).integers(0, jc.vocab, (1, 4)).astype(
        np.int32)
    args = (toks, np.asarray([2], np.int32), np.asarray([4], np.int32),
            table)
    _, jpool = JT.paged_mixed_step(jp, *map(jnp.asarray, args), jpool, jc,
                                   write_start=jnp.asarray([4], jnp.int32))
    _, tpool = TT.paged_mixed_step(tp, *map(torch.from_numpy, args), tpool,
                                   tc, write_start=torch.tensor([4]))
    kp = tpool["layers"]["attn"]["k_pages"]
    assert (kp[:, 1] == 0).all()          # the shared page stays untouched
    assert (kp[:, 2, :2] != 0).any() and (kp[:, 2, 2:] == 0).all()
    _assert_pools_close(jpool, tpool)


def test_cow_copy_pages_matches():
    jc, tc = _pair_cfg()
    rng = np.random.default_rng(8)
    jpool, tpool = _pools(jc, tc, 6, 4)
    for name in ("k_pages", "v_pages"):
        a = rng.standard_normal(tpool["layers"]["attn"][name].shape).astype(
            np.float32)
        jpool["layers"]["attn"][name] = jnp.asarray(a)
        tpool["layers"]["attn"][name] = torch.from_numpy(a.copy())
    # a page copied onto a later source reads the source's OLD contents
    src, dst = np.asarray([2, 4, 0]), np.asarray([4, 5, 0])
    want = JT.cow_copy_pages(jpool, jnp.asarray(src), jnp.asarray(dst))
    got = TT.cow_copy_pages(tpool, torch.from_numpy(src),
                            torch.from_numpy(dst))
    for name in ("k_pages", "v_pages"):
        np.testing.assert_array_equal(
            got["layers"]["attn"][name].numpy(),
            np.asarray(want["layers"]["attn"][name]))


def test_init_params_layout_matches_reference(model):
    """The port's own seeded init has the reference's keys, stacked layer
    axis, shapes and dtypes (values differ: another generator)."""
    jc, tc, jp, _ = model
    tp = TT.init_params(tc, seed=0, device="cpu")
    want = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), jp)
    got = tree_map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]),
                   tp)
    assert got == want
