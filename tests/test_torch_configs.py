"""The four reference configurations whose layers the port has, against the
JAX reference: bert-large-lm (GELU, LayerNorm, tied), codeqwen1.5-7b
(SwiGLU, RMSNorm, RoPE at 1e6, untied), minicpm-2b (SwiGLU, RMSNorm, vocab
122753 padded to 122880) and nemotron-4-15b (squared ReLU, LayerNorm,
GQA 48 over 8 heads, untied).

At each ``.reduced()`` configuration, with the kernels on (Monarch
``backend="pallas"``, ``use_paged_kernel=True``) and the reference's own
initialized params carried across by ``params_from_numpy``, the
forward's logits agree at ``tests/test_torch_models.py``'s LOGITS
tolerance (both sides sum fp32 in other orders; the reference's own
tolerance for a paged step against its ring-cache path).  The engines at
these configurations are held to the reference's in
``tests/test_torch_configs_serving.py``.

At full width: each configuration's fields equal the reference's, and the
Monarch dispatch at the paper policy sends nemotron-4-15b's projections
fused and its feed-forward pair staged, and codeqwen1.5-7b's w2 staged."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro_torch.configs import PORTED_ARCHS
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.monarch import make_dims
from repro_torch.kernels.monarch import fused_fits
from repro_torch.models import transformer as TT

LOGITS = dict(rtol=1e-4, atol=1e-4)   # tests/test_torch_models.py
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


def test_ported_archs():
    assert PORTED_ARCHS == ["gpt2-medium", *ARCHS]


@pytest.mark.parametrize("variant", ["", ":dense", ":mxu"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_the_reference(arch, variant):
    """Every field of the configuration, the Monarch spec's included,
    equal to the reference's, also at ``.reduced()``."""
    j, t = jget_config(arch + variant), tget_config(arch + variant)
    for jc, tc in ((j, t), (j.reduced(), t.reduced())):
        jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
        assert td == jd
        assert tc.vocab_padded == jc.vocab_padded and tc.hd == jc.hd


def test_published_widths_and_layers():
    n = tget_config("nemotron-4-15b")
    assert (n.n_layers, n.d_model, n.n_heads, n.n_kv_heads, n.hd, n.d_ff,
            n.vocab, n.ffn_type, n.norm_type, n.tie_embeddings) == (
        32, 6144, 48, 8, 128, 24576, 256000, "relu2", "layernorm", False)
    q = tget_config("codeqwen1.5-7b")
    assert (q.ffn_type, q.norm_type, q.rope_theta, q.tie_embeddings) == (
        "swiglu", "rmsnorm", 1e6, False)
    m = tget_config("minicpm-2b")
    assert (m.vocab, m.vocab_padded) == (122753, 122880)
    b = tget_config("bert-large-lm")
    assert (b.n_layers, b.d_model, b.vocab, b.tie_embeddings) == (
        24, 1024, 30522, True)


@pytest.mark.parametrize("arch,staged", [
    ("nemotron-4-15b", {"w1", "w2"}),
    ("codeqwen1.5-7b", {"w2"}),
    ("minicpm-2b", set()),
    ("bert-large-lm", set()),
])
def test_monarch_dispatch_at_the_paper_policy(arch, staged):
    """Which projections take the fused kernel (B1) and which the staged
    one (B2) at full width, from the port's ``make_dims`` and
    ``fused_fits`` (shapes only: nothing is allocated)."""
    cfg = tget_config(arch)
    d, f = cfg.d_model, cfg.d_ff
    proj = {"wq": (d, cfg.n_heads * cfg.hd),
            "wk": (d, cfg.n_kv_heads * cfg.hd),
            "wv": (d, cfg.n_kv_heads * cfg.hd),
            "wo": (cfg.n_heads * cfg.hd, d), "w1": (d, f), "w2": (f, d)}
    if cfg.ffn_type == "swiglu":
        proj["wg"] = (d, f)
    got = set()
    for name, (din, dout) in proj.items():
        dims = make_dims(din, dout, policy=cfg.monarch.policy)
        if not fused_fits(dims.l_shape, dims.r_shape):
            got.add(name)
    assert got == staged
    if arch == "nemotron-4-15b":
        w1 = make_dims(d, f, policy="paper")
        w2 = make_dims(f, d, policy="paper")
        assert (w1.k, w1.q) == (96, 96) and (w2.k, w2.q) == (192, 192)
    if arch == "codeqwen1.5-7b":
        w2 = make_dims(f, d, policy="paper")
        assert (w2.k, w2.q) == (120, 128)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jc, tc, jp, tp = _model(arch)
    toks = np.random.default_rng(4).integers(0, jc.vocab, (2, 9))
    want, _ = JT.forward(jp, {"tokens": jnp.asarray(toks)}, jc, train=False)
    got, _ = TT.forward(tp, {"tokens": torch.from_numpy(toks)}, tc,
                        train=False)
    assert got.shape == want.shape == (2, 9, jc.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
