"""The training loss and gradients of the port's other model families
against the JAX reference on the CPU.

``transformer.loss_fn`` and every gradient leaf of the port
(``launch.steps.value_and_grad``) against the reference's jitted
``jax.value_and_grad`` of ``loss_fn``, on the same numpy parameters
(``tests/_torch_numpy_params.py``) and batch, for a Mamba2 stack (the SSD
scan's backward), a Zamba2-style hybrid (two groups of two Mamba layers
under one shared attention block, then a tail layer; remat per group), an
encoder-decoder over stubbed audio frames (``enc_embeds``) and a vision
frontend whose ``patch_embeds`` are prepended: loss 1e-5 relative,
gradients 2e-4 / 2e-5 (``tests/test_substrate.py:88,92``).  The hybrid's
``cfg.remat`` "none", "full" and "dots" give ``torch.equal`` gradients,
"full" recomputing each group's products and "dots" only the batched
ones; one train step of each family runs.

The port runs its ops on one thread here, as in
``tests/test_torch_train.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_numpy_params import both
from repro.models.config import ModelConfig as JConfig
from repro.models.config import SSMConfig as JSSM
from repro_torch import optim as TO
from repro_torch.launch import steps as TS
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.config import SSMConfig as TSSM
from repro_torch.optim.adamw import leaves_with_paths
from test_torch_train import _OpCount, reference_grads

LOSS = dict(rtol=1e-5, atol=0.0)
FP32 = dict(rtol=2e-4, atol=2e-5)      # tests/test_substrate.py:88,92
BASE = dict(d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=128, dtype="float32")   # tests/test_models.py:17-18
SSM = dict(d_state=16, head_dim=32, chunk=8)
FAMILIES = {
    "mamba": dict(layer_kind="mamba"),
    "hybrid": dict(n_layers=5, layer_kind="hybrid", shared_attn_every=2),
    "encdec": dict(encdec=True, n_enc_layers=2, frontend="audio"),
    "vision": dict(frontend="vision"),
}
B, S, N_FRONT = 2, 16, 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name):
    kw = {**BASE, **FAMILIES[name]}
    ssm = name in ("mamba", "hybrid")
    return (JConfig(name=name, ssm=JSSM(**SSM) if ssm else None, **kw),
            TConfig(name=name, ssm=TSSM(**SSM) if ssm else None, **kw))


def _batch(name, cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
           "loss_mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    if name == "encdec":
        out["enc_embeds"] = rng.standard_normal(
            (B, N_FRONT, cfg.d_model)).astype(np.float32)
    if name == "vision":
        out["patch_embeds"] = rng.standard_normal(
            (B, N_FRONT, cfg.d_model)).astype(np.float32)
    return out


def _flat_ref(tree) -> dict:
    return {tuple(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def runs():
    """Each family's (reference (loss, grads), port's (loss, aux,
    grads)), once; the reference's jitted on threads."""
    cases = {name: _pair(name) for name in FAMILIES}
    ref = reference_grads(cases, 3, _batch)
    out = {}
    for name, (jc, tc) in cases.items():
        _, tp = both(jc, seed=3)
        jl, _, jg = ref[name]
        out[name] = ((float(jl), _flat_ref(jg)), TS.value_and_grad(tc)(
            tp, TS.batch_to(_batch(name, jc), "cpu")))
    return out


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_loss_and_every_gradient_match_reference(runs, name):
    (jl, jg), (tl, taux, tg) = runs[name]
    np.testing.assert_allclose(float(tl), jl, **LOSS)
    assert float(taux["lb_loss"]) == 0.0
    got = {path: g.numpy() for path, g in leaves_with_paths(tg)}
    assert sorted(got) == sorted(jg)
    for path, want in jg.items():
        assert got[path].dtype == np.float32
        np.testing.assert_allclose(got[path], want, err_msg=str(path), **FP32)
    # every leaf is reached: the gradients are not all zeros anywhere
    for path, g in got.items():
        assert np.abs(g).max() > 0, path


def test_hybrid_remat_per_group_changes_memory_not_values():
    """The hybrid's groups (Mamba layers + the shared block) are
    checkpointed whole; the tail is not, as in the reference."""
    jc, tc = _pair("hybrid")
    _, tp = both(jc, seed=3)
    b = TS.batch_to(_batch("hybrid", jc), "cpu")
    out, counts = {}, {}
    for remat in ("none", "full", "dots"):
        c = dataclasses.replace(tc, remat=remat)
        with _OpCount() as oc:
            out[remat] = TS.value_and_grad(c)(tp, b)
        counts[remat] = oc.n
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for (pa, a), (pb, g) in zip(leaves_with_paths(out[remat][2]),
                                    leaves_with_paths(out["none"][2])):
            assert pa == pb and torch.equal(a, g), (remat, pa)
    n, f, d = counts["none"], counts["full"], counts["dots"]
    assert f["bmm"] > n["bmm"] and d["bmm"] == f["bmm"]
    assert f["mm"] > n["mm"] and d["mm"] == n["mm"]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_one_train_step_of_each_family(name):
    jc, tc = _pair(name)
    _, tp = both(jc, seed=3)
    init, step = TS.make_train_step(tc, TO.adamw(lr=1e-3))
    state, m = step(init(params=tp), _batch(name, jc))
    assert int(state["opt"].step) == 1 and np.isfinite(float(m["loss"]))
    for (pa, a), (pb, p) in zip(leaves_with_paths(state["params"]),
                                leaves_with_paths(tp)):
        assert pa == pb and a.dtype == p.dtype and not torch.equal(a, p)
