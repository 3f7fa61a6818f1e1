"""The port's training path against the JAX reference on the CPU.

The same numpy inputs (parameters in the reference's layout from
``tests/_torch_numpy_params.py``, batches and gradients from seeded numpy
generators) go through ``repro`` and its counterparts in ``repro_torch``:

* the LR schedules over steps 0..N, and AdamW's ``update`` fed the SAME
  numpy gradients in both packages (updates, ``mu``, ``nu``, ``lr``,
  ``grad_norm``; clipping on and off; the default and a custom
  ``decay_mask``): pure functions, 1e-6 relative.  The gradients are
  compared on their own: AdamW's first step is about -lr * sign(g), so a
  gradient within rounding of 0 would flip a whole ``lr`` in a stepped
  parameter;
* the data pipeline, bitwise (host sharding, prefetch 0 and 2), and the
  int8 error-feedback compression over several steps (1e-6);
* ``cross_entropy`` with and without a mask, ``loss_fn`` and every
  gradient leaf against the reference's jitted ``jax.value_and_grad``
  (through ``_compute_cast``) for a dense, a Monarch (paper policy,
  ``min_dim`` lowered) and a bf16-compute model, and an MoE model whose
  routing drops tokens at capacity (its ``lb_loss`` term in the loss):
  fp32 loss 1e-5 relative, gradients 2e-4 / 2e-5 (the reference's own
  limits for two train steps that should agree,
  ``tests/test_substrate.py:88,92``), bf16 compute 2e-2;
* ``cfg.remat`` "none", "full" and "dots" give ``torch.equal`` gradients,
  and the products each recomputes are its policy's;
* ``make_train_step``'s stepped state against the reference's; the
  port's ``accum_steps=4`` equals 1 (``tests/test_substrate.py:78``);
  ``compress_grads=True`` against the reference;
* the ``Trainer``: loss falls over 30 steps and the run resumes at step 30
  from its checkpoint; a "wsd" run (``tests/test_substrate.py:198,216``);
* a train state's checkpoint crosses packages both ways (leaf ids, the
  int32 ``step``, values);
* every kernel wrapper refuses autograd, as the reference's ``jax.grad``
  through ``repro.kernels.ops.monarch_mm`` does;
* ``python -m repro_torch.examples.train_e2e --preset tiny --steps 5
  --device cpu`` runs to its last line.

The port runs its ops on one thread here (``_one_thread``): the tier-1
run shares the host's cores among its workers, and PyTorch's small CPU
ops slow down by orders of magnitude when every worker spreads them over
every core.
"""

import concurrent.futures
import dataclasses
import functools
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_numpy_params import both
from repro import optim as JO
from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.core.linear import MonarchSpec as JSpec
from repro.data import DataConfig as JDataConfig
from repro.data import make_batches as jmake_batches
from repro.data import synthetic_stream as jstream
from repro.ft import compression as JC
from repro.kernels import ops as jops
from repro.launch import steps as JS
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JConfig
from repro.models.config import MoEConfig as JMoE
from repro_torch import optim as TO
from repro_torch import tree_map
from repro_torch.checkpoint import latest_step
from repro_torch.checkpoint import restore_checkpoint as trestore
from repro_torch.checkpoint import save_checkpoint as tsave
from repro_torch.checkpoint.store import _leaves_with_paths
from repro_torch.core.linear import MonarchSpec as TSpec
from repro_torch.core.linear import linear_apply
from repro_torch.data import DataConfig, make_batches, synthetic_stream
from repro_torch.ft import compression as TC
from repro_torch.kernels import bdmm as KB
from repro_torch.kernels import monarch as KM
from repro_torch.kernels import paged as KP
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.config import MoEConfig as TMoE
from repro_torch.optim.adamw import Optimizer, leaves_with_paths
from repro_torch.train import Trainer, TrainerConfig

PURE = dict(rtol=1e-6, atol=0.0)
LOSS = dict(rtol=1e-5, atol=0.0)
FP32 = dict(rtol=2e-4, atol=2e-5)      # tests/test_substrate.py:88,92
BF16 = dict(rtol=2e-2, atol=2e-2)
BF16_VS_FP32 = 1.5
BASE = dict(d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=256, dtype="float32")  # tests/test_substrate.py:25


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(monarch=False, moe=None, **over):
    """(reference config, port config) of the same fields."""
    kw = {**BASE, **over}
    js = JSpec(enable=monarch, min_dim=64)
    ts = TSpec(enable=monarch, min_dim=64)
    return (JConfig(name="train", monarch=js,
                    moe=None if moe is None else JMoE(**moe), **kw),
            TConfig(name="train", monarch=ts,
                    moe=None if moe is None else TMoE(**moe), **kw))


# capacity 4 a group of 16 tokens, 8 choices an expert on average: drops
MOE = dict(n_experts=4, top_k=2, n_shared=1, capacity_factor=0.5,
           group_size=16, pad_to=6)
CONFIGS = {
    "dense": _pair(),
    "monarch": _pair(monarch=True),
    "bf16": _pair(monarch=True, dtype="bfloat16"),
    "moe": _pair(moe=MOE),
}


def _batch(cfg, B=2, S=16, seed=1, mask=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        out["loss_mask"] = (rng.random((B, S)) > 0.2).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _jgrad_fn(jcfg):
    def loss_of(p, b):
        return JT.loss_fn(JS._compute_cast(p, jcfg), b, jcfg)
    return jax.jit(jax.value_and_grad(loss_of, has_aux=True))


def _flat_ref(tree) -> dict:
    """{path of keys: numpy leaf} of a reference pytree."""
    return {tuple(getattr(k, "key", getattr(k, "name", k)) for k in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree) -> dict:
    return {path: leaf.detach().float().numpy()
            for path, leaf in leaves_with_paths(tree)}


def _assert_trees(got, want, **tol):
    g, w = _flat_port(got), _flat_ref(want)
    assert sorted(g) == sorted(w)
    for path in w:
        assert g[path].shape == w[path].shape, path
        np.testing.assert_allclose(g[path], w[path].astype(np.float32),
                                   err_msg=str(path), **tol)


def reference_grads(cases: dict, seed: int, batch_of) -> dict:
    """The reference's jitted (loss, aux, grads) of each case {name:
    (reference config, port config)}, on threads: XLA compiles outside
    the GIL."""
    def one(name):
        jc = cases[name][0]
        jp, _ = both(jc, seed=seed)
        b = {k: jnp.asarray(v) for k, v in batch_of(name, jc).items()}
        (jl, jaux), jg = _jgrad_fn(jc)(jp, b)
        return jl, jaux, jg

    with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
        return dict(zip(cases, pool.map(one, cases)))


@pytest.fixture(scope="module")
def grads():
    """Each config's (reference (loss, aux, grads), port's), once."""
    ref = reference_grads(CONFIGS, 2, lambda name, jc: _batch(jc))
    out = {}
    for name, (jc, tc) in CONFIGS.items():
        _, tp = both(jc, seed=2)
        out[name] = (ref[name], TS.value_and_grad(tc)(
            tp, TS.batch_to(_batch(jc), "cpu")))
    return out


# ---------------------------------------------------------------------------
# schedules, optimizer, data, compression: pure functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["cosine", "wsd"])
def test_schedules_match_reference(which):
    if which == "cosine":
        args = (3e-3, 7, 40)
        jf, tf = JO.cosine_schedule(*args), TO.cosine_schedule(*args)
    else:
        args = (1e-3, 5, 20, 9)
        jf, tf = JO.wsd_schedule(*args), TO.wsd_schedule(*args)
    steps = np.arange(0, 45, dtype=np.int32)
    want = np.asarray(jax.vmap(jf)(jnp.asarray(steps)))
    got = tf(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **PURE)
    assert float(tf(3)) == pytest.approx(float(want[3]), rel=1e-6)


def _opt_inputs(seed=0):
    """Params with matrices, a norm and a bf16 leaf; 3 steps of grads."""
    rng = np.random.default_rng(seed)
    shapes = {"a": {"w": (8, 6), "scale": (6,)}, "emb": {"table": (10, 4)},
              "half": (4, 4)}

    def draw(tree, scale):
        if isinstance(tree, dict):
            return {k: draw(v, scale) for k, v in tree.items()}
        return (scale * rng.standard_normal(tree)).astype(np.float32)

    params = draw(shapes, 1.0)
    grads = [draw(shapes, s) for s in (3.0, 0.1, 1e-3)]
    return params, grads


def _custom_mask_ref(path, leaf):
    return "emb" not in jax.tree_util.keystr(path) and leaf.ndim >= 2


def _custom_mask_port(path, leaf):
    return "emb" not in path and leaf.dim() >= 2


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("mask", ["default", "custom"])
def test_adamw_on_identical_grads_matches_reference(clip, mask):
    params, grads = _opt_inputs()
    sched = (3e-2, 2, 10)
    kw = dict(clip_norm=clip, weight_decay=0.1)
    jopt = JO.adamw(lr=JO.cosine_schedule(*sched), **kw,
                    decay_mask=_custom_mask_ref if mask == "custom" else None)
    topt = TO.adamw(lr=TO.cosine_schedule(*sched), **kw,
                    decay_mask=_custom_mask_port if mask == "custom"
                    else None)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = jax.tree_util.tree_map(torch.from_numpy, params)
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    for g in grads:
        ju, js, jm = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js,
                                 jp)
        tu, ts, tm = topt.update(jax.tree_util.tree_map(torch.from_numpy, g),
                                 ts, tp)
        _assert_trees(tu, ju, **PURE)
        _assert_trees(ts.mu, js.mu, **PURE)
        _assert_trees(ts.nu, js.nu, **PURE)
        assert int(ts.step) == int(js.step)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **PURE)
        jp = JO.apply_updates(jp, ju)
        tp = TO.apply_updates(tp, tu)
        _assert_trees(tp, jp, rtol=1e-6, atol=1e-7)
    # apply_updates keeps each parameter's dtype
    half = {"h": torch.ones(3, dtype=torch.bfloat16)}
    out = TO.apply_updates(half, {"h": torch.full((3,), 0.5)})
    assert out["h"].dtype == torch.bfloat16
    assert torch.equal(out["h"].float(), torch.full((3,), 1.5))


def test_data_pipeline_is_bitwise_the_reference():
    base = dict(vocab=256, seq_len=32, global_batch=8, seed=3)
    for hosts in ((0, 1), (0, 2), (1, 2)):
        kw = dict(base, host_index=hosts[0], host_count=hosts[1])
        js, ts = jstream(JDataConfig(**kw)), synthetic_stream(DataConfig(
            **kw))
        for _ in range(3):
            a, b = next(js), next(ts)
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for prefetch in (0, 2):
        jb = jmake_batches(JDataConfig(**base), prefetch=prefetch)
        tb = make_batches(DataConfig(**base), prefetch=prefetch)
        for _ in range(3):
            a, b = next(jb), next(tb)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k],
                                                                   b[k])


def test_compressed_gradients_match_reference_over_steps():
    params, grads = _opt_inputs(seed=4)
    je = JC.compress_state_init(jax.tree_util.tree_map(jnp.asarray, params))
    te = TC.compress_state_init(jax.tree_util.tree_map(torch.from_numpy,
                                                       params))
    _assert_trees(te, je, **PURE)
    for g in grads + grads:
        jg, je = JC.compressed_gradients(
            jax.tree_util.tree_map(jnp.asarray, g), je)
        tg, te = TC.compressed_gradients(
            jax.tree_util.tree_map(torch.from_numpy, g), te)
        _assert_trees(tg, jg, **PURE)
        _assert_trees(te, je, rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(5)
    logits = (3 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    logits[..., 45:] = -1e30          # padded vocab slots
    labels = rng.integers(0, 45, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32) if masked else None
    want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask))
    got = TL.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), **PURE)
    # an all-zero mask divides by 1, not 0
    zero = TL.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                            torch.zeros(3, 7))
    assert float(zero) == 0.0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_every_gradient_match_reference(grads, name):
    (jl, jaux, jg), (tl, taux, tg) = grads[name]
    bf16 = CONFIGS[name][1].dtype == "bfloat16"
    np.testing.assert_allclose(float(tl), float(jl), **(BF16 if bf16
                                                        else LOSS))
    np.testing.assert_allclose(float(taux["lb_loss"]), float(jaux["lb_loss"]),
                               **(BF16 if bf16 else LOSS))
    for _, g in leaves_with_paths(tg):     # the fp32 masters' gradients
        assert g.dtype == torch.float32
    if not bf16:
        _assert_trees(tg, jg, **FP32)
    else:
        _assert_bf16_grads(tg, jg, name)
    if name == "moe":                      # the lb_loss term is in the loss
        assert float(taux["lb_loss"]) > 0
        jc, tc = CONFIGS[name]
        jp, tp = both(jc, seed=2)
        logits, _ = TT.forward(tp, TS.batch_to(_batch(jc), "cpu"), tc,
                               train=False)
        b = TS.batch_to(_batch(jc), "cpu")
        ce = TL.cross_entropy(logits, b["labels"], b["loss_mask"])
        np.testing.assert_allclose(float(tl), float(ce)
                                   + 0.01 * float(taux["lb_loss"]), **LOSS)


def _assert_bf16_grads(tg, jg, name):
    """bf16 compute rounds every activation and cotangent: each package's
    gradients are ~4-7% (a leaf's norm) from the same model's fp32
    gradients, the reference's as much as the port's, so the two cannot
    meet elementwise at 2e-2.  Each leaf of the port's must be as close
    to the fp32 gradients (the port's at fp32 compute, held to the
    reference's by the fp32 cases) as the reference's is, within
    ``BF16_VS_FP32`` times, and the same layout and signs in bulk."""
    jc, tc = CONFIGS[name]
    _, tp = both(jc, seed=2)
    tc32 = dataclasses.replace(tc, dtype="float32")
    _, _, g32 = TS.value_and_grad(tc32)(tp, TS.batch_to(_batch(jc), "cpu"))
    got, want, truth = _flat_port(tg), _flat_ref(jg), _flat_port(g32)
    assert sorted(got) == sorted(want) == sorted(truth)
    for path in want:
        t = truth[path]
        port = np.linalg.norm(got[path] - t)
        ref = np.linalg.norm(want[path].astype(np.float32) - t)
        assert port <= BF16_VS_FP32 * ref, (path, port, ref)
        assert ref <= 0.1 * np.linalg.norm(t), path
        agree = np.sign(got[path]) == np.sign(want[path])
        assert agree.mean() > 0.9, path


def test_moe_config_drops_tokens_at_capacity():
    """The MoE case routes more choices to an expert than its capacity
    (the reference's own dispatch, counted): drops reach the gradients."""
    jc, tc = CONFIGS["moe"]
    jp, tp = both(jc, seed=2)
    x = TL.embed(tp["embedding"], torch.from_numpy(_batch(jc)["tokens"]), tc,
                 torch.float32)
    mc = tc.moe
    sg = mc.group_size
    xt = x.reshape(-1, sg, tc.d_model)
    router = tp["decoder"]["layers"]["moe"]["router"]
    _, gates, idx = TL._route(linear_apply({"w": router["w"][0]}, xt).float(),
                              mc)
    cap = max(4, int(mc.capacity_factor * sg * mc.top_k / mc.n_experts))
    dispatch, _ = TL._dispatch(idx, gates, mc.n_slots, cap, torch.float32)
    assert dispatch.sum() < idx.numel()


class _OpCount(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.n:
            self.n[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["monarch", "moe"])
def test_remat_changes_memory_not_values(name):
    """"none", "full" and "dots" give torch.equal loss and gradients.
    "full" recomputes every layer's products in the backward pass, "dots"
    only the batched ones (the Monarch stages and attention run as bmm;
    mm outputs are kept), as ``checkpoint_dots_with_no_batch_dims``."""
    jc, tc = CONFIGS[name]
    _, tp = both(jc, seed=2)
    b = TS.batch_to(_batch(jc), "cpu")
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
    # train=False checkpoints nothing
    c = dataclasses.replace(tc, remat="full")
    with _OpCount() as oc:
        logits, _ = TT.forward(tp, b, c, train=False)
        logits.sum()
    with _OpCount() as oc2:
        TT.forward(tp, b, dataclasses.replace(tc, remat="none"), train=False)
    assert oc.n == oc2.n


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _states(jc, tc, opt_kw, compress=False, seed=2):
    jp, tp = both(jc, seed=seed)
    jinit, jstep = JS.make_train_step(jc, JO.adamw(**opt_kw),
                                      compress_grads=compress)
    tinit, tstep = TS.make_train_step(tc, TO.adamw(**opt_kw),
                                      compress_grads=compress)
    js = {"params": jp, "opt": JO.adamw(**opt_kw).init(jp)}
    if compress:
        js["ef"] = JC.compress_state_init(jp)
    return js, jax.jit(jstep), tinit(params=tp), tstep


def _assert_states(ts, js, **tol):
    assert sorted(ts) == sorted(js)
    _assert_trees(ts["params"], js["params"], **tol)
    _assert_trees(ts["opt"].mu, js["opt"].mu, **tol)
    _assert_trees(ts["opt"].nu, js["opt"].nu, rtol=tol["rtol"], atol=1e-9)
    assert ts["opt"].step.dtype == torch.int32
    assert int(ts["opt"].step) == int(js["opt"].step)
    if "ef" in js:
        _assert_trees(ts["ef"], js["ef"], **tol)


def test_train_step_matches_reference():
    """One step from the same params and batch, each package's own
    gradients: the stepped state at the reference's train-step limits."""
    jc, tc = CONFIGS["dense"]
    js, jstep, ts, tstep = _states(jc, tc, dict(lr=1e-3))
    b = _batch(jc, B=4)
    js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
    ts, tm = tstep(ts, b)
    assert sorted(tm) == sorted(jm) == ["grad_norm", "lb_loss", "loss", "lr"]
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **LOSS)
    _assert_states(ts, js, **FP32)


def test_compressed_train_step_matches_reference(monkeypatch):
    """``compress_grads=True``: both packages' ``make_train_step`` fed the
    same gradients (the reference's of the initial params; each
    package's own are held to each other above) step the same state,
    the error feedback included, over three steps (1e-6).  The
    reference's step runs eagerly: jitted, XLA fuses the quantization
    into the step and rounds ``x / scale`` otherwise than its eager op
    and the port do, so an int8 level flips wherever a value sits within
    rounding of a half level (1 of 16384 elements here), as it does
    between two orders of summation when each package takes its own
    gradients."""
    jc, tc = CONFIGS["dense"]
    js, jstep, ts, tstep = _states(jc, tc, dict(lr=1e-3), compress=True)
    b = _batch(jc, B=4)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (_, _), G = _jgrad_fn(jc)(js["params"], jb)
    zero = {"lb_loss": np.float32(0)}

    def ref_vg(fn, has_aux=False):
        return lambda p: ((jnp.float32(0), zero), G)

    def port_vg(cfg):
        return lambda params, batch: (
            torch.tensor(0.0), zero, jax.tree_util.tree_map(
                lambda a: torch.from_numpy(np.array(a)), G))

    # the reference's step un-jitted: XLA's fusion of the quantization
    # into the step rounds x / scale otherwise than its eager op does
    monkeypatch.setattr(JS.jax, "value_and_grad", ref_vg)
    monkeypatch.setattr(TS, "value_and_grad", port_vg)
    _, jstep = JS.make_train_step(jc, JO.adamw(lr=1e-3), compress_grads=True)
    _, tstep = TS.make_train_step(tc, TO.adamw(lr=1e-3), compress_grads=True)
    for _ in range(3):
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, b)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **PURE)
        _assert_states(ts, js, rtol=1e-6, atol=1e-9)


def _sgd(lr):
    """A plain gradient step in the optimizer interface: the stepped
    parameters are linear in the gradients."""
    def update(grads, state, params):
        return (tree_map(lambda g: -lr * g, grads), state,
                {"lr": torch.tensor(lr)})
    return Optimizer(init=lambda p: None, update=update)


def test_grad_accumulation_matches_full_batch():
    """tests/test_substrate.py:78 on the port: the loss and AdamW's
    moments after 4 microbatches equal the full batch's at the
    reference's limits.  The stepped parameters are compared after a
    plain gradient step: AdamW's first step g / (|g| + eps) turns the
    summation order's rounding of a gradient near 0 into a whole
    ``lr``."""
    _, tc = CONFIGS["dense"]
    tokens = np.random.default_rng(1).integers(0, tc.vocab, (8, 16))
    batch = {"tokens": tokens, "labels": tokens}
    for opt in (TO.adamw(lr=1e-2, clip_norm=None), _sgd(1e-2)):
        init1, step1 = TS.make_train_step(tc, opt)
        _, step4 = TS.make_train_step(tc, opt, accum_steps=4)
        sa, ma = step1(init1(0, device="cpu"), batch)
        sb, mb = step4(init1(0, device="cpu"), batch)
        np.testing.assert_allclose(float(ma["loss"]), float(mb["loss"]),
                                   **LOSS)
        trees = ([(sa["opt"].mu, sb["opt"].mu), (sa["opt"].nu, sb["opt"].nu)]
                 if sa["opt"] is not None else
                 [(sa["params"], sb["params"])])
        for ta, tb in trees:
            for (pa, a), (pb, b) in zip(leaves_with_paths(ta),
                                        leaves_with_paths(tb)):
                assert pa == pb
                np.testing.assert_allclose(a.numpy(), b.numpy(),
                                           rtol=FP32["rtol"], atol=1e-9,
                                           err_msg=str(pa))


def test_moe_train_step_lb_loss_metric_as_reference():
    """Over 2 microbatches the step's ``lb_loss`` is their mean, as the
    reference's (one batch's is its ``aux``, compared above)."""
    jc, tc = CONFIGS["moe"]
    b = _batch(jc, B=4)
    for accum in (2,):
        jp, tp = both(jc, seed=2)
        _, jstep = JS.make_train_step(jc, JO.adamw(lr=1e-3),
                                      accum_steps=accum)
        tinit, tstep = TS.make_train_step(tc, TO.adamw(lr=1e-3),
                                          accum_steps=accum)
        js = {"params": jp, "opt": JO.adamw(lr=1e-3).init(jp)}
        _, jm = jax.jit(jstep)(js, {k: jnp.asarray(v) for k, v in b.items()})
        _, tm = tstep(tinit(params=tp), b)
        for k in ("loss", "lb_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **LOSS)


# ---------------------------------------------------------------------------
# the trainer, checkpoints, the example
# ---------------------------------------------------------------------------


def test_trainer_loss_decreases_and_resumes(tmp_path):
    """tests/test_substrate.py:198 on the port."""
    _, tc = CONFIGS["dense"]
    dcfg = DataConfig(vocab=tc.vocab, seq_len=32, global_batch=8, seed=3)
    tcfg = TrainerConfig(steps=30, peak_lr=3e-3, warmup=5, log_every=0,
                         ckpt_every=10, ckpt_dir=str(tmp_path))
    trainer = Trainer(tc, tcfg, device="cpu")
    trainer.run(make_batches(dcfg, prefetch=0))
    first = np.mean([h["loss"] for h in trainer.history[:5]])
    last = np.mean([h["loss"] for h in trainer.history[-5:]])
    assert last < first, (first, last)
    assert latest_step(tmp_path) == 30
    tcfg2 = dataclasses.replace(tcfg, steps=35)
    trainer2 = Trainer(tc, tcfg2, mesh=Mesh(model=1, device="cpu"))
    trainer2.run(make_batches(dcfg, prefetch=0))
    assert trainer2.history[0]["step"] == 30
    assert trainer2.history[0]["loss"] < first
    # a mesh of more than one rank trains only once it joined its world
    with pytest.raises(ValueError, match="process group"):
        Trainer(tc, tcfg2, mesh=Mesh(model=1, data=2, device="cpu"))


def test_trainer_wsd_schedule_runs():
    """tests/test_substrate.py:216 on the port."""
    _, tc = CONFIGS["dense"]
    dcfg = DataConfig(vocab=tc.vocab, seq_len=16, global_batch=4)
    tcfg = TrainerConfig(steps=6, schedule="wsd", log_every=0, ckpt_dir=None)
    trainer = Trainer(tc, tcfg, device="cpu")
    trainer.run(make_batches(dcfg, prefetch=0))
    assert len(trainer.history) == 6
    lr = TO.wsd_schedule(tcfg.peak_lr, tcfg.warmup, stable=1, decay=1)
    for i, h in enumerate(trainer.history):   # the step's lr: step i + 1
        assert h["lr"] == pytest.approx(float(lr(i + 1)), rel=1e-6)


def _manifest_leaves(directory, step) -> dict:
    man = json.loads((directory / f"step_{step:08d}" /
                      "manifest.json").read_text())
    return man["leaves"]


def test_train_state_checkpoint_crosses_packages(tmp_path):
    """A reference train state (one step taken: the int32 step is 1)
    restores in the port, and the port's in the reference: the same leaf
    ids (``opt__.step``, ``opt__.mu__...`` in field order, ``ef__...``),
    dtypes and values."""
    jc, tc = CONFIGS["dense"]
    js, jstep, ts, tstep = _states(jc, tc, dict(lr=1e-3), compress=True)
    b = _batch(jc, B=4)
    js, _ = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
    ts, _ = tstep(ts, b)
    jdir, tdir = tmp_path / "ref", tmp_path / "port"
    jsave(jdir, 1, js)
    tsave(tdir, 1, ts)
    jleaves, tleaves = _manifest_leaves(jdir, 1), _manifest_leaves(tdir, 1)
    assert list(jleaves) == list(tleaves)
    assert [pid for pid, _ in _leaves_with_paths(ts)] == list(jleaves)
    assert "opt__.step" in jleaves and jleaves["opt__.step"]["dtype"] == \
        tleaves["opt__.step"]["dtype"] == "int32"
    assert any(p.startswith("ef__") for p in jleaves)
    for pid in jleaves:
        assert jleaves[pid]["dtype"] == tleaves[pid]["dtype"]
        assert jleaves[pid]["shape"] == tleaves[pid]["shape"]
    # the reference's state in the port, exactly
    got, _ = trestore(jdir, 1, ts)
    assert type(got["opt"]) is type(ts["opt"])
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 1
    for (pa, a), (pb, w) in zip(_leaves_with_paths(got),
                                _leaves_with_paths(
                                    jax.tree_util.tree_map(np.asarray, js))):
        assert pa == pb
        assert np.array_equal(a.numpy(), np.asarray(w)), pa
    # the port's state in the reference, exactly
    back, _ = jrestore(tdir, 1, js)
    for (pa, a), (pb, w) in zip(_leaves_with_paths(ts),
                                jax.tree_util.tree_flatten_with_path(
                                    back)[0]):
        assert np.array_equal(a.numpy(), np.asarray(w)), pa


def test_train_e2e_example_runs_on_the_cpu(capsys):
    from repro_torch.examples import train_e2e

    assert train_e2e.main(["--preset", "tiny", "--steps", "5",
                           "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("model: e2e-tiny")
    assert lines[-1].startswith("loss: first5=")


# ---------------------------------------------------------------------------
# the kernels refuse autograd, as the reference's pallas_call does
# ---------------------------------------------------------------------------


def test_pallas_backend_refuses_autograd_in_both_packages():
    """``jax.grad`` through the reference's kernel path raises (its
    ``pallas_call`` has no VJP); the port's ``linear_apply(...,
    backend="pallas")`` under ``torch.autograd.grad`` raises too, on the
    CPU as on the card, instead of differentiating a plain version the
    card would not."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    L = rng.standard_normal((8, 8, 8)).astype(np.float32)
    R = rng.standard_normal((8, 8, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="Linearization failed"):
        jax.grad(lambda l: jnp.sum(jops.monarch_mm(jnp.asarray(x), l,
                                                   jnp.asarray(R))))(
            jnp.asarray(L))
    params = {"L": torch.from_numpy(L).requires_grad_(),
              "R": torch.from_numpy(R)}
    with pytest.raises(RuntimeError, match="no backward pass"):
        y = linear_apply(params, torch.from_numpy(x), backend="pallas")
        torch.autograd.grad(y.sum(), [params["L"]])
    # the einsum backend differentiates; without grad the kernel runs
    y = linear_apply(params, torch.from_numpy(x), backend="einsum")
    (g,) = torch.autograd.grad(y.sum(), [params["L"]])
    assert g.shape == params["L"].shape
    with torch.no_grad():
        y2 = linear_apply(params, torch.from_numpy(x), backend="pallas")
    torch.testing.assert_close(y2, y.detach(), rtol=2e-5, atol=2e-5)


def _wrapper_calls():
    """Every kernel wrapper with inputs of its own (CPU tensors); the
    first tensor is the one made to require grad."""
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(*s, generator=g)

    L, R = r(4, 4, 4), r(4, 4, 4)
    q8 = torch.randint(-127, 128, (4, 4, 4), dtype=torch.int8, generator=g)
    sc = torch.rand(4, 1, 1, generator=g) + 0.5
    pages = r(5, 4, 2, 8)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    start = torch.tensor([0, 2], dtype=torch.int32)
    span = torch.tensor([3, 2], dtype=torch.int32)
    mesh = Mesh(model=1, device="cpu")
    heads = dict(n_heads=4, n_kv_heads=2)
    return {
        "monarch_fused": (KM.monarch_fused, r(3, 16), L, R),
        "monarch_fused_experts": (KM.monarch_fused_experts, r(2, 3, 16),
                                  L[None].repeat(2, 1, 1, 1),
                                  R[None].repeat(2, 1, 1, 1)),
        "monarch_fused_q": (KM.monarch_fused_q, r(3, 16), q8, sc, q8, sc),
        "monarch_fused_q_experts": (KM.monarch_fused_q_experts, r(2, 3, 16),
                                    q8[None].repeat(2, 1, 1, 1),
                                    sc[None].repeat(2, 1, 1, 1),
                                    q8[None].repeat(2, 1, 1, 1),
                                    sc[None].repeat(2, 1, 1, 1)),
        "bdmm": (KB.bdmm, r(3, 4, 4), L),
        "bdmm_q": (KB.bdmm_q, r(3, 4, 4), q8, sc),
        "paged_attention_span": (KP.paged_attention_span, r(2, 3, 4, 8),
                                 pages, pages.clone(), table, start, span),
        "paged_attention": (KP.paged_attention, r(2, 4, 8), pages,
                            pages.clone(), table, span),
        "paged_attention_span_sharded": (
            lambda *a: KP.paged_attention_span_sharded(
                *a, 2 ** 30, mesh, **heads),
            r(2, 3, 4, 8), pages, pages.clone(), table, start, span),
        "paged_attention_sharded": (
            lambda *a: KP.paged_attention_sharded(*a, 2 ** 30, mesh,
                                                  **heads),
            r(2, 4, 8), pages, pages.clone(), table, span),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_every_kernel_wrapper_refuses_autograd(name):
    fn, first, *rest = _wrapper_calls()[name]
    want = fn(first, *rest)            # nothing requires grad: it runs
    with pytest.raises(RuntimeError, match="no backward pass"):
        fn(first.clone().requires_grad_(), *rest)
    with torch.no_grad():              # grad mode off: it runs
        got = fn(first.clone().requires_grad_(), *rest)
    assert torch.equal(got, want)
    if name.startswith(("monarch_fused", "bdmm")) and not name.endswith(
            ("_q", "_q_experts")):     # a float weight requiring grad
        with pytest.raises(RuntimeError, match="no backward pass"):
            fn(first, rest[0].clone().requires_grad_(), *rest[1:])


def test_serving_never_meets_the_refusal():
    """Serving never meets the check: its parameters require no grad."""
    jc, tc = CONFIGS["monarch"]
    _, tp = both(jc, seed=2)
    c = dataclasses.replace(tc, monarch=dataclasses.replace(
        tc.monarch, backend="pallas"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        logits, _ = TT.forward(tp, TS.batch_to(_batch(jc), "cpu"), c,
                               train=False)
    assert torch.isfinite(logits).all()


def test_training_entry_points_run_on_cuda_unless_cpu(monkeypatch):
    """The train state and the Trainer run on ``cuda`` unless the CPU is
    asked for, and raise without a card; the new modules are among those
    ``tests/test_torch_package.py`` imports in a process that must load
    no JAX and no reference module."""
    from test_torch_package import _modules

    assert {"repro_torch.optim.adamw", "repro_torch.optim.schedules",
            "repro_torch.data.pipeline", "repro_torch.ft.compression",
            "repro_torch.launch.steps", "repro_torch.train.trainer",
            "repro_torch.examples.train_e2e"} <= set(_modules())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = CONFIGS["dense"]
    init, _ = TS.make_train_step(tc)
    with pytest.raises(RuntimeError, match="CUDA"):
        init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(tc, TrainerConfig(steps=1))
    with pytest.raises(ValueError, match="process group"):
        Trainer(tc, TrainerConfig(steps=1),
                mesh=Mesh(model=2, rank=0, device="cpu"))
    state = init(0, device="cpu")
    assert state["opt"].step.device.type == "cpu"
