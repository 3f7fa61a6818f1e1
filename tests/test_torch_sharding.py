"""The port's tensor-parallel building blocks against the JAX reference.

B7: the port's span kernel per rank on its heads (the plain version on
the CPU), concatenated on the head axis, against the reference's
``paged_attention_span_sharded`` (``shard_map`` of the Pallas kernel in
interpret mode), which runs in a subprocess with four fake host devices
on the reference's ``_pool_fixture``-style inputs (tests/test_tp_serving.py).
The two frameworks' fp32 kernels are not bitwise equal even at tp = 1
(XLA's CPU ``exp`` is its own approximation; the page loop and the plain
version sum in other orders): the readings are 2.4e-7 (fp32 pages, values
O(1)) and 2.6e-6 (int8 pages, values up to ~10), a few ulps at the
output's scale.  So the outputs are held within fixed absolute bounds
set from those readings (1e-6 fp32, 4e-6 int8), and the sharding itself
is held exactly: the reference's sharded kernel equals its unsharded one, the
port's B7 equals its B3, and B7's difference from the reference is
bitwise the tp = 1 difference (fp32).  Both sides are within 2e-5 of the
reference's dense-gather oracle.

The rules: ``shard_params`` slices every leaf as the rule table and the
divisibility guard say, the slices of all ranks rebuild the full tree,
and gpt2-medium's shapes split as the Megatron scheme expects.  Then the
dispatch decision, the row/column contract of ``linear_apply``, the
collectives over a spawned gloo world, and ``DeviceKV``'s placement.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_tp_worker as W
from repro.kernels.ref import paged_attention_span_ref
from repro.core.quant import dequantize_kv_pages
from repro_torch.configs import get_config
from repro_torch.core.linear import MonarchSpec, linear_apply
from repro_torch.core.monarch import make_dims
from repro_torch.core.quant import quantize_monarch
from repro_torch.kernels import launches, reset_launches
from repro_torch.kernels.ops import paged_dispatch
from repro_torch.kernels.paged import (paged_attention_span,
                                       paged_attention_span_sharded)
from repro_torch.launch.mesh import COLLECTIVE_TIMEOUT, Mesh, run_ranks
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig
from repro_torch.serving.device_kv import DeviceKV, kv_shard_size
from repro_torch.sharding.params import shard_params, spec_for, tp_plan

ROOT = Path(__file__).resolve().parents[1]
WIN = 1_000_000_000
# |port - reference| per page type: the readings above, with headroom
B7_ATOL = {"fp32": 1e-6, "int8": 4e-6}


def _mesh(tp: int, rank: int = 0) -> Mesh:
    """A rank's mesh shape on the CPU (no process group)."""
    return Mesh(model=tp, rank=rank, device="cpu")

# ---------------------------------------------------------------------------
# B7 against the reference's shard_map kernel
# ---------------------------------------------------------------------------

REF_SCRIPT = """
import sys
import jax.numpy as jnp
import numpy as np
from repro.kernels.paged import (paged_attention_span,
                                 paged_attention_span_sharded)
from repro.launch.mesh import make_host_mesh

src, dst = sys.argv[1], sys.argv[2]
d = dict(np.load(src))
out = {}
for kv in ("fp32", "int8"):
    a = {k[len(kv) + 1:]: jnp.asarray(v) for k, v in d.items()
         if k.startswith(kv + "_")}
    sc = ({"k_scales": a["ks"], "v_scales": a["vs"]} if kv == "int8"
          else {})
    out[f"{kv}_tp1"] = np.asarray(paged_attention_span(
        a["q"], a["kp"], a["vp"], a["pt"], a["start"], a["span"],
        jnp.asarray(1_000_000_000, jnp.int32), **sc))
    for tp in (2, 4):
        o = paged_attention_span_sharded(
            a["q"], a["kp"], a["vp"], a["pt"], a["start"], a["span"],
            jnp.asarray(1_000_000_000, jnp.int32), make_host_mesh(model=tp),
            **sc)
        out[f"{kv}_tp{tp}"] = np.asarray(o)
np.savez(dst, **out)
"""


def _pool_inputs(kv: str, seed: int = 11) -> dict:
    """tests/test_tp_serving.py:_pool_fixture's shapes and draws."""
    rng = np.random.default_rng(seed)
    B, S, H, hd, P, pg, KV, MP = 3, 4, 8, 16, 12, 8, 8, 5
    d = {"q": rng.normal(size=(B, S, H, hd)).astype(np.float32),
         "pt": rng.integers(1, P, size=(B, MP)).astype(np.int32),
         "start": np.array([5, 11, 0], np.int32),
         "span": np.array([4, 2, 1], np.int32)}
    if kv == "int8":
        d["kp"] = rng.integers(-127, 128, size=(P, pg, KV, hd)).astype(
            np.int8)
        d["vp"] = rng.integers(-127, 128, size=(P, pg, KV, hd)).astype(
            np.int8)
        d["ks"] = rng.uniform(0.01, 0.1, size=(P, KV)).astype(np.float32)
        d["vs"] = rng.uniform(0.01, 0.1, size=(P, KV)).astype(np.float32)
    else:
        d["kp"] = rng.normal(size=(P, pg, KV, hd)).astype(np.float32)
        d["vp"] = rng.normal(size=(P, pg, KV, hd)).astype(np.float32)
    return d


@pytest.fixture(scope="module")
def ref_b7(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("b7")
    inputs = {kv: _pool_inputs(kv) for kv in ("fp32", "int8")}
    np.savez(tmp / "in.npz", **{f"{kv}_{k}": v for kv, d in inputs.items()
                                for k, v in d.items()})
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": str(ROOT / "src")}
    run = subprocess.run([sys.executable, "-c", REF_SCRIPT,
                          str(tmp / "in.npz"), str(tmp / "out.npz")],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-3000:]
    return inputs, dict(np.load(tmp / "out.npz"))


def _port_b7(d: dict, tp: int) -> torch.Tensor:
    """The port's B7 on every rank's slice, concatenated on heads."""
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    H, KV = t["q"].shape[2], t["kp"].shape[2]
    outs = []
    for r in range(tp):
        h = slice(r * H // tp, (r + 1) * H // tp)
        kh = slice(r * KV // tp, (r + 1) * KV // tp)
        sc = ({"k_scales": t["ks"][:, kh].contiguous(),
               "v_scales": t["vs"][:, kh].contiguous()} if "ks" in t else {})
        outs.append(paged_attention_span_sharded(
            t["q"][:, :, h].contiguous(), t["kp"][:, :, kh].contiguous(),
            t["vp"][:, :, kh].contiguous(), t["pt"], t["start"], t["span"],
            WIN, _mesh(tp, r), n_heads=H, n_kv_heads=KV, **sc))
    return torch.cat(outs, dim=2)


B7_CASES = [(tp, kv) for tp in (2, 4) for kv in ("fp32", "int8")]


@pytest.mark.parametrize("tp,kv", B7_CASES)
def test_b7_matches_reference_sharded_kernel(ref_b7, tp, kv):
    inputs, ref = ref_b7
    got = _port_b7(inputs[kv], tp).numpy()
    want = ref[f"{kv}_tp{tp}"]
    np.testing.assert_allclose(got, want, rtol=0, atol=B7_ATOL[kv])


@pytest.mark.parametrize("tp,kv", B7_CASES)
def test_b7_adds_no_error_to_the_unsharded_kernels(ref_b7, tp, kv):
    """Splitting heads changes nothing on either side: the reference's
    sharded kernel is its unsharded one (fp32 bitwise, int8 within 1e-6,
    its own bars), the port's B7 is bitwise its B3, so B7's difference from
    the reference is exactly the tp = 1 kernels' difference."""
    inputs, ref = ref_b7
    d = inputs[kv]
    want, whole = ref[f"{kv}_tp{tp}"], ref[f"{kv}_tp1"]
    if kv == "fp32":
        assert np.array_equal(want, whole)
    else:
        np.testing.assert_allclose(want, whole, rtol=0, atol=1e-6)
    got = _port_b7(d, tp)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    sc = ({"k_scales": t["ks"], "v_scales": t["vs"]} if "ks" in t else {})
    b3 = paged_attention_span(t["q"], t["kp"], t["vp"], t["pt"], t["start"],
                              t["span"], WIN, **sc)
    assert torch.equal(got, b3)
    if kv == "fp32":
        assert np.array_equal(got.numpy() - want, b3.numpy() - whole)


@pytest.mark.parametrize("tp,kv", B7_CASES)
def test_b7_within_the_reference_oracle(ref_b7, tp, kv):
    inputs, ref = ref_b7
    d = inputs[kv]
    kd, vd = d["kp"], d["vp"]
    if kv == "int8":
        kd = np.asarray(dequantize_kv_pages(kd, d["ks"]))
        vd = np.asarray(dequantize_kv_pages(vd, d["vs"]))
    oracle = np.asarray(paged_attention_span_ref(
        d["q"], kd, vd, d["pt"], d["start"], d["span"], WIN))
    for out in (_port_b7(d, tp).numpy(), ref[f"{kv}_tp{tp}"]):
        np.testing.assert_allclose(out, oracle, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("tp,kv", B7_CASES)
def test_b7_concatenation_is_the_unsharded_kernel(tp, kv):
    """Per-head math is unchanged, so the ranks' outputs concatenated are
    exactly the span kernel on the whole pool."""
    d = _pool_inputs(kv, seed=3)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    sc = ({"k_scales": t["ks"], "v_scales": t["vs"]} if "ks" in t else {})
    whole = paged_attention_span(t["q"], t["kp"], t["vp"], t["pt"],
                                 t["start"], t["span"], WIN, **sc)
    assert torch.equal(_port_b7(d, tp), whole)


def test_b7_rejects_shapes_that_are_not_a_rank_slice():
    t = {k: torch.from_numpy(v) for k, v in _pool_inputs("fp32").items()}
    with pytest.raises(ValueError, match="tp=2"):
        paged_attention_span_sharded(       # whole pool at tp = 2
            t["q"], t["kp"], t["vp"], t["pt"], t["start"], t["span"], WIN,
            _mesh(2), n_heads=8, n_kv_heads=8)
    with pytest.raises(ValueError, match="together"):
        paged_attention_span_sharded(
            t["q"], t["kp"], t["vp"], t["pt"], t["start"], t["span"], WIN,
            _mesh(1), n_heads=8, n_kv_heads=8, k_scales=t["q"])


def test_b7_cpu_path_counts_no_launch():
    reset_launches()
    _port_b7(_pool_inputs("int8"), 2)
    _port_b7(_pool_inputs("fp32"), 4)
    assert launches()["paged_attention_span_sharded"] == 0
    assert launches()["paged_attention_span_sharded_q"] == 0


# ---------------------------------------------------------------------------
# the partition rules
# ---------------------------------------------------------------------------

SMALL = dict(d_model=128, n_layers=2, n_heads=8, n_kv_heads=8, d_ff=256,
             vocab=512, dtype="float32")
CONFIGS = {
    "monarch": ModelConfig(name="m", monarch=MonarchSpec(
        enable=True, min_dim=64, backend="pallas"), **SMALL),
    "dense": ModelConfig(name="d", **SMALL),
    "gqa": ModelConfig(name="g", monarch=MonarchSpec(enable=True, min_dim=64),
                       **{**SMALL, "n_kv_heads": 2}),
    "gated_bias": ModelConfig(name="s", ffn_type="swiglu",
                              norm_type="rmsnorm", **SMALL),
}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, cfg in CONFIGS.items():
        p = TT.init_params(cfg, seed=0, device="cpu")
        if name == "gated_bias":   # a bias on a column and a row linear
            layers = p["decoder"]["layers"]
            layers["ffn"]["w1"]["b"] = torch.randn(2, cfg.d_ff)
            layers["attn"]["wo"]["b"] = torch.randn(2, cfg.d_model)
        out[name] = p
    return out


RULE_CASES = [(c, tp) for c in CONFIGS for tp in (2, 4)]


@pytest.mark.parametrize("cfg_name,tp", RULE_CASES)
def test_shard_params_shapes_per_rank(trees, cfg_name, tp):
    cfg, full = CONFIGS[cfg_name], trees[cfg_name]
    plan = tp_plan(full, cfg, _mesh(tp))
    for r in range(tp):
        local = dict(_leaves(shard_params(full, tp_plan(full, cfg,
                                                        _mesh(tp, r)))))
        for path, leaf in _leaves(full):
            ax = spec_for(path, plan)
            want = list(leaf.shape)
            if ax is not None:
                want[ax] //= tp
            assert list(local[path].shape) == want, path
            assert local[path].is_contiguous()


@pytest.mark.parametrize("cfg_name,tp", RULE_CASES)
def test_rank_slices_rebuild_the_full_tree(trees, cfg_name, tp):
    cfg, full = CONFIGS[cfg_name], trees[cfg_name]
    plan = tp_plan(full, cfg, _mesh(tp))
    ranks = [dict(_leaves(shard_params(full, tp_plan(full, cfg,
                                                     _mesh(tp, r)))))
             for r in range(tp)]
    for path, leaf in _leaves(full):
        ax = spec_for(path, plan)
        got = (ranks[0][path] if ax is None
               else torch.cat([rk[path] for rk in ranks], dim=ax))
        assert torch.equal(got, leaf), path


def test_plan_and_divisibility_guard(trees):
    m = trees["monarch"]
    p2 = tp_plan(m, CONFIGS["monarch"], _mesh(2))
    assert p2.groups() == {
        "heads": True, "kv_heads": True, "mlp": True, "vocab": True}
    assert p2.kv_shard == 2 and not p2.pool_replicated
    # 3 divides nothing of this shape: everything stays whole, and the
    # whole pool takes the dense gather
    p3 = tp_plan(m, CONFIGS["monarch"], _mesh(3))
    assert p3.groups() == {
        "heads": False, "kv_heads": False, "mlp": False, "vocab": False}
    assert p3.kv_shard == 1 and p3.pool_replicated
    p1 = tp_plan(m, CONFIGS["monarch"], _mesh(1))
    assert not any(p1.groups().values()) and not p1.pool_replicated
    # 2 KV heads on a 4-way axis: the pool and wk/wv stay whole
    g = tp_plan(trees["gqa"], CONFIGS["gqa"], _mesh(4))
    assert g.groups() == {"heads": True, "kv_heads": False, "mlp": True,
                          "vocab": True}
    assert g.kv_shard == 1 and g.pool_replicated
    # a row-parallel bias is added once, after the all-reduce: whole
    plan = tp_plan(trees["gated_bias"], CONFIGS["gated_bias"], _mesh(2))
    assert spec_for("decoder/layers/attn/wo/b", plan) is None
    assert spec_for("decoder/layers/ffn/w1/b", plan) == -1
    assert spec_for("decoder/layers/ln1/scale", plan) is None
    # a Monarch block count the axis does not divide keeps the group whole
    odd = {"decoder": {"layers": {"ffn": {
        "w1": {"L": torch.zeros(2, 4, 6, 32), "R": torch.zeros(2, 6, 8, 4)},
        "w2": {"L": torch.zeros(2, 6, 4, 8), "R": torch.zeros(2, 4, 32, 6)},
    }}}}
    assert not tp_plan(odd, CONFIGS["dense"], _mesh(4)).mlp
    assert tp_plan(odd, CONFIGS["dense"], _mesh(2)).mlp


def _meta_gpt2():
    """gpt2-medium's parameter shapes, as meta tensors."""
    cfg = get_config("gpt2-medium")
    n, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff

    def mon(din, dout):
        dims = make_dims(din, dout, policy=cfg.monarch.policy)
        return {"L": torch.empty(n, *dims.l_shape, device="meta"),
                "R": torch.empty(n, *dims.r_shape, device="meta")}

    tree = {"embedding": {"table": torch.empty(cfg.vocab_padded, d,
                                               device="meta")},
            "decoder": {"layers": {
                "attn": {k: mon(d, d) for k in ("wq", "wk", "wv", "wo")},
                "ffn": {"w1": mon(d, ff), "w2": mon(ff, d)}}}}
    return cfg, tree


def test_gpt2_medium_splits_as_megatron_pairs_at_tp2():
    cfg, tree = _meta_gpt2()
    plan = tp_plan(tree, cfg, _mesh(2))
    assert all(plan.groups().values())
    at = tree["decoder"]["layers"]["attn"]
    ffn = tree["decoder"]["layers"]["ffn"]
    assert tuple(at["wq"]["L"].shape[1:]) == (32, 32, 32)
    assert tuple(ffn["w1"]["R"].shape[1:]) == (32, 128, 32)
    assert tuple(ffn["w2"]["L"].shape[1:]) == (64, 64, 64)
    want = {   # column: L[:, qs, :], R[qs]; row: L[ks], R[:, :, ks]
        "decoder/layers/attn/wq/L": (24, 32, 16, 32),
        "decoder/layers/attn/wq/R": (24, 16, 32, 32),
        "decoder/layers/attn/wo/L": (24, 16, 32, 32),
        "decoder/layers/attn/wo/R": (24, 32, 32, 16),
        "decoder/layers/ffn/w1/L": (24, 32, 16, 32),
        "decoder/layers/ffn/w1/R": (24, 16, 128, 32),
        "decoder/layers/ffn/w2/L": (24, 32, 64, 64),
        "decoder/layers/ffn/w2/R": (24, 64, 16, 32),
        "embedding/table": (25216, 1024),
    }
    total = local = 0
    for path, leaf in _leaves(tree):
        ax = spec_for(path, plan)
        shape = list(leaf.shape)
        if ax is not None:
            shape[ax] //= 2
        if path in want:
            assert tuple(shape) == want[path], path
        if "decoder" in path:
            total += leaf.numel() * 4
            local += int(np.prod(shape)) * 4
    # the factors alone (PERF.md's 72.7 MB adds the layer norms)
    assert total == 72_351_744 and local * 2 == total


# ---------------------------------------------------------------------------
# dispatch, linear roles, collectives, DeviceKV
# ---------------------------------------------------------------------------


def test_paged_dispatch_under_tensor_parallelism(trees):
    assert paged_dispatch(64, 16) == "kernel"
    assert paged_dispatch(64, 16, pool_replicated=True) == "gqa_replicated"
    assert paged_dispatch(64, 16, paged_kernel=False,
                          pool_replicated=True) == "disabled"
    assert paged_dispatch(64, 16, softcap=True) == "softcap"
    # the flag is the plan's: split pool -> B7, whole pool at tp > 1 ->
    # the dense gather
    for name, tp, want in (("monarch", 2, "kernel"), ("monarch", 4, "kernel"),
                           ("monarch", 3, "gqa_replicated"),
                           ("gqa", 4, "gqa_replicated"),
                           ("gqa", 2, "kernel")):
        plan = tp_plan(trees[name], CONFIGS[name], _mesh(tp))
        assert paged_dispatch(
            64, 16, pool_replicated=plan.pool_replicated) == want, (name, tp)


def test_linear_column_slice_and_quantized_row_refusal():
    x = torch.randn(3, 64)
    L, R = torch.randn(4, 4, 16), torch.randn(4, 16, 4)
    with pytest.raises(NotImplementedError):
        linear_apply(quantize_monarch({"L": L, "R": R}, bits=8), x,
                     reduce=_mesh(2))
    # column-parallel is the smaller Monarch of this rank's output blocks
    y = linear_apply({"L": L, "R": R}, x)
    y0 = linear_apply({"L": L[:, :2].contiguous(), "R": R[:2].contiguous()},
                      x)
    torch.testing.assert_close(y0, y[:, :32], rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    return run_ranks(W.collectives, 2, backend="gloo", device="cpu",
                     timeout_s=120,
                     workdir=tmp_path_factory.mktemp("coll"))


def test_collectives_over_gloo(gloo_world):
    xs = [r["x"] for r in gloo_world]
    for r in gloo_world:
        assert torch.equal(r["sum"], xs[0] + xs[1])
        assert r["sum_bf16"].dtype == torch.bfloat16
        assert torch.equal(r["sum_bf16"].float(), xs[0] + xs[1])
        assert torch.equal(r["gather"], torch.cat(xs, dim=-1))
        assert r["time"] == 100.0      # rank 0's reading on every rank


def test_a_failed_rank_fails_the_world(tmp_path):
    """Rank 1 raises; the world fails and names it (with 1, or with the
    signal that stopped it when its peer's failure was seen first)."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="world failed: .*rank 1 exited"):
        run_ranks(W.fail_on_rank_one, 2, backend="gloo", device="cpu",
                  timeout_s=120, workdir=tmp_path)
    # stopped when the rank failed, not after the collective timeout
    assert time.monotonic() - t0 < COLLECTIVE_TIMEOUT.total_seconds()


def test_kv_shard_size_and_device_kv_placement(trees):
    cfg = CONFIGS["monarch"]
    assert kv_shard_size(cfg, 1) == 1
    assert kv_shard_size(cfg, 2) == 2
    assert kv_shard_size(cfg, 4) == 4
    assert kv_shard_size(CONFIGS["gqa"], 4) == 1
    assert kv_shard_size(cfg, 3) == 1
    kv = DeviceKV(cfg, 5, 8, kv_dtype="int8",
                  plan=tp_plan(trees["monarch"], cfg, _mesh(4, 3)),
                  device="cpu")
    assert kv.kv_shard == 4 and kv.local_kv_heads == 2
    attn = kv.pool["layers"]["attn"]
    assert tuple(attn["k_pages"].shape) == (2, 5, 8, 2, 16)
    assert tuple(attn["k_scales"].shape) == (2, 5, 2)
    kv.check_shards()
    # load takes this rank's heads (6, 7) of a whole host tree
    whole = TT.init_paged_pool(cfg, 5, 8, kv_dtype="int8", device="cpu")
    for k, v in whole["layers"]["attn"].items():
        v.copy_(torch.arange(v.numel()).reshape(v.shape).to(v.dtype))
    kv.load(whole)
    for k, v in whole["layers"]["attn"].items():
        ax = 3 if v.ndim == 5 else 2
        assert torch.equal(attn[k], v.narrow(ax, 6, 2))
    attn["v_pages"] = attn["v_pages"][:, :4]      # pages split: refused
    with pytest.raises(AssertionError, match="page axis"):
        kv.check_shards()
