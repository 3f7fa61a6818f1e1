"""The port's factor quantization, quantized Monarch kernels, quantized
linear layer and projection fusion against the JAX reference.

Integer values, packed int4 bytes and scales are compared bitwise: both
sides divide, round half to even and clamp in fp32.  The quantized kernels'
plain versions (on the CPU) are held against the reference's Pallas
``monarch_fused_q`` / ``bdmm_q`` in interpret mode at the reference kernel
tests' tolerances (tests/test_kernels.py: 2e-5 fp32, 2e-2 for a bf16
output), since both accumulate in fp32 in other orders.  Logits through
whole models are held at 1e-4, as in tests/test_torch_models.py.  Fused
against separate projections is held at the fp32 tolerance, not bitwise:
the reference's own bitwise fusion tests do not hold on every XLA CPU
build."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import linear as jlin
from repro.core import quant as jq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bdmm import bdmm_q as jbdmm_q
from repro.kernels.monarch import monarch_fused_q as jmonarch_fused_q
from repro.models import decode_path as JDP
from repro.models import fuse as JF
from repro.models import transformer as JT
from _torch_numpy_params import numpy_params
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import linear as tlin
from repro_torch.core import monarch as tmn
from repro_torch.core import quant as tq
from repro_torch.kernels import launches, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.bdmm import bdmm_plain, bdmm_q, bdmm_q_plain
from repro_torch.kernels.monarch import (fused_fits, fused_geometry,
                                         monarch_fused_plain,
                                         monarch_fused_q,
                                         monarch_fused_q_plain)
from repro_torch.models import decode_path as TDP
from repro_torch.models import fuse as TF
from repro_torch.models import transformer as TT
from test_torch_monarch import (SERVING_SHAPES, blockwise_monarch,
                                small_ints)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
LOGITS = dict(rtol=1e-4, atol=1e-4)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _pair(a: np.ndarray, dtype: str = "float32"):
    jd, td = DTYPES[dtype]
    return (jnp.asarray(a, jnp.float32).astype(jd),
            torch.from_numpy(np.asarray(a, np.float32)).to(td))


def _to_torch(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                             device="cpu")


# the reference's forward jitted (cfg and train static): one compile
# instead of one a primitive
_jforward = jax.jit(JT.forward, static_argnums=(2, 3))


def _jparams(jcfg, seed):
    """The reference's parameter tree drawn with numpy at ``seed``
    (``tests/_torch_numpy_params.py``): its layout and scales, without
    ``init_params``' eager compiles."""
    return jax.tree_util.tree_map(jnp.asarray, numpy_params(jcfg, seed))


def _assert_trees_equal(got, want):
    """The same keys, shapes, dtypes and values, element for element."""
    assert isinstance(got, dict) == isinstance(want, dict)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
        return
    w = np.asarray(want)
    assert str(got.dtype).split(".")[1] == str(w.dtype)
    assert tuple(got.shape) == w.shape
    np.testing.assert_array_equal(_np(got), w.astype(np.float32))


def _factors(din, dout, k, q, seed=0):
    rng = np.random.default_rng(seed)
    dims = tmn.MonarchDims(din=din, dout=dout, k=k, q=q)
    L = rng.standard_normal(dims.l_shape) / np.sqrt(dims.p)
    R = rng.standard_normal(dims.r_shape) / np.sqrt(dims.k)
    return L.astype(np.float32), R.astype(np.float32)


def _quantized(din, dout, k, q, bits, seed=0):
    """One factor pair quantized in both packages: (jax container, torch
    container), bitwise equal (checked)."""
    L, R = _factors(din, dout, k, q, seed)
    jc = jq.quantize_monarch({"L": jnp.asarray(L), "R": jnp.asarray(R)},
                             bits)
    tc = tq.quantize_monarch({"L": torch.from_numpy(L),
                              "R": torch.from_numpy(R)}, bits)
    _assert_trees_equal(tc, jc)
    return jc, tc


# ---------------------------------------------------------------------------
# factor quantization: bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(16, 16, 16), (3, 8, 32, 16), (1, 4, 4),
                                   (2, 5, 6, 8)])
def test_quantize_factor_bitwise(shape, bits):
    rng = np.random.default_rng(1)
    w = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    w[..., 0, :, :] = 0.0          # an all-zero block takes scale 1.0
    w.reshape(-1)[5] = 2.5 * float(np.abs(w).max())  # a block's extreme
    jv, js = jq.quantize_factor(jnp.asarray(w), bits)
    tv, ts = tq.quantize_factor(torch.from_numpy(w), bits)
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tq.block_scales(torch.from_numpy(w), bits).numpy(),
        np.asarray(jq.block_scales(jnp.asarray(w), bits)))
    np.testing.assert_array_equal(
        tq.dequantize_factor(tv, ts, unpacked_dim=shape[-1]).numpy(),
        np.asarray(jq.dequantize_factor(jv, js, unpacked_dim=shape[-1])))
    got = tq.quant_error_stats(torch.from_numpy(w), bits)
    want = jq.quant_error_stats(jnp.asarray(w), bits)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-6, abs=1e-12)
    assert got["max_block_rel_err"] <= got["bound_block_rel"] + 1e-6


def test_pack_unpack_int4_bitwise():
    """Every int4 pair packs to the reference's byte, and every one of the
    256 bytes unpacks to the reference's pair (lo the even index, both
    nibbles sign-extended)."""
    vals = np.arange(-8, 8, dtype=np.int8)
    pairs = np.stack(np.meshgrid(vals, vals, indexing="ij"), -1).reshape(
        4, -1)
    np.testing.assert_array_equal(
        tq.pack_int4(torch.from_numpy(pairs)).numpy(),
        np.asarray(jq.pack_int4(jnp.asarray(pairs))))
    every = np.arange(-128, 128, dtype=np.int32).astype(np.int8)[None]
    np.testing.assert_array_equal(
        tq.unpack_int4(torch.from_numpy(every)).numpy(),
        np.asarray(jq.unpack_int4(jnp.asarray(every))))
    clipped = np.clip(pairs, -7, 7)
    np.testing.assert_array_equal(
        tq.unpack_int4(tq.pack_int4(torch.from_numpy(clipped))).numpy(),
        clipped)
    with pytest.raises(ValueError, match="even"):
        tq.pack_int4(torch.zeros(2, 3, dtype=torch.int8))


@pytest.mark.parametrize("bits", [8, 4])
def test_container_helpers_match_reference(bits):
    jc, tc = _quantized(256, 512, 16, 16, bits)
    assert tq.quant_bits(tc, 256) == jq.quant_bits(jc, 256) == bits
    assert tq.quantized_out_dim(tc) == jq.quantized_out_dim(jc) == 512
    assert tlin.linear_out_dim(tc) == jlin.linear_out_dim(jc) == 512
    assert tq.tree_weight_bytes(tc) == jq.tree_weight_bytes(jc)
    assert tlin.is_quantized(tc) and not tlin.is_quantized({"w": 0})
    deq = tq.dequantize_monarch(tc, 16, 16)
    want = jq.dequantize_monarch(jc, 16, 16)
    _assert_trees_equal(deq, want)


# ---------------------------------------------------------------------------
# quantized kernels: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T_", [1, 40, 50])
@pytest.mark.parametrize("bits", [8, 4])
def test_monarch_fused_q_plain_matches_pallas(bits, T_, dtype):
    jc, tc = _quantized(256, 512, 16, 16, bits, seed=2)
    x = np.random.default_rng(3).standard_normal((T_, 256)).astype(
        np.float32)
    jx, tx = _pair(x, dtype)
    want = jmonarch_fused_q(jx, jc["Lq"], jc["Ls"], jc["Rq"], jc["Rs"],
                            interpret=True)
    before = launches()
    got = monarch_fused_q(tx, tc["Lq"], tc["Ls"], tc["Rq"], tc["Rs"])
    assert launches() == before, "the CPU path must not count launches"
    assert got.dtype == tx.dtype and got.shape == (T_, 512)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    # the plain version IS the float plain version on dequantized factors
    deq = tq.dequantize_monarch(tc, 16, 16)
    assert torch.equal(monarch_fused_q_plain(tx, tc["Lq"], tc["Ls"],
                                             tc["Rq"], tc["Rs"]),
                       monarch_fused_plain(tx, deq["L"], deq["R"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_bdmm_q_plain_matches_pallas(bits, dtype):
    jc, tc = _quantized(256, 512, 16, 16, bits, seed=4)
    x = np.random.default_rng(5).standard_normal((40, 16, 16)).astype(
        np.float32)
    jx, tx = _pair(x, dtype)
    want = jbdmm_q(jx, jc["Lq"], jc["Ls"], interpret=True)
    got = bdmm_q(tx, tc["Lq"], tc["Ls"])
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    w = tq.dequantize_factor(tc["Lq"], tc["Ls"], unpacked_dim=16)
    assert torch.equal(bdmm_q_plain(tx, tc["Lq"], tc["Ls"]),
                       bdmm_plain(tx, w))
    # the port's oracle agrees with the reference's oracle
    np.testing.assert_allclose(
        tref.bdmm_q_ref(tx.float(), tc["Lq"], tc["Ls"]).numpy(),
        np.asarray(jref.bdmm_q_ref(jx.astype(jnp.float32), jc["Lq"],
                                   jc["Ls"])), **TOL["float32"])


@pytest.mark.parametrize("bits", [8, 4])
def test_monarch_mm_q_fused_and_staged_match_reference(bits):
    """``monarch_mm_q`` takes the fused kernel where the UNPACKED shapes
    fit shared memory and the two-``bdmm_q`` branch where they do not, in
    both cases matching the reference's dispatch output."""
    x = np.random.default_rng(6).standard_normal((2, 3, 256)).astype(
        np.float32)
    jc, tc = _quantized(256, 512, 16, 16, bits, seed=7)
    assert fused_fits((16, 16, 16), (16, 32, 16))
    got = ops.monarch_mm_q(torch.from_numpy(x), tc["Lq"], tc["Ls"],
                           tc["Rq"], tc["Rs"])
    want = jops.monarch_mm_q(jnp.asarray(x), jc["Lq"], jc["Ls"], jc["Rq"],
                             jc["Rs"])
    assert got.shape == (2, 3, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])
    dims = tmn.make_dims(4096, 4096, nblocks=128)
    assert not fused_fits(dims.l_shape, dims.r_shape)
    jc, tc = _quantized(4096, 4096, dims.k, dims.q, bits, seed=8)
    x = np.random.default_rng(9).standard_normal((5, 4096)).astype(
        np.float32)
    got = ops.monarch_mm_q(torch.from_numpy(x), tc["Lq"], tc["Ls"],
                           tc["Rq"], tc["Rs"])
    want = jref.monarch_q_ref(jnp.asarray(x), jc["Lq"], jc["Ls"], jc["Rq"],
                              jc["Rs"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])
    np.testing.assert_allclose(
        tref.monarch_q_ref(torch.from_numpy(x), tc["Lq"], tc["Ls"],
                           tc["Rq"], tc["Rs"]).numpy(),
        np.asarray(want), **TOL["float32"])


def test_quantized_wrappers_reject_bad_containers():
    _, tc = _quantized(256, 512, 16, 16, 8)
    x = torch.zeros(2, 256)
    with pytest.raises(ValueError, match="quantized shapes"):
        monarch_fused_q(x, tc["Lq"][:, :, :8], tc["Ls"], tc["Rq"], tc["Rs"])
    with pytest.raises(ValueError, match="quantized shapes"):
        monarch_fused_q(torch.zeros(2, 200), tc["Lq"], tc["Ls"], tc["Rq"],
                        tc["Rs"])
    with pytest.raises(ValueError, match="quantized shapes"):
        bdmm_q(torch.zeros(2, 16, 16), tc["Lq"], tc["Ls"][:8])


# ---------------------------------------------------------------------------
# quantized linear layer, both backends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["einsum", "pallas"])
@pytest.mark.parametrize("bits", [8, 4])
def test_linear_apply_quantized_matches_reference(bits, backend, dtype):
    """The kernel backend returns x's dtype; the einsum backend dequantizes
    to fp32 and promotes a bf16 x to fp32, as ``jnp.einsum`` does."""
    jc, tc = _quantized(256, 512, 16, 16, bits, seed=10)
    b = np.random.default_rng(11).standard_normal(512).astype(np.float32)
    jc, tc = {**jc, "b": jnp.asarray(b)}, {**tc, "b": torch.from_numpy(b)}
    x = np.random.default_rng(12).standard_normal((2, 5, 256)).astype(
        np.float32)
    jx, tx = _pair(x, dtype)
    want = jlin.linear_apply(jc, jx, backend=backend)
    got = tlin.linear_apply(tc, tx, backend=backend)
    assert str(got.dtype).split(".")[1] == str(want.dtype)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


# ---------------------------------------------------------------------------
# projection fusion and the decode fast path
# ---------------------------------------------------------------------------


def _pair_cfg(**changes):
    jc = dataclasses.replace(jget_config("gpt2-medium").reduced(), **changes)
    tc = dataclasses.replace(tget_config("gpt2-medium").reduced(), **changes)
    return jc, tc


@pytest.mark.parametrize("variant", ["mha_gelu", "gqa_swiglu"])
def test_fuse_model_tree_equals_reference(variant):
    """The port's fused tree equals the reference's fused tree element for
    element: QKV (or, under GQA, KV) and the gated FFN's up/gate."""
    changes = ({} if variant == "mha_gelu"
               else dict(n_kv_heads=2, ffn_type="swiglu"))
    jc, _ = _pair_cfg(**changes)
    jp = _jparams(jc, 1)
    got = TF.fuse_model(_to_torch(jp))
    want = JF.fuse_model(jp)
    _assert_trees_equal(got, want)
    attn = got["decoder"]["layers"]["attn"]
    if variant == "mha_gelu":
        assert set(attn) == {"wqkv", "wo"}
    else:
        assert set(attn) == {"wq", "wkv", "wo"}
        assert "w1g" in got["decoder"]["layers"]["ffn"]
    assert TF.fused_split_sizes(4, 2, 32) == JF.fused_split_sizes(4, 2, 32)
    _assert_trees_equal(TF.fuse_model(got), want)  # fusing twice: no-op


@pytest.mark.parametrize("variant", ["mha_gelu", "gqa_swiglu"])
def test_fused_and_separate_logits_agree(variant):
    changes = ({} if variant == "mha_gelu"
               else dict(n_kv_heads=2, ffn_type="swiglu"))
    _, tc = _pair_cfg(**changes)
    tp = TT.init_params(tc, seed=2, device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(13).integers(0, tc.vocab, (2, 7)))
    sep, _ = TT.forward(tp, {"tokens": toks}, tc, train=False)
    fused, _ = TT.forward(TF.fuse_model(tp), {"tokens": toks}, tc,
                          train=False)
    np.testing.assert_allclose(fused.numpy(), sep.numpy(), **TOL["float32"])


@pytest.mark.parametrize("bits", [8, 4])
def test_prepare_decode_params_matches_reference(bits):
    """Fuse, then quantize: the same tree (int values and scales bitwise),
    the same weight bytes, and logits at the fp32 logits tolerance with the
    kernels on (the reference's Pallas kernels in interpret mode, the
    port's plain versions)."""
    jc, tc = _pair_cfg()
    jc = dataclasses.replace(jc, monarch=dataclasses.replace(
        jc.monarch, backend="pallas"))
    tc = dataclasses.replace(tc, monarch=dataclasses.replace(
        tc.monarch, backend="pallas"))
    jp = _jparams(jc, 3)
    want = JDP.prepare_decode_params(jp, jc, fuse=True, bits=bits)
    got = TDP.prepare_decode_params(_to_torch(jp), tc, fuse=True, bits=bits)
    _assert_trees_equal(got, want)
    assert TDP.decode_weight_bytes(got) == JDP.decode_weight_bytes(want)
    assert TDP.decode_weight_bytes(got) < TDP.decode_weight_bytes(
        _to_torch(jp))
    toks = np.random.default_rng(14).integers(0, jc.vocab, (2, 6))
    jl, _ = _jforward(want, {"tokens": jnp.asarray(toks)}, jc, False)
    tl, _ = TT.forward(got, {"tokens": torch.from_numpy(toks)}, tc,
                       train=False)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)


def test_params_from_numpy_carries_a_quantized_tree():
    """A reference tree after fuse + int8 quantization crosses as it is:
    int8 ``Lq``/``Rq`` and fp32 scales stacked on the layer axis, the same
    values, and the port's own quantization of the float tree gives the
    same tree."""
    jc, tc = _pair_cfg()
    jp = _jparams(jc, 4)
    jqp = JDP.prepare_decode_params(jp, jc, fuse=True, bits=8)
    got = _to_torch(jqp)
    _assert_trees_equal(got, jqp)
    wqkv = got["decoder"]["layers"]["attn"]["wqkv"]
    assert wqkv["Lq"].dtype == torch.int8 and wqkv["Ls"].dtype == \
        torch.float32
    assert wqkv["Lq"].shape[0] == wqkv["Ls"].shape[0] == jc.n_layers
    assert tuple(wqkv["Ls"].shape[-2:]) == (1, 1)
    _assert_trees_equal(
        TDP.prepare_decode_params(_to_torch(jp), tc, fuse=True, bits=8),
        jqp)


# ---------------------------------------------------------------------------
# the engine's compressed decode path on the einsum backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_engine_dense_fallback_and_einsum_match_reference(quantize):
    """The engine's branches of the compressed path that the kernel traces
    (tests/test_torch_kv_quant.py) do not take: the einsum backend
    (dequantize, then the float product) and the dense-gather attention
    over int8 pages, with int8 and int4 factors, through a tiny pool that
    preempts.  Greedy tokens and counters equal the reference engine's."""
    import repro.serving as jserving
    import repro_torch.serving as tserving

    jc, tc = _pair_cfg()
    jp = _jparams(jc, 0)
    tp = _to_torch(jp)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, jc.vocab, n) for n in (3, 24, 5, 18, 2)]
    kw = dict(max_slots=4, page_size=4, max_len=48, n_pages=9, chunk_size=8,
              quantize=quantize, fuse_projections=True, kv_dtype="int8")
    out = {}
    for name, pk, cfg, params, extra in (
            ("jax", jserving, jc, jp, {}),
            ("torch", tserving, tc, tp, {"device": "cpu"})):
        eng = pk.ContinuousBatchingEngine(cfg, params, **kw, **extra)
        reqs = [eng.add_request(p, pk.SamplingParams(max_new_tokens=5))
                for p in prompts]
        eng.run()
        eng.pool_host.check_invariants()
        out[name] = ([list(r.output_tokens) for r in reqs],
                     {k: eng.stats[k] for k in (
                         "mixed_steps", "preemptions", "tokens_out",
                         "kernel_dispatches", "dense_fallbacks")},
                     eng.weight_bits)
    assert out["torch"] == out["jax"]
    tokens, stats, bits = out["torch"]
    assert all(len(t) == 5 for t in tokens)
    assert stats["preemptions"] > 0
    assert stats["dense_fallbacks"] == stats["mixed_steps"]
    assert bits == {"int8": 8, "int4": 4}[quantize]


def _unit_scale_factor(rng, shape, bits) -> torch.Tensor:
    """Integers in [-3, 3] with one +-QMAX entry in every diagonal block,
    so each block's scale is exactly 1.0 and the dequantized factor is
    these integers: the split's sums stay exact in fp32."""
    w = small_ints(rng, shape)
    qmax = 127 if bits == 8 else 7
    w[:, 0, 0] = torch.from_numpy(rng.choice([-qmax, qmax], shape[0]).astype(
        np.float32))
    return w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 8, 513])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("name", ["qkv_fused", "w1", "w2", "tp2_w2"])
def test_blockwise_split_equals_monarch_fused_q_plain(name, bits, T, dtype):
    """B4 launches B1's blocks (fused_geometry does not depend on the
    factor width): following them over the dequantized factors is bitwise
    monarch_fused_q_plain."""
    L_shape, R_shape = SERVING_SHAPES[name]
    k, q, p = L_shape
    rng = np.random.default_rng(14)
    qc = tq.quantize_monarch({"L": _unit_scale_factor(rng, L_shape, bits),
                              "R": _unit_scale_factor(rng, R_shape, bits)},
                             bits)
    assert float(qc["Ls"].min()) == float(qc["Ls"].max()) == 1.0
    deq = tq.dequantize_monarch(qc, k, p)
    x = small_ints(rng, (T, k * p), 64).to(DTYPES[dtype][1])
    want = monarch_fused_q_plain(x, qc["Lq"], qc["Ls"], qc["Rq"], qc["Rs"])
    assert torch.equal(blockwise_monarch(x, deq["L"], deq["R"], T), want)
    xb = x.element_size()
    geo = fused_geometry(L_shape, R_shape, T, xb, bits)
    assert geo._replace(smem_bytes=0) == fused_geometry(
        L_shape, R_shape, T, xb, 32)._replace(smem_bytes=0)
