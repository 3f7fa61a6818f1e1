"""The port's Monarch core and Monarch kernel wrappers against the JAX
reference: dims bookkeeping for every shipped config, the einsum product,
and ``monarch_mm``/``bdmm_mm`` (their plain versions, on the CPU) against
the Pallas ``monarch_fused``/``bdmm`` kernels in interpret mode.

Inputs are made with numpy from a fixed seed and handed to both packages.
Tolerances are the reference kernel tests' own (tests/test_kernels.py):
2e-5 for fp32 (both sides accumulate in fp32, in other orders) and 2e-2
for a bf16 output (one bf16 rounding, ~0.4% relative, apart)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import linear as jlin
from repro.core import monarch as jmn
from repro.kernels.bdmm import bdmm as jbdmm
from repro.kernels.monarch import monarch_fused as jmonarch_fused
from repro.kernels.ref import monarch_ref as jmonarch_ref
from repro_torch.core import linear as tlin
from repro_torch.core import monarch as tmn
from repro_torch.kernels import launches, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.monarch import fused_fits

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same numpy values as a jax array and a torch tensor of
    ``dtype`` (both round fp32 -> bf16 to nearest even)."""
    jd, td = DTYPES[dtype]
    return (jnp.asarray(a, jnp.float32).astype(jd),
            torch.from_numpy(np.asarray(a, np.float32)).to(td))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _factors(din, dout, k, q, seed=0):
    rng = np.random.default_rng(seed)
    dims = tmn.MonarchDims(din=din, dout=dout, k=k, q=q)
    L = rng.standard_normal(dims.l_shape) / np.sqrt(dims.p)
    R = rng.standard_normal(dims.r_shape) / np.sqrt(dims.k)
    return L.astype(np.float32), R.astype(np.float32)


# ---------------------------------------------------------------------------
# dims bookkeeping
# ---------------------------------------------------------------------------


ARCHS = jconfigs.ALL_ARCHS + jconfigs.PAPER_MODELS_JAX


@pytest.mark.parametrize("variant", ["", ":mxu"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_dims_equal_for_every_shipped_config(arch, variant,
                                                  monkeypatch):
    """Every Monarch projection the reference sizes for a shipped config
    gets the same (k, q, p, s) from the port's ``make_dims``."""
    calls = []
    real = jmn.make_dims

    def record(din, dout, policy="paper", nblocks=None):
        calls.append((din, dout, policy, nblocks))
        return real(din, dout, policy=policy, nblocks=nblocks)

    monkeypatch.setattr(jmn, "make_dims", record)
    jconfigs.get_config(arch + variant).param_count()
    assert calls, "config sized no Monarch projection"
    for din, dout, policy, nblocks in calls:
        want = real(din, dout, policy=policy, nblocks=nblocks)
        got = tmn.make_dims(din, dout, policy=policy, nblocks=nblocks)
        assert (got.k, got.q, got.p, got.s) == (want.k, want.q, want.p,
                                                want.s), (din, dout)


@pytest.mark.parametrize("n,target", [(1024, 32), (4096, 64), (13440, 116),
                                      (50257, 224), (1, 1), (97, 10)])
def test_closest_divisor_matches(n, target):
    assert tmn.closest_divisor(n, target) == jmn.closest_divisor(n, target)


def test_gpt2_medium_dims_are_the_issue_table():
    """The shapes the Hopper kernels are sized for (PERF.md)."""
    got = {(din, dout): tmn.make_dims(din, dout)
           for din, dout in ((1024, 1024), (1024, 4096), (4096, 1024))}
    assert [(d.l_shape, d.r_shape) for d in got.values()] == [
        ((32, 32, 32), (32, 32, 32)),
        ((32, 32, 32), (32, 128, 32)),
        ((64, 64, 64), (64, 16, 64))]
    assert all(fused_fits(d.l_shape, d.r_shape) for d in got.values())
    big = tmn.make_dims(4096, 4096, nblocks=128)
    assert not fused_fits(big.l_shape, big.r_shape)


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

SHAPES = [  # tests/test_kernels.py:65-70
    (64, 256, 256, 16),
    (96, 1024, 1024, 32),
    (128, 1024, 4096, 32),
    (50, 4096, 1024, 64),
]


@pytest.mark.parametrize("T,din,dout,kq", SHAPES)
def test_monarch_multiply_and_dense_match_reference(T, din, dout, kq):
    L, R = _factors(din, dout, kq, kq)
    x = np.random.default_rng(1).standard_normal((T, din)).astype(np.float32)
    want = jmn.monarch_multiply(jnp.asarray(x), jnp.asarray(L),
                                jnp.asarray(R))
    got = tmn.monarch_multiply(torch.from_numpy(x), torch.from_numpy(L),
                               torch.from_numpy(R))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])
    np.testing.assert_allclose(
        tmn.monarch_to_dense(torch.from_numpy(L), torch.from_numpy(R)).numpy(),
        np.asarray(jmn.monarch_to_dense(jnp.asarray(L), jnp.asarray(R))),
        **TOL["float32"])
    np.testing.assert_allclose(
        tref.monarch_ref(torch.from_numpy(x), torch.from_numpy(L),
                         torch.from_numpy(R)).numpy(),
        np.asarray(jmonarch_ref(jnp.asarray(x), jnp.asarray(L),
                                jnp.asarray(R))), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,din,dout,kq", SHAPES)
def test_monarch_mm_matches_pallas_kernel(T, din, dout, kq, dtype):
    L, R = _factors(din, dout, kq, kq)
    x = np.random.default_rng(2).standard_normal((T, din)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jL, tL = _pair(L, dtype)
    jR, tR = _pair(R, dtype)
    want = jmonarch_fused(jx, jL, jR, interpret=True)
    before = launches()
    got = ops.monarch_mm(tx, tL, tR)
    assert launches() == before, "the CPU path must not count launches"
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


BDMM_SHAPES = [  # tests/test_kernels.py:29-35
    (64, 4, 32, 32),
    (100, 8, 16, 48),
    (256, 2, 128, 128),
    (8, 16, 8, 8),
    (512, 1, 64, 64),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,k,p,q", BDMM_SHAPES)
def test_bdmm_mm_matches_pallas_kernel(T, k, p, q, dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((T, k, p)).astype(np.float32)
    w = rng.standard_normal((k, q, p)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(w, dtype)
    want = jbdmm(jx, jw, interpret=True)
    got = ops.bdmm_mm(tx, tw)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    np.testing.assert_allclose(
        tref.bdmm_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.einsum("tkp,kqp->tkq", x, w), rtol=1e-4, atol=1e-4)


def test_staged_branch_matches_reference_oracle():
    """A factor pair too wide for the fused kernel takes the two-bdmm
    branch, with the stride permutation read through strides."""
    dims = tmn.make_dims(4096, 4096, nblocks=128)
    L, R = _factors(4096, 4096, dims.k, dims.q, seed=4)
    x = np.random.default_rng(5).standard_normal((6, 4096)).astype(np.float32)
    want = jmonarch_ref(jnp.asarray(x), jnp.asarray(L), jnp.asarray(R))
    got = ops.monarch_mm(torch.from_numpy(x), torch.from_numpy(L),
                         torch.from_numpy(R))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


@pytest.mark.parametrize("backend", ["einsum", "pallas"])
def test_mixed_bf16_x_f32_factors_dtype_flow(backend):
    """bf16 activations against fp32 factors: the einsum path promotes to
    fp32 and the kernel path returns bf16, in both packages; the values
    agree at the bf16 tolerance."""
    L, R = _factors(256, 256, 16, 16, seed=6)
    x = np.random.default_rng(7).standard_normal((3, 5, 256)).astype(
        np.float32)
    jx, tx = _pair(x, "bfloat16")
    want = jlin.linear_apply({"L": jnp.asarray(L), "R": jnp.asarray(R)}, jx,
                             backend=backend)
    got = tlin.linear_apply({"L": torch.from_numpy(L),
                             "R": torch.from_numpy(R)}, tx, backend=backend)
    assert str(got.dtype).split(".")[1] == str(want.dtype)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL["bfloat16"])


def test_linear_apply_dense_bias_and_nested_d2s_container():
    rng = np.random.default_rng(8)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    b = rng.standard_normal((48,)).astype(np.float32)
    L, R = _factors(256, 256, 16, 16, seed=9)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    x2 = rng.standard_normal((4, 256)).astype(np.float32)
    for jp, tp, xx in (
            ({"w": w, "b": b}, {"w": w, "b": b}, x),
            ({"w": {"L": L, "R": R}, "b": np.zeros(256, np.float32)},
             {"w": {"L": L, "R": R}, "b": np.zeros(256, np.float32)}, x2)):
        jt = jax.tree_util.tree_map(jnp.asarray, jp)
        tt = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
                  if isinstance(v, dict) else torch.from_numpy(v))
              for k, v in tp.items()}
        np.testing.assert_allclose(
            tlin.linear_apply(tt, torch.from_numpy(xx)).numpy(),
            np.asarray(jlin.linear_apply(jt, jnp.asarray(xx))),
            **TOL["float32"])


def test_quantized_container_is_not_ported_yet():
    with pytest.raises(NotImplementedError):
        tlin.linear_apply({"Lq": 0, "Rq": 0, "Ls": 0, "Rs": 0},
                          torch.zeros(2, 4))


def test_init_monarch_matches_in_distribution():
    """The port's init draws other numbers than jax.random but with the
    reference's per-factor variances (1/p and 1/k)."""
    dims = tmn.make_dims(1024, 4096)
    gen = torch.Generator().manual_seed(0)
    got = tmn.init_monarch(gen, dims)
    want = jmn.init_monarch(jax.random.PRNGKey(0), dims)
    for name in ("L", "R"):
        assert tuple(got[name].shape) == tuple(want[name].shape)
        assert got[name].dtype == torch.float32
        np.testing.assert_allclose(float(got[name].std()),
                                   float(jnp.std(want[name])), rtol=0.05)
    spec = dataclasses.replace(jlin.MonarchSpec(enable=True), min_dim=64)
    tspec = tlin.MonarchSpec(**dataclasses.asdict(spec))
    p = tlin.linear_init(gen, 256, 128, spec=tspec, use_bias=True)
    assert set(p) == {"L", "R", "b"}
