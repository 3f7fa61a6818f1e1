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
from repro_torch.kernels.monarch import (SMEM_BUDGET_BYTES, fused_fits,
                                         fused_geometry, monarch_fused_plain)

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


@pytest.mark.parametrize("backend", ["einsum", "pallas"])
def test_quantized_container_matches_reference(backend):
    """An int8 container made by the reference's ``quantize_monarch`` and
    carried across as numpy goes through the port's ``linear_apply`` on
    both backends (``monarch_mm_q``'s plain version, or dequantize then the
    einsum product) to the reference's output."""
    from repro.core import quant as jq

    L, R = _factors(256, 512, 16, 16, seed=10)
    jc = jq.quantize_monarch({"L": jnp.asarray(L), "R": jnp.asarray(R)}, 8)
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    x = np.random.default_rng(11).standard_normal((3, 256)).astype(
        np.float32)
    want = jlin.linear_apply(jc, jnp.asarray(x), backend=backend)
    got = tlin.linear_apply(tc, torch.from_numpy(x), backend=backend)
    assert got.shape == (3, 512) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])


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


# ---------------------------------------------------------------------------
# the fused kernel's launch geometry (csrc/monarch.cu): a grid over token
# tiles, q-blocks and slabs of R[i]'s rows
# ---------------------------------------------------------------------------

# every Monarch shape gpt2-medium serves through the fused kernel: its
# three projections, the fused QKV, and the rank-local shapes at tp 2 and
# 4 (column-parallel halves q, row-parallel halves k: sharding/params.py)
SERVING_SHAPES = {
    "attn": ((32, 32, 32), (32, 32, 32)),
    "w1": ((32, 32, 32), (32, 128, 32)),
    "w2": ((64, 64, 64), (64, 16, 64)),
    "qkv_fused": ((32, 96, 32), (96, 32, 32)),
    "tp2_attn_col": ((32, 16, 32), (16, 32, 32)),
    "tp2_w1": ((32, 16, 32), (16, 128, 32)),
    "tp2_wo": ((16, 32, 32), (32, 32, 16)),
    "tp2_w2": ((32, 64, 64), (64, 16, 32)),
    "tp4_attn_col": ((32, 8, 32), (8, 32, 32)),
    "tp4_w1": ((32, 8, 32), (8, 128, 32)),
    "tp4_wo": ((8, 32, 32), (32, 32, 8)),
    "tp4_w2": ((16, 64, 64), (64, 16, 16)),
}
GEOMETRY_T = (1, 7, 8, 64, 512, 513)


def fused_blocks(geo, q: int, s: int, T: int) -> list:
    """What the blocks of a launch compute, in block order, one entry per
    q-block a block owns: (t0, nt, i, c0, ns), i.e.
    ``y[t0:t0+nt, i*s+c0 : i*s+c0+ns]`` from ``L[:, i, :]`` and
    ``R[i, c0:c0+ns]`` -- csrc/monarch.cu's decoding of ``blockIdx``."""
    out = []
    n_groups = q // geo.q_group
    for b in range(geo.grid):
        sl, rest = b % geo.n_slabs, b // geo.n_slabs
        i0, tile = rest % n_groups * geo.q_group, rest // n_groups
        t0, c0 = tile * geo.tile_t, sl * geo.slab
        out += [(t0, min(geo.tile_t, T - t0), i0 + ii, c0,
                 min(geo.slab, s - c0)) for ii in range(geo.q_group)]
    return out


def test_serving_shapes_are_the_models_own():
    """SERVING_SHAPES are what make_dims, fuse_linears and the tp split
    give gpt2-medium (the split halves q or k of the tp = 1 shapes)."""
    attn, w1, w2 = (tmn.make_dims(a, b) for a, b in (
        (1024, 1024), (1024, 4096), (4096, 1024)))
    got = {n: (d.l_shape, d.r_shape) for n, d in
           (("attn", attn), ("w1", w1), ("w2", w2))}
    for n, shapes in got.items():
        assert SERVING_SHAPES[n] == shapes
    for tp in (2, 4):
        for n, col in (("attn", True), ("w1", True), ("attn", False),
                       ("w2", False)):
            (k, q, p), (_, s, _) = SERVING_SHAPES[n]
            local = (((k, q // tp, p), (q // tp, s, k)) if col else
                     ((k // tp, q, p), (q, s, k // tp)))
            name = f"tp{tp}_" + {("attn", True): "attn_col",
                                 ("w1", True): "w1", ("attn", False): "wo",
                                 ("w2", False): "w2"}[(n, col)]
            assert SERVING_SHAPES[name] == local


@pytest.mark.parametrize("T", GEOMETRY_T)
@pytest.mark.parametrize("name", sorted(SERVING_SHAPES))
def test_fused_geometry_tiles_the_output_once_within_shared_memory(name, T):
    """For every dtype pair the kernel takes, the blocks fit shared memory
    and tile [0, T) x [0, q*s) exactly once; the blocks, tile, q-group,
    slab and chunk do not depend on the dtypes (so B4 sums in B1's order);
    a decode launch (T <= 16) has one block a q-block, each with all s
    rows of R[i] (spreading it wider was slower on the H100); a T = 512
    launch at least 128 blocks."""
    L_shape, R_shape = SERVING_SHAPES[name]
    k, q, p = L_shape
    s = R_shape[1]
    assert fused_fits(L_shape, R_shape)
    geos = {(xb, wb): fused_geometry(L_shape, R_shape, T, xb, wb)
            for xb in (4, 2) for wb in (32, 16, 8, 4)}
    for geo in geos.values():
        assert geo is not None
        assert geo.smem_bytes <= SMEM_BUDGET_BYTES
        assert geo.threads == 256 and k % geo.chunk == 0
        assert geo._replace(smem_bytes=0) == geos[4, 32]._replace(
            smem_bytes=0)
    geo = geos[4, 32]
    assert q % geo.q_group == 0
    assert geo.grid == geo.n_tiles * q // geo.q_group * geo.n_slabs
    if T <= 16:
        assert (geo.q_group, geo.slab, geo.grid) == (1, s, q)
    if T == 512:
        assert geo.grid >= 128
    cover = np.zeros((T, q * s), np.int32)
    for t0, nt, i, c0, ns in fused_blocks(geo, q, s, T):
        assert nt >= 1 and ns >= 1
        cover[t0:t0 + nt, i * s + c0:i * s + c0 + ns] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("T", [1, 8, 64])
@pytest.mark.parametrize("slab", [1, 5, 11])
@pytest.mark.parametrize("name", ["attn", "w1", "tp2_w2"])
def test_fused_geometry_slab_override_tiles_the_output_once(name, slab, T):
    """A launch with fewer rows of R[i] a block than the plan (what
    chip_smoke's monarch_geometry phase compares against) keeps the plan's
    tile, q-group and chunk, masks the last slab, and still tiles the
    output exactly once within shared memory; a slab outside [1, s] has no
    geometry."""
    L_shape, R_shape = SERVING_SHAPES[name]
    q, s = R_shape[:2]
    plan = fused_geometry(L_shape, R_shape, T, 2, 32)
    geo = fused_geometry(L_shape, R_shape, T, 2, 32, slab=slab)
    assert geo.smem_bytes <= SMEM_BUDGET_BYTES
    assert (geo.tile_t, geo.q_group, geo.chunk) == (
        plan.tile_t, plan.q_group, plan.chunk)
    assert geo.slab == slab and geo.n_slabs == -(-s // slab)
    assert geo.grid == plan.grid // plan.n_slabs * geo.n_slabs
    cover = np.zeros((T, q * s), np.int32)
    for t0, nt, i, c0, ns in fused_blocks(geo, q, s, T):
        cover[t0:t0 + nt, i * s + c0:i * s + c0 + ns] += 1
    assert (cover == 1).all()
    for bad in (0, s + 1):
        assert fused_geometry(L_shape, R_shape, T, 2, 32, slab=bad) is None


def test_launch_args_pack_the_geometry_in_the_kernels_order():
    """One int array per launch (csrc/monarch.cu: Args): shape, geometry,
    x's dtype code, then the factors' dtype code or bits, then the experts
    of a stacked launch (1 for a single product; the geometry is one
    expert's); an unsupported dtype raises before any launch."""
    from repro_torch.kernels.monarch import _launch_args

    (k, q, p), (_, s, _) = SERVING_SHAPES["w2"]
    geo = fused_geometry((k, q, p), (q, s, k), 8, 2, 16)
    head = [8, k, q, p, s, geo.tile_t, geo.q_group, geo.slab, geo.chunk,
            geo.grid, geo.threads, geo.smem_bytes]
    assert list(_launch_args("t", k, q, p, s, 8, torch.bfloat16,
                             torch.bfloat16)) == head + [1, 1, 1]
    assert list(_launch_args("t", k, q, p, s, 8, torch.bfloat16,
                             torch.bfloat16, E=64)) == head + [1, 1, 64]
    geo = fused_geometry((k, q, p), (q, s, k), 8, 4, 4)
    assert list(_launch_args("t", k, q, p, s, 8, torch.float32, 4)) == [
        8, k, q, p, s, geo.tile_t, geo.q_group, geo.slab, geo.chunk,
        geo.grid, geo.threads, geo.smem_bytes, 0, 4, 1]
    geo = fused_geometry((k, q, p), (q, s, k), 8, 2, 32, slab=5)
    assert list(_launch_args("t", k, q, p, s, 8, torch.bfloat16,
                             torch.float32, 5))[7:10] == [5, geo.chunk,
                                                          geo.grid]
    with pytest.raises(TypeError, match="unsupported dtype"):
        _launch_args("t", k, q, p, s, 8, torch.float16, torch.float32)


def _old_fused_fits(L_shape, R_shape) -> bool:
    """The fit rule the first kernel launched with: an 8-row token tile,
    else a 4-row one, of its fp32 intermediate plus one padded factor
    block and a slice of x fits 227 KB."""
    k, q, p = L_shape
    _, s, _ = R_shape
    return any(4 * (t * k * q + max(q * (p + 1), s * (k + 1)) + t * p)
               <= 232448 for t in (8, 4))


def _dispatch_shapes():
    shapes = list(SERVING_SHAPES.values())
    for din, dout in ((1024, 1024), (1024, 4096), (4096, 1024),
                      (4096, 4096), (1024, 3072), (2048, 8192)):
        for nb in (None, 16, 64, 128, 256):
            try:
                d = tmn.make_dims(din, dout, nblocks=nb)
            except ValueError:
                continue
            shapes.append((d.l_shape, d.r_shape))
    rng = np.random.default_rng(12)
    for _ in range(300):
        k, q, p, s = (int(v) for v in rng.integers(1, 257, 4))
        shapes.append(((k, q, p), (q, s, k)))
    return shapes


def test_fused_fits_dispatch_is_unchanged():
    """The same shapes go fused and staged as under the first kernel:
    gpt2-medium's serving shapes fused, the 128-block shapes staged, and a
    seeded sweep of shapes decided as before.  Every shape that goes fused
    has a launch geometry at every T the serve uses."""
    shapes = _dispatch_shapes()
    for L_shape, R_shape in shapes:
        assert fused_fits(L_shape, R_shape) == _old_fused_fits(L_shape,
                                                               R_shape)
    for L_shape, R_shape in SERVING_SHAPES.values():
        assert fused_fits(L_shape, R_shape)
    for din, dout in ((1024, 1024), (1024, 4096), (4096, 1024),
                      (4096, 4096)):
        d = tmn.make_dims(din, dout, nblocks=128)
        assert not fused_fits(d.l_shape, d.r_shape)
    for L_shape, R_shape in shapes:
        if fused_fits(L_shape, R_shape):
            for T in (1, 8, 64, 513):
                geo = fused_geometry(L_shape, R_shape, T, 4, 32)
                assert geo is not None, (L_shape, R_shape, T)
                assert geo.smem_bytes <= SMEM_BUDGET_BYTES


def blockwise_monarch(x, L, R, T):
    """The fused kernel's split done in plain torch, block by block as
    fused_geometry lays them out: each block computes u_i from L[:, i, :]
    alone, rounds it to x's dtype, and writes its slab from R[i]'s rows.
    The blocks of one token tile run as one batched product (a batch entry
    a block's q-block), each entry reading only its own ``L[:, i, :]`` and
    ``R[i, c0:c0+ns]``; entries are grouped by slab width."""
    k, q, p = L.shape
    s = R.shape[1]
    geo = fused_geometry(tuple(L.shape), tuple(R.shape), T,
                         x.element_size(), 8 * L.element_size())
    y = torch.full((T, q * s), float("nan"), dtype=x.dtype)
    groups: dict = {}
    for t0, nt, i, c0, ns in fused_blocks(geo, q, s, T):
        groups.setdefault((t0, nt, ns), []).append((i, c0))
    Lf, Rf = L.float(), R.float()
    for (t0, nt, ns), blocks in groups.items():
        ii = torch.tensor([i for i, _ in blocks])
        cols = torch.tensor([c0 for _, c0 in blocks])[:, None] + \
            torch.arange(ns)                                  # (n, ns)
        xt = x[t0:t0 + nt].float().reshape(nt, k, p)
        u = torch.einsum("tkp,nkp->ntk", xt, Lf[:, ii, :].transpose(0, 1))
        u = u.to(x.dtype).float()
        yb = torch.einsum("ntk,nsk->nts", u, Rf[ii[:, None], cols])
        y[t0:t0 + nt, (ii[:, None] * s + cols).reshape(-1)] = yb.permute(
            1, 0, 2).reshape(nt, -1).to(x.dtype)
    return y


def small_ints(rng, shape, hi: int = 3) -> torch.Tensor:
    """Integers in [-hi, hi] as fp32.  With factors in [-3, 3] and x in
    [-64, 64] every product and partial sum of the split is below 2**24,
    so exact in fp32, and the comparison does not depend on the order in
    which torch's CPU kernels sum; a bf16 intermediate (|u| in the
    hundreds) still rounds."""
    return torch.from_numpy(rng.integers(-hi, hi + 1, shape).astype(
        np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 7, 8, 64, 513])
@pytest.mark.parametrize("name", ["attn", "w2", "qkv_fused", "tp2_wo",
                                  "tp4_attn_col"])
def test_blockwise_split_equals_monarch_fused_plain(name, T, dtype):
    """Following the kernel's blocks computes the whole product, bitwise
    monarch_fused_plain: each output block from L[:, i, :] and its rows of
    R[i] alone, with the intermediate rounded to x's dtype in between."""
    L_shape, R_shape = SERVING_SHAPES[name]
    rng = np.random.default_rng(13)
    L, R = small_ints(rng, L_shape), small_ints(rng, R_shape)
    x = small_ints(rng, (T, L_shape[0] * L_shape[2]), 64).to(
        DTYPES[dtype][1])
    got = blockwise_monarch(x, L, R, T)
    assert torch.equal(got, monarch_fused_plain(x, L, R))
    if dtype == "bfloat16" and T >= 8:  # the rounding was exercised
        u = torch.einsum("tkp,kqp->tkq", x.float().reshape(T, *L_shape[::2]),
                         L)
        assert not torch.equal(u.to(x.dtype).float(), u)
