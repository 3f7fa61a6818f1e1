"""The staged Monarch kernel's launch geometry (``kernels/bdmm.py:
bdmm_geometry``), its plain versions against the Pallas ``bdmm`` /
``bdmm_q`` in interpret mode at the feed-forward shapes of nemotron-4-15b
and codeqwen1.5-7b, and which branch each package's Monarch dispatch takes
at those shapes and at 128 blocks.

Inputs are made with numpy from a fixed seed and handed to both packages.
Tolerances are the reference kernel tests' own (tests/test_kernels.py:17-19):
2e-5 for fp32 and 2e-2 for a bf16 output."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.kernels.bdmm import bdmm as jbdmm
from repro.kernels.bdmm import bdmm_q as jbdmm_q
from repro.kernels.monarch import fused_fits as ref_fused_fits
from repro_torch.core import monarch as tmn
from repro_torch.core import quant as tquant
from repro_torch.kernels import bdmm as BD
from repro_torch.kernels import ops
from repro_torch.kernels.bdmm import bdmm_geometry
from repro_torch.kernels.monarch import (SMEM_BUDGET_BYTES, fused_fits,
                                         monarch_fused_plain)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# the feed-forward factor pairs of two shipped configs (paper-policy dims,
# make_dims): nemotron-4-15b d_model 6144, d_ff 24576; codeqwen1.5-7b
# d_model 4096, d_ff 13440
FFN_PAIRS = {"nemotron_w1": (6144, 24576), "nemotron_w2": (24576, 6144),
             "codeqwen_w2": (13440, 4096)}
# the 128-block pairs the staged serves run (gpt2-medium's projections)
NB128_PAIRS = {"1024x1024": (1024, 1024), "1024x4096": (1024, 4096),
               "4096x1024": (4096, 1024), "4096x4096": (4096, 4096)}


def _dims(din, dout, nblocks=None):
    return tmn.make_dims(din, dout, nblocks=nblocks)


def _stage_shapes():
    """(name, (k, q, p), x_contiguous) of both stages of every pair, plus
    ragged and odd blocks: p with no 4-value unit, a block too large for
    shared memory whole."""
    out = []
    for name, (din, dout) in {**FFN_PAIRS, **NB128_PAIRS}.items():
        d = _dims(din, dout, None if name in FFN_PAIRS else 128)
        out.append((f"{name}_s1", d.l_shape, True))
        out.append((f"{name}_s2", d.r_shape, False))
    out += [("ragged", (8, 48, 16), True), ("ragged_t", (8, 48, 16), False),
            ("odd_p", (5, 11, 7), True), ("big_block", (4, 1024, 256), True),
            ("p8", (16, 8, 8), False)]
    return out


STAGES = _stage_shapes()
GEOMETRY_T = [1, 5, 8, 16, 17, 100, 512]


def blocks_of(geo, T, k, q):
    """Every launched block's (t0, nt, j0, nj, n0, nn) as csrc/bdmm.cu reads
    the geometry: slab fastest, then the group of diagonal blocks, then
    the token tile; the ragged ends masked."""
    for b in range(geo.grid):
        sl = b % geo.n_slabs
        rest = b // geo.n_slabs
        grp, tile = rest % geo.n_groups, rest // geo.n_groups
        t0, j0, n0 = tile * geo.tile_t, grp * geo.group, sl * geo.slab
        yield (t0, min(geo.tile_t, T - t0), j0, min(geo.group, k - j0), n0,
               min(geo.slab, q - n0))


@pytest.mark.parametrize("T", GEOMETRY_T)
@pytest.mark.parametrize("name,blocks,contiguous", STAGES,
                         ids=[s[0] for s in STAGES])
def test_bdmm_geometry_tiles_the_output_once_within_shared_memory(
        name, blocks, contiguous, T):
    """For bf16 and fp32 x and every weight width the blocks fit shared
    memory and cover [0, T) x [0, k) x [0, q) exactly once; a decode block
    has a lane group for each of its rows (one pass), a prefill block's 8
    warps are its group x token x row tiles of mma.sync m16n8k8."""
    k, q, p = blocks
    for xb in (2, 4):
        for bits in (32, 16, 8, 4):
            if bits == 4 and p % 2:
                continue
            geo = bdmm_geometry(T, k, q, p, xb, bits, contiguous)
            assert geo.smem_bytes <= SMEM_BUDGET_BYTES
            assert geo.threads == 256
            if geo.instance == "decode":
                assert geo.tile_t == T and geo.unit in (4, 1)
                assert p % geo.unit == 0
                assert geo.lanes in (1, 2, 4, 8, 16, 32)
                assert geo.group * geo.slab <= geo.threads // geo.lanes
            else:
                assert geo.group * geo.warps_m * geo.warps_n == 8
                assert geo.tile_t == 32 * geo.warps_m
                assert geo.slab == 8 * geo.n_frag * geo.warps_n
                assert geo.n_frag in (1, 2, 4) and geo.group in (1, 2, 4, 8)
    geo = bdmm_geometry(T, k, q, p, 2, 32, contiguous)
    assert geo.grid == geo.n_tiles * geo.n_groups * geo.n_slabs
    cover = np.zeros((T, k, q), np.int32)
    for t0, nt, j0, nj, n0, nn in blocks_of(geo, T, k, q):
        assert nt >= 1 and nj >= 1 and nn >= 1
        cover[t0:t0 + nt, j0:j0 + nj, n0:n0 + nn] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("name,blocks,contiguous", STAGES,
                         ids=[s[0] for s in STAGES])
def test_bdmm_geometry_ignores_the_weights_width(name, blocks, contiguous):
    """The launch depends on the shapes (and x's width) only: every weight
    width gets the same blocks, so bdmm_q sums in bdmm's order and is
    bitwise bdmm on the dequantized blocks; only the prefill staging's
    bytes differ."""
    k, q, p = blocks
    for T in (3, 8, 64, 512):
        for xb in (2, 4):
            base = bdmm_geometry(T, k, q, p, xb, 32, contiguous)
            for bits in (16, 8, 4):
                if bits == 4 and p % 2:
                    continue
                geo = bdmm_geometry(T, k, q, p, xb, bits, contiguous)
                assert geo._replace(smem_bytes=0) == base._replace(
                    smem_bytes=0)


def test_bdmm_geometry_picks_decode_up_to_the_threshold():
    """The decode instance up to DECODE_MAX_T tokens, the prefill one above
    it, and prefill where the decode instance's x slice does not fit shared
    memory; either can be asked for, decode only within its tokens."""
    for T in range(1, BD.DECODE_MAX_T + 1):
        assert bdmm_geometry(T, 192, 192, 128).instance == "decode"
        assert bdmm_geometry(T, 192, 192, 128,
                             instance="prefill").instance == "prefill"
    for T in (BD.DECODE_MAX_T + 1, 64, 512):
        assert bdmm_geometry(T, 192, 192, 128).instance == "prefill"
        with pytest.raises(ValueError, match="no decode launch"):
            bdmm_geometry(T, 192, 192, 128, instance="decode")
    wide = bdmm_geometry(16, 2, 8, 4096)  # 16 x 4096 fp32 x: 256 KiB
    assert wide.instance == "prefill"
    assert wide.smem_bytes <= SMEM_BUDGET_BYTES


def test_bdmm_geometry_packs_small_blocks():
    """Small blocks: at 128 blocks of 8-row or 8-value rows every launch
    still has a block per SM; the prefill instance packs 8 diagonal blocks
    a tile for stage 2's transposed input, whose blocks are its contiguous
    axis (a token's value of 8 blocks is one 16-byte run of bf16); the
    decode instance packs diagonal blocks where their rows are fewer than a
    block's lane groups."""
    d = _dims(1024, 1024, 128)
    assert d.l_shape == (128, 128, 8) and d.r_shape == (128, 8, 128)
    for T in (8, 512):
        for blocks in (d.l_shape, d.r_shape):
            geo = bdmm_geometry(T, *blocks, 2, 32, blocks == d.l_shape)
            assert geo.grid >= 128  # every SM has a block
    s2 = bdmm_geometry(512, *d.r_shape, 2, 32, False)
    assert s2.instance == "prefill" and s2.group == 8
    tiny = bdmm_geometry(8, 64, 2, 128)  # 2-row blocks
    assert tiny.instance == "decode" and tiny.group > 1
    assert tiny.group * tiny.slab <= tiny.threads // tiny.lanes


@pytest.mark.parametrize("T", [1, 8, 16, 17, 512])
def test_bdmm_geometry_takes_a_block_too_large_for_shared_memory_whole(T):
    """A 1024 x 256 fp32 block is 1 MiB, four times a block's shared
    memory: the kernel slabs its rows and chunks p, so the geometry fits
    and tiles the output once."""
    for k, q, p in ((4, 1024, 256), (2, 1024, 1024)):
        assert 4 * q * p > SMEM_BUDGET_BYTES
        for contiguous in (True, False):
            geo = bdmm_geometry(T, k, q, p, 4, 32, contiguous)
            assert geo.smem_bytes <= SMEM_BUDGET_BYTES
            cover = np.zeros((T, k, q), np.int32)
            for t0, nt, j0, nj, n0, nn in blocks_of(geo, T, k, q):
                cover[t0:t0 + nt, j0:j0 + nj, n0:n0 + nn] += 1
            assert (cover == 1).all()


def test_bdmm_geometry_rejects_what_the_kernel_does_not_take():
    for bad in (dict(T=0), dict(q=0)):
        kw = {"T": 8, "k": 4, "q": 8, "p": 16, **bad}
        with pytest.raises(ValueError):
            bdmm_geometry(kw["T"], kw["k"], kw["q"], kw["p"])
    with pytest.raises(ValueError, match="bit"):
        bdmm_geometry(8, 4, 8, 16, 2, 2)
    with pytest.raises(ValueError, match="instance"):
        bdmm_geometry(8, 4, 8, 16, instance="fused")


def test_launch_args_pack_the_geometry_in_the_kernels_order():
    """One int array per launch (csrc/bdmm.cu: Args): shape, instance,
    geometry, x's dtype code, then the weights' dtype code or bits; an
    unsupported dtype raises before any launch."""
    from repro_torch.kernels.bdmm import _launch_args

    for T, blocks, contiguous in ((8, (192, 192, 128), True),
                                  (512, (192, 32, 192), False)):
        k, q, p = blocks
        for x_dtype, w, xb, bits, codes in (
                (torch.bfloat16, torch.float32, 2, 32, [1, 0]),
                (torch.float32, torch.bfloat16, 4, 16, [0, 1]),
                (torch.bfloat16, 8, 2, 8, [1, 8]),
                (torch.float32, 4, 4, 4, [0, 4])):
            g = bdmm_geometry(T, k, q, p, xb, bits, contiguous)
            got = list(_launch_args("t", T, k, q, p, x_dtype, w, contiguous))
            assert got == [T, k, q, p, 0 if g.instance == "decode" else 1,
                           g.tile_t, g.group, g.slab, g.lanes, g.unit,
                           g.warps_m, g.warps_n, g.n_frag, g.grid, g.threads,
                           g.smem_bytes] + codes
    got = list(_launch_args("t", 8, 16, 8, 64, torch.bfloat16,
                            torch.float32, True, instance="prefill"))
    assert got[4] == 1
    with pytest.raises(TypeError, match="unsupported dtype"):
        _launch_args("t", 8, 16, 8, 64, torch.float16, torch.float32)


def _pair(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return (jnp.asarray(a, jnp.float32).astype(jd),
            torch.from_numpy(np.asarray(a, np.float32)).to(td))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


FFN_STAGES = [(f"{name}_s{i + 1}", shape)
              for name, (din, dout) in FFN_PAIRS.items()
              for i, shape in enumerate((_dims(din, dout).l_shape,
                                         _dims(din, dout).r_shape))
              if name != "nemotron_w1"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,blocks", FFN_STAGES,
                         ids=[s[0] for s in FFN_STAGES])
def test_bdmm_plain_matches_pallas_at_ffn_stages(name, blocks, dtype):
    """bdmm's plain version (what a CPU tensor runs) against the Pallas
    bdmm in interpret mode at nemotron w2's and codeqwen w2's stage shapes,
    ragged T = 5, x through the transposed view stage 2 reads."""
    k, q, p = blocks
    rng = np.random.default_rng(16)
    x = rng.standard_normal((5, p, k)).astype(np.float32)
    w = (rng.standard_normal((k, q, p)) / np.sqrt(p)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(w, dtype)
    want = jbdmm(jnp.swapaxes(jx, 1, 2), jw, interpret=True)
    got = BD.bdmm(tx.transpose(1, 2), tw)
    assert got.dtype == tx.dtype and tuple(got.shape) == (5, k, q)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,blocks", FFN_STAGES,
                         ids=[s[0] for s in FFN_STAGES])
def test_bdmm_q_plain_matches_pallas_at_ffn_stages(name, blocks, dtype,
                                                   bits):
    """bdmm_q's plain version against the Pallas bdmm_q in interpret mode
    on the same int8 / int4 blocks and scales (quantized by the
    reference), T = 5."""
    k, q, p = blocks
    rng = np.random.default_rng(17)
    x = rng.standard_normal((5, k, p)).astype(np.float32)
    w = (rng.standard_normal((k, q, p)) / np.sqrt(p)).astype(np.float32)
    jwq, jsc = jquant.quantize_factor(jnp.asarray(w), bits)
    jx, tx = _pair(x, dtype)
    want = jbdmm_q(jx, jwq, jsc, interpret=True)
    twq = torch.from_numpy(np.array(jwq))
    tsc = torch.from_numpy(np.array(jsc))
    got = BD.bdmm_q(tx, twq, tsc)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    assert torch.equal(got, BD.bdmm(tx, tquant.dequantize_factor(
        twq, tsc, unpacked_dim=p)))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("name", sorted(FFN_PAIRS))
def test_monarch_mm_goes_staged_at_the_ffn_pairs(name, quantized,
                                                 monkeypatch):
    """ops.monarch_mm / monarch_mm_q take the two-bdmm branch at the three
    feed-forward pairs (the port's fused fit refuses them), stage 2 on
    stage 1's output through its transposed view, and agree with the fused
    product's plain version."""
    din, dout = FFN_PAIRS[name]
    d = _dims(din, dout)
    assert not fused_fits(d.l_shape, d.r_shape)
    rng = np.random.default_rng(18)
    L = torch.from_numpy((rng.standard_normal(d.l_shape)
                          / np.sqrt(d.p)).astype(np.float32))
    R = torch.from_numpy((rng.standard_normal(d.r_shape)
                          / np.sqrt(d.k)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((3, din)).astype(np.float32))
    calls = []
    name_of = "bdmm_q" if quantized else "bdmm"
    real = getattr(ops, name_of)

    def recording(xin, *args):
        calls.append((tuple(xin.shape),))
        return real(xin, *args)

    def refuse(*args):
        raise AssertionError("the fused kernel ran")

    monkeypatch.setattr(ops, name_of, recording)
    monkeypatch.setattr(ops, "monarch_fused_q" if quantized
                        else "monarch_fused", refuse)
    if quantized:
        qc = tquant.quantize_monarch({"L": L, "R": R}, 8)
        y = ops.monarch_mm_q(x, qc["Lq"], qc["Ls"], qc["Rq"], qc["Rs"])
        deq = tquant.dequantize_monarch(qc, d.k, d.p)
        L, R = deq["L"], deq["R"]
    else:
        y = ops.monarch_mm(x, L, R)
    assert [c[0] for c in calls] == [(3, d.k, d.p), (3, d.q, d.k)]
    np.testing.assert_allclose(y.numpy(), monarch_fused_plain(x, L, R).numpy(),
                               **TOL["float32"])


# which branch each package's Monarch dispatch takes (True: fused):
# the reference by its 10 MiB VMEM weight budget at the stored width
# (kernels/ops.py:_dispatch: fp32 4 bytes; int8 1 and int4 0.5 bytes with
# fp32 dequant temporaries and scales), the port by its shared-memory fit
# at any width
BRANCHES = {
    # pair: (reference fp32, int8, int4, port)
    "1024x1024": (True, True, True, False),
    "1024x4096": (True, True, True, False),
    "4096x1024": (True, True, True, False),
    "4096x4096": (True, True, True, False),
    "nemotron_w1": (False, False, False, False),
    "nemotron_w2": (False, False, False, False),
    "codeqwen_w2": (True, False, True, False),
}


@pytest.mark.parametrize("pair", sorted(BRANCHES))
def test_monarch_dispatch_branch_of_each_package(pair):
    """The reference sends the 128-block pairs to its fused kernel (their
    factors are well under its 10 MiB budget) and the port sends them
    staged (a 4-row tile of their 16384-wide intermediate does not fit
    shared memory): a designed difference of the port (ROADMAP.md C).  At
    the feed-forward pairs nemotron goes staged in both, codeqwen w2 fused
    in the reference at fp32 and int4 and staged at int8."""
    din, dout = {**FFN_PAIRS, **NB128_PAIRS}[pair]
    d = _dims(din, dout, 128 if pair in NB128_PAIRS else None)
    k, q = d.k, d.q
    want = BRANCHES[pair]
    got = (ref_fused_fits(d.l_shape, d.r_shape, 4),
           ref_fused_fits(d.l_shape, d.r_shape, 1, 4 * (k + q), 4),
           ref_fused_fits(d.l_shape, d.r_shape, 0.5, 4 * (k + q), 4),
           fused_fits(d.l_shape, d.r_shape))
    assert got == want
