"""The port's paged span attention against the JAX reference: the port's
``paged_attention_span``/``paged_attention`` (their plain version, on the
CPU) against the Pallas kernel (interpret mode on the CPU), and the port's
oracle against the reference's oracle.

Cases cover GQA (H=4, KV=2), a finite window, pages fully masked for some
queries, rows with ``span_len < S`` (which must be zero), a span-0 row,
and bf16 pages.  fp32 outputs agree at 2e-5 (both sides take an fp32
softmax, in other summation orders); a bf16 output at 2e-2 (one bf16
rounding apart).

The kernel's launch geometry (``span_geometry``: query tiles and splits
of the page axis) and its split-and-merge arithmetic
(``paged_attention_span_split_plain``) are checked here too: the splits
of a tile cover the pages its valid queries attend exactly once, and the
merged partials agree with the reference kernel, all-masked splits and
invalid rows included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.paged import paged_attention as jpaged_attention
from repro.kernels.paged import paged_attention_span as jpaged_span
from repro.kernels.ref import paged_attention_span_ref as jspan_ref
from repro_torch.kernels import launches, ops
from repro_torch.kernels import paged as tpaged
from repro_torch.kernels import ref as tref
from repro_torch.kernels.paged import (GLOBAL_WINDOW, paged_attention,
                                       paged_attention_span,
                                       paged_attention_span_plain,
                                       paged_attention_span_split_plain,
                                       span_geometry, split_pages)

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _fixture(B=3, H=4, KV=2, hd=16, pg=4, MP=5, seed=0):
    """Pages, a scrambled page table, and a query generator (GQA 4/2)."""
    rng = np.random.default_rng(seed)
    P = 1 + B * MP
    kp = rng.standard_normal((P, pg, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((P, pg, KV, hd)).astype(np.float32)
    pt = rng.permutation(np.arange(1, P)).reshape(B, MP).astype(np.int32)
    return rng, kp, vp, pt


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


@pytest.mark.parametrize("window", [GLOBAL_WINDOW, 5])
def test_single_query_matches_reference(window):
    rng, kp, vp, pt = _fixture()
    q = rng.standard_normal((3, 4, 16)).astype(np.float32)
    lengths = np.asarray([1, 7, 20], np.int32)
    (jq, jk, jv, jt, jl), (tq, tk, tv, tt, tl) = _both(q, kp, vp, pt, lengths)
    want = jpaged_attention(jq, jk, jv, jt, jl, jnp.asarray(window, jnp.int32))
    got = paged_attention(tq, tk, tv, tt, tl, window)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


# row 0: a span of 5 from position 2 straddles the page boundary at 4;
# row 1: span == page size from an aligned start, 2 padding rows;
# row 2: a span-1 decode deep into its pages
SPANS = {"straddle": (6, [2, 4, 17], [5, 4, 1]),
         "full_and_zero_start": (8, [0, 0, 8], [8, 3, 8]),
         "inert_row": (4, [3, 0, 12], [2, 0, 4])}


@pytest.mark.parametrize("window", [GLOBAL_WINDOW, 3])
@pytest.mark.parametrize("case", sorted(SPANS))
def test_span_matches_reference_kernel(case, window):
    S, start, span = SPANS[case]
    rng, kp, vp, pt = _fixture(seed=3)
    q = rng.standard_normal((3, S, 4, 16)).astype(np.float32)
    st, sl = np.asarray(start, np.int32), np.asarray(span, np.int32)
    (jq, jk, jv, jt, js, jl), (tq, tk, tv, tt, ts, tl) = _both(
        q, kp, vp, pt, st, sl)
    want = jpaged_span(jq, jk, jv, jt, js, jl, jnp.asarray(window, jnp.int32))
    got = paged_attention_span(tq, tk, tv, tt, ts, tl, window)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    # padding rows (i >= span_len) are zeros, not garbage
    arr = got.numpy()
    for b in range(3):
        assert (arr[b, span[b]:] == 0).all()
    # the port's oracle agrees with the reference's oracle
    np.testing.assert_allclose(
        tref.paged_attention_span_ref(tq, tk, tv, tt, ts, tl, window).numpy(),
        _np(jspan_ref(jq, jk, jv, jt, js, jl, window)), **F32)


def test_fully_masked_pages_leave_the_result_unchanged():
    """With window 3 a query at position 17 sees keys 15-17 (pages 3 and 4
    of its row); pages 0-2 are fully masked for it.  Scrambling their
    contents must not move the output (the explicit mask multiply), in the
    port as in the reference."""
    rng, kp, vp, pt = _fixture(seed=5)
    q = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    st = np.asarray([17, 17, 17], np.int32)
    sl = np.ones(3, np.int32)
    (tq, tk, tv, tt, ts, tl) = _both(q, kp, vp, pt, st, sl)[1]
    base = paged_attention_span(tq, tk, tv, tt, ts, tl, 3)
    masked = pt[:, :3].reshape(-1)
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[masked] = 1e3
    tv2[masked] = -1e3
    moved = paged_attention_span(tq, tk2, tv2, tt, ts, tl, 3)
    np.testing.assert_array_equal(base.numpy(), moved.numpy())
    jq, jk, jv, jt, js, jl = _both(q, kp, vp, pt, st, sl)[0]
    np.testing.assert_allclose(
        base.numpy(), _np(jpaged_span(jq, jk, jv, jt, js, jl,
                                      jnp.asarray(3, jnp.int32))), **F32)


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [GLOBAL_WINDOW, 3])
def test_bf16_pages_match_reference(q_dtype, window):
    """bf16 pages (the published config's pool): the same bf16 values go
    to both packages; an fp32 query keeps the fp32 tolerance."""
    S, start, span = SPANS["straddle"]
    rng, kp, vp, pt = _fixture(seed=7)
    q = rng.standard_normal((3, S, 4, 16)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[q_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[q_dtype]
    st, sl = np.asarray(start, np.int32), np.asarray(span, np.int32)
    (jq, jk, jv, jt, js, jl), (tq, tk, tv, tt, ts, tl) = _both(
        q, kp, vp, pt, st, sl)
    want = jpaged_span(jq.astype(jdt), jk.astype(jnp.bfloat16),
                       jv.astype(jnp.bfloat16), jt, js, jl,
                       jnp.asarray(window, jnp.int32))
    got = paged_attention_span(tq.to(tdt), tk.to(torch.bfloat16),
                               tv.to(torch.bfloat16), tt, ts, tl, window)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if q_dtype == "float32" else BF16))


def test_plain_version_matches_oracle_and_counts_no_launch():
    S, start, span = SPANS["straddle"]
    rng, kp, vp, pt = _fixture(seed=9)
    q = rng.standard_normal((3, S, 4, 16)).astype(np.float32)
    args = _both(q, kp, vp, pt, np.asarray(start, np.int32),
                 np.asarray(span, np.int32))[1]
    before = launches()
    got = paged_attention_span_plain(*args, 5)
    assert launches() == before
    np.testing.assert_allclose(
        got.numpy(), tref.paged_attention_span_ref(*args, 5).numpy(), **F32)


def test_paged_dispatch_agrees_with_reference_where_shapes_fit():
    """Same decision (and reasons) as the reference where both kernels
    fit; the port's span kernel tiles its queries, so it also takes the
    long spans the reference's 10 MiB VMEM rule sends to the dense path,
    and only a page too big for one query row's block is rejected."""
    assert ops.PAGED_DISPATCH_REASONS == jops.PAGED_DISPATCH_REASONS
    cases = [
        (1, 16, 64, 16, 16, 2.0, {}),
        (64, 16, 64, 16, 16, 2.0, {}),
        (512, 16, 64, 16, 16, 2.0, {}),
        (8, 4, 32, 4, 2, 4.0, {"paged_kernel": False}),
        (8, 4, 32, 4, 2, 4.0, {"softcap": True}),
    ]
    for span, h, hd, pg, kv, kvb, kw in cases:
        assert ops.paged_dispatch(hd, pg, **kw) == \
            jops.paged_dispatch(span, h, hd, pg, kv, kvb, **kw)
    assert jops.paged_dispatch(2048, 16, 64, 16, 16, 2.0) == "vmem"
    assert ops.paged_dispatch(64, 16) == "kernel"
    assert ops.paged_dispatch(256, 128) == "vmem"


@pytest.mark.parametrize("span,hd,pg,tile", [
    (1, 64, 16, 1), (20, 64, 16, 20), (64, 64, 16, 64), (512, 64, 16, 64),
    (4096, 64, 16, 64), (512, 256, 64, 32), (8, 256, 128, 0)])
def test_query_tile_fits_shared_memory(span, hd, pg, tile):
    """A block takes at most QUERY_TILE query rows, fewer where its
    working set would spill shared memory; the span kernel's shared-memory
    formula stays within the Hopper budget for every tile it picks."""
    from repro_torch.kernels.monarch import SMEM_BUDGET_BYTES
    from repro_torch.kernels.paged import QUERY_TILE, query_tile, smem_bytes

    got = query_tile(span, hd, pg)
    assert got == tile <= QUERY_TILE
    if got:
        assert smem_bytes(got, hd, pg) <= SMEM_BUDGET_BYTES
        assert (got == min(span, QUERY_TILE)
                or smem_bytes(2 * got, hd, pg) > SMEM_BUDGET_BYTES)


# ---------------------------------------------------------------------------
# the launch geometry and the split-and-merge arithmetic
# ---------------------------------------------------------------------------

# (S, starts, spans) over 64 pages of 16 a row: the chip_smoke call sets
# (decode, a 64-row prefill with a span-0 row, a 512-row span of 8 tiles)
GEOMETRY_CASES = {
    "decode": (1, [0, 15, 16, 100, 511, 700, 1000, 1023], [1] * 8),
    "prefill": (64, [0, 64, 128, 300, 500, 900, 960, 0],
                [64, 64, 30, 64, 1, 64, 64, 0]),
    "prefill512": (512, [0, 512, 100, 0, 300, 500, 0, 700],
                   [512, 512, 200, 65, 1, 300, 0, 128]),
}


@pytest.mark.parametrize("pps", [None, 1, 3, 64])
@pytest.mark.parametrize("window", [GLOBAL_WINDOW, 48])
@pytest.mark.parametrize("case", sorted(GEOMETRY_CASES))
def test_splits_cover_each_tiles_pages_exactly_once(case, window, pps):
    """Every tile's live splits, cut to the pages its valid queries attend,
    cover those pages once each; the pages are exactly the ones the mask
    admits a key of; a tile with no valid row (span 0) has none."""
    S, starts, spans = GEOMETRY_CASES[case]
    hd, pg, MP = 64, 16, 64
    g = span_geometry(S, hd, pg, MP, pps)
    assert g.blocks == g.n_tiles * g.n_splits
    assert g.n_tiles * g.tile >= S > (g.n_tiles - 1) * g.tile
    assert g.n_splits * g.pps >= MP > (g.n_splits - 1) * g.pps
    for start, span in zip(starts, spans):
        for tile in range(g.n_tiles):
            i0 = tile * g.tile
            rows = min(g.tile, S - i0)
            nval, first, last = split_pages(start, span, i0, rows, window,
                                            pg, MP)
            # the pages holding a key some valid row of the tile attends
            want = sorted({t // pg for i in range(nval)
                           for t in range(MP * pg)
                           if t <= start + i0 + i < t + window})
            assert list(range(first, last + 1)) == want
            covered = []
            for s in range(g.n_splits):
                lo, hi = max(first, s * g.pps), min(last, (s + 1) * g.pps - 1)
                covered += list(range(lo, hi + 1))
            assert covered == want
            if span <= i0:
                assert nval == 0 and not covered


def test_span_geometry_is_built_from_shapes_only():
    """The launch takes no start, span or head count: the grid is known on
    the host without reading the card, and a rank's launch on its heads
    (B7) splits each head as the launch on all heads does."""
    g = span_geometry(1, 64, 16, 64)
    assert (g.tile, g.pps, g.n_splits, g.n_tiles, g.stages) == (1, 4, 16, 1, 2)
    assert g.workspace_floats == 16 * (64 + 2)
    g = span_geometry(64, 64, 16, 64)
    assert (g.tile, g.pps, g.n_splits, g.n_tiles) == (64, 8, 8, 1)
    g = span_geometry(512, 64, 16, 64)
    assert (g.tile, g.pps, g.n_splits, g.n_tiles) == (64, 16, 4, 8)
    for S in (1, 7, 64, 300, 512, 4096):
        g = span_geometry(S, 64, 16, 512)
        assert g.workspace_floats <= tpaged.SPLIT_ROWS * (64 + 2)
    assert span_geometry(64, 64, 16, 64, pps=64).n_splits == 1
    assert span_geometry(64, 64, 16, 64, pps=64).workspace_floats == 0
    assert span_geometry(8, 256, 128, 4) is None
    # the launch arguments: shapes, then the geometry, in csrc/paged.cu's
    # Args order; the head counts enter only as themselves
    g1, a1 = tpaged._launch_args(8, 1, 16, 64, 16, 16, 64, GLOBAL_WINDOW,
                                 torch.bfloat16, 1)
    g2, a2 = tpaged._launch_args(8, 1, 8, 64, 16, 8, 64, GLOBAL_WINDOW,
                                 torch.bfloat16, tpaged.INT8_CODE)
    assert g1 == g2 == span_geometry(1, 64, 16, 64)
    assert list(a1) == [8, 1, 16, 64, 16, 16, 64, GLOBAL_WINDOW, 1, 4, 16, 1,
                        2, 1, 1]
    assert list(a2)[:2] + list(a2)[3:5] + list(a2)[6:14] == \
        list(a1)[:2] + list(a1)[3:5] + list(a1)[6:14]
    assert (a2[2], a2[5], a2[14]) == (8, 8, tpaged.INT8_CODE)


def test_workspace_is_cached_per_device_and_grows_only():
    dev = torch.device("cpu")
    saved = dict(tpaged._WORKSPACE)
    try:
        tpaged._WORKSPACE.clear()
        ws, tk = tpaged._workspace(dev, 100, 5)
        assert ws.dtype == torch.float32 and ws.numel() == 100
        assert tk.dtype == torch.int32 and (tk == 0).all()
        assert tpaged._workspace(dev, 60, 3) == (ws, tk)
        ws2, tk2 = tpaged._workspace(dev, 200, 5)
        assert ws2.numel() == 200 and tk2 is tk
        ws3, tk3 = tpaged._workspace(dev, 10, 9)
        assert ws3 is ws2 and tk3.numel() == 9 and (tk3 == 0).all()
    finally:
        tpaged._WORKSPACE.clear()
        tpaged._WORKSPACE.update(saved)


# deeper positions than SPANS over 6 pages of 4, so that a tile's early
# splits are fully masked for its later rows under window 3
SPLIT_SPANS = {**SPANS, "decode": (1, [0, 9, 23], [1, 1, 1]),
               "deep": (8, [12, 0, 5], [8, 8, 2])}


@pytest.mark.parametrize("pps", [None, 1, 2, 5])
@pytest.mark.parametrize("window", [GLOBAL_WINDOW, 3])
@pytest.mark.parametrize("case", sorted(SPLIT_SPANS))
def test_split_merge_matches_reference_kernel(case, window, pps):
    """The kernel's split and merge (its plain mirror) against the Pallas
    span kernel: partials of each split's pages merged in split order give
    the reference's output; a split whose keys are all masked for a row
    (m = -1e30, l = 0) leaves the merge unchanged, invalid rows are 0."""
    S, start, span = SPLIT_SPANS[case]
    rng, kp, vp, pt = _fixture(seed=11, MP=6)
    q = rng.standard_normal((3, S, 4, 16)).astype(np.float32)
    st, sl = np.asarray(start, np.int32), np.asarray(span, np.int32)
    (jq, jk, jv, jt, js, jl), targs = _both(q, kp, vp, pt, st, sl)
    want = jpaged_span(jq, jk, jv, jt, js, jl, jnp.asarray(window, jnp.int32))
    got = paged_attention_span_split_plain(*targs, window, pps=pps)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    for b in range(3):
        assert (got.numpy()[b, span[b]:] == 0).all()
