"""The port's paged span attention against the JAX reference: the port's
``paged_attention_span``/``paged_attention`` (their plain version, on the
CPU) against the Pallas kernel (interpret mode on the CPU), and the port's
oracle against the reference's oracle.

Cases cover GQA (H=4, KV=2), a finite window, pages fully masked for some
queries, rows with ``span_len < S`` (which must be zero), a span-0 row,
and bf16 pages.  fp32 outputs agree at 2e-5 (both sides take an fp32
softmax, in other summation orders); a bf16 output at 2e-2 (one bf16
rounding apart)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.paged import paged_attention as jpaged_attention
from repro.kernels.paged import paged_attention_span as jpaged_span
from repro.kernels.ref import paged_attention_span_ref as jspan_ref
from repro_torch.kernels import launches, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.paged import (GLOBAL_WINDOW, paged_attention,
                                       paged_attention_span,
                                       paged_attention_span_plain)

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
