"""Paged-KV span attention on Hopper (``csrc/paged.cu``).

Replaces ``repro/kernels/paged.py:paged_attention_span`` with fp32 or bf16
pages (Pallas ``_paged_attention_span`` / ``_paged_span_kernel`` /
``_span_attend``), with int8 pages and their per-(page, head) fp32 scales
(Pallas ``_paged_attention_span_q`` / ``_paged_span_kernel_q``), and its
single-query wrapper ``paged_attention``.  The int8 instance stages each
page as ``float(v) * scale`` (``core.quant.dequantize_kv_pages``'s one
multiply) into the float kernel's fp32 tile and runs its flash body
unchanged: it is bitwise the float kernel on dequantized pages, needs the
same shared memory, and counts its launches as ``paged_attention_span_q``.

Row ``b``'s query ``i`` sits at global position ``start[b] + i`` and is
valid iff ``i < span_len[b]`` (invalid rows return zeros); it attends key
``t`` iff ``t <= start[b] + i`` and ``start[b] + i - t < window``.  Query
head ``h`` reads KV head ``h // (H // KV)``.  Scores are scaled by
``1/sqrt(hd)``; the softmax runs in fp32 with the reference's -1e30 mask
value, explicit mask multiply and ``max(l, 1e-30)`` normalizer.

Bound on an H100 SXM: bytes — the queries, the K/V rows of every page a
valid query attends, and the output, once each — over 3.35 TB/s; the
4*hd FLOPs per attended (query, key) pair over 67 TFLOP/s fp32 (989
TFLOP/s where queries and pages are all bf16) are far below that at
decode.  The design reads each needed page straight from the pool through
the page table (no gathered copy of the cache in device memory) and skips
pages no valid query attends; one block per (sequence, query head, tile of
``QUERY_TILE`` query rows) re-reads a page once per query head of its KV
group and once per query tile, from L2.  Tiling the queries keeps a
block's shared memory independent of the span, so any span runs here.

``paged_attention_span`` launches the kernel for CUDA tensors and uses the
plain version ``paged_attention_span_plain`` only for CPU tensors.

Under tensor parallelism (B7, ``paged_attention_span_sharded``) each rank
launches the same kernel on its own heads: the grid and the page loop do
not depend on the head count, so the local launch needs no other source.
"""

from __future__ import annotations

import ctypes
import math

from typing import Optional

import torch

from repro_torch.core.quant import dequantize_kv_pages
from repro_torch.kernels import _build
from repro_torch.kernels.monarch import SMEM_BUDGET_BYTES

GLOBAL_WINDOW = 1_000_000_000  # "no window": larger than any context
QUERY_TILE = 64  # query rows one block takes at most


def smem_bytes(rows: int, head_dim: int, page_size: int) -> int:
    """Shared memory one block of ``rows`` query rows needs
    (csrc/paged.cu)."""
    return 4 * (2 * rows * head_dim + page_size * (head_dim + 1)
                + page_size * head_dim + 2 * rows * page_size + 3 * rows)


def query_tile(span: int, head_dim: int, page_size: int) -> int:
    """Query rows per block: ``min(span, QUERY_TILE)``, halved until the
    block fits shared memory; 0 when not even one row fits."""
    t = min(max(span, 1), QUERY_TILE)
    while t and smem_bytes(t, head_dim, page_size) > SMEM_BUDGET_BYTES:
        t //= 2
    return t


def span_fits(head_dim: int, page_size: int) -> bool:
    """Hopper's fit rule for the span kernel: a one-row query tile fits a
    block's shared memory.  The span does not enter it (queries are
    tiled), unlike the reference's VMEM rule, and neither does the page
    width (int8 pages are dequantized into the same fp32 tile)."""
    return query_tile(1, head_dim, page_size) > 0


def paged_attention_span_plain(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, page_table: torch.Tensor,
                               start: torch.Tensor, span_len: torch.Tensor,
                               window: int,
                               k_scales: Optional[torch.Tensor] = None,
                               v_scales: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, over all pages at once:
    gather every row's pages (int8 pages dequantized under their scale
    rows), mask with -1e30, softmax with the mask multiplied in and
    ``max(l, 1e-30)``, zero the invalid rows."""
    B, S, H, hd = q.shape
    _, pg, KV, _ = k_pages.shape
    MP = page_table.shape[1]
    g = H // KV
    pt = page_table.long()
    if k_scales is not None:
        kk = dequantize_kv_pages(k_pages[pt], k_scales[pt])
        vv = dequantize_kv_pages(v_pages[pt], v_scales[pt])
    else:
        kk, vv = k_pages[pt].float(), v_pages[pt].float()
    kk = kk.reshape(B, MP * pg, KV, hd)
    vv = vv.reshape(B, MP * pg, KV, hd)
    qh = q.reshape(B, S, KV, g, hd).float()
    s = torch.einsum("bskgh,btkh->bskgt", qh, kk) / math.sqrt(hd)
    t = torch.arange(MP * pg, device=q.device)[None, None, :]
    rows = torch.arange(S, device=q.device)
    q_pos = start.long()[:, None] + rows[None, :]
    ok = (t <= q_pos[..., None]) & ((q_pos[..., None] - t) < int(window))
    ok = ok[:, :, None, None, :]                              # (B,S,1,1,T)
    s = torch.where(ok, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * ok.float()
    l = p.sum(dim=-1)
    out = torch.einsum("bskgt,btkh->bskgh", p, vv)
    out = out / torch.clamp(l, min=1e-30)[..., None]
    valid = rows[None, :] < span_len.long()[:, None]
    out = torch.where(valid[:, :, None, None, None], out, 0.0)
    return out.reshape(B, S, H, hd).to(q.dtype)


_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
             + [ctypes.c_int] * 10 + [ctypes.c_void_p])
_Q_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]
               + [ctypes.c_int] * 9 + [ctypes.c_void_p])


def paged_attention_span(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, page_table: torch.Tensor,
                         start: torch.Tensor, span_len: torch.Tensor,
                         window: int = GLOBAL_WINDOW,
                         k_scales: Optional[torch.Tensor] = None,
                         v_scales: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """q: (B, S, H, hd) query spans; k/v_pages: (P, page, KV, hd);
    page_table: (B, MP); start, span_len: (B,); window: sliding window
    (``GLOBAL_WINDOW`` = global).  ``k_scales``/``v_scales`` (P, KV) fp32:
    the per-(page, head) scales of int8 pages, which then run the int8
    instance of the kernel.  Returns (B, S, H, hd) in q's dtype."""
    return _span(q, k_pages, v_pages, page_table, start, span_len, window,
                 k_scales, v_scales, "paged_attention_span")


def _span(q, k_pages, v_pages, page_table, start, span_len, window,
          k_scales, v_scales, counter: str) -> torch.Tensor:
    """The span kernel's launch (or plain version, for CPU tensors);
    a launch adds one to ``counter`` (``counter + "_q"`` for int8
    pages)."""
    B, S, H, hd = q.shape
    P, pg, KV, hd2 = k_pages.shape
    if hd2 != hd or v_pages.shape != k_pages.shape or H % KV:
        raise ValueError(f"bad shapes q{tuple(q.shape)} "
                         f"pages{tuple(k_pages.shape)}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    quantized = k_scales is not None
    if quantized and (k_pages.dtype != torch.int8
                      or tuple(k_scales.shape) != (P, KV)
                      or tuple(v_scales.shape) != (P, KV)):
        raise ValueError("scales need int8 pages and (P, KV) scale rows")
    window = int(window)
    if q.device.type == "cpu":
        return paged_attention_span_plain(q, k_pages, v_pages, page_table,
                                          start, span_len, window,
                                          k_scales, v_scales)
    dev = q.device
    scales = (k_scales, v_scales) if quantized else ()
    if dev.type != "cuda" or any(t.device != dev for t in (
            k_pages, v_pages, page_table, start, span_len, *scales)):
        raise ValueError(f"{counter}: every tensor must be on one CUDA "
                         f"device")
    if k_pages.dtype != v_pages.dtype:
        raise TypeError(f"{counter}: k and v pages differ in dtype")
    if quantized and not all(t.dtype == torch.float32 for t in scales):
        raise TypeError(f"{counter}: scales must be float32")
    tile = query_tile(S, hd, pg)
    if not tile:
        raise ValueError(f"{counter}: head_dim {hd} x page {pg} "
                         f"does not fit shared memory")
    q = q.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    st = start.to(torch.int32).contiguous()
    sl = span_len.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    if quantized:
        ksc, vsc = k_scales.contiguous(), v_scales.contiguous()
        lib = _build.library("paged", "paged_span_q_launch", _Q_ARGTYPES)
        err = lib.paged_span_q_launch(
            _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
            _build.ptr(ksc), _build.ptr(vsc), _build.ptr(pt),
            _build.ptr(st), _build.ptr(sl), window, _build.ptr(out), B, S,
            H, hd, pg, KV, pt.shape[1], tile,
            _build.dtype_code(q, "paged q"), _build.stream_of(q))
        _build.check(err, f"{counter}_q launch")
        _build.LAUNCHES[f"{counter}_q"] += 1
        return out
    lib = _build.library("paged", "paged_span_launch", _ARGTYPES)
    err = lib.paged_span_launch(
        _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
        _build.ptr(pt), _build.ptr(st), _build.ptr(sl), window,
        _build.ptr(out), B, S, H, hd, pg, KV, pt.shape[1], tile,
        _build.dtype_code(q, "paged q"), _build.dtype_code(k_pages, "pages"),
        _build.stream_of(q))
    _build.check(err, f"{counter} launch")
    _build.LAUNCHES[counter] += 1
    return out


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor,
                    window: int = GLOBAL_WINDOW,
                    k_scales: Optional[torch.Tensor] = None,
                    v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-query decode special case (span of 1 per sequence).

    q: (B, H, hd); lengths: (B,) valid keys per row, current token included
    (the query sits at position ``lengths - 1``); scales as in
    :func:`paged_attention_span`.  Returns (B, H, hd)."""
    return _one_query(paged_attention_span, q, k_pages, v_pages, page_table,
                      lengths, window, k_scales=k_scales, v_scales=v_scales)


def _one_query(span, q, k_pages, v_pages, page_table, lengths, window,
               **kw) -> torch.Tensor:
    """``span`` (a span-attention function) over one query a row, the
    query at position ``lengths - 1``: (B, H, hd) -> (B, H, hd)."""
    B = q.shape[0]
    ones = torch.ones((B,), dtype=torch.int32, device=q.device)
    out = span(q[:, None], k_pages, v_pages, page_table,
               lengths.to(torch.int32) - 1, ones, window, **kw)
    return out[:, 0]


# ---------------------------------------------------------------------------
# B7: the span kernel under tensor parallelism
# ---------------------------------------------------------------------------


def _check_shard(q, k_pages, mesh, n_heads: int, n_kv_heads: int) -> None:
    tp = mesh.model
    H, KV = q.shape[2], k_pages.shape[2]
    if H * tp != n_heads or KV * tp != n_kv_heads:
        raise ValueError(
            f"local heads {H}/KV {KV} x tp={tp} must be the model's "
            f"{n_heads}/{n_kv_heads} heads: the pool is not split on the "
            f"'model' axis")


def paged_attention_span_sharded(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 page_table: torch.Tensor,
                                 start: torch.Tensor, span_len: torch.Tensor,
                                 window: int, mesh, *, n_heads: int,
                                 n_kv_heads: int,
                                 k_scales: Optional[torch.Tensor] = None,
                                 v_scales: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Span attention of one rank under tensor parallelism (B7; replaces
    ``repro/kernels/paged.py:paged_attention_span_sharded``).

    The reference ``shard_map``s the unchanged Pallas span kernel over the
    ``"model"`` axis: each shard runs it on its ``H / tp`` query heads and
    its ``KV / tp`` KV heads of the pool, with the whole page table, and
    the outputs concatenate on the head axis with no collective (heads
    never mix).  In the port every rank is a process that already holds
    its slice, so B7 is the span kernel (``csrc/paged.cu``, float or int8
    instance) launched on LOCAL shapes: q ``(B, S, H / tp, hd)``, pages
    ``(P, page, KV / tp, hd)``, scales ``(P, KV / tp)``; the grid is
    ``(B, H / tp, query tiles)``.  ``n_heads``/``n_kv_heads`` are the
    model's global counts: shapes that are not this rank's ``1 / tp`` of
    them raise, as the reference's divisibility check does.  Launches
    count as ``paged_attention_span_sharded`` (``..._q`` for int8 pages);
    a CPU tensor runs ``paged_attention_span_plain`` on the local
    slices.  Returns this rank's heads, ``(B, S, H / tp, hd)``."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    _check_shard(q, k_pages, mesh, n_heads, n_kv_heads)
    return _span(q, k_pages, v_pages, page_table, start, span_len, window,
                 k_scales, v_scales, "paged_attention_span_sharded")


def paged_attention_sharded(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, page_table: torch.Tensor,
                            lengths: torch.Tensor, window: int, mesh, *,
                            n_heads: int, n_kv_heads: int,
                            k_scales: Optional[torch.Tensor] = None,
                            v_scales: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Single-query decode under tensor parallelism (span of 1 per row),
    :func:`paged_attention` over :func:`paged_attention_span_sharded`.
    q: (B, H / tp, hd) -> (B, H / tp, hd)."""
    return _one_query(paged_attention_span_sharded, q, k_pages, v_pages,
                      page_table, lengths, window, mesh=mesh,
                      n_heads=n_heads, n_kv_heads=n_kv_heads,
                      k_scales=k_scales, v_scales=v_scales)


__all__ = ["paged_attention", "paged_attention_span",
           "paged_attention_span_plain", "paged_attention_sharded",
           "paged_attention_span_sharded", "smem_bytes", "query_tile",
           "span_fits", "GLOBAL_WINDOW", "QUERY_TILE"]
