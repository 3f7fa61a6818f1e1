"""Paged-KV span attention on Hopper (``csrc/paged.cu``).

Replaces ``repro/kernels/paged.py:paged_attention_span`` with fp32 or bf16
pages (Pallas ``_paged_attention_span`` / ``_paged_span_kernel`` /
``_span_attend``), and its single-query wrapper ``paged_attention``.

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
"""

from __future__ import annotations

import ctypes
import math

import torch

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
    tiled), unlike the reference's VMEM rule."""
    return query_tile(1, head_dim, page_size) > 0


def paged_attention_span_plain(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, page_table: torch.Tensor,
                               start: torch.Tensor, span_len: torch.Tensor,
                               window: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch, over all pages at once:
    gather every row's pages, mask with -1e30, softmax with the mask
    multiplied in and ``max(l, 1e-30)``, zero the invalid rows."""
    B, S, H, hd = q.shape
    _, pg, KV, _ = k_pages.shape
    MP = page_table.shape[1]
    g = H // KV
    pt = page_table.long()
    kk = k_pages[pt].reshape(B, MP * pg, KV, hd).float()
    vv = v_pages[pt].reshape(B, MP * pg, KV, hd).float()
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


def paged_attention_span(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, page_table: torch.Tensor,
                         start: torch.Tensor, span_len: torch.Tensor,
                         window: int = GLOBAL_WINDOW) -> torch.Tensor:
    """q: (B, S, H, hd) query spans; k/v_pages: (P, page, KV, hd);
    page_table: (B, MP); start, span_len: (B,); window: sliding window
    (``GLOBAL_WINDOW`` = global).  Returns (B, S, H, hd) in q's dtype."""
    B, S, H, hd = q.shape
    _, pg, KV, hd2 = k_pages.shape
    if hd2 != hd or v_pages.shape != k_pages.shape or H % KV:
        raise ValueError(f"bad shapes q{tuple(q.shape)} "
                         f"pages{tuple(k_pages.shape)}")
    window = int(window)
    if q.device.type == "cpu":
        return paged_attention_span_plain(q, k_pages, v_pages, page_table,
                                          start, span_len, window)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (
            k_pages, v_pages, page_table, start, span_len)):
        raise ValueError("paged_attention_span: every tensor must be on one "
                         "CUDA device")
    if k_pages.dtype != v_pages.dtype:
        raise TypeError("paged_attention_span: k and v pages differ in dtype")
    tile = query_tile(S, hd, pg)
    if not tile:
        raise ValueError(f"paged_attention_span: head_dim {hd} x page {pg} "
                         f"does not fit shared memory")
    q = q.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    st = start.to(torch.int32).contiguous()
    sl = span_len.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    lib = _build.library("paged", "paged_span_launch", _ARGTYPES)
    err = lib.paged_span_launch(
        _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
        _build.ptr(pt), _build.ptr(st), _build.ptr(sl), window,
        _build.ptr(out), B, S, H, hd, pg, KV, pt.shape[1], tile,
        _build.dtype_code(q, "paged q"), _build.dtype_code(k_pages, "pages"),
        _build.stream_of(q))
    _build.check(err, "paged_attention_span launch")
    _build.LAUNCHES["paged_attention_span"] += 1
    return out


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor,
                    window: int = GLOBAL_WINDOW) -> torch.Tensor:
    """Single-query decode special case (span of 1 per sequence).

    q: (B, H, hd); lengths: (B,) valid keys per row, current token included
    (the query sits at position ``lengths - 1``).  Returns (B, H, hd)."""
    B = q.shape[0]
    ones = torch.ones((B,), dtype=torch.int32, device=q.device)
    out = paged_attention_span(q[:, None], k_pages, v_pages, page_table,
                               lengths.to(torch.int32) - 1, ones, window)
    return out[:, 0]


__all__ = ["paged_attention", "paged_attention_span",
           "paged_attention_span_plain", "smem_bytes", "query_tile",
           "span_fits", "GLOBAL_WINDOW", "QUERY_TILE"]
