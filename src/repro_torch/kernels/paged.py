"""Paged-KV span attention on Hopper (``csrc/paged.cu``).

Replaces ``repro/kernels/paged.py:paged_attention_span`` with fp32 or bf16
pages (Pallas ``_paged_attention_span`` / ``_paged_span_kernel`` /
``_span_attend``), with int8 pages and their per-(page, head) fp32 scales
(Pallas ``_paged_attention_span_q`` / ``_paged_span_kernel_q``), and its
single-query wrapper ``paged_attention``.  Pages are staged as stored and
widened where they are used; the int8 instance dequantizes each value as
``float(v) * scale`` (``core.quant.dequantize_kv_pages``'s one multiply)
and runs the float instance's flash body unchanged: it is bitwise the
float kernel on dequantized pages, launches the same geometry, and counts
its launches as ``paged_attention_span_q``.

Row ``b``'s query ``i`` sits at global position ``start[b] + i`` and is
valid iff ``i < span_len[b]`` (invalid rows return zeros); it attends key
``t`` iff ``t <= start[b] + i`` and ``start[b] + i - t < window``.  Query
head ``h`` reads KV head ``h // (H // KV)``.  Scores are scaled by
``1/sqrt(hd)``; the softmax runs in fp32 with the reference's -1e30 mask
value, explicit mask multiply and ``max(l, 1e-30)`` normalizer.

The grid is (query tiles x splits, H, B): a block owns one (sequence,
query head, tile of up to ``QUERY_TILE`` query rows) and one split of the
page axis, ``pps`` consecutive absolute pages (flash-decoding).  It
intersects its split with the pages the tile's valid queries attend,
computed on the card from ``start``/``span_len``/``window``, and returns
at once when they do not meet.  Where a tile has more than one non-empty
split, each writes its fp32 (m, l, acc) to a workspace and the last to
finish merges them in split order in the same launch (a ticket a tile,
reset by the merging block), so the result is the same on every run.
:func:`span_geometry` sizes all of it from ``(S, hd, pg, MP)`` alone:
the grid never reads the device (the engine's one host sync a step
stays one), and never depends on H or KV, so B7's launch on a rank's
heads computes each head as B3's launch on all heads does.

Bound on an H100 SXM: bytes -- the queries, the K/V rows of every page a
valid query attends, and the output, once each -- over 3.35 TB/s; the
4*hd FLOPs per attended (query, key) pair over 67 TFLOP/s fp32 (989
TFLOP/s where queries and pages are all bf16) are far below that at
decode.  The design reads each needed page straight from the pool
through the page table (no gathered copy of the cache in device memory),
one page ahead of the compute with ``cp.async``, and skips pages no
valid query attends.  Unsplit, a decode launch was one block a (row,
head) walking up to 64 pages in series, the latency of 64 dependent page
rounds; split, no block walks more than ``pps`` pages.  Tiling the
queries keeps a block's shared memory independent of the span.

``paged_attention_span`` launches the kernel for CUDA tensors and uses the
plain version ``paged_attention_span_plain`` only for CPU tensors;
``paged_attention_span_split_plain`` repeats the split-and-merge
arithmetic in plain PyTorch for the tests and is never on a served path.

Under tensor parallelism (B7, ``paged_attention_span_sharded``) each rank
launches the same kernel on its own heads.
"""

from __future__ import annotations

import ctypes
import functools
import math

from typing import NamedTuple, Optional

import torch

from repro_torch.core.quant import dequantize_kv_pages
from repro_torch.kernels import _build
from repro_torch.kernels.monarch import SMEM_BUDGET_BYTES

GLOBAL_WINDOW = 1_000_000_000  # "no window": larger than any context
QUERY_TILE = 64  # query rows one block takes at most
# pages a split: for a one-row tile (decode), and for a tile of more rows,
# the fastest of the counts chip_smoke.py's span_geometry phase times on
# the H100 (PERF.md)
PAGES_PER_SPLIT = 4
TILE_PAGES_PER_SPLIT = 8
# at most SPLIT_ROWS / S splits of an S-row span, so that the workspace of
# a (sequence, head) stays within SPLIT_ROWS * (hd + 2) floats
SPLIT_ROWS = 2048
INT8_CODE = 2  # int8 pages (csrc/paged.cu: DT_I8)


def _r16(n: int) -> int:
    return (n + 15) & ~15


def smem_bytes(rows: int, head_dim: int, page_size: int,
               stages: Optional[int] = None) -> int:
    """Shared memory one block of ``rows`` query rows needs over fp32
    pages, the most of every page dtype (csrc/paged.cu: layout): q, acc,
    scores, m/l/alpha and ``stages`` buffers of a page's K and V rows
    with their scales (default: two buffers where they fit a one-row
    block)."""
    if stages is None:
        stages = _stages(head_dim, page_size)
    hdp = (head_dim + 3) & ~3
    rawst = _r16(4 * hdp)
    rawst += 16 * ((rawst // 16) % 2 == 0)
    return (_r16(4 * rows * hdp) + _r16(4 * rows * head_dim)
            + _r16(4 * rows * ((page_size + 3) & ~3)) + _r16(12 * rows)
            + stages * (16 + 2 * page_size * rawst))


def _stages(head_dim: int, page_size: int) -> int:
    """2: the next page is copied while this one is used; 1: where two
    buffers do not fit even a one-row block, one page at a time."""
    return 2 if smem_bytes(1, head_dim, page_size, 2) <= SMEM_BUDGET_BYTES \
        else 1


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
    width (the rule sizes fp32 pages, which need the most)."""
    return query_tile(1, head_dim, page_size) > 0


class SpanGeometry(NamedTuple):
    """One launch of the span kernel, per (sequence, query head): the grid
    is ``blocks`` x H x B."""
    tile: int              # query rows a block
    pps: int               # pages a split
    n_splits: int          # splits of the page axis
    blocks: int            # n_tiles * n_splits
    workspace_floats: int  # fp32 partials (0: unsplit, no workspace)
    n_tiles: int
    stages: int            # see _stages


@functools.lru_cache(maxsize=4096)
def span_geometry(S: int, hd: int, pg: int, MP: int,
                  pps: Optional[int] = None) -> Optional[SpanGeometry]:
    """The launch for a span of ``S`` queries, head dim ``hd``, pages of
    ``pg`` over a table of ``MP`` pages a row, or None when not even a
    one-row tile fits.  Shapes only: no start, span or head count enters.
    ``pps`` replaces the pages a split (to compare launches; ``MP`` gives
    one split); the wrappers never pass it."""
    tile = query_tile(S, hd, pg)
    if not tile:
        return None
    n_tiles = -(-max(S, 1) // tile)
    if pps is None:
        most = max(1, SPLIT_ROWS // (n_tiles * tile))
        pps = max(PAGES_PER_SPLIT if tile == 1 else TILE_PAGES_PER_SPLIT,
                  -(-MP // most))
    pps = max(1, int(pps))
    n_splits = max(1, -(-MP // pps))
    ws = n_tiles * n_splits * tile * (hd + 2) if n_splits > 1 else 0
    return SpanGeometry(tile, pps, n_splits, n_tiles * n_splits, ws, n_tiles,
                        _stages(hd, pg))


def split_pages(start: int, span_len: int, i0: int, rows: int, window: int,
                pg: int, MP: int) -> tuple[int, int, int]:
    """A tile's valid rows and the pages they attend, as a block computes
    them (csrc/paged.cu): ``(nval, first, last)`` for the tile's rows
    ``i0 .. i0 + rows - 1``; ``first > last`` when no page is attended."""
    nval = max(0, min(rows, span_len - i0))
    if nval == 0:
        return 0, 0, -1
    st = start + i0
    lo = st - window + 1
    first = lo // pg if lo > 0 else 0
    return nval, first, min((st + nval - 1) // pg, MP - 1)


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
    s, okf, vv = _masked_scores(q, k_pages, v_pages, page_table, start,
                                window, k_scales, v_scales)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * okf
    l = p.sum(dim=-1)
    out = torch.einsum("bskgt,btkh->bskgh", p, vv)
    out = out / torch.clamp(l, min=1e-30)[..., None]
    rows = torch.arange(S, device=q.device)
    valid = rows[None, :] < span_len.long()[:, None]
    out = torch.where(valid[:, :, None, None, None], out, 0.0)
    return out.reshape(B, S, H, hd).to(q.dtype)


def _masked_scores(q, k_pages, v_pages, page_table, start, window,
                   k_scales, v_scales):
    """Every row's pages gathered (int8 pages dequantized under their
    scale rows): the scores (B, S, KV, g, MP * pg) scaled by 1/sqrt(hd) and
    masked with -1e30, the mask (B, S, 1, 1, MP * pg) as 1.0 / 0.0, and
    the values (B, MP * pg, KV, hd), all fp32."""
    B, S, H, hd = q.shape
    _, pg, KV, _ = k_pages.shape
    MP = page_table.shape[1]
    pt = page_table.long()
    if k_scales is not None:
        kk = dequantize_kv_pages(k_pages[pt], k_scales[pt])
        vv = dequantize_kv_pages(v_pages[pt], v_scales[pt])
    else:
        kk, vv = k_pages[pt].float(), v_pages[pt].float()
    kk = kk.reshape(B, MP * pg, KV, hd)
    vv = vv.reshape(B, MP * pg, KV, hd)
    qh = q.reshape(B, S, KV, H // KV, hd).float()
    s = torch.einsum("bskgh,btkh->bskgt", qh, kk) / math.sqrt(hd)
    t = torch.arange(MP * pg, device=q.device)[None, None, :]
    q_pos = start.long()[:, None] + torch.arange(S, device=q.device)[None, :]
    ok = (t <= q_pos[..., None]) & ((q_pos[..., None] - t) < int(window))
    ok = ok[:, :, None, None, :]                              # (B,S,1,1,T)
    s = torch.where(ok, s, torch.full_like(s, -1e30))
    return s, ok.float(), vv


def paged_attention_span_split_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                     v_pages: torch.Tensor,
                                     page_table: torch.Tensor,
                                     start: torch.Tensor,
                                     span_len: torch.Tensor, window: int,
                                     k_scales: Optional[torch.Tensor] = None,
                                     v_scales: Optional[torch.Tensor] = None,
                                     pps: Optional[int] = None
                                     ) -> torch.Tensor:
    """The kernel's split and merge in plain PyTorch, for the tests (never
    on a served path): each tile of :func:`span_geometry` (``pps`` as
    there) and each split that meets its pages gives a partial m_s (the
    max of its masked scores, -1e30 where all are masked), l_s and acc_s;
    they merge in split order as m* = max m_s, l = sum l_s exp(m_s - m*),
    acc = sum acc_s exp(m_s - m*), out = acc / max(l, 1e-30); a tile with
    one such split takes it as it is, and invalid rows are zeros."""
    B, S, H, hd = q.shape
    _, pg, KV, _ = k_pages.shape
    MP = page_table.shape[1]
    geo = span_geometry(S, hd, pg, MP, pps)
    s, okf, vv = _masked_scores(q, k_pages, v_pages, page_table, start,
                                window, k_scales, v_scales)
    out = torch.zeros(B, S, KV, H // KV, hd, device=q.device)
    for b in range(B):
        for tile in range(geo.n_tiles):
            i0 = tile * geo.tile
            nval, first, last = split_pages(
                int(start[b]), int(span_len[b]), i0, min(geo.tile, S - i0),
                int(window), pg, MP)
            if first > last:
                continue
            rows = slice(i0, i0 + nval)
            parts = []
            for sp in range(first // geo.pps, last // geo.pps + 1):
                keys = slice(max(first, sp * geo.pps) * pg,
                             (min(last, sp * geo.pps + geo.pps - 1) + 1) * pg)
                ss = s[b, rows, ..., keys]                   # (n, KV, g, T)
                m_s = ss.amax(dim=-1)
                p = torch.exp(ss - m_s[..., None]) * okf[b, rows, ..., keys]
                parts.append((m_s, p.sum(dim=-1), torch.einsum(
                    "skgt,tkh->skgh", p, vv[b, keys])))
            m_star = torch.stack([m_s for m_s, _, _ in parts]).amax(dim=0)
            l = torch.zeros_like(m_star)
            acc = torch.zeros_like(parts[0][2])
            for m_s, l_s, acc_s in parts:
                w = torch.exp(m_s - m_star)
                l = l + l_s * w
                acc = acc + acc_s * w[..., None]
            out[b, rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, S, H, hd).to(q.dtype)


_ARGTYPES = [ctypes.c_void_p] * 11
_Q_ARGTYPES = [ctypes.c_void_p] * 13


@functools.lru_cache(maxsize=4096)
def _launch_args(B: int, S: int, H: int, hd: int, pg: int, KV: int, MP: int,
                 window: int, q_dtype: torch.dtype, kv_code: int,
                 pps: Optional[int] = None) -> tuple[SpanGeometry,
                                                     ctypes.Array]:
    """The geometry and the C entry points' ``args`` (csrc/paged.cu: Args)
    of one launch, cached: at decode the wrapper's host time is as long as
    the launch.  ``kv_code``: the pages' dtype code, ``INT8_CODE`` for
    int8 pages; ``pps`` as in :func:`span_geometry`."""
    g = span_geometry(S, hd, pg, MP, pps)
    if g is None:
        raise ValueError(f"paged_attention_span: head_dim {hd} x page {pg} "
                         f"does not fit shared memory")
    args = (ctypes.c_int * 15)(
        B, S, H, hd, pg, KV, MP, window, g.tile, g.pps, g.n_splits,
        g.n_tiles, g.stages, _build.dtype_code_of(q_dtype, "paged q"),
        kv_code)
    return g, args


# device index -> (fp32 workspace, int32 tickets), grown to the largest
# launch so far and reused: launches on one stream run one after another,
# so a launch never meets another's partials, and each merging block resets
# its ticket.  Two streams on one device would need one pair each.  A
# growth drops the old pair: a CUDA graph that launches on it holds it
# (serving/step_graphs.py keeps :func:`workspaces` with each graph), and
# no pair grows while a graph is captured.
_WORKSPACE: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, floats: int,
               tickets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The device's workspace of at least ``floats`` fp32 values and its
    zeroed tickets, at least ``tickets`` of them."""
    key = device.index if device.index is not None else -1
    ws, tk = _WORKSPACE.get(key, (None, None))
    grow_ws = ws is None or ws.numel() < floats
    grow_tk = tk is None or tk.numel() < tickets
    if ((grow_ws or grow_tk) and device.type == "cuda"
            and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError(
            "paged_attention_span: the span workspace would grow inside a "
            "CUDA graph capture; size it first (reserve_workspace)")
    if grow_ws:
        ws = torch.empty(floats, dtype=torch.float32, device=device)
    if grow_tk:
        tk = torch.zeros(tickets, dtype=torch.int32, device=device)
    _WORKSPACE[key] = (ws, tk)
    return ws, tk


def workspaces() -> tuple[torch.Tensor, ...]:
    """Every device's current workspace and tickets: what a CUDA graph
    captured now launches on, and must keep alive."""
    return tuple(t for pair in _WORKSPACE.values() for t in pair)


def span_workspace_size(B: int, H: int, hd: int, pg: int, MP: int,
                        spans) -> tuple[int, int]:
    """The workspace floats and tickets that launches at every span of
    ``spans`` need over B rows of H heads (0, 0 where none splits): the
    most of ``B * H * workspace_floats`` and ``B * H * n_tiles`` over
    their geometries."""
    floats = tickets = 0
    for S in spans:
        g = span_geometry(S, hd, pg, MP)
        if g is not None and g.n_splits > 1:
            floats = max(floats, B * H * g.workspace_floats)
            tickets = max(tickets, B * H * g.n_tiles)
    return floats, tickets


def reserve_workspace(device: torch.device, B: int, H: int, hd: int,
                      pg: int, MP: int, spans) -> tuple[int, int]:
    """Size the device's workspace and tickets once for launches at every
    span of ``spans`` (:func:`span_workspace_size`), so that the engine's
    CUDA graphs, captured afterwards, all launch on the same buffers.
    Returns the sizes."""
    floats, tickets = span_workspace_size(B, H, hd, pg, MP, spans)
    if floats:
        _workspace(device, floats, tickets)
    return floats, tickets


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
          k_scales, v_scales, counter: str,
          pps: Optional[int] = None) -> torch.Tensor:
    """The span kernel's launch (or plain version, for CPU tensors);
    a launch adds one to ``counter`` (``counter + "_q"`` for int8
    pages).  ``pps`` as in :func:`span_geometry` (chip_smoke.py's
    comparison of splits; the wrappers never pass it)."""
    _build.refuse_autograd(counter, q, k_pages, v_pages, k_scales, v_scales)
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
    q = q.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    st = start.to(torch.int32).contiguous()
    sl = span_len.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    kv_code = INT8_CODE if quantized else _build.dtype_code(k_pages, "pages")
    g, args = _launch_args(B, S, H, hd, pg, KV, pt.shape[1], window, q.dtype,
                           kv_code, pps)
    ws = tk = None
    if g.n_splits > 1:
        ws, tk = _workspace(dev, B * H * g.workspace_floats,
                            B * H * g.n_tiles)
    ptrs = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()]
    if quantized:
        k_scales, v_scales = k_scales.contiguous(), v_scales.contiguous()
        ptrs += [k_scales.data_ptr(), v_scales.data_ptr()]
    ptrs += [pt.data_ptr(), st.data_ptr(), sl.data_ptr(), out.data_ptr(),
             ws.data_ptr() if ws is not None else None,
             tk.data_ptr() if tk is not None else None]
    name = f"{counter}_q" if quantized else counter
    fn = "paged_span_q_launch" if quantized else "paged_span_launch"
    lib = _build.library("paged", fn,
                         _Q_ARGTYPES if quantized else _ARGTYPES)
    err = getattr(lib, fn)(*ptrs, args, _build.stream_of(q))
    if err and tk is not None:  # no ticket may outlive a failed launch
        tk.zero_()
    _build.check(err, f"{name} launch")
    _build.LAUNCHES[name] += 1
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
    ``(query tiles x splits, H / tp, B)``, with the geometry of the
    unsharded launch (:func:`span_geometry` takes no head count).  ``n_heads``/``n_kv_heads`` are the
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
           "paged_attention_span_plain", "paged_attention_span_split_plain",
           "paged_attention_sharded", "paged_attention_span_sharded",
           "smem_bytes", "query_tile", "span_fits", "span_geometry",
           "split_pages", "span_workspace_size", "reserve_workspace",
           "SpanGeometry", "GLOBAL_WINDOW", "QUERY_TILE", "PAGES_PER_SPLIT",
           "TILE_PAGES_PER_SPLIT"]
