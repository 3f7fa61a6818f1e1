"""Transformer building blocks, attention-stack subset (port of
``repro.models.layers``): norms, RoPE, GQA attention over no cache, the
ring or a paged KV pool (KV-chunked without a cache where the config
asks), FFNs, mixture-of-experts FFNs, embedding, unembedding and the
training loss's cross-entropy.

Every parameterized matmul routes through ``core.linear``, so Monarch is a
global switch (``cfg.monarch``).  Numerics follow the reference where the
frameworks' defaults differ: GELU is the tanh approximation
(``jax.nn.gelu``'s default), LayerNorm's variance is the population
variance, RMSNorm scales by ``1 + scale``, and RoPE angles are fp32.

Page writes are IN PLACE: the reference's functional ``.at[].set`` under a
donated pool becomes an indexed assignment into the pool's tensors.
Padding and shared-prefix positions all land on the sink page 0.  The
span kernel never reads it unmasked, so there its colliding writes race
harmlessly; the dense gather's padding queries do read it, so on that
path colliding writes all carry the value of the last of them in
row-major order, the one ``.at[].set`` keeps (``last_writes``), and the
sink holds the same rows on the card as on the CPU.  An
int8 pool (``kv_dtype="int8"``) carries (P, KV) fp32 ``k_scales`` /
``v_scales`` beside its pages; fresh rows are quantized into it in place by
``kernels.kv_write.quantize_kv_write`` (its CUDA kernel on the card,
``core.quant.quantize_kv_write`` on the CPU) and read back dequantized, on
chip by the int8 span kernel or on the gathered blocks by the dense
fallback.

The ring KV cache (``attention_cache_init``: (B, max_len, KV, hd) K and V
a layer, the legacy ``ServeEngine``'s) is written in place too, row
``b``'s S new rows at positions ``pos[b] + arange(S)``; as the
reference's ``.at[].set`` does, a write at a position >= max_len is
dropped (every query then attends the whole ring), and the attention is
the dense ``_sdpa`` over the ring under the causal (and window) mask, with
no kernel in either package.

A mixture-of-experts FFN (``moe_init`` / ``moe_apply``) routes as the
reference does, GShard-style: tokens in fixed-size groups, top-k of the
router's softmax with padded slots masked out, capacity per group and
expert by slot priority, the dispatch and combine as einsums, shared
experts added.  The experts' parameters are stacked on a leading expert
axis, and every expert runs at once: ``ffn_apply`` on the (E, rows, d)
dispatch through stacked linears (``core.linear``), which is the
reference's ``jax.vmap`` of ``ffn_apply`` over the experts and, on the
kernel backend, one expert-batched launch a projection
(``kernels.monarch.monarch_fused_experts``).  The router's product and the
dispatch/combine einsums stay plain PyTorch, as the reference runs them
outside any kernel.  Under tensor parallelism a rank runs its slice of
the slots (expert parallelism, the reference's experts over
``"model"``), and the sublayer ends in one all-reduce.

Cross-attention (``attention_apply(kv_input=...)``, the encoder-decoder
models' ``xattn``) is the reference's: q from the decoder stream, K and V
from the encoder's output, no RoPE, every key visible, no cache.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.linear import linear_apply, linear_init
from repro_torch.core.quant import dequantize_kv_pages
from repro_torch.kernels import kv_write
from repro_torch.kernels.paged import GLOBAL_WINDOW
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.sharding.api import (copy_to, gather_slice, reduce_from,
                                      split_input)


def _promote(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    return torch.promote_types(a.dtype, b.dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_init(d: int, kind: str, device=None) -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), device=device)}
    return {"scale": torch.ones((d,), device=device),
            "bias": torch.zeros((d,), device=device)}


def norm_apply(params: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * (1.0 + 0.0 + params["scale"])
    else:
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        out = ((xf - mean) * torch.rsqrt(var + eps) * params["scale"]
               + params["bias"])
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, hd) with positions (..., S) or (S,)."""
    hd = x.shape[-1]
    half = hd // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freqs = 1.0 / (theta ** (ar / half))
    angles = positions[..., None].float() * freqs   # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional local window / logit softcap)
# ---------------------------------------------------------------------------


def attention_init(gen: torch.Generator, cfg: ModelConfig,
                   d_in: Optional[int] = None) -> dict:
    d = d_in or cfg.d_model
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    spec = cfg.monarch
    wo = linear_init(gen, h * hd, d, spec=spec,
                     w_init_scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1)))
    if cfg.fused_proj:
        if h == kv:
            return {"wqkv": linear_init(gen, d, (h + 2 * kv) * hd, spec=spec),
                    "wo": wo}
        return {"wq": linear_init(gen, d, h * hd, spec=spec),
                "wkv": linear_init(gen, d, 2 * kv * hd, spec=spec),
                "wo": wo}
    return {
        "wq": linear_init(gen, d, h * hd, spec=spec),
        "wk": linear_init(gen, d, kv * hd, spec=spec),
        "wv": linear_init(gen, d, kv * hd, spec=spec),
        "wo": wo,
    }


def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def _sdpa(q, k, v, mask, softcap, dtype, fast_scores: bool = False):
    """q: (B,S,H,hd) k/v: (B,T,KV,hd); GQA via head grouping; ``mask``
    broadcasts against (B, KV, g, S, T)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    q = q.reshape(B, S, KV, g, hd)
    score_dtype = torch.bfloat16 if fast_scores else torch.float32
    dt = _promote(q, k)
    scores = torch.einsum("bskgh,btkh->bkgst", q.to(dt), k.to(dt))
    scores = scores.to(score_dtype) / math.sqrt(hd)
    scores = _softcap(scores, softcap)
    neg = -3e4 if fast_scores else -1e30
    zero = torch.zeros((), dtype=score_dtype, device=q.device)
    scores = scores + torch.where(mask, zero, torch.full_like(zero, neg))
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    dt = _promote(probs, v)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(dt), v.to(dt))
    return out.reshape(B, S, H, hd)


def _sdpa_chunked(q, k, v, softcap, dtype, chunk: int, window,
                  bidir: bool):
    """KV-chunked (flash-style) self-attention without a cache: a running
    max and sum over KV chunks of ``chunk`` keys bound the scores to (S x
    chunk), the reference's ``_sdpa_chunked`` (its ``lax.scan`` over the
    chunks is a loop here).  Causal (and windowed) or bidirectional, the
    mask computed a chunk at a time.  q: (B,S,H,hd), k/v: (B,T,KV,hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    T = k.shape[1]
    C = min(chunk, T)
    if T % C:
        raise ValueError(f"chunked attention: {T} keys in chunks of {C}")
    qh = q.reshape(B, S, KV, g, hd)
    qi = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, KV, g, S), -math.inf, device=q.device)
    l = torch.zeros((B, KV, g, S), device=q.device)
    acc = torch.zeros((B, KV, g, S, hd), device=q.device)
    for c0 in range(0, T, C):
        kcb, vcb = k[:, c0:c0 + C], v[:, c0:c0 + C]
        dt = _promote(qh, kcb)
        s = torch.einsum("bskgh,btkh->bkgst", qh.to(dt), kcb.to(dt)).float()
        s = _softcap(s / math.sqrt(hd), softcap)
        kj = c0 + torch.arange(C, device=q.device)[None, :]
        ok = (torch.ones((S, C), dtype=torch.bool, device=q.device) if bidir
              else kj <= qi)
        if window is not None:
            ok = ok & ((qi - kj) < window)
        s = s + torch.where(ok, 0.0, -1e30)[None, None, None]
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + torch.sum(p, dim=-1)
        pv = p.to(dtype)
        dt = _promote(pv, vcb)
        acc = acc * scale[..., None] + torch.einsum(
            "bkgst,btkh->bkgsh", pv.to(dt), vcb.to(dt)).float()
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(dtype)
    return torch.movedim(out, 3, 1).reshape(B, S, H, hd)


def causal_mask(S: int, T: int, offset: int, window: Optional[int],
                device=None) -> torch.Tensor:
    """(1,1,1,S,T) boolean; query i attends key j iff j <= i+offset and
    (window is None or i+offset - j < window)."""
    qi = torch.arange(S, device=device)[:, None] + offset
    kj = torch.arange(T, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m = m & (qi - kj < window)
    return m[None, None, None]


def attention_apply(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    window=None,
    cache: Optional[dict] = None,
    pos: Optional[torch.Tensor] = None,
    page_table: Optional[torch.Tensor] = None,
    span_len: Optional[torch.Tensor] = None,
    write_start: Optional[torch.Tensor] = None,
    kv_input: Optional[torch.Tensor] = None,
    bidir: bool = False,
    backend: str = "einsum",
    plan=None,
) -> tuple[torch.Tensor, Optional[dict]]:
    """Self-attention without a cache, over the ring cache {"k": (B, T,
    KV, hd), "v": ...}, or over a paged KV cache {"k_pages": (P,page,KV,hd),
    "v_pages": ...} addressed through ``page_table`` (B, max_pages), with
    S >= 1 new tokens per row written at ``pos[b] + arange(S)`` (in place,
    either cache).  ``span_len`` and ``write_start`` are as in
    ``repro.models.layers.attention_apply``.  With ``kv_input`` (B, Skv,
    d) it is cross-attention: q from ``x``, K and V from ``kv_input``
    (a fused ``wkv`` too), no RoPE, every key visible, no cache.
    ``bidir`` (the encoder): no RoPE, every key visible.  Returns (out,
    cache).

    Under tensor parallelism (``plan``, a ``sharding.params.TPPlan``) the
    weights are this rank's slices: where the plan splits heads,
    ``wq``/``wk``/``wv`` are column-parallel over this rank's ``H / tp``
    query heads (and ``KV / tp`` KV heads where the pool splits too; a
    fused ``wqkv`` / ``wkv`` holds each part's slice side by side), the
    attention runs on those heads, and ``wo`` is row-parallel over them
    (one all-reduce).  Cross-attention splits as self-attention does,
    its K/V heads from the whole ``enc_out`` on every rank; the ring
    holds this rank's KV heads, or all of them where the plan keeps the
    KV heads whole (``init_decode_cache``)."""
    cross = kv_input is not None
    if cross and cache is not None:
        raise ValueError("cross-attention reads enc_out: no cache")
    ring = cache is not None and "k_pages" not in cache
    B, S, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dtype = x.dtype
    kv_src = kv_input if cross else x
    Skv = kv_src.shape[1]

    if plan is not None and plan.heads:     # this rank's heads
        h //= plan.tp
    if plan is not None and plan.kv_heads:
        kv //= plan.tp
    # the split projections read a whole activation: its gradient is the
    # ranks' sum (K/V projections kept whole are marked in _local_kv)
    xq = split_input(x, plan, plan is not None and plan.heads)
    kv_in = split_input(kv_src, plan, plan is not None and plan.kv_heads)
    if "wqkv" in params:     # [q | k | v], each part this rank's slice
        if cross:
            raise ValueError("fused QKV is self-attention only")
        if plan is not None and plan.pool_replicated \
                and _requires_grad(params["wqkv"]):
            raise NotImplementedError(
                "a fused QKV over whole KV heads under a split of the query "
                "heads has no gradient here: train on separate projections")
        qd, kd = h * hd, kv * hd
        qkv = linear_apply(params["wqkv"], xq, backend=backend)
        q = qkv[..., :qd].reshape(B, S, h, hd)
        k = qkv[..., qd:qd + kd].reshape(B, S, kv, hd)
        v = qkv[..., qd + kd:].reshape(B, S, kv, hd)
    elif "wkv" in params:
        q = linear_apply(params["wq"], xq, backend=backend).reshape(B, S, h, hd)
        kvh = linear_apply(params["wkv"], kv_in, backend=backend)
        k = kvh[..., :kv * hd].reshape(B, Skv, kv, hd)
        v = kvh[..., kv * hd:].reshape(B, Skv, kv, hd)
    else:
        def proj(name, src, heads):
            y = linear_apply(params[name], src, backend=backend)
            return y.reshape(B, src.shape[1], heads, hd)

        q, k, v = (proj("wq", xq, h), proj("wk", kv_in, kv),
                   proj("wv", kv_in, kv))

    if pos is None:
        q_pos = torch.arange(S, device=x.device)
    else:  # cached: per-row start position, S consecutive new tokens
        q_pos = (pos.reshape(B, 1).long()
                 + torch.arange(S, device=x.device)[None])
    if not bidir and not cross:
        q = rope(q, q_pos, cfg.rope_theta)
        k = rope(k, q_pos, cfg.rope_theta)
    if cfg.qk_norm:
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-6)
        k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-6)

    new_cache = None
    if ring:
        out, new_cache = _ring_attend(q, k, v, cache, q_pos, cfg, window,
                                      dtype, plan), cache
    elif cache is not None:
        out, new_cache = _paged_attend(
            q, k, v, cache, page_table, q_pos, cfg, window, dtype,
            span_len=span_len, write_start=write_start, plan=plan)
    elif cfg.attn_chunk is not None and not cross and S > cfg.attn_chunk:
        out = _sdpa_chunked(q, _local_kv(k, q, cfg, plan),
                            _local_kv(v, q, cfg, plan), cfg.logit_softcap,
                            dtype, cfg.attn_chunk, window, bidir)
    else:
        if bidir or cross:   # the encoder, or every encoder key
            mask = torch.ones((1, 1, 1, S, Skv), dtype=torch.bool,
                              device=x.device)
        else:
            mask = causal_mask(S, S, 0, window, device=x.device)
        out = _sdpa(q, _local_kv(k, q, cfg, plan), _local_kv(v, q, cfg, plan),
                    mask, cfg.logit_softcap, dtype,
                    fast_scores=cfg.fast_decode_scores)

    out = out.reshape(B, S, h * hd)
    row = plan is not None and plan.heads
    out = linear_apply(params["wo"], out, backend=backend,
                       reduce=plan.mesh if row else None)
    return out, new_cache


def _requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    return tree.requires_grad


def _local_kv(k: torch.Tensor, q: torch.Tensor, cfg: ModelConfig,
              plan) -> torch.Tensor:
    """k/v (..., T, KV, hd) for q's heads: unchanged where q's heads group
    over them, and where a rank's query heads run over every KV head
    (heads split, KV heads whole) the KV head of each of its query heads,
    so the attention is one KV head per query head."""
    if plan is None or not plan.heads or plan.kv_heads:
        return k
    k = copy_to(k, plan.mesh.group)   # every rank reads its heads of it
    H_loc = q.shape[2]
    g = cfg.n_heads // cfg.n_kv_heads
    idx = (plan.mesh.model_rank * H_loc
           + torch.arange(H_loc, device=k.device)) // g
    return k.index_select(k.dim() - 2, idx)


def attention_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                         device=None,
                         n_kv_heads: Optional[int] = None) -> dict:
    """One layer's ring cache: K and V (batch, max_len, KV, hd), zeros.
    ``n_kv_heads``: the heads this rank holds (default: all of them)."""
    shape = (batch, max_len, n_kv_heads or cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _ring_attend(q, k, v, cache, q_pos, cfg: ModelConfig, window, dtype,
                 plan=None):
    """Write the S new k/v rows of each row into the ring at ``q_pos``
    (in place), then attend every query over the whole ring under its own
    causal horizon (and window): the reference's ring branch
    (``repro/models/layers.py:255-271``).

    q: (B,S,H,hd); k/v: (B,S,KV,hd); cache k/v: (B,T,KV,hd); q_pos: (B,S).
    A position >= T is dropped, as ``.at[].set`` drops it: its write is
    sent to T - 1 carrying the value T - 1 ends with (this call's row for
    T - 1 where it writes one, else the ring's own), so every duplicate
    write of T - 1 writes one value and the scatter stays deterministic,
    with no host sync and no shape that depends on the positions.  Under
    a plan q holds this rank's heads and the ring its KV heads, or every
    KV head where the plan keeps them whole (then each query head reads
    its own, ``_local_kv``)."""
    ck, cv = cache["k"], cache["v"]
    B, S = q_pos.shape
    T = ck.shape[1]
    j = torch.clamp(q_pos, max=T - 1)                  # the ring row written
    start = q_pos[:, :1]
    fresh = j >= start               # this call writes ring row j ...
    src = torch.clamp(j - start, 0, S - 1)   # ... with its row j - start
    rows = torch.arange(B, device=q.device)[:, None]
    for c, new in ((ck, k), (cv, v)):
        idx = src[..., None, None].expand(-1, -1, *new.shape[2:])
        val = torch.where(fresh[..., None, None],
                          torch.gather(new, 1, idx).to(c.dtype), c[rows, j])
        c[rows, j] = val
    kj = torch.arange(T, device=q.device)[None, None, :]
    valid = kj <= q_pos[..., None]  # (B,S,T)
    if window is not None:
        valid &= (q_pos[..., None] - kj) < window
    return _sdpa(q, _local_kv(ck, q, cfg, plan), _local_kv(cv, q, cfg, plan),
                 valid[:, None, None], cfg.logit_softcap, dtype,
                 fast_scores=cfg.fast_decode_scores)


def paged_cache_init(cfg: ModelConfig, n_pages: int, page_size: int, dtype,
                     kv_dtype: Optional[str] = None, device=None,
                     n_kv_heads: Optional[int] = None) -> dict:
    """One layer's share of the paged KV pool: ``n_pages`` fixed-size pages
    stored at ``kv_dtype`` ("fp32" | "bf16" | "int8"; None keeps the model
    dtype).  "int8" adds one fp32 scale per (page, kv_head) for K and V
    independently (``k_scales``/``v_scales``, (n_pages, KV)).
    ``n_kv_heads``: the heads this rank holds (default: all of them)."""
    kv, hd = n_kv_heads or cfg.n_kv_heads, cfg.hd
    if kv_dtype is None:
        page_dtype = dtype
    elif kv_dtype == "fp32":
        page_dtype = torch.float32
    elif kv_dtype == "bf16":
        page_dtype = torch.bfloat16
    elif kv_dtype == "int8":
        page_dtype = torch.int8
    else:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    shape = (n_pages, page_size, kv, hd)
    cache = {"k_pages": torch.zeros(shape, dtype=page_dtype, device=device),
             "v_pages": torch.zeros(shape, dtype=page_dtype, device=device)}
    if kv_dtype == "int8":
        for name in ("k_scales", "v_scales"):
            cache[name] = torch.zeros((n_pages, kv), dtype=torch.float32,
                                      device=device)
    return cache


def paged_write_targets(page_table: torch.Tensor, q_pos: torch.Tensor,
                        pg: int, span_len=None, write_start=None):
    """Where a paged step writes its (B, S) new K/V rows: (phys (B, S)
    physical pages, off (B, S) offsets in them).  Positions past a row's
    ``span_len``, below its ``write_start`` or past its table go to the
    sink page 0."""
    B, S = q_pos.shape
    MP = page_table.shape[1]
    pt = page_table.long()
    # positions past the table (padding only) clamp, then go to the sink
    phys = torch.gather(pt, 1, torch.clamp(q_pos // pg, max=MP - 1))
    off = q_pos % pg
    if span_len is not None or write_start is not None:
        valid = torch.ones((B, S), dtype=torch.bool, device=q_pos.device)
        if span_len is not None:
            valid &= (torch.arange(S, device=q_pos.device)[None, :]
                      < span_len.long()[:, None])
        if write_start is not None:
            valid &= q_pos >= write_start.long()[:, None]
        phys = torch.where(valid, phys, torch.zeros_like(phys))
    return phys, off


def last_writes(phys: torch.Tensor, off: torch.Tensor,
                pg: int) -> torch.Tensor:
    """(B * S,): for each write, the row-major index of the LAST write to
    the same (page, offset), the write the reference's ``.at[].set`` keeps
    among duplicates.  Writing each position with its ``last`` row's
    value makes colliding writes (padding positions on the sink page)
    store one value, in whatever order the card runs them.  A stable sort
    of the targets and a suffix minimum find it, with no host sync."""
    target = (phys * pg + off).reshape(-1)
    n = target.numel()
    ts, perm = torch.sort(target, stable=True)
    idx = torch.arange(n, device=target.device)
    run_end = torch.cat([ts[1:] != ts[:-1],
                         torch.ones(1, dtype=torch.bool, device=idx.device)])
    end = torch.where(run_end, idx, torch.full_like(idx, n))
    end = torch.flip(torch.cummin(torch.flip(end, [0]), 0).values, [0])
    return torch.empty_like(perm).scatter_(0, perm, perm[end])


def _paged_attend(q, k, v, cache, page_table, q_pos, cfg: ModelConfig,
                  window, dtype, span_len=None, write_start=None, plan=None):
    """Write S new k/v rows through the page table (in place), attend over
    the gathered pages.

    q: (B,S,H,hd); k/v: (B,S,KV,hd); cache pages: (P, page, KV, hd);
    page_table: (B, MP) physical page ids; q_pos: (B,S) global positions.
    Positions past a row's ``span_len`` and below its ``write_start`` are
    redirected to the sink page 0; unallocated table entries point at the
    sink too and are never attended (the causal mask admits only keys at
    positions <= q_pos).  Where the dense gather runs on a float pool,
    among duplicate targets the last write's value lands (``last_writes``),
    deterministically: its padding queries read the sink.

    An int8 pool quantizes the span rows into its pages with
    ``kernels.kv_write.quantize_kv_write``; the stored-row rescale runs
    over the span's logical page range read from the page table
    (``ceil(S / page) + 1`` entries a row), which covers every non-sink
    page the writes name; any extra page (a shared one, the sink)
    rescales by exactly 1.0, and a page listed twice (the sink, the last
    column repeated by the clamp) is rescaled once.

    Under tensor parallelism the pool holds this rank's KV heads when the
    plan splits them: the span kernel then runs per rank as B7.  A pool
    left whole at tp > 1 takes the dense gather for this rank's query
    heads ("gqa_replicated")."""
    kp, vp = cache["k_pages"], cache["v_pages"]
    quantized = "k_scales" in cache
    ks = cache.get("k_scales")
    vs = cache.get("v_scales")
    pg = kp.shape[1]
    B, S = q_pos.shape
    MP = page_table.shape[1]
    pt = page_table.long()
    phys, off = paged_write_targets(pt, q_pos, pg, span_len, write_start)

    from repro_torch.kernels.ops import paged_dispatch

    decision = paged_dispatch(
        q.shape[3], pg, paged_kernel=cfg.paged_kernel,
        softcap=cfg.logit_softcap is not None,
        pool_replicated=plan is not None and plan.pool_replicated)
    if quantized:
        nK = (S + pg - 1) // pg + 1
        jcols = torch.clamp(
            q_pos[:, :1] // pg + torch.arange(nK, device=q.device)[None, :],
            0, MP - 1)
        resc = torch.gather(pt, 1, jcols)                     # (B, nK)
        kv_write.quantize_kv_write(kp, ks, phys, off, k, rescale_phys=resc)
        kv_write.quantize_kv_write(vp, vs, phys, off, v, rescale_phys=resc)
    elif decision == "kernel":
        kp[phys, off] = k.to(kp.dtype)
        vp[phys, off] = v.to(vp.dtype)
    else:
        # every write to a (page, offset) carries the value of the last
        # one in row-major order, so colliding sink writes land alike
        last = last_writes(phys, off, pg)
        for pages, new in ((kp, k), (vp, v)):
            rows = new.reshape(B * S, *new.shape[2:])[last]
            pages[phys, off] = rows.reshape(new.shape).to(pages.dtype)

    if decision == "kernel":
        from repro_torch.kernels import paged as span_k

        win = GLOBAL_WINDOW if window is None else int(window)
        sc = dict(k_scales=ks, v_scales=vs)
        if plan is not None and plan.kv_heads:  # B7: this rank's heads
            sc.update(mesh=plan.mesh, n_heads=cfg.n_heads,
                      n_kv_heads=cfg.n_kv_heads)
            one, span = (span_k.paged_attention_sharded,
                         span_k.paged_attention_span_sharded)
        else:
            one, span = span_k.paged_attention, span_k.paged_attention_span
        if S == 1 and span_len is None:
            out = one(q[:, 0], kp, vp, page_table, q_pos[:, 0] + 1, win,
                      **sc)
            return out[:, None], cache
        sp = (torch.full((B,), S, dtype=torch.int32, device=q.device)
              if span_len is None else span_len)
        out = span(q, kp, vp, page_table, q_pos[:, 0], sp, win, **sc)
        return out, cache

    # dense-gather fallback (the engine counts the reason); int8 pages are
    # gathered at their stored width, then dequantized
    if quantized:
        kk = dequantize_kv_pages(kp[pt], ks[pt]).to(dtype)
        vv = dequantize_kv_pages(vp[pt], vs[pt]).to(dtype)
    else:
        kk, vv = kp[pt], vp[pt]
    kk = kk.reshape(B, MP * pg, *kp.shape[2:])  # (B,T,KV,hd)
    vv = vv.reshape(B, MP * pg, *vp.shape[2:])
    kj = torch.arange(MP * pg, device=q.device)[None, None, :]
    valid = kj <= q_pos[..., None]  # (B,S,T)
    if window is not None:
        valid &= (q_pos[..., None] - kj) < window
    mask = valid[:, None, None]  # (B,1,1,S,T)
    out = _sdpa(q, _local_kv(kk, q, cfg, plan), _local_kv(vv, q, cfg, plan),
                mask, cfg.logit_softcap, dtype,
                fast_scores=cfg.fast_decode_scores)
    return out, cache


# ---------------------------------------------------------------------------
# FFN variants
# ---------------------------------------------------------------------------


def ffn_init(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    spec = cfg.monarch
    gated = cfg.ffn_type in ("swiglu", "geglu")
    w2 = linear_init(gen, ff, d, spec=spec,
                     w_init_scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1)))
    if gated and cfg.fused_proj:
        return {"w1g": linear_init(gen, d, 2 * ff, spec=spec), "w2": w2}
    p = {"w1": linear_init(gen, d, ff, spec=spec), "w2": w2}
    if gated:
        p["wg"] = linear_init(gen, d, ff, spec=spec)
    return p


def ffn_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
              backend: str = "einsum", plan=None,
              reduce: bool = True) -> torch.Tensor:
    """The FFN; where the plan splits the ``"mlp"`` group ``w1``/``wg``
    are column-parallel and ``w2`` row-parallel (one all-reduce, or with
    ``reduce=False`` this rank's partial sum, for a caller that sums it
    with others in one all-reduce; a ``w2`` bias would then be added on
    every rank, so it is refused)."""
    g = None
    x = split_input(x, plan, plan is not None and plan.mlp)
    if "w1g" in params:  # fused up+gate projection ([up, gate] layout)
        hg = linear_apply(params["w1g"], x, backend=backend)
        ff = hg.shape[-1] // 2
        h, g = hg[..., :ff], hg[..., ff:]
    else:
        h = linear_apply(params["w1"], x, backend=backend)
        if cfg.ffn_type in ("swiglu", "geglu"):
            g = linear_apply(params["wg"], x, backend=backend)
    if cfg.ffn_type == "swiglu":
        h = F.silu(g) * h
    elif cfg.ffn_type == "geglu":
        h = F.gelu(g, approximate="tanh") * h
    elif cfg.ffn_type == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif cfg.ffn_type == "relu2":  # squared ReLU (nemotron / Primer)
        h = torch.square(F.relu(h))
    else:
        raise ValueError(f"unknown ffn_type {cfg.ffn_type}")
    row = plan is not None and plan.mlp
    if row and not reduce and "b" in params["w2"]:
        raise ValueError("a row-parallel partial FFN with a w2 bias")
    return linear_apply(params["w2"], h, backend=backend,
                        reduce=plan.mesh if row and reduce else None)


# ---------------------------------------------------------------------------
# Mixture of Experts (GShard-style capacity dispatch, shared + routed)
# ---------------------------------------------------------------------------


def stack_trees(trees: list) -> dict:
    """Stack a list of identically shaped nested dicts on a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The router (dense, ``d_model`` x ``n_slots``), the routed experts'
    FFNs stacked on a leading axis of ``n_slots`` (padded slots included;
    routing masks them), and ``n_shared`` shared experts."""
    mc = cfg.moe
    de = mc.d_expert or cfg.d_ff
    sub = dataclasses.replace(cfg, d_ff=de)
    p = {"router": linear_init(gen, cfg.d_model, mc.n_slots, spec=None),
         "experts": stack_trees([ffn_init(gen, sub, d_ff=de)
                                 for _ in range(mc.n_slots)])}
    for i in range(mc.n_shared):
        p[f"shared{i}"] = ffn_init(gen, sub, d_ff=de)
    return p


def _route(logits: torch.Tensor, mc: MoEConfig):
    """The router's choice from its fp32 logits (G, s, n_slots): padded
    slots masked to -1e30, the softmax, the ``top_k`` most probable slots
    and their gates renormalised to sum to 1.  Returns (probs, gates (G,
    s, k), slots (G, s, k)).

    ``jax.lax.top_k`` takes the lower index first among equal values;
    a stable descending sort keeps equal values in index order, so its
    first ``top_k`` are the same slots in the same order (``torch.topk``
    promises no order among ties)."""
    if mc.n_slots > mc.n_experts:
        ok = torch.arange(mc.n_slots, device=logits.device) < mc.n_experts
        logits = torch.where(ok, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[..., :mc.top_k], idx[..., :mc.top_k]
    return probs, gates / torch.sum(gates, dim=-1, keepdim=True), idx


def _dispatch(idx: torch.Tensor, gates: torch.Tensor, E: int, cap: int,
              dtype: torch.dtype):
    """GShard's slot-priority capacity: for each of the k choices in turn,
    a token takes the next free capacity slot of its expert within its
    group (a ``cumsum`` over the group's tokens), dropped once ``cap`` are
    taken.  Returns (dispatch (G, s, E, cap) in ``dtype``, combine (G, s,
    E, cap) fp32: the gate where the token was kept).  One-hots are
    comparisons with an ``arange``: no value is read on the host."""
    G, sg, k = idx.shape
    slots = torch.arange(E, device=idx.device)
    caps = torch.arange(cap, device=idx.device)
    dispatch = torch.zeros((G, sg, E, cap), dtype=dtype, device=idx.device)
    combine = torch.zeros((G, sg, E, cap), device=idx.device)
    counts = torch.zeros((G, E), dtype=torch.long, device=idx.device)
    for k_slot in range(k):
        sel = (idx[..., k_slot, None] == slots).long()              # (G,s,E)
        # the running count over the group's tokens, scanned along the
        # innermost axis (PyTorch's scan over an outer axis of a CUDA
        # tensor is far slower); integers, so the same values
        run = torch.cumsum(sel.transpose(1, 2).contiguous(), dim=-1)
        pos = run.transpose(1, 2) - 1 + counts[:, None, :]
        counts = counts + torch.sum(sel, dim=1)
        keep = (pos < cap) & (sel > 0)
        oh = (torch.where(keep, pos, 0)[..., None] == caps).to(dtype)
        oh = oh * keep[..., None].to(dtype)                         # (G,s,E,c)
        dispatch = dispatch + oh
        combine = combine + (oh.float() * gates[..., k_slot, None, None]
                             * sel[..., None].float())
    return dispatch, combine


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
              backend: str = "einsum", lb_loss: bool = True,
              plan=None) -> tuple[torch.Tensor, dict]:
    """Grouped GShard dispatch (the reference's ``moe_apply``): the B*S
    tokens routed within groups of ``group_size`` (halved until it tiles
    them), capacity ``max(4, int(capacity_factor * group * top_k /
    n_experts))`` a group and expert; every slot's capacity rows run
    through its expert (the padded slots' and the unused rows too, as in
    the reference), the combine weights them by the renormalised gates,
    and the shared experts see every token.  Returns (output (B, S, d),
    {"lb_loss": the Switch/GShard load-balance loss E * sum_e f_e * p_e});
    ``lb_loss=False`` (a serving step, which drops it) returns {}.

    Under a plan that splits ``"experts"`` (expert parallelism, the
    reference's experts over ``"model"``) every rank routes every token
    (the activations are whole after each sublayer's all-reduce, so the
    routes and the capacity, from the group's whole token count, are the
    same on every rank), keeps its ``n_slots / tp`` slots of the dispatch
    and combine, runs its experts as one expert-batched launch a
    projection and forms its partial combine; the shared experts, where
    ``"mlp"`` splits, add their partial row-parallel sums, and ONE
    all-reduce sums the whole sublayer.  A part the plan keeps whole is
    added after it, once."""
    mc: MoEConfig = cfg.moe
    B, S, d = x.shape
    sg = moe_group_size(mc, B * S, plan)
    G = B * S // sg
    xt = x.reshape(G, sg, d)
    probs, gates, idx = _route(linear_apply(params["router"], xt).float(),
                               mc)
    E = mc.n_slots
    cap = max(4, int(mc.capacity_factor * sg * mc.top_k / mc.n_experts))
    dispatch, combine = _dispatch(idx, gates, E, cap, x.dtype)
    ep = plan is not None and plan.experts
    El = E // plan.tp if ep else E
    x_ex = split_input(xt, plan, ep)
    if ep:                       # this rank's slots
        lo = plan.mesh.model_rank * El
        dispatch = dispatch[:, :, lo:lo + El]
        combine = copy_to(combine, plan.mesh.group)[:, :, lo:lo + El]
    dt = _promote(dispatch, x_ex)
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch.to(dt),
                             x_ex.to(dt))
    sub = dataclasses.replace(cfg, d_ff=mc.d_expert or cfg.d_ff)
    expert_out = ffn_apply(params["experts"],
                           expert_in.reshape(El, G * cap, d), sub,
                           backend).reshape(El, G, cap, d)
    cw = combine.to(x.dtype)
    dt = _promote(cw, expert_out)
    # under expert parallelism the combine's sum over the experts is split
    # across the ranks: each sums its own slots, the all-reduce sums the
    # ranks, in fp32 -- another order than tp = 1's one sum over all slots
    out = torch.einsum("gsec,egcd->gsd", cw.to(dt), expert_out.to(dt))
    shared_split = plan is not None and plan.mlp
    partial, whole = (out, None) if ep else (None, out)
    for i in range(mc.n_shared):
        f = ffn_apply(params[f"shared{i}"], xt, sub, backend, plan=plan,
                      reduce=False)
        if shared_split:
            partial = f if partial is None else partial + f
        else:
            whole = f if whole is None else whole + f
    if partial is None:
        out = whole
    else:
        out = reduce_from(partial, plan.mesh.group)
        out = out if whole is None else out + whole
    if not lb_loss:
        return out.reshape(B, S, d), {}
    top1 = (idx[..., 0, None] == torch.arange(E, device=x.device)).float()
    data = None if plan is None else plan.mesh.data_group
    if data is None:
        frac = torch.mean(top1, dim=(0, 1))
        mean_prob = torch.mean(probs, dim=(0, 1))
    else:
        # the means over the whole batch: every data rank's sums
        n = float(G * sg * plan.mesh.data)
        frac = reduce_from(torch.sum(top1, dim=(0, 1)), data) / n
        mean_prob = reduce_from(torch.sum(probs, dim=(0, 1)), data) / n
    return out.reshape(B, S, d), {"lb_loss": E * torch.sum(frac * mean_prob)}


def moe_group_size(mc: MoEConfig, T: int, plan=None) -> int:
    """The routing group's size for ``T`` tokens on this rank: the
    reference's ``min(group_size, tokens)``, halved until it tiles the
    tokens, over the WHOLE batch's tokens (``T`` x the ``"data"`` axis)
    so that a data split routes as one process does.  A split whose rows
    would cut a group raises."""
    data = 1 if plan is None else plan.mesh.data
    total = T * data
    sg = min(mc.group_size, total)
    while total % sg:
        sg //= 2
    if T % sg:
        raise ValueError(
            f"a 'data' split of {data} cuts the MoE routing groups: "
            f"{T} tokens a rank, groups of {sg} over the batch's {total}")
    return sg


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embedding_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    std = 1.0 / math.sqrt(cfg.d_model)
    vp = cfg.vocab_padded
    dev = gen.device
    p = {"table": torch.randn((vp, cfg.d_model), generator=gen,
                              device=dev) * std}
    if not cfg.tie_embeddings:
        p["unembed"] = torch.randn((cfg.d_model, vp), generator=gen,
                                   device=dev) * std
    return p


def embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
          dtype, plan=None) -> torch.Tensor:
    """Token rows of the table.  A vocab-parallel table (this rank's
    ``Vp / tp`` rows) looks up the tokens of its slice, zeros the others
    and sums over the ranks: exact, since one rank holds each row."""
    table = params["table"]
    tok = tokens.long()
    Vl = table.shape[0]
    if plan is not None and plan.vocab:
        local = tok - plan.mesh.model_rank * Vl
        mine = (local >= 0) & (local < Vl)
        rows = table[torch.clamp(local, 0, Vl - 1)]
        rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
        rows = reduce_from(rows, plan.mesh.group)
    else:
        rows = table[tok]
    # gather, then cast: the same values as the reference's cast-then-gather
    x = rows.to(dtype)
    return x * math.sqrt(cfg.d_model) if cfg.norm_type == "rmsnorm" else x


def unembed(params: dict, x: torch.Tensor, cfg: ModelConfig,
            plan=None) -> torch.Tensor:
    """fp32 logits over the padded vocab.  Vocab-parallel weights give
    this rank's vocab slice of the logits, gathered from every rank
    (exact) before the padding mask."""
    x = split_input(x, plan, plan is not None and plan.vocab)
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["table"].to(x.dtype).t())
    else:
        logits = torch.matmul(x, params["unembed"].to(x.dtype))
    logits = logits.float()
    if plan is not None and plan.vocab:
        logits = gather_slice(logits, plan.mesh.group, dim=-1)
    logits = _softcap(logits, cfg.final_softcap)
    if cfg.vocab_padded > cfg.vocab:  # mask padding slots (softmax-neutral)
        valid = torch.arange(cfg.vocab_padded, device=x.device) < cfg.vocab
        logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  data_group=None) -> torch.Tensor:
    """Mean next-token negative log-likelihood of ``labels`` under
    ``logits`` (..., V); with ``mask``, the masked sum over the mask's sum
    (at least 1).  Under a ``data_group`` the rows are this rank's share
    of the batch: the sum and the count are the group's (fp32), so every
    rank returns the whole batch's loss."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if data_group is not None:
        num = torch.sum(nll if mask is None else nll * mask)
        den = (torch.tensor(float(nll.numel()), device=nll.device)
               if mask is None else torch.sum(mask).float())
        num, den = reduce_from(torch.stack([num.float(), den]),
                               data_group).unbind()
        return num / (den if mask is None else torch.clamp(den, min=1))
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)


__all__ = [
    "norm_init", "norm_apply", "rope",
    "attention_init", "attention_apply", "attention_cache_init",
    "paged_cache_init", "paged_write_targets", "last_writes",
    "causal_mask",
    "ffn_init", "ffn_apply", "moe_init", "moe_apply", "stack_trees",
    "embedding_init", "embed", "unembed", "cross_entropy", "GLOBAL_WINDOW",
    "moe_group_size",
]
