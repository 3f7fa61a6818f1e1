"""Transformer building blocks, attention-stack subset (port of
``repro.models.layers``): norms, RoPE, GQA attention over no cache or a
paged KV pool, FFNs, embedding and unembedding.

Every parameterized matmul routes through ``core.linear``, so Monarch is a
global switch (``cfg.monarch``).  Numerics follow the reference where the
frameworks' defaults differ: GELU is the tanh approximation
(``jax.nn.gelu``'s default), LayerNorm's variance is the population
variance, RMSNorm scales by ``1 + scale``, and RoPE angles are fp32.

Page writes are IN PLACE: the reference's functional ``.at[].set`` under a
donated pool becomes an indexed assignment into the pool's tensors.
Padding and shared-prefix positions all land on the sink page 0, where
duplicate writes race harmlessly (the sink is never read unmasked).  An
int8 pool (``kv_dtype="int8"``) carries (P, KV) fp32 ``k_scales`` /
``v_scales`` beside its pages; fresh rows are quantized into it in place by
``kernels.kv_write.quantize_kv_write`` (its CUDA kernel on the card,
``core.quant.quantize_kv_write`` on the CPU) and read back dequantized, on
chip by the int8 span kernel or on the gathered blocks by the dense
fallback.

MoE, the ring cache and cross-attention are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.linear import linear_apply, linear_init
from repro_torch.core.quant import dequantize_kv_pages
from repro_torch.kernels import kv_write
from repro_torch.kernels.paged import GLOBAL_WINDOW
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.api import all_gather_cat, all_reduce_sum


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
    """Self-attention without a cache, or over a paged KV cache
    {"k_pages": (P,page,KV,hd), "v_pages": ...} addressed through
    ``page_table`` (B, max_pages), with S >= 1 new tokens per row written
    at ``pos[b] + arange(S)``.  ``span_len`` and ``write_start`` are as in
    ``repro.models.layers.attention_apply``.  Returns (out, cache).

    Under tensor parallelism (``plan``, a ``sharding.params.TPPlan``) the
    weights are this rank's slices: where the plan splits heads,
    ``wq``/``wk``/``wv`` are column-parallel over this rank's ``H / tp``
    query heads (and ``KV / tp`` KV heads where the pool splits too), the
    attention runs on those heads, and ``wo`` is row-parallel over them
    (one all-reduce)."""
    if kv_input is not None:
        raise NotImplementedError("cross-attention is not ported yet")
    if cache is not None and "k_pages" not in cache:
        raise NotImplementedError("the ring KV cache is not ported yet")
    B, S, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dtype = x.dtype

    if "wqkv" in params:
        qd, kd = h * hd, kv * hd
        qkv = linear_apply(params["wqkv"], x, backend=backend)
        q = qkv[..., :qd].reshape(B, S, h, hd)
        k = qkv[..., qd:qd + kd].reshape(B, S, kv, hd)
        v = qkv[..., qd + kd:].reshape(B, S, kv, hd)
    elif "wkv" in params:
        q = linear_apply(params["wq"], x, backend=backend).reshape(B, S, h, hd)
        kvh = linear_apply(params["wkv"], x, backend=backend)
        k = kvh[..., :kv * hd].reshape(B, S, kv, hd)
        v = kvh[..., kv * hd:].reshape(B, S, kv, hd)
    else:
        if plan is not None and plan.heads:     # this rank's heads
            h //= plan.tp
        if plan is not None and plan.kv_heads:
            kv //= plan.tp

        def proj(name, heads):
            y = linear_apply(params[name], x, backend=backend)
            return y.reshape(B, S, heads, hd)

        q, k, v = proj("wq", h), proj("wk", kv), proj("wv", kv)

    if pos is None:
        q_pos = torch.arange(S, device=x.device)
    else:  # cached: per-row start position, S consecutive new tokens
        q_pos = (pos.reshape(B, 1).long()
                 + torch.arange(S, device=x.device)[None])
    if not bidir:
        q = rope(q, q_pos, cfg.rope_theta)
        k = rope(k, q_pos, cfg.rope_theta)
    if cfg.qk_norm:
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-6)
        k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-6)

    new_cache = None
    if cache is not None:
        out, new_cache = _paged_attend(
            q, k, v, cache, page_table, q_pos, cfg, window, dtype,
            span_len=span_len, write_start=write_start, plan=plan)
    else:
        if cfg.attn_chunk is not None and S > cfg.attn_chunk:
            raise NotImplementedError("chunked attention is not ported yet")
        if bidir:
            mask = torch.ones((1, 1, 1, S, S), dtype=torch.bool,
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


def _local_kv(k: torch.Tensor, q: torch.Tensor, cfg: ModelConfig,
              plan) -> torch.Tensor:
    """k/v (..., T, KV, hd) for q's heads: unchanged where q's heads group
    over them, and where a rank's query heads run over every KV head
    (heads split, KV heads whole) the KV head of each of its query heads,
    so the attention is one KV head per query head."""
    if plan is None or not plan.heads or plan.kv_heads:
        return k
    H_loc = q.shape[2]
    g = cfg.n_heads // cfg.n_kv_heads
    idx = (plan.mesh.rank * H_loc
           + torch.arange(H_loc, device=k.device)) // g
    return k.index_select(k.dim() - 2, idx)


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


def _paged_attend(q, k, v, cache, page_table, q_pos, cfg: ModelConfig,
                  window, dtype, span_len=None, write_start=None, plan=None):
    """Write S new k/v rows through the page table (in place), attend over
    the gathered pages.

    q: (B,S,H,hd); k/v: (B,S,KV,hd); cache pages: (P, page, KV, hd);
    page_table: (B, MP) physical page ids; q_pos: (B,S) global positions.
    Positions past a row's ``span_len`` and below its ``write_start`` are
    redirected to the sink page 0; unallocated table entries point at the
    sink too and are never attended (the causal mask admits only keys at
    positions <= q_pos).

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
    # positions past the table (padding only) clamp, then go to the sink
    phys = torch.gather(pt, 1, torch.clamp(q_pos // pg, max=MP - 1))
    off = q_pos % pg
    if span_len is not None or write_start is not None:
        valid = torch.ones((B, S), dtype=torch.bool, device=q.device)
        if span_len is not None:
            valid &= (torch.arange(S, device=q.device)[None, :]
                      < span_len.long()[:, None])
        if write_start is not None:
            valid &= q_pos >= write_start.long()[:, None]
        phys = torch.where(valid, phys, torch.zeros_like(phys))
    if quantized:
        nK = (S + pg - 1) // pg + 1
        jcols = torch.clamp(
            q_pos[:, :1] // pg + torch.arange(nK, device=q.device)[None, :],
            0, MP - 1)
        resc = torch.gather(pt, 1, jcols)                     # (B, nK)
        kv_write.quantize_kv_write(kp, ks, phys, off, k, rescale_phys=resc)
        kv_write.quantize_kv_write(vp, vs, phys, off, v, rescale_phys=resc)
    else:
        kp[phys, off] = k.to(kp.dtype)
        vp[phys, off] = v.to(vp.dtype)

    from repro_torch.kernels.ops import paged_dispatch

    decision = paged_dispatch(
        q.shape[3], pg, paged_kernel=cfg.paged_kernel,
        softcap=cfg.logit_softcap is not None,
        pool_replicated=plan is not None and plan.pool_replicated)
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
              backend: str = "einsum", plan=None) -> torch.Tensor:
    """The FFN; where the plan splits the ``"mlp"`` group ``w1``/``wg``
    are column-parallel and ``w2`` row-parallel (one all-reduce)."""
    g = None
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
    return linear_apply(params["w2"], h, backend=backend,
                        reduce=plan.mesh if row else None)


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
        local = tok - plan.mesh.rank * Vl
        mine = (local >= 0) & (local < Vl)
        rows = table[torch.clamp(local, 0, Vl - 1)]
        rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
        rows = all_reduce_sum(rows, plan.mesh)
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
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["table"].to(x.dtype).t())
    else:
        logits = torch.matmul(x, params["unembed"].to(x.dtype))
    logits = logits.float()
    if plan is not None and plan.vocab:
        logits = all_gather_cat(logits, plan.mesh, dim=-1)
    logits = _softcap(logits, cfg.final_softcap)
    if cfg.vocab_padded > cfg.vocab:  # mask padding slots (softmax-neutral)
        valid = torch.arange(cfg.vocab_padded, device=x.device) < cfg.vocab
        logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    return logits


__all__ = [
    "norm_init", "norm_apply", "rope",
    "attention_init", "attention_apply", "paged_cache_init", "causal_mask",
    "ffn_init", "ffn_apply", "embedding_init", "embed", "unembed",
    "GLOBAL_WINDOW",
]
