"""Plain PyTorch oracles, translated from ``repro/kernels/ref.py`` and
independent of the kernels and of their plain versions."""

from __future__ import annotations

import math

import torch


def bdmm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (T, k, p), w: (k, q, p) -> (T, k, q)."""
    return torch.einsum("tkp,kqp->tkq", x, w)


def monarch_ref(x: torch.Tensor, L: torch.Tensor,
                R: torch.Tensor) -> torch.Tensor:
    """x: (T, k*p) -> (T, q*s): the folded Monarch product."""
    T, _ = x.shape
    k, q, p = L.shape
    _, s, _ = R.shape
    u = torch.einsum("kqp,tkp->tkq", L, x.reshape(T, k, p))
    ut = u.transpose(-1, -2)  # P
    y = torch.einsum("qsk,tqk->tqs", R, ut)
    return y.reshape(T, q * s)


def paged_attention_span_ref(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, page_table: torch.Tensor,
                             start: torch.Tensor, span_len: torch.Tensor,
                             window) -> torch.Tensor:
    """Gather every sequence's pages into a contiguous KV buffer, then plain
    masked softmax attention, causal within the span; rows
    ``i >= span_len[b]`` return zeros."""
    B, S, H, hd = q.shape
    _, pg, KV, _ = k_pages.shape
    MP = page_table.shape[1]
    g = H // KV
    pt = page_table.long()
    kk = k_pages[pt].reshape(B, MP * pg, KV, hd).float()
    vv = v_pages[pt].reshape(B, MP * pg, KV, hd).float()
    qh = q.reshape(B, S, KV, g, hd).float()
    s = torch.einsum("bskgh,btkh->bskgt", qh, kk) / math.sqrt(hd)
    dev = q.device
    t = torch.arange(MP * pg, device=dev)[None, None, :]
    q_pos = start.long()[:, None] + torch.arange(S, device=dev)[None, :]
    ok = (t <= q_pos[..., None]) & ((q_pos[..., None] - t) < window)
    s = torch.where(ok[:, :, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bskgt,btkh->bskgh", p, vv).reshape(B, S, H, hd)
    valid = torch.arange(S, device=dev)[None, :] < span_len.long()[:, None]
    return torch.where(valid[..., None, None], out, 0.0).to(q.dtype)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        lengths: torch.Tensor, window) -> torch.Tensor:
    """Single-query (decode) oracle: span of 1 at position ``lengths - 1``."""
    B = q.shape[0]
    out = paged_attention_span_ref(
        q[:, None], k_pages, v_pages, page_table, lengths - 1,
        torch.ones((B,), dtype=torch.int32, device=q.device), window)
    return out[:, 0]


__all__ = ["bdmm_ref", "monarch_ref", "paged_attention_span_ref",
           "paged_attention_ref"]
