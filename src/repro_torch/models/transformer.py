"""Model assembly for attention stacks (port of
``repro.models.transformer``).

Parameters keep the reference's pytree layout: nested dicts with the same
keys, every decoder leaf stacked on a leading layer axis
(``decoder/layers/...`` has shape ``(n_layers, ...)``).  Where the
reference scans that axis, the port loops over it.

Public API:
  init_params(cfg, seed, device)                  -> params
  forward(params, batch, cfg)                     -> (logits, aux)
  init_paged_pool(cfg, n_pages, page_size, ...)   -> pool
  cow_copy_pages(pool, src, dst)                  -> pool (in place)
  paged_mixed_step(params, tokens, start, span_len, page_table, pool, cfg)
                                                  -> (logits, pool)

SSM, hybrid, MoE and encoder-decoder stacks, the ring cache and training
are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import DeviceLike, resolve_device, tree_map
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

GLOBAL_WINDOW = L.GLOBAL_WINDOW


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.layer_kind != "attn":
        raise NotImplementedError(f"{cfg.layer_kind} stacks are not ported")
    if cfg.moe is not None:
        raise NotImplementedError("MoE layers are not ported yet")
    if cfg.encdec or cfg.frontend is not None:
        raise NotImplementedError(
            "encoder-decoder and modality frontends are not ported yet")
    if cfg.sandwich_norm:
        raise NotImplementedError("sandwich norms are not ported yet")


def _stack(trees: list) -> dict:
    """Stack a list of identically shaped nested dicts on a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i``'s slice of a stacked tree (views, no copies)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


# ---------------------------------------------------------------------------
# One decoder block (attention mixer + FFN)
# ---------------------------------------------------------------------------


def attn_block_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dev = gen.device
    return {
        "ln1": L.norm_init(cfg.d_model, cfg.norm_type, device=dev),
        "attn": L.attention_init(gen, cfg),
        "ln2": L.norm_init(cfg.d_model, cfg.norm_type, device=dev),
        "ffn": L.ffn_init(gen, cfg),
    }


def attn_block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                     window=None, cache: Optional[dict] = None, pos=None,
                     page_table=None, span_len=None, write_start=None,
                     bidir: bool = False, plan=None) -> torch.Tensor:
    """One decoder block; a paged cache is written in place.  Under a
    tensor-parallel ``plan`` the block's activations are whole on every
    rank between the sublayers (each ends in its row-parallel
    all-reduce)."""
    h = L.norm_apply(p["ln1"], x, cfg.norm_type)
    a, _ = L.attention_apply(
        p["attn"], h, cfg, window=window,
        cache=cache["attn"] if cache else None, pos=pos,
        page_table=page_table, span_len=span_len, write_start=write_start,
        bidir=bidir, backend=cfg.monarch.backend, plan=plan)
    x = x + a
    h = L.norm_apply(p["ln2"], x, cfg.norm_type)
    return x + L.ffn_apply(p["ffn"], h, cfg, backend=cfg.monarch.backend,
                           plan=plan)


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------


def layer_windows(cfg: ModelConfig) -> list[int]:
    return [cfg.window if cfg.attn_kind(i) == "local" else GLOBAL_WINDOW
            for i in range(cfg.n_layers)]


def decoder_stack_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    _check_ported(cfg)
    return {"layers": _stack([attn_block_init(gen, cfg)
                              for _ in range(cfg.n_layers)])}


def decoder_stack_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                        cache: Optional[dict] = None, pos=None,
                        page_table=None, span_len=None, write_start=None,
                        bidir: bool = False, train: bool = False,
                        plan=None):
    """Loops the stacked layers; returns (x, cache, aux).  A paged cache is
    updated in place and returned as given."""
    _check_ported(cfg)
    for i, win in enumerate(layer_windows(cfg)):
        p = layer_params(params["layers"], i)
        c = layer_params(cache["layers"], i) if cache is not None else None
        x = attn_block_apply(
            p, x, cfg, window=win, cache=c, pos=pos, page_table=page_table,
            span_len=span_len, write_start=write_start, bidir=bidir,
            plan=plan)
    aux = {"lb_loss": torch.zeros((), dtype=torch.float32, device=x.device)}
    return x, cache, aux


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> dict:
    """Random parameters from ``seed``, generated on ``device``.  They
    match the reference's initializer in distribution, not in value."""
    _check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return {
        "embedding": L.embedding_init(gen, cfg),
        "decoder": decoder_stack_init(gen, cfg),
        "ln_f": L.norm_init(cfg.d_model, cfg.norm_type, device=dev),
    }


def forward(params: dict, batch: dict, cfg: ModelConfig, train: bool = True):
    """Full-sequence causal forward: (logits (B,S,Vp) fp32, aux)."""
    dtype = _dtype(cfg)
    x = L.embed(params["embedding"], batch["tokens"], cfg, dtype)
    x, _, aux = decoder_stack_apply(params["decoder"], x, cfg, train=train)
    x = L.norm_apply(params["ln_f"], x, cfg.norm_type)
    return L.unembed(params["embedding"], x, cfg), aux


# ---- paged serving (continuous batching) ----------------------------------


def init_paged_pool(cfg: ModelConfig, n_pages: int, page_size: int,
                    kv_dtype: Optional[str] = None,
                    device: DeviceLike = None,
                    n_kv_heads: Optional[int] = None) -> dict:
    """Paged KV pool for the whole stack, stacked on a leading layer axis:
    {"layers": {"attn": {"k_pages": (L, P, page, KV, hd), "v_pages": ...}}}.
    Page 0 is the sink page — free slots' page tables point at it.
    ``kv_dtype="int8"`` adds ``k_scales``/``v_scales`` (L, P, KV) fp32, one
    scale per (page, kv_head), with the page axis at 1 like the pages.
    ``n_kv_heads``: the KV heads this rank holds (``serving.device_kv``;
    default all)."""
    _check_ported(cfg)
    one = L.paged_cache_init(cfg, n_pages, page_size, _dtype(cfg),
                             kv_dtype=kv_dtype, device=resolve_device(device),
                             n_kv_heads=n_kv_heads)
    return {"layers": {"attn": {
        name: a.new_zeros((cfg.n_layers, *a.shape)) for name, a in one.items()
    }}}


def cow_copy_pages(pool: dict, src: torch.Tensor, dst: torch.Tensor) -> dict:
    """Device half of a copy-on-write fork: copy whole pages ``src[i]`` ->
    ``dst[i]`` in every layer's page arrays (page axis 1), in place; an
    int8 pool's scale rows share that axis, so page bytes and scales are
    copied together and the fork dequantizes to the source's values.  The
    right-hand side is gathered before any write, so every source is read
    before a destination is written; sink-onto-sink padding entries are a
    no-op by value."""
    src, dst = src.long(), dst.long()

    def copy(a):
        a[:, dst] = a[:, src]
        return a

    return tree_map(copy, pool)


def paged_mixed_step(params: dict, tokens: torch.Tensor, start: torch.Tensor,
                     span_len: torch.Tensor, page_table: torch.Tensor,
                     pool: dict, cfg: ModelConfig,
                     write_start: Optional[torch.Tensor] = None, plan=None):
    """ONE unified engine iteration: every row contributes a variable-length
    token span (a prefill chunk or a single decode token).

    tokens: (B, S) right-padded spans; row ``b``'s token ``i`` sits at
    position ``start[b] + i`` and is real iff ``i < span_len[b]``.  Real
    positions write k/v through ``page_table`` into the pool, in place;
    padding positions and positions below ``write_start`` go to the sink
    page.  Returns (fp32 logits at each row's last real position (B, Vp),
    the same pool).

    Under tensor parallelism (``plan``, a ``sharding.params.TPPlan``)
    ``params`` and ``pool`` are this rank's shards
    (``sharding.params.shard_params``, ``serving.device_kv.DeviceKV``);
    every rank calls this with the same host inputs, and the logits come
    out whole and equal on every rank."""
    dtype = _dtype(cfg)
    x = L.embed(params["embedding"], tokens, cfg, dtype, plan=plan)
    x, pool, _ = decoder_stack_apply(
        params["decoder"], x, cfg, cache=pool, pos=start,
        page_table=page_table, span_len=span_len, write_start=write_start,
        plan=plan)
    x = L.norm_apply(params["ln_f"], x, cfg.norm_type)
    idx = (torch.clamp(span_len.long(), min=1) - 1)[:, None, None]
    xl = torch.gather(x, 1, idx.expand(-1, 1, x.shape[-1]))  # (B,1,d)
    logits = L.unembed(params["embedding"], xl, cfg, plan=plan)
    return logits[:, 0], pool


__all__ = [
    "init_params", "forward", "init_paged_pool", "paged_mixed_step",
    "cow_copy_pages", "decoder_stack_init", "decoder_stack_apply",
    "attn_block_init", "attn_block_apply", "layer_params", "layer_windows",
]
