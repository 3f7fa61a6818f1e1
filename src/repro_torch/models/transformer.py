"""Model assembly: decoder stacks, hybrid (Zamba2) groups, encoder-decoder
(port of ``repro.models.transformer``).

Parameters keep the reference's pytree layout: nested dicts with the same
keys, every decoder leaf stacked on a leading layer axis
(``decoder/layers/...`` has shape ``(n_layers, ...)``).  Where the
reference scans that axis, the port loops over it.

Public API:
  init_params(cfg, seed, device, plan=None)       -> params (a rank's
                                                     shards under a plan)
  forward(params, batch, cfg, train=True)         -> (logits, aux)
  loss_fn(params, batch, cfg, plan=None)          -> (loss, aux)
  init_decode_cache(cfg, batch, max_len, device)  -> cache (the ring and
                                                     the Mamba states)
  decode_step(params, tokens, cache, cfg, enc_out=None) -> (logits, cache)
  prefill(params, batch, cfg)                     -> last-position logits
  prefill_with_cache(params, tokens, cache, cfg)  -> (logits, cache)
  init_paged_pool(cfg, n_pages, page_size, ...)   -> pool
  cow_copy_pages(pool, src, dst)                  -> pool (in place)
  paged_mixed_step(params, tokens, start, span_len, page_table, pool, cfg)
                                                  -> (logits, pool)

The ring cache, the Mamba states and the paged pool are written in
place: the reference donates them to its jitted steps.  A block may carry
gemma2's sandwich norms (``ln1_post`` / ``ln2_post`` on each sublayer's
output) and a mixture-of-experts FFN (``moe``) in place of ``ffn``; the
stack's ``aux`` holds the MoE load-balance loss, averaged over the layers
as the reference does.

Besides attention stacks the port has the reference's other families:
Mamba2 stacks (``layer_kind="mamba"``, ``models/mamba2.py``), Zamba2
hybrids (``"hybrid"``: groups of ``shared_attn_every`` Mamba layers, each
group followed by ONE shared attention block whose parameters every group
reuses while each group keeps its own ring, then a tail of the leftover
Mamba layers), encoder-decoder models (``encdec``: a bidirectional
encoder over ``enc_embeds``, the stubbed audio frontend, or
``enc_tokens``, and a cross-attention sublayer ``xattn`` in every decoder
block) and the stubbed vision frontend (``patch_embeds`` prepended to the
text and cut off again).  Cross-attention recomputes its K and V from
``enc_out`` at every call, the decode step's included, as the reference
does; with ``enc_out=None`` (the engines' text stream) it attends the
block's own tokens, causally, as the reference's does.

Training (``forward(train=True)``, ``loss_fn``) checkpoints each layer,
or each hybrid group, as ``cfg.remat`` asks, where the reference
``jax.checkpoint``s its scan bodies (``_maybe_remat``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch import DeviceLike, resolve_device, tree_map
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.config import ModelConfig

GLOBAL_WINDOW = L.GLOBAL_WINDOW


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i``'s slice of a stacked tree (views, no copies)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


# ---------------------------------------------------------------------------
# One decoder block (attention mixer + FFN/MoE)
# ---------------------------------------------------------------------------


def attn_block_init(gen: torch.Generator, cfg: ModelConfig,
                    cross: bool = False) -> dict:
    dev = gen.device
    p = {
        "ln1": L.norm_init(cfg.d_model, cfg.norm_type, device=dev),
        "attn": L.attention_init(gen, cfg),
        "ln2": L.norm_init(cfg.d_model, cfg.norm_type, device=dev),
    }
    if cfg.moe is not None:
        p["moe"] = L.moe_init(gen, cfg)
    else:
        p["ffn"] = L.ffn_init(gen, cfg)
    if cfg.sandwich_norm:
        p["ln1_post"] = L.norm_init(cfg.d_model, cfg.norm_type, device=dev)
        p["ln2_post"] = L.norm_init(cfg.d_model, cfg.norm_type, device=dev)
    if cross:
        p["ln_x"] = L.norm_init(cfg.d_model, cfg.norm_type, device=dev)
        # its K and V read enc_out, its q the decoder stream: never a
        # fused QKV projection
        p["xattn"] = L.attention_init(
            gen, dataclasses.replace(cfg, fused_proj=False))
    return p


def attn_block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                     window=None, cache: Optional[dict] = None, pos=None,
                     page_table=None, span_len=None, write_start=None,
                     enc_out=None, bidir: bool = False, plan=None,
                     aux: Optional[dict] = None) -> torch.Tensor:
    """One decoder block; a paged cache is written in place.  Under a
    tensor-parallel ``plan`` the block's activations are whole on every
    rank between the sublayers (each ends in its row-parallel
    all-reduce).  An MoE block adds its load-balance loss to
    ``aux["lb_loss"]`` when ``aux`` is given.  A block with ``xattn``
    cross-attends ``enc_out`` (every key visible, no RoPE) after its
    self-attention; with ``enc_out=None`` that sublayer attends the
    block's own tokens, as the reference's does.  Under a plan the
    cross-attention splits its heads as the self-attention does and an
    MoE block runs its slots of the experts (``layers.moe_apply``)."""
    h = L.norm_apply(p["ln1"], x, cfg.norm_type)
    a, _ = L.attention_apply(
        p["attn"], h, cfg, window=window,
        cache=cache["attn"] if cache else None, pos=pos,
        page_table=page_table, span_len=span_len, write_start=write_start,
        bidir=bidir, backend=cfg.monarch.backend, plan=plan)
    if cfg.sandwich_norm:
        a = L.norm_apply(p["ln1_post"], a, cfg.norm_type)
    x = x + a
    if "xattn" in p:
        h = L.norm_apply(p["ln_x"], x, cfg.norm_type)
        a, _ = L.attention_apply(p["xattn"], h, cfg, kv_input=enc_out,
                                 backend=cfg.monarch.backend, plan=plan)
        x = x + a
    h = L.norm_apply(p["ln2"], x, cfg.norm_type)
    if "moe" in p:
        f, moe_aux = L.moe_apply(p["moe"], h, cfg,
                                 backend=cfg.monarch.backend,
                                 lb_loss=aux is not None, plan=plan)
        if aux is not None:
            aux["lb_loss"] = aux["lb_loss"] + moe_aux["lb_loss"]
    else:
        f = L.ffn_apply(p["ffn"], h, cfg, backend=cfg.monarch.backend,
                        plan=plan)
    if cfg.sandwich_norm:
        f = L.norm_apply(p["ln2_post"], f, cfg.norm_type)
    return x + f


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------


def layer_windows(cfg: ModelConfig) -> list[int]:
    return [cfg.window if cfg.attn_kind(i) == "local" else GLOBAL_WINDOW
            for i in range(cfg.n_layers)]


def _mamba_layer(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 cache: Optional[dict], plan=None) -> torch.Tensor:
    h = L.norm_apply(p["ln"], x, cfg.norm_type)
    y, _ = M.mamba_apply(p["mamba"], h, cfg, cache=cache,
                         backend=cfg.monarch.backend, plan=plan)
    return x + y


def _mamba_layer_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {"ln": L.norm_init(cfg.d_model, cfg.norm_type, device=gen.device),
            "mamba": M.mamba_init(gen, cfg)}


def hybrid_groups(cfg: ModelConfig) -> tuple[int, int]:
    """A hybrid stack's (groups of ``shared_attn_every`` Mamba layers,
    leftover tail layers)."""
    n_groups = cfg.n_layers // cfg.shared_attn_every
    return n_groups, cfg.n_layers - n_groups * cfg.shared_attn_every


def _keep_all(prefix: str, tree: dict) -> dict:
    return tree


def decoder_stack_init(gen: torch.Generator, cfg: ModelConfig,
                       cross: bool = False, keep=_keep_all,
                       prefix: str = "decoder") -> dict:
    """The stack's parameters, drawn layer by layer; ``keep(path,
    layer_tree)`` cuts each layer (or the shared block) to what this rank
    keeps as soon as it is drawn (``init_params(plan=)``)."""
    if cfg.layer_kind in ("attn", "mamba"):
        one = (lambda: attn_block_init(gen, cfg, cross)) \
            if cfg.layer_kind == "attn" else \
            (lambda: _mamba_layer_init(gen, cfg))
        return {"layers": L.stack_trees([keep(f"{prefix}/layers", one())
                                         for _ in range(cfg.n_layers)])}
    # hybrid (Zamba2): (n_groups, g, ...) Mamba layers, one shared block
    g = cfg.shared_attn_every
    n_groups, tail = hybrid_groups(cfg)
    p = {"groups": L.stack_trees([
        L.stack_trees([keep(f"{prefix}/groups", _mamba_layer_init(gen, cfg))
                       for _ in range(g)])
        for _ in range(n_groups)]),
        "shared_attn": keep(f"{prefix}/shared_attn",
                            attn_block_init(gen, cfg))}
    if tail:
        p["tail"] = L.stack_trees([keep(f"{prefix}/tail",
                                        _mamba_layer_init(gen, cfg))
                                   for _ in range(tail)])
    return p


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``:
    keep the outputs of products with no batch dimension (``mm`` /
    ``addmm``: the dense projections, the LM head), recompute everything
    else, the batched products included (the Monarch stages and the
    attention einsums run as ``bmm``)."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_dots_policy)


def _maybe_remat(fn, cfg: ModelConfig, train: bool):
    """The reference's ``_maybe_remat``: ``fn`` under activation
    checkpointing as ``cfg.remat`` asks -- ``"full"`` keeps only its
    inputs and recomputes the rest in the backward pass, ``"dots"`` keeps
    the unbatched products' outputs too (:func:`_dots_policy`); anything
    else, ``train=False`` or grad mode off leaves ``fn`` as it is.  It
    changes memory, not values."""
    if not train or not torch.is_grad_enabled():
        return fn
    from torch.utils.checkpoint import checkpoint

    if cfg.remat == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     preserve_rng_state=False)
    if cfg.remat == "dots":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     preserve_rng_state=False,
                                     context_fn=_dots_context)
    return fn


def decoder_stack_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                        cache: Optional[dict] = None, pos=None,
                        page_table=None, span_len=None, write_start=None,
                        enc_out=None, bidir: bool = False,
                        train: bool = False, plan=None,
                        aux_loss: bool = True):
    """Loops the stacked layers; returns (x, cache, aux), ``aux`` holding
    the MoE load-balance loss summed over the layers over ``n_layers`` (0
    for a dense, Mamba or hybrid stack).  ``aux_loss=False`` (the serving
    steps, which drop it as the reference's jitted steps do) computes no
    loss and returns an empty ``aux``.  A cache (the ring and the Mamba
    states, or a paged pool) is updated in place and returned as
    given.  Without a cache and with ``train``, each attention or Mamba
    layer, and each hybrid group (its Mamba layers and the shared block),
    is checkpointed as ``cfg.remat`` asks (:func:`_maybe_remat`), where
    the reference remats its scan bodies.  Under a tensor-parallel
    ``plan`` every branch runs this rank's shards (``params`` and the
    cache as ``sharding.params`` and ``init_decode_cache`` lay them out)
    and returns whole activations."""
    aux = ({"lb_loss": torch.zeros((), dtype=torch.float32,
                                   device=x.device)} if aux_loss else None)
    remat = train and cache is None
    if cfg.layer_kind == "attn":
        def block(h, p, win):
            la = None if aux is None else {"lb_loss": torch.zeros_like(
                aux["lb_loss"])}
            h = attn_block_apply(p, h, cfg, window=win, enc_out=enc_out,
                                 bidir=bidir, plan=plan, aux=la)
            return h, None if la is None else la["lb_loss"]

        block = _maybe_remat(block, cfg, remat)
        for i, win in enumerate(layer_windows(cfg)):
            p = layer_params(params["layers"], i)
            if cache is None:
                x, lb = block(x, p, win)
                if aux is not None:
                    aux["lb_loss"] = aux["lb_loss"] + lb
                continue
            x = attn_block_apply(
                p, x, cfg, window=win, cache=layer_params(cache["layers"], i),
                pos=pos, page_table=page_table, span_len=span_len,
                write_start=write_start, enc_out=enc_out, bidir=bidir,
                plan=plan, aux=aux)
        if aux is not None:
            aux["lb_loss"] = aux["lb_loss"] / cfg.n_layers
    elif cfg.layer_kind == "mamba":
        layer = _maybe_remat(_mamba_layer, cfg, remat)
        for i in range(cfg.n_layers):
            x = layer(
                layer_params(params["layers"], i), x, cfg,
                None if cache is None else layer_params(cache["layers"], i),
                plan)
    else:
        # hybrid: each group's Mamba layers, then the ONE shared block
        # (global attention) over that group's own ring; then the tail
        n_groups, _ = hybrid_groups(cfg)
        shared = params["shared_attn"]

        def group(h, gp, gc):
            for j in range(cfg.shared_attn_every):
                h = _mamba_layer(
                    layer_params(gp, j), h, cfg,
                    None if gc is None else layer_params(gc["mamba"], j),
                    plan)
            return attn_block_apply(
                shared, h, cfg, window=None,
                cache=None if gc is None else {"attn": gc["attn"]}, pos=pos,
                plan=plan)

        group = _maybe_remat(group, cfg, remat)
        for gi in range(n_groups):
            x = group(x, layer_params(params["groups"], gi),
                      None if cache is None
                      else layer_params(cache["groups"], gi))
        for i in range(hybrid_groups(cfg)[1]):
            x = _mamba_layer(
                layer_params(params["tail"], i), x, cfg,
                None if cache is None else layer_params(cache["tail"], i),
                plan)
    return x, cache, ({} if aux is None else aux)


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder's configuration: ``n_enc_layers`` attention blocks with
    dense FFNs."""
    return dataclasses.replace(cfg, n_layers=cfg.n_enc_layers, moe=None,
                               layer_kind="attn")


@functools.lru_cache(maxsize=16)
def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's leaves as fake tensors (shapes and dtypes;
    nothing is drawn or held).  Cached: read it, never write to it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return init_params(cfg, seed=0, device="cpu")


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None, plan=None) -> dict:
    """Random parameters from ``seed``, generated on ``device``.  They
    match the reference's initializer in distribution, not in value.

    Under a ``plan`` (``sharding.params.TPPlan``) the tree is this rank's
    shards: every leaf is drawn in the same order as without one, and each
    layer (the embedding, each stacked layer, the final norms) is cut to
    the rank's ``"model"`` part and then its ``"data"`` part as soon as
    it is drawn (``sharding.params.keep_parts``), so the rank holds its
    shards plus one layer's whole leaves at most; each shard is
    ``torch.equal`` to the slice of the whole draw."""
    dev = resolve_device(device)
    keep = _keep_all
    if plan is not None:
        from repro_torch.sharding.params import keep_parts, placements

        table = placements(param_shapes(cfg), plan)

        def keep(prefix, tree):
            return keep_parts(tree, prefix, table, plan)

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    p = {
        "embedding": keep("embedding", L.embedding_init(gen, cfg)),
        "decoder": decoder_stack_init(gen, cfg, cross=cfg.encdec, keep=keep),
        "ln_f": keep("ln_f", L.norm_init(cfg.d_model, cfg.norm_type,
                                         device=dev)),
    }
    if cfg.encdec:
        p["encoder"] = decoder_stack_init(gen, _enc_cfg(cfg), keep=keep,
                                          prefix="encoder")
        p["ln_enc"] = keep("ln_enc", L.norm_init(cfg.d_model, cfg.norm_type,
                                                 device=dev))
    return p


def _encode(params: dict, batch: dict, cfg: ModelConfig,
            train: bool = False, plan=None) -> torch.Tensor:
    """The encoder pass (bidirectional).  The audio frontend is a stub:
    the batch carries precomputed frame embeddings (``enc_embeds``), or
    else ``enc_tokens`` are embedded.  Under a plan the encoder's heads
    and FFN split as the decoder's, and ``enc_out`` comes out whole on
    every rank."""
    dtype = _dtype(cfg)
    if "enc_embeds" in batch:
        h = batch["enc_embeds"].to(dtype)
    else:
        h = L.embed(params["embedding"], batch["enc_tokens"], cfg, dtype,
                    plan=plan)
    h, _, _ = decoder_stack_apply(params["encoder"], h, _enc_cfg(cfg),
                                  bidir=True, train=train, plan=plan,
                                  aux_loss=False)
    return L.norm_apply(params["ln_enc"], h, cfg.norm_type)


def forward(params: dict, batch: dict, cfg: ModelConfig, train: bool = True,
            plan=None):
    """Full-sequence causal forward: (logits (B,S,Vp) fp32, aux).  A
    vision frontend's ``patch_embeds`` (B, n, d) are prepended to the
    text and their positions cut off the output; an encoder-decoder model
    encodes ``enc_embeds`` or ``enc_tokens`` first.  Under a plan
    ``params`` are this rank's shards and the logits come out whole."""
    dtype = _dtype(cfg)
    x = L.embed(params["embedding"], batch["tokens"], cfg, dtype, plan=plan)
    n_front = 0
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        n_front = batch["patch_embeds"].shape[1]
        x = torch.cat([batch["patch_embeds"].to(dtype), x], dim=1)
    enc_out = _encode(params, batch, cfg, train, plan) if cfg.encdec \
        else None
    x, _, aux = decoder_stack_apply(params["decoder"], x, cfg,
                                    enc_out=enc_out, train=train, plan=plan)
    if n_front:
        x = x[:, n_front:, :]
    x = L.norm_apply(params["ln_f"], x, cfg.norm_type)
    return L.unembed(params["embedding"], x, cfg, plan=plan), aux


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, plan=None):
    """The training loss of a batch {"tokens", "labels"[, "loss_mask"],
    the frontends' inputs}: the masked next-token cross-entropy of
    ``forward(train=True)`` (activation checkpointing as ``cfg.remat``
    asks), plus 0.01 x the load-balance loss for an MoE model.  Returns
    (loss, aux).  Under a ``plan`` the params are this rank's
    ``"model"`` parts and the batch its rows of a ``"data"`` split: the
    cross-entropy's sum and count and the load-balance loss's means are
    the whole batch's, so every rank returns the whole batch's loss."""
    logits, aux = forward(params, batch, cfg, train=True, plan=plan)
    loss = L.cross_entropy(logits, batch["labels"], batch.get("loss_mask"),
                           data_group=None if plan is None
                           else plan.mesh.data_group)
    if cfg.moe is not None:
        loss = loss + 0.01 * aux["lb_loss"]
    return loss, aux


# ---- serving through the ring cache (the legacy ServeEngine) --------------


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device: DeviceLike = None, plan=None) -> dict:
    """The decode cache, zeros, in the reference's layout: an attention
    stack's ring {"layers": {"attn": {"k": (L, B, max_len, KV, hd), "v":
    ...}}} (K and V in the model dtype); a Mamba stack's states
    {"layers": {"conv": (L, B, d_conv - 1, conv_dim) fp32, "ssm": (L, B,
    H, P, N) fp32}} (``mamba2.mamba_cache_init``: the conv state is
    stored wide and read at its window's dtype); a hybrid's {"groups":
    {"mamba": (n_groups, g, ...) states, "attn": (n_groups, ...) rings},
    "tail": (tail, ...) states}; and "pos" (B,) int32.

    Under a tensor-parallel ``plan`` (the port of the reference's
    ``cache_shardings``) each leaf is this rank's: a ring holds its
    ``KV / tp`` heads where the plan splits the KV heads, and all of them
    where it keeps them whole (never the reference's fallback of
    splitting the ring's sequence axis); a Mamba ``conv`` state holds the
    rank's ``x`` channels and ``B``/``C`` whole, its ``ssm`` state ``(B,
    H / tp, P, N)`` (``mamba2.mamba_cache_init``)."""
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    kv = cfg.n_kv_heads // (plan.tp if plan is not None and plan.kv_heads
                            else 1)

    def stacked(one: dict, prefix: tuple) -> dict:
        return {name: a.new_zeros((*prefix, *a.shape))
                for name, a in one.items()}

    def ring():
        return L.attention_cache_init(cfg, batch, max_len, dtype, device=dev,
                                      n_kv_heads=kv)

    if cfg.layer_kind == "attn":
        cache = {"layers": {"attn": stacked(ring(), (cfg.n_layers,))}}
    else:
        state = M.mamba_cache_init(cfg, batch, device=dev, plan=plan)
        if cfg.layer_kind == "mamba":
            cache = {"layers": stacked(state, (cfg.n_layers,))}
        else:
            n_groups, tail = hybrid_groups(cfg)
            cache = {"groups": {
                "mamba": stacked(state, (n_groups, cfg.shared_attn_every)),
                "attn": stacked(ring(), (n_groups,))}}
            if tail:
                cache["tail"] = stacked(state, (tail,))
    cache["pos"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
    return cache


def decode_step(params: dict, tokens: torch.Tensor, cache: dict,
                cfg: ModelConfig, enc_out=None, plan=None):
    """One new token per batch row (``tokens`` (B,)) against the running
    cache: its k/v rows are written at ``cache["pos"]``, the Mamba states
    advance, and ``pos`` advances by one, all in place.  An
    encoder-decoder model cross-attends ``enc_out`` (its K and V
    recomputed from it at every step, as in the reference).  Under a
    plan ``params`` and ``cache`` are this rank's shards
    (``init_decode_cache(plan=)``), ``enc_out`` is whole, and the logits
    come out whole on every rank.  Returns (fp32 logits (B, Vp), the
    same cache)."""
    dtype = _dtype(cfg)
    pos = cache["pos"]
    x = L.embed(params["embedding"], tokens[:, None], cfg, dtype, plan=plan)
    x, _, _ = decoder_stack_apply(params["decoder"], x, cfg, cache=cache,
                                  pos=pos, enc_out=enc_out, plan=plan,
                                  aux_loss=False)
    x = L.norm_apply(params["ln_f"], x, cfg.norm_type)
    logits = L.unembed(params["embedding"], x, cfg, plan=plan)
    pos.add_(1)
    return logits[:, 0], cache


def prefill(params: dict, batch: dict, cfg: ModelConfig,
            plan=None) -> torch.Tensor:
    """The last position's logits of a full causal forward (this rank's
    shards under a plan; the logits whole)."""
    logits, _ = forward(params, batch, cfg, train=False, plan=plan)
    return logits[:, -1]


def prefill_with_cache(params: dict, tokens: torch.Tensor, cache: dict,
                       cfg: ModelConfig):
    """The whole (B, S) prompt block in ONE forward through the ring:
    every layer writes its S k/v rows a row at ``pos`` (in place) and
    ``pos`` advances by S.  Attention stacks only (Mamba states advance a
    token at a time).  Returns (last-position fp32 logits (B, Vp), the
    same cache)."""
    if cfg.layer_kind != "attn":
        raise ValueError("batched cache prefill needs attn layers")
    S = tokens.shape[1]
    dtype = _dtype(cfg)
    pos = cache["pos"]
    x = L.embed(params["embedding"], tokens, cfg, dtype)
    x, _, _ = decoder_stack_apply(params["decoder"], x, cfg, cache=cache,
                                  pos=pos, aux_loss=False)
    x = L.norm_apply(params["ln_f"], x, cfg.norm_type)
    logits = L.unembed(params["embedding"], x[:, -1:], cfg)
    pos.add_(S)
    return logits[:, 0], cache


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
    default all).  Attention stacks only."""
    if cfg.layer_kind != "attn":
        raise ValueError("paged KV cache needs attn layers")
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
        plan=plan, aux_loss=False)
    x = L.norm_apply(params["ln_f"], x, cfg.norm_type)
    idx = (torch.clamp(span_len.long(), min=1) - 1)[:, None, None]
    xl = torch.gather(x, 1, idx.expand(-1, 1, x.shape[-1]))  # (B,1,d)
    logits = L.unembed(params["embedding"], xl, cfg, plan=plan)
    return logits[:, 0], pool


__all__ = [
    "init_params", "param_shapes", "forward", "loss_fn", "init_decode_cache", "decode_step",
    "prefill", "hybrid_groups",
    "prefill_with_cache", "init_paged_pool", "paged_mixed_step",
    "cow_copy_pages", "decoder_stack_init", "decoder_stack_apply",
    "attn_block_init", "attn_block_apply", "layer_params", "layer_windows",
]
