"""The train step and the serving steps (port of ``repro.launch.steps``).

``make_prefill_step`` and ``make_decode_step`` return the functions the
reference jits for its server: parameters are kept fp32 (the master copy)
and cast to the model's compute dtype at the top of each step
(``_compute_cast``: fp32 leaves to bf16 for a bf16 config).  The reference
lets XLA fuse those casts into their first consumers; here the cast is
one copy of the fp32 leaves a call.

The reference's prefill step returns the last position's logits only,
and its ``prefill_with_cache`` takes no ``enc_out``: an encoder-decoder
model is served by ``transformer._encode``, then its prompt token by
token through ``make_decode_step(cfg)(params, tok, cache, enc_out)``
into a ring, then the new tokens the same way.

Both serving steps take a tensor-parallel ``plan``
(``sharding.params.tp_plan``): the params are then this rank's shards
(``shard_params``) and the decode cache this rank's
(``transformer.init_decode_cache(plan=)``), every rank calls the step
with the same inputs and gets the same whole logits.  They are the
reference's tensor-parallel path for the Mamba, hybrid and
encoder-decoder stacks, as its legacy ``ServeEngine`` takes no mesh.

``make_train_step`` returns ``(init_state, train_step)``: the state is
{"params": fp32 masters, "opt": ``optim.AdamWState``, and with gradient
compression "ef": the error-feedback residuals}; a step takes a batch
of numpy arrays or tensors, moves it to the parameters' device, and
returns (new state, metrics).  The gradient is the reference's
``jax.value_and_grad`` of ``transformer.loss_fn`` through
``_compute_cast``: the bf16 copies' gradients land on the fp32 masters.
The step is eager and functional (nothing is updated in place; the
caller drops the old state, where the reference donates it).
``train_shardings`` is not ported: it needs the ``"data"`` axis.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import DeviceLike, tree_map
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, apply_updates
from repro_torch.optim.adamw import Optimizer, leaves_with_paths


def _compute_cast(params, cfg: ModelConfig):
    """fp32 leaves cast to bf16 for a bf16 config; any other leaf (an int8
    or int4 container's, a bf16 one) as it is."""
    if cfg.dtype != "bfloat16":
        return params

    def cast(p):
        return p.to(torch.bfloat16) if p.dtype == torch.float32 else p

    return tree_map(cast, params)


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------


def batch_to(batch: dict, device) -> dict:
    """A batch's arrays (numpy or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def value_and_grad(cfg: ModelConfig):
    """``loss_and_grads(params, batch) -> (loss, aux, grads)``: the
    reference's ``jax.value_and_grad(loss_of, has_aux=True)`` over the
    fp32 masters, ``loss_of(p) = loss_fn(_compute_cast(p, cfg), batch,
    cfg)``.  ``grads`` has the parameters' layout and dtypes; a leaf the
    loss does not reach gets zeros.  ``loss`` and ``aux`` are detached."""
    def loss_and_grads(params, batch):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, aux = T.loss_fn(_compute_cast(p, cfg), batch, cfg)
            paths = leaves_with_paths(p)
            gs = torch.autograd.grad(loss, [leaf for _, leaf in paths],
                                     allow_unused=True)
        by_path = {path: torch.zeros_like(leaf) if g is None else g
                   for (path, leaf), g in zip(paths, gs)}

        def pick(t, prefix=()):
            if isinstance(t, dict):
                return {k: pick(v, prefix + (k,)) for k, v in t.items()}
            return by_path[prefix]

        return (loss.detach(), tree_map(lambda t: t.detach(), aux),
                pick(params))

    return loss_and_grads


def make_train_step(cfg: ModelConfig, optimizer: Optional[Optimizer] = None,
                    accum_steps: int = 1, compress_grads: bool = False):
    """``accum_steps > 1`` splits the batch's leading axis into that many
    microbatches, sums their fp32 gradients and averages them before the
    optimizer's update (the reference scans them); ``compress_grads``
    applies int8 error-feedback compression to the gradients
    (``ft.compression``).  Returns ``(init_state, train_step)``:
    ``init_state(seed=0, device=None, params=None)`` draws the parameters
    from ``seed`` on ``device`` (``cuda`` unless the CPU is asked for), or
    starts from ``params``; ``train_step(state, batch) -> (state,
    metrics)``, metrics {"lr", "grad_norm" (when clipping), "loss",
    "lb_loss"} as 0-d tensors."""
    optimizer = optimizer or adamw(lr=3e-4)
    grads_of = value_and_grad(cfg)

    def init_state(seed: int = 0, device: DeviceLike = None, params=None):
        if params is None:
            params = T.init_params(cfg, seed=seed, device=device)
        state = {"params": params, "opt": optimizer.init(params)}
        if compress_grads:
            from repro_torch.ft.compression import compress_state_init
            state["ef"] = compress_state_init(params)
        return state

    def train_step(state, batch):
        params = state["params"]
        dev = leaves_with_paths(params)[0][1].device
        batch = batch_to(batch, dev)
        if accum_steps > 1:
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
            loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
            lbs = []
            for i in range(accum_steps):
                mb = {k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                                   *v.shape[1:])[i]
                      for k, v in batch.items()}
                loss, aux, grads = grads_of(params, mb)
                acc = tree_map(torch.add, acc, grads)
                loss_acc = loss_acc + loss
                if cfg.moe:
                    lbs.append(aux["lb_loss"])
            grads = tree_map(lambda g: g / accum_steps, acc)
            loss = loss_acc / accum_steps
            lb = (torch.sum(torch.stack(lbs)) / accum_steps if lbs
                  else torch.zeros((), dtype=torch.float32, device=dev))
        else:
            loss, aux, grads = grads_of(params, batch)
            lb = aux.get("lb_loss", 0.0)

        new_state = {}
        if compress_grads:
            from repro_torch.ft.compression import compressed_gradients
            grads, new_state["ef"] = compressed_gradients(grads, state["ef"])

        updates, opt, metrics = optimizer.update(grads, state["opt"], params)
        new_state.update(params=apply_updates(params, updates), opt=opt)
        metrics = dict(metrics, loss=loss, lb_loss=lb)
        return new_state, metrics

    return init_state, train_step


# ---------------------------------------------------------------------------
# Serve
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, plan=None):
    """``prefill_step(params, batch)`` -> the last position's fp32 logits
    (B, Vp) of a full forward (``transformer.prefill``), on this rank's
    shards under ``plan``."""
    def prefill_step(params, batch):
        return T.prefill(_compute_cast(params, cfg), batch, cfg, plan=plan)

    return prefill_step


def make_decode_step(cfg: ModelConfig, plan=None):
    """``decode_step(params, tokens, cache, enc_out=None)`` -> (fp32 logits
    (B, Vp), the cache advanced in place); an encoder-decoder model
    cross-attends ``enc_out`` (whole on every rank under ``plan``)."""
    def decode_step(params, tokens, cache, enc_out=None):
        p = _compute_cast(params, cfg)
        if cfg.encdec:
            return T.decode_step(p, tokens, cache, cfg, enc_out=enc_out,
                                 plan=plan)
        return T.decode_step(p, tokens, cache, cfg, plan=plan)

    return decode_step


__all__ = ["make_train_step", "value_and_grad", "batch_to",
           "make_prefill_step", "make_decode_step"]
