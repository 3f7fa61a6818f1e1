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
On a mesh with ``data > 1`` each data rank calls them on its own rows
(:func:`shard_batch`) and a decode cache of those rows, as the
reference's ``cache_shardings`` puts the batch on ``"data"``; only the
model group's collectives run.

``make_train_step`` returns ``(init_state, train_step)``: the state is
{"params": fp32 masters, "opt": ``optim.AdamWState``, and with gradient
compression "ef": the error-feedback residuals}; a step takes a batch
of numpy arrays or tensors, moves it to the parameters' device, and
returns (new state, metrics).  The gradient is the reference's
``jax.value_and_grad`` of ``transformer.loss_fn`` through
``_compute_cast``: the bf16 copies' gradients land on the fp32 masters.
The step is eager and functional (nothing is updated in place; the
caller drops the old state, where the reference donates it).

**Under a ``("data", "model")`` mesh** (``make_train_step(mesh=)``) the
state is this rank's shards (``sharding.params``: the ``"model"`` part
of each leaf, then its FSDP part over ``"data"``; the moments and the
error feedback mirror the masters) and the batch this rank's rows
(:func:`shard_batch` cuts them from a global batch).  A step gathers the
FSDP shards of the whole tree over the data group
(``sharding.api.gather_scatter``), computes the loss and gradients on
its rows under the tensor-parallel plan (the loss is the whole batch's
on every rank: ``transformer.loss_fn(plan=)``), and autograd
reduce-scatters each gradient back to its shard (a leaf whole over
``"data"`` is all-reduced: ``copy_to``); the update is elementwise on
the shards, the global norm and the compression scale summed and maxed
over each leaf's shards, once per leaf.  The result is the
single-process step on the global batch, as the reference's GSPMD step
is.  :func:`train_shardings` is the reference's answer for the same
placement: each state leaf's ``"model"`` and ``"data"`` split, the
batch's row split, and the state and batch as meta tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import DeviceLike, tree_map
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, apply_updates
from repro_torch.optim.adamw import AdamWState, Optimizer, leaves_with_paths
from repro_torch.sharding import api
from repro_torch.sharding import params as SP


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


def value_and_grad(cfg: ModelConfig, plan=None, table=None):
    """``loss_and_grads(params, batch) -> (loss, aux, grads)``: the
    reference's ``jax.value_and_grad(loss_of, has_aux=True)`` over the
    fp32 masters, ``loss_of(p) = loss_fn(_compute_cast(p, cfg), batch,
    cfg)``.  ``grads`` has the parameters' layout and dtypes; a leaf the
    loss does not reach gets zeros.  ``loss`` and ``aux`` are detached.
    Under a mesh's ``plan`` (with ``table``, the leaves' placements) the
    params are this rank's shards and so are the grads, summed over the
    data group (module docstring)."""
    def loss_and_grads(params, batch):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            whole = p if plan is None else gather_fsdp(p, plan, table)
            loss, aux = T.loss_fn(_compute_cast(whole, cfg), batch, cfg,
                                  plan=plan)
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


def _joined(mesh) -> None:
    if mesh.group is None and mesh.world > 1:
        raise ValueError(
            "the mesh has no process group (a shape alone): join the world "
            "with launch.mesh.make_host_mesh")
    shape_only = any(isinstance(g, api.ShapeGroup)
                     for g in (mesh.group, mesh.data_group))
    if shape_only and mesh.device.type != "meta":
        raise ValueError(
            f"a mesh of shape-only groups traces meta tensors only, not "
            f"{mesh.device} (launch.mesh.shape_mesh)")


def train_plan(cfg: ModelConfig, mesh) -> tuple:
    """(tensor-parallel plan, {path: LeafPlacement}) of ``cfg``'s
    parameters on ``mesh``, from their shapes alone."""
    shapes = T.param_shapes(cfg)
    plan = SP.tp_plan(shapes, cfg, mesh)
    return plan, SP.placements(shapes, plan)


def gather_fsdp(params, plan, table) -> dict:
    """The rank's ``"model"`` parts, whole over ``"data"``: each FSDP
    shard all-gathered over the data group (its gradient reduce-scattered
    back), each leaf whole over ``"data"`` marked so that its gradient is
    the data ranks' sum.  The whole tree, leaf by leaf in key order."""
    mesh = plan.mesh

    def go(node, prefix):
        if isinstance(node, dict):
            return {k: go(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in node.items()}
        pl = table[prefix]
        if pl.fsdp is not None:
            return api.gather_scatter(node, mesh.data_group, pl.fsdp)
        return api.copy_to(node, mesh.data_group) if mesh.data > 1 else node

    return go(params, "")


def _placed(params, table) -> list:
    """Each leaf's placement in the optimizer's sorted leaf order."""
    return [table["/".join(path)] for path, _ in leaves_with_paths(params)]


def leaf_reductions(plan, order: list):
    """(leaf_sums, leaf_max) for a mesh step, over the leaves in sorted
    order: ``leaf_sums(shards)``, each whole leaf's sum of squares, and
    ``leaf_max(values)``, the max over each leaf's shards of a value a
    shard.  A sum counts every element once: what a model or data rank
    holds whole (a leaf, or the whole parts of a partly split leaf: a
    Mamba conv's B and C) is counted on rank 0 of that axis alone."""
    mesh = plan.mesh
    mr, dr = mesh.model_rank, mesh.data_rank

    def groups():
        if mesh.model > 1:
            yield mesh.group
        if mesh.data > 1:
            yield mesh.data_group

    def own_sq(g, pl):
        """This rank's count of a shard's squares."""
        if pl.fsdp is None and dr != 0:
            return g.new_zeros((), dtype=torch.float32)
        if pl.tp is None:
            return (torch.sum(torch.square(g.float())) if mr == 0
                    else g.new_zeros((), dtype=torch.float32))
        ax, parts = pl.tp
        if all(split for _, split in parts):
            return torch.sum(torch.square(g.float()))
        total, at = g.new_zeros((), dtype=torch.float32), 0
        for w, split in parts:
            n = w // plan.tp if split else w
            if split or mr == 0:
                total = total + torch.sum(torch.square(
                    g.narrow(ax, at, n).float()))
            at += n
        return total

    def leaf_sums(shards):
        v = torch.stack([own_sq(g, pl) for g, pl in zip(shards, order)])
        for g in groups():
            v = api.reduce_stats(v, g, "sum")
        return list(v.unbind())

    def leaf_max(mx):
        v = torch.stack([t.float() for t in mx])
        for g in groups():
            v = api.reduce_stats(v, g, "max")
        return list(v.unbind())

    return leaf_sums, leaf_max


def shard_batch(batch: dict, mesh, accum_steps: int = 1) -> dict:
    """This data rank's rows of a global batch, such that the mesh step
    on them is the single-process step on ``batch``: of each of the
    ``accum_steps`` microbatches (the rows' consecutive blocks), the
    rank's share, ``data`` ways in rank order.  Every rank of a model
    group takes the same rows."""
    data, d = mesh.data, mesh.data_rank
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % (accum_steps * data):
            raise ValueError(f"{k}: {B} rows do not split into "
                             f"{accum_steps} microbatches x {data} ranks")
        m, r = B // accum_steps, B // accum_steps // data
        rows = [v[i * m + d * r:i * m + (d + 1) * r]
                for i in range(accum_steps)]
        out[k] = rows[0] if accum_steps == 1 else (
            torch.cat(rows) if isinstance(v, torch.Tensor)
            else np.concatenate(rows))
    return out


def make_train_step(cfg: ModelConfig, optimizer: Optional[Optimizer] = None,
                    accum_steps: int = 1, compress_grads: bool = False,
                    mesh=None):
    """``accum_steps > 1`` splits the batch's leading axis into that many
    microbatches, sums their fp32 gradients and averages them before the
    optimizer's update (the reference scans them); ``compress_grads``
    applies int8 error-feedback compression to the gradients
    (``ft.compression``).  Returns ``(init_state, train_step)``:
    ``init_state(seed=0, device=None, params=None)`` draws the parameters
    from ``seed`` on ``device`` (``cuda`` unless the CPU is asked for), or
    starts from ``params``; ``train_step(state, batch) -> (state,
    metrics)``, metrics {"lr", "grad_norm" (when clipping), "loss",
    "lb_loss"} as 0-d tensors.

    Under ``mesh`` (a joined ``launch.mesh.Mesh``) the state is this
    rank's shards on the mesh's device: ``init_state`` draws them as
    they are made (``transformer.init_params(plan=)``) or cuts them from
    a whole ``params`` tree, and ``train_step`` takes this rank's rows
    (:func:`shard_batch`) and returns the whole batch's metrics on every
    rank (module docstring)."""
    optimizer = optimizer or adamw(lr=3e-4)
    plan = table = None
    leaf_sums = leaf_max = None
    if mesh is not None:
        _joined(mesh)
        plan, table = train_plan(cfg, mesh)
        leaf_sums, leaf_max = leaf_reductions(
            plan, _placed(T.param_shapes(cfg), table))
    grads_of = value_and_grad(cfg) if mesh is None \
        else value_and_grad(cfg, plan, table)

    def init_state(seed: int = 0, device: DeviceLike = None, params=None):
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            params = (T.init_params(cfg, seed=seed, device=mesh.device,
                                    plan=plan) if params is None
                      else SP.shard_train_params(params, plan, table))
        elif params is None:
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
            grads, new_state["ef"] = compressed_gradients(
                grads, state["ef"], leaf_max=leaf_max)

        kw = {} if mesh is None else {"leaf_sums": leaf_sums}
        updates, opt, metrics = optimizer.update(grads, state["opt"], params,
                                                 **kw)
        new_state.update(params=apply_updates(params, updates), opt=opt)
        metrics = dict(metrics, loss=loss, lb_loss=lb)
        return new_state, metrics

    return init_state, train_step


@dataclasses.dataclass(frozen=True)
class TrainShardings:
    """``train_shardings``' answer: ``state`` -- each train-state leaf's
    placement ({"params": {path: LeafPlacement}, "opt": AdamWState(step
    None: whole on every rank, mu and nu the params')}); ``batch`` --
    each input's rows a data rank takes (None: whole on every rank, as
    the reference's guard leaves a batch the axis does not divide);
    ``state_shape`` / ``batch_shape`` -- the whole state and batch as
    meta tensors."""

    state: dict
    batch: dict
    state_shape: dict
    batch_shape: dict


def train_shardings(cfg: ModelConfig, mesh, shape: str) -> TrainShardings:
    """The port's ``repro.launch.steps.train_shardings``: where every
    leaf of ``make_train_step(mesh=)``'s state and of the ``shape``
    cell's batch (``configs.shapes``) lives on ``mesh`` (a mesh's shape
    alone will do)."""
    from repro_torch.configs.shapes import input_specs

    _, table = train_plan(cfg, mesh)
    meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"),
                    T.param_shapes(cfg))
    state_shape = {"params": meta, "opt": AdamWState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        mu=tree_map(torch.empty_like, meta),
        nu=tree_map(torch.empty_like, meta))}

    def placed(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: placed(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in tree.items()}
        return table[prefix]

    pl = placed(meta)
    state = {"params": pl, "opt": AdamWState(step=None, mu=pl, nu=pl)}
    batch_shape = input_specs(cfg, shape)
    batch = {k: (v.shape[0] // mesh.data if v.shape[0] % mesh.data == 0
                 else None) for k, v in batch_shape.items()}
    return TrainShardings(state, batch, state_shape, batch_shape)


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


__all__ = ["make_train_step", "value_and_grad", "batch_to", "shard_batch",
           "train_shardings", "TrainShardings", "train_plan", "gather_fsdp",
           "make_prefill_step", "make_decode_step"]
