"""AdamW with decoupled weight decay and global-norm clipping (port of
``repro.optim.adamw``).

Functional, as the reference's optax-style optimizer is:
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state, metrics)``, over the port's nested dicts of tensors.  Nothing is
updated in place; ``apply_updates`` returns new parameters.  Leaves are
visited in sorted key order, the order ``jax.tree_util`` flattens the same
dicts in, so the global norm sums its leaves in the reference's order.

``decay_mask(path, leaf) -> bool`` receives the leaf's path as a tuple of
its dict keys, outermost first (``("decoder", "layers", "attn", "wq",
"L")``): the keys of the reference's path, without JAX's key objects.

Under a ``("data", "model")`` mesh the grads, moments and params are a
rank's shards and every update is elementwise on them; only the global
norm spans ranks: ``update(..., leaf_sums=f)`` takes ``f``, which maps
the gradient shards (in the leaves' sorted order) to each whole leaf's
sum of squares, every element counted once (``launch.steps``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch import tree_map

class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def leaves_with_paths(tree, prefix: tuple = ()) -> list:
    """[(path, leaf)] of a nested dict in sorted key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaves_with_paths(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def clip_by_global_norm(grads, max_norm: float, leaf_sums=None):
    """``leaf_sums``: None on one process, or the mesh's map from the
    gradient shards to each whole leaf's sum of squares (module
    docstring)."""
    leaves = [g for _, g in leaves_with_paths(grads)]
    sq = (leaf_sums(leaves) if leaf_sums is not None else
          [torch.sum(torch.square(g.float())) for g in leaves])
    gnorm = torch.sqrt(sum(sq))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gnorm


def adamw(
    lr: Union[float, Callable[[torch.Tensor], torch.Tensor]],
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: Optional[float] = 1.0,
    decay_mask: Optional[Callable[[tuple, torch.Tensor], bool]] = None,
) -> Optimizer:
    """``decay_mask(path, leaf) -> bool`` selects leaves for weight decay
    (default: every leaf with ndim >= 2 -- skips norms and biases)."""

    def init(params):
        some = leaves_with_paths(params)[0][1]
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=some.device),
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(grads, state: AdamWState, params, leaf_sums=None):
        gnorm = None
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm, leaf_sums)
        step = state.step + 1
        lr_t = lr(step) if callable(lr) else lr
        # b ** step in fp32, as the reference's weak-typed b1 ** fp32 step
        step32 = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, step32)
        bc2 = 1.0 - torch.pow(b2, step32)

        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g),
                        state.nu, grads)

        decay = {path: (decay_mask(path, leaf) if decay_mask
                        else leaf.dim() >= 2)
                 for path, leaf in leaves_with_paths(params)}

        def upd(path, m, v, p):
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay and decay[path]:
                u = u + weight_decay * p
            return -lr_t * u

        def walk(m, v, p, prefix=()):
            if isinstance(p, dict):
                return {k: walk(m[k], v[k], p[k], prefix + (k,)) for k in p}
            return upd(prefix, m, v, p)

        updates = walk(mu, nu, params)
        metrics = {"lr": lr_t}
        if gnorm is not None:
            metrics["grad_norm"] = gnorm
        return updates, AdamWState(step=step, mu=mu, nu=nu), metrics

    return Optimizer(init=init, update=update)


@torch.no_grad()
def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


__all__ = ["adamw", "AdamWState", "Optimizer", "apply_updates",
           "clip_by_global_norm", "leaves_with_paths"]
