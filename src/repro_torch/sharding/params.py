"""Path-based parameter partition rules for tensor parallelism (port of
``repro.sharding.params``).

The reference shards the Monarch factors on their contraction axis and
lets GSPMD insert a ``psum`` after each stage.  The port places the
weights as Megatron pairs on the Monarch block axes instead, which needs
two all-reduces a layer.  For a factor pair ``L (k, q, p)``,
``R (q, s, k)``, ``y[qi*s + si] = sum_k R[qi, si, k] * (x_k . L[k, qi, :])``:

  * **column-parallel** (``wq``, ``wk``, ``wv``, ``w1``, ``wg``): rank ``r``
    keeps the output blocks ``qi`` of its slice, ``L[:, qs, :]`` and
    ``R[qs]`` — a smaller Monarch the kernels take as it is, with no
    collective, each output column computed as at tp = 1;
  * **row-parallel** (``wo``, ``w2``): rank ``r`` keeps the input blocks
    ``ki`` of its slice, ``L[ks]`` and ``R[:, :, ks]``, computes a partial
    ``y`` and ends in one ``all_reduce``;
  * dense ``w (din, dout)`` (and its bias) splits columns or rows the same
    way; a D2S-nested ``{"w": {"L", "R"}}`` follows its factors' rule;
  * the tied embedding ``table (Vp, d)`` splits its vocab rows (the
    untied ``unembed (d, Vp)`` its vocab columns): vocab-parallel lookup
    and logits.

Rules are suffix patterns on the ``/``-joined parameter path; any leading
dims (the stacked layer axis) are untouched.  Each rule belongs to a
group whose members must split together — a head-split ``wq`` needs a
head-split ``wo`` — and the reference's divisibility guard decides per
group: a group whose dims ``tp`` does not divide stays replicated.  KV
heads split exactly when the pool does
(``serving.device_kv.kv_shard_size``), so a GQA model whose KV heads the
axis does not divide keeps ``wk``/``wv`` and the pool whole on every rank.

The decision is made once, at load, by :func:`tp_plan`: its
:class:`TPPlan` is what ``shard_params`` slices by, what the layers read
to know which linears end in an all-reduce and where attention runs, and
what sizes the engine's pool (``kv_shard``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.models.config import ModelConfig
from repro_torch.sharding.api import divides

# (path components that must all appear, group, role)
_RULES: list[tuple[tuple[str, ...], str, str]] = [
    (("attn", "wq"), "heads", "column"),
    (("attn", "wk"), "kv_heads", "column"),
    (("attn", "wv"), "kv_heads", "column"),
    (("attn", "wo"), "heads", "row"),
    (("ffn", "w1"), "mlp", "column"),
    (("ffn", "wg"), "mlp", "column"),
    (("ffn", "w2"), "mlp", "row"),
    (("embedding", "table"), "vocab", "vocab_rows"),
    (("embedding", "unembed"), "vocab", "vocab_cols"),
]

# split axis of each leaf kind (the path's last component), per role;
# None = the leaf stays whole (a row-parallel bias is added once, after
# the all-reduce)
_AXES: dict[str, dict[str, Optional[int]]] = {
    "column": {"L": -2, "R": -3, "w": -1, "b": -1},
    "row": {"L": -3, "R": -1, "w": -2, "b": None},
    "vocab_rows": {"table": -2},
    "vocab_cols": {"unembed": -1},
}

GROUPS = ("heads", "kv_heads", "mlp", "vocab")


def _rule(path: str) -> Optional[tuple[str, str]]:
    parts = path.split("/")
    for needles, group, role in _RULES:
        if all(n in parts for n in needles):
            return group, role
    return None


def _leaves(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def _split_axis(path: str) -> Optional[int]:
    r = _rule(path)
    if r is None:
        return None
    kind = path.split("/")[-1]
    axes = _AXES[r[1]]
    if kind not in axes:
        raise NotImplementedError(
            f"{path}: no tensor-parallel rule for a {kind!r} leaf "
            f"(quantized or fused factors are not sharded yet)")
    return axes[kind]


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """One rank's tensor-parallel placement: its mesh, and which groups of
    :data:`GROUPS` split over the mesh's ``"model"`` axis."""

    mesh: Any
    heads: bool = False
    kv_heads: bool = False
    mlp: bool = False
    vocab: bool = False

    @property
    def tp(self) -> int:
        return self.mesh.model

    @property
    def kv_shard(self) -> int:
        """How many ways the pool's KV-head axis is split."""
        return self.tp if self.kv_heads else 1

    @property
    def pool_replicated(self) -> bool:
        """A ``tp`` > 1 axis over a pool left whole on every rank: attention
        takes the dense gather (``"gqa_replicated"``), never B7."""
        return self.tp > 1 and not self.kv_heads

    def groups(self) -> dict[str, bool]:
        return {g: getattr(self, g) for g in GROUPS}


def tp_plan(tree, cfg: ModelConfig, mesh) -> TPPlan:
    """Which groups split over ``mesh``'s ``tp``-way ``"model"`` axis:
    each one whose every split dim ``tp`` divides (and, for heads, whose
    head counts it divides); KV heads only where the pool splits too."""
    from repro_torch.serving.device_kv import kv_shard_size

    tp = mesh.model
    ok = {g: tp > 1 for g in GROUPS}
    ok["heads"] &= cfg.n_heads % tp == 0
    ok["vocab"] &= cfg.vocab_padded % tp == 0
    for path, leaf in _leaves(tree):
        ax = _split_axis(path)
        if ax is not None and not divides(leaf.shape[ax], tp):
            ok[_rule(path)[0]] = False
    pool_split = kv_shard_size(cfg, tp) == tp > 1
    if pool_split and not (ok["heads"] and ok["kv_heads"]):
        raise ValueError(
            f"tp={tp} splits the KV pool's heads, but the attention "
            f"weights' blocks do not divide by it")
    ok["kv_heads"] &= pool_split
    return TPPlan(mesh, **ok)


def spec_for(path: str, plan: TPPlan) -> Optional[int]:
    """The axis ``path``'s leaf splits on under ``plan``, or None."""
    r = _rule(path)
    if r is None or not getattr(plan, r[0]):
        return None
    return _split_axis(path)


def shard_params(tree, plan: TPPlan) -> dict:
    """This rank's slices of a full parameter tree under ``plan``,
    contiguous, on the plan's mesh's device.  Each leaf is sliced where it
    lies and only the slice is moved, so a full tree on the CPU never
    reaches the card whole."""
    tp, rank, dev = plan.tp, plan.mesh.rank, plan.mesh.device

    def go(node, prefix):
        if isinstance(node, dict):
            return {k: go(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in node.items()}
        ax = spec_for(prefix, plan)
        if ax is not None:
            n = node.shape[ax] // tp
            node = node.narrow(ax, rank * n, n)
        return node.contiguous().to(dev)

    return go(tree, "")


__all__ = ["TPPlan", "shard_params", "tp_plan", "spec_for", "GROUPS"]
