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
  * a fused projection (``wqkv``, ``wkv``, ``w1g``) is column-parallel part
    by part: rank ``r`` keeps each part's slice of its blocks, so its
    factor is ``[q_r | k_r | v_r]``, a part whose group stays whole kept
    whole (the k/v of a GQA pool left whole).  The parts' widths are in
    the ratio of their head counts (``h : kv : kv``; up and gate alike):
    a dense GQA ``wqkv`` is ``[h*hd | kv*hd | kv*hd]``, and Monarch factors
    fuse only at equal shapes (``models/fuse.py``);
  * quantized factors (``Lq``/``Ls``/``Rq``/``Rs``) split as their float
    factors, each per-block scale with its block or whole where the
    split cuts inside the blocks it scales;
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
import math
from typing import Any, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.sharding.api import divides

# (path components that must all appear, the group of each part, role).
# A fused projection (``models/fuse.py``) holds its parts side by side on
# the column split's axis: ``wqkv`` is [q | k | v], ``wkv`` [k | v] and
# ``w1g`` [up | gate]; each part splits (or stays whole) as its group does
_RULES: list[tuple[tuple[str, ...], tuple[str, ...], str]] = [
    (("attn", "wq"), ("heads",), "column"),
    (("attn", "wk"), ("kv_heads",), "column"),
    (("attn", "wv"), ("kv_heads",), "column"),
    (("attn", "wqkv"), ("heads", "kv_heads", "kv_heads"), "column"),
    (("attn", "wkv"), ("kv_heads", "kv_heads"), "column"),
    (("attn", "wo"), ("heads",), "row"),
    (("ffn", "w1"), ("mlp",), "column"),
    (("ffn", "wg"), ("mlp",), "column"),
    (("ffn", "w1g"), ("mlp", "mlp"), "column"),
    (("ffn", "w2"), ("mlp",), "row"),
    (("embedding", "table"), ("vocab",), "vocab_rows"),
    (("embedding", "unembed"), ("vocab",), "vocab_cols"),
]

# split axis of each leaf kind (the path's last component), per role;
# None = the leaf stays whole (a row-parallel bias is added once, after
# the all-reduce).  Quantized factors (``core/quant.py``: ``Lq (k, q,
# p[/2])`` with one scale ``Ls (k, 1, 1)`` a block, ``Rq (q, s, k[/2])``
# with ``Rs (q, 1, 1)``) split with their float factor; a scale covers its
# whole block, so it splits on the block axis or stays whole.  int4 packs
# pairs along the last axis, so a row-parallel ``Rq`` splits its packed
# k/2 bytes: the divisibility guard then needs k/tp even, which keeps
# every packed pair on one rank
_AXES: dict[str, dict[str, Optional[int]]] = {
    "column": {"L": -2, "R": -3, "w": -1, "b": -1,
               "Lq": -2, "Ls": None, "Rq": -3, "Rs": -3},
    "row": {"L": -3, "R": -1, "w": -2, "b": None,
            "Lq": -3, "Ls": -3, "Rq": -1, "Rs": None},
    "vocab_rows": {"table": -2},
    "vocab_cols": {"unembed": -1},
}

GROUPS = ("heads", "kv_heads", "mlp", "vocab")


def _rule(path: str) -> Optional[tuple[tuple[str, ...], str]]:
    parts = path.split("/")
    for needles, groups, role in _RULES:
        if all(n in parts for n in needles):
            return groups, role
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
            f"{path}: no tensor-parallel rule for a {kind!r} leaf")
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
    # the model's head counts: a fused [q | k | v]'s parts are h : kv : kv
    n_heads: int = 1
    n_kv_heads: int = 1

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


def _part_widths(path: str, n: int, groups: tuple[str, ...], n_heads: int,
                 n_kv_heads: int) -> list[int]:
    """The widths of a (fused) leaf's parts on its split axis, ``n`` in
    all: in the ratio of the parts' head counts, equal for a part of any
    other group."""
    if len(groups) == 1:
        return [n]
    g = math.gcd(n_heads, n_kv_heads)
    ratio = [{"heads": n_heads // g, "kv_heads": n_kv_heads // g}.get(p, 1)
             for p in groups]
    if n % sum(ratio):
        raise ValueError(f"{path}: {n} columns do not hold parts in the "
                         f"ratio {':'.join(map(str, ratio))}")
    return [n // sum(ratio) * r for r in ratio]


def tp_plan(tree, cfg: ModelConfig, mesh) -> TPPlan:
    """Which groups split over ``mesh``'s ``tp``-way ``"model"`` axis:
    each one whose every split dim ``tp`` divides (and, for heads, whose
    head counts it divides); KV heads only where the pool splits too.
    Norms without a rule (gemma2's ``ln1_post`` / ``ln2_post`` too) stay
    whole on every rank.  A mixture-of-experts model at ``tp`` > 1 raises
    ``NotImplementedError``: it needs expert parallelism; so do Mamba and
    hybrid stacks and encoder-decoder models, whose rules are not
    ported."""
    from repro_torch.serving.device_kv import kv_shard_size

    tp = mesh.model
    if cfg.moe is not None and tp > 1:
        # the reference shards the stacked experts over "model"
        # (repro/sharding/params.py:48-52): expert parallelism
        raise NotImplementedError(
            f"{cfg.name}: mixture-of-experts layers at tp = {tp} need expert "
            f"parallelism (experts over the \"model\" axis), which is not "
            f"ported yet")
    if tp > 1 and (cfg.layer_kind != "attn" or cfg.encdec):
        # the reference splits the Mamba leaves over "model" (its rules
        # for in_proj, out_proj, conv_w, conv_b, A_log, dt_bias,
        # norm_scale and D, repro/sharding/params.py:65-72), and the
        # encoder's and the cross-attention's heads as any attention's
        what = ("Mamba layers (in_proj, out_proj and the SSM heads' "
                "leaves over \"model\")" if cfg.layer_kind != "attn" else
                "the encoder and the cross-attention (xattn) under a plan")
        raise NotImplementedError(
            f"{cfg.name}: {what} at tp = {tp} are not ported yet")
    ok = {g: tp > 1 for g in GROUPS}
    ok["heads"] &= cfg.n_heads % tp == 0
    ok["vocab"] &= cfg.vocab_padded % tp == 0
    for path, leaf in _leaves(tree):
        ax = _split_axis(path)
        if ax is None:
            continue
        groups = _rule(path)[0]
        widths = _part_widths(path, leaf.shape[ax], groups, cfg.n_heads,
                              cfg.n_kv_heads)
        for g, width in zip(groups, widths):
            if not divides(width, tp):
                ok[g] = False
    pool_split = kv_shard_size(cfg, tp) == tp > 1
    if pool_split and not (ok["heads"] and ok["kv_heads"]):
        raise ValueError(
            f"tp={tp} splits the KV pool's heads, but the attention "
            f"weights' blocks do not divide by it")
    ok["kv_heads"] &= pool_split
    return TPPlan(mesh, **ok, n_heads=cfg.n_heads,
                  n_kv_heads=cfg.n_kv_heads)


def split_parts(path: str, shape, plan: TPPlan
                ) -> Optional[tuple[int, tuple[tuple[int, bool], ...]]]:
    """``(axis, ((width, splits), ...))`` for ``path``'s leaf of
    ``shape`` under ``plan``: one part for a plain projection, one a
    projection for a fused one (``[q | k | v]``, ``[k | v]``, ``[up |
    gate]``), each with its width on the axis and whether its group
    splits.  None where the leaf stays whole."""
    r = _rule(path)
    if r is None:
        return None
    ax = _split_axis(path)
    flags = tuple(getattr(plan, g) for g in r[0])
    if ax is None or not any(flags):
        return None
    widths = _part_widths(path, shape[ax], r[0], plan.n_heads,
                          plan.n_kv_heads)
    return ax, tuple(zip(widths, flags))


def shard_params(tree, plan: TPPlan) -> dict:
    """This rank's slices of a full parameter tree under ``plan``,
    contiguous, on the plan's mesh's device.  A fused leaf's rank slice
    is each part's slice, concatenated in the parts' order (``[q_r | k_r
    | v_r]``; a part whose group stays whole is kept whole).  Each leaf is
    sliced where it lies and only the slice is moved, so a full tree on
    the CPU never reaches the card whole.  Quantized and fused trees are
    prepared whole first (``models.decode_path.prepare_decode_params``),
    so a block's scale is the one the tp = 1 tree holds."""
    tp, rank, dev = plan.tp, plan.mesh.rank, plan.mesh.device

    def go(node, prefix):
        if isinstance(node, dict):
            return {k: go(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in node.items()}
        sp = split_parts(prefix, node.shape, plan)
        if sp is not None:
            ax, parts = sp
            pieces, at = [], 0
            for w, split in parts:
                pieces.append(node.narrow(ax, at + rank * (w // tp), w // tp)
                              if split else node.narrow(ax, at, w))
                at += w
            node = torch.cat(pieces, dim=ax) if len(pieces) > 1 \
                else pieces[0]
        return node.contiguous().to(dev)

    return go(tree, "")


__all__ = ["TPPlan", "shard_params", "tp_plan", "split_parts", "GROUPS"]
