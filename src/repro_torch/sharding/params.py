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

Every family of the reference splits over the same axis:

  * **experts** (``moe/experts/...``, the reference's ``("experts", ...)``
    rules): every leaf of the stacked routed experts splits its expert
    axis, the one in front of each expert's own dims (``L (E, k, q, p)``,
    ``R (E, q, s, k)``, dense ``w (E, din, dout)``, the quantized ``Lq`` /
    ``Ls`` / ``Rq`` / ``Rs`` alike), so each rank holds ``n_slots / tp``
    whole experts: a fused ``w1g`` and an int4 pair are never cut.  The
    router stays whole; the shared experts (``moe/shared{i}/...``) are
    ``"mlp"`` pairs like a dense FFN;
  * the **encoder** (``encoder/...``) falls under the attention and FFN
    rules, and the **cross-attention** (``xattn/...``) under rules of its
    own in the same groups: its q heads and its K/V heads split as the
    self-attention's do;
  * **Mamba** leaves (``mamba/...``) split their SSM heads
    (``"ssm_heads"``): ``conv_w`` / ``conv_b`` part by part (``[x | B | C]``:
    the ``x`` channels by heads, the one group's ``B`` and ``C`` whole),
    ``A_log``, ``dt_bias``, ``D`` and the gated norm's ``norm_scale`` by
    heads, and ``out_proj`` row-parallel (its input blocks of ``head_dim``
    lie on head boundaries).  ``in_proj`` stays whole on every rank and
    each rank slices its output, ``[z | x | B | C | dt]``, by parts.  Its
    output blocks (661 wide for mamba2-2.7b, 911 for zamba2-7b) straddle
    the parts' boundaries, so no column split of its factors can hand a
    rank its parts; splitting by output blocks would need an
    ``all_gather`` of the whole output in every layer, while the whole
    factors are ~0.2 M weights a layer and every column stays exactly the
    tp = 1 column, with no collective.  The gated norm's statistic spans
    the whole ``d_inner``: one ``all_reduce`` of its partial sums a layer
    (``models/mamba2.py``).  Split only for one group (``n_groups == 1``,
    both Mamba configs).

Rules are patterns on the ``/``-joined parameter path's components (a
shared expert's ``shared{i}`` reads as ``shared``); any leading dims
(the stacked layer axis) are untouched.  Each rule belongs to a
group whose members must split together — a head-split ``wq`` needs a
head-split ``wo`` — and the reference's divisibility guard decides per
group: a group whose dims ``tp`` does not divide stays replicated.  KV
heads split exactly when the pool does
(``serving.device_kv.kv_shard_size``), so a GQA model whose KV heads the
axis does not divide keeps ``wk``/``wv`` and the pool whole on every rank.

The decision is made once, at load, by :func:`tp_plan`: its
:class:`TPPlan` is what ``shard_params`` slices by, what the layers read
to know which linears end in an all-reduce and where attention runs, and
what sizes the engine's pool (``kv_shard``) and the decode cache.

**FSDP over ``"data"``** (training; the reference's ZeRO-3 placement of
the fp32 masters and both AdamW moments).  After its tensor-parallel
split, each leaf splits over the ``"data"`` axis on the dim the
reference's rules (``repro.sharding.params._RULES``, kept here as
:data:`_REF_RULES`) give ``"data"``, where the port's ``"model"`` split
leaves that dim free and ``data`` divides it; otherwise on the first dim
of the leaf's own (``data`` divides it, not the ``"model"`` one), or it
stays whole, as the reference's guard leaves it.  A leaf the reference
gives no ``"data"`` dim (norms, the router, the Mamba conv and heads'
vectors) stays whole.  The stacked layer axes are never split, so a
layer's leaves are sliced as they are drawn (:func:`keep_parts`,
``transformer.init_params(plan=)``).  Where the port's dim differs from
the reference's (:func:`fsdp_axis`), the difference is designed: the
port's ``"model"`` split takes other dims than the reference's.
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
# ``w1g`` [up | gate]; each part splits (or stays whole) as its group does.
# A part of group WHOLE never splits (a Mamba conv's B and C channels)
WHOLE = "whole"
_RULES: list[tuple[tuple[str, ...], tuple[str, ...], str]] = [
    (("moe", "experts"), ("experts",), "experts"),
    (("shared", "w1"), ("mlp",), "column"),
    (("shared", "wg"), ("mlp",), "column"),
    (("shared", "w1g"), ("mlp", "mlp"), "column"),
    (("shared", "w2"), ("mlp",), "row"),
    (("attn", "wq"), ("heads",), "column"),
    (("attn", "wk"), ("kv_heads",), "column"),
    (("attn", "wv"), ("kv_heads",), "column"),
    (("attn", "wqkv"), ("heads", "kv_heads", "kv_heads"), "column"),
    (("attn", "wkv"), ("kv_heads", "kv_heads"), "column"),
    (("attn", "wo"), ("heads",), "row"),
    (("xattn", "wq"), ("heads",), "column"),
    (("xattn", "wk"), ("kv_heads",), "column"),
    (("xattn", "wv"), ("kv_heads",), "column"),
    (("xattn", "wkv"), ("kv_heads", "kv_heads"), "column"),
    (("xattn", "wo"), ("heads",), "row"),
    (("ffn", "w1"), ("mlp",), "column"),
    (("ffn", "wg"), ("mlp",), "column"),
    (("ffn", "w1g"), ("mlp", "mlp"), "column"),
    (("ffn", "w2"), ("mlp",), "row"),
    (("mamba", "conv_w"), ("ssm_heads", WHOLE, WHOLE), "ssm"),
    (("mamba", "conv_b"), ("ssm_heads", WHOLE, WHOLE), "ssm"),
    (("mamba", "A_log"), ("ssm_heads",), "ssm"),
    (("mamba", "dt_bias"), ("ssm_heads",), "ssm"),
    (("mamba", "D"), ("ssm_heads",), "ssm"),
    (("mamba", "norm_scale"), ("ssm_heads",), "ssm"),
    (("mamba", "out_proj"), ("ssm_heads",), "row"),
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
# every packed pair on one rank.  An expert leaf splits the axis in front
# of one expert's own dims
_AXES: dict[str, dict[str, Optional[int]]] = {
    "column": {"L": -2, "R": -3, "w": -1, "b": -1,
               "Lq": -2, "Ls": None, "Rq": -3, "Rs": -3},
    "row": {"L": -3, "R": -1, "w": -2, "b": None,
            "Lq": -3, "Ls": -3, "Rq": -1, "Rs": None},
    "experts": {"L": -4, "R": -4, "w": -3, "b": -2,
                "Lq": -4, "Ls": -4, "Rq": -4, "Rs": -4},
    "ssm": {"conv_w": -1, "conv_b": -1, "A_log": -1, "dt_bias": -1,
            "D": -1, "norm_scale": -1},
    "vocab_rows": {"table": -2},
    "vocab_cols": {"unembed": -1},
}

# the groups of every model; a family's own groups join them where the
# model has that family (TPPlan.present)
BASE_GROUPS = ("heads", "kv_heads", "mlp", "vocab")
GROUPS = BASE_GROUPS + ("experts", "ssm_heads")


def _components(path: str) -> list[str]:
    """The path's components, a shared expert's ``shared{i}`` as
    ``shared`` (zamba2's ``shared_attn`` stays itself)."""
    return ["shared" if c.startswith("shared") and c[6:].isdigit() else c
            for c in path.split("/")]


def _rule(path: str) -> Optional[tuple[tuple[str, ...], str]]:
    parts = _components(path)
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
    experts: bool = False
    ssm_heads: bool = False
    # the model's head counts: a fused [q | k | v]'s parts are h : kv : kv
    n_heads: int = 1
    n_kv_heads: int = 1
    # a Mamba conv's [x | B | C]: the width of B (and of C), n_groups * N
    ssm_bc: int = 0
    # the groups this model has (a family's groups where it has the family)
    present: tuple[str, ...] = BASE_GROUPS

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
        return {g: getattr(self, g) for g in self.present}


def _part_widths(path: str, n: int, groups: tuple[str, ...], n_heads: int,
                 n_kv_heads: int, ssm_bc: int = 0) -> list[int]:
    """The widths of a (fused) leaf's parts on its split axis, ``n`` in
    all: a Mamba conv's ``[x | B | C]`` at ``[n - 2 ssm_bc, ssm_bc,
    ssm_bc]``, otherwise in the ratio of the parts' head counts, equal
    for a part of any other group."""
    if len(groups) == 1:
        return [n]
    if WHOLE in groups:
        return [n - 2 * ssm_bc, ssm_bc, ssm_bc]
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
    head counts it divides; for experts, whose slot count it divides; for
    SSM heads, whose head count it divides, with one group); KV heads
    only where the pool splits too.  Norms without a rule (gemma2's
    ``ln1_post`` / ``ln2_post`` too), the router and ``in_proj`` stay
    whole on every rank.  Every config is planned: a group the axis does
    not divide stays whole."""
    from repro_torch.serving.device_kv import kv_shard_size

    tp = mesh.model
    ok = {g: tp > 1 for g in GROUPS}
    ok["heads"] &= cfg.n_heads % tp == 0
    ok["vocab"] &= cfg.vocab_padded % tp == 0
    present = BASE_GROUPS
    ssm_bc = 0
    if cfg.moe is not None:
        present += ("experts",)
        ok["experts"] &= cfg.moe.n_slots % tp == 0
    if cfg.ssm is not None:
        s = cfg.ssm
        present += ("ssm_heads",)
        ssm_bc = s.n_groups * s.d_state
        n_ssm = s.expand * cfg.d_model // s.head_dim
        ok["ssm_heads"] &= n_ssm % tp == 0 and s.n_groups == 1
    for path, leaf in _leaves(tree):
        ax = _split_axis(path)
        if ax is None:
            continue
        groups = _rule(path)[0]
        widths = _part_widths(path, leaf.shape[ax], groups, cfg.n_heads,
                              cfg.n_kv_heads, ssm_bc)
        for g, width in zip(groups, widths):
            if g != WHOLE and not divides(width, tp):
                ok[g] = False
    pool_split = kv_shard_size(cfg, tp) == tp > 1
    if pool_split and not (ok["heads"] and ok["kv_heads"]):
        raise ValueError(
            f"tp={tp} splits the KV pool's heads, but the attention "
            f"weights' blocks do not divide by it")
    ok["kv_heads"] &= pool_split
    return TPPlan(mesh, **ok, n_heads=cfg.n_heads,
                  n_kv_heads=cfg.n_kv_heads, ssm_bc=ssm_bc, present=present)


def split_parts(path: str, shape, plan: TPPlan
                ) -> Optional[tuple[int, tuple[tuple[int, bool], ...]]]:
    """``(axis, ((width, splits), ...))`` for ``path``'s leaf of
    ``shape`` under ``plan``: one part for a plain projection, one a
    projection for a fused one (``[q | k | v]``, ``[k | v]``, ``[up |
    gate]``) and for a Mamba conv (``[x | B | C]``), each with its width
    on the axis and whether its group splits.  None where the leaf stays
    whole."""
    r = _rule(path)
    if r is None:
        return None
    ax = _split_axis(path)
    flags = tuple(g != WHOLE and getattr(plan, g) for g in r[0])
    if ax is None or not any(flags):
        return None
    widths = _part_widths(path, shape[ax], r[0], plan.n_heads,
                          plan.n_kv_heads, plan.ssm_bc)
    return ax, tuple(zip(widths, flags))


def _tp_slice(node: torch.Tensor, tp_parts, tp: int, rank: int):
    if tp_parts is None:
        return node
    ax, parts = tp_parts
    pieces, at = [], 0
    for w, split in parts:
        pieces.append(node.narrow(ax, at + rank * (w // tp), w // tp)
                      if split else node.narrow(ax, at, w))
        at += w
    return torch.cat(pieces, dim=ax) if len(pieces) > 1 else pieces[0]


def shard_params(tree, plan: TPPlan) -> dict:
    """This rank's ``"model"`` slices of a full parameter tree under
    ``plan`` (whole over ``"data"``: the serving steps' params), contiguous,
    on the plan's mesh's device: :func:`shard_train_params` with no FSDP
    split.  A fused leaf's rank slice is each part's slice, concatenated
    in the parts' order (``[q_r | k_r | v_r]``; a part whose group stays
    whole is kept whole).  Quantized and fused trees are prepared whole
    first (``models.decode_path.prepare_decode_params``), so a block's
    scale is the one the tp = 1 tree holds."""
    return shard_train_params(tree, plan, placements(tree, plan, fsdp=False))


# ---------------------------------------------------------------------------
# FSDP over "data"
# ---------------------------------------------------------------------------

# the reference's rules (repro/sharding/params.py:47-72, its "psum"
# scheme): (path substrings, all of which must appear; each trailing
# dim's mesh axis)
_REF_RULES: list[tuple[tuple[str, ...], tuple]] = [
    (("experts", "/L"), ("model", None, None, "data")),
    (("experts", "/R"), ("model", None, "data", None)),
    (("experts", "w1", "w"), ("model", "data", None)),
    (("experts", "wg", "w"), ("model", "data", None)),
    (("experts", "w2", "w"), ("model", None, "data")),
    (("router",), (None, None)),
    (("embedding", "table"), ("model", "data")),
    (("embedding", "unembed"), ("data", "model")),
    (("/L",), ("model", None, "data")),
    (("/R",), (None, "data", "model")),
    (("wq", "w"), ("data", "model")),
    (("wk", "w"), ("data", "model")),
    (("wv", "w"), ("data", "model")),
    (("wo", "w"), ("model", "data")),
    (("w1", "w"), ("data", "model")),
    (("wg", "w"), ("data", "model")),
    (("w2", "w"), ("model", "data")),
    (("in_proj", "w"), ("data", "model")),
    (("out_proj", "w"), ("model", "data")),
    (("conv_w",), (None, "model")),
    (("conv_b",), ("model",)),
    (("A_log",), ("model",)),
    (("dt_bias",), ("model",)),
    (("norm_scale",), ("model",)),
    (("D",), ("model",)),
]


def reference_spec(path: str, ndim: int) -> tuple:
    """The reference's ``spec_for(path, shape)`` before its divisibility
    guard: one mesh axis name (or None) a dim, leading dims padded with
    None; all None where no rule matches or the rule is longer than the
    leaf."""
    for needles, axes in _REF_RULES:
        if all(n in path for n in needles):
            if len(axes) > ndim:
                return (None,) * ndim
            return (None,) * (ndim - len(axes)) + tuple(axes)
    return (None,) * ndim


def stacked_dims(path: str) -> int:
    """How many leading axes of ``path``'s leaf stack layers: 1 for a
    stack's ``layers`` and a hybrid's ``tail``, 2 for its ``groups``, 0
    elsewhere (the embedding, the final norms, the shared block)."""
    parts = path.split("/")
    if len(parts) > 1 and parts[0] in ("decoder", "encoder"):
        return {"layers": 1, "tail": 1, "groups": 2}.get(parts[1], 0)
    return 0


@dataclasses.dataclass(frozen=True)
class LeafPlacement:
    """Where one leaf of a train state lives on a ``("data", "model")``
    mesh: its whole shape, its ``"model"`` split (``split_parts``:
    ``(axis, ((width, splits), ...))`` or None), the dim it splits over
    ``"data"`` (negative: counted from the end, never a stacked layer
    axis; None: whole on every data rank), and this rank's shard shape."""

    shape: tuple
    tp: Optional[tuple]
    fsdp: Optional[int]
    shard: tuple


def _tp_local(shape: tuple, tp_parts, tp: int) -> tuple:
    if tp_parts is None:
        return tuple(shape)
    ax, parts = tp_parts
    out = list(shape)
    out[ax] = sum(w // tp if split else w for w, split in parts)
    return tuple(out)


def fsdp_axis(path: str, shape, plan: TPPlan) -> Optional[int]:
    """The dim (negative) ``path``'s leaf of whole ``shape`` splits over
    the ``"data"`` axis under ``plan`` (module docstring), or None."""
    data = plan.mesh.data
    if data == 1:
        return None
    nd = len(shape)
    spec = reference_spec(path, nd)
    if "data" not in spec:
        return None
    sp = split_parts(path, shape, plan)
    tax = None if sp is None else sp[0] % nd
    local = _tp_local(shape, sp, plan.tp)
    lead = stacked_dims(path)
    want = spec.index("data")
    if want >= lead and want != tax and local[want] % data == 0:
        return want - nd
    for i in range(lead, nd):
        if i != tax and local[i] % data == 0:
            return i - nd
    return None


def placement(path: str, shape, plan: TPPlan,
              fsdp: bool = True) -> LeafPlacement:
    shape = tuple(shape)
    sp = split_parts(path, shape, plan)
    fax = fsdp_axis(path, shape, plan) if fsdp else None
    shard = list(_tp_local(shape, sp, plan.tp))
    if fax is not None:
        shard[fax] //= plan.mesh.data
    return LeafPlacement(shape, sp, fax, tuple(shard))


def placements(tree, plan: TPPlan, fsdp: bool = True) -> dict:
    """{path: :class:`LeafPlacement`} of every leaf of a whole tree (meta
    or fake tensors will do: only shapes are read); ``fsdp=False``: the
    ``"model"`` split alone, every leaf whole over ``"data"``."""
    return {path: placement(path, leaf.shape, plan, fsdp)
            for path, leaf in _leaves(tree)}


def shard_leaf(node: torch.Tensor, pl: LeafPlacement,
               plan: TPPlan) -> torch.Tensor:
    """This rank's shard of a leaf (the whole leaf, or one layer of it:
    the split axes are counted from the end): its ``"model"`` part, then
    its ``"data"`` part, a contiguous copy of its own."""
    node = _tp_slice(node, pl.tp, plan.tp, plan.mesh.model_rank)
    if pl.fsdp is not None:
        n = node.shape[pl.fsdp] // plan.mesh.data
        node = node.narrow(pl.fsdp, plan.mesh.data_rank * n, n)
    return node.contiguous().clone() if node.is_contiguous() \
        else node.contiguous()


def keep_parts(tree, prefix: str, table: dict, plan: TPPlan) -> dict:
    """Each leaf of ``tree`` (a subtree at ``prefix``: a layer of a
    stack, the embedding) cut to this rank's shard by its placement in
    ``table`` (:func:`placements` of the whole tree)."""
    if isinstance(tree, dict):
        return {k: keep_parts(v, f"{prefix}/{k}" if prefix else str(k),
                              table, plan) for k, v in tree.items()}
    return shard_leaf(tree, table[prefix], plan)


def shard_train_params(tree, plan: TPPlan, table: dict) -> dict:
    """This rank's shards of a whole tree (``"model"`` then ``"data"``),
    on the plan's mesh's device: each leaf is sliced where it lies and
    only the shard is moved."""
    out = keep_parts(tree, "", table, plan)

    def go(node):
        if isinstance(node, dict):
            return {k: go(v) for k, v in node.items()}
        return node.to(plan.mesh.device)

    return go(out)


def unshard_leaf(parts: list, pl: LeafPlacement, plan: TPPlan
                 ) -> torch.Tensor:
    """A whole leaf put back together from every world rank's shard
    (``parts[r]`` is world rank ``r``'s): each model rank's ``"data"``
    shards joined on the FSDP dim, then the model ranks' parts joined
    part by part on the ``"model"`` dim."""
    tp, data = plan.tp, plan.mesh.data
    per_model = []
    for m in range(tp):
        mine = [parts[d * tp + m] for d in range(data)]
        per_model.append(torch.cat(mine, dim=pl.fsdp)
                         if pl.fsdp is not None else mine[0])
    if pl.tp is None:
        return per_model[0]
    ax, widths = pl.tp
    pieces, at = [], 0
    for w, split in widths:
        n = w // tp if split else w
        if split:
            pieces.extend(t.narrow(ax, at, n) for t in per_model)
        else:
            pieces.append(per_model[0].narrow(ax, at, n))
        at += n
    return torch.cat(pieces, dim=ax)


__all__ = ["TPPlan", "shard_params", "tp_plan", "split_parts", "GROUPS",
           "LeafPlacement", "placement", "placements", "fsdp_axis",
           "reference_spec", "stacked_dims", "shard_leaf", "keep_parts",
           "shard_train_params", "unshard_leaf"]
