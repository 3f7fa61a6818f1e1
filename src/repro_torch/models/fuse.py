"""Projection fusion: Q/K/V (and MLP gate/up) as ONE widened Monarch matmul
(port of ``repro.models.fuse``).

For Monarch factors of identical shapes, concatenating the L factors along
the per-block output axis and the R factors along the block axis,

    L_cat = cat([L_1..L_n], dim=-2)     (k, n*qm, p)
    R_cat = cat([R_1..R_n], dim=-3)     (n*qm, s, k)

gives a valid Monarch pair whose map is ``cat([x @ M_1, ..., x @ M_n],
dim=-1)``: every per-block dot product is unchanged.  Dense weights
concatenate along the output axis.  Negative dims make the same transform
work on layer-stacked parameter trees.

GQA stacks (n_heads != n_kv_heads) have differently shaped Q vs K/V
factors; there K and V fuse into ``wkv`` and Q stays separate, as they do
in a cross-attention block (``xattn``: its q reads another stream).  A
Mamba layer (``in_proj`` / ``out_proj``) has nothing to fuse and passes
through unchanged.
Quantization composes: fuse first, then ``core.quant.quantize_tree``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.linear import is_monarch


def _fusable(parts: list[dict]) -> bool:
    if any(not isinstance(p, dict) for p in parts):
        return False
    if any("b" in p for p in parts) != all("b" in p for p in parts):
        return False
    if all(is_monarch(p) for p in parts):
        return (all(p["L"].shape == parts[0]["L"].shape for p in parts)
                and all(p["R"].shape == parts[0]["R"].shape for p in parts))
    if all("w" in p and not isinstance(p["w"], dict) for p in parts):
        return all(p["w"].shape[-2] == parts[0]["w"].shape[-2]
                   for p in parts)
    return False


def fuse_linears(parts: list[dict]) -> dict:
    """Concatenate compatible linear params into one widened projection
    whose output is ``cat([y_1, ..., y_n], dim=-1)`` exactly."""
    if not _fusable(parts):
        raise ValueError("projections are not fusable (shape/kind mismatch)")
    if is_monarch(parts[0]):
        out: dict[str, Any] = {
            "L": torch.cat([p["L"] for p in parts], dim=-2),
            "R": torch.cat([p["R"] for p in parts], dim=-3),
        }
    else:
        out = {"w": torch.cat([p["w"] for p in parts], dim=-1)}
    if "b" in parts[0]:
        out["b"] = torch.cat([p["b"] for p in parts], dim=-1)
    return out


def fuse_attention(p: dict, allow_qkv: bool = True) -> dict:
    """{wq, wk, wv, wo} -> {wqkv, wo} (full fusion) or {wq, wkv, wo} (GQA,
    or cross-attention, where only K/V may fuse).  Already-fused or
    unfusable dicts pass through."""
    if "wqkv" in p or "wkv" in p or not all(
            k in p for k in ("wq", "wk", "wv")):
        return p
    rest = {k: v for k, v in p.items() if k not in ("wq", "wk", "wv")}
    if allow_qkv and _fusable([p["wq"], p["wk"], p["wv"]]):
        return {"wqkv": fuse_linears([p["wq"], p["wk"], p["wv"]]), **rest}
    if _fusable([p["wk"], p["wv"]]):
        return {"wq": p["wq"], "wkv": fuse_linears([p["wk"], p["wv"]]),
                **rest}
    return p


def fuse_ffn(p: dict) -> dict:
    """{w1, wg, w2} -> {w1g, w2} with ``w1g`` output = [up, gate]."""
    if "w1g" in p or "w1" not in p or "wg" not in p:
        return p
    if not _fusable([p["w1"], p["wg"]]):
        return p
    rest = {k: v for k, v in p.items() if k not in ("w1", "wg")}
    return {"w1g": fuse_linears([p["w1"], p["wg"]]), **rest}


def fuse_model(params: Any, _key: str = "") -> Any:
    """Fuse every attention QKV triple and gated-FFN pair of a parameter
    tree (stacked layer trees included); the result runs through the
    unchanged model code, which dispatches on the fused keys.
    Cross-attention blocks (``xattn``) fuse K/V only."""
    if not isinstance(params, dict):
        return params
    p = {k: fuse_model(v, k) for k, v in params.items()}
    if all(k in p for k in ("wq", "wk", "wv")):
        p = fuse_attention(p, allow_qkv=(_key != "xattn"))
    if "w1" in p and "wg" in p:
        p = fuse_ffn(p)
    return p


def fused_split_sizes(h: int, kv: int, hd: int) -> tuple[int, int, int]:
    """Output-slice widths of a fused QKV projection: (q, k, v)."""
    return h * hd, kv * hd, kv * hd


__all__ = ["fuse_linears", "fuse_attention", "fuse_ffn", "fuse_model",
           "fused_split_sizes"]
