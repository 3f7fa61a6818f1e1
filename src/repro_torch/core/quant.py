"""Per-block symmetric quantization of Monarch factors and of KV pages
(port of ``repro.core.quant``).

Quantized parameter container (dict-shaped, like every param tree here):

    {"Lq": int8 (..., k, q, p[/2]),  "Ls": f32 (..., k, 1, 1),
     "Rq": int8 (..., q, s, k[/2]),  "Rs": f32 (..., q, 1, 1)}

One fp32 scale per diagonal block (per ``shape[:-2]`` slice, so a stacked
leading layer axis passes straight through).  int4 packs two values per
byte along the contraction axis (the last axis of both factors):
``byte = hi << 4 | lo`` with lo the even index; the unpacked width is
recovered from the scale shapes plus the activation width.

KV pages are int8 with one fp32 scale per (page, kv_head), K and V
independent.  ``quantize_kv_write`` keeps the reference's invariant (every
stored row is quantized under a scale covering every row its page has
received since its first write) and its order of operations, but writes
the pool IN PLACE: the stored rows it rescales are gathered before any
new row lands, so the result equals the reference's functional update.

Every rounding here is the reference's: ``torch.round`` and ``jnp.round``
both round half to even, and each dequantize is one fp32 multiply, the
same multiply the kernels run on chip (``csrc/*.cu``: ``__fmul_rn``).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

QMAX = {8: 127, 4: 7}
BITS_BY_NAME = {"int8": 8, "int4": 4}  # engine/CLI mode names -> bit widths


def _qmax(bits: int) -> int:
    try:
        return QMAX[bits]
    except KeyError:
        raise ValueError(f"unsupported quantization bits: {bits}") from None


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, as ``jnp``'s division and PyTorch's on the
    CPU round it.  On a CUDA tensor PyTorch divides by a Python number as a
    multiply by its reciprocal (two roundings: amax / 127 then lands one
    ulp off the CPU's scale), so the divisor goes in as a tensor."""
    return x / torch.full_like(x, d)


def block_scales(w: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """One fp32 scale per ``w[..., i, :, :]`` diagonal block (shape
    ``w.shape[:-2] + (1, 1)``)."""
    amax = torch.amax(torch.abs(w.float()), dim=(-2, -1), keepdim=True)
    return torch.where(amax > 0, _div(amax, _qmax(bits)),
                       torch.ones_like(amax))


def pack_int4(v: torch.Tensor) -> torch.Tensor:
    """Pack int8-held int4 values ([-7, 7]) pairwise along the last axis:
    byte = (odd & 0xF) << 4 | (even & 0xF).  Last axis must be even."""
    if v.shape[-1] % 2:
        raise ValueError(
            f"int4 packing needs an even last axis, got {tuple(v.shape)}")
    vi = v.to(torch.int32)
    lo = vi[..., 0::2] & 0xF
    hi = vi[..., 1::2] & 0xF
    return ((hi << 4) | lo).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: (..., n) int8 -> (..., 2n) int8."""
    b = packed.to(torch.int32)          # sign-extends the signed byte
    lo = ((b & 0xF) ^ 8) - 8            # sign-extend the low nibble
    hi = b >> 4                         # arithmetic shift: the high one
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], 2 * packed.shape[-1]).to(
        torch.int8)


def quantize_factor(w: torch.Tensor, bits: int = 8
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One block-diagonal factor -> (int8 values, per-block fp32 scales):
    round half to even, symmetric range ±QMAX[bits], int4 nibble-packed
    along the last axis."""
    scale = block_scales(w, bits)
    qm = _qmax(bits)
    q = torch.clamp(torch.round(w.float() / scale), -qm, qm).to(torch.int8)
    if bits == 4:
        q = pack_int4(q)
    return q, scale


def dequantize_factor(q: torch.Tensor, scale: torch.Tensor, *,
                      unpacked_dim: Optional[int] = None) -> torch.Tensor:
    """(values, scales) -> fp32 factor.  ``unpacked_dim`` is the true
    last-axis width; when it differs from ``q.shape[-1]`` the values are
    int4-packed."""
    if unpacked_dim is not None and unpacked_dim != q.shape[-1]:
        q = unpack_int4(q)[..., :unpacked_dim]
    return q.float() * scale


def quantize_monarch(params: dict[str, Any], bits: int = 8
                     ) -> dict[str, Any]:
    """{"L", "R"(, "b")} -> {"Lq", "Ls", "Rq", "Rs"(, "b")}."""
    Lq, Ls = quantize_factor(params["L"], bits)
    Rq, Rs = quantize_factor(params["R"], bits)
    out: dict[str, Any] = {"Lq": Lq, "Ls": Ls, "Rq": Rq, "Rs": Rs}
    if "b" in params:
        out["b"] = params["b"]
    return out


def dequantize_monarch(params: dict[str, Any], k: int, p: int
                       ) -> dict[str, Any]:
    """Inverse container transform; (k, p) disambiguates int4 packing."""
    out: dict[str, Any] = {
        "L": dequantize_factor(params["Lq"], params["Ls"], unpacked_dim=p),
        "R": dequantize_factor(params["Rq"], params["Rs"], unpacked_dim=k),
    }
    if "b" in params:
        out["b"] = params["b"]
    return out


def is_quantized(params: Any) -> bool:
    """A quantized Monarch container: int8/int4 factors plus scales."""
    return isinstance(params, dict) and "Lq" in params and "Rq" in params


def quant_bits(params: dict[str, Any], din: int) -> int:
    """8 or 4, recovered from static shapes (packed iff the stored
    contraction axis is half the true one)."""
    k = params["Ls"].shape[-3]
    p = din // k
    return 4 if params["Lq"].shape[-1] != p else 8


def quantized_out_dim(params: dict[str, Any]) -> int:
    q = params["Rs"].shape[-3]
    s = params["Rq"].shape[-2]
    return q * s


def quant_error_stats(w: torch.Tensor, bits: int = 8) -> dict[str, float]:
    """Reconstruction error of per-block quantization: max abs error, max
    per-block relative error (vs the block's absmax), Frobenius relative
    error, and the per-block bound ``0.5 / QMAX[bits]``."""
    q, scale = quantize_factor(w, bits)
    deq = dequantize_factor(q, scale, unpacked_dim=w.shape[-1])
    wf = w.float()
    err = torch.abs(deq - wf)
    amax = torch.amax(torch.abs(wf), dim=(-2, -1), keepdim=True)
    rel = torch.where(amax > 0, err / amax, torch.zeros_like(err))
    fro = torch.linalg.vector_norm((deq - wf).reshape(-1)) / torch.clamp(
        torch.linalg.vector_norm(wf.reshape(-1)), min=1e-30)
    return {
        "max_abs_err": float(torch.max(err)),
        "max_block_rel_err": float(torch.max(rel)),
        "fro_rel_err": float(fro),
        "bound_block_rel": 0.5 / _qmax(bits),
    }


def quantize_tree(params: Any, bits: int = 8) -> Any:
    """Replace every Monarch ``{"L", "R"}`` dict of a parameter tree with
    its quantized container (stacked factors quantize per (layer, block));
    dense weights, norms, embeddings and biases pass through untouched."""
    if isinstance(params, dict):
        if "L" in params and "R" in params:
            return quantize_monarch(params, bits)
        return {k: quantize_tree(v, bits) for k, v in params.items()}
    return params


def tree_weight_bytes(params: Any) -> int:
    """Total bytes of every tensor leaf (the decode step's weight
    traffic)."""
    if isinstance(params, dict):
        return sum(tree_weight_bytes(v) for v in params.values())
    if isinstance(params, torch.Tensor):
        return params.element_size() * params.numel()
    return 0


# ---------------------------------------------------------------------------
# KV-cache page quantization (paged serving pool)
# ---------------------------------------------------------------------------

KV_QMAX = 127.0
# engine/pool ``kv_dtype`` mode names -> stored bytes per KV element
KV_DTYPE_BYTES = {"fp32": 4.0, "bf16": 2.0, "int8": 1.0}


def kv_page_bytes(n_layers: int, n_kv_heads: int, head_dim: int,
                  page_size: int, kv_dtype: str = "fp32") -> int:
    """Physical bytes one KV page pins across the whole stack: k+v rows at
    the stored width, plus (int8 only) the per-(page, head) fp32 scales."""
    try:
        itemsize = KV_DTYPE_BYTES[kv_dtype]
    except KeyError:
        raise ValueError(
            f"kv_dtype must be one of {sorted(KV_DTYPE_BYTES)}, "
            f"got {kv_dtype!r}") from None
    data = 2 * n_layers * n_kv_heads * head_dim * page_size * itemsize
    scales = 2 * n_layers * n_kv_heads * 4 if kv_dtype == "int8" else 0
    return int(data) + scales


def quantize_kv_page(rows: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """One full page (..., page_size, KV, hd) -> (int8 values, (..., KV)
    fp32 scales): symmetric per-(page, head), range ±KV_QMAX."""
    rows = rows.float()
    amax = torch.amax(torch.abs(rows), dim=(-3, -1))         # (..., KV)
    scale = torch.where(amax > 0, _div(amax, KV_QMAX),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(rows / scale[..., None, :, None]),
                    -KV_QMAX, KV_QMAX).to(torch.int8)
    return q, scale


def dequantize_kv_pages(pages: torch.Tensor,
                        scales: torch.Tensor) -> torch.Tensor:
    """(..., page, KV, hd) int8 x (..., KV) fp32 -> fp32 pages: the single
    cast-multiply the int8-page span kernel runs on chip."""
    return pages.float() * scales[..., None, :, None]


def quantize_kv_write(pages: torch.Tensor, scales: torch.Tensor,
                      phys: torch.Tensor, off: torch.Tensor,
                      rows: torch.Tensor,
                      rescale_phys: Optional[torch.Tensor] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter new K (or V) span rows into the int8 page pool IN PLACE,
    maintaining the per-(page, head) scales; returns (pages, scales), the
    tensors given.

    pages: (P, page, KV, hd) int8; scales: (P, KV) fp32; phys/off: (B, S)
    physical page / row offset per span position (masked positions already
    redirected to the sink page 0); rows: (B, S, KV, hd).  ``rescale_phys``
    (B, K): the page set whose stored rows are rescaled, covering every
    non-sink page ``phys`` names (extra pages rescale by exactly 1.0).

    The reference's steps, in its order: (1) a row at offset 0 is its
    page's first write, so that page's scale resets to 0 (masked positions
    reset the sink); (2) the rows' per-head absmax / 127 is scatter-maxed
    into the scales (max does not depend on the order); (3) the stored rows
    of the rescale set, gathered before anything is written, are rescaled
    by old/new (a guarded ratio: exactly 1.0 where the scale did not move,
    and round(q * 1.0) == q, so untouched and shared pages stay
    bit-identical); (4) the new rows are quantized under the final scales
    (round, then clamp, then int8) and written.  Duplicate indices occur
    only at the sink page, which is never read unmasked."""
    rows = rows.float()
    KV = scales.shape[-1]
    phys_l = phys.long()
    reset = torch.where(off == 0, phys_l, torch.zeros_like(phys_l))
    # index_fill, not ``scales0[idx] = 0.0``: on a CUDA tensor that
    # assignment copies the 0.0 to the device and waits for the stream
    scales0 = scales.index_fill(0, reset.reshape(-1), 0.0)
    amax = torch.amax(torch.abs(rows), dim=-1)                # (B, S, KV)
    idx = phys_l.reshape(-1, 1).expand(-1, KV)
    new_scales = scales0.scatter_reduce(
        0, idx, _div(amax, KV_QMAX).reshape(-1, KV), "amax",
        include_self=True)
    rp = phys_l if rescale_phys is None else rescale_phys.long()
    ratio = torch.where(new_scales > 0, scales0 / new_scales,
                        torch.ones_like(new_scales))[rp]       # (B, K, KV)
    rescaled = torch.round(pages[rp].float()
                           * ratio[:, :, None, :, None]).to(torch.int8)
    pages[rp] = rescaled
    s = new_scales[phys_l]                                    # (B, S, KV)
    q = torch.clamp(
        torch.round(rows / torch.where(s > 0, s, torch.ones_like(s))[
            ..., None]), -KV_QMAX, KV_QMAX).to(torch.int8)
    pages[phys_l, off.long()] = q
    scales.copy_(new_scales)
    return pages, scales


__all__ = [
    "QMAX", "BITS_BY_NAME", "block_scales", "pack_int4", "unpack_int4",
    "quantize_factor", "dequantize_factor",
    "quantize_monarch", "dequantize_monarch",
    "is_quantized", "quant_bits", "quantized_out_dim",
    "quant_error_stats", "quantize_tree", "tree_weight_bytes",
    "KV_QMAX", "KV_DTYPE_BYTES", "kv_page_bytes",
    "quantize_kv_page", "dequantize_kv_pages", "quantize_kv_write",
]
