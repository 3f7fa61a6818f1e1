"""Monarch block-diagonal factorization (port of ``repro.core.monarch``).

A Monarch matrix (paper Eq. 1, M = P.L.P.R.P) is the product of two
block-diagonal matrices interleaved with stride permutations, in the
*folded* convention: the permutations are absorbed into the reshape and
transpose of the multiply, never materialized.

Conventions (y = x @ M, x: (..., din), y: (..., dout)):

    x   -> reshape (..., k, p)                      k * p == din
    u   =  einsum('kqp,...kp->...kq', L)            L: (k, q, p)   stage 1
    ut  =  swapaxes(u, -1, -2)                      stride permutation P
    y   =  einsum('qsk,...qk->...qs', R)            R: (q, s, k)   stage 2
    y   -> reshape (..., q * s)                     q * s == dout

The dimension bookkeeping is framework-free and copied verbatim, so both
packages factorize every projection identically.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


# ---------------------------------------------------------------------------
# Dimension bookkeeping
# ---------------------------------------------------------------------------


def closest_divisor(n: int, target: int) -> int:
    """Divisor of ``n`` closest to ``target`` (ties broken downward)."""
    if n <= 0:
        raise ValueError(f"n must be positive, got {n}")
    best, best_dist = 1, abs(1 - target)
    for d in range(1, int(math.isqrt(n)) + 1):
        if n % d == 0:
            for cand in (d, n // d):
                dist = abs(cand - target)
                if dist < best_dist or (dist == best_dist and cand < best):
                    best, best_dist = cand, dist
    return best


@dataclasses.dataclass(frozen=True)
class MonarchDims:
    """Shape bookkeeping for one Monarch-factorized matmul.

    din  = k * p   (stage-1: k blocks, each p -> q)
    dmid = k * q   (the permuted intermediate)
    dout = q * s   (stage-2: q blocks, each k -> s)
    """

    din: int
    dout: int
    k: int
    q: int

    def __post_init__(self) -> None:
        if self.din % self.k:
            raise ValueError(f"k={self.k} must divide din={self.din}")
        if self.dout % self.q:
            raise ValueError(f"q={self.q} must divide dout={self.dout}")

    @property
    def p(self) -> int:
        return self.din // self.k

    @property
    def s(self) -> int:
        return self.dout // self.q

    @property
    def dmid(self) -> int:
        return self.k * self.q

    @property
    def l_shape(self) -> tuple[int, int, int]:
        return (self.k, self.q, self.p)

    @property
    def r_shape(self) -> tuple[int, int, int]:
        return (self.q, self.s, self.k)

    @property
    def params(self) -> int:
        return self.k * self.q * self.p + self.q * self.s * self.k

    @property
    def dense_params(self) -> int:
        return self.din * self.dout

    @property
    def compression(self) -> float:
        return self.dense_params / self.params

    def flops(self, tokens: int) -> int:
        """Multiply-add FLOPs (2 * MACs) for ``tokens`` row-vectors."""
        return 2 * tokens * self.params

    def dense_flops(self, tokens: int) -> int:
        return 2 * tokens * self.dense_params


def paper_dims(din: int, dout: int) -> MonarchDims:
    """Paper policy: square-ish blocks b ~= sqrt(din)."""
    b = closest_divisor(din, int(round(math.sqrt(din))))
    k = din // b
    q = k if dout % k == 0 else closest_divisor(dout, k)
    return MonarchDims(din=din, dout=dout, k=k, q=q)


def mxu_dims(din: int, dout: int, lane: int = 128) -> MonarchDims:
    """Block dims that are multiples of ``lane`` where possible (the
    reference's TPU co-design policy, kept so ``:mxu`` configs agree)."""
    p = closest_divisor(din, lane)
    s = closest_divisor(dout, lane)
    return MonarchDims(din=din, dout=dout, k=din // p, q=dout // s)


def make_dims(
    din: int,
    dout: int,
    policy: str = "paper",
    nblocks: Optional[int] = None,
) -> MonarchDims:
    if nblocks is not None:
        k = closest_divisor(din, nblocks)
        q = closest_divisor(dout, nblocks)
        return MonarchDims(din=din, dout=dout, k=k, q=q)
    if policy == "paper":
        return paper_dims(din, dout)
    if policy == "mxu128":
        return mxu_dims(din, dout)
    raise ValueError(f"unknown monarch dims policy: {policy}")


# ---------------------------------------------------------------------------
# Multiplication
# ---------------------------------------------------------------------------


def _promote(*ts: torch.Tensor) -> torch.dtype:
    """The dtype ``jnp.einsum`` would compute in: the promotion of its
    operands (``torch.einsum`` refuses mixed dtypes, so it is explicit)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def blockdiag_multiply(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., k, p) times block-diagonal w: (k, q, p) -> (..., k, q)."""
    dt = _promote(x, w)
    return torch.einsum("kqp,...kp->...kq", w.to(dt), x.to(dt))


def monarch_multiply(x: torch.Tensor, L: torch.Tensor,
                     R: torch.Tensor) -> torch.Tensor:
    """y = x @ M with M the Monarch matrix defined by factors (L, R).

    Computes in the promotion of the operand dtypes, as the reference's
    einsums do: bf16 x with fp32 factors returns fp32.

    Stacked experts (a mixture-of-experts layer, the reference's product
    under ``jax.vmap``): L (E, k, q, p), R (E, q, s, k) and x (E, ...,
    k*p), expert e's rows through expert e's factors."""
    *lead, k, q, p = L.shape
    *lead_r, q2, s, k2 = R.shape
    if (q2, k2) != (q, k) or lead_r != lead or len(lead) > 1:
        raise ValueError(f"incompatible factors L{tuple(L.shape)} "
                         f"R{tuple(R.shape)}")
    *batch, din = x.shape
    if din != k * p or batch[:len(lead)] != lead:
        raise ValueError(f"x{tuple(x.shape)} does not fit factors "
                         f"L{tuple(L.shape)}")
    dt = _promote(x, L, R)
    xr = x.reshape(*batch, k, p).to(dt)
    if lead:
        u = torch.einsum("ekqp,e...kp->e...kq", L.to(dt), xr)
        y = torch.einsum("eqsk,e...qk->e...qs", R.to(dt),
                         u.transpose(-1, -2))
        return y.reshape(*batch, q * s)
    u = blockdiag_multiply(xr, L.to(dt))
    ut = u.transpose(-1, -2)  # (..., q, k): the folded permutation
    y = torch.einsum("qsk,...qk->...qs", R.to(dt), ut)
    return y.reshape(*batch, q * s)


def monarch_to_dense(L: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Materialize the dense (din, dout) matrix represented by (L, R):
    W[(ki*p + pi), (qi*s + si)] = L[ki, qi, pi] * R[qi, si, ki].  Leading
    axes of stacked factors (..., k, q, p) stay: (..., din, dout)."""
    *lead, k, q, p = L.shape
    s = R.shape[-2]
    dt = _promote(L, R)
    w4 = torch.einsum("...kqp,...qsk->...kpqs", L.to(dt), R.to(dt))
    return w4.reshape(*lead, k * p, q * s)


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------


def init_monarch(
    gen: torch.Generator,
    dims: MonarchDims,
    dtype: torch.dtype = torch.float32,
    scale: Optional[float] = None,
    device: Optional[torch.device] = None,
) -> dict[str, torch.Tensor]:
    """Monarch factors with the reference's variances (var(L) = 1/p,
    var(R) = 1/k, so var(M) ~= 1/din).  Matches ``repro`` in distribution
    only: ``torch.Generator`` draws other numbers than ``jax.random``."""
    dev = device if device is not None else gen.device
    l_std = math.sqrt(1.0 / dims.p)
    r_std = math.sqrt(1.0 / dims.k)
    if scale is not None:
        r_std *= scale
    L = torch.randn(dims.l_shape, generator=gen, device=dev) * l_std
    R = torch.randn(dims.r_shape, generator=gen, device=dev) * r_std
    return {"L": L.to(dtype), "R": R.to(dtype)}


# ---------------------------------------------------------------------------
# Block-structure description consumed by the CIM mapper
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockDiagSpec:
    """Shape-only description of one block-diagonal factor, as seen by the
    CIM mapping layer (repro_torch.cim.mapping): ``nblocks`` blocks, each
    ``rows x cols`` (rows = crossbar wordlines = input dim of the block)."""

    nblocks: int
    rows: int
    cols: int
    name: str = ""

    @property
    def nnz(self) -> int:
        return self.nblocks * self.rows * self.cols

    @property
    def total_rows(self) -> int:
        return self.nblocks * self.rows

    @property
    def total_cols(self) -> int:
        return self.nblocks * self.cols


def stage_specs(dims: MonarchDims, name: str = "") -> tuple[BlockDiagSpec, BlockDiagSpec]:
    """The two block-diagonal factors of a Monarch matmul as mapper specs."""
    l_spec = BlockDiagSpec(dims.k, dims.p, dims.q, name=f"{name}/L")
    r_spec = BlockDiagSpec(dims.q, dims.k, dims.s, name=f"{name}/R")
    return l_spec, r_spec


__all__ = [
    "MonarchDims",
    "BlockDiagSpec",
    "blockdiag_multiply",
    "monarch_multiply",
    "monarch_to_dense",
    "init_monarch",
    "make_dims",
    "paper_dims",
    "mxu_dims",
    "closest_divisor",
    "stage_specs",
]
