"""Dense-to-sparse (D2S) transformation (paper Sec. III-A; port of
``repro.core.d2s``).

Projects a dense weight matrix W onto the closest Monarch matrix in
Frobenius norm, *without retraining*, via batched rank-1 SVD (the analytical
method of Dao et al., Monarch, ICML'22, adopted by the paper).

With y = x @ M and the folded convention,

    M[(ki*p + pi), (qi*s + si)] = L[ki, qi, pi] * R[qi, si, ki]

so the 4-D reshape W.reshape(k, p, q, s) sliced at a fixed (ki, qi) is the
rank-1 outer product L[ki, qi, :] (x) R[qi, :, ki].  The optimal Frobenius
approximation of each (p x s) slice is its leading singular triple.

The SVD is ``torch.linalg.svd`` on the weight's own device (LAPACK on the
CPU, cuSOLVER on the card), as the reference calls ``jnp.linalg.svd``
outside any kernel.  Singular vectors are defined up to sign, and the
libraries choose signs differently: the factors may differ in sign per
slice, while ``monarch_to_dense(L, R)`` and the projection error do not.

The leading triple is taken in float64, whatever the weight's dtype, and
the factors cast back.  A slice whose two largest singular values nearly
tie turns its leading vectors by ~eps * s0 / (s0 - s1): random 32 x 32
slices come within 0.1% of a tie, so an fp32 SVD moves a 1024 x 1024
projection by ~1e-5 of ||M||, differently in each driver (XLA, LAPACK,
cuSOLVER).  In float64 that is ~1e-13, and the card's and the CPU's
factors agree to their fp32 rounding.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core.monarch import MonarchDims, make_dims, monarch_to_dense


def project_to_monarch(
    w: torch.Tensor, dims: Optional[MonarchDims] = None, policy: str = "paper"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Optimal Frobenius-norm Monarch approximation of dense ``w`` (din, dout).

    Returns the factors (L, R) with shapes (k, q, p) and (q, s, k).  Leading
    axes of a stacked ``w`` (..., din, dout) stay, and every slice is
    projected in the same batched SVD call: (..., k, q, p), (..., q, s, k).
    """
    *lead, din, dout = w.shape
    if dims is None:
        dims = make_dims(din, dout, policy=policy)
    k, q, p, s = dims.k, dims.q, dims.p, dims.s
    # (..., din, dout) -> (..., k, p, q, s) -> batch the (p, s) slices over
    # (..., k, q)
    w4 = w.reshape(*lead, k, p, q, s).transpose(-3, -2)   # (..., k, q, p, s)
    u, sv, vt = torch.linalg.svd(w4.to(torch.float64), full_matrices=False)
    sigma0 = sv[..., 0]                      # (..., k, q)
    u0 = u[..., :, 0]                        # (..., k, q, p)
    v0 = vt[..., 0, :]                       # (..., k, q, s)
    root = torch.sqrt(torch.clamp(sigma0, min=0.0))
    L = u0 * root[..., None]                 # (..., k, q, p)
    Rkqs = v0 * root[..., None]              # (..., k, q, s)
    R = Rkqs.permute(*range(len(lead)), -2, -1, -3)   # (..., q, s, k)
    return L.to(w.dtype), R.to(w.dtype).contiguous()


def projection_error(w: torch.Tensor, L: torch.Tensor,
                     R: torch.Tensor) -> torch.Tensor:
    """Relative Frobenius error ||W - M||_F / ||W||_F of the projection
    (one per slice of a stacked ``w``)."""
    m = monarch_to_dense(L, R)
    num = torch.linalg.matrix_norm(w - m)
    return num / torch.clamp(torch.linalg.matrix_norm(w), min=1e-30)


@dataclasses.dataclass
class D2SReport:
    """Bookkeeping for one converted layer (feeds Fig. 2b style accounting)."""

    name: str
    din: int
    dout: int
    dims: MonarchDims
    rel_error: float

    @property
    def dense_params(self) -> int:
        return self.din * self.dout

    @property
    def sparse_params(self) -> int:
        return self.dims.params

    @property
    def compression(self) -> float:
        return self.dense_params / max(self.sparse_params, 1)


def _flatten(tree: Any, path: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict, in ``jax.tree_util``'s order
    (a dict's keys sorted) and with its ``keystr`` paths."""
    if isinstance(tree, dict):
        return [pair for key in sorted(tree)
                for pair in _flatten(tree[key], f"{path}[{key!r}]")]
    return [(path, tree)]


def _replace(tree: Any, new: dict[str, Any], path: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _replace(v, new, f"{path}[{k!r}]") for k, v in tree.items()}
    return new.get(path, tree)


def convert_tree(
    params: Any,
    select: Callable[[str, Any], bool],
    policy: str = "paper",
    nblocks: Optional[int] = None,
) -> tuple[Any, list[D2SReport]]:
    """D2S-convert every selected 2-D weight in a nested dict of tensors.

    ``select(path, leaf) -> bool`` marks the *parameterized matmuls* (paper
    Fig. 2b: attention projections + FFN weights; attention-score and AV
    matmuls have no weights and are untouched by construction).  ``path``
    is the string ``jax.tree_util.keystr`` gives for the same tree in the
    reference (e.g. ``['decoder']['layers']['attn']['wq']['w']``), and the
    reports come in the reference's leaf order.

    Returns the new tree — selected leaves replaced by
    ``{"L": ..., "R": ...}`` dicts on the leaf's device — plus per-layer
    reports.  A stacked leaf (scan-stacked layers, expert stacks) is
    projected in one batch; its error is the worst slice's.
    """
    reports: list[D2SReport] = []
    new: dict[str, Any] = {}
    for pathstr, leaf in _flatten(params):
        if not (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2
                and select(pathstr, leaf)):
            continue
        *lead, din, dout = leaf.shape
        dims = make_dims(din, dout, policy=policy, nblocks=nblocks)
        L, R = project_to_monarch(leaf, dims)
        err = float(projection_error(leaf, L, R).max())
        reports.append(
            D2SReport(name=pathstr, din=din, dout=dout, dims=dims,
                      rel_error=err))
        new[pathstr] = {"L": L, "R": R}
    return _replace(params, new), reports


__all__ = [
    "project_to_monarch",
    "projection_error",
    "convert_tree",
    "D2SReport",
]
