"""Stride permutations and the paper's permutation-folding identity (port
of ``repro.core.permutations``).

The paper (Sec. III-B3) rewrites M = P.L.P.R.P as (P.L.P) . P . (P.R.P),
folding the outer permutations into the block-diagonal factors offline so a
single explicit permutation remains.  In our folded convention the remaining
permutation is the (..., k, q) -> (..., q, k) transpose inside
``monarch_multiply``; these utilities make the explicit forms available for
(a) equivalence tests and (b) the CIM mapper, whose DenseMap lane shifting
(Sec. III-B2a) is a permutation of block assignments.
"""

from __future__ import annotations

import numpy as np
import torch


def stride_perm_indices(k: int, q: int) -> np.ndarray:
    """Index vector of the (k, q) -> (q, k) stride permutation P_{k,q}.

    out[i] = in[perm[i]]: position (qi, ki) of the output reads position
    (ki, qi) of the input.  P_{k,q} @ P_{q,k} = I.
    """
    idx = np.arange(k * q).reshape(k, q).T.reshape(-1)
    return idx


def stride_perm_matrix(k: int, q: int) -> np.ndarray:
    """Dense 0/1 matrix of P_{k,q} acting on row vectors: y = x @ P."""
    n = k * q
    perm = stride_perm_indices(k, q)
    m = np.zeros((n, n), dtype=np.float32)
    # y[i] = x[perm[i]]  =>  P[perm[i], i] = 1
    m[perm, np.arange(n)] = 1.0
    return m


def apply_stride_perm(x: torch.Tensor, k: int, q: int) -> torch.Tensor:
    """y = x @ P_{k,q} for x: (..., k*q), via reshape/transpose (free form)."""
    *batch, n = x.shape
    assert n == k * q, (n, k, q)
    return x.reshape(*batch, k, q).transpose(-1, -2).reshape(*batch, n)


def block_diag_dense(blocks) -> np.ndarray:
    """Materialize a dense block-diagonal matrix from (nb, r, c) blocks."""
    blocks = np.asarray(blocks)
    nb, r, c = blocks.shape
    out = np.zeros((nb * r, nb * c), dtype=blocks.dtype)
    for i in range(nb):
        out[i * r : (i + 1) * r, i * c : (i + 1) * c] = blocks[i]
    return out


def rotate_blocks(x: torch.Tensor, shift: int, nblocks: int) -> torch.Tensor:
    """Block-wise cyclic rotation of a vector (paper Fig. 5a).

    A DenseMap lane at diagonal index i produces outputs rotated by i block
    positions; ``rotate_blocks(y, -i, D)`` undoes it.
    """
    *batch, n = x.shape
    assert n % nblocks == 0
    xb = x.reshape(*batch, nblocks, n // nblocks)
    return torch.roll(xb, shift, dims=-2).reshape(*batch, n)


def paper_form_dense(L, R) -> np.ndarray:
    """Materialize M = P . Lb . P . Rb . P (paper Eq. 1 convention, square
    case) from folded factors, for equivalence testing against
    ``monarch_to_dense``.

    Acting on row vectors y = x @ M with x of length n = k*p:
      x @ P_{k,q=p?}: for the square case k = p = q = s = b the three
      permutations are all P_{b,b}.
    """
    k, q, p = L.shape
    qq, s, kk = R.shape
    assert (qq, kk) == (q, k)
    assert k == q and p == s and k == p, "paper form is defined for the square case"
    b = k
    P = stride_perm_matrix(b, b)
    # Blocks acting on row vectors: stage-1 block ki maps p inputs -> q outs,
    # i.e. right-multiplication by L[ki].T (p x q).
    Lb = block_diag_dense(np.transpose(np.asarray(L), (0, 2, 1)))  # (k*p, k*q)
    Rb = block_diag_dense(np.transpose(np.asarray(R), (0, 2, 1)))  # (q*k, q*s)
    # Folded multiply: y = reshape/transpose pipeline == x @ (P.T? ...)
    # x (k,p) -> block L -> (k,q) -> transpose = @P_{k,q} -> (q,k) -> block R
    # -> (q,s).  As dense algebra on row vectors:
    #   y = x @ Lb @ P_{k,q} @ Rb
    # The paper's Eq. 1 wraps this with boundary permutations P0/P2 that are
    # identity in the folded convention (input/output already block-ordered).
    return Lb @ stride_perm_matrix(k, q) @ Rb


__all__ = [
    "stride_perm_indices",
    "stride_perm_matrix",
    "apply_stride_perm",
    "block_diag_dense",
    "rotate_blocks",
    "paper_form_dense",
]
