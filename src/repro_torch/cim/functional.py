"""Functional (numeric) emulation of CIM crossbar execution (port of
``repro.cim.functional``).

Programs the mapped weights into dense m x m array images and executes the
schedule with crossbar physics: a cycle drives voltages on its wordlines and
each *read* bitline integrates current from **all** driven rows in that
column (Ohm + Kirchhoff, paper Fig. 1).  Nothing about block structure is
assumed at execution time — so any mapping/scheduling bug (lane collision,
wrong shift, crosstalk between packed diagonals) shows up as a numeric
mismatch against the Monarch product.  This is the reproduction's
ground-truth test of Sec. III-B2a (rotations/shifts) and Sec. III-C
(mapping-aware scheduling).

The arrays, drives and currents are float64 tensors on the weights' device;
which wordlines a cycle has driven is host bookkeeping, as the placements
and cycles are.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.cim.mapping import Mapping
from repro_torch.cim.scheduling import CycleOp


def program_arrays(mapping: Mapping,
                   weights: dict[str, torch.Tensor]) -> dict[int, torch.Tensor]:
    """Write weights into array images.

    ``weights[name]`` is the full logical matrix (in_dim x out_dim) of each
    mapped matrix (dense, or the block-diagonal factor *materialized dense* —
    zeros off-diagonal).  Placements copy the sub-tile
    ``W[vec_in_off : +rows, vec_out_off : +cols]`` to (row_off, col_off).
    The images take the weights' dtype and device.
    """
    arrays: dict[int, torch.Tensor] = {}
    for info in mapping.matrices.values():
        w = weights[info.name]
        assert tuple(w.shape) == (info.in_dim, info.out_dim), (
            info.name,
            tuple(w.shape),
            (info.in_dim, info.out_dim),
        )
        for p in info.placements:
            img = arrays.get(p.array_id)
            if img is None:
                img = arrays[p.array_id] = torch.zeros(
                    (mapping.m, mapping.m), dtype=w.dtype, device=w.device)
            tile = w[p.vec_in_off : p.vec_in_off + p.rows, p.vec_out_off : p.vec_out_off + p.cols]
            region = img[p.row_off : p.row_off + p.rows, p.col_off : p.col_off + p.cols]
            if bool((region != 0).any()):
                raise AssertionError(
                    f"placement collision in array {p.array_id} for {info.name}"
                )
            region.copy_(tile)
    return arrays


def execute_matmul(
    mapping: Mapping,
    arrays: dict[int, torch.Tensor],
    cycles: list[CycleOp],
    inputs: dict[str, torch.Tensor],
) -> dict[str, torch.Tensor]:
    """Run scheduled cycles with crossbar physics; returns per-matrix outputs
    (float64, on the arrays' device).

    ``inputs[name]`` is the logical input vector of each matmul being
    executed (co-activated groups may contain several matrices).  Partial
    products accumulate into logical output vectors via the placements'
    addressing (the scheduler's address generation, Sec. III-C).
    """
    dev = next(iter(arrays.values())).device
    outs: dict[str, torch.Tensor] = {}
    for info in mapping.matrices.values():
        if info.name in inputs:
            outs[info.name] = torch.zeros((info.out_dim,), dtype=torch.float64,
                                          device=dev)
    for c in cycles:
        img = arrays[c.array_id].to(torch.float64)
        m = mapping.m
        # Wordline voltages: a physical row line is shared by every column,
        # so co-activated matmuls must agree on the driven values (they share
        # the input vector by construction — enforced numerically here).
        v = torch.zeros((m,), dtype=torch.float64, device=dev)
        driven = np.zeros((m,), dtype=bool)
        for r in c.reads:
            x = inputs[r.matrix]
            for d in c.drives:
                seg = x[d.vec_off : d.vec_off + d.length].to(dev, torch.float64)
                rows = slice(d.row_off, d.row_off + d.length)
                prev = driven[rows]
                if prev.any():
                    mask = torch.from_numpy(prev).to(dev)
                    if not torch.allclose(v[rows][mask], seg[mask]):
                        raise AssertionError(
                            f"conflicting drive on array {c.array_id} rows "
                            f"{d.row_off}..{d.row_off + d.length}: co-activated "
                            "matmuls must share the input vector"
                        )
                v[rows] = seg
                driven[rows] = True
        currents = v @ img  # Kirchhoff sum over ALL driven rows per bitline
        for r in c.reads:
            outs[r.matrix][r.vec_off : r.vec_off + r.length] += currents[
                r.col_off : r.col_off + r.length
            ]
    return outs


__all__ = ["program_arrays", "execute_matmul"]
