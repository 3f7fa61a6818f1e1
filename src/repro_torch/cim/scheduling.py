"""Mapping-aware scheduling (paper Sec. III-C).

Turns a ``Mapping`` into per-array temporal cycles of row-group activations
and column reads.  For *Linear*/*SparseMap* a matmul is a single full-array
activation per array (all blocks parallel); for *DenseMap* each array issues
one cycle per block-row group of the target matrix (intra-array
sequentiality), activating only that group's wordlines and reading only the
target lane's bitlines — which is what permits the lower ADC resolution.

Beyond-paper scheduler optimization (``coactivate=True``): matmuls that
consume the *same input vector* (e.g. the Q/K/V projections, or all L-stages
packed in one array) and whose cycles drive identical row groups are merged
into one activation that reads the union of their (disjoint) columns —
amortizing the analog MVM activation across operations.  Validated by the
functional emulator and evaluated in benchmarks/fig7_latency_energy.py.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Iterable, Sequence

from repro_torch.cim.mapping import Mapping, MatrixInfo, Placement


@dataclasses.dataclass(frozen=True)
class Drive:
    row_off: int
    vec_off: int
    length: int


@dataclasses.dataclass(frozen=True)
class Readout:
    col_off: int
    vec_off: int
    length: int
    matrix: str


@dataclasses.dataclass(frozen=True)
class CycleOp:
    """One temporal step on one array: drive row groups, read columns."""

    array_id: int
    drives: tuple[Drive, ...]
    reads: tuple[Readout, ...]

    @property
    def active_rows(self) -> int:
        return sum(d.length for d in self.drives)

    @property
    def read_cols(self) -> int:
        return sum(r.length for r in self.reads)

    @property
    def active_cells(self) -> int:
        """Cells carrying current: driven rows x *read* columns (unselected
        bitlines are floated — selective column activation, Sec. I)."""
        return self.active_rows * self.read_cols


def _cycles_for_matrix(mapping: Mapping, info: MatrixInfo) -> list[CycleOp]:
    """Schedule one matmul: per array, group placements by row group."""
    per_array: dict[int, dict[int, list[Placement]]] = defaultdict(lambda: defaultdict(list))
    for p in info.placements:
        per_array[p.array_id][p.row_off].append(p)
    cycles: list[CycleOp] = []
    for array_id in sorted(per_array):
        row_groups = per_array[array_id]
        if mapping.strategy in ("linear", "sparse"):
            # all rows at once — blocks occupy disjoint rows and columns
            drives = tuple(
                Drive(p.row_off, p.vec_in_off, p.rows)
                for grp in row_groups.values()
                for p in grp
            )
            reads = tuple(
                Readout(p.col_off, p.vec_out_off, p.cols, p.matrix)
                for grp in row_groups.values()
                for p in grp
            )
            cycles.append(CycleOp(array_id, drives, reads))
        else:
            # dense: temporal scheduling, one cycle per placed block.  Two
            # partitions of the same factor may share an array's wordlines
            # with *different* input slices — they can never co-activate, so
            # each block is its own cycle (the intra-array sequentiality the
            # paper trades for capacity, Sec. IV-B).
            for row_off in sorted(row_groups):
                for p in sorted(row_groups[row_off], key=lambda p: p.vec_in_off):
                    cycles.append(
                        CycleOp(
                            array_id,
                            (Drive(p.row_off, p.vec_in_off, p.rows),),
                            (Readout(p.col_off, p.vec_out_off, p.cols, p.matrix),),
                        )
                    )
    return cycles


def schedule_matmul(mapping: Mapping, name: str) -> list[CycleOp]:
    return _cycles_for_matrix(mapping, mapping.matrices[name])


def schedule_group(
    mapping: Mapping, names: Sequence[str], coactivate: bool = False
) -> list[CycleOp]:
    """Schedule several matmuls; with ``coactivate`` merge cycles that share
    (array, drives) — only valid when the matmuls consume the same input."""
    all_cycles: list[CycleOp] = []
    for n in names:
        all_cycles.extend(schedule_matmul(mapping, n))
    if not coactivate:
        return all_cycles
    merged: dict[tuple, CycleOp] = {}
    for c in all_cycles:
        key = (c.array_id, c.drives)
        if key in merged:
            prev = merged[key]
            taken = {(r.col_off, r.length) for r in prev.reads}
            extra = tuple(r for r in c.reads if (r.col_off, r.length) not in taken)
            merged[key] = CycleOp(c.array_id, c.drives, prev.reads + extra)
        else:
            merged[key] = c
    return list(merged.values())


def cycles_by_array(cycles: Iterable[CycleOp]) -> dict[int, list[CycleOp]]:
    out: dict[int, list[CycleOp]] = defaultdict(list)
    for c in cycles:
        out[c.array_id].append(c)
    return out


def validate_no_column_crosstalk(mapping: Mapping, cycles: Iterable[CycleOp]) -> None:
    """Assert that within each cycle, every read column receives current only
    from rows belonging to the placement that owns the column (the scheduler
    invariant that makes DenseMap correct; property-tested)."""
    placements_by_array: dict[int, list[Placement]] = defaultdict(list)
    for info in mapping.matrices.values():
        for p in info.placements:
            placements_by_array[p.array_id].append(p)
    for c in cycles:
        driven = set()
        for d in c.drives:
            driven.update(range(d.row_off, d.row_off + d.length))
        for r in c.reads:
            cols = set(range(r.col_off, r.col_off + r.length))
            owners = [
                p
                for p in placements_by_array[c.array_id]
                if p.matrix == r.matrix
                and p.col_off == r.col_off
                and p.cols == r.length
            ]
            assert owners, f"read {r} has no owning placement"
            owner_rows = set()
            for p in owners:
                owner_rows.update(range(p.row_off, p.row_off + p.rows))
            for p in placements_by_array[c.array_id]:
                p_cols = set(range(p.col_off, p.col_off + p.cols))
                p_rows = set(range(p.row_off, p.row_off + p.rows))
                if p_cols & cols and p_rows & driven:
                    if not (p.matrix == r.matrix and p_rows <= owner_rows | p_rows):
                        # any foreign placement intersecting both the driven
                        # rows and the read columns corrupts the dot product
                        overlap_rows = p_rows & driven
                        if p not in owners and overlap_rows:
                            raise AssertionError(
                                f"crosstalk: array {c.array_id} cols {r.col_off}.."
                                f"{r.col_off + r.length} read while foreign rows "
                                f"{sorted(overlap_rows)[:4]}... of {p.matrix} driven"
                            )


__all__ = [
    "CycleOp",
    "Drive",
    "Readout",
    "schedule_matmul",
    "schedule_group",
    "cycles_by_array",
    "validate_no_column_crosstalk",
]
