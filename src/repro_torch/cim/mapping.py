"""Mapping sparse block-diagonal (and dense) matrices onto CIM arrays.

Implements the paper's three strategies (Sec. III-B):

* ``map_linear``    — dense tiling baseline (*Linear*).
* ``map_sparse``    — latency-optimized (*SparseMap*, Sec. III-B1): blocks on
  the main diagonal of each array, zero-padded, all blocks parallel.
* ``map_dense_pack``— capacity-optimized (*DenseMap*, Sec. III-B2): up to
  D = m/b block-diagonals per array on shifted diagonal *lanes*, with the
  rotation bookkeeping of Sec. III-B2a (lane i block-rotates the output by i;
  pairing i_R = -i_L mod D cancels the two Monarch stages' rotations; lanes
  0 and D/2 are self-inverse and must not be paired inside one array).

Placements carry explicit input/output vector routing offsets so that
``repro_torch.cim.functional`` can emulate crossbar physics cycle-by-cycle and
verify the mapping + schedule numerically against the Monarch oracle.
"""

from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Iterable, Optional, Sequence

from repro_torch.core.monarch import BlockDiagSpec


@dataclasses.dataclass(frozen=True)
class DenseMatSpec:
    """A dense (unfactorized) weight matrix: rows = input dim (wordlines)."""

    rows: int
    cols: int
    name: str = ""


@dataclasses.dataclass(frozen=True)
class Placement:
    """One contiguous weight tile inside one array.

    ``vec_in_off``/``vec_out_off`` locate the tile's slice of the *physical*
    input/output vectors of its matmul (physical = after any lane rotation),
    which is what the functional emulator and the scheduler consume.
    """

    matrix: str
    block_idx: int
    array_id: int
    row_off: int
    col_off: int
    rows: int
    cols: int
    vec_in_off: int
    vec_out_off: int
    lane: int = 0


@dataclasses.dataclass
class MatrixInfo:
    """Per-logical-matrix mapping metadata."""

    name: str
    in_dim: int
    out_dim: int
    nnz: int
    placements: list[Placement] = dataclasses.field(default_factory=list)
    lane: int = 0                    # DenseMap lane (rotation index)
    shift: int = 0                   # DenseMap row-shift absorbed from prior stage
    reduction_groups: int = 1        # row-tile partial-sum fan-in (Linear)

    @property
    def array_ids(self) -> list[int]:
        return sorted({p.array_id for p in self.placements})


@dataclasses.dataclass
class Mapping:
    strategy: str
    m: int
    matrices: dict[str, MatrixInfo]
    n_arrays: int

    # ---- utilization accounting (paper Fig. 6) ----
    def used_cells_per_array(self) -> dict[int, int]:
        used: dict[int, int] = defaultdict(int)
        for info in self.matrices.values():
            for p in info.placements:
                used[p.array_id] += p.rows * p.cols
        return used

    @property
    def utilization(self) -> float:
        """Mean ratio of valid (non-padded) cells to array capacity."""
        used = self.used_cells_per_array()
        if not used:
            return 0.0
        cap = self.m * self.m
        return sum(used.values()) / (len(used) * cap)

    @property
    def total_cells(self) -> int:
        return self.n_arrays * self.m * self.m


def _lane_capacity(m: int, rows: int, cols: int) -> tuple[int, int, int]:
    """(row slots, col slots, lanes) of the block grid inside one array."""
    dr = max(1, m // rows)
    dc = max(1, m // cols)
    lanes = dc  # lane i occupies slots (j mod dr, (j + i) mod dc)
    return dr, dc, lanes


# ---------------------------------------------------------------------------
# Linear (dense baseline)
# ---------------------------------------------------------------------------


def map_linear(mats: Sequence[DenseMatSpec], m: int) -> Mapping:
    matrices: dict[str, MatrixInfo] = {}
    next_array = 0
    for mat in mats:
        info = MatrixInfo(
            name=mat.name,
            in_dim=mat.rows,
            out_dim=mat.cols,
            nnz=mat.rows * mat.cols,
        )
        n_row_tiles = math.ceil(mat.rows / m)
        n_col_tiles = math.ceil(mat.cols / m)
        info.reduction_groups = n_row_tiles
        for rt in range(n_row_tiles):
            r0, r1 = rt * m, min((rt + 1) * m, mat.rows)
            for ct in range(n_col_tiles):
                c0, c1 = ct * m, min((ct + 1) * m, mat.cols)
                info.placements.append(
                    Placement(
                        matrix=mat.name,
                        block_idx=rt * n_col_tiles + ct,
                        array_id=next_array,
                        row_off=0,
                        col_off=0,
                        rows=r1 - r0,
                        cols=c1 - c0,
                        vec_in_off=r0,
                        vec_out_off=c0,
                    )
                )
                next_array += 1
        matrices[mat.name] = info
    return Mapping("linear", m, matrices, next_array)


# ---------------------------------------------------------------------------
# SparseMap (latency-optimized, Sec. III-B1)
# ---------------------------------------------------------------------------


def map_sparse(
    factors: Sequence[BlockDiagSpec], m: int, max_pack: Optional[int] = None
) -> Mapping:
    """Blocks of each factor on the main diagonal of dedicated arrays.

    Packing g = min(m//rows, m//cols) blocks per array keeps all blocks
    independently addressable (disjoint rows *and* columns) so a single
    full-array activation computes them all in parallel; the off-diagonal
    remainder is zero padding (the paper's Fig. 4a, utilization b/m).
    ``max_pack`` caps g to trade extra arrays for fewer serialized ADC
    conversions per array (the latency-optimized end of the spectrum).
    """
    matrices: dict[str, MatrixInfo] = {}
    next_array = 0
    for f in factors:
        info = MatrixInfo(
            name=f.name,
            in_dim=f.total_rows,
            out_dim=f.total_cols,
            nnz=f.nnz,
        )
        if f.rows > m or f.cols > m:
            # Oversized blocks: tile each block like a small dense matrix.
            n_rt = math.ceil(f.rows / m)
            n_ct = math.ceil(f.cols / m)
            info.reduction_groups = n_rt
            for b in range(f.nblocks):
                for rt in range(n_rt):
                    r0, r1 = rt * m, min((rt + 1) * m, f.rows)
                    for ct in range(n_ct):
                        c0, c1 = ct * m, min((ct + 1) * m, f.cols)
                        info.placements.append(
                            Placement(
                                matrix=f.name,
                                block_idx=b,
                                array_id=next_array,
                                row_off=0,
                                col_off=0,
                                rows=r1 - r0,
                                cols=c1 - c0,
                                vec_in_off=b * f.rows + r0,
                                vec_out_off=b * f.cols + c0,
                            )
                        )
                        next_array += 1
        else:
            g = max(1, min(m // f.rows, m // f.cols))
            if max_pack is not None:
                g = max(1, min(g, max_pack))
            for b in range(f.nblocks):
                slot = b % g
                if b and slot == 0:
                    next_array += 1
                info.placements.append(
                    Placement(
                        matrix=f.name,
                        block_idx=b,
                        array_id=next_array,
                        row_off=slot * f.rows,
                        col_off=slot * f.cols,
                        rows=f.rows,
                        cols=f.cols,
                        vec_in_off=b * f.rows,
                        vec_out_off=b * f.cols,
                    )
                )
            next_array += 1
        matrices[f.name] = info
    return Mapping("sparse", m, matrices, next_array)


# ---------------------------------------------------------------------------
# DenseMap (capacity-optimized, Sec. III-B2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MonarchPair:
    """The two factors of one Monarch matmul, for lane pairing."""

    L: BlockDiagSpec
    R: BlockDiagSpec
    name: str = ""


class _ArrayPool:
    """Lane allocator over a growing pool of same-geometry arrays.

    Allocation is *breadth-first* across existing arrays (pick the array with
    the most free lanes): a factor's partitions spread over different arrays,
    so each stage's cycles run on parallel arrays while the remaining lanes
    are filled by other matmuls that execute in other stages — capacity stays
    ~100 % without paying extra intra-array sequentiality (the scheduler/
    placement co-design of Sec. III-C, "balancing ADC sharing and
    parallelism")."""

    def __init__(self, m: int, rows: int, cols: int, base_id: int):
        self.m = m
        self.rows = rows
        self.cols = cols
        self.dr, self.dc, self.lanes = _lane_capacity(m, rows, cols)
        self.base_id = base_id
        self.free_by_array: dict[int, set[int]] = {}
        self.n_arrays = 0

    def _grow(self) -> None:
        idx = self.n_arrays
        self.n_arrays += 1
        self.free_by_array[idx] = set(range(self.lanes))

    @property
    def free(self) -> list[tuple[int, int]]:
        out = []
        for a in sorted(self.free_by_array):
            for lane in sorted(self.free_by_array[a]):
                out.append((a, lane))
        return out

    def take(self, want_lane: Optional[int] = None,
             avoid_array_of: Optional[tuple[int, int]] = None) -> tuple[int, int]:
        """Allocate (array_idx, lane), breadth-first (most-free array wins).
        If ``want_lane`` is set, only arrays where that lane is free qualify;
        optionally avoid one array (self-inverse constraint, lanes 0 / D/2)."""
        candidates = [
            (a, lanes)
            for a, lanes in self.free_by_array.items()
            if lanes
            and (want_lane is None or want_lane in lanes)
            and (avoid_array_of is None or a != avoid_array_of[0])
        ]
        if not candidates:
            self._grow()
            return self.take(want_lane=want_lane, avoid_array_of=avoid_array_of)
        a, lanes = max(candidates, key=lambda kv: (len(kv[1]), -kv[0]))
        lane = want_lane if want_lane is not None else min(lanes)
        lanes.discard(lane)
        return (a, lane)

    def take_specific(self, slot: tuple[int, int]) -> tuple[int, int]:
        a, lane = slot
        self.free_by_array[a].discard(lane)
        return slot


def _take_pair_slots(
    lpool: "_ArrayPool", rpool: "_ArrayPool", mixed: bool
) -> tuple[tuple[int, int], tuple[int, int]]:
    """Jointly allocate the part-0 slots of an (L, R) pair so that
    lane_R = -lane_L mod D (paper Sec. III-B2a) *and* packing stays dense:
    prefer an existing L slot whose inverse lane is also free in the R pool,
    honoring the self-inverse constraint (lane 0 / D/2 pairs must not share
    an array when the pools coincide)."""
    same_pool = lpool is rpool
    d = rpool.lanes

    def r_candidates(l_slot):
        a_l, lane_l = l_slot
        lane_r = (-lane_l) % d
        self_inv = same_pool and lane_r == lane_l
        return [
            s
            for s in rpool.free
            if s[1] == lane_r
            and not (self_inv and s[0] == a_l)
            and not (same_pool and s == l_slot)
        ]

    for l_slot in list(lpool.free):
        cands = r_candidates(l_slot)
        if cands:
            lpool.take_specific(l_slot)
            return l_slot, rpool.take_specific(cands[0])
    # no joint fit: take the best L slot, then grow R's pool for the inverse
    if lpool.free:
        l_slot = lpool.free[0]
    else:
        lpool._grow()
        l_slot = lpool.free[0]
    cands = r_candidates(l_slot)
    if not cands:
        rpool._grow()
        cands = r_candidates(l_slot)
    lpool.take_specific(l_slot)
    return l_slot, rpool.take_specific(cands[0])


def map_dense_pack(
    pairs: Sequence[MonarchPair],
    m: int,
    singles: Sequence[BlockDiagSpec] = (),
    mixed: bool = True,
) -> Mapping:
    """Pack block-diagonals densely onto shifted diagonal lanes.

    ``mixed=True`` allows the L and R stages to share physical arrays (same
    block geometry required); the self-inverse lanes 0 and D/2 then must not
    host both factors of one pair in the same array (Sec. III-B2a) — the
    allocator enforces this and the tests assert it.

    Rotation/shift bookkeeping: L gets lane i_L (output rotated by i_L); R
    gets lane i_R = -i_L mod D with its blocks row-shifted by i_L so the
    rotated intermediate lands on the right blocks; net output rotation 0.
    """
    matrices: dict[str, MatrixInfo] = {}
    pools: dict[tuple[int, int], _ArrayPool] = {}
    lane_rr: dict[tuple[int, int], int] = defaultdict(int)  # round-robin lane

    def pool_for(spec: BlockDiagSpec, suffix: str = "") -> _ArrayPool:
        key = (min(spec.rows, m), min(spec.cols, m), suffix)
        if key not in pools:
            pool = _ArrayPool(m, key[0], key[1], base_id=0)
            pool.uid = len(pools)  # unique id for flat array-id resolution
            pools[key] = pool
        return pools[key]

    def place_factor(
        spec: BlockDiagSpec,
        lane: int,
        shift: int,
        avoid: Optional[tuple[int, int]] = None,
        part0_slot: Optional[tuple[int, int]] = None,
        pool: Optional[_ArrayPool] = None,
    ) -> tuple[MatrixInfo, tuple[int, int]]:
        """Place all blocks of one factor on lane ``lane`` (plus overflow
        partitions on free lanes).

        Physical layout: block j sits at block-row (j + shift) mod dr and
        block-col (block-row + lane) mod dc of its partition's array — the
        paper's shifted-diagonal lane (Fig. 4b / Fig. 5).  The vec_in/out
        offsets stay *logical*: the mapping-aware scheduler (Sec. III-C)
        generates addresses, so lane rotation and stage shifting are folded
        into addressing and cost nothing at runtime; the functional emulator
        (repro_torch.cim.functional) verifies this end to end.
        """
        if spec.rows > m or spec.cols > m:
            raise ValueError(
                f"DenseMap block {spec.rows}x{spec.cols} exceeds array {m}x{m}; "
                "re-factorize with smaller blocks (paper Sec. IV-A co-design)"
            )
        if pool is None:
            pool = pool_for(spec)
        info = MatrixInfo(
            name=spec.name,
            in_dim=spec.total_rows,
            out_dim=spec.total_cols,
            nnz=spec.nnz,
            lane=lane,
            shift=shift,
        )
        dr, dc = pool.dr, pool.dc  # block slots per array side
        n_parts = math.ceil(spec.nblocks / dr)
        first_slot: Optional[tuple[int, int]] = None
        for part in range(n_parts):
            if part == 0 and part0_slot is not None:
                slot = part0_slot
            else:
                slot = pool.take(
                    want_lane=lane if part == 0 else None, avoid_array_of=avoid
                )
            if first_slot is None:
                first_slot = slot
            a_idx, use_lane = slot
            lo = part * dr
            hi = min((part + 1) * dr, spec.nblocks)
            for j in range(lo, hi):
                jr = (j - lo + shift) % dr
                jc = (jr + use_lane) % dc
                info.placements.append(
                    Placement(
                        matrix=spec.name,
                        block_idx=j,
                        array_id=(pool.uid, a_idx),  # resolved to flat id later
                        row_off=jr * spec.rows,
                        col_off=jc * spec.cols,
                        rows=spec.rows,
                        cols=spec.cols,
                        vec_in_off=j * spec.rows,
                        vec_out_off=j * spec.cols,
                        lane=use_lane,
                    )
                )
            if part == 0:
                info.lane = use_lane
        assert first_slot is not None
        return info, first_slot

    for pair in pairs:
        lpool = pool_for(pair.L)
        rpool = pool_for(pair.R, suffix="R" if not mixed else "")
        l_slot, r_slot = _take_pair_slots(lpool, rpool, mixed=mixed)
        l_info, _ = place_factor(
            pair.L, lane=l_slot[1], shift=0, part0_slot=l_slot, pool=lpool
        )
        r_info, _ = place_factor(
            pair.R, lane=r_slot[1], shift=l_info.lane, part0_slot=r_slot, pool=rpool
        )
        matrices[l_info.name] = l_info
        matrices[r_info.name] = r_info

    for spec in singles:
        info, _ = place_factor(spec, lane=0, shift=0)
        matrices[info.name] = info

    # resolve per-pool array ids into a flat global id space
    next_id = 0
    id_map: dict[tuple, int] = {}
    for pool in sorted(pools.values(), key=lambda p: p.uid):
        for a in range(pool.n_arrays):
            id_map[(pool.uid, a)] = next_id
            next_id += 1
    for info in matrices.values():
        info.placements = [
            dataclasses.replace(p, array_id=id_map[p.array_id]) for p in info.placements
        ]
    return Mapping("dense", m, matrices, next_id)


# ---------------------------------------------------------------------------
# Convenience: map a whole set of monarch matmuls under each strategy
# ---------------------------------------------------------------------------


def arrays_required(mapping: Mapping) -> int:
    return mapping.n_arrays


__all__ = [
    "DenseMatSpec",
    "Placement",
    "MatrixInfo",
    "Mapping",
    "MonarchPair",
    "map_linear",
    "map_sparse",
    "map_dense_pack",
    "arrays_required",
]
