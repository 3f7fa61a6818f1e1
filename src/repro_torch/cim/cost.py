"""Latency / energy evaluation of scheduled CIM execution (Table I costs).

Composition rules (assumptions documented in DESIGN.md Sec. 8):

* Arrays operate in parallel (paper Sec. III-C); a matmul's latency is the
  slowest array's cycle sequence plus partial-sum reduction hops.
* Within an array, activation cycles are sequential; with
  ``pipeline_adc=True`` conversions of cycle t overlap the activation of
  cycle t+1, so the array time is max(sum act, sum conv) + first activation.
* Activation time scales with the driven-row fraction when
  ``act_scaling="rows"`` (charge/settle proportional to driven wordlines) and
  is the full Table-I 100 ns otherwise; energy always scales with active cells
  (driven rows x read columns — unselected bitlines are floated).
* SAR ADC latency and energy scale linearly with resolution (Sec. IV-C:
  8b -> 3b gives ~2.67x on both).
* ``input_bits`` bit-serial DAC cycles multiply both activations and
  conversions (Sec. II-A step 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence

from repro_torch.cim.mapping import Mapping
from repro_torch.cim.scheduling import CycleOp, cycles_by_array
from repro_torch.cim.spec import CIMConfig


@dataclasses.dataclass
class Cost:
    latency_ns: float = 0.0
    energy_nj: float = 0.0

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.latency_ns + other.latency_ns, self.energy_nj + other.energy_nj)

    def parallel(self, other: "Cost") -> "Cost":
        """Independent units: latency is the max, energy still adds."""
        return Cost(max(self.latency_ns, other.latency_ns), self.energy_nj + other.energy_nj)

    def scaled(self, n: float) -> "Cost":
        return Cost(self.latency_ns * n, self.energy_nj * n)


def array_cost(cycles: Sequence[CycleOp], cfg: CIMConfig, mapping_kind: str) -> Cost:
    """Sequential cost of one array's cycle list."""
    t = cfg.tech
    act_ns = conv_ns = energy = 0.0
    first_act = 0.0
    for i, c in enumerate(cycles):
        bits = cfg.adc_bits(mapping_kind, c.active_rows)
        frac = c.active_rows / cfg.m if cfg.act_scaling == "rows" else 1.0
        # Table-I MVM covers the complete (bit-serial) analog op; ADC
        # conversions occur once per column per input bit cycle (which is why
        # ADCs dominate CIM energy, Sec. II-A).
        a = t.mvm_ns * frac
        conv_slots = math.ceil(c.read_cols / max(cfg.adcs_per_array, 1))
        v = conv_slots * t.adc_ns(bits) * cfg.input_bits
        act_ns += a
        conv_ns += v
        if i == 0:
            first_act = a
        energy += (
            t.mvm_nj * (c.active_cells / (cfg.m * cfg.m))
            + c.read_cols * t.adc_nj(bits) * cfg.input_bits
        )
    if cfg.pipeline_adc:
        lat = max(act_ns, conv_ns) + first_act
    else:
        lat = act_ns + conv_ns
    return Cost(lat, energy)


def matmul_cost(
    mapping: Mapping,
    cycles: Iterable[CycleOp],
    cfg: CIMConfig,
    matrix_names: Sequence[str],
) -> Cost:
    """One (possibly co-activated group of) matmul(s): parallel arrays +
    partial-sum reduction + one output-routing hop per array."""
    t = cfg.tech
    by_array = cycles_by_array(cycles)
    cost = Cost()
    for array_id, cyc in by_array.items():
        cost = cost.parallel(array_cost(cyc, cfg, mapping.strategy))
    # partial-sum reduction across row tiles (Linear / oversized blocks)
    red = max(mapping.matrices[n].reduction_groups for n in matrix_names)
    if red > 1:
        hops = math.ceil(math.log2(red))
        cost = cost + Cost(hops * t.comm_ns, (red - 1) * t.comm_nj)
    # Activation movement: broadcasting the input vector to the arrays and
    # collecting the output to the consumer (DPU / next stage), charged per
    # m-element vector chunk — activations move regardless of how the weights
    # are mapped, which is what dilutes end-to-end gains (paper Fig. 7 vs the
    # per-matmul ADC savings).
    msgs = 0
    for n in matrix_names:
        info = mapping.matrices[n]
        msgs += math.ceil(info.in_dim / cfg.m) + math.ceil(info.out_dim / cfg.m)
    cost = cost + Cost(t.comm_ns, msgs * t.comm_nj)
    return cost


def fixed_op_cost(kind: str, cfg: CIMConfig, count: int = 1) -> Cost:
    t = cfg.tech
    table = {
        "layernorm": (t.layernorm_ns, t.layernorm_nj),
        "relu": (t.relu_ns, t.relu_nj),
        "gelu": (t.gelu_ns, t.gelu_nj),
        "add": (t.add_ns, t.add_nj),
        "comm": (t.comm_ns, t.comm_nj),
    }
    ns, nj = table[kind]
    return Cost(ns * count, nj * count)


def swap_cost(mapping: Mapping, cfg: CIMConfig) -> Cost:
    """Array-rewrite overhead when the model exceeds the array budget
    (Sec. III-B1: dynamic swapping in resource-constrained systems)."""
    if cfg.array_budget is None or mapping.n_arrays <= cfg.array_budget:
        return Cost()
    excess = mapping.n_arrays - cfg.array_budget
    t = cfg.tech
    # each excess array must be rewritten once per pass: m rows per array
    return Cost(excess * cfg.m * t.write_row_ns, excess * cfg.m * t.write_row_nj)


__all__ = ["Cost", "array_cost", "matmul_cost", "fixed_op_cost", "swap_cost"]
