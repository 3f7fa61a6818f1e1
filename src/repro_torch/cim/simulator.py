"""End-to-end CIM inference simulation (paper Sec. IV).

Maps a ``ModelDesc``'s parameterized matmuls under one of the three
strategies, schedules them, and composes Table-I costs into per-token
latency and whole-pass energy.  Reproduces the quantities behind the paper's
Fig. 6 (arrays + utilization), Fig. 7 (latency + energy) and Fig. 8 (ADC
sharing DSE).

Accounting notes (DESIGN.md Sec. 8): the MHA unit's internal cost
(non-parameterized score/AV matmuls) is excluded — identical across
strategies and outside the paper's focus ("we specifically focus on the
performance of parameterized ones"); embedding/LM-head stay dense and off
the strategy-mapped arrays (paper Fig. 2b keeps them untransformed).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.monarch import make_dims, stage_specs
from repro_torch.cim.cost import Cost, fixed_op_cost, matmul_cost, swap_cost
from repro_torch.cim.mapping import (
    DenseMatSpec,
    Mapping,
    MonarchPair,
    map_dense_pack,
    map_linear,
    map_sparse,
)
from repro_torch.cim.scheduling import schedule_group, schedule_matmul
from repro_torch.cim.spec import CIMConfig
from repro_torch.cim.workload import LayerDesc, ModelDesc


@dataclasses.dataclass
class SimResult:
    model: str
    strategy: str
    n_arrays: int
    utilization: float
    latency_ns_per_token: float
    energy_nj_per_token: float
    seq_len: int
    n_layers: int
    params: int
    flops: int

    @property
    def latency_ns_total(self) -> float:
        return self.latency_ns_per_token * self.seq_len

    @property
    def energy_nj_total(self) -> float:
        return self.energy_nj_per_token * self.seq_len


def _expand_matmuls(layer: LayerDesc) -> list:
    out = []
    for m in layer.matmuls:
        for i in range(m.count):
            name = m.name if m.count == 1 else f"{m.name}.{i}"
            out.append(dataclasses.replace(m, name=name, count=1))
    return out


def build_layer_mapping(
    layer: LayerDesc,
    strategy: str,
    cfg: CIMConfig,
    monarch_policy: str = "paper",
) -> Mapping:
    mms = _expand_matmuls(layer)
    if strategy == "linear":
        return map_linear(
            [DenseMatSpec(m.din, m.dout, m.name) for m in mms], cfg.m
        )
    if strategy == "sparse":
        factors = []
        for m in mms:
            dims = make_dims(m.din, m.dout, policy=monarch_policy)
            l_spec, r_spec = stage_specs(dims, name=m.name)
            factors += [l_spec, r_spec]
        return map_sparse(factors, cfg.m, max_pack=cfg.sparse_max_pack)
    if strategy == "dense":
        pairs = []
        for m in mms:
            dims = make_dims(m.din, m.dout, policy=monarch_policy)
            l_spec, r_spec = stage_specs(dims, name=m.name)
            pairs.append(MonarchPair(L=l_spec, R=r_spec, name=m.name))
        return map_dense_pack(pairs, cfg.m)
    raise ValueError(f"unknown strategy {strategy}")


def _stage_cost(
    mapping: Mapping,
    strategy: str,
    stage_names: tuple[str, ...],
    cfg: CIMConfig,
    coactivate: bool,
) -> Cost:
    """Cost of one sequential stage (its matmuls run on parallel arrays)."""
    t = cfg.tech
    if strategy == "linear":
        # one array never hosts two Linear matmuls, so the group schedule is
        # exactly the per-matmul parallel composition
        cycles = schedule_group(mapping, list(stage_names), coactivate=coactivate)
        return matmul_cost(mapping, cycles, cfg, list(stage_names))
    # monarch: L stage then R stage; the inter-stage permutation is folded
    # (Sec. III-B3) — outputs stream straight into the next stage's DACs, so
    # no communication hop unless folding is disabled.  Cycles of different
    # matmuls that land on the same physical array serialize (the group
    # schedule accounts for it); ``coactivate`` merges shared-input cycles.
    inter = Cost() if cfg.fold_interstage else Cost(t.comm_ns, 0.0)
    l_names = [f"{n}/L" for n in stage_names]
    r_names = [f"{n}/R" for n in stage_names]
    cl = schedule_group(mapping, l_names, coactivate=coactivate)
    cr = schedule_group(mapping, r_names, coactivate=False)
    lc = matmul_cost(mapping, cl, cfg, l_names)
    rc = matmul_cost(mapping, cr, cfg, r_names)
    return lc + inter + rc


def simulate(
    model: ModelDesc,
    strategy: str,
    cfg: Optional[CIMConfig] = None,
    monarch_policy: str = "paper",
    coactivate: Optional[bool] = None,
) -> SimResult:
    cfg = cfg or CIMConfig()
    if coactivate is None:
        coactivate = cfg.coactivate
    total_arrays = 0
    util_num = 0.0
    per_token = Cost()
    for layer in model.layers:
        mapping = build_layer_mapping(layer, strategy, cfg, monarch_policy)
        eff_cfg = cfg
        if cfg.iso_adc_budget and strategy != "linear":
            lin = build_layer_mapping(layer, "linear", cfg, monarch_policy)
            scale = max(1, round(lin.n_arrays / max(mapping.n_arrays, 1)))
            eff_cfg = dataclasses.replace(
                cfg, adcs_per_array=min(cfg.adcs_per_array * scale, cfg.m)
            )
        total_arrays += mapping.n_arrays * layer.count
        util_num += mapping.utilization * mapping.n_arrays * layer.count
        layer_cost = Cost()
        for stage in layer.stages:
            layer_cost = layer_cost + _stage_cost(
                mapping, strategy, stage, eff_cfg, coactivate
            )
        for kind, count in layer.fixed_ops:
            layer_cost = layer_cost + fixed_op_cost(kind, cfg, count)
        layer_cost = layer_cost + swap_cost(mapping, cfg).scaled(1.0 / model.seq_len)
        # static ADC power over the layer's runtime (1 W x 1 ns = 1 nJ)
        n_adcs = mapping.n_arrays * eff_cfg.adcs_per_array
        layer_cost = layer_cost + Cost(
            0.0, cfg.tech.adc_static_w * layer_cost.latency_ns * n_adcs
        )
        per_token = per_token + layer_cost.scaled(layer.count)
    params = (
        model.para_matmul_params()
        if strategy == "linear"
        else model.monarch_params(monarch_policy)
    )
    flops = (
        model.para_matmul_flops()
        if strategy == "linear"
        else model.monarch_flops(monarch_policy)
    )
    return SimResult(
        model=model.name,
        strategy=strategy,
        n_arrays=total_arrays,
        utilization=util_num / max(total_arrays, 1),
        latency_ns_per_token=per_token.latency_ns,
        energy_nj_per_token=per_token.energy_nj,
        seq_len=model.seq_len,
        n_layers=model.n_layers,
        params=params,
        flops=flops,
    )


__all__ = ["SimResult", "simulate", "build_layer_mapping"]
