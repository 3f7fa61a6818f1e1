"""Design-space exploration + calibration (paper Sec. IV-C / Fig. 8).

``sweep_adc_sharing`` reproduces Fig. 8 (latency/energy vs ADCs per array);
``sweep_adc_resolution`` the Sec. IV-C resolution scaling; ``calibrate``
grid-searches the modeling assumptions the paper leaves unspecified
(DESIGN.md Sec. 8) and picks the combination that minimizes deviation from
the paper's headline Fig. 7 ratios — the chosen assumption set is printed by
the benchmarks so the reproduction is transparent about it.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

from repro_torch.cim.simulator import simulate
from repro_torch.cim.spec import CIMConfig
from repro_torch.cim.workload import ModelDesc, PAPER_MODELS


# Paper headline ratios (Fig. 7, geomean across the three models).
PAPER_RATIOS = {
    ("latency", "sparse"): 1.59,   # Linear / SparseMap
    ("latency", "dense"): 1.73,    # Linear / DenseMap
    ("energy", "sparse"): 1.61,
    ("energy", "dense"): 1.74,
}


def calibrated_config() -> CIMConfig:
    """The assumption set selected by ``calibrate()`` (cached here so
    benchmarks don't re-run the grid).  Achieves Linear/strategy ratios of
    1.53/1.75 (latency) and 1.32/1.47 (energy) vs the paper's
    1.59/1.73 and 1.61/1.74 — see EXPERIMENTS.md 'Paper-claims'.

    Physically: row-proportional activation time, 8-bit bit-serial inputs
    (ADC-conversion dominated, consistent with ADCs being 60-80 % of CIM
    energy), pipelined conversions, densest diagonal packing for SparseMap,
    shared-input co-activation, and an area-neutral (equal total ADC)
    comparison across strategies."""
    return CIMConfig(
        act_scaling="rows",
        input_bits=8,
        pipeline_adc=True,
        sparse_max_pack=None,
        coactivate=True,
        iso_adc_budget=True,
    )


def strategy_ratios(cfg: CIMConfig, models: Sequence[ModelDesc]) -> dict:
    """geomean(Linear / strategy) for latency and energy across models."""
    import math

    out = {}
    for metric in ("latency", "energy"):
        for strat in ("sparse", "dense"):
            logsum = 0.0
            for m in models:
                base = simulate(m, "linear", cfg)
                res = simulate(m, strat, cfg)
                if metric == "latency":
                    r = base.latency_ns_per_token / res.latency_ns_per_token
                else:
                    r = base.energy_nj_per_token / res.energy_nj_per_token
                logsum += math.log(max(r, 1e-12))
            out[(metric, strat)] = math.exp(logsum / len(models))
    return out


def calibrate(models: Sequence[ModelDesc] | None = None) -> tuple[CIMConfig, dict]:
    """Pick (act_scaling, input_bits, pipeline_adc) minimizing log-distance
    to the paper's Fig. 7 ratios.  Returns (best config, its ratios)."""
    import math

    models = models or [f() for f in PAPER_MODELS.values()]
    best, best_err, best_ratios = None, float("inf"), None
    for act, bits, pipe, pack, coact, iso in itertools.product(
        ("rows", "full"), (1, 8), (True, False), (None, 2, 1), (False, True),
        (False, True),
    ):
        cfg = CIMConfig(
            act_scaling=act,
            input_bits=bits,
            pipeline_adc=pipe,
            sparse_max_pack=pack,
            coactivate=coact,
            iso_adc_budget=iso,
        )
        ratios = strategy_ratios(cfg, models)
        err = sum(
            (math.log(ratios[k]) - math.log(v)) ** 2 for k, v in PAPER_RATIOS.items()
        )
        if err < best_err:
            best, best_err, best_ratios = cfg, err, ratios
    assert best is not None
    return best, best_ratios


@dataclasses.dataclass
class SweepPoint:
    adcs_per_array: int
    strategy: str
    latency_ns: float
    energy_nj: float


def sweep_adc_sharing(
    model: ModelDesc,
    adc_counts: Sequence[int] = (4, 8, 16, 32),
    base: CIMConfig | None = None,
) -> list[SweepPoint]:
    base = base or CIMConfig()
    points = []
    for n_adc in adc_counts:
        cfg = dataclasses.replace(base, adcs_per_array=n_adc)
        for strat in ("linear", "sparse", "dense"):
            r = simulate(model, strat, cfg)
            points.append(
                SweepPoint(n_adc, strat, r.latency_ns_per_token, r.energy_nj_per_token)
            )
    return points


def sweep_adc_resolution(
    model: ModelDesc, base: CIMConfig | None = None
) -> dict[str, float]:
    """Sec. IV-C: reducing ADC resolution 8b -> 3b cuts latency and energy by
    ~2.67x.  We verify the scaling on the DenseMap config by comparing its
    paper-resolution (3b) run against a forced-8b run, all else equal."""
    import dataclasses as dc

    base = base or CIMConfig()
    # the 2.67x claim concerns the conversion-bound regime: evaluate at one
    # shared ADC per array without the iso-budget rescaling
    base = dc.replace(base, adcs_per_array=1, iso_adc_budget=False)
    r_3b = simulate(model, "dense", dc.replace(base, adc_bits_override=3))
    r_8b = simulate(model, "dense", dc.replace(base, adc_bits_override=8))
    return {
        "latency_scaling": r_8b.latency_ns_per_token / r_3b.latency_ns_per_token,
        "energy_scaling": r_8b.energy_nj_per_token / r_3b.energy_nj_per_token,
    }


__all__ = [
    "PAPER_RATIOS",
    "strategy_ratios",
    "calibrate",
    "sweep_adc_sharing",
    "sweep_adc_resolution",
    "SweepPoint",
]
