"""CIM hardware specification and the paper's Table I cost constants.

All latency numbers are nanoseconds, all energies nanojoules, matching the
paper's Table I ("Baseline CIM parameters for d_model = 1024", IBM PCM based,
256 x 256 arrays, SAR ADCs per ISAAC [23]).

Modeling assumptions that the paper leaves unspecified are explicit fields
here (``act_scaling``, ``input_bits``, ``pipeline_adc``) and documented in
DESIGN.md Sec. 8; `calibrate()` in repro_torch.cim.dse picks the combination that
best matches the paper's headline ratios and records the choice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TechCosts:
    """Primitive op costs (paper Table I)."""

    mvm_ns: float = 100.0          # one full 256x256 PCM array MVM activation
    mvm_nj: float = 10.0
    adc_ns_8b: float = 0.833       # one SAR conversion at 8 bits
    adc_nj_8b: float = 13.33e-3
    comm_ns: float = 48.0          # one inter-array/unit communication hop
    comm_nj: float = 51.7
    layernorm_ns: float = 100.0
    layernorm_nj: float = 42.0
    relu_ns: float = 1.0
    relu_nj: float = 0.06
    gelu_ns: float = 70.0
    gelu_nj: float = 38.5
    add_ns: float = 36.0
    add_nj: float = 37.7
    # NVM write cost for dynamic array swapping (Sec. III-B1 discussion);
    # PCM-typical microsecond-scale SET/RESET per row. Assumption documented.
    write_row_ns: float = 1000.0
    write_row_nj: float = 100.0
    # Static (leakage + reference) power per ADC in watts; makes energy
    # latency-dependent so Fig-8b's trend (fewer ADCs -> longer runtime ->
    # DenseMap's relative advantage grows) is expressible.  The paper gives
    # no number; 0.1 mW/ADC is SAR-typical incl. references (assumption,
    # DESIGN.md Sec. 8).  1 W x 1 ns == 1 nJ.
    adc_static_w: float = 1e-4

    def adc_ns(self, bits: int) -> float:
        """SAR conversion latency scales linearly with resolution steps
        (paper Sec. IV-C: 8b -> 3b cuts latency and energy by ~8/3 = 2.67x)."""
        return self.adc_ns_8b * bits / 8.0

    def adc_nj(self, bits: int) -> float:
        return self.adc_nj_8b * bits / 8.0


TABLE_I = TechCosts()


# Paper-published per-mapping SAR ADC resolutions (Sec. IV-B):
PAPER_ADC_BITS = {"linear": 8, "sparse": 5, "dense": 3}

# Per-block scale <-> per-array ADC range correspondence
# ------------------------------------------------------
# The software quantizer (``repro_torch.core.quant``) keeps ONE fp32 scale per
# diagonal Monarch block.  On the CIM substrate each 256x256 array hosts
# exactly one such block (SparseMap/DenseMap, Sec. III-B), so the per-block
# scale is the digital twin of that array's ADC full-scale range: the
# bitline currents are converted relative to the block's max conductance,
# and the column sums are re-scaled by the block scale in the periphery —
# exactly the ``wq.astype(f32) * scale`` dequant the Pallas kernels run in
# VMEM.  Lower weight precision (int4 cells) shrinks the output dynamic
# range, so a conversion never needs more resolution than the cell width:
# ``CIMConfig.weight_bits`` clamps ``adc_bits`` accordingly, which is the
# same resolution/latency/energy trade the Fig. 8 ADC-sharing DSE
# (benchmarks/fig8_adc_dse.py) sweeps explicitly via ``adc_bits_override``
# — the DSE explores the knob, the weight width bounds it.
#
# The same correspondence covers the KV cache.  CIM storage is inherently
# low-precision — a crossbar cell holds a few bits, and whatever buffers the
# attention DPU reads its K/V stream from is calibrated per array, not per
# element — so the serving pool's quantized KV pages (``core.quant``: int8
# rows with ONE fp32 scale per (page, kv_head), K and V independent) are the
# digital twin of a per-crossbar ADC full-scale range over the array
# holding that page's keys (or values): the page is the hardware residency
# granule, the head is its column group, and the periphery re-scales column
# sums by the page scale exactly as the paged-attention kernel multiplies
# the gathered int8 page by its scale row in VMEM.  A page's scale only
# ever grows while the page fills (append-only history), which is the ADC
# range-tracking discipline of programming an array: widen the full-scale,
# re-normalize what is already stored, never touch a committed array —
# shared (immutable) pages keep their conversion range forever.


@dataclasses.dataclass(frozen=True)
class CIMConfig:
    """One CIM accelerator configuration."""

    m: int = 256                    # array rows == cols
    adcs_per_array: int = 1         # ADC sharing degree (Fig. 8 sweeps 4..32)
    adc_policy: str = "paper"       # "paper" (8/5/3 bits) | "analytical"
    input_bits: int = 8             # DAC bit-serial streaming cycles per MVM
    act_scaling: str = "rows"       # "rows": t_act ~ active_rows/m | "full"
    pipeline_adc: bool = True       # overlap conversions with next activation
    array_budget: int | None = None # if set, swapping costs apply beyond it
    sparse_max_pack: int | None = None  # cap blocks/array in SparseMap
                                        # (None = densest diagonal packing;
                                        # 1 = full latency-optimized spread)
    fold_interstage: bool = True    # Sec. III-B3 permutation folding: the
                                    # L->R intermediate streams directly into
                                    # the next array's DACs (no comm hop)
    coactivate: bool = False        # shared-input co-activation (beyond-paper)
    iso_adc_budget: bool = False    # compare strategies at equal *total* ADC
                                    # count (area-neutral): mappings that use
                                    # fewer arrays get proportionally more
                                    # ADCs per array (paper's >4x area-saving
                                    # claim implies freed ADCs are available)
    tech: TechCosts = TABLE_I

    adc_bits_override: int | None = None  # force a resolution (DSE sweeps)
    weight_bits: int = 8            # cell precision; caps adc_bits (see the
                                    # per-block-scale <-> ADC note above)

    def adc_bits(self, mapping: str, active_rows: int) -> int:
        """Required ADC resolution.

        "paper": the published per-mapping values (8/5/3).
        "analytical": ceil(log2(active rows summing into one bitline)) —
        the physically-derived bound; differs from the paper for DenseMap
        (5 vs 3 at b=32), recorded as a reproduction ambiguity (DESIGN.md 8.1).
        Either policy is clamped to ``weight_bits``: int4 cells never need
        finer than 4-bit conversions.
        """
        if self.adc_bits_override is not None:
            return self.adc_bits_override
        if self.adc_policy == "paper":
            return min(PAPER_ADC_BITS[mapping], self.weight_bits)
        bits = max(1, (max(active_rows, 1) - 1).bit_length())
        return min(bits, 8, self.weight_bits)


# GPU reference points quoted by the paper (Sec. IV-B), reported for context
# only — we do not re-simulate the GPU.
PAPER_GPU_SPEEDUP_LINEAR_BERT = 16.2
PAPER_ENERGY_ORDER_OF_MAGNITUDE = 1e3


__all__ = ["TechCosts", "TABLE_I", "CIMConfig", "PAPER_ADC_BITS"]
