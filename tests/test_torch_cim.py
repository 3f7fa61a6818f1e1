"""The port's CIM stack (``repro_torch.cim``) against the reference's
(``repro.cim``), on the CPU.

The mapper, scheduler, cost composition, simulator and DSE are copies of
the reference's, so every number is held to ``==``: each ``SimResult``
field for the paper models under every strategy and for the decode
workload of each ported configuration, the ADC sweeps and the
calibration grid, and every placement and cycle at the shapes of
``tests/test_cim_mapping.py``.  The functional emulator runs on float64
tensors: its outputs are held within 1e-9 of the reference's numpy
emulator and of the Monarch product, the tolerance of
``tests/test_cim_mapping.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.cim import dse as jdse
from repro.cim import functional as jfunctional
from repro.cim import mapping as jmapping
from repro.cim import scheduling as jscheduling
from repro.cim.simulator import simulate as jsimulate
from repro.cim.spec import CIMConfig as JCIMConfig
from repro.cim import workload as jworkload
from repro.configs import get_config as jget_config
from repro.core import monarch as jmn
from repro_torch.cim import dse, functional, mapping, scheduling, workload
from repro_torch.cim.mapping import (Mapping, MatrixInfo, MonarchPair,
                                     Placement)
from repro_torch.cim.scheduling import CycleOp, Drive, Readout
from repro_torch.cim.simulator import simulate
from repro_torch.cim.spec import CIMConfig
from repro_torch.configs import PORTED_ARCHS
from repro_torch.configs import get_config as tget_config
from repro_torch.core import monarch as mn
from repro_torch.core.permutations import block_diag_dense

STRATEGIES = ("linear", "sparse", "dense")
EMULATION = dict(rtol=1e-9, atol=1e-9)   # tests/test_cim_mapping.py


def _cfgs():
    return {"default": (JCIMConfig(), CIMConfig()),
            "calibrated": (jdse.calibrated_config(),
                           dse.calibrated_config())}


# ---------------------------------------------------------------------------
# simulate and the DSE: identical numbers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cim", ["default", "calibrated"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("model", sorted(workload.PAPER_MODELS))
def test_simulate_paper_models_identical(model, strategy, cim):
    jcfg, tcfg = _cfgs()[cim]
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jdesc, tdesc = jworkload.PAPER_MODELS[model](), workload.PAPER_MODELS[
        model]()
    assert dataclasses.asdict(jdesc) == dataclasses.asdict(tdesc)
    want = jsimulate(jdesc, strategy, jcfg)
    got = simulate(tdesc, strategy, tcfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.latency_ns_total, got.energy_nj_total) == (
        want.latency_ns_total, want.energy_nj_total)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_simulate_decode_workload_identical(arch, fused):
    jdesc = jworkload.decode_workload(jget_config(arch), seq_len=512,
                                      fused_proj=fused)
    tdesc = workload.decode_workload(tget_config(arch), seq_len=512,
                                     fused_proj=fused)
    assert dataclasses.asdict(tdesc) == dataclasses.asdict(jdesc)
    for kv_bits in (32, 16, 8):
        assert workload.decode_kv_bytes_per_token(
            tget_config(arch), kv_bits) == jworkload.decode_kv_bytes_per_token(
            jget_config(arch), kv_bits)
    for strategy in STRATEGIES:
        try:
            want = dataclasses.asdict(jsimulate(jdesc, strategy))
        except ValueError as e:   # a block wider than an array (DenseMap)
            with pytest.raises(ValueError, match=str(e).split(";")[0]):
                simulate(tdesc, strategy)
            continue
        assert dataclasses.asdict(simulate(tdesc, strategy)) == want


def test_adc_sweeps_identical():
    for name in sorted(workload.PAPER_MODELS):
        jm, tm = jworkload.PAPER_MODELS[name](), workload.PAPER_MODELS[name]()
        for jbase, tbase in _cfgs().values():
            assert [dataclasses.asdict(p) for p in dse.sweep_adc_sharing(
                tm, base=tbase)] == [dataclasses.asdict(p) for p in
                                     jdse.sweep_adc_sharing(jm, base=jbase)]
            assert dse.sweep_adc_resolution(tm, base=tbase) == \
                jdse.sweep_adc_resolution(jm, base=jbase)
    models = [f() for f in workload.PAPER_MODELS.values()]
    jmodels = [f() for f in jworkload.PAPER_MODELS.values()]
    for jcfg, tcfg in _cfgs().values():
        assert dse.strategy_ratios(tcfg, models) == \
            jdse.strategy_ratios(jcfg, jmodels)


def test_calibration_grid_identical():
    tbest, tratios = dse.calibrate()
    jbest, jratios = jdse.calibrate()
    assert dataclasses.asdict(tbest) == dataclasses.asdict(jbest)
    assert tratios == jratios
    assert dataclasses.asdict(tbest) == dataclasses.asdict(
        dse.calibrated_config())
    assert dse.PAPER_RATIOS == jdse.PAPER_RATIOS


# ---------------------------------------------------------------------------
# placements and cycles: identical on tests/test_cim_mapping.py's shapes
# ---------------------------------------------------------------------------


def _pairs(mods, dims_args, n, name="w"):
    dims = mods[0].MonarchDims(*dims_args)
    return [mods[1].MonarchPair(*mods[0].stage_specs(dims, name=f"{name}{i}"),
                                name=f"{name}{i}") for i in range(n)]


def _map(mods, case):
    mp_ = mods[1]
    kind, args = case
    if kind == "linear":
        return mp_.map_linear([mp_.DenseMatSpec(*args)], 256)
    dims_args, n, m, extra = args
    pairs = _pairs(mods, dims_args, n)
    if kind == "sparse":
        return mp_.map_sparse([s for p in pairs for s in (p.L, p.R)], m,
                              **extra)
    return mp_.map_dense_pack(pairs, m, **extra)


MAPPING_CASES = {
    "linear_1024": ("linear", (1024, 1024, "w")),
    "sparse_1024": ("sparse", ((1024, 1024, 32, 32), 1, 256, {})),
    "sparse_1024_pack1": ("sparse", ((1024, 1024, 32, 32), 2, 256,
                                     {"max_pack": 1})),
    "dense_8_pairs": ("dense", ((1024, 1024, 32, 32), 8, 256, {})),
    "dense_6_pairs": ("dense", ((1024, 1024, 32, 32), 6, 256, {})),
    "dense_self_inverse": ("dense", ((256, 256, 8, 8), 1, 256,
                                     {"mixed": True})),
    "dense_unmixed": ("dense", ((256, 256, 8, 8), 3, 256,
                                {"mixed": False})),
    "dense_5_pairs_512": ("dense", ((512, 512, 16, 16), 5, 256, {})),
    "sparse_256_m64": ("sparse", ((256, 256, 16, 16), 3, 64, {})),
    "dense_256_m64": ("dense", ((256, 256, 16, 16), 3, 64, {})),
    "dense_rect_m128": ("dense", ((128, 512, 8, 8), 2, 128, {})),
}


def _mapping_tuple(m):
    return (m.strategy, m.m, m.n_arrays, m.utilization, m.total_cells,
            sorted(m.used_cells_per_array().items()),
            [(name, info.in_dim, info.out_dim, info.nnz, info.lane,
              info.shift, info.reduction_groups, info.array_ids,
              [dataclasses.astuple(p) for p in info.placements])
             for name, info in m.matrices.items()])


@pytest.mark.parametrize("case", sorted(MAPPING_CASES))
def test_mapping_and_schedule_identical(case):
    got = _map((mn, mapping), MAPPING_CASES[case])
    want = _map((jmn, jmapping), MAPPING_CASES[case])
    assert _mapping_tuple(got) == _mapping_tuple(want)
    assert mapping.arrays_required(got) == jmapping.arrays_required(want)
    names = list(got.matrices)
    for name in names:
        assert [dataclasses.astuple(c) for c in scheduling.schedule_matmul(
            got, name)] == [dataclasses.astuple(c) for c in
                            jscheduling.schedule_matmul(want, name)]
    for coact in (False, True):
        cyc = scheduling.schedule_group(got, names, coactivate=coact)
        jcyc = jscheduling.schedule_group(want, names, coactivate=coact)
        assert [dataclasses.astuple(c) for c in cyc] == [
            dataclasses.astuple(c) for c in jcyc]
        assert [(c.active_rows, c.read_cols, c.active_cells) for c in cyc] \
            == [(c.active_rows, c.read_cols, c.active_cells) for c in jcyc]
        assert sorted(scheduling.cycles_by_array(cyc)) == sorted(
            jscheduling.cycles_by_array(jcyc))


# ---------------------------------------------------------------------------
# functional emulation on float64 tensors
# ---------------------------------------------------------------------------


def _l_factor_dense(L):
    # L: (k, q, p), block j maps p -> q: dense block is L[j].T (p x q)
    return block_diag_dense(np.transpose(L, (0, 2, 1)))


def _r_factor_dense(R):
    # R: (q, s, k), block j maps k -> s: dense block is R[j].T (k x s)
    return block_diag_dense(np.transpose(R, (0, 2, 1)))


@pytest.mark.parametrize("strategy,dims_args,n_mats,m_dim,coactivate", [
    ("sparse", (256, 256, 16, 16), 3, 64, False),
    ("dense", (256, 256, 16, 16), 3, 64, False),
    ("dense", (128, 512, 8, 8), 2, 128, False),
    ("sparse", (1024, 1024, 32, 32), 2, 256, True),
    ("dense", (64, 64, 8, 8), 4, 32, True),
])
def test_execute_matmul_matches_reference_and_monarch(strategy, dims_args,
                                                      n_mats, m_dim,
                                                      coactivate):
    rng = np.random.default_rng(sum(dims_args) + n_mats)
    dims = mn.MonarchDims(*dims_args)
    pairs = [MonarchPair(*mn.stage_specs(dims, name=f"w{i}"), name=f"w{i}")
             for i in range(n_mats)]
    jpairs = _pairs((jmn, jmapping), dims_args, n_mats)
    if strategy == "dense":
        mp = mapping.map_dense_pack(pairs, m_dim)
        jmp = jmapping.map_dense_pack(jpairs, m_dim)
    else:
        mp = mapping.map_sparse([s for p in pairs for s in (p.L, p.R)], m_dim)
        jmp = jmapping.map_sparse([s for p in jpairs for s in (p.L, p.R)],
                                  m_dim)
    factors, weights = {}, {}
    for i in range(n_mats):
        L = rng.standard_normal(dims.l_shape)
        R = rng.standard_normal(dims.r_shape)
        factors[f"w{i}"] = (L, R)
        weights[f"w{i}/L"] = _l_factor_dense(L)
        weights[f"w{i}/R"] = _r_factor_dense(R)
    arrays = functional.program_arrays(
        mp, {k: torch.from_numpy(v) for k, v in weights.items()})
    jarrays = jfunctional.program_arrays(jmp, weights)
    assert sorted(arrays) == sorted(jarrays)
    for a in arrays:
        assert arrays[a].dtype == torch.float64
        np.testing.assert_array_equal(arrays[a].numpy(), jarrays[a])
    # one input shared by every L stage where co-activated (Q, K, V)
    x = rng.standard_normal((n_mats, dims.din))
    if coactivate:
        x[:] = x[0]
    l_names = [f"w{i}/L" for i in range(n_mats)]
    cyc_l = scheduling.schedule_group(mp, l_names, coactivate=coactivate)
    inter = functional.execute_matmul(
        mp, arrays, cyc_l, {n: torch.from_numpy(x[i])
                            for i, n in enumerate(l_names)})
    jinter = jfunctional.execute_matmul(
        jmp, jarrays, jscheduling.schedule_group(jmp, l_names,
                                                 coactivate=coactivate),
        {n: x[i] for i, n in enumerate(l_names)})
    perm_in = {f"w{i}/R": inter[f"w{i}/L"].reshape(dims.k, dims.q).T.reshape(
        -1) for i in range(n_mats)}
    cyc_r = scheduling.schedule_group(mp, [f"w{i}/R" for i in range(n_mats)])
    outs = functional.execute_matmul(mp, arrays, cyc_r, perm_in)
    for i in range(n_mats):
        assert inter[f"w{i}/L"].dtype == torch.float64
        np.testing.assert_allclose(inter[f"w{i}/L"].numpy(),
                                   jinter[f"w{i}/L"], **EMULATION)
        L, R = factors[f"w{i}"]
        M = mn.monarch_to_dense(torch.from_numpy(L), torch.from_numpy(R))
        np.testing.assert_allclose(outs[f"w{i}/R"].numpy(),
                                   (torch.from_numpy(x[i]) @ M).numpy(),
                                   **EMULATION)


def _one_array_mapping(second_name: str) -> Mapping:
    tile = Placement("a", 0, 0, 0, 0, 4, 4, 0, 0)
    return Mapping("sparse", 4, {
        "a": MatrixInfo("a", 4, 4, 16, [tile]),
        second_name: MatrixInfo(second_name, 4, 4, 16,
                                [dataclasses.replace(tile,
                                                     matrix=second_name)])},
        n_arrays=1)


def test_program_arrays_refuses_a_collision():
    mp = _one_array_mapping("b")
    w = torch.ones((4, 4), dtype=torch.float64)
    with pytest.raises(AssertionError, match="placement collision"):
        functional.program_arrays(mp, {"a": w, "b": w})


def test_execute_matmul_refuses_conflicting_drives():
    """Two matmuls read in one cycle share its wordlines: their inputs must
    agree on the driven rows."""
    arrays = {0: torch.eye(4, dtype=torch.float64)}
    mp = Mapping("sparse", 4, {
        "a": MatrixInfo("a", 2, 2, 4), "b": MatrixInfo("b", 2, 2, 4)}, 1)
    cycle = CycleOp(0, (Drive(0, 0, 2),),
                    (Readout(0, 0, 2, "a"), Readout(2, 0, 2, "b")))
    same = torch.tensor([1.0, 2.0], dtype=torch.float64)
    out = functional.execute_matmul(mp, arrays, [cycle],
                                    {"a": same, "b": same.clone()})
    assert out["a"].tolist() == [1.0, 2.0] and out["b"].tolist() == [0, 0]
    with pytest.raises(AssertionError, match="conflicting drive"):
        functional.execute_matmul(mp, arrays, [cycle],
                                  {"a": same, "b": same + 1})
