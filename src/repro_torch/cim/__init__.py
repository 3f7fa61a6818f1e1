"""Analog CIM mapping/scheduling stack — the paper's faithful reproduction.

Submodules: spec (Table I), mapping (Linear/SparseMap/DenseMap),
scheduling (Sec. III-C), cost (latency/energy composition), functional
(numeric crossbar emulation), workload (paper models), simulator
(end-to-end), dse (Fig. 8 sweeps + calibration).

A copy of ``repro.cim``, module for module, with the same numbers: the
stack is plain Python; only ``functional`` differs, running the crossbars
on float64 tensors on a device.
"""

from repro_torch.cim.spec import CIMConfig, TABLE_I, TechCosts  # noqa: F401
from repro_torch.cim.mapping import (  # noqa: F401
    DenseMatSpec,
    Mapping,
    MonarchPair,
    map_dense_pack,
    map_linear,
    map_sparse,
)
from repro_torch.cim.simulator import SimResult, simulate  # noqa: F401
