"""Serving runtime of the port: the continuous-batching engine over a
refcounted, prefix-sharing paged KV pool.

The host side — request lifecycle, pool, scheduler, metrics, tracing — is
a copy of ``repro.serving``'s jax-free modules, so both packages plan the
same steps for the same traffic.  The device side is the port's own:
``engine.ContinuousBatchingEngine`` runs each iteration as one mixed
forward through ``models.transformer.paged_mixed_step``, and the legacy
``engine.ServeEngine`` serves one batch through the ring cache
(``models.transformer.decode_step``, a CUDA graph a batch size on the
card: ``ring_graphs``).  The scheduler's
two step-pricing models, ``HBMCostModel`` (a weight-streaming roofline)
and ``CIMCostModel`` (the paper's CIM simulator, ``repro_torch.cim``), are
the reference's.

Fault tolerance is the reference's too: engine snapshots through the
checkpoint store (``snapshot``), the seeded fault injector and the
recovery oracles (``faults``), and R engine replicas behind one router
with health, failover, migration and quarantine (``replicas``).
"""

from repro_torch.serving.device_kv import (DeviceKV,  # noqa: F401
                                           kv_shard_size)
from repro_torch.serving.engine import (ContinuousBatchingEngine,  # noqa: F401
                                        GenerationConfig, ServeEngine)
from repro_torch.serving.faults import (DispatchFailure,  # noqa: F401
                                        FaultInjector, InjectedFault,
                                        SimulatedCrash,
                                        assert_fleet_invariants,
                                        assert_recovery_invariants)
from repro_torch.serving.kv_pool import (PagedKVPool, PoolOOM,  # noqa: F401
                                         PoolStats, PrefixMatch, SINK_PAGE)
from repro_torch.serving.metrics import (Calibration, Counter,  # noqa: F401
                                         EngineStats, Gauge, Histogram,
                                         MetricsRegistry, render_report)
from repro_torch.serving.replicas import (ReplicaHealth,  # noqa: F401
                                          ReplicatedEngine, ROUTING_POLICIES)
from repro_torch.serving.request import (FinishReason, Request,  # noqa: F401
                                         RequestState, SamplingParams,
                                         Sequence)
from repro_torch.serving.scheduler import (CIMCostModel,  # noqa: F401
                                           CostModel, HBMCostModel,
                                           IterationScheduler,
                                           SchedulerConfig, StepPlan)
from repro_torch.serving.tracing import (NULL_TRACER,  # noqa: F401
                                         ChromeTracer, NullTracer,
                                         load_trace, validate_trace)
