"""Fault tolerance of the port: heartbeats, supervisors, straggler
detection and elastic remesh planning (host code), and the gradients'
int8 error-feedback compression (``ft.compression``)."""

from repro_torch.ft.coordinator import (  # noqa: F401
    ElasticPlan,
    EngineSupervisor,
    FleetSupervisor,
    HeartbeatRegistry,
    StragglerMonitor,
    plan_elastic_remesh,
)
