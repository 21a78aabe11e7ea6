"""Multi-tenant serving tier: admission, fairness, warm-state budget,
snapshot/restore, per-tenant quality/SLO health — N concurrent tenants
over one shared Engine.

    from repro_torch.serve import TenantService, ServiceConfig, Rejected

The port of ``repro.serve`` over the port's engine; the same names.
"""
from repro_torch.serve.admission import AdmissionQueue, Rejected
from repro_torch.serve.health import (
    Alert,
    HealthConfig,
    HealthMonitor,
    QualitySample,
    TenantTimeline,
)
from repro_torch.serve.service import ServiceConfig, TenantService, TenantTicket

__all__ = [
    "AdmissionQueue",
    "Rejected",
    "ServiceConfig",
    "TenantService",
    "TenantTicket",
    "Alert",
    "HealthConfig",
    "HealthMonitor",
    "QualitySample",
    "TenantTimeline",
]
