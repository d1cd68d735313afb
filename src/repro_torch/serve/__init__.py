"""Serving front end: ``LatencyService`` wave microbatching with an
epoch-keyed cache over ``repro_torch.api.LatencyOracle``, plus the fault
injection (``faults``) and circuit breaker (``resilience``) it uses."""
from repro_torch.api.types import ServiceStats
from repro_torch.serve.latency_service import (LatencyService, ServiceRequest,
                                               synthetic_requests)

__all__ = ["LatencyService", "ServiceRequest", "ServiceStats",
           "synthetic_requests"]
