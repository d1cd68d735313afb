"""``repro_torch.serve`` — serving front-ends.

  - ``LatencyService`` / ``ServiceRequest`` / ``ServiceStats``: wave-based
    microbatching + epoch-keyed LRU caching of PROFET latency prediction
    over ``repro_torch.api.LatencyOracle``, with ``oracle_refreshed``
    mid-traffic model swaps;
  - ``transport``: the asyncio HTTP front end over the service
    (``TransportServer`` / ``BackgroundServer``), its blocking ``Client``,
    and the ``replay`` load generator;
  - ``faults``: the deterministic fault-injection harness
    (``FaultPlan`` / ``FaultRule`` / ``FaultInjector``);
  - ``resilience``: client ``RetryPolicy`` (exponential backoff +
    jitter, idempotency-aware) and the per-(anchor, target)
    ``CircuitBreaker`` the wave service quarantines failing pairs with;
  - ``shard``: multi-worker sharded wave execution — ``ShardPlane``
    owns N workers each holding a group-axis ``ModelBank`` shard (spawn
    processes with their own CUDA context, in-process threads, or
    ``WorkerServer`` peers over the framed TCP protocol —
    ``launch_tcp_workers`` spins up a loopback pool), and ``ShardedBank``
    scatters a wave's rows by (anchor, target) group and gathers them
    back bit-identically;
  - ``lifecycle``: self-healing worker supervision over the shard plane
    (``WorkerSupervisor`` / ``LifecycleConfig``);
  - ``frames``: the length-prefixed binary framing + codecs the TCP
    worker wire and the columnar ``/measure`` body share;
  - ``Engine``: the token-serving engine for the model zoo
    (``repro_torch.serve.engine``; imported lazily — it pulls in the model
    stack).
"""
from repro_torch.api.types import ServiceStats
from repro_torch.serve.faults import (FaultInjector, FaultPlan, FaultRule,
                                      InjectedFault)
from repro_torch.serve.latency_service import (LatencyService, ServiceRequest,
                                               synthetic_requests)
from repro_torch.serve.lifecycle import LifecycleConfig, WorkerSupervisor
from repro_torch.serve.resilience import CircuitBreaker, RetryPolicy
from repro_torch.serve.shard import (ShardedBank, ShardPlane, TcpWorkerPool,
                                     WorkerAuthError, WorkerDeadError,
                                     WorkerServer, launch_tcp_workers)
from repro_torch.serve.transport import (BackgroundServer, Client,
                                         TransportError, TransportServer,
                                         replay)

__all__ = ["BackgroundServer", "CircuitBreaker", "Client", "Engine",
           "FaultInjector", "FaultPlan", "FaultRule", "InjectedFault",
           "LatencyService", "LifecycleConfig", "RetryPolicy",
           "ServiceRequest", "ServiceStats", "ShardPlane", "ShardedBank",
           "TcpWorkerPool", "TransportError", "TransportServer",
           "WorkerAuthError", "WorkerDeadError", "WorkerServer",
           "WorkerSupervisor", "launch_tcp_workers", "replay",
           "synthetic_requests"]


def __getattr__(name):
    if name == "Engine":
        from repro_torch.serve.engine import Engine
        return Engine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
