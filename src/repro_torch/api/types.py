"""Typed request/response surface of the PROFET prediction service.

Everything crossing the ``repro_torch.api`` boundary is one of these frozen
dataclasses: callers never hand-assemble ``(model, batch, pix)`` tuples or
pick min/max anchor profiles themselves. Requests are plain data (JSON-able
via ``dataclasses.asdict``) so they can travel through a serving layer
unchanged.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np

# Request modes (``PredictRequest.mode``)
MODE_AUTO = "auto"            # cross if an exact-case profile exists, else two-phase
MODE_CROSS = "cross"          # phase-1 only: profile of the exact case required
MODE_TWO_PHASE = "two_phase"  # phase-1 min/max + phase-2 knob interpolation
# Resolved modes additionally include:
MODE_MEASURED = "measured"    # target == anchor and the case was measured

KNOB_BATCH = "batch"
KNOB_PIXEL = "pixel"

# ``PredictRequest.anchor`` sentinel: let the planner route the request to
# the cheapest anchor (by catalog price) holding a usable profile.
ANCHOR_ANY = "any"


class ApiError(Exception):
    """Base class for every error raised at the ``repro_torch.api`` boundary."""


class UnknownDeviceError(ApiError, KeyError):
    """Anchor/target name not in the oracle's trained pair set."""


class UnsupportedRequestError(ApiError):
    """The request cannot be routed: no profile for the case and no feasible
    min/max anchor configs to interpolate from."""


class InvalidWorkloadError(ApiError, ValueError):
    """A ``Workload`` that can never be predicted (empty model name,
    non-positive batch/pixel) — rejected at construction, not deep inside
    feature building."""


class OverloadedError(ApiError):
    """The serving layer's bounded admission queue is full; the request was
    rejected (back-pressure), not queued. Clients should retry later."""


class ExecutionError(ApiError):
    """The fused executor failed unexpectedly mid-wave (a bug or resource
    failure below the api layer, not a routing problem). The serving layer
    fails the wave's requests individually with this instead of dying."""


class MalformedRequestError(ApiError, ValueError):
    """A wire payload that does not decode into a typed request (bad JSON,
    missing fields, wrong types) — the transport answers it with a typed
    error response instead of dropping the connection."""


class DeadlineExceededError(ApiError):
    """The request's ``deadline_ms`` budget elapsed before it was planned:
    the wave it would have joined shed it instead of spending model time on
    an answer the caller has already abandoned (HTTP 504)."""


class CircuitOpenError(ApiError):
    """The request's (anchor, target) pair is quarantined by the circuit
    breaker after repeated wave failures — fast-fail now, retry after the
    cooldown (a half-open probe re-tests the pair; HTTP 503)."""


class ShardExecutionError(ExecutionError):
    """A shard worker died (or its slice failed) mid-wave. Only the
    requests whose rows rode the failed slice carry this error — the rest
    of the wave's answers stand, and the wave pump survives (HTTP 500).
    Subsequent waves route the dead shard's rows through the degraded
    single-worker fallback instead."""


class PartialExecutionError(ExecutionError):
    """Internal carrier between a sharded bank and the executor: the wave
    executed, but some rows' slices failed. ``preds`` holds every row's
    prediction (garbage at failed rows), ``failed_rows`` is the boolean
    row mask. The executor converts it into per-request
    :class:`ShardExecutionError` entries — it never crosses the ``repro_torch.api``
    boundary."""

    def __init__(self, message: str, preds, failed_rows):
        super().__init__(message)
        self.preds = preds
        self.failed_rows = failed_rows


@dataclasses.dataclass(frozen=True)
class Workload:
    """One CNN training configuration — the paper's (M, B, P) cell."""
    model: str
    batch: int
    pix: int

    def __post_init__(self):
        if not self.model or not isinstance(self.model, str):
            raise InvalidWorkloadError(
                f"Workload.model must be a non-empty string, got "
                f"{self.model!r}")
        if self.batch < 1:
            raise InvalidWorkloadError(
                f"Workload.batch must be >= 1, got {self.batch!r} "
                f"(model {self.model!r})")
        if self.pix < 1:
            raise InvalidWorkloadError(
                f"Workload.pix must be >= 1, got {self.pix!r} "
                f"(model {self.model!r})")

    @property
    def case(self) -> Tuple[str, int, int]:
        """The legacy ``(model, batch, pix)`` tuple used by ``repro_torch.core``."""
        return (self.model, self.batch, self.pix)

    @classmethod
    def from_case(cls, case: Tuple[str, int, int]) -> "Workload":
        return cls(model=case[0], batch=int(case[1]), pix=int(case[2]))


@dataclasses.dataclass(frozen=True)
class PredictRequest:
    """Predict the latency of ``workload`` on ``target`` from anchor-side
    information only.

    ``profile`` is the client's op-name -> aggregated-ms profile measured on
    ``anchor``; when omitted the oracle falls back to its offline dataset.
    ``mode`` routes between phase-1 cross prediction and the two-phase
    min/max interpolation (``knob`` chooses the interpolation axis).

    ``deadline_ms`` is the caller's latency budget measured from
    submission: once elapsed, the serving layer sheds the request with a
    typed :class:`DeadlineExceededError` instead of planning/executing it.
    It is delivery metadata, not part of the prediction identity — cache
    keys ignore it.
    """
    anchor: str
    target: str
    workload: Workload
    profile: Optional[Mapping[str, float]] = None
    mode: str = MODE_AUTO
    knob: str = KNOB_BATCH
    deadline_ms: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class PredictResult:
    """A prediction plus enough context to audit and price it.

    ``epoch`` names the oracle generation that answered the request (the
    artifact-store fingerprint the serving layer was configured with); a
    client can detect a mid-traffic model refresh by watching it change.
    """
    latency_ms: float
    anchor: str
    target: str
    workload: Workload
    mode: str                 # resolved: measured | cross | two_phase
    price_hr: float
    epoch: Optional[str] = None

    def cost_usd(self, steps: int) -> float:
        """Cost of ``steps`` training steps at the predicted ms/batch."""
        return self.latency_ms / 1e3 / 3600.0 * steps * self.price_hr


@dataclasses.dataclass(frozen=True)
class PredictPlan:
    """A fully resolved execution plan for ONE request — the output of the
    pure planner (``repro_torch.api.planner``) and the unit the batch executor
    fuses over.

    Everything the executor needs is resolved here: the final mode, the
    target's price, the measured latency (``measured`` plans), the anchor
    profile row (``cross`` plans), or the oracle-chosen min/max configs and
    their profiles (``two_phase`` plans). The executor never touches the
    dataset — plans are the complete hand-off.
    """
    request: PredictRequest
    mode: str                 # resolved: measured | cross | two_phase
    price_hr: float
    measured_ms: Optional[float] = None
    profile: Optional[Mapping[str, float]] = None          # cross
    case_min: Optional[Tuple[str, int, int]] = None        # two_phase
    case_max: Optional[Tuple[str, int, int]] = None
    profile_min: Optional[Mapping[str, float]] = None
    profile_max: Optional[Mapping[str, float]] = None

    @property
    def anchor(self) -> str:
        return self.request.anchor

    @property
    def target(self) -> str:
        return self.request.target

    @property
    def workload(self) -> Workload:
        return self.request.workload

    @property
    def knob_value(self) -> float:
        w = self.request.workload
        return float(w.batch if self.request.knob == KNOB_BATCH else w.pix)


@dataclasses.dataclass(frozen=True)
class BatchPredictResult:
    """Results of one fused ``predict_many`` execution, in request order,
    plus the batching telemetry the serving layer reports."""
    results: Tuple[Optional[PredictResult], ...]
    fused_calls: int          # fused model dispatches: 1 per wave on the
                              # stacked ModelBank path, else one
                              # MedianEnsemble.predict per (anchor, target)
    rows: int                 # deduped phase-1 feature rows evaluated
    mode_counts: Mapping[str, int]
    epoch: Optional[str] = None   # oracle generation that executed the batch
    banked: bool = False          # answered via the stacked ModelBank path
    # per-request typed errors (aligned with ``results``): None everywhere
    # on a clean batch; a failed shard slice marks ONLY its requests (their
    # ``results`` slot is None) while the rest of the batch answers — the
    # serving layer fails those requests individually and keeps pumping
    errors: Optional[Tuple[Optional[ApiError], ...]] = None

    def __len__(self) -> int:
        return len(self.results)

    def __getitem__(self, i) -> PredictResult:
        return self.results[i]

    def __iter__(self) -> Iterator[PredictResult]:
        return iter(self.results)

    def latencies(self) -> np.ndarray:
        return np.array([r.latency_ms for r in self.results])


# p50/p99 are computed over a bounded rolling window so a long-lived
# service neither grows without bound nor slows its stats down; counters
# (requests, cache_hits, ...) remain exact lifetime totals.
LATENCY_WINDOW = 65536


@dataclasses.dataclass
class ServiceStats:
    """Per-service counters of ``repro_torch.serve.LatencyService`` (mutable —
    the service updates it wave by wave).

    ``epoch`` is the cache epoch currently serving new admissions;
    ``epoch_cache_hits`` counts hits *within* that epoch and resets to zero
    on every ``oracle_refreshed`` swap (the hit-rate reset a refresh must
    show), while ``cache_hits`` stays a lifetime total. ``invalidated``
    counts cache entries purged by swaps, ``overloads`` counts admissions
    rejected by the transport's bounded queue, and ``rerouted`` counts
    ``ANCHOR_ANY`` requests the planner sent to a concrete anchor.
    ``warmup_ms`` is wall time spent in epoch-aware warm-up (ModelBank
    build + MLP bucket pre-compiles) before traffic was admitted — at
    service construction and again on every ``oracle_refreshed`` swap.

    Resilience counters: ``deadline_expired`` counts requests shed with a
    ``DeadlineExceededError`` before planning; ``circuit_rejections``
    counts requests fast-failed because their (anchor, target) pair was
    quarantined; ``circuit_trips`` is cumulative open transitions;
    ``pump_crashes``/``pump_restarts`` account the transport pump
    supervisor; ``degraded`` (+ ``degraded_reason``) is set while the
    service runs a fallback path (e.g. per-group execute after a
    warm-up/bank failure) and clears when a healthy oracle is swapped in."""
    requests: int = 0
    waves: int = 0
    fused_calls: int = 0
    cache_hits: int = 0
    errors: int = 0
    wall_s: float = 0.0
    epoch: str = ""
    epoch_swaps: int = 0
    epoch_cache_hits: int = 0
    invalidated: int = 0
    overloads: int = 0
    rerouted: int = 0
    warmup_ms: float = 0.0
    deadline_expired: int = 0
    circuit_rejections: int = 0
    circuit_trips: int = 0
    pump_crashes: int = 0
    pump_restarts: int = 0
    # sharded execution (repro_torch.serve.shard): requests failed because their
    # shard slice died mid-wave, and rows served by the degraded
    # single-worker (parent-side) fallback after a worker death/quarantine
    shard_slice_errors: int = 0
    shard_fallback_rows: int = 0
    degraded: bool = False
    degraded_reason: Optional[str] = None
    latencies_ms: "deque" = dataclasses.field(
        default_factory=lambda: deque(maxlen=LATENCY_WINDOW))

    def _pct(self, q: float) -> float:
        return float(np.percentile(self.latencies_ms, q)) \
            if self.latencies_ms else float("nan")

    @property
    def p50_ms(self) -> float:
        return self._pct(50.0)

    @property
    def p99_ms(self) -> float:
        return self._pct(99.0)

    @property
    def requests_per_s(self) -> float:
        return self.requests / self.wall_s if self.wall_s else 0.0

    def summary(self) -> Dict[str, object]:
        return {"requests": self.requests, "waves": self.waves,
                "fused_calls": self.fused_calls,
                "cache_hits": self.cache_hits, "errors": self.errors,
                "wall_s": self.wall_s, "epoch": self.epoch,
                "epoch_swaps": self.epoch_swaps,
                "epoch_cache_hits": self.epoch_cache_hits,
                "invalidated": self.invalidated,
                "overloads": self.overloads, "rerouted": self.rerouted,
                "warmup_ms": self.warmup_ms,
                "deadline_expired": self.deadline_expired,
                "circuit_rejections": self.circuit_rejections,
                "circuit_trips": self.circuit_trips,
                "pump_crashes": self.pump_crashes,
                "pump_restarts": self.pump_restarts,
                "shard_slice_errors": self.shard_slice_errors,
                "shard_fallback_rows": self.shard_fallback_rows,
                "degraded": self.degraded,
                "degraded_reason": self.degraded_reason,
                "p50_ms": self.p50_ms, "p99_ms": self.p99_ms,
                "requests_per_s": self.requests_per_s}


@dataclasses.dataclass(frozen=True)
class GridRequest:
    """Sweep one model over targets x batches x pixels from one anchor —
    the advisor's hot path, answered by vectorized phase-1 calls."""
    anchor: str
    model: str
    targets: Tuple[str, ...]
    batches: Tuple[int, ...]
    pixels: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class GridResult:
    """Dense latency grid; cells without an anchor profile (infeasible or
    unmeasured configs) are NaN."""
    request: GridRequest
    latency_ms: np.ndarray    # (targets, batches, pixels)

    def at(self, target: str, batch: int, pix: int) -> float:
        r = self.request
        return float(self.latency_ms[r.targets.index(target),
                                     r.batches.index(batch),
                                     r.pixels.index(pix)])

    def rows(self) -> Iterator[Tuple[str, int, int, float]]:
        """Iterate finite cells as (target, batch, pix, latency_ms)."""
        r = self.request
        for i, t in enumerate(r.targets):
            for j, b in enumerate(r.batches):
                for k, p in enumerate(r.pixels):
                    v = float(self.latency_ms[i, j, k])
                    if np.isfinite(v):
                        yield t, b, p, v

    def to_dict(self) -> Dict:
        """JSON-serializable form for a serving layer. NaN cells become
        None: bare NaN tokens are rejected by spec-compliant JSON parsers."""
        lat = [[[v if np.isfinite(v) else None for v in row]
                for row in plane] for plane in self.latency_ms.tolist()]
        return {"request": dataclasses.asdict(self.request),
                "latency_ms": lat}
