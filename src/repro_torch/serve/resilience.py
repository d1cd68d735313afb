"""Resilience primitives for the serving plane: client retry policy
(exponential backoff + seeded jitter) and a per-(anchor, target) circuit
breaker with the classic closed / open / half-open state machine.

Both are transport-agnostic: :class:`RetryPolicy` is pure arithmetic
(the HTTP client owns the loop), and :class:`CircuitBreaker` is keyed by
arbitrary hashable keys — the wave service feeds it (anchor, target)
pairs and decides what a "failure" means (a fused wave execute that
died, not a typed per-request validation error).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

import numpy as np

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with jitter. ``backoff_s(k)`` is the sleep
    before retry ``k`` (k >= 1): ``base_s * multiplier**(k-1)`` capped at
    ``max_backoff_s``, with a uniform jitter of ±``jitter`` fraction.
    ``retry_statuses`` lists HTTP statuses worth retrying (e.g. 503
    back-pressure); connection failures are always retry *candidates* —
    the client additionally gates them on idempotency. ``seed`` pins the
    jitter stream for reproducible tests."""
    max_attempts: int = 2
    base_s: float = 0.05
    multiplier: float = 2.0
    max_backoff_s: float = 2.0
    jitter: float = 0.5
    retry_statuses: FrozenSet[int] = frozenset()
    seed: Optional[int] = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        object.__setattr__(self, "retry_statuses",
                           frozenset(self.retry_statuses))

    def rng(self) -> np.random.Generator:
        return np.random.default_rng(self.seed)

    def backoff_s(self, attempt: int,
                  rng: Optional[np.random.Generator] = None) -> float:
        if self.base_s <= 0.0:
            return 0.0
        raw = min(self.base_s * self.multiplier ** max(attempt - 1, 0),
                  self.max_backoff_s)
        if self.jitter <= 0.0:
            return raw
        u = (rng or np.random.default_rng()).random()
        return raw * (1.0 - self.jitter + 2.0 * self.jitter * u)


#: Back-compat default: two attempts, retry only connection failures
#: (no status-based retry), no sleep between them.
LEGACY_RETRY = RetryPolicy(max_attempts=2, base_s=0.0)


@dataclasses.dataclass
class _PairState:
    state: str = CLOSED
    failures: int = 0          # consecutive failures while closed/half-open
    open_until: float = 0.0
    probing: bool = False      # a half-open probe is in flight
    opened: int = 0            # times this key tripped open (accounting)


class CircuitBreaker:
    """Quarantine keys (e.g. (anchor, target) pairs) after ``threshold``
    *consecutive* failures. While open, ``allow`` fast-fails; after
    ``cooldown_s`` the next caller is admitted as a single half-open
    probe — its success closes the circuit, its failure re-opens it for
    another cooldown. ``clock`` is injectable for deterministic tests."""

    def __init__(self, threshold: int = 5, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._pairs: Dict[Tuple, _PairState] = {}

    def allow(self, key) -> bool:
        """May a request for ``key`` proceed right now? Transitions
        open -> half-open when the cooldown has elapsed (the caller that
        gets True becomes the probe)."""
        with self._lock:
            st = self._pairs.get(key)
            if st is None or st.state == CLOSED:
                return True
            if st.state == OPEN:
                if self._clock() >= st.open_until:
                    st.state = HALF_OPEN
                    st.probing = True
                    return True
                return False
            # half-open: exactly one probe at a time
            if st.probing:
                return False
            st.probing = True
            return True

    def record_success(self, key) -> None:
        with self._lock:
            st = self._pairs.get(key)
            if st is None:
                return
            st.state = CLOSED
            st.failures = 0
            st.probing = False

    def record_failure(self, key) -> None:
        with self._lock:
            st = self._pairs.setdefault(key, _PairState())
            st.failures += 1
            st.probing = False
            if st.state == HALF_OPEN or st.failures >= self.threshold:
                st.state = OPEN
                st.opened += 1
                st.open_until = self._clock() + self.cooldown_s

    def force_open(self, key) -> None:
        """Quarantine ``key`` permanently (no half-open probes): the
        shard plane uses this for a worker that *died* — unlike a
        transient exec failure, a dead process never recovers, so probing
        it would cost one failed slice per cooldown. Only :meth:`reset`
        (an oracle swap) clears it."""
        with self._lock:
            st = self._pairs.setdefault(key, _PairState())
            if st.state != OPEN or st.open_until != float("inf"):
                st.opened += 1
            st.state = OPEN
            st.probing = False
            st.open_until = float("inf")

    def heal(self, key) -> None:
        """Forget one key entirely — even a :meth:`force_open` quarantine.
        The shard plane calls this when a *recovered* worker is adopted:
        the replacement process/connection has no shared fate with the
        one that died, so its reputation starts clean (unlike
        ``record_success``, which only a successful probe should earn)."""
        with self._lock:
            self._pairs.pop(key, None)

    def state(self, key) -> str:
        with self._lock:
            st = self._pairs.get(key)
            return st.state if st is not None else CLOSED

    def open_keys(self) -> List[Tuple]:
        """Keys currently quarantined (open and still cooling down)."""
        now = self._clock()
        with self._lock:
            return [k for k, st in self._pairs.items()
                    if st.state == OPEN and now < st.open_until]

    def trips(self) -> int:
        """Total open transitions across all keys (accounting)."""
        with self._lock:
            return sum(st.opened for st in self._pairs.values())

    def reset(self) -> None:
        """Forget everything — e.g. after an oracle swap installs a fresh
        model whose reputation starts clean."""
        with self._lock:
            self._pairs.clear()
