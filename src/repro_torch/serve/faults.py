"""Deterministic fault injection for the serving plane.

Chaos testing only pays off when a failing run can be replayed: a
``FaultPlan`` is a *script* — a tuple of :class:`FaultRule` entries, each
naming a fault **site** (a string like ``"service.execute"``), a fault
kind, and a deterministic firing schedule (explicit hit indices and/or a
seeded Bernoulli rate). A :class:`FaultInjector` owns the plan plus one
independent seeded RNG per rule, so the decision sequence at each site
depends only on ``(plan.seed, rule index, per-site hit count)`` — never
on thread interleaving across sites.

Sites are pure strings; production code marks them with the module-level
helpers, which are no-ops when no injector is threaded through::

    faults.fire(self._faults, faults.SITE_EXECUTE)      # error / delay
    if faults.should_drop(self._faults, faults.SITE_RESPONSE):
        ...  # caller performs the drop (e.g. close the socket early)

Fault kinds:

``error``
    raise :class:`InjectedFault` (deliberately *not* an ``ApiError`` —
    injected faults must exercise the generic failure paths, not the
    typed happy-path error mapping).
``delay``
    sleep ``delay_s`` seconds at the site, then continue (slow waves,
    stalled pumps).
``drop``
    only consulted by ``should_drop`` sites; the caller implements the
    drop action (e.g. truncate + reset a socket mid-response).

Every firing is recorded (site, kind, hit index) so tests can assert the
exact chaos that ran.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

ERROR = "error"
DELAY = "delay"
DROP = "drop"
_KINDS = (ERROR, DELAY, DROP)

# Fault-site catalog (see api/README.md "Resilience & fault injection").
SITE_PLAN = "service.plan"          # per-request planning in a wave
SITE_EXECUTE = "service.execute"    # fused wave execute
SITE_WARMUP = "service.warmup"      # bank build + shape pre-compilation
SITE_PUMP = "transport.pump"        # async pump drain hop
SITE_RESPONSE = "transport.response"  # socket write of a response (drop)
SITE_REFIT = "calibrate.refit"      # background candidate refit
SITE_CANARY = "calibrate.canary"    # shadow canary verdict
# TCP shard-worker wire faults (see repro_torch.serve.shard.WorkerServer):
SITE_SHARD_SLOW = "shard.worker.slow"    # delay before replying (slow peer)
SITE_SHARD_RESET = "shard.worker.reset"  # error -> RST-close the connection
SITE_SHARD_FRAME = "shard.worker.frame"  # drop -> truncate the reply frame
# Worker lifecycle faults (see repro_torch.serve.lifecycle.WorkerSupervisor):
SITE_SHARD_LEASE = "shard.worker.lease"    # error -> a lease ping is lost
SITE_RESPAWN_FAIL = "shard.respawn.fail"   # error -> a respawn attempt dies

SITES = (SITE_PLAN, SITE_EXECUTE, SITE_WARMUP, SITE_PUMP, SITE_RESPONSE,
         SITE_REFIT, SITE_CANARY, SITE_SHARD_SLOW, SITE_SHARD_RESET,
         SITE_SHARD_FRAME, SITE_SHARD_LEASE, SITE_RESPAWN_FAIL)


class InjectedFault(RuntimeError):
    """The scripted failure raised at an ``error`` fault site."""

    def __init__(self, site: str, hit: int, message: str = ""):
        self.site = site
        self.hit = hit
        super().__init__(message or f"injected fault at {site} (hit {hit})")


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One scripted fault: fire ``kind`` at ``site`` on a deterministic
    schedule — explicit 0-based per-site hit indices (``at``), a seeded
    Bernoulli ``rate``, or both (a hit fires if either says so). ``limit``
    caps total firings of this rule."""
    site: str
    kind: str = ERROR
    at: Optional[Tuple[int, ...]] = None
    rate: float = 0.0
    limit: Optional[int] = None
    delay_s: float = 0.0
    message: str = ""

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {_KINDS}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.at is not None:
            object.__setattr__(self, "at", tuple(int(i) for i in self.at))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A replayable chaos script: rules plus the seed that fixes every
    rate-based decision."""
    rules: Tuple[FaultRule, ...] = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))


class FaultInjector:
    """Executes a :class:`FaultPlan`. Thread-safe; decisions are
    deterministic per (rule, per-site hit index) regardless of how
    threads interleave across *different* sites."""

    def __init__(self, plan: FaultPlan):
        self._lock = threading.Lock()
        self._fired: List[Tuple[str, str, int]] = []
        self._hits = {}
        self._set_plan(plan)

    def _set_plan(self, plan: FaultPlan) -> None:
        self.plan = plan
        self._rules = list(plan.rules)
        self._rngs = [np.random.default_rng((plan.seed, i))
                      for i in range(len(self._rules))]
        self._counts = [0] * len(self._rules)

    # -- bookkeeping -------------------------------------------------------

    @property
    def fired(self) -> List[Tuple[str, str, int]]:
        """Every firing so far as ``(site, kind, hit_index)``."""
        with self._lock:
            return list(self._fired)

    def hits(self, site: str) -> int:
        """How many times ``site`` was *reached* (fired or not)."""
        with self._lock:
            return self._hits.get(site, 0)

    def clear(self) -> None:
        """Drop every rule (stop injecting); firing history is kept."""
        with self._lock:
            self._set_plan(FaultPlan(rules=(), seed=self.plan.seed))

    # -- decision core -----------------------------------------------------

    def _decide(self, site: str, kinds) -> List[Tuple[FaultRule, int]]:
        """Under the lock: advance the site hit counter, return the rules
        of matching ``kinds`` that fire at this hit."""
        hit = self._hits.get(site, 0)
        self._hits[site] = hit + 1
        firing = []
        for i, rule in enumerate(self._rules):
            if rule.site != site or rule.kind not in kinds:
                continue
            if rule.limit is not None and self._counts[i] >= rule.limit:
                continue
            fire_now = rule.at is not None and hit in rule.at
            if not fire_now and rule.rate > 0.0:
                fire_now = bool(self._rngs[i].random() < rule.rate)
            if fire_now:
                self._counts[i] += 1
                self._fired.append((site, rule.kind, hit))
                firing.append((rule, hit))
        return firing

    def fire(self, site: str) -> None:
        """Mark an error/delay site: sleep through any firing ``delay``
        rules, then raise on the first firing ``error`` rule."""
        with self._lock:
            firing = self._decide(site, (ERROR, DELAY))
        boom = None
        for rule, hit in firing:
            if rule.kind == DELAY:
                time.sleep(rule.delay_s)
            elif boom is None:
                boom = InjectedFault(site, hit, rule.message)
        if boom is not None:
            raise boom

    def drop(self, site: str) -> bool:
        """Mark a drop site; True when a ``drop`` rule fires (the caller
        performs the actual drop)."""
        with self._lock:
            return bool(self._decide(site, (DROP,)))


def fire(injector: Optional[FaultInjector], site: str) -> None:
    """No-op unless a live injector is threaded through."""
    if injector is not None:
        injector.fire(site)


def should_drop(injector: Optional[FaultInjector], site: str) -> bool:
    return injector is not None and injector.drop(site)
