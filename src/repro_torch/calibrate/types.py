"""Typed surface of the live-calibration control plane.

Everything crossing the ``repro_torch.calibrate`` boundary is one of these
plain dataclasses: a client-measured :class:`Observation`, the knobs of
:class:`CalibrationConfig`, and the mutable :class:`CalibrationStats` the
controller exports through ``/statsz`` so every state transition (drift
detected, refit launched, canary verdict, promotion, rollback) is
observable from the outside.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

Case = Tuple[str, int, int]
Pair = Tuple[str, str]

# Controller states (``CalibrationStats.state``)
STATE_IDLE = "idle"          # watching drift, no candidate in flight
STATE_SHADOW = "shadow"      # candidate refit, canary scoring in progress
STATE_CONFIRM = "confirm"    # candidate promoted, post-promote watch window


def pair_label(pair: Pair) -> str:
    return f"{pair[0]}->{pair[1]}"


@dataclasses.dataclass(frozen=True)
class Observation:
    """One client-measured ground-truth latency: ``workload`` ran on
    ``target`` and took ``latency_ms``, after the serving path predicted
    ``predicted_ms`` for it (``None`` when the client did not echo the
    prediction back — the controller then scores it against the incumbent
    oracle off the hot path)."""
    anchor: str
    target: str
    case: Case
    latency_ms: float
    predicted_ms: Optional[float] = None
    # the cache epoch that produced predicted_ms (clients echo the
    # response's epoch). A prediction echoed from a pre-swap epoch is NOT
    # scored as-is — the controller re-predicts it under the current
    # oracle, so in-flight client batches can never fake a regression of
    # a freshly promoted epoch.
    epoch: Optional[str] = None

    @property
    def pair(self) -> Pair:
        return (self.anchor, self.target)


@dataclasses.dataclass(frozen=True)
class CalibrationConfig:
    """Knobs of the ingest -> drift -> refit -> shadow -> promote loop.

    Drift triggers at ``trigger_mape`` (rolling, per pair, over
    ``drift_window`` scored observations, at least ``min_obs`` of them) and
    clears only below ``trigger_mape * clear_ratio`` — the hysteresis band
    that keeps a pair hovering at the threshold from flapping
    detect/refit cycles."""
    # ingest
    per_pair_capacity: int = 512     # ring-buffer depth per (anchor, target)
    max_pairs: int = 64              # distinct pairs tracked before drops
    # drift detection
    drift_window: int = 64           # rolling MAPE window (observations)
    min_obs: int = 8                 # observations before a pair can trigger
    trigger_mape: float = 15.0       # percent; rolling MAPE above -> drifted
    clear_ratio: float = 0.6         # clear below trigger_mape * clear_ratio
    # refit
    min_refit_obs: int = 4           # usable observations to refit a pair
    drift_confirm_obs: int = 24      # obs scored on a drifted pair AFTER
                                     # detection before a refit launches —
                                     # the refit then trains on the last
                                     # drift_confirm_obs observations, all
                                     # from the post-detection regime (a
                                     # refit at the trigger moment would
                                     # blend pre- and post-drift truth)
    cooldown_scored: int = 32        # scored obs between refit attempts
    refit_interval_s: Optional[float] = None
                                     # wall-clock cadence of *scheduled*
                                     # refits: when idle (no drift) and
                                     # this many seconds have passed since
                                     # the last refit launched, the
                                     # controller refits every pair with
                                     # >= min_refit_obs buffered truth
                                     # through the same shadow-canary /
                                     # promote path. None disables.
    # shadow canary
    mirror_capacity: int = 32        # mirrored live waves buffered at once
    canary_waves: int = 1            # mirrored waves before a verdict …
    canary_patience_steps: int = 5   # … or this many quiet control steps
    canary_min_obs: int = 4          # held-out obs per scored pair
    regress_margin: float = 1.0      # pts a non-refit pair may regress
    # post-promote confirmation
    confirm_obs: int = 16            # scored obs before confirm/rollback
    # crash-safe persistence: when set, every promoted candidate is
    # written through the versioned artifact store (repro_torch.api.artifacts.
    # CalibrationStore) under this directory and demoted on rollback, so
    # a restarted server recovers the latest promoted calibration
    persist_dir: Optional[str] = None


@dataclasses.dataclass
class CalibrationStats:
    """Counters of one :class:`repro_torch.calibrate.Calibrator` (mutable —
    the controller updates it observation by observation). ``summary()`` is
    the JSON block ``/statsz`` exports; every control-plane transition shows
    up here: ``drift_events`` (pairs crossing the trigger), ``refits``
    (candidates built), ``canary_pass``/``canary_fail`` (verdicts),
    ``promotions``/``rollbacks``/``confirms`` (epoch transitions)."""
    observations: int = 0            # accepted into the buffer
    dropped: int = 0                 # rejected at ingest (bad value, pair
                                     # table full, unroutable pair)
    evicted: int = 0                 # ring-buffer overwrites (oldest out)
    scored: int = 0                  # observations scored against a live
                                     # prediction
    unscorable: int = 0              # no prediction obtainable (plan error)
    drift_events: int = 0
    refits: int = 0
    scheduled_refits: int = 0        # refits launched on the wall-clock
                                     # cadence rather than by drift
    canary_pass: int = 0
    canary_fail: int = 0
    promotions: int = 0
    rollbacks: int = 0
    confirms: int = 0                # promotions that survived the watch
    shadow_waves: int = 0            # mirrored live waves replayed on a
    shadow_requests: int = 0         # candidate (off the serving path)
    shadow_errors: int = 0
    refit_errors: int = 0            # refit factory crashes survived
    canary_errors: int = 0           # canary verdict crashes survived
    persisted: int = 0               # promotions written to the store
    persist_failures: int = 0        # store writes that failed (promotion
                                     # stands; only persistence is lost)
    state: str = STATE_IDLE
    last_verdict: Optional[Dict[str, object]] = None
    events: List[str] = dataclasses.field(default_factory=list)

    _EVENT_CAP = 256

    def event(self, msg: str) -> None:
        self.events.append(msg)
        if len(self.events) > self._EVENT_CAP:
            del self.events[:len(self.events) - self._EVENT_CAP]

    def summary(self) -> Dict[str, object]:
        return {"state": self.state,
                "observations": self.observations, "dropped": self.dropped,
                "evicted": self.evicted, "scored": self.scored,
                "unscorable": self.unscorable,
                "drift_events": self.drift_events, "refits": self.refits,
                "scheduled_refits": self.scheduled_refits,
                "canary_pass": self.canary_pass,
                "canary_fail": self.canary_fail,
                "promotions": self.promotions, "rollbacks": self.rollbacks,
                "confirms": self.confirms,
                "shadow_waves": self.shadow_waves,
                "shadow_requests": self.shadow_requests,
                "shadow_errors": self.shadow_errors,
                "refit_errors": self.refit_errors,
                "canary_errors": self.canary_errors,
                "persisted": self.persisted,
                "persist_failures": self.persist_failures,
                "last_verdict": self.last_verdict,
                "last_event": self.events[-1] if self.events else None}
