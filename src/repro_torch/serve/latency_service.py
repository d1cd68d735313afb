"""Wave-based microbatching front-end over ``repro_torch.api.LatencyOracle``.

The latency-prediction sibling of the token engine in ``serve/engine.py``:
requests queue up, a *wave* of up to ``max_wave`` is admitted, the wave is
answered with the minimum number of fused model dispatches (via the
oracle's plan -> batch -> execute pipeline and its stacked ``ModelBank``),
and completed requests carry their result or a typed per-request error.
Mixed traffic — measured, cross, and two-phase requests over any set of
device pairs — shares one execution engine, so a wave costs ONE grouped
forest launch + one stacked MLP apply total, not one Python round-trip per
request or per device pair.

On top of the executor the service adds:

  - an **epoch-keyed LRU cache**: a request whose content (anchor, target,
    workload, mode, knob, profile-by-value) was answered before *under the
    current oracle epoch* is completed without planning or executing
    anything. The epoch defaults to the oracle's artifact-store config
    fingerprint;
  - **refresh-aware swaps**: :meth:`LatencyService.oracle_refreshed`
    atomically replaces the oracle mid-traffic — in-flight waves drain on
    the oracle they were admitted under, new admissions plan/execute/cache
    under the new epoch, and every stale cache entry is invalidated;
  - **epoch-aware warm-up**: at construction and before every swap the
    incoming oracle's ModelBank is built and its MLP bucket shapes are
    pre-compiled up to ``warmup_rows`` (default: ``2 * max_wave``, the
    most phase-1 rows a wave of all-two-phase requests can register), so
    the first wave served under a new epoch pays zero compiles
    (``ServiceStats.warmup_ms``);
  - **per-request error isolation**: planning happens per request, so one
    unroutable request (unknown device, off-catalog price, no min/max
    configs) marks only itself failed — the rest of the wave executes;
  - **``ServiceStats``**: requests, waves, fused calls, cache hits (lifetime
    + per-epoch), epoch swaps/invalidations, errors, wall time, and p50/p99
    per-request service latency.

The queue, cache, and swap paths are lock-guarded so an async transport
(``repro_torch.serve.transport``) can submit from its event loop while a worker
thread drains waves.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.oracle import LatencyOracle
from repro_torch.api.planner import minmax_cases, request_fingerprint
from repro_torch.api.types import (ANCHOR_ANY, ApiError, CircuitOpenError,
                             DeadlineExceededError, ExecutionError,
                             KNOB_BATCH, KNOB_PIXEL, PredictRequest,
                             PredictResult, ServiceStats, Workload)
from repro_torch.serve import faults as faults_mod
from repro_torch.serve.resilience import CircuitBreaker

_MISS = object()

# How many past epochs the A/B/A uniquification remembers. Bounded so the
# calibrate promote/rollback loop can't grow the set forever; 1024 is far
# beyond any plausible number of in-flight-wave generations.
_EPOCH_MEMORY = 1024


@dataclasses.dataclass
class ServiceRequest:
    """One in-flight prediction request; ``result`` XOR ``error`` is set
    when ``done``."""
    uid: int
    request: PredictRequest
    t_submit: float = 0.0
    # filled by the service
    result: Optional[PredictResult] = None
    error: Optional[ApiError] = None
    done: bool = False
    t_finish: float = 0.0

    @property
    def latency_ms(self) -> float:
        """Service latency (queue + execute), not the predicted latency."""
        return 1e3 * (self.t_finish - self.t_submit)


class LatencyService:
    """Queue -> admit wave -> fused execute -> complete."""

    def __init__(self, oracle: LatencyOracle, *, max_wave: int = 64,
                 cache_size: int = 4096, epoch: Optional[str] = None,
                 warmup: bool = True, warmup_rows: Optional[int] = None,
                 faults=None, breaker: Optional[CircuitBreaker] = None,
                 shard_plane=None, supervise=False):
        self.oracle = oracle
        self.max_wave = int(max_wave)
        self.cache_size = int(cache_size)
        self.queue: List[ServiceRequest] = []
        self.finished: List[ServiceRequest] = []
        self.stats = ServiceStats()
        self._cache: "OrderedDict[tuple, PredictResult]" = OrderedDict()
        self._uid = 0
        self._lock = threading.Lock()
        self._epoch = epoch if epoch is not None else oracle.fingerprint
        # insertion-ordered bounded memory of every epoch label served
        # (values unused) — see _remember_epoch
        self._used_epochs: "OrderedDict[str, None]" = OrderedDict()
        self._used_epochs[self._epoch] = None
        self.stats.epoch = self._epoch
        # deterministic fault injection (chaos tests); None in production
        self._faults = faults
        # per-(anchor, target) quarantine after repeated wave failures
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        # False after a warm-up/bank failure: execute takes the per-group
        # fallback path until a healthy oracle is swapped in
        self._banked = True
        # epoch-aware warm-up: build the oracle's ModelBank and pre-compile
        # the MLP bucket shapes up to one full wave BEFORE any traffic is
        # admitted, so the first wave pays zero compiles. Re-run on every
        # oracle_refreshed swap for the incoming oracle.
        self._warmup_enabled = bool(warmup)
        # a wave of max_wave requests can register up to 2*max_wave phase-1
        # rows (two-phase plans contribute a min AND a max row), so the
        # default warm-up must cover the doubled bucket or the first
        # two-phase-heavy wave would still pay a compile
        self._warmup_rows = int(warmup_rows if warmup_rows is not None
                                else 2 * self.max_wave)
        # wave observer (live calibration): called after each completed
        # wave with its finished requests. Never on the submit path, and
        # exceptions are swallowed — observers must not break serving.
        self._observer = None
        # multi-worker shard plane (repro_torch.serve.shard.ShardPlane): when
        # set, every banked wave executes through a ShardedBank generation
        # instead of the oracle's own bank — scattered by (anchor, target)
        # group across the plane's workers, gathered back in row order,
        # bit-identical answers. The service owns generation lifecycle:
        # one per oracle epoch, swapped all-or-nothing in oracle_refreshed.
        self.shard_plane = shard_plane
        self._shard_gen = None
        if self._warmup_enabled:
            # a warm-up that dies at construction must not take the
            # service down with it: serve degraded on the per-group
            # (unbanked) path instead. oracle_refreshed swaps keep the
            # strict behavior (raise, incumbent intact) — a failed
            # *upgrade* is rejected, a failed *boot* limps along.
            try:
                self._warm(oracle)
            except Exception as e:
                self._mark_degraded(
                    f"warm-up failed at construction "
                    f"({type(e).__name__}: {e}); serving per-group")
        if self.shard_plane is not None:
            # boot-time generation load follows the same degrade-not-crash
            # rule as warm-up: a failed load leaves _shard_gen unset and
            # waves execute through the oracle's own (unsharded) bank
            try:
                self._shard_gen = self._load_generation(oracle)
            except Exception as e:
                with self._lock:
                    self.stats.degraded = True
                    self.stats.degraded_reason = (
                        f"shard-plane load failed at construction "
                        f"({type(e).__name__}: {e}); serving unsharded")
        # self-healing supervision (repro_torch.serve.lifecycle): leases every
        # worker and respawns/re-adopts dead ones. supervise=True uses
        # defaults, or pass a LifecycleConfig. The supervisor attaches to
        # the plane (plane.close() stops it) and is exposed here for
        # transport telemetry.
        self.supervisor = None
        if self.shard_plane is not None and supervise:
            from repro_torch.serve.lifecycle import (LifecycleConfig,
                                               WorkerSupervisor)
            cfg = supervise if isinstance(supervise, LifecycleConfig) \
                else None
            self.supervisor = WorkerSupervisor(
                self.shard_plane, config=cfg, faults=faults).start()

    def _load_generation(self, oracle: LatencyOracle):
        """Split-and-load ``oracle``'s bank onto the shard plane; returns
        the new ShardedBank generation, or None when the oracle has no
        bank (unbankable models serve per-group, unsharded)."""
        bank = oracle.bank
        if bank is None:
            return None
        return self.shard_plane.load(bank)

    def _warm(self, oracle: LatencyOracle) -> None:
        faults_mod.fire(self._faults, faults_mod.SITE_WARMUP)
        self.stats.warmup_ms += 1e3 * oracle.warmup(
            max_rows=self._warmup_rows)

    def _mark_degraded(self, reason: str) -> None:
        with self._lock:
            self._banked = False
            self.stats.degraded = True
            self.stats.degraded_reason = reason

    def _remember_epoch(self, epoch: str) -> None:
        """Record ``epoch`` in the bounded uniquification memory (caller
        holds the lock)."""
        self._used_epochs[epoch] = None
        while len(self._used_epochs) > _EPOCH_MEMORY:
            self._used_epochs.popitem(last=False)

    @property
    def epoch(self) -> str:
        """The cache epoch new admissions are served under."""
        return self._epoch

    def set_observer(self, callback) -> None:
        """Register a wave observer: ``callback(completed)`` runs after
        each wave with that wave's finished :class:`ServiceRequest` list
        (results and errors both included). Used by ``repro_torch.calibrate`` to
        mirror live traffic onto shadow candidates without touching the
        serving path; any exception it raises is swallowed."""
        self._observer = callback

    def _notify_observer(self, wave: Sequence["ServiceRequest"]) -> None:
        cb = self._observer
        if cb is None:
            return
        try:
            cb([sr for sr in wave if sr.error is None])
        except Exception:
            pass

    # ------------------------------------------------------------------
    def submit(self, request: PredictRequest) -> ServiceRequest:
        t = time.perf_counter()
        with self._lock:
            sr = ServiceRequest(uid=self._uid, request=request, t_submit=t)
            self._uid += 1
            self.queue.append(sr)
        return sr

    def pending(self) -> int:
        with self._lock:
            return len(self.queue)

    def queued_uids(self) -> set:
        with self._lock:
            return {sr.uid for sr in self.queue}

    # ------------------------------------------------------------------
    def oracle_refreshed(self, oracle: Optional[LatencyOracle] = None,
                         fingerprint: Optional[str] = None) -> str:
        """Refresh hook: atomically swap in a refit oracle mid-traffic.

        The new cache epoch is ``fingerprint`` (typically the refreshed
        artifact's store fingerprint); when omitted it is derived from the
        new oracle's config fingerprint. Either way, an epoch equal to the
        current one is uniquified with the swap counter — a refresh means
        the model changed even when the label did not, so stale entries
        must never survive the swap. In-flight
        waves keep draining on the oracle they snapshotted at admission;
        every wave admitted after this returns plans, executes, and caches
        under the new epoch. Stale cache entries are purged (counted in
        ``stats.invalidated``) and the per-epoch hit counter resets.
        Returns the new epoch.

        The incoming oracle is warmed BEFORE the swap (bank built, MLP
        bucket shapes compiled, ``stats.warmup_ms`` accumulated) so the
        first post-swap wave pays zero compiles — in-flight traffic keeps
        draining on the old oracle/bank meanwhile."""
        if oracle is not None and self._warmup_enabled:
            self._warm(oracle)
        new_gen = old_gen = None
        if oracle is not None and self.shard_plane is not None:
            # load the incoming bank's generation onto every worker BEFORE
            # taking the lock: the swap is all-or-nothing (a failed load
            # raises here, incumbent generation and oracle untouched), and
            # no wave can ever mix epochs across shards — waves admitted
            # before the commit below hold the old generation, waves after
            # it hold the new one, and the old generation is only dropped
            # once its in-flight waves drain.
            new_gen = self._load_generation(oracle)
        with self._lock:
            if oracle is not None:
                self.oracle = oracle
                if self.shard_plane is not None:
                    old_gen, self._shard_gen = self._shard_gen, new_gen
            epoch = (fingerprint if fingerprint is not None
                     else self.oracle.fingerprint)
            # a refresh means the model changed even when the label did
            # not (same-config refit, or an operator reusing a deploy
            # tag). Uniquify against every epoch EVER used, not just the
            # current one — an A/B/A label sequence would otherwise let an
            # in-flight old-epoch wave cache stale results under the
            # re-current epoch.
            n = self.stats.epoch_swaps
            while epoch in self._used_epochs:
                n += 1
                epoch = f"{epoch}+{n}"
            self._remember_epoch(epoch)
            self._epoch = epoch
            stale = [k for k in self._cache if k[0] != epoch]
            for k in stale:
                del self._cache[k]
            self.stats.invalidated += len(stale)
            self.stats.epoch_swaps += 1
            self.stats.epoch_cache_hits = 0
            self.stats.epoch = epoch
            if oracle is not None:
                # a freshly warmed oracle clears degraded mode and resets
                # the circuit breaker: the new model's reputation starts
                # clean, and the warm-up above proved the banked path
                self._banked = True
                self.stats.degraded = False
                self.stats.degraded_reason = None
        if oracle is not None:
            self.breaker.reset()
            if self.shard_plane is not None:
                self.shard_plane.breaker.reset()
                self.shard_plane.retire(old_gen)
        return epoch

    # ------------------------------------------------------------------
    def _complete(self, sr: ServiceRequest) -> None:
        sr.done = True
        sr.t_finish = time.perf_counter()
        with self._lock:
            self.finished.append(sr)
            self.stats.latencies_ms.append(sr.latency_ms)

    def _fail(self, sr: ServiceRequest, err: ApiError) -> None:
        with self._lock:
            self.stats.errors += 1
        sr.error = err
        self._complete(sr)

    @staticmethod
    def _deadline_error(sr: ServiceRequest,
                        now: float) -> Optional[DeadlineExceededError]:
        budget = sr.request.deadline_ms
        if budget is None:
            return None
        spent_ms = 1e3 * (now - sr.t_submit)
        if spent_ms <= budget:
            return None
        return DeadlineExceededError(
            f"deadline of {budget:.1f} ms exceeded before planning "
            f"({spent_ms:.1f} ms since submission)")

    def _run_wave(self, wave: Sequence[ServiceRequest],
                  oracle: LatencyOracle, epoch: str,
                  sharded=None) -> None:
        plans, pending = [], []
        now = time.perf_counter()
        for sr in wave:
            # shed already-expired requests before spending cache, planner,
            # or model time on them: the caller has moved on
            expired = self._deadline_error(sr, now)
            if expired is not None:
                with self._lock:
                    self.stats.deadline_expired += 1
                self._fail(sr, expired)
                continue
            key = (epoch,) + request_fingerprint(sr.request)
            with self._lock:
                hit = self._cache.get(key, _MISS)
                if hit is not _MISS:
                    self._cache.move_to_end(key)
                    self.stats.cache_hits += 1
                    self.stats.epoch_cache_hits += 1
            if hit is not _MISS:
                sr.result = hit
                self._complete(sr)
                continue
            try:
                faults_mod.fire(self._faults, faults_mod.SITE_PLAN)
                plan = oracle.plan(sr.request)
            except ApiError as e:
                self._fail(sr, e)
                continue
            except Exception as e:
                # a planner bug (or injected fault) marks only this
                # request failed — never the pump thread
                self._fail(sr, ExecutionError(f"planning failed: {e!r}"))
                continue
            # the plan carries the concrete anchor (ANCHOR_ANY resolved),
            # so the breaker quarantines real pairs, not the sentinel
            if not self.breaker.allow((plan.anchor, plan.target)):
                with self._lock:
                    self.stats.circuit_rejections += 1
                self._fail(sr, CircuitOpenError(
                    f"pair ({plan.anchor!r} -> {plan.target!r}) is "
                    f"quarantined after repeated wave failures; retry "
                    f"after cooldown"))
                continue
            plans.append(plan)
            pending.append((sr, key))
        if plans:
            pairs = {(p.anchor, p.target) for p in plans}
            try:
                faults_mod.fire(self._faults, faults_mod.SITE_EXECUTE)
                batch = oracle.execute(plans, epoch=epoch,
                                       banked=self._banked, bank=sharded)
            except Exception as e:
                # an executor-level failure (bug, resource exhaustion) must
                # not escape run(): it would kill a transport's pump task
                # and hang every queued client. Fail the wave's requests
                # individually instead; the service stays up.
                err = e if isinstance(e, ApiError) else ExecutionError(
                    f"wave execution failed: {e!r}")
                for pair in pairs:
                    self.breaker.record_failure(pair)
                for sr, _ in pending:
                    self._fail(sr, err)
                with self._lock:
                    self.stats.circuit_trips = self.breaker.trips()
                    self.stats.requests += len(wave)
                    self.stats.waves += 1
                self._notify_observer(wave)
                return
            for pair in pairs:
                self.breaker.record_success(pair)
            if self._banked and oracle.bank_error is not None:
                # the bank build died under us mid-flight; execute already
                # fell back per group — flag it so /statsz tells the truth
                self._mark_degraded(
                    f"bank build failed ({oracle.bank_error}); "
                    f"serving per-group")
            with self._lock:
                self.stats.fused_calls += batch.fused_calls
                if sharded is not None:
                    # plane counters are lifetime totals; mirror them so
                    # /statsz reports without reaching into the plane
                    self.stats.shard_fallback_rows = \
                        self.shard_plane.fallback_rows
            errs = batch.errors or ((None,) * len(batch.results))
            for (sr, key), res, err in zip(pending, batch.results, errs):
                if err is not None:
                    # a shard slice died mid-wave: only the requests whose
                    # rows rode it fail (typed), the rest of the wave's
                    # answers stand and the pump survives
                    with self._lock:
                        self.stats.shard_slice_errors += 1
                    self._fail(sr, err)
                    continue
                sr.result = res
                with self._lock:
                    if sr.request.anchor == ANCHOR_ANY:
                        self.stats.rerouted += 1
                    # a swap may have landed mid-execute: entries keyed to
                    # a stale epoch can never be hit again, so don't store
                    if key[0] == self._epoch:
                        self._cache[key] = res
                        while len(self._cache) > self.cache_size:
                            self._cache.popitem(last=False)
                self._complete(sr)
        with self._lock:
            self.stats.requests += len(wave)
            self.stats.waves += 1
        self._notify_observer(wave)

    def _next_wave(self):
        """Atomically admit the next wave under the current oracle epoch,
        holding a reference on the current shard generation (if any) so a
        concurrent swap cannot drop it out from under the wave."""
        with self._lock:
            wave = self.queue[:self.max_wave]
            del self.queue[:self.max_wave]
            sharded = self._shard_gen if (wave and self._banked) else None
            if sharded is not None:
                self.shard_plane.acquire(sharded)
            return wave, self.oracle, self._epoch, sharded

    def run_once(self) -> int:
        """Admit and execute ONE wave; returns how many requests it
        served (0 = queue empty). A transport pumps this per executor hop
        so each wave's responses flush as soon as it completes instead of
        waiting for a full drain."""
        t0 = time.perf_counter()
        wave, oracle, epoch, sharded = self._next_wave()
        if not wave:
            return 0
        try:
            self._run_wave(wave, oracle, epoch, sharded)
        finally:
            if sharded is not None:
                self.shard_plane.release(sharded)
        with self._lock:
            self.stats.wall_s += time.perf_counter() - t0
        return len(wave)

    def run(self) -> List[ServiceRequest]:
        """Drain the queue in waves; returns finished requests in
        completion order."""
        while self.run_once():
            pass
        return self.finished

    def take_finished(self) -> List[ServiceRequest]:
        """Drain and return the finished list (a long-lived transport calls
        this after each ``run`` so completions don't accumulate forever)."""
        with self._lock:
            done, self.finished = self.finished, []
        return done


# ----------------------------------------------------------------------
# synthetic traffic (CLI replay + benchmarks)
# ----------------------------------------------------------------------

_OFF_GRID_BATCHES = (24, 48, 96, 192)
_OFF_GRID_PIXELS = (48, 96, 160, 240)


def synthetic_requests(oracle: LatencyOracle, n: int = 500, seed: int = 0,
                       client_profile_frac: float = 0.25
                       ) -> List[PredictRequest]:
    """A shuffled mixed workload over every trained pair of ``oracle``:
    ~20% measured (target == anchor), ~45% cross (some with client-supplied
    profile copies), ~35% two-phase at off-grid knob values. Two-phase
    candidates whose min/max configs are unmeasured fall back to cross so
    every generated request is answerable."""
    rng = np.random.default_rng(seed)
    ds = oracle.dataset
    anchors = sorted({a for a, _ in oracle.pairs()})
    if not anchors:
        raise ValueError("oracle has no trained pairs")
    reqs: List[PredictRequest] = []
    for _ in range(n):
        anchor = anchors[rng.integers(len(anchors))]
        targets = oracle.targets_from(anchor)
        case = ds.cases[rng.integers(len(ds.cases))]
        kind = rng.random()
        if kind < 0.20:
            reqs.append(PredictRequest(anchor, anchor,
                                       Workload.from_case(case)))
            continue
        target = targets[rng.integers(len(targets))]
        if kind < 0.65:
            profile = (dict(ds.profile(anchor, case))
                       if rng.random() < client_profile_frac else None)
            reqs.append(PredictRequest(anchor, target,
                                       Workload.from_case(case),
                                       profile=profile))
            continue
        model, batch, pix = case
        if rng.random() < 0.5:
            knob = KNOB_BATCH
            w = Workload(model, int(rng.choice(_OFF_GRID_BATCHES)), pix)
        else:
            knob = KNOB_PIXEL
            w = Workload(model, batch, int(rng.choice(_OFF_GRID_PIXELS)))
        if minmax_cases(w, knob, ds.measurements[anchor]) is None:
            reqs.append(PredictRequest(anchor, target,
                                       Workload.from_case(case)))
        else:
            reqs.append(PredictRequest(anchor, target, w, knob=knob))
    return reqs
