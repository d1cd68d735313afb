"""The calibration controller: ingest -> drift -> refit -> shadow ->
promote/rollback over a live ``repro_torch.serve.LatencyService``.

The control plane over the serving data plane. The serving path only ever
does two things for calibration, both O(1): append a client-measured
observation to a bounded queue (``ingest``), and hand each completed wave
to the observer hook (mirrored — request list only — into a bounded
deque). Everything else — scoring observations against live predictions,
drift detection, candidate refits, shadow canary execution, the
``oracle_refreshed`` promote/rollback swaps — happens in :meth:`step`,
driven by a background thread (:meth:`start`) or called synchronously
(tests, benchmarks).

State machine (invariants: the incumbent always serves; candidates never
plan, execute, or compile on the hot path):

    idle     -- drift trigger -->  shadow    (refit built a candidate)
    shadow   -- canary pass   -->  confirm   (candidate promoted via the
                                              warm-up-aware epoch swap)
    shadow   -- canary fail   -->  idle      (candidate discarded; the
                                              incumbent never stopped
                                              serving; cooldown)
    confirm  -- live MAPE ok  -->  idle      (promotion confirmed)
    confirm  -- regression    -->  idle      (auto-rollback: re-swap to the
                                              pre-promotion oracle, which
                                              purges every cache key of the
                                              failed epoch; cooldown)

On the card the observer runs on the service's wave thread and touches no
tensor: it mirrors request lists only, so it never waits for the device.
The :meth:`start` thread trains the candidate's DNN member, launches the
canary's predictions and builds and warms up the candidate's bank on the
current (default) stream while the wave thread serves on it too; the
forest kernels' launch counts and per-stream tile counters are guarded
by ``repro_torch.kernels.forest_eval``'s lock, and launches on one stream
run in their order.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.api.types import ApiError, PredictRequest, Workload
from repro_torch.serve import faults as faults_mod
from repro_torch.calibrate import canary as canary_mod
from repro_torch.calibrate import refit as refit_mod
from repro_torch.calibrate.buffer import MeasurementBuffer
from repro_torch.calibrate.drift import DriftDetector
from repro_torch.calibrate.types import (STATE_CONFIRM, STATE_IDLE,
                                         STATE_SHADOW, CalibrationConfig,
                                         CalibrationStats, Observation, Pair,
                                         pair_label)

_PENDING_CAP = 4096


class Calibrator:
    """Streaming live-calibration over one :class:`LatencyService`.

    ``refit_fn(oracle, buffer, pairs, min_refit_obs=...)`` is the candidate
    factory (default :func:`repro_torch.calibrate.refit.build_candidate`);
    tests inject poisoned candidates through it.

    ``store`` (or ``config.persist_dir``) enables crash-safe persistence:
    every promoted candidate is written through the versioned artifact
    store under its serving epoch and demoted again on rollback, so a
    restarted ``serve_calibrated`` recovers the newest promoted
    calibration instead of forgetting it. Store failures never block a
    promotion — they are counted (``stats.persist_failures``) and served
    on.

    ``faults`` threads a :class:`repro_torch.serve.faults.FaultInjector`
    through the refit/canary sites for deterministic chaos tests; either
    crashing must leave the incumbent serving.
    """

    def __init__(self, service, config: Optional[CalibrationConfig] = None,
                 refit_fn=None, faults=None, store=None,
                 clock=time.monotonic):
        self.service = service
        self._clock = clock
        self.config = config or CalibrationConfig()
        self.stats = CalibrationStats()
        self._faults = faults
        if store is None and self.config.persist_dir:
            from repro_torch.api.artifacts import CalibrationStore
            store = CalibrationStore(self.config.persist_dir)
        self.store = store
        cfg = self.config
        self.buffer = MeasurementBuffer(
            per_pair=cfg.per_pair_capacity, max_pairs=cfg.max_pairs,
            allowed_pairs=set(service.oracle.pairs()))
        self.detector = DriftDetector(
            window=cfg.drift_window, min_obs=cfg.min_obs,
            trigger_mape=cfg.trigger_mape, clear_ratio=cfg.clear_ratio)
        self._refit_fn = refit_fn or refit_mod.build_candidate
        self._lock = threading.Lock()
        self._pending: deque = deque()         # accepted, not yet scored
        self._mirror: deque = deque(maxlen=cfg.mirror_capacity)
        # per-candidate shadow accumulators
        self._candidate = None
        self._refit_report = None
        self._refit_pairs: Tuple[Pair, ...] = ()
        self._shadow = {"waves": 0, "requests": 0, "errors": 0}
        self._shadow_steps = 0
        # obs scored on each pair since its drift was detected — a refit
        # waits for drift_confirm_obs of them so it trains purely on the
        # post-drift regime
        self._drift_seen: Dict[Pair, int] = {}
        # post-promote watch
        self._prev: Optional[Tuple[object, str]] = None
        self._confirm_start = 0
        self._cooldown_until = 0
        self._last_refit_t = clock()   # scheduled-refit cadence anchor
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        service.set_observer(self._observe)

    # ------------------------------------------------------------------
    # ingest (transport / advise path; O(1), lock-guarded, no model work)
    # ------------------------------------------------------------------
    def ingest(self, anchor: str, target: str, workload,
               latency_ms: float, predicted_ms: Optional[float] = None,
               epoch: Optional[str] = None) -> bool:
        """One client-measured observation. ``workload`` is a ``Workload``
        or a ``(model, batch, pix)`` case; ``epoch`` is the cache epoch
        the client's echoed ``predicted_ms`` came from. Returns whether it
        was accepted (drops are accounted in ``stats.dropped``)."""
        case = workload.case if isinstance(workload, Workload) \
            else (str(workload[0]), int(workload[1]), int(workload[2]))
        obs = Observation(anchor=str(anchor), target=str(target), case=case,
                          latency_ms=float(latency_ms),
                          predicted_ms=None if predicted_ms is None
                          else float(predicted_ms),
                          epoch=None if epoch is None else str(epoch))
        if not self.buffer.add(obs):
            self.stats.dropped += 1
            return False
        self.stats.observations += 1
        with self._lock:
            if len(self._pending) >= _PENDING_CAP:
                self._pending.popleft()       # scoring backlog: oldest out
                self.stats.unscorable += 1
            self._pending.append(obs)
        return True

    def ingest_rows(self, rows: Sequence[Dict]) -> Tuple[int, int]:
        """Batch ingest of decoded ``/measure`` rows; returns
        ``(accepted, dropped)``."""
        accepted = 0
        for row in rows:
            try:
                ok = self.ingest(row["anchor"], row["target"],
                                 (row["model"], row["batch"], row["pix"]),
                                 row["latency_ms"], row.get("predicted_ms"),
                                 epoch=row.get("epoch"))
            except (ApiError, KeyError, TypeError, ValueError):
                self.stats.dropped += 1
                ok = False
            accepted += bool(ok)
        return accepted, len(rows) - accepted

    # ------------------------------------------------------------------
    # wave observer (serving thread; must stay O(wave) and never raise)
    # ------------------------------------------------------------------
    def _observe(self, completed) -> None:
        if self.stats.state != STATE_SHADOW:
            return
        reqs = [sr.request for sr in completed]
        if reqs:
            with self._lock:
                self._mirror.append(reqs)

    # ------------------------------------------------------------------
    # the control loop
    # ------------------------------------------------------------------
    def step(self) -> str:
        """One control iteration: score pending observations, update drift
        state, and advance the idle/shadow/confirm machine. Returns the
        state after the step."""
        self._score_pending()
        state = self.stats.state
        if state == STATE_IDLE:
            self._idle_step()
        elif state == STATE_SHADOW:
            self._shadow_step()
        elif state == STATE_CONFIRM:
            self._confirm_step()
        return self.stats.state

    def _score_pending(self) -> None:
        with self._lock:
            pending = list(self._pending)
            self._pending.clear()
        if not pending:
            return
        # trust a client-echoed prediction only if it came from the epoch
        # currently serving — after a swap, in-flight client batches still
        # carry pre-swap predictions, and scoring those against the new
        # epoch's reputation would fake a regression (and trigger a bogus
        # rollback). Stale echoes are re-predicted under the live oracle.
        epoch = self.service.epoch
        need_pred = [o for o in pending
                     if o.predicted_ms is None
                     or (o.epoch is not None and o.epoch != epoch)]
        stale = {id(o) for o in need_pred}
        predicted: Dict[int, float] = {}
        if need_pred:
            oracle = self.service.oracle
            plans, plan_obs = [], []
            for o in need_pred:
                try:
                    plans.append(oracle.plan(PredictRequest(
                        o.anchor, o.target, Workload.from_case(o.case))))
                    plan_obs.append(o)
                except ApiError:
                    self.stats.unscorable += 1
            if plans:
                try:
                    batch = oracle.execute(plans)
                    for o, res in zip(plan_obs, batch.results):
                        predicted[id(o)] = res.latency_ms
                except Exception:
                    self.stats.unscorable += len(plans)
        for o in pending:
            pred = predicted.get(id(o)) if id(o) in stale \
                else o.predicted_ms
            if pred is None:
                continue
            transition = self.detector.update(o.pair, o.latency_ms, pred)
            self.stats.scored += 1
            if self.detector.is_drifted(o.pair):
                self._drift_seen[o.pair] = \
                    self._drift_seen.get(o.pair, 0) + 1
            if transition is True:
                self.stats.drift_events += 1
                self._drift_seen[o.pair] = 0
                self.stats.event(
                    f"drift detected on {pair_label(o.pair)}: rolling MAPE "
                    f"{self.detector.mape(o.pair):.2f} > "
                    f"{self.config.trigger_mape:.2f}")
            elif transition is False:
                self._drift_seen.pop(o.pair, None)
                self.stats.event(f"drift cleared on {pair_label(o.pair)}")

    # -- idle ----------------------------------------------------------
    def _idle_step(self) -> None:
        if self.stats.scored < self._cooldown_until:
            return
        trained = set(self.service.oracle.pairs())
        drifted = [p for p in self.detector.drifted_pairs()
                   if p in trained
                   and self._drift_seen.get(p, 0)
                   >= self.config.drift_confirm_obs]
        if drifted:
            self._launch_refit(drifted)
            return
        # wall-clock cadence: with no drift in sight, periodically fold
        # the accumulated ground truth back into the oracle anyway — the
        # candidate still has to earn promotion through the same shadow
        # canary, so a scheduled refit can never regress the incumbent.
        interval = self.config.refit_interval_s
        if interval is None or self._clock() - self._last_refit_t < interval:
            return
        due = [p for p in sorted(trained)
               if self.buffer.count(p) >= self.config.min_refit_obs]
        if due:
            self._launch_refit(due, scheduled=True)
        else:
            self._last_refit_t = self._clock()   # nothing to train on yet

    def _launch_refit(self, drifted: List[Pair],
                      scheduled: bool = False) -> None:
        self._last_refit_t = self._clock()
        kind = "scheduled refit" if scheduled else "refit"
        try:
            faults_mod.fire(self._faults, faults_mod.SITE_REFIT)
            candidate, report = self._refit_fn(
                self.service.oracle, self.buffer, drifted,
                min_refit_obs=self.config.min_refit_obs,
                window=self.config.drift_confirm_obs)
        except Exception as e:
            # a crashed refit (bad live data, injected fault) must not
            # take the control loop down — the incumbent keeps serving,
            # and the cooldown prevents a hot crash loop
            self.stats.refit_errors += 1
            self._cooldown_until = (self.stats.scored
                                    + self.config.cooldown_scored)
            self.stats.event(f"{kind} crashed ({e!r}); incumbent keeps "
                             "serving, retry after cooldown")
            return
        if candidate is None:
            self._cooldown_until = (self.stats.scored
                                    + self.config.cooldown_scored)
            self.stats.event(
                f"{kind} skipped: no candidate pair has enough usable "
                f"observations ({', '.join(map(pair_label, drifted))})")
            return
        self.stats.refits += 1
        if scheduled:
            self.stats.scheduled_refits += 1
        self._candidate, self._refit_report = candidate, report
        self._refit_pairs = tuple(report.pairs)
        self._shadow = {"waves": 0, "requests": 0, "errors": 0}
        self._shadow_steps = 0
        with self._lock:
            self._mirror.clear()
        self.stats.state = STATE_SHADOW
        self.stats.event(
            f"{kind} candidate over "
            f"{', '.join(map(pair_label, report.pairs))}"
            f" ({report.total_obs} obs folded in); shadow canary started")

    # -- shadow canary -------------------------------------------------
    def _shadow_step(self) -> None:
        self._shadow_steps += 1
        with self._lock:
            waves = list(self._mirror)
            self._mirror.clear()
        for reqs in waves:
            self._shadow["waves"] += 1
            self._shadow["requests"] += len(reqs)
            try:
                self._candidate.predict_many(reqs)
            except Exception:
                self._shadow["errors"] += 1
        self.stats.shadow_waves += len(waves)
        self.stats.shadow_requests += sum(len(r) for r in waves)
        self.stats.shadow_errors = (self.stats.shadow_errors
                                    + self._shadow["errors"]
                                    - self._shadow.get("_counted", 0))
        self._shadow["_counted"] = self._shadow["errors"]
        if (self._shadow["waves"] < self.config.canary_waves
                and self._shadow_steps < self.config.canary_patience_steps):
            return
        try:
            faults_mod.fire(self._faults, faults_mod.SITE_CANARY)
            rep = canary_mod.verdict(
                self.service.oracle, self._candidate, self.buffer,
                self._refit_pairs, min_obs=self.config.canary_min_obs,
                regress_margin=self.config.regress_margin,
                window=self.config.drift_confirm_obs,
                shadow_waves=self._shadow["waves"],
                shadow_requests=self._shadow["requests"],
                shadow_errors=self._shadow["errors"])
        except Exception as e:
            # a crashed canary can't vouch for the candidate: treat it as
            # a failed verdict — discard, cooldown, incumbent untouched
            self.stats.canary_errors += 1
            self.stats.canary_fail += 1
            self.stats.event(f"canary crashed ({e!r}); candidate "
                             "discarded — incumbent keeps serving")
            self._reset_candidate()
            return
        self.stats.last_verdict = rep.summary()
        if rep.passed:
            self._promote(rep)
        else:
            self._discard_candidate(rep)

    def _promote(self, rep) -> None:
        from repro_torch.api.artifacts import calibration_fingerprint
        label = calibration_fingerprint(
            self._candidate.config, self._refit_pairs,
            self._refit_report.total_obs if self._refit_report else 0)
        prev = (self.service.oracle, self.service.epoch)
        try:
            epoch = self.service.oracle_refreshed(self._candidate, label)
        except Exception as e:
            # a failed warm-up/swap leaves the incumbent serving (the
            # service guarantees no half-swapped state); the candidate is
            # discarded like a failed canary
            self.stats.canary_fail += 1
            self.stats.event(f"promotion failed pre-swap ({e!r}); "
                             "incumbent keeps serving")
            self._reset_candidate()
            return
        self.stats.canary_pass += 1
        self.stats.promotions += 1
        if self.store is not None:
            # persist AFTER the swap, under the epoch actually serving
            # (the service may have uniquified the label). A store failure
            # costs only durability, never the promotion itself.
            try:
                self.store.record_promotion(self._candidate, epoch)
                self.stats.persisted += 1
                self.stats.event(f"promotion persisted as epoch {epoch}")
            except Exception as e:
                self.stats.persist_failures += 1
                self.stats.event(f"promotion persist failed ({e!r}); "
                                 "serving unpersisted")
        self._prev = prev
        self.detector.reset(self._refit_pairs)
        for p in self._refit_pairs:
            self._drift_seen.pop(p, None)
        self._confirm_start = self.stats.scored
        self.stats.state = STATE_CONFIRM
        self.stats.event(f"canary passed ({rep.reason}); promoted "
                         f"candidate as epoch {epoch}")
        self._candidate = None

    def _discard_candidate(self, rep) -> None:
        self.stats.canary_fail += 1
        self.stats.event(f"canary failed ({rep.reason}); candidate rolled "
                         "back — incumbent keeps serving")
        self._reset_candidate()

    def _reset_candidate(self) -> None:
        self._candidate = None
        self._refit_report = None
        self._cooldown_until = (self.stats.scored
                                + self.config.cooldown_scored)
        self.stats.state = STATE_IDLE

    # -- post-promote confirmation ------------------------------------
    def _confirm_step(self) -> None:
        if self.stats.scored - self._confirm_start < self.config.confirm_obs:
            return
        bad = [p for p in self._refit_pairs
               if self.detector.samples(p) >= self.config.min_obs
               and self.detector.mape(p) >= self.config.trigger_mape]
        if bad:
            self._rollback(bad)
        else:
            self.stats.confirms += 1
            self._prev = None
            self._cooldown_until = (self.stats.scored
                                    + self.config.cooldown_scored)
            self.stats.state = STATE_IDLE
            self.stats.event("promotion confirmed: live MAPE stayed below "
                             "the trigger through the watch window")

    def _rollback(self, bad: List[Pair]) -> None:
        prev_oracle, prev_epoch = self._prev
        failed_epoch = self.service.epoch
        epoch = self.service.oracle_refreshed(prev_oracle, prev_epoch)
        self.stats.rollbacks += 1
        if self.store is not None:
            # demote the regressed promotion so recovery never resurrects
            # it (failures here are non-fatal, like persist failures)
            try:
                self.store.record_rollback(failed_epoch)
            except Exception as e:
                self.stats.persist_failures += 1
                self.stats.event(f"rollback demote failed ({e!r})")
        self.detector.reset(self._refit_pairs)
        for p in self._refit_pairs:
            self._drift_seen.pop(p, None)
        self._prev = None
        self._cooldown_until = (self.stats.scored
                                + self.config.cooldown_scored)
        self.stats.state = STATE_IDLE
        self.stats.event(
            f"rolled back: live MAPE regressed on "
            f"{', '.join(map(pair_label, bad))} post-promotion; re-swapped "
            f"to pre-promotion oracle as epoch {epoch} (failed epoch's "
            "cache purged)")

    # ------------------------------------------------------------------
    # background daemon
    # ------------------------------------------------------------------
    def start(self, interval: float = 0.1) -> "Calibrator":
        if self._thread is not None:
            raise RuntimeError("calibrator already started")
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(interval):
                try:
                    self.step()
                except Exception as e:   # the loop must survive any step
                    self.stats.event(f"step error: {e!r}")

        self._thread = threading.Thread(target=loop, name="profet-calibrate",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout)
        self._thread = None

    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, object]:
        """The ``/statsz`` calibration block."""
        s = self.stats.summary()
        s["buffered"] = self.buffer.total()
        s["evicted"] = self.buffer.evicted
        s["drifted_pairs"] = [pair_label(p)
                              for p in self.detector.drifted_pairs()]
        s["rolling_mape"] = {pair_label(p): round(v, 3)
                             for p, v in self.detector.rolling().items()}
        s["epoch"] = self.service.epoch
        return s
