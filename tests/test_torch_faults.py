"""The port's twin of ``tests/test_faults.py``: the same cases on
``repro_torch``, every entry point given ``device="cpu"``.

Chaos suite: scripted fault plans (``repro.serve.faults``) driven
through every resilience layer of the serving plane.

Invariants under injected chaos:

  - every submitted request terminates with result XOR typed error —
    never a hang, never an untyped escape out of ``run()``;
  - expired deadlines are shed as typed 504s before any model time;
  - the client retry loop never re-sends a non-idempotent ``/measure``
    whose response was lost after a complete send (the double-ingest bug);
  - a crashed wave pump is supervised: restarted with accounting,
    ``/healthz`` honest ("degraded") until a clean drain hop;
  - a failed warm-up degrades to the per-group path instead of killing
    the service, and a healthy swap recovers;
  - a repeatedly failing (anchor, target) pair is quarantined by the
    circuit breaker and recovers through a half-open probe;
  - the calibrator survives injected refit/canary crashes with the
    incumbent serving throughout, and promoted calibrations persist
    through the artifact store across a simulated process restart with
    bit-identical predictions.
"""
import threading
import time

import numpy as np
import pytest

from repro_torch import api
from repro_torch.api.artifacts import CalibrationStore, save
from repro_torch.api.types import (ApiError, CircuitOpenError,
                             DeadlineExceededError, ExecutionError)
from repro_torch.calibrate import CalibrationConfig, Calibrator
from repro_torch.core import workloads
from repro_torch.core.predictor import ProfetConfig
from repro_torch.serve import (BackgroundServer, CircuitBreaker, Client,
                         FaultInjector, FaultPlan, FaultRule, InjectedFault,
                         LatencyService, RetryPolicy, TransportError,
                         synthetic_requests)
from repro_torch.serve import faults as faults_mod

CFG1 = ProfetConfig(members=("linear", "forest"), n_trees=15, seed=0)
CFG2 = ProfetConfig(members=("linear", "forest"), n_trees=15, seed=7)
PAIR = ("T4", "V100")

# small calibration windows so the detect -> refit -> canary -> promote
# arc completes in a handful of waves (mirrors tests/test_calibrate.py)
CAL = CalibrationConfig(drift_window=32, min_obs=6, trigger_mape=10.0,
                        min_refit_obs=6, drift_confirm_obs=12,
                        cooldown_scored=8, canary_min_obs=4,
                        confirm_obs=10)


@pytest.fixture(scope="module")
def dataset():
    return workloads.generate(devices=("T4", "V100"),
                              models=("LeNet5", "AlexNet", "ResNet18"))


@pytest.fixture(scope="module")
def oracle(dataset):
    return api.LatencyOracle.fit(dataset, CFG1, device="cpu")


@pytest.fixture(scope="module")
def oracle2(dataset):
    return api.LatencyOracle.fit(dataset, CFG2, device="cpu")


def _cross_reqs(ds, cases):
    return [api.PredictRequest("T4", "V100", api.Workload.from_case(c))
            for c in cases]


def _serve(svc, reqs):
    """Submit, drain, return the (ordered) ServiceRequests."""
    srs = [svc.submit(r) for r in reqs]
    svc.run()
    svc.take_finished()
    return srs


def _wait_for(cond, timeout=15.0, every=0.01, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(every)
    raise AssertionError(f"timed out waiting for {what}")


# ---------------------------------------------------------------------------
# the injector itself
# ---------------------------------------------------------------------------


def test_fault_rule_validation():
    with pytest.raises(ValueError):
        FaultRule(site="x", kind="explode")
    with pytest.raises(ValueError):
        FaultRule(site="x", rate=1.5)
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)


def test_injector_is_deterministic_and_site_independent():
    plan = FaultPlan(rules=(FaultRule(site="s.a", rate=0.4),
                            FaultRule(site="s.b", kind=faults_mod.DROP,
                                      rate=0.5, limit=3)), seed=11)

    def drive_interleaved(inj):
        for _ in range(50):
            try:
                inj.fire("s.a")
            except InjectedFault:
                pass
            inj.drop("s.b")
        return inj.fired

    a = drive_interleaved(FaultInjector(plan))
    b = drive_interleaved(FaultInjector(plan))
    assert a == b and len(a) > 0
    # drop firings respect the limit
    assert sum(1 for s, k, _ in a if k == faults_mod.DROP) == 3
    # per-site decisions depend only on the per-site hit count, not on how
    # calls interleave across sites
    c = FaultInjector(plan)
    for _ in range(50):
        c.drop("s.b")
    for _ in range(50):
        try:
            c.fire("s.a")
        except InjectedFault:
            pass
    assert ([f for f in c.fired if f[0] == "s.a"]
            == [f for f in a if f[0] == "s.a"])
    assert c.hits("s.a") == 50 and c.hits("s.b") == 50


def test_injector_at_schedule_delay_and_clear():
    inj = FaultInjector(FaultPlan(rules=(
        FaultRule(site="s", at=(1,), message="boom"),
        FaultRule(site="s", kind=faults_mod.DELAY, at=(0,), delay_s=0.03))))
    t0 = time.perf_counter()
    inj.fire("s")                              # hit 0: delay only
    assert time.perf_counter() - t0 >= 0.02
    with pytest.raises(InjectedFault, match="boom") as ei:
        inj.fire("s")                          # hit 1: error
    assert ei.value.site == "s" and ei.value.hit == 1
    inj.fire("s")                              # hit 2: quiet
    history = inj.fired
    inj.clear()
    inj.fire("s")                              # rules gone, history kept
    assert inj.fired == history and inj.hits("s") == 4
    # module helpers no-op without an injector
    faults_mod.fire(None, "s")
    assert not faults_mod.should_drop(None, "s")


# ---------------------------------------------------------------------------
# service-level chaos
# ---------------------------------------------------------------------------


def test_every_request_terminates_under_chaos(oracle):
    inj = FaultInjector(FaultPlan(rules=(
        FaultRule(site=faults_mod.SITE_PLAN, rate=0.15),
        FaultRule(site=faults_mod.SITE_EXECUTE, rate=0.15),
        FaultRule(site=faults_mod.SITE_EXECUTE, kind=faults_mod.DELAY,
                  rate=0.25, delay_s=0.001)), seed=7))
    svc = LatencyService(oracle, max_wave=16, faults=inj)
    reqs = synthetic_requests(oracle, n=96, seed=5)
    srs = _serve(svc, reqs)
    assert inj.fired                           # the chaos actually ran
    for sr in srs:
        assert sr.done
        assert (sr.result is None) != (sr.error is None)
        if sr.error is not None:
            assert isinstance(sr.error, ApiError)
    n_err = sum(1 for sr in srs if sr.error is not None)
    assert n_err >= 1
    assert svc.stats.requests == 96
    assert svc.stats.errors == n_err
    assert len(svc.stats.latencies_ms) == 96
    # chaos off: the same service serves cleanly again
    inj.clear()
    svc.breaker.reset()
    clean = _serve(svc, _cross_reqs(oracle.dataset, oracle.dataset.cases[:4]))
    assert all(sr.error is None for sr in clean)


def test_expired_deadline_is_shed_with_typed_error(oracle):
    svc = LatencyService(oracle, warmup=False)
    ds = oracle.dataset
    import dataclasses as _dc
    reqs = [_dc.replace(r, deadline_ms=0.5)
            for r in _cross_reqs(ds, ds.cases[:3])]
    srs = [svc.submit(r) for r in reqs]
    time.sleep(0.01)                           # burn the 0.5 ms budget
    svc.run()
    for sr in srs:
        assert isinstance(sr.error, DeadlineExceededError)
    assert svc.stats.deadline_expired == 3
    # a generous budget sails through
    [ok] = _serve(svc, [_dc.replace(reqs[0], deadline_ms=1e6)])
    assert ok.error is None and ok.result is not None


def test_warmup_failure_degrades_then_healthy_swap_recovers(oracle, oracle2):
    inj = FaultInjector(FaultPlan(rules=(
        FaultRule(site=faults_mod.SITE_WARMUP, at=(0,)),)))
    svc = LatencyService(oracle, max_wave=16, faults=inj)
    assert svc.stats.degraded and not svc._banked
    assert "warm-up failed" in svc.stats.degraded_reason
    assert svc.stats.summary()["degraded"] is True
    # degraded (per-group) answers are still the oracle's answers
    ds = oracle.dataset
    reqs = _cross_reqs(ds, ds.cases[:6])
    srs = _serve(svc, reqs)
    assert all(sr.error is None for sr in srs)
    ref = oracle.predict_many(reqs).latencies()
    np.testing.assert_allclose([sr.result.latency_ms for sr in srs], ref,
                               rtol=1e-12)
    # a healthy swap (warm-up passes this time) clears degraded mode
    svc.oracle_refreshed(oracle2, fingerprint="healthy")
    assert not svc.stats.degraded and svc._banked
    assert svc.stats.degraded_reason is None
    srs = _serve(svc, reqs)
    assert all(sr.error is None for sr in srs)
    np.testing.assert_allclose([sr.result.latency_ms for sr in srs],
                               oracle2.predict_many(reqs).latencies(),
                               rtol=1e-12)


def test_circuit_breaker_quarantines_and_half_open_probe_recovers(oracle):
    clk = [0.0]
    breaker = CircuitBreaker(threshold=2, cooldown_s=10.0,
                             clock=lambda: clk[0])
    inj = FaultInjector(FaultPlan(rules=(
        FaultRule(site=faults_mod.SITE_EXECUTE, at=(0, 1)),)))
    svc = LatencyService(oracle, max_wave=8, cache_size=0, warmup=False,
                         faults=inj, breaker=breaker)
    ds = oracle.dataset
    req = _cross_reqs(ds, ds.cases[:1])[0]

    [sr] = _serve(svc, [req])                  # failure 1/2
    assert isinstance(sr.error, ExecutionError)
    assert breaker.state(PAIR) == "closed"
    [sr] = _serve(svc, [req])                  # failure 2/2 -> trips open
    assert isinstance(sr.error, ExecutionError)
    assert breaker.state(PAIR) == "open"
    assert svc.stats.circuit_trips == 1 and PAIR in breaker.open_keys()

    # quarantined: fast-fail typed errors, the model is never invoked
    srs = _serve(svc, [req, req, req])
    assert all(isinstance(sr.error, CircuitOpenError) for sr in srs)
    assert svc.stats.circuit_rejections == 3
    assert inj.hits(faults_mod.SITE_EXECUTE) == 2

    # cooldown elapses: ONE half-open probe is admitted per wave, the
    # rest keep fast-failing; the probe's success closes the circuit
    clk[0] += 11.0
    probe, rejected = _serve(svc, [req, req])
    assert probe.error is None and probe.result is not None
    assert isinstance(rejected.error, CircuitOpenError)
    assert breaker.state(PAIR) == "closed" and not breaker.open_keys()
    [sr] = _serve(svc, [req])
    assert sr.error is None


def test_used_epoch_memory_is_bounded_and_still_uniquifies(oracle):
    from repro_torch.serve import latency_service as ls
    svc = LatencyService(oracle, warmup=False)
    for i in range(ls._EPOCH_MEMORY + 200):
        svc.oracle_refreshed(fingerprint=f"e{i}")
        assert len(svc._used_epochs) <= ls._EPOCH_MEMORY
    # A/B/A label reuse within the memory window still uniquifies
    assert svc.oracle_refreshed(fingerprint="A") == "A"
    assert svc.oracle_refreshed(fingerprint="B") == "B"
    again = svc.oracle_refreshed(fingerprint="A")
    assert again != "A" and again.startswith("A+")


def test_concurrent_pumps_keep_stats_and_results_consistent(oracle):
    reqs = synthetic_requests(oracle, n=120, seed=9)
    svc = LatencyService(oracle, max_wave=8, cache_size=0, warmup=False)
    srs = [svc.submit(r) for r in reqs]
    threads = [threading.Thread(target=svc.run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert all(sr.done for sr in srs)
    assert all(sr.error is None for sr in srs)
    assert svc.stats.requests == 120 and svc.stats.errors == 0
    assert len(svc.stats.latencies_ms) == 120
    # element-wise identical to a single-threaded drain of the same load
    ref_svc = LatencyService(oracle, max_wave=8, cache_size=0, warmup=False)
    ref = _serve(ref_svc, reqs)
    np.testing.assert_allclose([sr.result.latency_ms for sr in srs],
                               [sr.result.latency_ms for sr in ref],
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# transport-level chaos
# ---------------------------------------------------------------------------


def test_deadline_header_maps_to_504(oracle):
    svc = LatencyService(oracle, max_wave=16)
    bg = BackgroundServer(svc).start()
    try:
        with Client(bg.host, bg.port) as c:
            req = api.PredictRequest("T4", "V100", api.Workload(
                model="LeNet5", batch=4, pix=32))
            # 1 us budget: expired long before the pump's batch window ends
            with pytest.raises(TransportError) as ei:
                c.predict(req, deadline_ms=0.001)
            assert ei.value.status == 504
            assert ei.value.error_type == "DeadlineExceededError"
            assert svc.stats.deadline_expired >= 1
            # body-level deadline behaves the same over the wire
            from repro_torch.serve.transport import request_to_dict
            d = request_to_dict(req)
            d["deadline_ms"] = 0.001
            status, out = c.request("POST", "/predict", d)
            assert status == 504
            assert out["error"]["type"] == "DeadlineExceededError"
            # malformed header: typed 400, not a dropped connection
            status, out = c.request("POST", "/predict", request_to_dict(req),
                                    headers={"X-Deadline-Ms": "soon"})
            assert status == 400
            assert out["error"]["type"] == "MalformedRequestError"
            # a generous budget predicts normally
            res = c.predict(req, deadline_ms=60_000)
            assert res["latency_ms"] > 0
    finally:
        bg.stop()


def test_idempotent_predict_retries_through_dropped_response(oracle):
    inj = FaultInjector(FaultPlan(rules=(
        FaultRule(site=faults_mod.SITE_RESPONSE, kind=faults_mod.DROP,
                  at=(0,)),)))
    svc = LatencyService(oracle, max_wave=16)
    bg = BackgroundServer(svc, faults=inj).start()
    try:
        retry = RetryPolicy(max_attempts=3, base_s=0.001, seed=0)
        with Client(bg.host, bg.port, retry=retry) as c:
            req = api.PredictRequest("T4", "V100", api.Workload(
                model="AlexNet", batch=4, pix=32))
            res = c.predict(req)               # first response truncated
        assert (faults_mod.SITE_RESPONSE, faults_mod.DROP, 0) in inj.fired
        ref = oracle.predict_many([req]).latencies()[0]
        assert res["latency_ms"] == pytest.approx(ref, rel=1e-12)
    finally:
        bg.stop()


def test_measure_is_never_retried_after_a_complete_send(oracle):
    """The double-ingest regression: a /measure whose *response* is lost
    after the request fully hit the wire must surface the failure, not
    blind-retry into ingesting every row twice."""
    inj = FaultInjector(FaultPlan(rules=(
        FaultRule(site=faults_mod.SITE_RESPONSE, kind=faults_mod.DROP,
                  at=(0,)),)))
    svc = LatencyService(oracle, max_wave=16)
    cal = Calibrator(svc, CAL)
    bg = BackgroundServer(svc, calibrator=cal, faults=inj).start()
    rows = [{"anchor": "T4", "target": "V100", "model": "LeNet5",
             "batch": 4, "pix": 32, "latency_ms": 10.0 + i}
            for i in range(5)]
    try:
        retry = RetryPolicy(max_attempts=3, base_s=0.001, seed=0)
        with Client(bg.host, bg.port, retry=retry) as c:
            with pytest.raises((ConnectionError, OSError)):
                c.measure(rows)
            # the server DID ingest the batch — exactly once
            assert cal.stats.observations == 5
            # a fresh delivery (no drop scheduled) goes through normally
            out = c.measure(rows)
            assert out["accepted"] == 5
            assert cal.stats.observations == 10
    finally:
        bg.stop()


def test_blind_retry_would_double_ingest(oracle):
    """Sanity check of the scenario above: the same lost response under an
    idempotent-marked request (the old blind-retry behavior) re-executes
    the body — proving the ``sent`` gate is what prevents double-ingest."""
    inj = FaultInjector(FaultPlan(rules=(
        FaultRule(site=faults_mod.SITE_RESPONSE, kind=faults_mod.DROP,
                  at=(0,)),)))
    svc = LatencyService(oracle, max_wave=16)
    cal = Calibrator(svc, CAL)
    bg = BackgroundServer(svc, calibrator=cal, faults=inj).start()
    try:
        from repro_torch.serve.transport import measure_columnar_from_rows
        rows = [{"anchor": "T4", "target": "V100", "model": "LeNet5",
                 "batch": 4, "pix": 32, "latency_ms": 11.0}] * 4
        retry = RetryPolicy(max_attempts=3, base_s=0.001, seed=0)
        with Client(bg.host, bg.port, retry=retry) as c:
            status, out = c.request("POST", "/measure",
                                    measure_columnar_from_rows(rows),
                                    idempotent=True)
        assert status == 200 and out["accepted"] == 4
        assert cal.stats.observations == 8     # ingested TWICE
    finally:
        bg.stop()


def test_pump_crash_is_supervised_and_healthz_is_honest(oracle):
    inj = FaultInjector(FaultPlan(rules=(
        FaultRule(site=faults_mod.SITE_PUMP, rate=1.0),)))
    svc = LatencyService(oracle, max_wave=16)
    bg = BackgroundServer(svc, faults=inj).start()
    try:
        req = api.PredictRequest("T4", "V100", api.Workload(
            model="ResNet18", batch=4, pix=32))
        box = {}

        def call():
            with Client(bg.host, bg.port) as c:
                box["res"] = c.predict(req)

        t = threading.Thread(target=call)
        t.start()
        with Client(bg.host, bg.port) as probe:
            _wait_for(lambda: probe.healthz()["status"] == "degraded",
                      what="degraded /healthz while the pump crash-loops")
            assert svc.stats.pump_crashes >= 1
            # stop injecting: the supervised restart serves the queued
            # request and a clean drain hop restores "ok"
            inj.clear()
            t.join(20)
            assert not t.is_alive() and box["res"]["latency_ms"] > 0
            _wait_for(lambda: probe.healthz()["status"] == "ok",
                      what="healthy /healthz after a clean drain hop")
            h = probe.healthz()
            assert h["pump_crashes"] >= 1 and h["reasons"] == []
        assert svc.stats.pump_restarts >= 1
    finally:
        bg.stop()


# ---------------------------------------------------------------------------
# calibration chaos + crash-safe persistence
# ---------------------------------------------------------------------------


def _drive_round(svc, cal, reqs, truth_fn):
    for r in reqs:
        svc.submit(r)
    svc.run()
    for sr in svc.take_finished():
        if sr.error is not None:
            continue
        cal.ingest(sr.request.anchor, sr.request.target,
                   sr.request.workload, truth_fn(sr.request),
                   predicted_ms=sr.result.latency_ms,
                   epoch=sr.result.epoch)
    return cal.step()


def _drift_truth(ds, factor, rng, noise=0.01):
    def fn(req):
        truth = ds.latency(req.target, req.workload.case) * factor
        return truth * (1 + rng.normal(0, noise))
    return fn


def test_incumbent_survives_injected_refit_and_canary_crashes(oracle):
    ds = oracle.dataset
    inj = FaultInjector(FaultPlan(rules=(
        FaultRule(site=faults_mod.SITE_REFIT, at=(0,)),
        FaultRule(site=faults_mod.SITE_CANARY, at=(0,)))))
    svc = LatencyService(oracle, max_wave=32)
    cal = Calibrator(svc, CAL, faults=inj)
    base_epoch = svc.epoch
    rng = np.random.default_rng(6)
    drifted = _drift_truth(ds, 1.6, rng)
    for rnd in range(40):
        reqs = _cross_reqs(ds, [ds.cases[(rnd * 7 + i) % len(ds.cases)]
                                for i in range(16)])
        _drive_round(svc, cal, reqs, drifted)
        # through both injected crashes the incumbent must keep serving
        if not cal.stats.promotions:
            assert svc.epoch == base_epoch
        if cal.stats.confirms:
            break
    s = cal.stats
    # arc: refit #1 crashes -> cooldown -> refit #2 builds -> canary #1
    # crashes (candidate discarded) -> cooldown -> refit #3 -> canary #2
    # passes -> promote -> confirm
    assert s.refit_errors == 1 and s.canary_errors == 1
    assert s.refits == 2 and s.canary_pass == 1 and s.canary_fail == 1
    assert s.promotions == 1 and s.rollbacks == 0 and s.confirms == 1
    assert any("refit crashed" in e for e in s.events)
    assert any("canary crashed" in e for e in s.events)
    assert svc.epoch != base_epoch and "+cal" in svc.epoch
    assert svc.stats.errors == 0               # serving never failed


def test_promoted_calibration_survives_restart_bit_identical(
        oracle, tmp_path):
    ds = oracle.dataset
    store = CalibrationStore(tmp_path)
    svc = LatencyService(oracle, max_wave=32)
    cal = Calibrator(svc, CAL, store=store)
    rng = np.random.default_rng(8)
    drifted = _drift_truth(ds, 1.6, rng)
    for rnd in range(14):
        reqs = _cross_reqs(ds, [ds.cases[(rnd * 7 + i) % len(ds.cases)]
                                for i in range(16)])
        _drive_round(svc, cal, reqs, drifted)
        if cal.stats.promotions:
            break
    assert cal.stats.promotions == 1 and cal.stats.persisted == 1
    promoted_epoch = svc.epoch
    assert store.latest()["epoch"] == promoted_epoch

    # "kill -9" + restart: a brand-new store over the same directory
    # recovers the promoted candidate under its served epoch
    recovered = CalibrationStore(tmp_path).recover(expect_config=CFG1, device="cpu")
    assert recovered is not None
    rec_oracle, rec_epoch = recovered
    assert rec_epoch == promoted_epoch
    svc2 = LatencyService(rec_oracle, max_wave=32, epoch=rec_epoch)
    probes = _cross_reqs(ds, ds.cases[:8])
    before = _serve(svc, probes)
    after = _serve(svc2, probes)
    np.testing.assert_array_equal(
        [sr.result.latency_ms for sr in before],
        [sr.result.latency_ms for sr in after])
    assert all(sr.result.epoch == promoted_epoch for sr in after)

    # a rollback demotes the entry; recovery then has nothing to serve
    assert store.record_rollback(promoted_epoch)
    assert CalibrationStore(tmp_path).recover(expect_config=CFG1, device="cpu") is None


def test_calibration_store_recovery_is_defensive(oracle, oracle2, tmp_path):
    store = CalibrationStore(tmp_path / "s")
    assert store.recover(device="cpu") is None and store.latest() is None
    store.record_promotion(oracle, "ep1")
    store.record_promotion(oracle2, "ep2")
    rec_oracle, epoch = store.recover(device="cpu")
    assert epoch == "ep2"
    # newest-first: rolling ep2 back falls back to ep1
    assert store.record_rollback("ep2")
    assert not store.record_rollback("ep2")    # already demoted
    rec_oracle, epoch = store.recover(device="cpu")
    assert epoch == "ep1"
    # an entry whose artifact vanished is skipped, not fatal
    (store.root / store.latest()["file"]).unlink()
    assert store.recover(device="cpu") is None
    # a config mismatch on recovery is a skip, not a crash
    store2 = CalibrationStore(tmp_path / "s2")
    store2.record_promotion(oracle, "ep3")
    other = ProfetConfig(members=("linear",), seed=0)
    assert store2.recover(expect_config=other, device="cpu") is None
    assert store2.recover(expect_config=CFG1, device="cpu") is not None
    # a corrupted index never takes recovery down
    (store2.root / store2.INDEX).write_text("{not json")
    assert store2.entries() == [] and store2.recover(device="cpu") is None
    # config.persist_dir wires a store through the Calibrator constructor
    import dataclasses as _dc
    svc = LatencyService(oracle, warmup=False)
    cal = Calibrator(svc, _dc.replace(CAL, persist_dir=str(tmp_path / "s3")))
    assert isinstance(cal.store, CalibrationStore)
