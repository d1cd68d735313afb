"""The port's twin of ``tests/test_serve_latency.py``: the same cases on
``repro_torch``, every entry point given ``device="cpu"``.

Batched execution + serving layer: fused ``predict_many`` equality
against the per-request path on a shuffled mixed stream, batching telemetry,
the LatencyService wave/cache/error behavior, and ServiceStats."""
import numpy as np
import pytest

from repro_torch import api
from repro_torch.core import workloads
from repro_torch.core.predictor import ProfetConfig
from repro_torch.serve import LatencyService, ServiceStats, synthetic_requests

# deterministic float64 members: fused vs sequential must agree to ~exact
CFG = ProfetConfig(members=("linear", "forest"), n_trees=15, seed=0)


@pytest.fixture(scope="module")
def oracle():
    ds = workloads.generate(devices=("T4", "V100"),
                            models=("LeNet5", "AlexNet", "VGG11",
                                    "ResNet18"))
    return api.LatencyOracle.fit(ds, CFG, device="cpu")


@pytest.fixture(scope="module")
def stream(oracle):
    reqs = synthetic_requests(oracle, n=150, seed=3)
    rng = np.random.default_rng(7)
    return [reqs[i] for i in rng.permutation(len(reqs))]


# ---------------------------------------------------------------------------
# fused predict_many == per-request predict
# ---------------------------------------------------------------------------


def test_predict_many_matches_per_request_predict(oracle, stream):
    fused = oracle.predict_many(stream)
    seq = [oracle.predict(r) for r in stream]
    assert len(fused) == len(stream)
    np.testing.assert_allclose(fused.latencies(),
                               [r.latency_ms for r in seq], rtol=1e-9)
    assert [r.mode for r in fused] == [r.mode for r in seq]
    assert [r.target for r in fused] == [r.target for r in seq]
    assert [r.price_hr for r in fused] == [r.price_hr for r in seq]


def test_stream_covers_all_modes_and_pairs(oracle, stream):
    fused = oracle.predict_many(stream)
    assert set(fused.mode_counts) == {api.MODE_MEASURED, api.MODE_CROSS,
                                      api.MODE_TWO_PHASE}
    assert {(r.anchor, r.target) for r in fused
            if r.anchor != r.target} == set(oracle.pairs())


def test_batch_telemetry(oracle, stream):
    fused = oracle.predict_many(stream)
    # ONE stacked ModelBank dispatch for the whole wave, NOT one call per
    # request or per pair
    assert fused.banked and fused.fused_calls == 1
    assert 0 < fused.rows < sum(2 if r.mode == api.MODE_TWO_PHASE else 1
                                for r in fused if r.mode != api.MODE_MEASURED)
    assert sum(fused.mode_counts.values()) == len(stream)
    # sequence protocol
    assert fused[0] is fused.results[0]
    assert list(iter(fused))[-1] is fused.results[-1]


def test_predict_many_empty(oracle):
    fused = oracle.predict_many([])
    assert len(fused) == 0 and fused.fused_calls == 0 and fused.rows == 0


def test_plan_execute_staging_matches_predict_many(oracle, stream):
    plans = [oracle.plan(r) for r in stream[:20]]
    a = oracle.execute(plans)
    b = oracle.predict_many(stream[:20])
    np.testing.assert_array_equal(a.latencies(), b.latencies())


def test_advise_goes_through_fused_batch(oracle):
    ds = oracle.dataset
    w = api.Workload.from_case(ds.cases[0])
    rows = oracle.advise("T4", w, measured_ms=12.5)
    assert [r.target for r in rows] == ["T4"] + list(
        oracle.targets_from("T4"))
    assert rows[0].mode == api.MODE_MEASURED
    assert rows[0].latency_ms == 12.5
    want = oracle.predict(api.PredictRequest("T4", "V100", w))
    assert rows[1].latency_ms == pytest.approx(want.latency_ms, rel=1e-12)


# ---------------------------------------------------------------------------
# LatencyService: waves, cache, errors
# ---------------------------------------------------------------------------


def test_service_waves_and_results(oracle, stream):
    svc = LatencyService(oracle, max_wave=40)
    subs = [svc.submit(r) for r in stream]
    done = svc.run()
    assert len(done) == len(stream)
    assert svc.stats.waves == -(-len(stream) // 40)   # ceil
    assert svc.stats.requests == len(stream)
    direct = oracle.predict_many(stream)
    for sr, want in zip(subs, direct):
        assert sr.done and sr.error is None
        assert sr.result.latency_ms == pytest.approx(want.latency_ms,
                                                     rel=1e-9)


def test_service_cache_hits_return_identical_results(oracle, stream):
    svc = LatencyService(oracle, max_wave=64)
    first = [svc.submit(r) for r in stream]
    svc.run()
    fused_after_first = svc.stats.fused_calls
    hits_after_first = svc.stats.cache_hits
    second = [svc.submit(r) for r in stream]
    svc.run()
    # the replay is answered entirely from cache: no new fused calls
    assert svc.stats.fused_calls == fused_after_first
    assert svc.stats.cache_hits == hits_after_first + len(stream)
    for a, b in zip(first, second):
        assert b.result is a.result or \
            b.result.latency_ms == a.result.latency_ms


def test_service_cache_eviction(oracle, stream):
    svc = LatencyService(oracle, max_wave=16, cache_size=4)
    for r in stream[:32]:
        svc.submit(r)
    svc.run()
    assert len(svc._cache) <= 4


def test_service_isolates_per_request_errors(oracle):
    ds = oracle.dataset
    good = api.PredictRequest("T4", "V100",
                              api.Workload.from_case(ds.cases[0]))
    bad = api.PredictRequest("T4", "TPUv4",
                             api.Workload.from_case(ds.cases[0]))
    svc = LatencyService(oracle)
    sg, sb = svc.submit(good), svc.submit(bad)
    svc.run()
    assert sg.done and sg.error is None and sg.result is not None
    assert sb.done and sb.result is None
    assert isinstance(sb.error, api.UnknownDeviceError)
    assert svc.stats.errors == 1
    assert svc.stats.requests == 2


def test_service_stats_percentiles(oracle, stream):
    svc = LatencyService(oracle, max_wave=32)
    for r in stream:
        svc.submit(r)
    svc.run()
    s = svc.stats
    assert len(s.latencies_ms) == len(stream)
    assert np.isfinite(s.p50_ms) and np.isfinite(s.p99_ms)
    assert s.p50_ms <= s.p99_ms
    assert s.requests_per_s > 0
    summary = s.summary()
    assert summary["requests"] == len(stream)
    assert summary["waves"] == s.waves


def test_empty_service_stats():
    s = ServiceStats()
    assert np.isnan(s.p50_ms) and np.isnan(s.p99_ms)
    assert s.requests_per_s == 0.0


def test_public_exports():
    from repro_torch.serve import LatencyService as LS, ServiceRequest
    assert LS is LatencyService
    assert {"PredictPlan", "BatchPredictResult", "ServiceStats",
            "InvalidWorkloadError"} <= set(api.__all__)


# ---------------------------------------------------------------------------
# oracle_refreshed failure paths (the swap guarantees live calibration
# promotion/rollback rest on)
# ---------------------------------------------------------------------------


def test_refresh_warmup_failure_leaves_incumbent_intact(oracle, stream):
    svc = LatencyService(oracle, max_wave=32)
    for r in stream[:16]:
        svc.submit(r)
    svc.run()
    epoch0 = svc.epoch
    cache0 = dict(svc._cache)
    assert cache0, "cache should be warm before the failed swap"

    ds = workloads.generate(devices=("T4", "V100"),
                            models=("LeNet5", "AlexNet"))
    fresh = api.LatencyOracle.fit(ds, ProfetConfig(
        members=("linear", "forest"), n_trees=15, seed=9), device="cpu")
    fresh.warmup = lambda max_rows=64: (_ for _ in ()).throw(
        RuntimeError("warm-up exploded"))
    with pytest.raises(RuntimeError, match="warm-up exploded"):
        svc.oracle_refreshed(fresh, "next-epoch")
    # warm-up runs BEFORE the swap lock: nothing is half-swapped
    assert svc.oracle is oracle
    assert svc.epoch == epoch0
    assert svc.stats.epoch_swaps == 0 and svc.stats.invalidated == 0
    assert dict(svc._cache) == cache0
    # and the incumbent keeps serving (replay hits the intact cache)
    hits0 = svc.stats.cache_hits
    for r in stream[:16]:
        svc.submit(r)
    svc.run()
    assert svc.stats.cache_hits == hits0 + 16
    assert all(sr.error is None for sr in svc.finished)


def test_rollback_reswap_purges_every_failed_epoch_key(oracle, stream):
    """The calibration rollback pattern: swap to a candidate, serve under
    it, swap BACK — every cache key of the abandoned epoch must purge and
    the restored oracle must serve under a fresh uniquified epoch."""
    ds = workloads.generate(devices=("T4", "V100"),
                            models=("LeNet5", "AlexNet", "VGG11",
                                    "ResNet18"))
    candidate = api.LatencyOracle.fit(ds, ProfetConfig(
        members=("linear", "forest"), n_trees=15, seed=9), device="cpu")
    svc = LatencyService(oracle, max_wave=32, warmup=False)
    base_epoch = svc.epoch
    for r in stream[:24]:
        svc.submit(r)
    svc.run()
    promoted = svc.oracle_refreshed(candidate, "candidate-epoch")
    for r in stream[:24]:
        svc.submit(r)
    svc.run()
    assert any(k[0] == promoted for k in svc._cache)
    invalidated0 = svc.stats.invalidated

    restored = svc.oracle_refreshed(oracle, base_epoch)   # the rollback
    assert svc.oracle is oracle
    # the label was already used at construction -> uniquified, never reused
    assert restored != base_epoch and restored.startswith(base_epoch)
    # every key of the failed epoch (and any older epoch) is gone
    assert all(k[0] == restored for k in svc._cache) or not svc._cache
    assert not any(k[0] == promoted for k in svc._cache)
    assert svc.stats.invalidated > invalidated0
    assert svc.stats.epoch_swaps == 2
    assert svc.stats.epoch_cache_hits == 0   # per-epoch counter reset
    # post-rollback traffic serves + caches under the restored epoch only
    for r in stream[:8]:
        svc.submit(r)
    done = svc.run()
    assert all(sr.result.epoch == restored for sr in done[-8:]
               if sr.result is not None)


def test_wave_observer_sees_completed_waves(oracle, stream):
    svc = LatencyService(oracle, max_wave=16, warmup=False)
    seen = []
    svc.set_observer(lambda wave: seen.append(list(wave)))
    for r in stream[:32]:
        svc.submit(r)
    svc.run()
    assert len(seen) == 2
    assert sum(len(w) for w in seen) == 32
    assert all(sr.done and sr.error is None for w in seen for sr in w)
    # a raising observer is swallowed, never breaks serving
    svc.set_observer(lambda wave: 1 / 0)
    for r in stream[:8]:
        svc.submit(r)
    svc.run()
    assert svc.stats.errors == 0
