"""The port's live calibration (``repro_torch.calibrate``) against the
reference (``repro.calibrate``) on the same oracle and observations.

The reference oracle is fitted at ``tests/test_calibrate.py``'s config
(linear + forest, 15 trees, seed 0, T4/V100 x LeNet5/AlexNet/ResNet18) and
carried into the port on the CPU (``_torch_state.carry_oracle``).

Tolerances and why:
  - buffer, drift detector, ``calibrated_latencies``, ``build_candidate``
    and ``heldout_scores`` run the same numpy code over float64 members
    (linear model and forest, both grown on the host): bitwise equal;
  - the synchronous ``Calibrator.step`` loop, fed the same waves and
    observations with an injected clock: the same state sequence and
    counters, exactly;
  - with the DNN member the candidate's DNN is trained by each package
    from its own seeded init (``jax.random`` cannot be reproduced in
    torch), so the canary verdict must match and the port's candidate
    may be at most ``MAPE_PARITY_PTS`` points worse on the drifted pair
    (the one-sided band of ``tests/test_torch_fit_mape.py``).

The first group of tests are the twins of the reference's 20 tests in
``tests/test_calibrate.py``, run on the port.
"""
import functools
import types

import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro import calibrate as ref_cal
from repro.core.ensemble import MedianEnsemble as RefEnsemble
from repro.core.predictor import ProfetConfig as RefConfig
from repro.serve import LatencyService as RefService
from repro_torch import api
from repro_torch import calibrate as cal_mod
from repro_torch.calibrate import (STATE_CONFIRM, STATE_IDLE, STATE_SHADOW,
                                   CalibrationConfig, Calibrator,
                                   DriftDetector, MeasurementBuffer,
                                   Observation, build_candidate,
                                   heldout_scores, verdict)
from repro_torch.core.ensemble import MedianEnsemble, mape
from repro_torch.serve import LatencyService

from _torch_state import carry_oracle, small_dataset

PAIR = ("T4", "V100")
# tests/test_torch_fit_mape.py: the regression budget, in percentage points
MAPE_PARITY_PTS = 3.0

# small windows so the whole loop runs in a handful of waves (the
# reference's tests/test_calibrate.py CAL)
CAL_KW = dict(drift_window=32, min_obs=6, trigger_mape=10.0,
              min_refit_obs=6, drift_confirm_obs=12, cooldown_scored=8,
              canary_min_obs=4, confirm_obs=10)
CAL = CalibrationConfig(**CAL_KW)

# each package's names, so one scenario function runs on either
PORT = types.SimpleNamespace(
    api=api, cal=cal_mod, LatencyService=LatencyService,
    MedianEnsemble=functools.partial(MedianEnsemble, device="cpu"))
REF = types.SimpleNamespace(
    api=ref_api, cal=ref_cal, LatencyService=RefService,
    MedianEnsemble=RefEnsemble)

COUNTERS = ("observations", "dropped", "evicted", "scored", "unscorable",
            "drift_events", "refits", "scheduled_refits", "canary_pass",
            "canary_fail", "promotions", "rollbacks", "confirms",
            "shadow_waves", "shadow_requests", "shadow_errors",
            "refit_errors", "canary_errors", "persisted",
            "persist_failures")


@pytest.fixture(scope="module")
def ref_oracle():
    return ref_api.LatencyOracle.fit(
        small_dataset(),
        RefConfig(members=("linear", "forest"), n_trees=15, seed=0))


@pytest.fixture(scope="module")
def oracle(ref_oracle):
    return carry_oracle(ref_oracle)


def _obs(pair=PAIR, case=("LeNet5", 4, 32), latency=10.0, pred=None):
    return Observation(anchor=pair[0], target=pair[1], case=case,
                       latency_ms=latency, predicted_ms=pred)


# ---------------------------------------------------------------------------
# twins of tests/test_calibrate.py: ingest buffer
# ---------------------------------------------------------------------------


def test_buffer_ring_and_drop_accounting():
    buf = MeasurementBuffer(per_pair=4, max_pairs=2)
    for i in range(6):
        assert buf.add(_obs(latency=float(i + 1)))
    assert buf.count(PAIR) == 4 and buf.evicted == 2
    # freshest survive, oldest fell off the back
    assert [o.latency_ms for o in buf.observations(PAIR)] == [3, 4, 5, 6]
    assert [o.latency_ms for o in buf.observations(PAIR, last=2)] == [5, 6]
    # non-finite / non-positive latencies never enter
    assert not buf.add(_obs(latency=float("nan")))
    assert not buf.add(_obs(latency=-1.0))
    # pair table is bounded
    assert buf.add(_obs(pair=("V100", "T4")))
    assert not buf.add(_obs(pair=("A100", "T4")))
    assert buf.rejected == 3
    assert buf.total() == 5


def test_buffer_rejects_unroutable_pairs():
    buf = MeasurementBuffer(allowed_pairs={PAIR})
    assert buf.add(_obs())
    assert not buf.add(_obs(pair=("T4", "TPUv9")))
    # target == anchor (measured-mode ground truth) is always ingestible
    assert buf.add(_obs(pair=("K80", "K80")))


# ---------------------------------------------------------------------------
# twins: drift detection
# ---------------------------------------------------------------------------


def test_drift_trigger_and_hysteresis():
    det = DriftDetector(window=16, min_obs=4, trigger_mape=10.0,
                        clear_ratio=0.5)
    # 3 bad samples: below min_obs, cannot trigger yet
    assert [det.update(PAIR, 100.0, 120.0) for _ in range(3)] == [None] * 3
    assert det.update(PAIR, 100.0, 120.0) is True     # the transition
    assert det.is_drifted(PAIR) and det.drifted_pairs() == [PAIR]
    # perfect predictions pull the rolling MAPE down, but not below the
    # clear threshold (5.0) yet -> still drifted, no transition
    assert det.update(PAIR, 100.0, 100.0) is None
    assert det.is_drifted(PAIR)
    while det.is_drifted(PAIR):
        out = det.update(PAIR, 100.0, 100.0)
    assert out is False and det.mape(PAIR) < 5.0
    det.update(PAIR, 100.0, 200.0)
    det.reset([PAIR])
    assert det.samples(PAIR) == 0 and not det.is_drifted(PAIR)


# ---------------------------------------------------------------------------
# twins: refit + candidate cloning
# ---------------------------------------------------------------------------


def _fill_drifted(buf, ds, pair, cases, factor, n_per_case=2, noise=0.0,
                  seed=0, obs_cls=Observation):
    rng = np.random.default_rng(seed)
    for case in cases:
        for _ in range(n_per_case):
            truth = ds.latency(pair[1], case) * factor
            buf.add(obs_cls(pair[0], pair[1], case,
                            truth * (1 + rng.normal(0, noise))))


def test_build_candidate_learns_live_truth(oracle):
    ds = oracle.dataset
    buf = MeasurementBuffer()
    factor = 1.7
    _fill_drifted(buf, ds, PAIR, ds.cases[:12], factor, noise=0.01)
    cand, rep = build_candidate(oracle, buf, [PAIR], min_refit_obs=6)
    assert cand is not None and rep.pairs == (PAIR,)
    assert rep.scale[PAIR] == pytest.approx(factor, rel=0.05)
    assert rep.total_obs == 24
    # candidate tracks the drifted truth; incumbent does not
    truth = np.array([ds.latency("V100", c) * factor for c in ds.cases])
    reqs = [api.PredictRequest("T4", "V100", api.Workload.from_case(c))
            for c in ds.cases]
    assert mape(truth, cand.predict_many(reqs).latencies()) < 5.0
    assert mape(truth, oracle.predict_many(reqs).latencies()) > 20.0
    # the untouched pair still answers identically to the incumbent
    other = [api.PredictRequest("V100", "T4", api.Workload.from_case(c))
             for c in ds.cases[:8]]
    np.testing.assert_allclose(cand.predict_many(other).latencies(),
                               oracle.predict_many(other).latencies(),
                               rtol=1e-12)


def test_build_candidate_requires_enough_observations(oracle):
    buf = MeasurementBuffer()
    _fill_drifted(buf, oracle.dataset, PAIR, oracle.dataset.cases[:2], 1.5,
                  n_per_case=1)
    cand, rep = build_candidate(oracle, buf, [PAIR], min_refit_obs=6)
    assert cand is None and rep.pairs == () and rep.skipped == (PAIR,)


def test_build_candidate_skips_untrained_and_measured_pairs(oracle):
    ds = oracle.dataset
    buf = MeasurementBuffer()
    _fill_drifted(buf, ds, ("T4", "T4"), ds.cases[:8], 1.5)
    _fill_drifted(buf, ds, PAIR, ds.cases[:8], 1.5)
    cand, rep = build_candidate(oracle, buf, [("T4", "T4"), PAIR],
                                min_refit_obs=6)
    assert rep.pairs == (PAIR,) and ("T4", "T4") in rep.skipped
    assert cand is not None


def test_clone_with_pairs_validates(oracle):
    with pytest.raises(api.UnknownDeviceError):
        oracle.clone_with_pairs({("T4", "TPUv9"): object()})


def test_clone_with_pairs_is_isolated(oracle):
    ds = oracle.dataset
    X = oracle.feature_matrix("T4", ds.cases)
    y = np.array([ds.latency("V100", c) for c in ds.cases]) * 2.0
    ens = MedianEnsemble(seed=0, n_trees=15, members=("linear", "forest"),
                         device="cpu").fit(X, y)
    clone = oracle.clone_with_pairs({PAIR: ens})
    assert clone.profet is not oracle.profet
    assert clone.features is oracle.features          # shared feature space
    assert clone.ensemble(*PAIR) is ens
    assert oracle.ensemble(*PAIR) is not ens          # incumbent untouched
    # the clone banks and serves on its own
    assert clone.predict_many(
        [api.PredictRequest("T4", "V100",
                            api.Workload.from_case(ds.cases[0]))]).banked


# ---------------------------------------------------------------------------
# twins: shadow canary verdicts
# ---------------------------------------------------------------------------


def test_canary_passes_genuinely_better_candidate(oracle):
    ds = oracle.dataset
    buf = MeasurementBuffer()
    _fill_drifted(buf, ds, PAIR, ds.cases[:10], 1.6, noise=0.01)
    cand, _ = build_candidate(oracle, buf, [PAIR], min_refit_obs=6)
    rep = verdict(oracle, cand, buf, [PAIR], min_obs=4)
    assert rep.passed and PAIR in rep.pair_scores
    inc, c, n = rep.pair_scores[PAIR]
    assert c < inc and n == 20


def test_canary_fails_on_shadow_errors(oracle):
    buf = MeasurementBuffer()
    _fill_drifted(buf, oracle.dataset, PAIR, oracle.dataset.cases[:10], 1.6)
    cand, _ = build_candidate(oracle, buf, [PAIR], min_refit_obs=6)
    rep = verdict(oracle, cand, buf, [PAIR], min_obs=4, shadow_errors=2)
    assert not rep.passed and "shadow" in rep.reason


def test_canary_fails_without_refit_pair_coverage(oracle):
    rep = verdict(oracle, oracle, MeasurementBuffer(), [PAIR], min_obs=4)
    assert not rep.passed and "no held-out" in rep.reason


def test_canary_fails_non_improving_candidate(oracle):
    buf = MeasurementBuffer()
    _fill_drifted(buf, oracle.dataset, PAIR, oracle.dataset.cases[:10], 1.6)
    rep = verdict(oracle, oracle, buf, [PAIR], min_obs=4)
    assert not rep.passed and "did not improve" in rep.reason


# ---------------------------------------------------------------------------
# the full loop over a live service, on either package
# ---------------------------------------------------------------------------


def _drive_round(svc, cal, reqs, truth_fn):
    """One traffic round: serve ``reqs``, feed measured truth back like a
    client echoing predictions+epoch, then run one control step."""
    for r in reqs:
        svc.submit(r)
    svc.run()
    for sr in svc.take_finished():
        if sr.error is not None:
            continue
        truth = truth_fn(sr.request)
        if truth is None:
            continue
        cal.ingest(sr.request.anchor, sr.request.target,
                   sr.request.workload, truth,
                   predicted_ms=sr.result.latency_ms,
                   epoch=sr.result.epoch)
    return cal.step()


def _cross_reqs(pkg, cases):
    return [pkg.api.PredictRequest("T4", "V100",
                                   pkg.api.Workload.from_case(c))
            for c in cases]


def _drift_truth(ds, factor, rng, noise=0.01):
    def fn(req):
        truth = ds.latency(req.target, req.workload.case) * factor
        return truth * (1 + rng.normal(0, noise))
    return fn


def _calibrator(pkg, svc, **kw):
    """A calibrator at ``CAL`` whose clock stands still (no scheduled
    refit can fire; both packages see the same time)."""
    return pkg.cal.Calibrator(svc, pkg.cal.CalibrationConfig(**CAL_KW),
                              clock=lambda: 0.0, **kw)


def _promote_scenario(pkg, orc):
    ds = orc.dataset
    svc = pkg.LatencyService(orc, max_wave=32)
    cal = _calibrator(pkg, svc)
    base_epoch = svc.epoch
    drifted = _drift_truth(ds, 1.6, np.random.default_rng(1))
    states, seen_epochs = [], set()
    for rnd in range(14):
        reqs = _cross_reqs(pkg, [ds.cases[(rnd * 7 + i) % len(ds.cases)]
                                 for i in range(16)])
        states.append(_drive_round(svc, cal, reqs, drifted))
        seen_epochs |= {sr.result.epoch
                        for sr in svc.finished if sr.result is not None}
        if cal.stats.confirms:
            break
    return svc, cal, states, dict(base_epoch=base_epoch,
                                  seen_epochs=seen_epochs)


def _poisoned_scenario(pkg, orc):
    ds = orc.dataset
    svc = pkg.LatencyService(orc, max_wave=32)

    def poisoned_refit(oracle_, buffer, pairs, **kw):
        # a catastrophically wrong candidate: predicts ~0 everywhere
        overrides = {}
        for pair in pairs:
            X = oracle_.feature_matrix(pair[0], ds.cases)
            overrides[pair] = pkg.MedianEnsemble(
                seed=0, n_trees=5, members=("linear", "forest")).fit(
                    X, np.full(len(ds.cases), 1e-3))
        rep = pkg.cal.RefitReport(pairs=tuple(pairs), skipped=(), scale={},
                                  n_obs={p: 99 for p in pairs}, total_obs=99)
        return oracle_.clone_with_pairs(overrides), rep

    cal = _calibrator(pkg, svc, refit_fn=poisoned_refit)
    base_epoch = svc.epoch
    drifted = _drift_truth(ds, 1.6, np.random.default_rng(2))
    states = []
    for rnd in range(14):
        reqs = _cross_reqs(pkg, [ds.cases[(rnd * 5 + i) % len(ds.cases)]
                                 for i in range(16)])
        states.append(_drive_round(svc, cal, reqs, drifted))
        if cal.stats.canary_fail:
            break
    return svc, cal, states, dict(base_epoch=base_epoch)


def _transient_scenario(pkg, orc):
    ds = orc.dataset
    svc = pkg.LatencyService(orc, max_wave=32)
    cal = _calibrator(pkg, svc)
    base_epoch = svc.epoch
    rng = np.random.default_rng(3)
    regime = {"factor": 1.6}

    def truth_fn(req):
        t = ds.latency(req.target, req.workload.case) * regime["factor"]
        return t * (1 + rng.normal(0, 0.01))

    promoted_epoch = None
    states = []
    for rnd in range(20):
        reqs = _cross_reqs(pkg, [ds.cases[(rnd * 7 + i) % len(ds.cases)]
                                 for i in range(16)])
        states.append(_drive_round(svc, cal, reqs, truth_fn))
        if cal.stats.promotions and promoted_epoch is None:
            promoted_epoch = svc.epoch
            regime["factor"] = 1.0    # the drift was transient: truth reverts
        if cal.stats.rollbacks:
            break
    rolled_back_epoch = svc.epoch
    # post-rollback traffic scores cleanly against the restored oracle
    for rnd in range(3):
        states.append(_drive_round(svc, cal,
                                   _cross_reqs(pkg, ds.cases[:12]),
                                   truth_fn))
    return svc, cal, states, dict(base_epoch=base_epoch,
                                  promoted_epoch=promoted_epoch,
                                  rolled_back_epoch=rolled_back_epoch)


# ---------------------------------------------------------------------------
# twins: the full loop over a live service
# ---------------------------------------------------------------------------


def test_e2e_drift_refit_canary_promote(oracle):
    svc, cal, states, info = _promote_scenario(PORT, oracle)
    base_epoch = info["base_epoch"]
    s = cal.stats
    # the whole arc ran: detect -> refit -> shadow -> promote -> confirm
    assert s.drift_events >= 1 and s.refits == 1
    assert s.canary_pass == 1 and s.canary_fail == 0
    assert s.promotions == 1 and s.rollbacks == 0 and s.confirms == 1
    assert STATE_SHADOW in states and STATE_CONFIRM in states
    assert states[-1] == STATE_IDLE
    # promoted epoch is a recognisable calibration epoch
    assert svc.epoch != base_epoch and "+cal" in svc.epoch
    # zero stale-epoch answers: every response carried an epoch that was
    # current when it was served
    assert info["seen_epochs"] <= {base_epoch, svc.epoch}
    # live error recovered below the trigger
    assert cal.detector.mape(PAIR) < CAL.trigger_mape
    # and the service keeps serving under the promoted oracle
    for r in _cross_reqs(PORT, oracle.dataset.cases[:4]):
        svc.submit(r)
    done = svc.run()
    assert all(sr.result.epoch == svc.epoch for sr in done[-4:])
    # shadow canary actually replayed mirrored live waves off-path
    assert s.shadow_waves >= 1 and s.shadow_requests > 0
    assert s.shadow_errors == 0


def test_e2e_poisoned_candidate_rolls_back_before_promotion(oracle):
    svc, cal, _, info = _poisoned_scenario(PORT, oracle)
    s = cal.stats
    # the canary caught the poison: no promotion, incumbent never stopped
    assert s.refits == 1 and s.canary_fail == 1 and s.canary_pass == 0
    assert s.promotions == 0 and s.rollbacks == 0
    assert s.state == STATE_IDLE
    assert svc.epoch == info["base_epoch"]
    assert s.last_verdict is not None and not s.last_verdict["passed"]
    assert any("canary failed" in e for e in s.events)
    # incumbent still serves correctly
    done_before = svc.stats.requests
    for r in _cross_reqs(PORT, oracle.dataset.cases[:4]):
        svc.submit(r)
    svc.run()
    assert svc.stats.requests == done_before + 4
    assert svc.stats.errors == 0


def test_e2e_transient_drift_promotes_then_rolls_back(oracle):
    svc, cal, _, info = _transient_scenario(PORT, oracle)
    base_epoch, promoted_epoch = info["base_epoch"], info["promoted_epoch"]
    s = cal.stats
    assert promoted_epoch is not None and "+cal" in promoted_epoch
    assert s.promotions == 1 and s.rollbacks == 1 and s.confirms == 0
    assert s.state == STATE_IDLE
    # the rollback re-swap restored the pre-promotion oracle under a fresh
    # uniquified epoch, and purged every cache key of the failed epoch
    epoch = info["rolled_back_epoch"]
    assert epoch == svc.epoch
    assert epoch not in (base_epoch, promoted_epoch)
    assert epoch.startswith(base_epoch)
    assert all(k[0] != promoted_epoch for k in svc._cache)
    assert svc.oracle.ensemble(*PAIR) is oracle.ensemble(*PAIR)
    # post-rollback traffic scored cleanly against the restored oracle
    assert cal.detector.mape(PAIR) < CAL.trigger_mape


def test_promotion_failure_leaves_incumbent_serving(oracle):
    """A candidate whose warm-up blows up mid-promote is discarded like a
    failed canary; the incumbent epoch keeps serving."""
    ds = oracle.dataset
    svc = LatencyService(oracle, max_wave=32)

    def exploding_refit(oracle_, buffer, pairs, **kw):
        cand, rep = build_candidate(oracle_, buffer, pairs,
                                    min_refit_obs=CAL.min_refit_obs,
                                    window=CAL.drift_confirm_obs)
        if cand is not None:
            cand.warmup = lambda max_rows=64: (_ for _ in ()).throw(
                RuntimeError("bank exploded"))
        return cand, rep

    cal = Calibrator(svc, CAL, refit_fn=exploding_refit)
    base_epoch = svc.epoch
    drifted = _drift_truth(ds, 1.6, np.random.default_rng(4))
    for rnd in range(14):
        _drive_round(svc, cal,
                     _cross_reqs(PORT,
                                 [ds.cases[(rnd * 5 + i) % len(ds.cases)]
                                  for i in range(16)]), drifted)
        if cal.stats.canary_fail:
            break
    assert cal.stats.promotions == 0 and cal.stats.canary_fail == 1
    assert svc.epoch == base_epoch and cal.stats.state == STATE_IDLE
    assert any("promotion failed" in e for e in cal.stats.events)


# ---------------------------------------------------------------------------
# twins: stats surface and scheduled refits
# ---------------------------------------------------------------------------


def test_summary_exports_control_plane(oracle):
    svc = LatencyService(oracle, warmup=False)
    cal = Calibrator(svc, CAL)
    cal.ingest("T4", "V100", ("LeNet5", 4, 32), 12.0, predicted_ms=10.0)
    cal.step()
    s = cal.summary()
    assert s["state"] == STATE_IDLE
    assert s["observations"] == 1 and s["scored"] == 1
    assert s["buffered"] == 1 and s["epoch"] == svc.epoch
    assert "T4->V100" in s["rolling_mape"]
    # malformed rows are dropped with accounting, never raised
    accepted, dropped = cal.ingest_rows([
        {"anchor": "T4", "target": "V100", "model": "LeNet5", "batch": 4,
         "pix": 32, "latency_ms": 11.0},
        {"anchor": "T4", "target": "V100", "model": "LeNet5",
         "batch": "not-a-number", "pix": 32, "latency_ms": 11.0},
        {"missing": "everything"},
    ])
    assert (accepted, dropped) == (1, 2)
    assert cal.stats.dropped == 2


def test_scheduled_refit_launches_on_interval(oracle):
    svc = LatencyService(oracle, warmup=False)
    now = [0.0]
    cfg = CalibrationConfig(refit_interval_s=60.0, min_refit_obs=4,
                            min_obs=6, trigger_mape=50.0)
    cal = Calibrator(svc, cfg, clock=lambda: now[0])
    for k in range(8):
        cal.ingest("T4", "V100", ("LeNet5", 16, 32), 10.0 + 0.01 * k,
                   predicted_ms=10.0, epoch=svc.epoch)
    # interval not elapsed: stays idle, nothing launched
    assert cal.step() == STATE_IDLE
    assert cal.stats.refits == 0 and cal.stats.scheduled_refits == 0
    now[0] = 61.0
    assert cal.step() == STATE_SHADOW
    assert cal.stats.refits == 1 and cal.stats.scheduled_refits == 1
    assert cal.stats.drift_events == 0
    assert "scheduled refit candidate" in cal.stats.events[-1]


def test_scheduled_refit_waits_for_observations(oracle):
    svc = LatencyService(oracle, warmup=False)
    now = [0.0]
    cfg = CalibrationConfig(refit_interval_s=60.0, min_refit_obs=4)
    cal = Calibrator(svc, cfg, clock=lambda: now[0])
    cal.ingest("T4", "V100", ("LeNet5", 16, 32), 10.0, predicted_ms=10.0,
               epoch=svc.epoch)
    now[0] = 61.0
    assert cal.step() == STATE_IDLE
    assert cal.stats.refits == 0 and cal.stats.scheduled_refits == 0
    # the timer re-armed: the next interval can fire once data arrives
    for k in range(4):
        cal.ingest("T4", "V100", ("AlexNet", 16, 32), 10.0 + 0.01 * k,
                   predicted_ms=10.0, epoch=svc.epoch)
    now[0] = 100.0
    assert cal.step() == STATE_IDLE        # 61 + 60 not reached yet
    now[0] = 122.0
    assert cal.step() == STATE_SHADOW
    assert cal.stats.scheduled_refits == 1


def test_scheduled_refit_disabled_by_default(oracle):
    svc = LatencyService(oracle, warmup=False)
    now = [0.0]
    cal = Calibrator(svc, CAL, clock=lambda: now[0])
    for k in range(12):
        cal.ingest("T4", "V100", ("LeNet5", 16, 32), 10.0 + 0.01 * k,
                   predicted_ms=10.0, epoch=svc.epoch)
    now[0] = 1e9
    assert cal.step() == STATE_IDLE
    assert cal.stats.refits == 0 and cal.stats.scheduled_refits == 0
    assert "scheduled_refits" in cal.summary()


# ---------------------------------------------------------------------------
# the port against the reference on the same inputs
# ---------------------------------------------------------------------------


def test_public_surface_matches_the_reference():
    assert cal_mod.__all__ == ref_cal.__all__
    for name in cal_mod.__all__:
        assert getattr(cal_mod, name) is not None, name
    assert (cal_mod.STATE_IDLE, cal_mod.STATE_SHADOW,
            cal_mod.STATE_CONFIRM) == (ref_cal.STATE_IDLE,
                                       ref_cal.STATE_SHADOW,
                                       ref_cal.STATE_CONFIRM)
    assert CalibrationConfig() == CalibrationConfig(
        **vars(ref_cal.CalibrationConfig()))


def _observation_stream(n=400, seed=0):
    """Rows (anchor, target, case, latency, predicted) over allowed,
    unroutable and measured-mode pairs, with non-finite and non-positive
    latencies mixed in."""
    rng = np.random.default_rng(seed)
    pairs = [PAIR, ("V100", "T4"), ("T4", "TPUv9"), ("K80", "K80"),
             ("A100", "T4")]
    cases = [("LeNet5", 4, 32), ("AlexNet", 16, 64), ("ResNet18", 8, 32)]
    rows = []
    for _ in range(n):
        lat = float(rng.lognormal(2.0, 0.5))
        u = rng.random()
        if u < 0.03:
            lat = float("nan")
        elif u < 0.06:
            lat = -lat
        pair = pairs[rng.integers(len(pairs))]
        rows.append((pair[0], pair[1], cases[rng.integers(len(cases))],
                     lat, lat * float(rng.uniform(0.6, 1.6))))
    return rows


def test_buffer_gives_the_reference_drops_and_rings():
    rows = _observation_stream()
    allowed = {PAIR, ("V100", "T4")}
    got = {}
    for name, buf_cls, obs_cls in (
            ("port", MeasurementBuffer, Observation),
            ("ref", ref_cal.MeasurementBuffer, ref_cal.Observation)):
        buf = buf_cls(per_pair=16, max_pairs=3, allowed_pairs=allowed)
        taken = [buf.add(obs_cls(a, t, c, lat, pred))
                 for a, t, c, lat, pred in rows]
        got[name] = (taken, buf.evicted, buf.rejected, buf.total(),
                     buf.pairs(),
                     {p: [(o.case, o.latency_ms, o.predicted_ms)
                          for o in buf.observations(p, last=9)]
                      for p in buf.pairs()})
    assert got["port"] == got["ref"]
    assert got["port"][1] > 0 and got["port"][2] > 0


def test_drift_detector_gives_the_reference_mape_and_triggers():
    rows = _observation_stream(seed=1)
    got = {}
    for name, det_cls in (("port", DriftDetector),
                          ("ref", ref_cal.DriftDetector)):
        det = det_cls(window=24, min_obs=6, trigger_mape=20.0,
                      clear_ratio=0.6)
        trace = []
        for k, (a, t, _, lat, pred) in enumerate(rows):
            if not np.isfinite(lat):
                lat = pred = 1.0
            lat, pred = abs(lat), abs(pred)
            if k >= len(rows) // 3:       # a calmer regime: pairs clear
                pred = lat * 1.01
            trace.append((det.update((a, t), lat, pred), det.mape((a, t)),
                          det.is_drifted((a, t))))
            if k == len(rows) // 2:
                det.reset([PAIR])
        got[name] = (trace, det.drifted_pairs(), det.rolling(),
                     {p: det.samples(p) for p in det.rolling()})
    assert got["port"] == got["ref"]
    transitions = [tr[0] for tr in got["port"][0] if tr[0] is not None]
    assert True in transitions and False in transitions


def _both_buffers(ref_ds, pair, cases, factor, noise, seed):
    bufs = []
    for buf_cls, obs_cls in ((MeasurementBuffer, Observation),
                             (ref_cal.MeasurementBuffer,
                              ref_cal.Observation)):
        buf = buf_cls()
        _fill_drifted(buf, ref_ds, pair, cases, factor, noise=noise,
                      seed=seed, obs_cls=obs_cls)
        bufs.append(buf)
    return bufs


def _latencies(pkg, orc, pair, cases):
    return orc.predict_many([
        pkg.api.PredictRequest(pair[0], pair[1],
                               pkg.api.Workload.from_case(c))
        for c in cases]).latencies()


def test_build_candidate_and_heldout_scores_match_bitwise(oracle,
                                                          ref_oracle):
    ds = ref_oracle.dataset
    buf, ref_buf = _both_buffers(ds, PAIR, ds.cases[:12], 1.7, 0.01, 5)
    # a second pair with too few observations: skipped by both
    for b, obs_cls in ((buf, Observation), (ref_buf, ref_cal.Observation)):
        b.add(obs_cls("V100", "T4", ds.cases[0], 3.0))
    pairs = [PAIR, ("V100", "T4"), ("T4", "T4")]
    cand, rep = build_candidate(oracle, buf, pairs, min_refit_obs=6,
                                window=20)
    ref_cand, ref_rep = ref_cal.build_candidate(ref_oracle, ref_buf, pairs,
                                                min_refit_obs=6, window=20)
    assert (rep.pairs, rep.skipped, rep.scale, rep.n_obs, rep.total_obs) \
        == (ref_rep.pairs, ref_rep.skipped, ref_rep.scale, ref_rep.n_obs,
            ref_rep.total_obs)
    assert rep.pairs == (PAIR,) and rep.total_obs == 20
    for pair in oracle.pairs():
        np.testing.assert_array_equal(
            _latencies(PORT, cand, pair, ds.cases),
            _latencies(REF, ref_cand, pair, ds.cases))
    # calibrated targets: the same float64 vector
    y, s, n = cal_mod.calibrated_latencies(oracle.dataset, "V100",
                                           list(ds.cases),
                                           buf.observations(PAIR))
    ry, rs, rn = ref_cal.calibrated_latencies(ds, "V100", list(ds.cases),
                                              ref_buf.observations(PAIR))
    np.testing.assert_array_equal(y, ry)
    assert (s, n) == (rs, rn)
    # the held-out scores of both oracles, and the verdicts built on them
    for window in (None, 12):
        got = heldout_scores(oracle, cand, buf, min_obs=4, window=window)
        want = ref_cal.heldout_scores(ref_oracle, ref_cand, ref_buf,
                                      min_obs=4, window=window)
        assert got == want and PAIR in got
    rep_v = verdict(oracle, cand, buf, [PAIR], min_obs=4)
    ref_v = ref_cal.verdict(ref_oracle, ref_cand, ref_buf, [PAIR],
                            min_obs=4)
    assert rep_v.summary() == ref_v.summary() and rep_v.passed


@pytest.mark.parametrize("scenario", [
    _promote_scenario, _poisoned_scenario, _transient_scenario],
    ids=["drift-promote", "poisoned-rollback", "transient-rollback"])
def test_step_loop_gives_the_reference_states_and_counters(
        oracle, ref_oracle, scenario):
    """The synchronous loop fed the same waves and observations in both
    packages: the same state after every step, the same counters and
    verdict, the same served epochs."""
    svc, cal, states, info = scenario(PORT, oracle)
    rsvc, rcal, rstates, rinfo = scenario(REF, ref_oracle)
    assert states == rstates
    assert {k: getattr(cal.stats, k) for k in COUNTERS} == \
        {k: getattr(rcal.stats, k) for k in COUNTERS}
    assert cal.stats.state == rcal.stats.state
    assert cal.stats.last_verdict == rcal.stats.last_verdict
    assert cal.stats.events == rcal.stats.events
    assert svc.epoch == rsvc.epoch and info == rinfo
    assert cal.detector.rolling() == rcal.detector.rolling()
    # every scenario gets through a refit and a verdict
    assert cal.stats.refits >= 1 and (cal.stats.canary_pass
                                      + cal.stats.canary_fail) >= 1


def test_candidate_is_fit_on_the_oracles_device(oracle):
    """The candidate's members live where the incumbent's do: a CPU
    oracle's candidate is fit on the CPU (``MedianEnsemble``'s default is
    the card, where a machine without one raises)."""
    ds = oracle.dataset
    buf = MeasurementBuffer()
    _fill_drifted(buf, ds, PAIR, ds.cases[:10], 1.6, noise=0.01)
    cand, _ = build_candidate(oracle, buf, [PAIR], min_refit_obs=6)
    ens = cand.ensemble(*PAIR)
    assert ens is not oracle.ensemble(*PAIR)
    assert ens.device == oracle.profet.device == torch.device("cpu")
    assert ens.models["forest"].device == torch.device("cpu")
    assert cand.profet.device == torch.device("cpu")
    assert cand.bank is not None and cand.bank_error is None


def test_dnn_candidate_canary_verdict_matches_the_reference():
    """With the DNN member: the incumbent (carried) is the same in both
    packages; each package refits the drifted pair with its own DNN init.
    The canary verdict on the drifted pair is the same, and the port's
    candidate is at most ``MAPE_PARITY_PTS`` worse there (one-sided)."""
    ref_oracle = ref_api.LatencyOracle.fit(
        small_dataset(), RefConfig(members=("linear", "forest", "dnn"),
                                   n_trees=15, dnn_epochs=40, seed=0))
    port_oracle = carry_oracle(ref_oracle)
    ds = ref_oracle.dataset
    buf, ref_buf = _both_buffers(ds, PAIR, ds.cases[:10], 1.6, 0.01, 0)
    cand, rep = build_candidate(port_oracle, buf, [PAIR], min_refit_obs=6)
    ref_cand, ref_rep = ref_cal.build_candidate(ref_oracle, ref_buf, [PAIR],
                                                min_refit_obs=6)
    assert rep.pairs == ref_rep.pairs == (PAIR,)
    assert "dnn" in cand.ensemble(*PAIR).models
    got = verdict(port_oracle, cand, buf, [PAIR], min_obs=4)
    want = ref_cal.verdict(ref_oracle, ref_cand, ref_buf, [PAIR], min_obs=4)
    inc, c, n = got.pair_scores[PAIR]
    rinc, rc, rn = want.pair_scores[PAIR]
    print(f"drifted pair held-out MAPE: incumbent port {inc:.3f} / repro "
          f"{rinc:.3f}; candidate port {c:.3f} / repro {rc:.3f}")
    assert got.passed == want.passed and got.passed
    assert n == rn
    # the incumbent's DNN is carried: float32 apply, rtol 1e-5
    assert inc == pytest.approx(rinc, rel=1e-5)
    assert c - rc <= MAPE_PARITY_PTS, (c, rc)


# ---------------------------------------------------------------------------
# the serve_calibrated entry point
# ---------------------------------------------------------------------------


def test_serve_calibrated_cli_on_cpu(tmp_path, capsys):
    from repro_torch.launch import serve_calibrated
    rc = serve_calibrated.main(["--device", "cpu", "--rounds", "3",
                                "--requests", "40", "--persist-dir",
                                str(tmp_path / "cal")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "drift injection: T4->V100 x1.6 from round 1" in out
    assert all(f"round {r}:" in out for r in range(3))
    assert "40/40 ok" in out
    assert "calibration timeline:" in out and "\nfinal: state=" in out
    assert "statsz: epoch " in out


def test_serve_calibrated_restart_recovers_the_promotion(tmp_path, capsys):
    """The default replay promotes and persists a calibration; a restart
    on the same ``--persist-dir`` recovers it on the CPU and serves it
    under its persisted epoch."""
    from repro_torch.launch import serve_calibrated
    argv = ["--device", "cpu", "--persist-dir", str(tmp_path / "cal")]
    assert serve_calibrated.main(argv) == 0
    out = capsys.readouterr().out
    promoted = [ln for ln in out.splitlines()
                if "promotion persisted as epoch" in ln]
    assert promoted and "+cal" in promoted[-1], out
    epoch = promoted[-1].rsplit(" ", 1)[1]
    assert serve_calibrated.main(argv + ["--rounds", "1"]) == 0
    out = capsys.readouterr().out
    assert f"recovered promoted calibration epoch {epoch}" in out
    assert f"epoch {epoch}  pairs:" in out


def test_serve_calibrated_cuda_without_a_card_raises(tmp_path):
    from repro_torch.launch import serve_calibrated
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for one without")
    with pytest.raises(RuntimeError, match="cuda"):
        serve_calibrated.main(["--device", "cuda", "--rounds", "3",
                               "--requests", "40", "--persist-dir",
                               str(tmp_path / "cal")])
