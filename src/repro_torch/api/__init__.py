"""``repro_torch.api`` — the public prediction-service layer over PROFET.

The three-call flow every consumer (advisor CLI, serving, tests) goes
through:

    from repro_torch import api

    oracle = api.LatencyOracle.fit(dataset, config)          # 1. fit (card)
    api.save(oracle, "results/oracle.pkl")                   # 2. persist
    oracle = api.load("results/oracle.pkl", expect_config=config,
                      device="cpu")                          # on any device
    r = oracle.predict(api.PredictRequest(                   # 3. query
            anchor="T4", target="V100",
            workload=api.Workload("ResNet50", 64, 128)))
    r.latency_ms, r.cost_usd(steps=50_000)

Batched querying (``oracle.predict_many``) answers a heterogeneous request
stream with one stacked dispatch through the oracle's ``ModelBank``;
plan-only access is ``oracle.plan`` -> ``PredictPlan`` -> ``oracle.execute``
-> ``BatchPredictResult``. ``repro_torch.serve.LatencyService`` adds wave
microbatching + caching on top. The surface is ``repro.api``'s, name for
name; fitting and loading take ``device=`` (default ``"cuda"``).
"""
from repro_torch.api.artifacts import (ArtifactError,
                                       FingerprintMismatchError,
                                       SchemaVersionError,
                                       calibration_fingerprint,
                                       config_fingerprint, fit_or_load, load,
                                       save)
from repro_torch.api.bank import BankUnsupportedError, ModelBank
from repro_torch.api.oracle import LatencyOracle
from repro_torch.api.planner import (choose_anchor, plan_request,
                                     request_fingerprint)
from repro_torch.api.types import (ANCHOR_ANY, KNOB_BATCH, KNOB_PIXEL,
                                   MODE_AUTO, MODE_CROSS, MODE_MEASURED,
                                   MODE_TWO_PHASE, ApiError,
                                   BatchPredictResult, CircuitOpenError,
                                   DeadlineExceededError, ExecutionError,
                                   GridRequest, GridResult,
                                   InvalidWorkloadError,
                                   MalformedRequestError, OverloadedError,
                                   PredictPlan, PredictRequest, PredictResult,
                                   ServiceStats, UnknownDeviceError,
                                   UnsupportedRequestError, Workload)

__all__ = [
    "ANCHOR_ANY", "ApiError", "ArtifactError", "BankUnsupportedError",
    "BatchPredictResult", "CircuitOpenError", "DeadlineExceededError",
    "ExecutionError", "FingerprintMismatchError", "GridRequest",
    "GridResult", "InvalidWorkloadError", "KNOB_BATCH", "KNOB_PIXEL",
    "LatencyOracle", "MODE_AUTO", "MODE_CROSS", "MODE_MEASURED",
    "MODE_TWO_PHASE", "MalformedRequestError", "ModelBank",
    "OverloadedError",
    "PredictPlan", "PredictRequest", "PredictResult", "SchemaVersionError",
    "ServiceStats", "UnknownDeviceError", "UnsupportedRequestError",
    "Workload", "calibration_fingerprint", "choose_anchor",
    "config_fingerprint", "fit_or_load",
    "load", "plan_request", "request_fingerprint", "save",
]
