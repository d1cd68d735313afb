"""The port's serving slice end to end against the reference: a small
reference oracle (2 devices, 3 models, few trees and epochs) carried into
``repro_torch`` with ``profet_from_numpy``, and the same
``synthetic_requests`` stream served by both ``LatencyService``s, the
port's on ``device="cpu"``.

Tolerances: with the linear and forest members every step is float64 and
the same operations in the same order (routing compares, the tree-sequential
mean, the row-stable linear form, ``np.median``, Horner), so answers are
bitwise equal. With the float32 DNN member the median can pick the DNN's
answer, which XLA and PyTorch round differently: rtol 1e-5.
"""
import numpy as np
import pytest

from repro.serve import LatencyService as RefService
from repro.serve import synthetic_requests as ref_requests
from repro.api.planner import request_fingerprint as ref_fingerprint
from repro_torch.api.oracle import LatencyOracle
from repro_torch.api.planner import request_fingerprint
from repro_torch.convert import profet_from_numpy, profet_to_numpy
from repro_torch.core import workloads
from repro_torch.core.predictor import ProfetConfig
from repro_torch.serve import LatencyService, synthetic_requests

from _torch_state import (SMALL_DEVICES, SMALL_MODELS, fit_small_repro,
                          state_from_repro)

N_REQ = 120
LINEAR_FOREST = ("linear", "forest")
ALL = ("linear", "forest", "dnn")


@pytest.fixture(scope="module")
def ref_oracles():
    return {m: fit_small_repro(m) for m in (LINEAR_FOREST, ALL)}


def _port_dataset():
    return workloads.generate(devices=SMALL_DEVICES, models=SMALL_MODELS)


def _carry(ref_oracle):
    return LatencyOracle(profet_from_numpy(state_from_repro(ref_oracle.profet),
                                           device="cpu"), _port_dataset())


def _serve(service_cls, oracle, reqs, replays=2):
    svc = service_cls(oracle, max_wave=16)
    for _ in range(replays):
        for r in reqs:
            svc.submit(r)
        svc.run()
    assert svc.stats.errors == 0 and not svc.stats.degraded
    done = sorted(svc.finished, key=lambda sr: sr.uid)
    return svc, np.array([sr.result.latency_ms for sr in done])


def _both(ref_oracle, port_oracle):
    rq = ref_requests(ref_oracle, n=N_REQ, seed=1)
    pq = synthetic_requests(port_oracle, n=N_REQ, seed=1)
    assert [ref_fingerprint(r) for r in rq] == \
        [request_fingerprint(r) for r in pq]
    _, want = _serve(RefService, ref_oracle, rq)
    svc, got = _serve(LatencyService, port_oracle, pq)
    return svc, got, want


def test_linear_forest_service_answers_bitwise(ref_oracles):
    ref = ref_oracles[LINEAR_FOREST]
    port = _carry(ref)
    svc, got, want = _both(ref, port)
    np.testing.assert_array_equal(got, want)
    assert port.fingerprint == ref.fingerprint
    # one grouped forest launch per banked wave (every wave here is banked)
    bank = port.bank
    assert port.bank_error is None
    assert bank.forest_launches == svc.stats.fused_calls > 0
    assert "dnn" not in bank.members and bank.mlp_applies == 0


def test_dnn_service_answers_within_float32(ref_oracles):
    ref = ref_oracles[ALL]
    port = _carry(ref)
    svc, got, want = _both(ref, port)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    bank = port.bank
    assert bank.forest_launches == bank.mlp_applies == svc.stats.fused_calls


def test_port_fit_of_linear_forest_bitwise_equal(ref_oracles):
    ref = ref_oracles[LINEAR_FOREST]
    cfg = ProfetConfig(members=LINEAR_FOREST, n_trees=8, dnn_epochs=4)
    port = LatencyOracle.fit(_port_dataset(), cfg, device="cpu")
    assert port.pairs() == ref.pairs()
    for pair in ref.pairs():
        a = ref.profet.cross[pair].models
        b = port.profet.cross[pair].models
        np.testing.assert_array_equal(b["linear"].coef_, a["linear"].coef_)
        for k in ("feat", "thr", "left", "right", "value"):
            np.testing.assert_array_equal(getattr(b["forest"].forest_, k),
                                          getattr(a["forest"].forest_, k))
    _, got, want = _both(ref, port)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("members", [LINEAR_FOREST, ALL])
def test_banked_and_per_group_agree(ref_oracles, members):
    port = _carry(ref_oracles[members])
    plans = [port.plan(r) for r in synthetic_requests(port, n=60, seed=3)]
    banked = port.execute(plans, banked=True)
    per_group = port.execute(plans, banked=False)
    assert banked.banked and not per_group.banked
    assert banked.fused_calls == 1 and per_group.fused_calls > 1
    a, b = banked.latencies(), per_group.latencies()
    if members == LINEAR_FOREST:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-5)


def test_numpy_state_round_trip(ref_oracles):
    port = _carry(ref_oracles[ALL])
    again = LatencyOracle(profet_from_numpy(profet_to_numpy(port.profet),
                                            device="cpu"), port.dataset)
    plans = [port.plan(r) for r in synthetic_requests(port, n=40, seed=4)]
    np.testing.assert_array_equal(again.execute(plans).latencies(),
                                  port.execute(plans).latencies())
