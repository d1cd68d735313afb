"""The port's DNN trainer held to the reference's accuracy end to end: the
port fits with its own seeded torch init and ``repro`` with its own
(``jax.random`` cannot be reproduced in torch, so the heads differ), both
on the same training cases of the small grid, and both are scored on the
same held-out cases as ``benchmarks/bench_fit.py`` scores them (mean
phase-1 cross MAPE over every trained pair). The port may be at most
``MAPE_PARITY_PTS`` points worse (one-sided: better never fails).

The configuration is ``bench_fit``'s smoke fit: all three members, 40
DNN epochs, 30 trees, seed 0."""
import numpy as np
import pytest

from repro.core import workloads as ref_workloads
from repro.core.predictor import Profet as RefProfet
from repro.core.predictor import ProfetConfig as RefConfig
from repro_torch.core.predictor import Profet, ProfetConfig

from _torch_state import SMALL_DEVICES, SMALL_MODELS, dataset_from_repro

# benchmarks/bench_fit.py: the regression budget, in percentage points
MAPE_PARITY_PTS = 3.0


def _mape(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    return float(np.mean(np.abs(y_pred - y_true)
                         / np.maximum(np.abs(y_true), 1e-12)) * 100.0)


def _cross_mape(profet, ds, test) -> float:
    """Mean phase-1 MAPE over every trained pair on the held-out cases
    (``bench_fit._cross_mape``)."""
    scores = []
    X_by_anchor = {}
    for (ga, gt) in sorted(profet.cross):
        if ga not in X_by_anchor:
            X_by_anchor[ga] = profet.feature_matrix(
                [ds.profile(ga, c) for c in test], test)
        y_true = np.array([ds.latency(gt, c) for c in test])
        scores.append(_mape(y_true, profet.predict_cross_matrix(
            ga, gt, X_by_anchor[ga])))
    return float(np.mean(scores))


@pytest.fixture(scope="module")
def split():
    ds = ref_workloads.generate(devices=SMALL_DEVICES, models=SMALL_MODELS)
    train, test = ref_workloads.split_cases(ds.cases, test_frac=0.25, seed=0)
    return ds, dataset_from_repro(ds), train, test


def test_port_fit_holds_held_out_mape_within_parity(split):
    ref_ds, ds, train, test = split
    kw = dict(members=("linear", "forest", "dnn"), dnn_epochs=40,
              n_trees=30, seed=0)
    ref = RefProfet(RefConfig(**kw)).fit(ref_ds, train)
    port = Profet(ProfetConfig(**kw), device="cpu").fit(ds, train)
    mape_ref = _cross_mape(ref, ref_ds, test)
    mape_port = _cross_mape(port, ds, test)
    print(f"held-out cross MAPE: port {mape_port:.2f}%, repro "
          f"{mape_ref:.2f}%")
    assert np.isfinite(mape_port) and np.isfinite(mape_ref)
    assert mape_port - mape_ref <= MAPE_PARITY_PTS, (
        f"port {mape_port:.2f}% vs repro {mape_ref:.2f}% held-out cross "
        f"MAPE ({mape_port - mape_ref:+.2f} pts > {MAPE_PARITY_PTS})")
