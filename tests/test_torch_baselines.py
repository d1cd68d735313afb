"""The paper's baselines in the port (``repro_torch.core.baselines``)
against the reference (``repro.core.baselines``) on the same inputs.

Tolerances and why:
  - Paleo, Habitat and MLPredict's white-box features are the same numpy
    code on the same simulator: bitwise equal;
  - MLPredict's MLP fed the reference's initial weights (and the same
    minibatch plan): float32 steps round their sums in another order, so
    the trained weights stay within 1e-5 of each layer's largest weight,
    the bar of ``tests/test_torch_regressors.py``.

The last five tests are the reference's sanity tests
(``tests/test_baselines.py``) run on the port.
"""
import numpy as np
import torch

from repro.core import baselines as ref_baselines
from repro.core import regressors as ref_regressors
from repro.core import workloads as ref_workloads
from repro_torch.core import baselines, regressors, simulator, workloads

from _torch_state import dataset_from_repro

PAPER_MODELS = ("VGG16", "AlexNet", "ResNet50")
PAIRS = (("T4", "V100"), ("V100", "T4"))


def _ml_grid():
    """``tests/test_baselines.py``'s MLPredict grid, in both packages."""
    ref_ds = ref_workloads.generate(devices=("T4", "V100"),
                                    models=("LeNet5", "AlexNet"),
                                    batches=(16, 64), pixels=(32, 64))
    return ref_ds, dataset_from_repro(ref_ds)


def test_paleo_and_habitat_match_the_reference_bitwise():
    ref_ds = ref_workloads.generate(devices=("T4", "V100"),
                                    models=PAPER_MODELS)
    ds = dataset_from_repro(ref_ds)
    pa, ref_pa = baselines.PaleoModel(), ref_baselines.PaleoModel()
    for d in ds.devices:
        meas = [ds.latency(d, c) for c in ds.cases]
        pa.calibrate_many(d, ds.cases, meas)
        ref_pa.calibrate_many(d, ref_ds.cases, meas)
    assert pa.ppp == ref_pa.ppp
    one = baselines.PaleoModel().calibrate("T4", ds.cases[3], 7.5)
    assert one.ppp == ref_baselines.PaleoModel().calibrate(
        "T4", ds.cases[3], 7.5).ppp
    hb, ref_hb = baselines.HabitatScaling(), ref_baselines.HabitatScaling()
    for c in ds.cases:
        for d in ds.devices:
            assert pa.predict(d, c) == ref_pa.predict(d, c)
        for ga, gt in PAIRS:
            assert hb.predict(ga, gt, c) == ref_hb.predict(ga, gt, c)


def test_mlpredict_features_match_the_reference_bitwise():
    ref_ds, ds = _ml_grid()
    ml = baselines.MLPredictModel(epochs=1, device="cpu")
    ref_ml = ref_baselines.MLPredictModel(epochs=1)
    for d in ds.devices:
        for c in ds.cases:
            np.testing.assert_array_equal(ml._x(d, c), ref_ml._x(d, c))


def test_mlpredict_tracks_the_reference_from_its_init(monkeypatch):
    """``MLPredictModel.fit`` in both packages, the port's MLP started
    from the reference's initial weights: the trained weights move away
    from that init and stay together."""
    ref_ds, ds = _ml_grid()
    epochs, seed = 40, 0
    ref_ml = ref_baselines.MLPredictModel(epochs=epochs, seed=seed).fit(
        ref_ds, ref_ds.cases)
    d_in = ref_ml._x("T4", ref_ds.cases[0]).shape[0]
    init = [{k: np.array(v) for k, v in layer.items()}
            for layer in ref_regressors._mlp_init(
                seed, d_in, ref_regressors.DNNRegressor.LAYERS)]

    def reference_init(seed_, d, layers, device="cuda"):
        assert (seed_, d, tuple(layers)) == (seed, d_in,
                                            regressors.DNNRegressor.LAYERS)
        return [{k: torch.from_numpy(v.copy()).to(device)
                 for k, v in layer.items()} for layer in init]

    monkeypatch.setattr(regressors, "_mlp_init", reference_init)
    ml = baselines.MLPredictModel(epochs=epochs, seed=seed,
                                  device="cpu").fit(ds, ds.cases)
    assert ml.reg.device == torch.device("cpu")
    np.testing.assert_array_equal(ml.reg._stats[0], ref_ml.reg._stats[0])
    assert ml.reg._stats[2] == ref_ml.reg._stats[2]
    for la, lb, l0 in zip(ref_ml.reg.params, ml.reg.params, init):
        assert not np.allclose(np.asarray(la["w"]), l0["w"])
        for k in ("w", "b"):
            wa = np.asarray(la[k])
            np.testing.assert_allclose(lb[k].numpy(), wa, rtol=0,
                                       atol=1e-5 * np.abs(wa).max())
    got = np.array([ml.predict(d, c) for d in ds.devices for c in ds.cases])
    want = np.array([ref_ml.predict(d, c)
                     for d in ref_ds.devices for c in ref_ds.cases])
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ---------------------------------------------------------------------------
# the reference's sanity tests (tests/test_baselines.py) on the port
# ---------------------------------------------------------------------------


def test_paleo_exact_on_single_calibration_case():
    case = ("VGG16", 64, 128)
    m = simulator.measure("T4", *case)
    pa = baselines.PaleoModel().calibrate("T4", case, m.latency_ms)
    assert abs(pa.predict("T4", case) - m.latency_ms) / m.latency_ms < 1e-6


def test_paleo_reasonable_after_geometric_calibration():
    ds = workloads.generate(devices=("T4", "V100"), models=PAPER_MODELS)
    pa = baselines.PaleoModel()
    for d in ds.devices:
        pa.calibrate_many(d, ds.cases, [ds.latency(d, c) for c in ds.cases])
    errs = [abs(pa.predict(d, c) - ds.latency(d, c)) / ds.latency(d, c)
            for d in ds.devices for c in ds.cases]
    assert np.mean(errs) < 2.0  # analytic model: coarse but sane


def test_habitat_direction_of_scaling():
    """Scaling a big compute-bound workload from T4 to V100 must predict a
    speedup (V100 has ~1.7x peak and ~2.8x bandwidth)."""
    hb = baselines.HabitatScaling()
    case = ("VGG16", 128, 128)
    t4 = simulator.measure("T4", *case).latency_ms
    pred_v100 = hb.predict("T4", "V100", case)
    assert pred_v100 < t4


def test_mlpredict_trains_and_predicts():
    ds = workloads.generate(devices=("T4", "V100"),
                            models=("LeNet5", "AlexNet"),
                            batches=(16, 64), pixels=(32, 64))
    ml = baselines.MLPredictModel(epochs=40, device="cpu").fit(ds, ds.cases)
    p = ml.predict("T4", ds.cases[0])
    assert np.isfinite(p)


def test_profet_beats_baselines_small_grid():
    """The paper's headline: PROFET's MAPE beats the white-box baselines.
    Checked on a reduced grid to keep test time sane."""
    from repro_torch.core.ensemble import mape
    from repro_torch.core.predictor import Profet, ProfetConfig

    ds = workloads.generate(devices=("T4", "V100"),
                            models=("LeNet5", "AlexNet", "VGG11", "ResNet18"))
    train, test = workloads.split_cases(ds.cases, test_frac=0.25, seed=0)
    prophet = Profet(ProfetConfig(dnn_epochs=40, n_trees=20),
                     device="cpu").fit(ds, train)

    def profet_mape():
        errs = []
        for ga, gt in PAIRS:
            pred = prophet.predict_cross_many(ga, gt, ds, test)
            true = np.array([ds.latency(gt, c) for c in test])
            errs.append(mape(true, pred))
        return np.mean(errs)

    hb = baselines.HabitatScaling()
    hb_errs = []
    for ga, gt in PAIRS:
        pred = np.array([hb.predict(ga, gt, c) for c in test])
        true = np.array([ds.latency(gt, c) for c in test])
        hb_errs.append(mape(true, pred))

    assert profet_mape() < np.mean(hb_errs)
