"""The port's dataset and regressors (``repro_torch.core``) against the
reference (``repro.core``) on the same inputs.

Tolerances and why:
  - dataset, forest grower, linear fit: the port runs the same numpy code
    on the host, so they are bitwise equal;
  - DNN apply and stacked apply on the same weights: float32 products whose
    sums XLA and PyTorch order differently, rtol 1e-5 (the reference's own
    batched-vs-per-row bar);
  - ``fit_dnn_multi`` fed the reference's initial weights and the same
    minibatch plan: every step rounds its float32 sums in another order, so
    trained weights drift by a few ulps per step; after a few epochs they
    stay within 1e-5 of each layer's largest weight.
"""
import numpy as np
import torch

from repro.core import regressors as R
from repro.core import workloads as ref_workloads
from repro_torch.core import regressors as P
from repro_torch.core import workloads

from _torch_state import SMALL_DEVICES, SMALL_MODELS


def _data(n=70, d=9, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    Y = np.stack([np.abs(X[:, 0]) * 3 + X[:, 1] ** 2 + 1,
                  np.exp(X[:, 2] / 3) * 5])
    return X, Y


def test_dataset_bitwise_equal():
    a = ref_workloads.generate(devices=SMALL_DEVICES, models=SMALL_MODELS)
    b = workloads.generate(devices=SMALL_DEVICES, models=SMALL_MODELS)
    assert a.devices == b.devices and a.cases == b.cases
    for d in a.devices:
        for c in a.cases:
            ma, mb = a.measurements[d][c], b.measurements[d][c]
            assert (ma.model, ma.device, ma.batch, ma.pix) == \
                (mb.model, mb.device, mb.batch, mb.pix)
            assert ma.latency_ms == mb.latency_ms
            assert ma.profile == mb.profile


def test_forest_grower_and_linear_fit_bitwise_equal():
    X, Y = _data()
    y = Y[0]
    ra = R.RandomForestRegressor(n_estimators=7, seed=4).fit(X, y).forest_
    pa = P.RandomForestRegressor(n_estimators=7, seed=4,
                                 device="cpu").fit(X, y)
    for k in ("feat", "thr", "left", "right", "value", "n_nodes"):
        np.testing.assert_array_equal(getattr(pa.forest_, k), getattr(ra, k))
    assert pa.forest_.depth == ra.depth
    Xq = _data(n=20, seed=1)[0]
    np.testing.assert_array_equal(
        pa.predict(Xq), R.RandomForestRegressor(
            n_estimators=7, seed=4).fit(X, y).predict(Xq))
    la, lb = R.LinearRegressor().fit(X, y), P.LinearRegressor().fit(X, y)
    np.testing.assert_array_equal(lb.coef_, la.coef_)
    np.testing.assert_array_equal(lb.predict(Xq), la.predict(Xq))


def _carried(ref_models):
    out = []
    for m in ref_models:
        p = P.DNNRegressor(device="cpu")
        p.params = [{k: torch.from_numpy(np.array(layer[k]))
                     for k in ("w", "b")} for layer in m.params]
        p._stats = m._stats
        out.append(p)
    return out


def test_dnn_apply_and_stacked_apply_on_carried_weights():
    X, Y = _data()
    ref = R.fit_dnn_multi(X, Y, epochs=3, batch_size=32, seed=2)
    port = _carried(ref)
    Xq = _data(n=13, seed=5)[0]
    for a, b in zip(ref, port):
        got = b.predict(Xq)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, a.predict(Xq), rtol=1e-5)
    # stacked: heads gathered by index on the device, (groups, rows) out
    params, mu, sd, ys = R.stack_dnn_heads(ref)
    tparams, tmu, tsd, tys = P.stack_dnn_heads(port, device="cpu")
    np.testing.assert_array_equal(tmu, mu)
    np.testing.assert_array_equal(tys, ys)
    rng = np.random.default_rng(3)
    block = rng.normal(size=(4, 8, X.shape[1])).astype(np.float32)
    gidx = np.array([1, 0, 1, 1])
    want = np.asarray(R._mlp_apply_multi()(params, gidx.astype(np.int32),
                                           block))
    got = P.mlp_apply_multi(tparams, torch.from_numpy(gidx),
                            torch.from_numpy(block)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_fit_dnn_multi_tracks_reference_from_its_init():
    X, Y = _data()
    seed, epochs = 3, 4
    ref = R.fit_dnn_multi(X, Y, epochs=epochs, batch_size=32, seed=seed)
    init = [{k: np.array(v) for k, v in layer.items()}
            for layer in R._mlp_init(seed, X.shape[1], R.DNNRegressor.LAYERS)]
    port = P.fit_dnn_multi(X, Y, epochs=epochs, batch_size=32, seed=seed,
                           device="cpu", init_params=init)
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(b._stats[0], a._stats[0])
        assert b._stats[2] == a._stats[2]
        for la, lb, l0 in zip(a.params, b.params, init):
            # training moved the weights away from the shared init ...
            assert not np.allclose(np.asarray(la["w"]), l0["w"])
            for k in ("w", "b"):
                wa = np.asarray(la[k])
                # ... and the two trainers moved them together
                np.testing.assert_allclose(lb[k].numpy(), wa, rtol=0,
                                           atol=1e-5 * np.abs(wa).max())


def test_port_own_init_is_he_normal_and_seeded():
    a = P._mlp_init(7, 33, P.DNNRegressor.LAYERS, device="cpu")
    b = P._mlp_init(7, 33, P.DNNRegressor.LAYERS, device="cpu")
    for la, lb in zip(a, b):
        assert torch.equal(la["w"], lb["w"])
        assert not la["b"].any()
    std = a[0]["w"].std().item()
    assert abs(std - np.sqrt(2.0 / 33)) < 0.1 * np.sqrt(2.0 / 33)
