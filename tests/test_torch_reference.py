"""The port's frozen fit path (``repro_torch.core.reference``) against the
reference's (``repro.core.reference``), and the port's vectorized grower
against the port's recursive oracle.

Tolerances and why:
  - ``ReferenceForest``, the linear member, the phase-2 scalers and the
    per-group answers of a reference-fit oracle: the same numpy code on the
    host in both packages, so bitwise equal;
  - the vectorized grower against the recursive oracle: on random normal
    features the same splits, and leaf values that are the same weighted
    means summed in another order, so predictions within rtol 1e-12 (the
    reference's own bar, ``tests/test_fit_path.py``); on the paper grid's
    features the same up to exact SSE ties, which the two resolve apart
    (``chip_smoke.tie_walk``);
  - ``fit_dnn_sequential`` from the reference's initial weights: every step
    rounds its float32 sums in another order, so the trained weights stay
    within 1e-5 of each layer's largest weight (the bar of
    ``tests/test_torch_regressors.py``).
"""
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.core import reference as R
from repro.core import regressors as RR
from repro.core.predictor import ProfetConfig as RefConfig
from repro.serve import synthetic_requests as ref_requests
from repro.api.planner import request_fingerprint as ref_fingerprint
from repro.core import workloads as ref_workloads
from repro_torch import api
from repro_torch.api.artifacts import ArtifactError
from repro_torch.api.bank import BankUnsupportedError, ModelBank
from repro_torch.api.planner import request_fingerprint
from repro_torch.convert import profet_from_numpy, profet_to_numpy
from repro_torch.core import reference as P
from repro_torch.core import regressors as PR
from repro_torch.core.predictor import ProfetConfig
from repro_torch.core.regressors import LegacyForestError
from repro_torch.kernels import forest_eval
from repro_torch.serve import synthetic_requests

from _torch_state import dataset_from_repro, small_dataset

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _forest_data(n=90, d=6, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = np.sin(X[:, 0] * 2) + X[:, 1] ** 2 + 0.1 * rng.normal(size=n)
    return X, y, rng.normal(size=(40, d))


def _nodes(forest):
    return [[(n.feature, n.threshold, n.left, n.right, n.value) for n in t]
            for t in forest.trees_]


@pytest.mark.parametrize("bootstrap", ["weights", "rows"])
@pytest.mark.parametrize("max_depth", [4, 24])
def test_reference_forest_bitwise_repro(bootstrap, max_depth):
    X, y, Xq = _forest_data()
    kw = dict(n_estimators=6, max_depth=max_depth, seed=2,
              bootstrap=bootstrap)
    a = R.ReferenceForest(**kw).fit(X, y)
    b = P.ReferenceForest(**kw).fit(X, y)
    assert _nodes(b) == _nodes(a)
    assert b.split_multiset() == a.split_multiset()
    for Z in (X, Xq):
        np.testing.assert_array_equal(b.predict(Z), a.predict(Z))


@pytest.mark.parametrize("max_depth,seed", [(4, 5), (24, 1)])
def test_grower_matches_recursive_reference(max_depth, seed):
    """The twin of ``tests/test_fit_path.py``'s: the port's grower against
    the port's recursive oracle, predictions through the plain version of
    the forest kernel (CPU tensors)."""
    X, y, Xq = _forest_data()
    rf = PR.RandomForestRegressor(n_estimators=6, max_depth=max_depth,
                                  seed=seed, device="cpu").fit(X, y)
    ref = P.ReferenceForest(n_estimators=6, max_depth=max_depth,
                            seed=seed).fit(X, y)
    f = rf.forest_
    assert [int(c) for c in f.n_nodes] == [len(t) for t in ref.trees_]
    for t in range(f.n_trees):
        mine = sorted((int(f.feat[t, i]), float(f.thr[t, i]))
                      for i in range(f.n_nodes[t]) if f.feat[t, i] >= 0)
        assert mine == ref.split_multiset()[t]
    forest_eval.reset_launches()
    for Z in (X, Xq):
        np.testing.assert_allclose(rf.predict(Z), ref.predict(Z),
                                   rtol=1e-12, atol=1e-12)
    assert forest_eval.plain_calls["predict"] == 2
    assert not any(forest_eval.launches.values())


def _dnn_data(n=70, d=9, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    return X, np.abs(X[:, 0]) * 3 + X[:, 1] ** 2 + 1


def test_fit_dnn_sequential_tracks_reference_from_its_init():
    """n = 70 at batch 32: two minibatches an epoch, 6 rows dropped."""
    X, y = _dnn_data()
    seed, epochs = 3, 4
    ref = R.fit_dnn_sequential(X, y, epochs=epochs, batch_size=32,
                               seed=seed)
    init = [{k: np.array(v) for k, v in layer.items()}
            for layer in RR._mlp_init(seed, X.shape[1],
                                      RR.DNNRegressor.LAYERS)]
    port = P.fit_dnn_sequential(X, y, epochs=epochs, batch_size=32,
                                seed=seed, device="cpu", init_params=init)
    assert isinstance(port, PR.DNNRegressor) and port.device.type == "cpu"
    np.testing.assert_array_equal(port._stats[0], ref._stats[0])
    np.testing.assert_array_equal(port._stats[1], ref._stats[1])
    assert port._stats[2] == ref._stats[2]
    for la, lb, l0 in zip(ref.params, port.params, init):
        assert not np.allclose(np.asarray(la["w"]), l0["w"])
        for k in ("w", "b"):
            wa = np.asarray(la[k])
            np.testing.assert_allclose(lb[k].numpy(), wa, rtol=0,
                                       atol=1e-5 * np.abs(wa).max())
    # the seeded init draws the port's own numbers, from the same seed
    own = P.fit_dnn_sequential(X, y, epochs=1, batch_size=32, seed=seed,
                               device="cpu")
    again = P.fit_dnn_sequential(X, y, epochs=1, batch_size=32, seed=seed,
                                 device="cpu")
    for la, lb in zip(own.params, again.params):
        assert torch.equal(la["w"], lb["w"])


def test_fit_dnn_sequential_asks_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the CPU-only error cannot show")
    X, y = _dnn_data()
    with pytest.raises(RuntimeError, match="cuda"):
        P.fit_dnn_sequential(X, y, epochs=1)
    with pytest.raises(RuntimeError, match="cuda"):
        P.fit_profet_reference(small_dataset(), ProfetConfig(
            members=("linear",)))


LINEAR_FOREST = ("linear", "forest")


@pytest.fixture(scope="module")
def small_fits():
    """``fit_profet_reference`` with linear and forest members on the small
    grid, in both packages."""
    ds = small_dataset()
    kw = dict(members=LINEAR_FOREST, n_trees=8, seed=0)
    ref = R.fit_profet_reference(ds, RefConfig(**kw))
    port = P.fit_profet_reference(dataset_from_repro(ds), ProfetConfig(**kw),
                                  device="cpu")
    return ds, ref, port


def test_fit_profet_reference_bitwise_repro(small_fits):
    ds, ref, port = small_fits
    assert sorted(port.cross) == sorted(ref.cross)
    for (ga, gt) in sorted(ref.cross):
        X = ref.feature_matrix([ds.profile(ga, c) for c in ds.cases],
                               ds.cases)
        np.testing.assert_array_equal(
            port.feature_matrix([ds.profile(ga, c) for c in ds.cases],
                                ds.cases), X)
        assert isinstance(port.cross[(ga, gt)].models["forest"],
                          P.ReferenceForest)
        np.testing.assert_array_equal(port.predict_cross_matrix(ga, gt, X),
                                      ref.predict_cross_matrix(ga, gt, X))
    for kind in ("batch_scalers", "pixel_scalers"):
        a, b = getattr(ref, kind), getattr(port, kind)
        assert sorted(a) == sorted(b)
        for d in a:
            np.testing.assert_array_equal(b[d].coef, a[d].coef)
            assert (b[d].min_knob, b[d].max_knob, b[d].min_range) == \
                (a[d].min_knob, a[d].max_knob, a[d].min_range)


def _lenet():
    ds = ref_workloads.generate(devices=("T4", "V100"), models=("LeNet5",))
    kw = dict(members=LINEAR_FOREST, n_trees=5, seed=0)
    ref = R.fit_profet_reference(ds, RefConfig(**kw))
    port_ds = dataset_from_repro(ds)
    port = P.fit_profet_reference(port_ds, ProfetConfig(**kw), device="cpu")
    return (ref_api.LatencyOracle(ref, ds),
            api.LatencyOracle(port, port_ds))


def test_unbankable_members_fall_back_per_group():
    """The twin of ``tests/test_bank.py``'s: the frozen reference models
    cannot stack, so the oracle serves one fused ensemble call per group,
    the forest walking on the host; its answers are the reference's."""
    ref_oracle, oracle = _lenet()
    with pytest.raises(BankUnsupportedError):
        ModelBank.build(oracle.profet)
    assert oracle.bank is None and oracle.bank_error is None
    req = api.PredictRequest("T4", "V100",
                             api.Workload.from_case(oracle.dataset.cases[0]))
    forest_eval.reset_launches()
    batch = oracle.predict_many([req])
    assert not batch.banked and batch.fused_calls == 1
    assert np.isfinite(batch.latencies()).all()

    rq = ref_requests(ref_oracle, n=80, seed=2)
    pq = synthetic_requests(oracle, n=80, seed=2)
    assert [ref_fingerprint(r) for r in rq] == \
        [request_fingerprint(r) for r in pq]
    got, want = oracle.predict_many(pq), ref_oracle.predict_many(rq)
    assert not got.banked and got.fused_calls == want.fused_calls == 2
    np.testing.assert_array_equal(got.latencies(), want.latencies())
    # no forest kernel, and no plain version of one, ran for these answers
    assert not any(forest_eval.launches.values())
    assert not any(forest_eval.plain_calls.values())


def test_reference_fit_artifact_saves_and_is_refused_on_load(tmp_path):
    """As in the reference: ``save`` writes the oracle, ``load`` refuses its
    non-packed forest with a typed ``ArtifactError``."""
    ref_oracle, oracle = _lenet()
    ref_api.save(ref_oracle, tmp_path / "ref.pkl")
    with pytest.raises(ref_api.ArtifactError,
                       match="non-packed forest member"):
        ref_api.load(tmp_path / "ref.pkl")
    manifest = api.save(oracle, tmp_path / "port.pkl")
    assert manifest["pairs"] == [["T4", "V100"], ["V100", "T4"]]
    with pytest.raises(ArtifactError, match="non-packed forest member"):
        api.load(tmp_path / "port.pkl", device="cpu")
    state = profet_to_numpy(oracle.profet)
    assert len(state["pairs"][0]["forest"]["node_lists"]) == 5
    with pytest.raises(LegacyForestError):
        profet_from_numpy(state, device="cpu")


def test_paper_grid_forest_differs_from_recursive_only_by_exact_ties():
    """Phase 19 (b)'s data on the CPU: pair (T4, V100) on the paper grid's
    260 training rows. On PROFET's features (co-monotone in pairs, many
    nodes splitting into pure children) the grower and the recursive oracle
    resolve SSE ties apart, in ``repro`` as in the port, so their
    ``(feature, threshold)`` multisets differ; ``chip_smoke.tie_walk``
    finds every difference an exact tie, and flags a split that is not
    one. The forest kernel's plain version on the oracle's own trees
    (``chip_smoke.pack_node_lists``) gives the recursive walk's answers."""
    from repro.core.predictor import Profet as RefProfet
    ds = ref_workloads.generate()
    train, test = ref_workloads.split_cases(ds.cases, test_frac=0.25, seed=0)
    p = RefProfet(RefConfig(seed=0))
    p._fit_features(ds, ["T4"], train)
    X = p.feature_matrix([ds.profile("T4", c) for c in train], train)
    Xt = p.feature_matrix([ds.profile("T4", c) for c in test], test)
    y = np.array([ds.latency("V100", c) for c in train])
    T = 8
    ref_rf = RR.RandomForestRegressor(n_estimators=T, seed=0).fit(X, y)
    ref_oracle = R.ReferenceForest(n_estimators=T, seed=0).fit(X, y)
    rf = PR.RandomForestRegressor(n_estimators=T, seed=0,
                                  device="cpu").fit(X, y)
    oracle = P.ReferenceForest(n_estimators=T, seed=0).fit(X, y)
    for k in ("feat", "thr", "left", "right", "value", "n_nodes"):
        np.testing.assert_array_equal(getattr(rf.forest_, k),
                                      getattr(ref_rf.forest_, k))
    assert _nodes(oracle) == _nodes(ref_oracle)

    def multisets(f):
        return [sorted((int(f.feat[t, i]), float(f.thr[t, i]))
                       for i in range(f.n_nodes[t]) if f.feat[t, i] >= 0)
                for t in range(f.n_trees)]

    assert multisets(ref_rf.forest_) != ref_oracle.split_multiset()
    W, _ = PR.bootstrap_plan(0, T, len(y))
    walk = chip_smoke.tie_walk(np, rf.forest_, oracle, W, X, y)
    assert walk["mismatched"] == 0 and walk["ties"] > 0
    assert walk["equal"] > walk["ties"] + walk["ties_same_rows"]
    assert walk["value_max_rel"] <= 1e-12
    # a threshold moved off a tie into another gap is caught
    bad = PR.PackedForest(**{k: np.copy(getattr(rf.forest_, k)) for k in (
        "feat", "thr", "left", "right", "value", "n_nodes")},
        depth=rf.forest_.depth)
    col = X[:, bad.feat[0, 0]]
    bad.thr[0, 0] = np.sort(col)[len(col) // 4]
    assert chip_smoke.tie_walk(np, bad, oracle, W, X, y)["mismatched"] > 0

    packed = chip_smoke.pack_node_lists(torch, oracle.trees_,
                                        torch.device("cpu"))
    assert packed[5] == max(_depth(t) for t in oracle.trees_)
    for Z in (X, Xt):
        got = forest_eval.predict(torch.from_numpy(Z), *packed[:5],
                                  depth=packed[5]).numpy()
        np.testing.assert_allclose(got, oracle.predict(Z), rtol=1e-12,
                                   atol=1e-12)


def _depth(tree, i=0):
    nd = tree[i]
    if nd.feature < 0:
        return 0
    return 1 + max(_depth(tree, nd.left), _depth(tree, nd.right))
