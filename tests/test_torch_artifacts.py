"""The port's artifact store and ``api`` surface
(``repro_torch.api.artifacts``, ``repro_torch.api``) against the reference
``repro.api``: a reference oracle carried into the port on the CPU, saved
and loaded through the port's envelope, answers bitwise as before and as
the reference does; a fingerprint mismatch, a wrong schema, a corrupt file
and an artifact the reference wrote each raise their typed error, and the
last imports neither ``repro`` nor ``jax``.

Tolerances: the linear and forest members are float64 and compute the same
operations in the same order in both packages, so answers are bitwise
equal. A reload on the same device holds the float32 DNN heads' exact bits
and runs the same products, so with the DNN member the round trip is
bitwise too; against the reference the DNN member's bar is rtol 1e-5.
"""
import dataclasses
import json
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

from repro import api as ref_api
from repro.core.predictor import ProfetConfig as RefConfig
from repro_torch import api
from repro_torch.core import workloads
from repro_torch.core.predictor import ProfetConfig
from repro_torch.serve import synthetic_requests

from _torch_state import (SMALL_DEVICES, SMALL_MODELS, carry_oracle,
                          fit_small_repro)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# fast plumbing config of tests/test_api.py: float64 members only
MEMBERS = ("linear", "forest")
CFG = ProfetConfig(members=MEMBERS, n_trees=8, dnn_epochs=4, seed=0)
CFG_ALL = dataclasses.replace(CFG, members=("linear", "forest", "dnn"))


@pytest.fixture(scope="module")
def ref():
    return {m: fit_small_repro(m) for m in (MEMBERS, CFG_ALL.members)}


@pytest.fixture(scope="module")
def oracle(ref):
    return carry_oracle(ref[MEMBERS])


@pytest.fixture(scope="module")
def stream(oracle):
    return synthetic_requests(oracle, n=60, seed=2)


def _lat(oracle, reqs):
    return oracle.predict_many(reqs).latencies()


# ---------------------------------------------------------------------------
# the api surface
# ---------------------------------------------------------------------------


def test_api_exports_the_reference_surface():
    assert sorted(api.__all__) == sorted(ref_api.__all__)
    for name in api.__all__:
        assert hasattr(api, name), name
    assert issubclass(api.SchemaVersionError, api.ArtifactError)
    assert issubclass(api.FingerprintMismatchError, api.ArtifactError)
    assert issubclass(api.ArtifactError, api.ApiError)


def test_config_and_calibration_fingerprints_match_the_reference():
    for cfg in (CFG, CFG_ALL, ProfetConfig()):
        rcfg = RefConfig(**dataclasses.asdict(cfg))
        assert api.config_fingerprint(cfg) == \
            ref_api.config_fingerprint(rcfg)
        pairs = [("T4", "V100"), ("V100", "T4")]
        assert api.calibration_fingerprint(cfg, pairs, 17) == \
            ref_api.calibration_fingerprint(rcfg, pairs, 17)


def test_cross_and_measured_modes_match_the_reference(ref, oracle):
    ro = ref[MEMBERS]
    for c in oracle.dataset.cases[:6]:
        w, rw = api.Workload.from_case(c), ref_api.Workload.from_case(c)
        for target in ("V100", "T4"):
            got = oracle.predict(api.PredictRequest("T4", target, w))
            want = ro.predict(ref_api.PredictRequest("T4", target, rw))
            assert got.mode == want.mode
            assert got.latency_ms == want.latency_ms
            assert got.cost_usd(3600) == want.cost_usd(3600)
        legacy = oracle.profet.predict_cross(
            "T4", "V100", oracle.dataset.profile("T4", c), c)
        assert oracle.predict(api.PredictRequest(
            "T4", "V100", w)).latency_ms == pytest.approx(legacy, rel=1e-12)


def test_grid_matches_the_reference_and_is_strict_json(ref, oracle):
    req = api.GridRequest("T4", "AlexNet", ("T4", "V100"),
                          tuple(workloads.BATCHES) + (999,),
                          tuple(workloads.PIXELS))
    rreq = ref_api.GridRequest(*dataclasses.astuple(req))
    got = oracle.predict_grid(req).latency_ms
    want = ref[MEMBERS].predict_grid(rreq).latency_ms
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[:, -1]).all()

    def no_nan(_):
        raise AssertionError("bare NaN token in JSON")
    out = json.loads(json.dumps(oracle.predict_grid(req).to_dict()),
                     parse_constant=no_nan)
    assert out["latency_ms"][0][-1][0] is None


def test_unknown_pair_and_anchor_raise_helpful_errors(oracle):
    w = api.Workload.from_case(oracle.dataset.cases[0])
    with pytest.raises(api.UnknownDeviceError, match="trained anchors"):
        oracle.predict(api.PredictRequest("T4", "TPUv4", w))
    with pytest.raises(api.UnknownDeviceError, match="available"):
        oracle.predict(api.PredictRequest("H100", "H100", w))


# ---------------------------------------------------------------------------
# artifacts: round trips
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("members", [MEMBERS, CFG_ALL.members],
                         ids=["float64", "with-dnn"])
def test_save_load_round_trip_is_bitwise(ref, members, stream, tmp_path):
    port = carry_oracle(ref[members])
    path = tmp_path / "oracle.pkl"
    manifest = api.save(port, path)
    assert manifest["magic"] == "profet-oracle-torch"
    assert manifest["schema_version"] == 1
    assert manifest["forest_format"] == "packed-arrays"
    assert manifest["fingerprint"] == api.config_fingerprint(port.config)
    assert manifest["pairs"] == [list(p) for p in port.pairs()]
    assert not path.with_name(path.name + ".tmp").exists()

    loaded = api.load(path, expect_config=port.config, device="cpu")
    assert loaded.config == port.config
    assert loaded.pairs() == port.pairs()
    assert loaded.dataset == port.dataset
    np.testing.assert_array_equal(_lat(loaded, stream), _lat(port, stream))
    # and against the reference on the same requests
    rreqs = [ref_api.PredictRequest(
        r.anchor, r.target, ref_api.Workload(*r.workload.case),
        mode=r.mode, knob=r.knob) for r in stream]
    want = ref[members].predict_many(rreqs).latencies()
    if members == MEMBERS:
        np.testing.assert_array_equal(_lat(loaded, stream), want)
    else:
        np.testing.assert_allclose(_lat(loaded, stream), want, rtol=1e-5)


def test_artifact_holds_no_tensor_and_no_device(oracle, tmp_path):
    """The envelope is state, not objects: no torch name in the pickle
    stream, so a file written on one device loads on another."""
    path = tmp_path / "oracle.pkl"
    api.save(oracle, path)

    class Names(pickle.Unpickler):
        seen = set()

        def find_class(self, module, name):
            self.seen.add(module.split(".")[0])
            return super().find_class(module, name)
    with open(path, "rb") as f:
        env = Names(f).load()
    assert Names.seen <= {"numpy"}, Names.seen
    assert set(env["payload"]) == {"profet", "dataset"}
    assert b"cuda" not in path.read_bytes()


def test_fit_or_load_loads_matching_and_refits_on_mismatch(oracle,
                                                           tmp_path):
    path = tmp_path / "oracle.pkl"
    calls = []

    def fit():
        calls.append(1)
        return oracle
    first = api.fit_or_load(path, oracle.config, fit_fn=fit, device="cpu")
    assert calls == [1] and first is oracle and path.exists()
    again = api.fit_or_load(path, oracle.config, fit_fn=fit, device="cpu")
    assert calls == [1] and again is not oracle
    reqs = synthetic_requests(oracle, n=20, seed=5)
    np.testing.assert_array_equal(_lat(again, reqs), _lat(oracle, reqs))
    api.fit_or_load(path, dataclasses.replace(oracle.config, seed=9),
                    fit_fn=fit, device="cpu")
    assert calls == [1, 1]


def test_fit_or_load_fits_on_the_device_it_is_given(tmp_path):
    ds = workloads.generate(devices=SMALL_DEVICES, models=SMALL_MODELS[:2])
    path = tmp_path / "oracle.pkl"
    o = api.fit_or_load(path, CFG, device="cpu", dataset=ds)
    assert o.profet.device.type == "cpu" and path.exists()
    assert api.load(path, expect_config=CFG, device="cpu").pairs() == \
        o.pairs()


def test_load_on_cuda_without_cuda_raises(oracle, tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    path = tmp_path / "oracle.pkl"
    api.save(oracle, path)
    with pytest.raises(RuntimeError, match="cuda"):
        api.load(path)


# ---------------------------------------------------------------------------
# artifacts: typed rejections
# ---------------------------------------------------------------------------


def test_fingerprint_mismatch_raises(oracle, tmp_path):
    path = tmp_path / "oracle.pkl"
    api.save(oracle, path)
    for stale in (dataclasses.replace(oracle.config, seed=123),
                  dataclasses.replace(oracle.config, dnn_epochs=7)):
        with pytest.raises(api.FingerprintMismatchError):
            api.load(path, expect_config=stale, device="cpu")


def test_wrong_schema_raises(oracle, tmp_path):
    path = tmp_path / "oracle.pkl"
    api.save(oracle, path)
    with open(path, "rb") as f:
        env = pickle.load(f)
    for version in (999, 0, None):
        env["schema_version"] = version
        with open(path, "wb") as f:
            pickle.dump(env, f)
        with pytest.raises(api.SchemaVersionError, match="refit"):
            api.load(path, device="cpu")


def test_corrupt_missing_and_foreign_files_raise(oracle, tmp_path):
    path = tmp_path / "oracle.pkl"
    api.save(oracle, path)
    blob = path.read_bytes()
    path.write_bytes(blob[:len(blob) // 2])          # truncated
    with pytest.raises(api.ArtifactError, match="unreadable"):
        api.load(path, device="cpu")
    path.write_bytes(b"not a pickle at all")
    with pytest.raises(api.ArtifactError):
        api.load(path, device="cpu")
    with pytest.raises(api.ArtifactError, match="no artifact"):
        api.load(tmp_path / "missing.pkl", device="cpu")
    with open(path, "wb") as f:                      # legacy bare tuple
        pickle.dump(("profet", {"cases": []}), f)
    with pytest.raises(api.ArtifactError, match="not a profet-oracle"):
        api.load(path, device="cpu")
    with open(path, "wb") as f:                      # a global it refuses
        pickle.dump({"magic": "profet-oracle-torch", "x": os.getcwd}, f)
    with pytest.raises(api.ArtifactError, match="not loaded"):
        api.load(path, device="cpu")


def test_non_packed_forest_member_raises(oracle, tmp_path):
    path = tmp_path / "oracle.pkl"
    api.save(oracle, path)
    with open(path, "rb") as f:
        env = pickle.load(f)
    del env["payload"]["profet"]["pairs"][0]["forest"]["value"]
    with open(path, "wb") as f:
        pickle.dump(env, f)
    with pytest.raises(api.ArtifactError, match="non-packed forest"):
        api.load(path, device="cpu")


def test_reference_artifact_raises_and_imports_neither_repro_nor_jax(
        ref, tmp_path):
    """An artifact the reference wrote names ``repro.*`` classes; loading
    it raises ArtifactError, and (in a fresh process) leaves ``repro`` and
    ``jax`` out of ``sys.modules``."""
    path = tmp_path / "ref.pkl"
    ref_api.save(ref[MEMBERS], path)
    with pytest.raises(api.ArtifactError, match="repro"):
        api.load(path, device="cpu")
    code = (
        "import json, sys\n"
        "from repro_torch import api\n"
        "try:\n"
        f"    api.load({str(path)!r}, device='cpu')\n"
        "    err = None\n"
        "except api.ArtifactError as e:\n"
        "    err = type(e).__name__\n"
        "print(json.dumps([err, sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith('jax.') or m == 'repro' or "
        "m.startswith('repro.'))]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == \
        ["ArtifactError", []]


# ---------------------------------------------------------------------------
# crash-safe calibration persistence
# ---------------------------------------------------------------------------


def test_calibration_store_promote_rollback_recover(oracle, tmp_path):
    store = api.artifacts.CalibrationStore(tmp_path / "cal")
    assert store.recover(device="cpu") is None
    e1 = api.calibration_fingerprint(oracle.config, oracle.pairs(), 10)
    e2 = api.calibration_fingerprint(oracle.config, oracle.pairs(), 20)
    assert e1 != e2 and "+cal" in e1
    store.record_promotion(oracle, e1)
    store.record_promotion(oracle, e2)
    got, epoch = store.recover(expect_config=oracle.config, device="cpu")
    assert epoch == e2
    reqs = synthetic_requests(oracle, n=16, seed=8)
    np.testing.assert_array_equal(_lat(got, reqs), _lat(oracle, reqs))
    assert store.record_rollback(e2) and not store.record_rollback(e2)
    assert store.latest()["epoch"] == e1
    assert store.recover(device="cpu")[1] == e1
    # an entry of another config is skipped, not fatal
    stale = dataclasses.replace(oracle.config, seed=99)
    assert store.recover(expect_config=stale, device="cpu") is None
