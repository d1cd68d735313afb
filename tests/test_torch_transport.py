"""The port's HTTP transport (``repro_torch.serve.transport``), twin of
``tests/test_transport.py``: concurrent clients on a real socket, typed
error responses (malformed payloads, per-request ApiErrors, bounded-queue
overload), the epoch-keyed cache, a mid-traffic ``oracle_refreshed`` swap
with zero stale-epoch responses, and the columnar and binary ``/measure``
codecs — over the reference's oracles carried into the port on the CPU.
Each package's ``Client`` talks to the other's ``TransportServer`` on
loopback and both give the same answers.

The ``/measure`` and ``measured_ms`` ingest paths are held to the
reference twice: with a recording stand-in calibrator that takes every row
(the rows it receives equal what the same bytes give the reference's
server), and with each package's real ``Calibrator`` (the same
``(accepted, dropped)`` counts and the same ``/statsz`` calibration block).

Tolerance: float64 members, so answers over the socket equal the
in-process answers (rel 1e-9 as in the reference's twin; the JSON float
round trip is exact)."""
import json
import socket
import threading
import time

import numpy as np
import pytest

from repro_torch import api
from repro_torch.core import workloads
from repro_torch.serve import (BackgroundServer, Client, LatencyService,
                               TransportError, replay, synthetic_requests)
from repro_torch.serve import transport

from _torch_state import carry_oracle


def _ref_oracle(seed):
    from repro import api as ref_api
    from repro.core import workloads as ref_workloads
    from repro.core.predictor import ProfetConfig as RefConfig
    ds = ref_workloads.generate(devices=("T4", "V100"),
                                models=("LeNet5", "AlexNet", "ResNet18"))
    return ref_api.LatencyOracle.fit(
        ds, RefConfig(members=("linear", "forest"), n_trees=15, seed=seed))


@pytest.fixture(scope="module")
def ref_oracle():
    return _ref_oracle(0)


@pytest.fixture(scope="module")
def oracle(ref_oracle):
    return carry_oracle(ref_oracle)


@pytest.fixture(scope="module")
def oracle2():
    """A refreshed-model stand-in: same data, different seed — predictions
    differ from ``oracle`` on (almost) every request."""
    return carry_oracle(_ref_oracle(7))


@pytest.fixture(scope="module")
def dataset(oracle):
    return oracle.dataset


@pytest.fixture(scope="module")
def stream(oracle):
    return synthetic_requests(oracle, n=96, seed=3)


@pytest.fixture()
def server(oracle):
    svc = LatencyService(oracle, max_wave=32)
    bg = BackgroundServer(svc, batch_window_s=0.0).start()
    yield bg
    bg.stop()


def _client(bg):
    return Client(bg.host, bg.port, timeout=30)


# ---------------------------------------------------------------------------
# health + stats + basic round trip
# ---------------------------------------------------------------------------


def test_healthz_statsz(server, oracle):
    with _client(server) as c:
        h = c.healthz()
        assert h["status"] == "ok"
        assert h["epoch"] == server.server.service.epoch
        assert h["pairs"] == len(oracle.pairs())
        s = c.statsz()
        assert s["stats"]["epoch"] == h["epoch"]
        assert {"requests", "waves", "fused_calls", "cache_hits",
                "epoch_swaps", "overloads"} <= set(s["stats"])


def test_predict_round_trip(server, oracle, stream):
    want = oracle.predict(stream[0])
    with _client(server) as c:
        got = c.predict(stream[0])
    assert got["latency_ms"] == pytest.approx(want.latency_ms, rel=1e-9)
    assert got["mode"] == want.mode
    assert got["target"] == want.target
    assert got["price_hr"] == want.price_hr
    assert got["epoch"] == server.server.service.epoch


def test_concurrent_clients_complete_and_correct(server, oracle, stream):
    direct = oracle.predict_many(stream)
    rep = replay(server.host, server.port, stream, clients=8)
    assert rep["ok"] == len(stream) and not rep["errors"]
    np.testing.assert_allclose(
        [r["latency_ms"] for r in rep["results"]], direct.latencies(),
        rtol=1e-9)
    assert [r["mode"] for r in rep["results"]] == \
        [r.mode for r in direct.results]
    stats = server.server.service.stats
    assert stats.requests == len(stream)
    assert stats.errors == 0


def test_paused_admissions_fuse_into_deterministic_waves(server, oracle,
                                                         stream):
    """pause -> concurrent fire -> resume: the whole burst drains in
    ceil(n / max_wave) fused waves, proving wave admission (not
    per-request round-trips) answers concurrent traffic."""
    server.server.pause()
    rep_out = {}

    # one request per client: every request is in flight (and parked in
    # the service queue) before the pump is resumed
    def fire():
        rep_out.update(replay(server.host, server.port, stream[:64],
                              clients=64))

    t = threading.Thread(target=fire)
    t.start()
    svc = server.server.service
    deadline = time.time() + 10
    while svc.pending() < 64 and time.time() < deadline:
        time.sleep(0.005)
    assert svc.pending() == 64
    server.server.resume()
    t.join(timeout=30)
    assert not t.is_alive() and rep_out["ok"] == 64
    assert svc.stats.waves == 2          # ceil(64 / max_wave=32)
    direct = oracle.predict_many(stream[:64])
    np.testing.assert_allclose(
        [r["latency_ms"] for r in rep_out["results"]], direct.latencies(),
        rtol=1e-9)


# ---------------------------------------------------------------------------
# typed error responses
# ---------------------------------------------------------------------------


def test_malformed_payload_typed_error_keeps_connection(server, stream):
    with _client(server) as c:
        status, out = c.request("POST", "/predict")       # no body at all
        assert status == 400
        assert out["error"]["type"] == "MalformedRequestError"
        # raw non-JSON body
        status, out = c.request("POST", "/predict", payload="not an object")
        assert status == 400
        assert out["error"]["type"] == "MalformedRequestError"
        # missing fields
        status, out = c.request("POST", "/predict", payload={"anchor": "T4"})
        assert status == 400
        assert out["error"]["type"] == "MalformedRequestError"
        # invalid workload values -> the api-level typed error
        status, out = c.request(
            "POST", "/predict",
            payload={"anchor": "T4", "target": "V100",
                     "workload": {"model": "LeNet5", "batch": 0, "pix": 32}})
        assert status == 400
        assert out["error"]["type"] == "InvalidWorkloadError"
        # ...and the SAME connection still answers a valid request
        res = c.predict(stream[0])
        assert np.isfinite(res["latency_ms"])


def test_raw_garbage_bytes_get_a_response(server):
    """Unparseable HTTP framing is answered (400 + typed payload) before
    the connection closes — never a silent drop."""
    with socket.create_connection((server.host, server.port),
                                  timeout=10) as s:
        s.sendall(b"this is not http\r\n\r\n")
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
        assert b"400" in buf.split(b"\r\n", 1)[0]
        assert b"MalformedRequestError" in buf + s.recv(65536)


def test_unknown_route_and_method(server):
    with _client(server) as c:
        status, out = c.request("GET", "/nope")
        assert status == 404 and out["error"]["type"] == "NotFound"
        status, out = c.request("PUT", "/predict", payload={})
        assert status == 405 and out["error"]["type"] == "MethodNotAllowed"
        status, out = c.request("POST", "/healthz")
        assert status == 405


def test_per_request_api_errors_are_typed(server, dataset, stream):
    w = api.Workload.from_case(dataset.cases[0])
    with _client(server) as c:
        with pytest.raises(TransportError) as ei:
            c.predict(api.PredictRequest("T4", "TPUv4", w))
        assert ei.value.status == 404
        assert ei.value.error_type == "UnknownDeviceError"
        # connection survives; service isolated the error
        res = c.predict(stream[0])
        assert np.isfinite(res["latency_ms"])
    assert server.server.service.stats.errors == 1


def test_bounded_queue_overload(oracle, stream):
    svc = LatencyService(oracle, max_wave=32)
    bg = BackgroundServer(svc, max_queue=8, batch_window_s=0.0).start()
    try:
        bg.server.pause()
        rep_out = {}

        def fire():
            rep_out.update(replay(bg.host, bg.port, stream[:12],
                                  clients=12))

        t = threading.Thread(target=fire)
        t.start()
        # 8 admitted + parked; 4 rejected immediately with the typed error
        deadline = time.time() + 10
        while ((svc.pending() < 8 or svc.stats.overloads < 4)
               and time.time() < deadline):
            time.sleep(0.005)
        assert svc.pending() == 8
        assert svc.stats.overloads == 4
        bg.server.resume()
        t.join(timeout=30)
        assert not t.is_alive()
        assert len(rep_out["errors"]) == 4
        assert {etype for _, etype in rep_out["errors"]} == \
            {"OverloadedError"}
        assert rep_out["ok"] == 8
        direct = {i: oracle.predict(stream[i]).latency_ms
                  for i in range(12)}
        for i, res in enumerate(rep_out["results"]):
            if res is not None:
                assert res["latency_ms"] == pytest.approx(direct[i],
                                                          rel=1e-9)
    finally:
        bg.stop()


def test_overload_status_code_is_503(oracle, stream):
    svc = LatencyService(oracle)
    bg = BackgroundServer(svc, max_queue=0).start()
    try:
        with Client(bg.host, bg.port) as c:
            status, out = c.request(
                "POST", "/predict",
                payload={"anchor": stream[0].anchor,
                         "target": stream[0].target,
                         "workload": {"model": stream[0].workload.model,
                                      "batch": stream[0].workload.batch,
                                      "pix": stream[0].workload.pix}})
            assert status == 503
            assert out["error"]["type"] == "OverloadedError"
    finally:
        bg.stop()


# ---------------------------------------------------------------------------
# grid + advise endpoints
# ---------------------------------------------------------------------------


def test_grid_endpoint_matches_in_process(server, oracle):
    req = api.GridRequest(anchor="T4", model="ResNet18",
                          targets=("T4",) + oracle.targets_from("T4"),
                          batches=tuple(workloads.BATCHES)[:3],
                          pixels=tuple(workloads.PIXELS)[:3])
    want = oracle.predict_grid(req)
    with _client(server) as c:
        out = c.grid(req)
    got = np.array([[[np.nan if v is None else v for v in row]
                     for row in plane]
                    for plane in out["grid"]["latency_ms"]])
    np.testing.assert_allclose(got, want.latency_ms, rtol=1e-9,
                               equal_nan=True)
    assert out["epochs"] == [server.server.service.epoch]


def test_advise_endpoint_matches_in_process(server, oracle, dataset):
    w = api.Workload.from_case(dataset.cases[0])
    want = oracle.advise("T4", w, measured_ms=12.5)
    with _client(server) as c:
        rows = c.advise({"anchor": "T4",
                         "workload": {"model": w.model, "batch": w.batch,
                                      "pix": w.pix},
                         "measured_ms": 12.5})
    assert [r["target"] for r in rows] == [r.target for r in want]
    np.testing.assert_allclose([r["latency_ms"] for r in rows],
                               [r.latency_ms for r in want], rtol=1e-9)
    assert rows[0]["mode"] == api.MODE_MEASURED


# ---------------------------------------------------------------------------
# cross-anchor admission (ANCHOR_ANY)
# ---------------------------------------------------------------------------


def test_anchor_any_routes_to_cheapest_anchor(server, oracle, dataset):
    # T4 ($0.526/hr) undercuts V100 ($3.06/hr); both hold the profile
    w = api.Workload.from_case(dataset.cases[0])
    want = oracle.predict(api.PredictRequest("T4", "V100", w))
    with _client(server) as c:
        got = c.predict(api.PredictRequest(api.ANCHOR_ANY, "V100", w))
    assert got["anchor"] == "T4"
    assert got["latency_ms"] == pytest.approx(want.latency_ms, rel=1e-9)
    assert server.server.service.stats.rerouted == 1


def test_anchor_any_with_client_profile_rejected(server, dataset):
    w = api.Workload.from_case(dataset.cases[0])
    with _client(server) as c:
        with pytest.raises(TransportError) as ei:
            c.predict(api.PredictRequest(api.ANCHOR_ANY, "V100", w,
                                         profile={"conv": 1.0}))
    assert ei.value.error_type == "UnsupportedRequestError"


# ---------------------------------------------------------------------------
# refresh-aware cache epochs
# ---------------------------------------------------------------------------


def test_epoch_swap_invalidates_cache_and_resets_hit_counter(oracle, oracle2,
                                                             stream):
    svc = LatencyService(oracle, max_wave=64)
    e1 = svc.epoch
    for r in stream[:32]:
        svc.submit(r)
    svc.run()
    for r in stream[:32]:
        svc.submit(r)
    svc.run()
    assert svc.stats.epoch_cache_hits == 32      # full replay from cache
    assert svc.stats.cache_hits == 32

    e2 = svc.oracle_refreshed(oracle2, "epoch-2")
    assert e2 == "epoch-2" and svc.epoch == "epoch-2" != e1
    assert svc.stats.epoch_swaps == 1
    assert svc.stats.invalidated > 0             # stale entries purged
    assert svc.stats.epoch_cache_hits == 0       # hit-rate reset observed
    assert svc.stats.epoch == "epoch-2"

    # the same replay now misses the cache and is answered by the NEW oracle
    subs = [svc.submit(r) for r in stream[:32]]
    svc.run()
    assert svc.stats.cache_hits == 32            # lifetime total unchanged
    want = oracle2.predict_many(stream[:32])
    for sr, w in zip(subs, want):
        assert sr.result.epoch == "epoch-2"
        assert sr.result.latency_ms == pytest.approx(w.latency_ms, rel=1e-9)


def test_same_config_refresh_still_bumps_epoch(oracle):
    svc = LatencyService(oracle)
    e1 = svc.epoch
    e2 = svc.oracle_refreshed(oracle)      # refit under an unchanged config
    assert e2 != e1
    assert svc.epoch == e2


def test_aba_epoch_labels_never_collide(oracle, oracle2):
    """v1 -> v2 -> v3 with the same fingerprint label: the third epoch must
    not equal the first, or an in-flight v1 wave could cache stale results
    under the live epoch."""
    svc = LatencyService(oracle, epoch="fp")
    seen = {svc.epoch}
    for nxt in (oracle2, oracle, oracle2):
        e = svc.oracle_refreshed(nxt, "fp")
        assert e not in seen
        seen.add(e)


def test_anchor_any_measured_mode_routes_to_target(oracle, dataset):
    """anchor='any' + mode='measured' must route to the target itself (the
    only anchor that can answer a measured request)."""
    w = api.Workload.from_case(dataset.cases[0])
    res = oracle.predict(api.PredictRequest(api.ANCHOR_ANY, "V100", w,
                                            mode=api.MODE_MEASURED))
    assert res.anchor == "V100" and res.mode == api.MODE_MEASURED


def test_oversized_sweep_is_permanent_422_not_503(server):
    with _client(server) as c:
        status, out = c.request(
            "POST", "/grid",
            payload={"anchor": "T4", "model": "LeNet5",
                     "targets": ["V100"],
                     "batches": list(workloads.BATCHES),
                     "pixels": list(workloads.PIXELS)})
        assert status == 200            # normal sweep fits
        server.server.max_queue = 4
        status, out = c.request(
            "POST", "/grid",
            payload={"anchor": "T4", "model": "LeNet5",
                     "targets": ["V100"],
                     "batches": list(workloads.BATCHES),
                     "pixels": list(workloads.PIXELS)})
        assert status == 422
        assert out["error"]["type"] == "UnsupportedRequestError"
        assert "split the sweep" in out["error"]["message"]


def test_over_limit_header_line_typed_400(server):
    """A header line past the StreamReader limit (64 KiB) is answered with
    the typed 400, not a silently dropped connection."""
    with socket.create_connection((server.host, server.port),
                                  timeout=10) as s:
        s.sendall(b"GET /healthz HTTP/1.1\r\nX-Huge: "
                  + b"a" * (1 << 17) + b"\r\n\r\n")
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
        assert b" 400 " in buf.split(b"\r\n", 1)[0]


def test_reused_explicit_fingerprint_still_invalidates(oracle, oracle2,
                                                       stream):
    """An operator reusing a deploy label must not leave the previous
    model's cache entries live under the new model."""
    svc = LatencyService(oracle)
    svc.oracle_refreshed(oracle, "v2")
    subs = [svc.submit(r) for r in stream[:8]]
    svc.run()
    svc.oracle_refreshed(oracle2, "v2")    # same label, different model
    assert svc.epoch != "v2"               # uniquified
    assert svc.stats.invalidated >= len({id(s.result) for s in subs}) > 0
    resubs = [svc.submit(r) for r in stream[:8]]
    svc.run()
    want = oracle2.predict_many(stream[:8])
    for sr, w in zip(resubs, want):
        assert sr.result.latency_ms == pytest.approx(w.latency_ms,
                                                     rel=1e-9)


def test_executor_failure_fails_wave_not_service(oracle, stream,
                                                 monkeypatch):
    """A non-ApiError escaping the fused executor fails that wave's
    requests with a typed 500 ExecutionError; the server keeps serving."""
    svc = LatencyService(oracle, cache_size=0)
    bg = BackgroundServer(svc, batch_window_s=0.0).start()
    try:
        real_execute = type(oracle).execute
        calls = {"n": 0}

        def flaky(self, plans, epoch=None, **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("simulated executor crash")
            return real_execute(self, plans, epoch=epoch, **kw)

        monkeypatch.setattr(type(oracle), "execute", flaky)
        with _client(bg) as c:
            with pytest.raises(TransportError) as ei:
                c.predict(stream[0])
            assert ei.value.status == 500
            assert ei.value.error_type == "ExecutionError"
            # same connection, next wave executes normally
            res = c.predict(stream[0])
            assert np.isfinite(res["latency_ms"])
        assert svc.stats.errors == 1
    finally:
        bg.stop()


def test_mid_traffic_swap_zero_stale_epoch_responses(oracle, oracle2,
                                                     stream):
    """The acceptance assertion: under live concurrent replay traffic, an
    ``oracle_refreshed`` swap yields ZERO stale-epoch responses — every
    response matches the oracle of the epoch it is stamped with, and every
    request sent after the swap returns is answered by the new epoch."""
    svc = LatencyService(oracle, max_wave=16, cache_size=0)  # no cache:
    # every response must come from a live execute on some oracle
    bg = BackgroundServer(svc, batch_window_s=0.0).start()
    try:
        e1, e2 = svc.epoch, "epoch-2"
        want1 = {i: r.latency_ms
                 for i, r in enumerate(oracle.predict_many(stream))}
        want2 = {i: r.latency_ms
                 for i, r in enumerate(oracle2.predict_many(stream))}

        swap_done = threading.Event()
        phase1 = {}

        def traffic():
            with Client(bg.host, bg.port) as c:
                for i, r in enumerate(stream):
                    phase1[i] = c.predict(r)
                    if i == len(stream) // 4:
                        svc.oracle_refreshed(oracle2, e2)
                        swap_done.set()

        threads = [threading.Thread(target=traffic) for _ in range(1)]
        # concurrent load alongside, recorded with send-ordering info
        post_swap = []
        lock = threading.Lock()

        def load():
            with Client(bg.host, bg.port) as c:
                for i, r in enumerate(stream):
                    sent_after = swap_done.is_set()
                    res = c.predict(r)
                    with lock:
                        post_swap.append((i, sent_after, res))

        threads += [threading.Thread(target=load) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)

        checked = stale = 0
        for i, _, res in post_swap + [(i, None, r)
                                      for i, r in phase1.items()]:
            if res["epoch"] == e1:
                assert res["latency_ms"] == pytest.approx(want1[i],
                                                          rel=1e-9)
            elif res["epoch"] == e2:
                assert res["latency_ms"] == pytest.approx(want2[i],
                                                          rel=1e-9)
            else:
                stale += 1
            checked += 1
        assert stale == 0 and checked == 4 * len(stream)
        # linearization: anything sent strictly after the swap returned is
        # answered by the new epoch
        for i, sent_after, res in post_swap:
            if sent_after:
                assert res["epoch"] == e2, \
                    f"stale epoch on post-swap request {i}"
        assert {r["epoch"] for r in phase1.values()} == {e1, e2}
        assert svc.stats.epoch_swaps == 1
    finally:
        bg.stop()


def test_serve_public_exports():
    from repro import serve as ref_serve
    from repro_torch import serve
    assert set(serve.__all__) == set(ref_serve.__all__)
    for name in serve.__all__:
        assert getattr(serve, name) is not None, name
    assert {"BackgroundServer", "Client", "TransportError",
            "TransportServer", "replay"} <= set(serve.__all__)
    assert {"ANCHOR_ANY", "MalformedRequestError",
            "OverloadedError"} <= set(api.__all__)


# ---------------------------------------------------------------------------
# /measure codecs over the wire (a recording stand-in calibrator)
# ---------------------------------------------------------------------------


class _RecordingCalibrator:
    """Takes every row the transport decodes; ``summary`` rides
    ``/statsz``."""

    def __init__(self):
        self.rows = []
        self.ingested = []

    def ingest_rows(self, rows):
        self.rows.extend(rows)
        return len(rows), 0

    def ingest(self, anchor, target, workload, measured):
        self.ingested.append((anchor, target, workload.case, measured))

    def summary(self):
        return {"observations": len(self.rows) + len(self.ingested)}


def _measure_rows(n=3, pair=("T4", "V100"), latency=12.0):
    return [{"anchor": pair[0], "target": pair[1], "model": "LeNet5",
             "batch": 4, "pix": 32, "latency_ms": latency + i,
             "predicted_ms": 10.0} for i in range(n)]


def test_measure_without_calibrator_is_422(server):
    with _client(server) as c:
        with pytest.raises(TransportError) as ei:
            c.measure(_measure_rows())
        assert ei.value.status == 422
        assert ei.value.error_type == "UnsupportedRequestError"


def test_measure_codecs_give_the_reference_bytes_and_rows():
    from repro.serve import transport as ref_transport
    rows = _measure_rows(5) + [dict(_measure_rows(1)[0], epoch="e1",
                                    predicted_ms=None)]
    cols = transport.measure_columnar_from_rows(rows)
    assert json.dumps(cols, sort_keys=True) == json.dumps(
        ref_transport.measure_columnar_from_rows(rows), sort_keys=True)
    assert transport.measure_rows_from_columnar(cols) == \
        ref_transport.measure_rows_from_columnar(cols)
    blob = transport.measure_binary_from_rows(rows)
    assert blob == ref_transport.measure_binary_from_rows(rows)
    assert transport.measure_rows_from_binary(blob) == \
        ref_transport.measure_rows_from_binary(blob)


@pytest.mark.parametrize("binary", [False, True], ids=["json", "pfc1"])
def test_measure_round_trip_reaches_the_calibrator(oracle, ref_oracle,
                                                   binary):
    """The same rows through each package's server (columnar JSON or the
    binary body) reach the attached calibrator identically; ragged
    columnar batches are malformed, and the calibrator's summary rides
    ``/statsz``."""
    from repro.serve import BackgroundServer as RefServer
    from repro.serve import LatencyService as RefService
    got = {}
    for name, svc_cls, srv_cls, orc in (
            ("port", LatencyService, BackgroundServer, oracle),
            ("ref", RefService, RefServer, ref_oracle)):
        cal = _RecordingCalibrator()
        bg = srv_cls(svc_cls(orc, max_wave=32), batch_window_s=0.0,
                     calibrator=cal).start()
        try:
            with Client(bg.host, bg.port) as c:
                if binary:       # the client's first choice
                    assert c.measure(_measure_rows(4)) == \
                        {"accepted": 4, "dropped": 0}
                else:
                    status, body = c.request(
                        "POST", "/measure",
                        transport.measure_columnar_from_rows(
                            _measure_rows(4)))
                    assert status == 200 and body["accepted"] == 4
                status, body = c.request(
                    "POST", "/measure",
                    {"anchor": ["T4"], "target": [], "model": ["LeNet5"],
                     "batch": [4], "pix": [32], "latency_ms": [9.0]})
                assert status == 400
                assert body["error"]["type"] == "MalformedRequestError"
                assert c.statsz()["calibration"] == {"observations": 4}
        finally:
            bg.stop()
        got[name] = cal.rows
    assert len(got["port"]) == 4 and got["port"] == got["ref"]


def test_advise_measured_ms_feeds_calibrator(oracle, dataset):
    cal = _RecordingCalibrator()
    svc = LatencyService(oracle, max_wave=32)
    bg = BackgroundServer(svc, batch_window_s=0.0, calibrator=cal).start()
    try:
        case = dataset.cases[0]
        with Client(bg.host, bg.port) as c:
            rows = c.advise({"anchor": "T4",
                             "workload": {"model": case[0],
                                          "batch": case[1],
                                          "pix": case[2]},
                             "measured_ms": 12.5})
            assert rows[0]["latency_ms"] == 12.5
        assert cal.ingested == [("T4", "T4", tuple(case), 12.5)]
    finally:
        bg.stop()


def test_replay_reports_measurements_columnar(oracle, dataset, stream):
    """The load generator's measure_fn path: measured latencies stream
    back through /measure in columnar batches and reach the calibrator,
    each echoing its prediction and epoch."""
    cal = _RecordingCalibrator()
    svc = LatencyService(oracle, max_wave=32)
    bg = BackgroundServer(svc, batch_window_s=0.0, calibrator=cal).start()
    try:
        def measure_fn(req, res):
            case = (res["workload"]["model"], res["workload"]["batch"],
                    res["workload"]["pix"])
            if case not in dataset.measurements.get(res["target"], {}):
                return None
            return dataset.latency(res["target"], case)

        rep = replay(bg.host, bg.port, stream, clients=4,
                     measure_fn=measure_fn, measure_every=8)
        assert rep["ok"] == len(stream)
        assert rep["measured"] > 0 and rep["measure_dropped"] == 0
        assert len(cal.rows) == rep["measured"]
        assert all(r["predicted_ms"] is not None for r in cal.rows)
        assert all(r["epoch"] == svc.epoch for r in cal.rows)
    finally:
        bg.stop()


# ---------------------------------------------------------------------------
# /measure and measured_ms into each package's real Calibrator
# ---------------------------------------------------------------------------


def _mixed_measure_rows(epoch):
    """Rows the calibrator takes and rows it drops: echoed predictions,
    an echoed epoch without a prediction (re-predicted when scored), a
    measured-mode pair, a pair the oracle cannot serve and a negative
    latency."""
    rows = _measure_rows(4)
    rows.append(dict(_measure_rows(1, latency=14.0)[0], predicted_ms=None,
                     epoch=epoch))
    rows.append(dict(_measure_rows(1)[0], target="T4"))
    rows.append(dict(_measure_rows(1)[0], target="TPUv9"))
    rows.append(dict(_measure_rows(1)[0], latency_ms=-3.0))
    return rows


def _real_calibrators(oracle, ref_oracle):
    from repro.calibrate import Calibrator as RefCalibrator
    from repro.serve import BackgroundServer as RefServer
    from repro.serve import LatencyService as RefService
    from repro_torch.calibrate import Calibrator
    return (("port", LatencyService, BackgroundServer, Calibrator, oracle),
            ("ref", RefService, RefServer, RefCalibrator, ref_oracle))


@pytest.mark.parametrize("binary", [False, True], ids=["json", "pfc1"])
def test_measure_into_the_real_calibrator_matches_the_reference(
        oracle, ref_oracle, binary):
    """The same bytes through each package's server into its own
    ``Calibrator``: the same ``(accepted, dropped)`` and, after one
    control step scores them, the same ``/statsz`` calibration block."""
    got = {}
    for name, svc_cls, srv_cls, cal_cls, orc in _real_calibrators(
            oracle, ref_oracle):
        svc = svc_cls(orc, max_wave=32)
        cal = cal_cls(svc)
        rows = _mixed_measure_rows(svc.epoch)
        bg = srv_cls(svc, batch_window_s=0.0, calibrator=cal).start()
        try:
            with Client(bg.host, bg.port) as c:
                if binary:
                    counts = c.measure(rows)
                else:
                    status, body = c.request(
                        "POST", "/measure",
                        transport.measure_columnar_from_rows(rows))
                    assert status == 200
                    counts = {k: body[k] for k in ("accepted", "dropped")}
                cal.step()
                got[name] = (counts, c.statsz()["calibration"])
        finally:
            bg.stop()
    assert got["port"] == got["ref"]
    counts, block = got["port"]
    assert counts == {"accepted": 6, "dropped": 2}
    assert block["observations"] == 6 and block["scored"] == 6
    assert block["buffered"] == 6 and block["dropped"] == 2
    assert set(block["rolling_mape"]) == {"T4->V100", "T4->T4"}


def test_advise_measured_ms_into_the_real_calibrator_matches_the_reference(
        oracle, ref_oracle, dataset):
    """An advise call carrying ``measured_ms`` feeds the anchor's own
    measurement to each package's ``Calibrator``; the ``/statsz``
    calibration blocks agree."""
    case = dataset.cases[0]
    got = {}
    for name, svc_cls, srv_cls, cal_cls, orc in _real_calibrators(
            oracle, ref_oracle):
        svc = svc_cls(orc, max_wave=32)
        cal = cal_cls(svc)
        bg = srv_cls(svc, batch_window_s=0.0, calibrator=cal).start()
        try:
            with Client(bg.host, bg.port) as c:
                rows = c.advise({"anchor": "T4",
                                 "workload": {"model": case[0],
                                              "batch": case[1],
                                              "pix": case[2]},
                                 "measured_ms": 12.5})
                assert rows[0]["latency_ms"] == 12.5
                cal.step()
                got[name] = c.statsz()["calibration"]
        finally:
            bg.stop()
    assert got["port"] == got["ref"]
    assert got["port"]["observations"] == 1
    assert got["port"]["scored"] == 1
    assert list(got["port"]["rolling_mape"]) == ["T4->T4"]


# ---------------------------------------------------------------------------
# interop: each package's Client against the other's server
# ---------------------------------------------------------------------------


def _serve_with(client_cls, server_cls, service_cls, orc, reqs):
    bg = server_cls(service_cls(orc, max_wave=32),
                    batch_window_s=0.0).start()
    try:
        with client_cls(bg.host, bg.port, timeout=30) as c:
            # plain dicts: each Client encodes only its own package's
            # request type
            out = [c.predict(transport.request_to_dict(r)) for r in reqs]
            grid = c.grid({"anchor": "T4", "model": "AlexNet",
                           "targets": ["T4", "V100"], "batches": [16, 64],
                           "pixels": [32, 64]})
            assert c.healthz()["status"] == "ok"
    finally:
        bg.stop()
    return out, grid


def test_port_client_and_reference_server_answer_each_other(
        oracle, ref_oracle, stream):
    """A ``repro_torch`` Client against a ``repro`` TransportServer, and
    a ``repro`` Client against a ``repro_torch`` TransportServer, on
    loopback: both answer, and the answers are equal."""
    from repro.serve import BackgroundServer as RefServer
    from repro.serve import Client as RefClient
    from repro.serve import LatencyService as RefService
    reqs = stream[:24]
    a, ga = _serve_with(Client, RefServer, RefService, ref_oracle, reqs)
    b, gb = _serve_with(RefClient, BackgroundServer, LatencyService, oracle,
                        reqs)
    for x, y in zip(a, b):
        assert x["latency_ms"] == y["latency_ms"]
        assert x["mode"] == y["mode"] and x["target"] == y["target"]
        assert x["price_hr"] == y["price_hr"]
    assert json.dumps(ga, sort_keys=True) == json.dumps(gb, sort_keys=True)
    np.testing.assert_array_equal(
        [r["latency_ms"] for r in b], oracle.predict_many(reqs).latencies())
