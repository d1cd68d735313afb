"""The port's shard plane (``repro_torch.serve.shard``), twin of
``tests/test_shard.py``: group-axis bank splits, scatter/gather bit-identity,
row-order reassembly under shuffled completion, mid-wave worker death (typed
per-slice errors, pump survives, degraded fallback), epoch-consistent
generation swaps, the all-or-nothing load contract, and TCP workers, all on
``device="cpu"``. The oracles are the reference's, carried into the port;
where a test holds the port's sharded answers to the unsharded bank it also
holds them to the reference plane's answers on the same wave.

Tolerance: float64-only members, so every comparison is bitwise."""
import threading
import time

import numpy as np
import pytest

from repro.serve import ShardPlane as RefShardPlane
from repro.serve import WorkerServer as RefWorkerServer
from repro_torch import api
from repro_torch.api import planner
from repro_torch.api.types import PartialExecutionError, ShardExecutionError
from repro_torch.core.predictor import ProfetConfig
from repro_torch.serve import (BackgroundServer, Client, FaultInjector,
                               FaultPlan, FaultRule, LatencyService,
                               ShardPlane, WorkerDeadError,
                               WorkerServer, launch_tcp_workers,
                               synthetic_requests)
from repro_torch.serve import faults

from _torch_state import carry_oracle

# float64-only members: sharded answers must be bit-identical
CFG = ProfetConfig(members=("linear", "forest"), n_trees=15, seed=0)
DEVICES = ("T4", "V100", "K80")
MODELS = ("LeNet5", "AlexNet", "ResNet18")


@pytest.fixture(scope="module")
def ref_oracles():
    from repro import api as ref_api
    from repro.core import workloads as ref_workloads
    from repro.core.predictor import ProfetConfig as RefConfig
    ds = ref_workloads.generate(devices=DEVICES, models=MODELS)
    return tuple(ref_api.LatencyOracle.fit(
        ds, RefConfig(members=("linear", "forest"), n_trees=15, seed=seed))
        for seed in (0, 7))


@pytest.fixture(scope="module")
def ref_oracle(ref_oracles):
    return ref_oracles[0]


@pytest.fixture(scope="module")
def oracle(ref_oracle):
    return carry_oracle(ref_oracle)


@pytest.fixture(scope="module")
def fresh_oracle(ref_oracles):
    return carry_oracle(ref_oracles[1])


@pytest.fixture(scope="module")
def stream(oracle):
    return synthetic_requests(oracle, n=120, seed=3)


def _ref_plane_execute(ref_oracle, X, gids, **plane_kw):
    """The reference plane's answer to the same wave (thread workers
    unless ``plane_kw`` says otherwise)."""
    plane_kw.setdefault("workers", 3)
    plane_kw.setdefault("mode", "thread")
    with RefShardPlane(**plane_kw) as plane:
        return plane.load(ref_oracle.bank).execute(X, gids)


def _wave_inputs(oracle, n_rows=40, seed=0):
    """A (X, gids) wave touching every group of the bank."""
    bank = oracle.bank
    rng = np.random.default_rng(seed)
    cases = oracle.dataset.cases
    gids = np.concatenate([np.arange(len(bank.pairs)),
                           rng.integers(0, len(bank.pairs),
                                        n_rows - len(bank.pairs))])
    X = np.stack([oracle.feature_matrix(
        bank.pairs[g][0], [cases[rng.integers(len(cases))]])[0]
        for g in gids])
    return X, gids.astype(np.int64)


# ---------------------------------------------------------------------------
# partitioning + split
# ---------------------------------------------------------------------------


def test_partition_pairs_deterministic_and_balanced(oracle):
    pairs = oracle.bank.pairs
    for n in (1, 2, 3, 4, len(pairs), len(pairs) + 3):
        parts = planner.partition_pairs(pairs, n)
        assert parts == planner.partition_pairs(list(pairs), n)
        flat = [p for part in parts for p in part]
        assert sorted(flat) == sorted(pairs)          # exact cover
        sizes = [len(part) for part in parts]
        assert max(sizes) - min(sizes) <= 1           # balanced
        for s, part in enumerate(parts):              # routing agrees
            for p in part:
                assert planner.shard_of_pair(p, pairs, n) == s
    with pytest.raises(ValueError):
        planner.partition_pairs(pairs, 0)
    with pytest.raises(api.UnknownDeviceError):
        planner.shard_of_pair(("T4", "TPUv9"), pairs, 2)


def test_bank_split_bit_identity(oracle, ref_oracle):
    bank = oracle.bank
    parts = planner.partition_pairs(bank.pairs, 3)
    subs = bank.split(parts)
    X, gids = _wave_inputs(oracle)
    want = bank.execute(X, gids)
    np.testing.assert_array_equal(want, ref_oracle.bank.execute(X, gids))
    for part, sub in zip(parts, subs):
        assert sub is not None
        for j, pair in enumerate(part):
            rows = np.nonzero(gids == bank.gid[pair])[0]
            if not len(rows):
                continue
            got = sub.execute(X[rows], np.full(len(rows), j, np.int64))
            np.testing.assert_array_equal(got, want[rows])


def test_bank_split_empty_and_unknown(oracle):
    bank = oracle.bank
    n = len(bank.pairs)
    subs = bank.split(planner.partition_pairs(bank.pairs, n + 2))
    assert sum(s is None for s in subs) == 2          # empty shards
    from repro_torch.api.bank import BankUnsupportedError
    with pytest.raises(BankUnsupportedError):
        bank.split(((("T4", "TPUv9"),),))


# ---------------------------------------------------------------------------
# scatter/gather
# ---------------------------------------------------------------------------


def test_sharded_execute_bit_identical_thread(oracle, ref_oracle):
    X, gids = _wave_inputs(oracle, n_rows=64, seed=1)
    want = oracle.bank.execute(X, gids)
    with ShardPlane(workers=3, mode="thread") as plane:
        sharded = plane.load(oracle.bank)
        got = sharded.execute(X, gids)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, _ref_plane_execute(ref_oracle, X, gids))
        assert plane.slices == 3
        lw = sharded.last_wave
        assert lw["rows"] == 64 and set(lw["busy_s"]) == {0, 1, 2}


def test_row_order_reassembly_under_shuffled_completion(oracle):
    """Shards finishing out of submission order must still land every
    prediction on its own row: the earliest-submitted shard is forced to
    finish last (and vice versa) via the thread-worker delay hook."""
    X, gids = _wave_inputs(oracle, n_rows=60, seed=2)
    want = oracle.bank.execute(X, gids)
    with ShardPlane(workers=3, mode="thread") as plane:
        for w, d in zip(plane.workers, (0.15, 0.05, 0.0)):
            w.delay_s = d                      # completion order reversed
        sharded = plane.load(oracle.bank)
        np.testing.assert_array_equal(sharded.execute(X, gids), want)


def test_spawn_plane_bit_identical(oracle, ref_oracle):
    """Real processes + shared-memory segments (the production mode)."""
    X, gids = _wave_inputs(oracle, n_rows=48, seed=4)
    want = oracle.bank.execute(X, gids)
    np.testing.assert_array_equal(
        want, _ref_plane_execute(ref_oracle, X, gids, workers=2))
    with ShardPlane(workers=2, mode="spawn") as plane:
        sharded = plane.load(oracle.bank)
        np.testing.assert_array_equal(sharded.execute(X, gids), want)
        np.testing.assert_array_equal(sharded.execute(X, gids), want)
        assert plane.slices == 4
        plane.retire(sharded)
        assert plane.summary()["generations"] == []


# ---------------------------------------------------------------------------
# worker death: partial waves, typed errors, degraded fallback
# ---------------------------------------------------------------------------


def test_worker_death_mid_wave_fails_only_its_slice(oracle):
    X, gids = _wave_inputs(oracle, n_rows=50, seed=5)
    want = oracle.bank.execute(X, gids)
    with ShardPlane(workers=2, mode="thread") as plane:
        victim = plane.workers[1]
        victim.delay_s = 0.3                  # alive-check runs post-delay
        sharded = plane.load(oracle.bank)
        killer = threading.Timer(0.05, victim.kill)
        killer.start()
        with pytest.raises(PartialExecutionError) as ei:
            sharded.execute(X, gids)
        killer.join()
        dead_rows = np.isin(gids, [oracle.bank.gid[p]
                                   for p in sharded.partition[1]])
        # exactly the dead shard's rows failed; the rest already answered
        np.testing.assert_array_equal(ei.value.failed_rows, dead_rows)
        np.testing.assert_array_equal(ei.value.preds[~dead_rows],
                                      want[~dead_rows])
        assert plane.breaker.state(("shard", 1)) == "open"
        # next wave: dead shard serves parent-side, bit-identical
        np.testing.assert_array_equal(sharded.execute(X, gids), want)
        assert plane.fallback_rows == int(dead_rows.sum())
        assert plane.alive_workers() == 1


def test_service_slice_error_typed_and_pump_survives(oracle, stream):
    plane = ShardPlane(workers=2, mode="thread")
    svc = LatencyService(oracle, max_wave=64, shard_plane=plane)
    try:
        victim = plane.workers[0]
        victim.delay_s = 0.3
        srs = [svc.submit(r) for r in stream[:40]]
        killer = threading.Timer(0.05, victim.kill)
        killer.start()
        svc.run()
        killer.join()
        dead_pairs = set(svc._shard_gen.partition[0])
        died = [sr for sr in srs if sr.error is not None]
        assert died and all(isinstance(sr.error, ShardExecutionError)
                            for sr in died)
        # every errored request rides the dead shard; survivors answered
        for sr in srs:
            if sr.error is None:
                assert sr.result is not None
        assert svc.stats.shard_slice_errors == len(died)
        # the pump survives: the same stream resubmitted now succeeds
        # through the degraded parent-side fallback, bit-identically
        want = {i: r.latency_ms
                for i, r in enumerate(oracle.predict_many(stream[:40]))}
        redo = [svc.submit(r) for r in stream[:40]]
        svc.run()
        for i, sr in enumerate(redo):
            assert sr.error is None
            assert sr.result.latency_ms == want[i]
        assert svc.stats.shard_fallback_rows > 0
        assert dead_pairs  # sanity: shard 0 actually owned pairs
    finally:
        plane.close()


def test_transport_slice_error_is_typed_500(oracle):
    """Over HTTP: a mid-wave worker death turns into a 500
    ShardExecutionError for the riding requests only — the connection,
    the wave pump, and every other slice keep working."""
    plane = ShardPlane(workers=2, mode="thread")
    svc = LatencyService(oracle, max_wave=32, shard_plane=plane)
    bg = BackgroundServer(svc, host="127.0.0.1", port=0).start()
    try:
        part = svc._shard_gen.partition
        dead_pair, live_pair = part[1][0], part[0][0]
        case = oracle.dataset.cases[0]
        mk = lambda p: {"anchor": p[0], "target": p[1],
                        "workload": {"model": case[0], "batch": case[1],
                                     "pix": case[2]}}
        victim = plane.workers[1]
        victim.delay_s = 0.4
        with Client(bg.host, bg.port) as c:
            killer = threading.Timer(0.1, victim.kill)
            c.send_pipelined("POST", "/predict", mk(dead_pair), tag="dead")
            c.send_pipelined("POST", "/predict", mk(live_pair), tag="live")
            killer.start()
            got = {tag: (status, payload)
                   for tag, status, payload in c.drain()}
            killer.join()
            assert got["live"][0] == 200, got["live"]
            assert got["dead"][0] == 500, got["dead"]
            assert got["dead"][1]["error"]["type"] == "ShardExecutionError"
            # pump + connection survive: retry serves via fallback
            out = c.predict(api.PredictRequest(
                dead_pair[0], dead_pair[1], api.Workload.from_case(case)))
            assert out["latency_ms"] == oracle.predict(api.PredictRequest(
                dead_pair[0], dead_pair[1],
                api.Workload.from_case(case))).latency_ms
    finally:
        bg.stop()
        plane.close()


# ---------------------------------------------------------------------------
# generations: epoch-consistent swaps, all-or-nothing loads
# ---------------------------------------------------------------------------


def test_swap_defers_drop_until_inflight_waves_drain(oracle, fresh_oracle):
    plane = ShardPlane(workers=2, mode="thread")
    svc = LatencyService(oracle, max_wave=32, shard_plane=plane)
    try:
        gen1 = svc._shard_gen
        plane.acquire(gen1)                    # an in-flight wave's ref
        svc.oracle_refreshed(fresh_oracle, "e2")
        gen2 = svc._shard_gen
        assert gen2 is not gen1 and gen2.gen_id != gen1.gen_id
        # old generation retired but NOT dropped while the wave holds it
        assert sorted(plane.summary()["generations"]) == \
            [gen1.gen_id, gen2.gen_id]
        plane.release(gen1)                    # wave drains -> drop
        assert plane.summary()["generations"] == [gen2.gen_id]
        # a straggler wave that raced the retire still answers, parent-side
        X, gids = _wave_inputs(oracle, n_rows=20, seed=6)
        np.testing.assert_array_equal(gen1.execute(X, gids),
                                      oracle.bank.execute(X, gids))
    finally:
        plane.close()


def test_no_wave_mixes_epochs_across_swap(oracle, fresh_oracle, stream):
    """Hammer submits/waves from one thread while the main thread swaps
    oracles: every response's (epoch, value) must agree with exactly one
    oracle — no wave may blend shards from two generations."""
    plane = ShardPlane(workers=2, mode="thread")
    svc = LatencyService(oracle, max_wave=16, cache_size=0,
                         shard_plane=plane)
    want = {}
    for orc, tag in ((oracle, "e1"), (fresh_oracle, "e2")):
        for i, res in enumerate(orc.predict_many(stream[:48])):
            want[(tag, i)] = res.latency_ms
    results = []
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            srs = [(i, svc.submit(r)) for i, r in enumerate(stream[:48])]
            svc.run()
            results.extend(srs)

    # the service may uniquify reused labels: map actual epoch -> oracle tag
    epoch_tag = {svc.oracle_refreshed(oracle, "e1"): "e1"}
    t = threading.Thread(target=pump)
    t.start()
    try:
        for k in range(4):
            time.sleep(0.05)
            orc, tag = ((fresh_oracle, "e2") if k % 2 == 0
                        else (oracle, "e1"))
            epoch_tag[svc.oracle_refreshed(orc, f"{tag}.{k}")] = tag
    finally:
        stop.set()
        t.join()
        plane.close()
    assert len(results) >= 96
    for i, sr in results:
        assert sr.error is None
        tag = epoch_tag[sr.result.epoch]
        assert sr.result.latency_ms == want[(tag, i)], (i, tag)


def test_load_failure_aborts_swap_all_or_nothing(oracle, fresh_oracle):
    plane = ShardPlane(workers=2, mode="thread")
    svc = LatencyService(oracle, max_wave=32, shard_plane=plane)
    try:
        gen1 = svc._shard_gen
        epoch1 = svc.epoch
        plane.workers[1].fail_loads = 1
        with pytest.raises(RuntimeError, match="injected load failure"):
            svc.oracle_refreshed(fresh_oracle, "e2")
        # incumbent intact: same epoch, same generation, still sharded
        assert svc.epoch == epoch1 and svc._shard_gen is gen1
        assert plane.summary()["generations"] == [gen1.gen_id]
        srs = [svc.submit(r) for r in synthetic_requests(oracle, n=8,
                                                         seed=9)]
        svc.run()
        assert all(sr.error is None for sr in srs)
        # next swap (no injected failure) succeeds
        svc.oracle_refreshed(fresh_oracle, "e2")
        assert svc._shard_gen is not gen1
    finally:
        plane.close()


def test_plane_construction_failure_degrades_not_crashes(oracle):
    plane = ShardPlane(workers=2, mode="thread")
    for w in plane.workers:
        w.fail_loads = 1
    try:
        svc = LatencyService(oracle, max_wave=32, shard_plane=plane)
        assert svc._shard_gen is None
        assert svc.stats.degraded is True
        srs = [svc.submit(r) for r in synthetic_requests(oracle, n=8,
                                                         seed=10)]
        svc.run()                              # serves unsharded
        assert all(sr.error is None for sr in srs)
    finally:
        plane.close()


# ---------------------------------------------------------------------------
# TCP workers: remote bank distribution over the framed socket protocol
# ---------------------------------------------------------------------------


def _fault_server(*rules, seed=0, **kw):
    return WorkerServer(faults=FaultInjector(FaultPlan(rules=tuple(rules),
                                                       seed=seed)),
                        device="cpu", **kw)


def test_tcp_plane_bit_identical(oracle, ref_oracle):
    """Remote-only and mixed local+remote planes answer bit-identically
    to the single-worker banked path — the shard's float64 tensors ride
    the wire as raw bytes, so the bytes ARE the bytes — and to the
    reference's TCP plane."""
    X, gids = _wave_inputs(oracle, n_rows=64, seed=11)
    want = oracle.bank.execute(X, gids)
    with RefWorkerServer() as r0, RefWorkerServer() as r1:
        np.testing.assert_array_equal(want, _ref_plane_execute(
            ref_oracle, X, gids, workers=0,
            remote=[r0.address, r1.address]))
    with WorkerServer(device="cpu") as s0, WorkerServer(device="cpu") as s1:
        with ShardPlane(workers=0, mode="thread",
                        remote=[s0.address, s1.address]) as plane:
            assert plane.summary()["worker_kinds"] == ["tcp", "tcp"]
            sharded = plane.load(oracle.bank)
            np.testing.assert_array_equal(sharded.execute(X, gids), want)
            assert s0.execs + s1.execs == 2
        with ShardPlane(workers=1, mode="thread",
                        remote=[s0.address]) as plane:
            sharded = plane.load(oracle.bank)
            np.testing.assert_array_equal(sharded.execute(X, gids), want)
            assert plane.summary()["worker_kinds"] == ["thread", "tcp"]


def test_tcp_connection_reset_mid_wave_fails_only_riding_rows(oracle):
    """An injected RST on the exec reply (hit 1: hit 0 is the load) kills
    exactly that shard's slice: typed partial failure, breaker
    force-open, later waves bit-identical through the parent fallback."""
    X, gids = _wave_inputs(oracle, n_rows=50, seed=12)
    want = oracle.bank.execute(X, gids)
    with WorkerServer(device="cpu") as s0, \
            _fault_server(FaultRule(site=faults.SITE_SHARD_RESET,
                                    kind="error", at=(1,))) as s1:
        with ShardPlane(workers=0, mode="thread",
                        remote=[s0.address, s1.address]) as plane:
            sharded = plane.load(oracle.bank)
            with pytest.raises(PartialExecutionError) as ei:
                sharded.execute(X, gids)
            dead_rows = np.isin(gids, [oracle.bank.gid[p]
                                       for p in sharded.partition[1]])
            np.testing.assert_array_equal(ei.value.failed_rows, dead_rows)
            np.testing.assert_array_equal(ei.value.preds[~dead_rows],
                                          want[~dead_rows])
            assert plane.breaker.state(("shard", 1)) == "open"
            assert plane.alive_workers() == 1
            np.testing.assert_array_equal(sharded.execute(X, gids), want)
            assert plane.fallback_rows == int(dead_rows.sum())


def test_tcp_truncated_frame_fault_is_worker_death(oracle):
    """A reply cut mid-frame (then RST) must never decode into a wrong
    answer — the parent sees unusable bytes and declares the worker
    dead."""
    X, gids = _wave_inputs(oracle, n_rows=40, seed=13)
    want = oracle.bank.execute(X, gids)
    with WorkerServer(device="cpu") as s0, \
            _fault_server(FaultRule(site=faults.SITE_SHARD_FRAME,
                                    kind="drop", at=(1,))) as s1:
        with ShardPlane(workers=0, mode="thread",
                        remote=[s0.address, s1.address]) as plane:
            sharded = plane.load(oracle.bank)
            with pytest.raises(PartialExecutionError):
                sharded.execute(X, gids)
            assert not plane.workers[1].alive
            np.testing.assert_array_equal(sharded.execute(X, gids), want)


def test_tcp_slow_peer_times_out_and_degrades(oracle):
    """A peer that stalls past io_timeout_s is dead to the parent — a
    late reply could pair with the wrong request, so the connection is
    abandoned, the rows fail typed, and the shard falls back."""
    X, gids = _wave_inputs(oracle, n_rows=40, seed=14)
    want = oracle.bank.execute(X, gids)
    with WorkerServer(device="cpu") as s0, \
            _fault_server(FaultRule(site=faults.SITE_SHARD_SLOW,
                                    kind="delay", delay_s=2.0,
                                    at=(1,))) as s1:
        with ShardPlane(workers=0, mode="thread",
                        remote=[s0.address, s1.address],
                        io_timeout_s=0.4) as plane:
            sharded = plane.load(oracle.bank)
            t0 = time.perf_counter()
            with pytest.raises(PartialExecutionError):
                sharded.execute(X, gids)
            assert time.perf_counter() - t0 < 1.5   # timed out, not 2 s
            assert not plane.workers[1].alive
            np.testing.assert_array_equal(sharded.execute(X, gids), want)


def test_tcp_remote_load_failure_aborts_swap_all_or_nothing(
        oracle, fresh_oracle):
    """A remote worker that fails the generation load rejects the whole
    swap: the incumbent generation keeps serving every shard."""
    X, gids = _wave_inputs(oracle, n_rows=30, seed=15)
    want = oracle.bank.execute(X, gids)
    with WorkerServer(device="cpu") as s0, \
            _fault_server(FaultRule(site=faults.SITE_SHARD_RESET,
                                    kind="error", at=(1,))) as s1:
        with ShardPlane(workers=0, mode="thread",
                        remote=[s0.address, s1.address]) as plane:
            gen1 = plane.load(oracle.bank)
            with pytest.raises(WorkerDeadError):
                plane.load(fresh_oracle.bank)   # hit 1 on s1: reset
            # all-or-nothing: only the incumbent generation exists, and
            # it still answers (dead shard parent-side, bit-identical)
            assert plane.summary()["generations"] == [gen1.gen_id]
            np.testing.assert_array_equal(gen1.execute(X, gids), want)


def test_tcp_no_mixed_epochs_under_socket_faults(oracle, fresh_oracle,
                                                 stream):
    """The zero-mixed-epoch invariant, now with remote workers AND
    rate-injected socket chaos (resets + stalls): every answered request
    matches exactly one oracle's bit-exact prediction, and failures are
    typed slice errors — never a blended or stale value."""
    s0 = _fault_server(
        FaultRule(site=faults.SITE_SHARD_RESET, kind="error", rate=0.03),
        FaultRule(site=faults.SITE_SHARD_SLOW, kind="delay",
                  delay_s=0.02, rate=0.2), seed=42)
    s1 = _fault_server(
        FaultRule(site=faults.SITE_SHARD_FRAME, kind="drop", rate=0.03),
        seed=7)
    plane = ShardPlane(workers=1, mode="thread",
                       remote=[s0.address, s1.address], io_timeout_s=5.0)
    svc = LatencyService(oracle, max_wave=16, cache_size=0,
                         shard_plane=plane)
    want = {}
    for orc, tag in ((oracle, "e1"), (fresh_oracle, "e2")):
        for i, res in enumerate(orc.predict_many(stream[:32])):
            want[(tag, i)] = res.latency_ms
    epoch_tag = {svc.epoch: "e1"}
    results = []
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            srs = [(i, svc.submit(r)) for i, r in enumerate(stream[:32])]
            svc.run()
            results.extend(srs)

    t = threading.Thread(target=pump)
    t.start()
    try:
        for k in range(4):
            time.sleep(0.08)
            orc, tag = ((fresh_oracle, "e2") if k % 2 == 0
                        else (oracle, "e1"))
            try:
                epoch_tag[svc.oracle_refreshed(orc, f"{tag}.{k}")] = tag
            except (WorkerDeadError, RuntimeError):
                pass        # swap rejected whole: incumbent must serve on
    finally:
        stop.set()
        t.join()
        plane.close()
        s0.close()
        s1.close()
    assert len(results) >= 64
    answered = 0
    for i, sr in results:
        if sr.error is not None:
            assert isinstance(sr.error, ShardExecutionError), sr.error
            continue
        answered += 1
        tag = epoch_tag[sr.result.epoch]
        assert sr.result.latency_ms == want[(tag, i)], (i, tag)
    assert answered >= 32


def test_tcp_subprocess_workers_end_to_end(oracle):
    """The real multi-host topology on loopback: shard_worker
    subprocesses, generation distribution over the wire, a hard process
    kill mid-service, typed containment, and fallback bit-identity."""
    X, gids = _wave_inputs(oracle, n_rows=48, seed=16)
    want = oracle.bank.execute(X, gids)
    with launch_tcp_workers(2, device="cpu") as pool:
        with ShardPlane(workers=0, mode="thread",
                        remote=pool.addresses) as plane:
            assert all(p.poll() is None for p in pool.procs)
            sharded = plane.load(oracle.bank)
            np.testing.assert_array_equal(sharded.execute(X, gids), want)
            pool.kill(1)                    # SIGKILL the worker process
            pool.procs[1].wait(timeout=5.0)
            with pytest.raises(PartialExecutionError) as ei:
                sharded.execute(X, gids)
            dead_rows = np.isin(gids, [oracle.bank.gid[p]
                                       for p in sharded.partition[1]])
            np.testing.assert_array_equal(ei.value.failed_rows, dead_rows)
            np.testing.assert_array_equal(sharded.execute(X, gids), want)
            assert plane.alive_workers() == 1


def test_http_replay_over_tcp_workers(oracle, stream):
    """Full stack: HTTP transport -> wave service -> TCP shard plane.
    Every replayed answer must equal the unsharded oracle's, under the
    served epoch."""
    with WorkerServer(device="cpu") as s0, WorkerServer(device="cpu") as s1:
        plane = ShardPlane(workers=0, mode="thread",
                           remote=[s0.address, s1.address])
        svc = LatencyService(oracle, max_wave=32, shard_plane=plane)
        bg = BackgroundServer(svc, host="127.0.0.1", port=0).start()
        try:
            want = [r.latency_ms for r in oracle.predict_many(stream[:40])]
            with Client(bg.host, bg.port) as c:
                for i, req in enumerate(stream[:40]):
                    got = c.predict(req)
                    assert got["latency_ms"] == want[i]
                    assert got["epoch"] == svc.epoch
                h = c.healthz()
                assert h["status"] == "ok"
        finally:
            bg.stop()
            plane.close()


# ---------------------------------------------------------------------------
# the port's own: wire payloads, devices, the DNN member
# ---------------------------------------------------------------------------


def test_payload_round_trip_matches_the_reference_payload(oracle,
                                                          ref_oracle):
    """``to_payload`` carries host copies of the stacked tensors (the same
    arrays as the reference's payload, ``device`` where it has
    ``backend``); through the wire codec and ``from_payload`` the bank
    answers bitwise."""
    from repro_torch.serve import frames
    bank = oracle.bank
    d = bank.to_payload()
    ref = ref_oracle.bank.to_payload()
    assert d["device"] == "cpu" and "backend" not in d
    for k in ("feat", "thr", "left", "right", "value", "depth"):
        assert isinstance(d["forest"][k], np.ndarray)
        assert d["forest"][k].flags.c_contiguous
        np.testing.assert_array_equal(d["forest"][k], ref["forest"][k])
        assert d["forest"][k].dtype == np.asarray(ref["forest"][k]).dtype
    np.testing.assert_array_equal(d["lin_coef"], ref["lin_coef"])
    assert [tuple(p) for p in d["pairs"]] == [tuple(p) for p in ref["pairs"]]
    for pack, unpack in frames.CODECS.values():
        back = api.ModelBank.from_payload(unpack(pack(d)), device="cpu")
        assert back.device.type == "cpu" and back.pairs == bank.pairs
        X, gids = _wave_inputs(oracle, n_rows=32, seed=20)
        np.testing.assert_array_equal(back.execute(X, gids),
                                      bank.execute(X, gids))


def test_split_gathers_on_the_bank_device(oracle):
    bank = oracle.bank
    subs = bank.split(planner.partition_pairs(bank.pairs, 2))
    for part, sub in zip(planner.partition_pairs(bank.pairs, 2), subs):
        idx = [bank.gid[p] for p in part]
        assert sub.device == bank.device
        for k, v in sub.forest.items():
            assert v.device == bank.device
            np.testing.assert_array_equal(v.numpy(),
                                          bank.forest[k].numpy()[idx])
        assert sub.scalers is bank.scalers and sub.devices == bank.devices


def test_cuda_asked_without_cuda_raises(oracle):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        WorkerServer()
    with pytest.raises(RuntimeError, match="cuda"):
        api.ModelBank.from_payload(oracle.bank.to_payload())
    with pytest.raises(RuntimeError, match="cuda"):
        launch_tcp_workers(1)


def test_sharded_with_dnn_member_within_bar(ref_oracle):
    """With the float32 DNN member a sub-bank runs the stacked MLP over
    fewer groups; the float64 members stay bitwise and the answers hold
    to rtol 1e-5."""
    from repro import api as ref_api
    from repro.core.predictor import ProfetConfig as RefConfig
    ref = ref_api.LatencyOracle.fit(ref_oracle.dataset, RefConfig(
        members=("linear", "forest", "dnn"), n_trees=8, dnn_epochs=4,
        seed=0))
    oracle = carry_oracle(ref)
    X, gids = _wave_inputs(oracle, n_rows=48, seed=21)
    want = oracle.bank.execute(X, gids)
    with ShardPlane(workers=2, mode="thread") as plane:
        got = plane.load(oracle.bank).execute(X, gids)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, ref.bank.execute(X, gids), rtol=1e-5)


def test_every_worker_kind_reports_stats(oracle):
    """The port's ``stats`` op: each worker kind reports its pid and the
    forest launch counts of its process (zero on the CPU: plain versions
    count none)."""
    import os
    X, gids = _wave_inputs(oracle, n_rows=24, seed=22)
    with launch_tcp_workers(1, device="cpu") as pool:
        with ShardPlane(workers=1, mode="spawn",
                        remote=pool.addresses) as plane:
            sharded = plane.load(oracle.bank)
            sharded.execute(X, gids)
            spawn, tcp = (w.stats() for w in plane.workers)
            assert spawn["pid"] == plane.workers[0]._proc.pid != os.getpid()
            assert tcp["pid"] == pool.procs[0].pid
            for st in (spawn, tcp):
                assert st["launches"]["predict_grouped"] == 0
                assert "cuda_memory_allocated" not in st
    with ShardPlane(workers=1, mode="thread") as plane:
        plane.load(oracle.bank)
        assert plane.workers[0].stats()["pid"] == os.getpid()
