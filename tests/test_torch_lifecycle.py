"""The port's worker lifecycle supervision (``repro_torch.serve.lifecycle``),
twin of ``tests/test_lifecycle.py``: heartbeat leases (missed lease ->
suspect -> parent-side routing before a wave ever rides it), automatic
respawn/reconnect with deterministic fake-clock backoff, re-ship + adoption
preserving every invariant (no mixed epochs, bit-identity through the
recovery window, all-or-nothing swaps), authenticated HELLO rejection before
any load, and fd/shm/zombie leak regression over repeated kill/respawn
cycles — on ``device="cpu"``, with the reference's oracles carried into the
port. A recovered plane's answers are also held to the reference
supervisor's after the same kill.

Tolerance: float64-only members, so every comparison is bitwise."""
import os
import threading
import time

import numpy as np
import pytest

from repro_torch.api.types import PartialExecutionError
from repro_torch.serve import (BackgroundServer, FaultInjector, FaultPlan,
                               FaultRule, LatencyService, LifecycleConfig,
                               RetryPolicy, ShardPlane, WorkerAuthError,
                               WorkerServer, WorkerSupervisor,
                               launch_tcp_workers, replay,
                               synthetic_requests)
from repro_torch.serve import faults, lifecycle

from _torch_state import carry_oracle

#: deterministic backoff for fake-clock tests (no jitter, no sleep)
BACKOFF = RetryPolicy(max_attempts=2, base_s=0.05, multiplier=2.0,
                      max_backoff_s=0.2, jitter=0.0, seed=0)


@pytest.fixture(scope="module")
def ref_oracles():
    from repro import api as ref_api
    from repro.core import workloads as ref_workloads
    from repro.core.predictor import ProfetConfig as RefConfig
    ds = ref_workloads.generate(devices=("T4", "V100", "K80"),
                                models=("LeNet5", "AlexNet", "ResNet18"))
    return tuple(ref_api.LatencyOracle.fit(
        ds, RefConfig(members=("linear", "forest"), n_trees=15, seed=seed))
        for seed in (0, 7))


@pytest.fixture(scope="module")
def ref_oracle(ref_oracles):
    return ref_oracles[0]


@pytest.fixture(scope="module")
def oracle(ref_oracles):
    return carry_oracle(ref_oracles[0])


@pytest.fixture(scope="module")
def fresh_oracle(ref_oracles):
    return carry_oracle(ref_oracles[1])


def _wave_inputs(oracle, n_rows=40, seed=0):
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


def _supervisor(plane, *, rules=(), seed=0, clock=None, **cfg_kw):
    inj = (FaultInjector(FaultPlan(rules=tuple(rules), seed=seed))
           if rules else None)
    cfg = LifecycleConfig(backoff=BACKOFF, **cfg_kw)
    kw = {"config": cfg, "faults": inj}
    if clock is not None:
        kw["clock"] = clock
    return WorkerSupervisor(plane, **kw), inj


def _step_until(sup, pred, n=50, sleep_s=0.05):
    """Drive step() until ``pred()`` (real-clock recovery arcs)."""
    for _ in range(n):
        sup.step()
        if pred():
            return
        time.sleep(sleep_s)
    raise AssertionError("condition not reached after %d steps" % n)


# ---------------------------------------------------------------------------
# leases: missed ping -> suspect -> parent-side routing -> renewal
# ---------------------------------------------------------------------------


def test_missed_lease_marks_suspect_and_routes_parent_side(oracle):
    """One lost heartbeat makes the worker suspect: the NEXT wave serves
    its shard parent-side (bit-identically) without the wave ever riding
    the stale worker; a renewed lease restores worker-side routing."""
    X, gids = _wave_inputs(oracle, n_rows=40, seed=1)
    want = oracle.bank.execute(X, gids)
    with ShardPlane(workers=2, mode="thread") as plane:
        sharded = plane.load(oracle.bank)
        # site hits interleave workers: hit 0 is worker 0's first lease
        sup, _ = _supervisor(plane, rules=[FaultRule(
            site=faults.SITE_SHARD_LEASE, kind="error", at=(0,))])
        sup.step()
        assert plane.workers[0].suspect
        s = sup.summary()
        assert s["workers"][0]["state"] == lifecycle.SUSPECT
        assert s["workers"][0]["misses"] == 1
        assert s["workers"][1]["state"] == lifecycle.LIVE
        execs_before = plane.workers[0].execs
        np.testing.assert_array_equal(sharded.execute(X, gids), want)
        assert plane.workers[0].execs == execs_before   # never rode it
        assert plane.fallback_rows > 0
        # no further injected loss: the lease renews, routing restores
        sup.step()
        assert not plane.workers[0].suspect
        assert sup.summary()["workers"][0]["state"] == lifecycle.LIVE
        np.testing.assert_array_equal(sharded.execute(X, gids), want)
        assert plane.workers[0].execs == execs_before + 1


def test_lease_misses_escalate_to_kill_and_respawn(oracle):
    """``dead_after_misses`` consecutive lost leases declare the worker
    dead; recovery replaces it in the same supervision pass and the
    replacement serves bit-identically with a healed breaker."""
    X, gids = _wave_inputs(oracle, n_rows=36, seed=2)
    want = oracle.bank.execute(X, gids)
    with ShardPlane(workers=2, mode="thread") as plane:
        sharded = plane.load(oracle.bank)
        victim = plane.workers[0]
        # worker 0 leases on even site hits (workers interleave)
        sup, _ = _supervisor(plane, dead_after_misses=3, rules=[FaultRule(
            site=faults.SITE_SHARD_LEASE, kind="error", at=(0, 2, 4))])
        sup.step()
        sup.step()
        assert sup.summary()["workers"][0]["misses"] == 2
        assert victim.alive                      # suspect, not dead yet
        sup.step()                               # third miss: kill+respawn
        assert not victim.alive
        assert plane.workers[0] is not victim    # replaced, never revived
        assert plane.workers[0].alive
        assert sup.summary()["workers"][0]["state"] == lifecycle.ADOPTED
        assert sup.summary()["respawns"] == 1
        assert plane.adoptions == 1
        np.testing.assert_array_equal(sharded.execute(X, gids), want)
        assert plane.workers[0].execs == 1       # rode the replacement
        sup.step()                               # clean lease -> live
        assert sup.summary()["workers"][0]["state"] == lifecycle.LIVE


# ---------------------------------------------------------------------------
# recovery arcs: SIGKILLed spawn process, RST-killed TCP connection
# ---------------------------------------------------------------------------


def test_spawn_worker_sigkill_auto_recovery_bit_identical(oracle):
    """A SIGKILLed spawn worker is re-forked, re-shipped every live
    generation, and adopted: waves before, during, and after the window
    answer bit-identically, and the breaker key is healed."""
    X, gids = _wave_inputs(oracle, n_rows=48, seed=3)
    want = oracle.bank.execute(X, gids)
    with ShardPlane(workers=2, mode="spawn") as plane:
        sharded = plane.load(oracle.bank)
        np.testing.assert_array_equal(sharded.execute(X, gids), want)
        sup, _ = _supervisor(plane)
        plane.workers[1].kill()                  # SIGKILL the process
        plane.workers[1]._proc.join(timeout=5.0)
        # during the window: the dead shard serves parent-side (a wave
        # may first surface the death as a typed partial error — routed
        # waves after that are whole)
        try:
            sharded.execute(X, gids)
        except PartialExecutionError:
            pass
        np.testing.assert_array_equal(sharded.execute(X, gids), want)
        _step_until(sup, lambda: plane.adoptions >= 1)
        assert plane.alive_workers() == 2
        assert plane.breaker.allow(("shard", 1))  # healed, not cooling
        execs_before = plane.workers[1].execs
        np.testing.assert_array_equal(sharded.execute(X, gids), want)
        assert plane.workers[1].execs == execs_before + 1
        s = sup.summary()
        assert s["respawns"] == 1
        assert s["workers"][1]["state"] in (lifecycle.ADOPTED,
                                            lifecycle.LIVE)


def test_tcp_rst_killed_connection_redials_and_recovers(oracle):
    """An RST-killed TCP worker connection is re-dialed at the same
    endpoint (fresh HELLO, full re-ship) and adopted; the generation
    table on the server side is per-connection, so the replacement's
    banks arrive over the wire again."""
    X, gids = _wave_inputs(oracle, n_rows=40, seed=4)
    want = oracle.bank.execute(X, gids)
    with WorkerServer(device="cpu") as s0, WorkerServer(device="cpu") as s1:
        with ShardPlane(workers=0, mode="thread",
                        remote=[s0.address, s1.address]) as plane:
            sharded = plane.load(oracle.bank)
            np.testing.assert_array_equal(sharded.execute(X, gids), want)
            sup, _ = _supervisor(plane)
            loads_before = s1.loads
            plane.workers[1].kill()              # hard socket shutdown
            _step_until(sup, lambda: plane.adoptions >= 1)
            assert plane.alive_workers() == 2
            assert s1.loads == loads_before + 1  # full re-ship happened
            execs_before = plane.workers[1].execs
            np.testing.assert_array_equal(sharded.execute(X, gids), want)
            assert plane.workers[1].execs == execs_before + 1


def test_tcp_pool_subprocess_sigkill_respawns_on_new_port(oracle):
    """A SIGKILLed shard-worker subprocess is re-launched through the
    pool's endpoint callback: the replacement lands on a NEW ephemeral
    port, the plane's remote table follows it, and answers stay
    bit-identical."""
    X, gids = _wave_inputs(oracle, n_rows=40, seed=5)
    want = oracle.bank.execute(X, gids)
    with launch_tcp_workers(2, device="cpu") as pool:
        with ShardPlane(workers=0, mode="thread",
                        remote=pool.addresses) as plane:
            sharded = plane.load(oracle.bank)
            np.testing.assert_array_equal(sharded.execute(X, gids), want)
            old_addr = pool.addresses[1]
            sup, _ = _supervisor(
                plane, endpoints={1: lambda: pool.respawn(1)})
            pool.kill(1)
            pool.procs[1].wait(timeout=5.0)
            _step_until(sup, lambda: plane.adoptions >= 1)
            assert pool.addresses[1] != old_addr
            assert plane.remote[1] == pool.addresses[1]
            assert plane.alive_workers() == 2
            np.testing.assert_array_equal(sharded.execute(X, gids), want)


# ---------------------------------------------------------------------------
# authenticated HELLO
# ---------------------------------------------------------------------------


def test_auth_wrong_or_missing_token_rejected_before_load(oracle):
    """A parent with a wrong (or no) token is closed before any load is
    processed — the worker burns zero CPU on unauthenticated peers — and
    the failure is a typed WorkerAuthError at plane construction."""
    with WorkerServer(device="cpu", token="s3kr1t") as server:
        with pytest.raises(WorkerAuthError):
            ShardPlane(workers=0, mode="thread",
                       remote=[server.address], worker_token="wrong")
        with pytest.raises(WorkerAuthError,
                           match="requires a pre-shared token"):
            ShardPlane(workers=0, mode="thread", remote=[server.address])
        assert server.loads == 0
        assert server.auth_rejects == 1          # wrong token counted
        # the right token serves normally
        X, gids = _wave_inputs(oracle, n_rows=24, seed=6)
        with ShardPlane(workers=0, mode="thread",
                        remote=[server.address],
                        worker_token="s3kr1t") as plane:
            sharded = plane.load(oracle.bank)
            np.testing.assert_array_equal(
                sharded.execute(X, gids), oracle.bank.execute(X, gids))
        assert server.loads == 1


def test_auth_refuses_worker_that_wont_authenticate():
    """A plane holding a token refuses a peer that does not enforce auth
    (an impostor on the worker's port would happily skip the check)."""
    with WorkerServer(device="cpu") as server:                # no token: no auth
        with pytest.raises(WorkerAuthError, match="does not enforce"):
            ShardPlane(workers=0, mode="thread",
                       remote=[server.address], worker_token="s3kr1t")
        assert server.loads == 0


def test_recovered_worker_reconnects_through_auth(oracle):
    """The recovery re-dial performs the full authenticated handshake —
    a replacement is adopted only after HELLO auth passes."""
    X, gids = _wave_inputs(oracle, n_rows=30, seed=7)
    want = oracle.bank.execute(X, gids)
    with WorkerServer(device="cpu", token="tok") as s0, WorkerServer(device="cpu", token="tok") as s1:
        with ShardPlane(workers=0, mode="thread",
                        remote=[s0.address, s1.address],
                        worker_token="tok") as plane:
            sharded = plane.load(oracle.bank)
            sup, _ = _supervisor(plane)
            plane.workers[0].kill()
            _step_until(sup, lambda: plane.adoptions >= 1)
            np.testing.assert_array_equal(sharded.execute(X, gids), want)
            assert s0.auth_rejects == 0


# ---------------------------------------------------------------------------
# respawn storm: deterministic fake-clock backoff
# ---------------------------------------------------------------------------


def test_respawn_backoff_bounds_with_fake_clock(oracle):
    """Failed respawn attempts back off exponentially against the
    injected clock: stepping without advancing time attempts nothing,
    and each window admits exactly one attempt — a respawn storm is
    bounded by the schedule, not by how hot the supervision loop runs."""
    now = [100.0]
    with ShardPlane(workers=2, mode="thread") as plane:
        plane.load(oracle.bank)
        sup, inj = _supervisor(
            plane, clock=lambda: now[0],
            rules=[FaultRule(site=faults.SITE_RESPAWN_FAIL,
                             kind="error", rate=1.0)])
        plane.workers[0].kill()
        sup.step()                                # attempt 1 (immediate)
        assert inj.hits(faults.SITE_RESPAWN_FAIL) == 1
        st = sup.summary()["workers"][0]
        assert st["state"] == lifecycle.RECOVERING and st["attempt"] == 1
        for _ in range(5):                        # hot loop, frozen clock
            sup.step()
        assert inj.hits(faults.SITE_RESPAWN_FAIL) == 1  # still backing off
        now[0] += 0.05                            # base_s window elapses
        sup.step()                                # attempt 2
        assert inj.hits(faults.SITE_RESPAWN_FAIL) == 2
        for _ in range(3):
            sup.step()
        assert inj.hits(faults.SITE_RESPAWN_FAIL) == 2
        now[0] += 0.1                             # base_s * multiplier
        sup.step()                                # attempt 3
        assert inj.hits(faults.SITE_RESPAWN_FAIL) == 3
        # the injector stops failing: the next window's attempt adopts
        inj.clear()
        now[0] += 0.2                             # capped at max_backoff_s
        sup.step()
        assert plane.adoptions == 1
        assert sup.summary()["workers"][0]["state"] == lifecycle.ADOPTED


def test_respawn_gives_up_after_max_attempts(oracle):
    """``max_attempts`` bounds attempts per death: past it the worker is
    declared dead and supervision stops burning attempts on it."""
    now = [0.0]
    with ShardPlane(workers=2, mode="thread") as plane:
        plane.load(oracle.bank)
        sup, inj = _supervisor(
            plane, clock=lambda: now[0], max_attempts=2,
            rules=[FaultRule(site=faults.SITE_RESPAWN_FAIL,
                             kind="error", rate=1.0)])
        plane.workers[1].kill()
        for _ in range(10):
            sup.step()
            now[0] += 1.0                         # past every backoff
        assert inj.hits(faults.SITE_RESPAWN_FAIL) == 2
        s = sup.summary()
        assert s["workers"][1]["state"] == lifecycle.DEAD
        assert s["states"].get(lifecycle.DEAD) == 1
        assert plane.adoptions == 0


# ---------------------------------------------------------------------------
# the full arc under concurrent swaps + live pipelined replay
# ---------------------------------------------------------------------------


def test_recovery_under_concurrent_swaps_zero_lost_zero_mixed(
        oracle, fresh_oracle):
    """The tentpole invariant: SIGKILL a worker mid-replay while FOUR
    oracle swaps land concurrently and the supervisor heals in the
    background. Every request answers (a typed mid-kill 500 retries
    through the parent fallback), every answer matches exactly ONE
    oracle bit-exactly (no mixed-epoch waves), and the worker is
    adopted back."""
    plane = ShardPlane(workers=2, mode="thread")
    svc = LatencyService(oracle, max_wave=16, cache_size=0,
                         shard_plane=plane)
    sup, _ = _supervisor(plane)
    sup.start(interval_s=0.02)
    bg = BackgroundServer(svc, host="127.0.0.1", port=0).start()
    reqs = synthetic_requests(oracle, n=160, seed=8)
    want = {}
    for orc, tag in ((oracle, "e1"), (fresh_oracle, "e2")):
        for i, res in enumerate(orc.predict_many(reqs)):
            want[(tag, i)] = res.latency_ms
    epoch_tag = {svc.epoch: "e1"}
    try:
        killer = threading.Timer(0.05, plane.workers[1].kill)
        killer.start()

        def swaps():
            for k in range(4):
                time.sleep(0.04)
                orc, tag = ((fresh_oracle, "e2") if k % 2 == 0
                            else (oracle, "e1"))
                epoch_tag[svc.oracle_refreshed(orc, f"{tag}.{k}")] = tag

        swapper = threading.Thread(target=swaps)
        swapper.start()
        rep = replay(bg.host, bg.port, reqs, clients=8,
                     retry=RetryPolicy(max_attempts=4, base_s=0.02,
                                       jitter=0.0, seed=0,
                                       retry_statuses=frozenset(
                                           {500, 503})))
        killer.join()
        swapper.join()
        assert rep["ok"] == rep["n"], rep["errors"][:3]   # zero lost
        for i, r in enumerate(rep["results"]):
            tag = epoch_tag[r["epoch"]]
            assert r["latency_ms"] == want[(tag, i)], (i, tag)
        _step_until(sup, lambda: plane.adoptions >= 1, sleep_s=0.02)
        assert plane.alive_workers() == 2
        assert sup.summary()["respawns"] >= 1
        # throughput restored: a clean post-recovery replay rides both
        # workers again, still bit-identical under the final epoch
        rep2 = replay(bg.host, bg.port, reqs[:48], clients=4)
        assert rep2["ok"] == rep2["n"]
        final_tag = epoch_tag[svc.epoch]
        for i, r in enumerate(rep2["results"]):
            assert r["latency_ms"] == want[(final_tag, i)]
    finally:
        bg.stop()
        sup.stop()
        plane.close()


def test_swap_during_recovery_never_mixes_epochs(oracle, fresh_oracle):
    """A load() racing the re-ship+adopt window serializes on the swap
    lock: the adopted replacement holds exactly the generations live at
    adoption, so a wave on either generation answers whole."""
    X, gids = _wave_inputs(oracle, n_rows=30, seed=9)
    plane = ShardPlane(workers=2, mode="thread")
    svc = LatencyService(oracle, max_wave=16, shard_plane=plane)
    sup, _ = _supervisor(plane)
    try:
        plane.workers[0].kill()
        done = threading.Event()

        def swap_loop():
            for k in range(3):
                svc.oracle_refreshed(
                    (fresh_oracle, oracle)[k % 2], f"s{k}")
            done.set()

        t = threading.Thread(target=swap_loop)
        t.start()
        _step_until(sup, lambda: plane.adoptions >= 1, sleep_s=0.01)
        t.join()
        assert done.is_set()
        # the final generation serves whole on BOTH workers, bit-identical
        final = svc._shard_gen
        want = final._full.execute(X, gids)
        np.testing.assert_array_equal(final.execute(X, gids), want)
        assert plane.alive_workers() == 2
        # exactly one live generation: no stale epoch left behind
        assert plane.summary()["generations"] == [final.gen_id]
    finally:
        sup.stop()
        plane.close()


# ---------------------------------------------------------------------------
# resource-leak regression: kill/respawn cycles must not leak
# ---------------------------------------------------------------------------


def _open_fds():
    return len(os.listdir("/proc/self/fd"))


def _shm_segments():
    """This process's shard segments (other test processes on the host
    publish and unlink their own meanwhile)."""
    from repro_torch.serve.shard import segment_prefix
    try:
        return sum(1 for n in os.listdir("/dev/shm")
                   if n.startswith(segment_prefix()))
    except FileNotFoundError:
        return 0


def test_kill_respawn_cycles_leak_no_fds_shm_or_zombies(oracle):
    """Three SIGKILL->respawn->adopt cycles on a spawn plane: open fds
    and shared-memory segments return to baseline after close, and no
    zombie children linger (the old worker object is closed at adoption
    — pipe fds, Process sentinel, shm handles all released)."""
    import multiprocessing as mp
    fd_base = _open_fds()
    shm_base = _shm_segments()
    plane = ShardPlane(workers=2, mode="spawn")
    try:
        sharded = plane.load(oracle.bank)
        X, gids = _wave_inputs(oracle, n_rows=24, seed=10)
        want = oracle.bank.execute(X, gids)
        sup, _ = _supervisor(plane)
        for cycle in range(3):
            plane.workers[1].kill()
            _step_until(sup, lambda c=cycle: plane.adoptions >= c + 1)
            np.testing.assert_array_equal(sharded.execute(X, gids), want)
        assert plane.adoptions == 3
    finally:
        plane.close()
    # adopted-and-closed processes must be fully reaped: active_children
    # joins what it can — none may remain ours
    for p in mp.active_children():
        p.join(timeout=5.0)
    assert not mp.active_children()
    assert _shm_segments() == shm_base
    # fd accounting has slack for the interpreter's own churn, but 3
    # cycles x (2 pipe fds + sentinel + shm handles) would blow well
    # past it if adoption leaked
    assert _open_fds() <= fd_base + 4


def test_service_supervise_flag_attaches_and_close_detaches(oracle):
    """``LatencyService(supervise=...)`` owns the supervisor lifecycle:
    summary rides plane.summary(), and plane.close() stops the loop."""
    plane = ShardPlane(workers=2, mode="thread")
    svc = LatencyService(oracle, max_wave=16, shard_plane=plane,
                         supervise=True)
    try:
        assert svc.supervisor is not None
        assert plane.supervisor is svc.supervisor
        s = plane.summary()
        assert s["lifecycle"]["supervising"] is True
        assert {w["state"] for w in s["lifecycle"]["workers"]} <= {
            lifecycle.LIVE, lifecycle.SUSPECT, lifecycle.ADOPTED}
    finally:
        plane.close()
    assert plane.summary()["lifecycle"]["supervising"] is False


def test_recovered_plane_answers_as_the_reference_recovers(oracle,
                                                          ref_oracle):
    """The same kill -> respawn -> adopt arc on a thread plane of each
    package: both recover, and the port's answers after adoption equal the
    reference's bit for bit."""
    from repro.serve import ShardPlane as RefShardPlane
    from repro.serve.lifecycle import LifecycleConfig as RefConfig
    from repro.serve.lifecycle import WorkerSupervisor as RefSupervisor
    from repro.serve.resilience import RetryPolicy as RefRetry
    X, gids = _wave_inputs(oracle, n_rows=40, seed=11)
    got = {}
    for name, plane_cls, sup_fn, orc in (
            ("port", ShardPlane, lambda p: _supervisor(p)[0], oracle),
            ("ref", RefShardPlane, lambda p: RefSupervisor(
                p, config=RefConfig(backoff=RefRetry(
                    max_attempts=2, base_s=0.05, multiplier=2.0,
                    max_backoff_s=0.2, jitter=0.0, seed=0))), ref_oracle)):
        with plane_cls(workers=2, mode="thread") as plane:
            sharded = plane.load(orc.bank)
            sup = sup_fn(plane)
            plane.workers[1].kill()
            _step_until(sup, lambda: plane.adoptions >= 1)
            assert plane.alive_workers() == 2
            got[name] = sharded.execute(X, gids)
    np.testing.assert_array_equal(got["port"], got["ref"])
    np.testing.assert_array_equal(got["port"], oracle.bank.execute(X, gids))


def test_spawn_segments_are_named_for_their_process(oracle):
    """A spawn plane's generation lives in segments named for the process
    that published them, and retiring it unlinks every one."""
    from repro_torch.serve.shard import segment_prefix
    assert segment_prefix(123) == "repro_torch_123_"
    base = _shm_segments()
    with ShardPlane(workers=1, mode="spawn") as plane:
        sharded = plane.load(oracle.bank)
        # 5 forest arrays and the linear coefficients
        assert _shm_segments() == base + 6
        plane.retire(sharded)
        assert _shm_segments() == base
