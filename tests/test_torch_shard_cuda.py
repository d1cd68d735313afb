"""The shard plane's use of the card: thread-mode workers share the parent's
CUDA context and launch the fused grouped forest kernel from several threads
at once; spawn workers each open their own context. The ``cuda``-marked
tests need an NVIDIA GPU (the CUDA kernels have no CPU mode) and skip
without one; the file imports no JAX, so on a GPU machine it runs with
``--noconftest``:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_shard_cuda.py

Bars: the forest kernels are float64 and route in float64, so kernel and
plain version agree bit for bit; with float64-only members sharded answers
equal the unsharded bank's bit for bit.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.kernels import forest_eval

SMALL_DEVICES = ("T4", "V100", "K80")
SMALL_MODELS = ("LeNet5", "AlexNet", "ResNet18")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _oracle(device):
    from repro_torch.api.oracle import LatencyOracle
    from repro_torch.core import workloads
    from repro_torch.core.predictor import ProfetConfig
    ds = workloads.generate(devices=SMALL_DEVICES, models=SMALL_MODELS)
    return LatencyOracle.fit(ds, ProfetConfig(members=("linear", "forest"),
                                              n_trees=15, seed=0),
                             device=device)


def _wave(oracle, n_rows, seed):
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


def test_tile_counters_growth_is_thread_safe():
    """Threads asking one (device, stream) for ever more tiles each get a
    buffer of at least their tiles, and the buffer kept is the largest
    asked for (``tile_counters`` checks and grows under a lock)."""
    plan = forest_eval.TilePlan(R=4, B=4, smem=0)
    key = ("cpu", None, 12345)
    forest_eval._COUNTERS.pop(key, None)
    errors = []
    barrier = threading.Barrier(8)

    def ask(i):
        barrier.wait()
        for m in range(1 + i, 4000, 97):
            buf = forest_eval.tile_counters(m, plan, "cpu", 12345)
            if buf.numel() < -(-m // plan.R):
                errors.append((i, m, buf.numel()))
    threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    most = max(m for i in range(8) for m in range(1 + i, 4000, 97))
    assert forest_eval._COUNTERS.pop(key).numel() == -(-most // plan.R)


@pytest.mark.cuda
def test_two_threads_fused_launches_match_plain_bitwise(cuda):
    """Two threads launch the fused grouped prediction on one device over
    waves of different sizes (growing the shared tile counters between
    them); every answer equals the plain version's bit for bit and every
    launch is counted."""
    oracle = _oracle(cuda)
    f = oracle.bank.forest
    args = (f["feat"], f["thr"], f["left"], f["right"], f["value"],
            f["depth"])
    waves = []
    for i, n in enumerate((7, 64, 300, 1000, 33, 512)):
        X, g = _wave(oracle, max(n, len(oracle.bank.pairs)), seed=i)
        X, g = torch.from_numpy(X).to(cuda), torch.from_numpy(g).to(cuda)
        waves.append((X, g, forest_eval.predict_grouped(
            X, g, *args, backend="torch")))
    forest_eval.reset_launches()
    bad, runs = [], 40

    def run(offset):
        for r in range(runs):
            X, g, want = waves[(r + offset) % len(waves)]
            got = forest_eval.predict_grouped(X, g, *args)
            if not torch.equal(got, want):
                bad.append((offset, r))
    threads = [threading.Thread(target=run, args=(k,)) for k in (0, 3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    torch.cuda.synchronize()
    assert not bad and not any(t.is_alive() for t in threads)
    launched = (forest_eval.launches["predict_grouped"]
                + forest_eval.launches["leaf_values_grouped/global"])
    assert launched == 2 * runs


@pytest.mark.cuda
def test_thread_plane_counts_one_fused_launch_per_slice(cuda):
    from repro_torch.serve import ShardPlane
    oracle = _oracle(cuda)
    X, gids = _wave(oracle, 48, seed=1)
    want = oracle.bank.execute(X, gids)
    with ShardPlane(workers=2, mode="thread") as plane:
        sharded = plane.load(oracle.bank)
        forest_eval.reset_launches()
        got = sharded.execute(X, gids)
        assert forest_eval.launches["predict_grouped"] == plane.slices == 2
        assert forest_eval.launches["leaf_values_grouped"] == 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_spawn_plane_on_the_card_bit_identical(cuda):
    """Spawn workers attach the shared-memory shards, copy them to the
    card in their own CUDA context and answer through the kernel."""
    from repro_torch.serve import ShardPlane
    oracle = _oracle(cuda)
    X, gids = _wave(oracle, 48, seed=2)
    want = oracle.bank.execute(X, gids)
    with ShardPlane(workers=2, mode="spawn") as plane:
        sharded = plane.load(oracle.bank)
        np.testing.assert_array_equal(sharded.execute(X, gids), want)
        np.testing.assert_array_equal(sharded.execute(X, gids), want)
        assert plane.slices == 4 and plane.fallback_rows == 0
