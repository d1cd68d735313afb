"""The port's forest kernels' plain versions (``repro_torch.kernels.
forest_eval``) against the reference traversals of ``repro.kernels.
forest_eval``.

Tolerances: routing is a pure float64 comparison and the tree mean adds
trees in the same order with the same float64 operations, so every
comparison with the float64 numpy reference is bitwise. Against the Pallas
kernels (float32, interpret mode) the forests and inputs are first
quantized to float32, so routing agrees exactly there too, and the float32
leaf values compare exactly. The CUDA kernels themselves run only on the
card: the ``cuda``-marked tests skip here. The choice between the two
kernel routes is a function of shapes and runs here, and so does the
choice between the fused prediction (traversal and tree mean in one
launch) and the global traversal followed by the tree mean.
"""
import numpy as np
import pytest
import torch

from repro.core.regressors import RandomForestRegressor
from repro.kernels import forest_eval as ref
from repro_torch.kernels import _build, forest_eval


def _stack(seed=0, n_groups=4, d=4, flat_group=2):
    """Reference forests of ragged size and depth, stacked ``(G, T, N)``;
    group ``flat_group`` is grown on a constant target, so its depth is 0."""
    rng = np.random.default_rng(seed)
    forests = []
    for g in range(n_groups):
        X = rng.uniform(-2, 2, size=(40 + 10 * g, d))
        y = (np.full(len(X), 3.5) if g == flat_group
             else np.sin(X[:, 0] * (g + 1)) + X[:, 1] ** 2)
        forests.append(RandomForestRegressor(
            n_estimators=6, max_depth=3 + 2 * g, seed=seed + g).fit(X, y).forest_)
    n_max = max(f.feat.shape[1] for f in forests)
    s = {}
    for name, fill in (("feat", -1), ("thr", 0.0), ("left", 0),
                       ("right", 0), ("value", 0.0)):
        arr = np.full((n_groups, forests[0].n_trees, n_max), fill,
                      getattr(forests[0], name).dtype)
        for g, f in enumerate(forests):
            arr[g, :, :f.feat.shape[1]] = getattr(f, name)
        s[name] = arr
    s["depth"] = np.array([f.depth for f in forests], np.int64)
    assert s["depth"][flat_group] == 0 and len(set(s["depth"])) > 2
    return forests, s


def _t(s):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in s.items()}


FIELDS = ("feat", "thr", "left", "right", "value")


def test_grouped_plain_matches_numpy_bitwise():
    _, s = _stack()
    rng = np.random.default_rng(7)
    X = rng.uniform(-2, 2, size=(83, 4))
    gid = rng.integers(0, 4, size=83)
    want = ref.leaf_values_grouped_numpy(X, gid, *(s[k] for k in FIELDS),
                                         s["depth"])
    t = _t(s)
    got = forest_eval.leaf_values_grouped(
        torch.from_numpy(X), torch.from_numpy(gid), *(t[k] for k in FIELDS),
        t["depth"])
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


def test_single_plain_matches_numpy_bitwise():
    forests, _ = _stack(seed=1)
    rng = np.random.default_rng(3)
    X = rng.uniform(-2, 2, size=(29, 4))
    for f in forests:
        want = ref.leaf_values_numpy(X, f.feat, f.thr, f.left, f.right,
                                     f.value, depth=f.depth)
        got = forest_eval.leaf_values(
            torch.from_numpy(X), *(torch.from_numpy(getattr(f, k))
                                   for k in FIELDS), depth=f.depth)
        np.testing.assert_array_equal(got.numpy(), want)


def test_predict_matches_reference_bitwise():
    forests, s = _stack(seed=2)
    rng = np.random.default_rng(5)
    X = rng.uniform(-2, 2, size=(50, 4))
    gid = rng.integers(0, 4, size=50)
    t = _t(s)
    got = forest_eval.predict_grouped(
        torch.from_numpy(X), torch.from_numpy(gid), *(t[k] for k in FIELDS),
        t["depth"])
    want = ref.predict_grouped(X, gid, *(s[k] for k in FIELDS),
                               depth=s["depth"], backend="numpy")
    np.testing.assert_array_equal(got.numpy(), want)
    f = forests[1]
    got1 = forest_eval.predict(torch.from_numpy(X), *(
        torch.from_numpy(getattr(f, k)) for k in FIELDS), depth=f.depth)
    want1 = ref.predict(X, f.feat, f.thr, f.left, f.right, f.value,
                        depth=f.depth, backend="numpy")
    np.testing.assert_array_equal(got1.numpy(), want1)


def test_grouped_matches_pallas_interpret_on_f32_forests():
    """Float32-quantized inputs and thresholds: float64 routing of the
    port takes the same branches as the float32 Pallas kernel."""
    _, s = _stack(seed=3)
    rng = np.random.default_rng(11)
    X = rng.uniform(-2, 2, size=(37, 4)).astype(np.float32).astype(np.float64)
    s["thr"] = s["thr"].astype(np.float32).astype(np.float64)
    gid = rng.integers(0, 4, size=37)
    want = ref.leaf_values_grouped_pallas(
        X, gid, *(s[k] for k in FIELDS), depth=s["depth"], block_rows=8,
        interpret=True)
    t = _t(s)
    got = forest_eval.leaf_values_grouped(
        torch.from_numpy(X), torch.from_numpy(gid), *(t[k] for k in FIELDS),
        t["depth"])
    np.testing.assert_array_equal(got.numpy().astype(np.float32), want)


def test_single_matches_pallas_interpret_on_f32_forest():
    forests, _ = _stack(seed=4)
    f = forests[3]
    rng = np.random.default_rng(2)
    X = rng.uniform(-2, 2, size=(21, 4)).astype(np.float32).astype(np.float64)
    thr = f.thr.astype(np.float32).astype(np.float64)
    want = ref.leaf_values_pallas(X, f.feat, thr, f.left, f.right, f.value,
                                  depth=f.depth, block_rows=8,
                                  interpret=True)
    got = forest_eval.leaf_values(
        torch.from_numpy(X), torch.from_numpy(f.feat), torch.from_numpy(thr),
        torch.from_numpy(f.left), torch.from_numpy(f.right),
        torch.from_numpy(f.value), depth=f.depth)
    np.testing.assert_array_equal(got.numpy().astype(np.float32), want)


def test_ragged_depth0_groups_and_zero_rows():
    _, s = _stack(seed=6)
    t = _t(s)
    rng = np.random.default_rng(1)
    # every row in the depth-0 group: each tree answers its root value
    X = rng.uniform(-2, 2, size=(9, 4))
    gid = np.full(9, 2)
    got = forest_eval.leaf_values_grouped(
        torch.from_numpy(X), torch.from_numpy(gid), *(t[k] for k in FIELDS),
        t["depth"]).numpy()
    np.testing.assert_array_equal(got, np.repeat(s["value"][2][:, :1], 9, 1))
    # zero rows: (T, 0) leaves, (0,) predictions
    X0 = torch.zeros((0, 4), dtype=torch.float64)
    g0 = torch.zeros(0, dtype=torch.int64)
    T = s["feat"].shape[1]
    assert forest_eval.leaf_values_grouped(
        X0, g0, *(t[k] for k in FIELDS), t["depth"]).shape == (T, 0)
    assert forest_eval.predict_grouped(
        X0, g0, *(t[k] for k in FIELDS), t["depth"]).shape == (0,)
    want0 = ref.leaf_values_grouped_numpy(
        np.zeros((0, 4)), np.zeros(0, np.int64), *(s[k] for k in FIELDS),
        s["depth"])
    assert want0.shape == (T, 0)


def test_tree_mean_bitwise_and_row_stable():
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(60, 37)) * 10 ** rng.uniform(-3, 3, size=(60, 37))
    got = forest_eval.tree_mean(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, ref.tree_mean(vals))
    # a row's mean does not depend on the other rows in the batch
    sub = forest_eval.tree_mean(torch.from_numpy(vals[:, 5:9].copy()))
    np.testing.assert_array_equal(sub.numpy(), got[5:9])


def test_cpu_calls_launch_nothing_and_the_kernels_raise(monkeypatch):
    _, s = _stack(seed=8)
    t = _t(s)
    X = torch.zeros((3, 4), dtype=torch.float64)
    gid = torch.zeros(3, dtype=torch.int64)
    before = dict(forest_eval.launches)
    plain = dict(forest_eval.plain_calls)
    forest_eval.predict_grouped(X, gid, *(t[k] for k in FIELDS), t["depth"])
    assert forest_eval.launches == before
    # the plain version answered, and was counted as such (once: its
    # traversal and tree mean are the plain functions, not the wrappers)
    assert forest_eval.plain_calls == dict(
        plain, predict_grouped=plain["predict_grouped"] + 1)
    forest_eval.reset_launches()
    assert not any(forest_eval.plain_calls.values())
    assert not any(forest_eval.launches.values())
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        forest_eval._leaf_values_grouped_global(
            X, gid, *(t[k] for k in FIELDS), t["depth"])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        forest_eval._leaf_values_global(X, *(t[k][0] for k in FIELDS),
                                        depth=2)
    with pytest.raises(ValueError, match="unknown backend 'pallas'"):
        forest_eval.tree_mean(torch.zeros((4, 3), dtype=torch.float64),
                              backend="pallas")
    # the tree mean's launch sits in its wrapper: sent there, it raises
    monkeypatch.setattr(_build, "route", lambda x, backend: "kernel")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        forest_eval.tree_mean(torch.zeros((4, 3), dtype=torch.float64))


def test_smem_bytes_counts_tree_rows_and_list():
    """28 bytes a node (feat, left, right int32; thr, value float64), 8 a
    staged feature, 4 a list entry, 4 for the count."""
    assert forest_eval.smem_bytes(461, 33, 76, 32) \
        == 461 * (4 + 8 + 4 + 4 + 8) + 32 * 33 * 8 + 76 * 4 + 4 == 21_664
    assert forest_eval.smem_bytes(1, 1, 0, 0) == 32


# blocks of the shared route an H100 holds at once, as the card reads them
# (test_cuda_resident_blocks_of_the_paper_grid): 132 SMs; an SM's 65,536
# registers hold 10 grouped blocks (48 registers a thread) or 12
# single-forest ones (40), and its 228 KB of shared memory, with 1 KB
# reserved a block, may hold fewer
def _h100_resident(grouped):
    return lambda smem: 132 * min(10 if grouped else 12,
                                  233_472 // (smem + 1_024))


def test_tile_plan_paper_grid_takes_shared_route():
    """The paper grid's bank (12, 60, 461) with D = 33: the serving wave
    (76 rows) and a pair's rows through one forest take the shared route;
    a wave is one tile of 128 rows per group, 720 blocks in one round."""
    plan = forest_eval.tile_plan(12, 60, 461, 76, 33)
    assert plan == (1536, 32, forest_eval.smem_bytes(461, 33, 76, 32))
    assert forest_eval.route_plan(12, 60, 461, 76, 33,
                                  _h100_resident(True)) == plan
    assert 60 * 12 <= _h100_resident(True)(plan.smem) == 1_320
    single = forest_eval.tile_plan(1, 60, 461, 12, 33)
    assert single == (128, 12, forest_eval.smem_bytes(461, 33, 12, 12))
    assert forest_eval.route_plan(1, 60, 461, 12, 33,
                                  _h100_resident(False)) == single


def test_route_plan_takes_global_route_beyond_one_round():
    """A wave whose shared-route grid needs more than one round of
    resident blocks goes to the global route: over the paper grid's bank
    at 1,024 rows (720 blocks, 660 resident) and 4,096; through one forest
    beyond 8 tiles of 128 rows (528 resident at full batches)."""
    def route(G, m):
        return forest_eval.route_plan(G, 60, 461, m, 33,
                                      _h100_resident(G > 1))
    assert route(12, 512) == forest_eval.tile_plan(12, 60, 461, 512, 33)
    full = forest_eval.tile_plan(12, 60, 461, 1024, 33)
    assert full.B == 96 and _h100_resident(True)(full.smem) == 660
    assert route(12, 1024) is None and route(12, 4096) is None
    assert _h100_resident(False)(forest_eval.tile_plan(
        1, 60, 461, 1024, 33).smem) == 528
    assert route(1, 1024) is not None
    assert route(1, 1025) is None and route(1, 4096) is None
    # the rule itself: a grid of exactly one round still fits
    assert forest_eval.route_plan(12, 60, 461, 76, 33,
                                  lambda smem: 720) is not None
    assert forest_eval.route_plan(12, 60, 461, 76, 33,
                                  lambda smem: 719) is None


def test_tile_plan_large_tree_takes_global_route():
    """A tree whose 28 N bytes and one row leave no room in a block's
    shared memory goes to the global route; one node fewer than the
    limit still fits, with fewer rows a batch."""
    D, m, G, T = 33, 76, 12, 60
    L = min(forest_eval.tile_rows(G), m)
    n_max = (_build.SMEM_PER_BLOCK - forest_eval.smem_bytes(0, D, L, 1)) \
        // 28
    assert forest_eval.tile_plan(G, T, n_max + 1, m, D) is None
    assert forest_eval.route_plan(G, T, n_max + 1, m, D,
                                  lambda smem: 10 ** 9) is None
    fits = forest_eval.tile_plan(G, T, n_max, m, D)
    assert fits is not None and fits.B == 1
    assert fits.smem <= _build.SMEM_PER_BLOCK
    assert forest_eval.tile_plan(G, T, 10_000, m, D) is None
    # a grid taller than the card takes: 65,536 tiles of 128 rows
    assert forest_eval.tile_plan(1, T, 15, 128 * 65_535 + 1, 4) is None


@pytest.mark.parametrize("G,T,N,m,D", [
    (12, 60, 461, 76, 33), (12, 60, 461, 4096, 33), (1, 60, 461, 1, 33),
    (1, 60, 461, 4096, 33), (4, 60, 401, 100, 33), (40, 7, 127, 9000, 5),
    (3, 1, 2000, 130, 300), (1, 60, 15, 8_388_480, 4)])
def test_tile_plan_fits_the_kernel(G, T, N, m, D):
    """Whatever the shape: tiles of whole warps' rows, at most 128 rows a
    batch and no more than a tile holds, within a block's shared
    memory."""
    plan = forest_eval.tile_plan(G, T, N, m, D)
    assert plan is not None
    assert plan.R % forest_eval.TILE_THREADS == 0
    assert plan.R == forest_eval.tile_rows(G) <= 128 * 16
    assert 1 <= plan.B <= min(forest_eval.TILE_THREADS, plan.R, m)
    assert plan.smem == forest_eval.smem_bytes(N, D, min(plan.R, m), plan.B)
    assert plan.smem <= _build.SMEM_PER_BLOCK
    assert -(-m // plan.R) <= forest_eval.GRID_YZ_MAX


def test_cpu_traversals_read_no_occupancy():
    """On CPU tensors the wrappers run the plain versions without asking
    the card for its occupancy (there is no library to ask here)."""
    _, s = _stack(seed=12)
    t = _t(s)
    rng = np.random.default_rng(6)
    X = torch.from_numpy(rng.uniform(-2, 2, size=(17, 4)))
    gid = torch.from_numpy(rng.integers(0, 4, size=17))
    args = [t[k] for k in FIELDS]
    forest_eval._RESIDENT.clear()
    got = forest_eval.leaf_values_grouped(X, gid, *args, t["depth"])
    assert torch.equal(got, forest_eval.leaf_values_grouped_plain(
        X, gid, *args, t["depth"]))
    forest_eval.leaf_values(X, *(a[0] for a in args), depth=2)
    assert forest_eval._RESIDENT == {}


def _out_of_range_rows(s, device):
    """Rows 2 and 5 carry group ids outside ``[0, G)``."""
    t = {k: v.to(device) for k, v in _t(s).items()}
    rng = np.random.default_rng(11)
    X = torch.from_numpy(rng.uniform(-2, 2, size=(8, 4))).to(device)
    gid = torch.tensor([0, 1, -1, 3, 2, 4, 1, 0], device=device)
    return t, X, gid


def test_grouped_plain_out_of_range_gid_gives_nan_rows():
    """A row with a group id outside ``[0, G)`` reads no forest and gets NaN
    in every tree; the other rows are answered as if it were absent."""
    _, s = _stack(seed=10)
    t, X, gid = _out_of_range_rows(s, "cpu")
    got = forest_eval.leaf_values_grouped(X, gid, *(t[k] for k in FIELDS),
                                          t["depth"])
    bad = torch.tensor([2, 5])
    assert torch.isnan(got[:, bad]).all()
    ok = torch.tensor([0, 1, 3, 4, 6, 7])
    want = ref.leaf_values_grouped_numpy(
        X[ok].numpy(), gid[ok].numpy(), *(s[k] for k in FIELDS), s["depth"])
    np.testing.assert_array_equal(got[:, ok].numpy(), want)


def _bitwise_with_nan(got, want):
    return torch.equal(torch.isnan(got), torch.isnan(want)) \
        and torch.equal(got.nan_to_num(), want.nan_to_num())


def _grouped_routes(X, gid, args, depth):
    """The grouped traversal by each route on the card, whatever the
    shape: {"shared": ..., "global": ...}."""
    G, T, N = args[0].shape
    plan = forest_eval.tile_plan(G, T, N, *X.shape)
    return {"shared": forest_eval._leaf_values_grouped_shared(
                X, gid, *args, depth, plan),
            "global": forest_eval._leaf_values_grouped_global(
                X, gid, *args, depth)}


def _single_routes(X, args, depth):
    T, N = args[0].shape
    plan = forest_eval.tile_plan(1, T, N, *X.shape)
    return {"shared": forest_eval._leaf_values_shared(
                X, *args, depth=depth, plan=plan),
            "global": forest_eval._leaf_values_global(X, *args,
                                                      depth=depth)}


@pytest.mark.cuda
def test_cuda_grouped_kernel_out_of_range_gid_gives_nan_rows():
    """On the card: each route's own range guard gives the plain version's
    NaN rows and leaves the other rows bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    _, s = _stack(seed=10)
    t, X, gid = _out_of_range_rows(s, "cuda")
    args = [t[k] for k in FIELDS]
    want = forest_eval.leaf_values_grouped(X, gid, *args, t["depth"],
                                           backend="torch")
    for route, got in _grouped_routes(X, gid, args, t["depth"]).items():
        assert torch.isnan(got[:, [2, 5]]).all()
        assert _bitwise_with_nan(got, want), route


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """On the card: each kernel, by both routes, bitwise equal to its plain
    version; each launch counted under its route, the shared route the one
    chosen by shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    _, s = _stack(seed=9)
    t = {k: v.cuda() for k, v in _t(s).items()}
    rng = np.random.default_rng(4)
    X = torch.from_numpy(rng.uniform(-2, 2, size=(77, 4))).cuda()
    gid = torch.from_numpy(rng.integers(0, 4, size=77)).cuda()
    forest_eval.reset_launches()
    args = [t[k] for k in FIELDS]
    want = forest_eval.leaf_values_grouped(X, gid, *args, t["depth"],
                                           backend="torch")
    got = forest_eval.leaf_values_grouped(X, gid, *args, t["depth"])
    assert torch.equal(got, want)
    assert torch.equal(forest_eval._leaf_values_grouped_global(
        X, gid, *args, t["depth"]), want)
    args1 = [a[1] for a in args]
    depth1 = int(s["depth"][1])
    want1 = forest_eval.leaf_values(X, *args1, depth=depth1,
                                    backend="torch")
    assert torch.equal(forest_eval.leaf_values(X, *args1, depth=depth1),
                       want1)
    assert torch.equal(forest_eval._leaf_values_global(X, *args1,
                                                       depth=depth1), want1)
    assert torch.equal(forest_eval.tree_mean(got),
                       forest_eval.tree_mean(got, backend="torch"))
    assert forest_eval.launches == {
        "leaf_values_grouped": 1, "leaf_values_grouped/global": 1,
        "leaf_values": 1, "leaf_values/global": 1, "tree_mean": 1,
        "predict_grouped": 0, "predict": 0}


def _card_cases():
    """Inputs for the routes' card tests: ragged stacks with a depth-0
    group, (name, X, gid) with rows absent from some groups, out-of-range
    gids, one row, and row counts that are no multiple of a tile."""
    _, s = _stack(seed=13, n_groups=4, d=4)
    rng = np.random.default_rng(21)
    cases = []
    for m in (1, 77, 129, 511, 1000, 2100):
        cases.append((f"m={m}", rng.uniform(-2, 2, size=(m, 4)),
                      rng.integers(0, 4, size=m)))
    X = rng.uniform(-2, 2, size=(300, 4))
    cases.append(("groups 0 and 3 only", X, rng.choice([0, 3], size=300)))
    cases.append(("depth-0 group only", X, np.full(300, 2)))
    g = rng.integers(0, 4, size=300)
    g[::7], g[3::11], g[5::13] = -1, 4, 11
    cases.append(("out-of-range gids", X, g))
    return s, cases


@pytest.mark.cuda
@pytest.mark.parametrize("route", ("shared", "global"))
def test_cuda_grouped_routes_match_plain_bitwise(route):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    s, cases = _card_cases()
    t = {k: v.cuda() for k, v in _t(s).items()}
    args = [t[k] for k in FIELDS]
    for name, X, g in cases:
        X, g = torch.from_numpy(X).cuda(), torch.from_numpy(g).cuda()
        want = forest_eval.leaf_values_grouped(X, g, *args, t["depth"],
                                               backend="torch")
        got = _grouped_routes(X, g, args, t["depth"])[route]
        torch.cuda.synchronize()
        assert _bitwise_with_nan(got, want), name


@pytest.mark.cuda
@pytest.mark.parametrize("route", ("shared", "global"))
def test_cuda_single_routes_match_plain_bitwise(route):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    forests, _ = _stack(seed=14)
    rng = np.random.default_rng(22)
    for f in forests:
        a = [torch.from_numpy(np.ascontiguousarray(getattr(f, k))).cuda()
             for k in FIELDS]
        for m in (1, 12, 129, 1000):
            X = torch.from_numpy(rng.uniform(-2, 2, size=(m, 4))).cuda()
            want = forest_eval.leaf_values(X, *a, depth=f.depth,
                                           backend="torch")
            got = _single_routes(X, a, f.depth)[route]
            torch.cuda.synchronize()
            assert torch.equal(got, want), (f.depth, m)


@pytest.mark.cuda
def test_cuda_resident_blocks_of_the_paper_grid():
    """On the card: the occupancy the route choice reads at the paper
    grid's shapes, per SM: 10 grouped blocks and 12 single-forest ones
    where registers bound it (48 and 40 a thread), fewer where shared
    memory does; the fused kernels (traversal and tree mean) 7 where
    registers bound them (72 a thread, the cap of their launch bounds).
    A change to the kernel that moves these numbers moves the route
    choice, and the rows of PERF.md that rest on it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for grouped, m, per_sm, fused_per_sm in (
            (True, 76, 10, 7), (True, 512, 7, 7), (True, 1024, 5, 5),
            (True, 4096, 4, 4), (False, 12, 12, 7), (False, 1024, 4, 4)):
        plan = forest_eval.tile_plan(12 if grouped else 1, 60, 461, m, 33)
        got = forest_eval.resident_blocks(grouped, plan.smem, dev)
        assert got == sms * per_sm, (grouped, m, got)
        got = forest_eval.resident_blocks(grouped, plan.smem, dev,
                                          mean=True)
        assert got == sms * fused_per_sm, ("fused", grouped, m, got)


# ---------------------------------------------------------------------------
# the forest predictions: the traversal with its tree mean
# ---------------------------------------------------------------------------


def _predict_case(name):
    """(stack, X, gid) of one prediction case: ragged groups with a depth-0
    one, every row in the depth-0 group, no rows, gids out of range."""
    _, s = _stack(seed=15)
    rng = np.random.default_rng(31)
    X = rng.uniform(-2, 2, size=(0 if name == "empty wave" else 61, 4))
    gid = rng.integers(0, 4, size=len(X))
    if name == "depth-0 group only":
        gid[:] = 2
    if name == "out-of-range gids":
        gid[::6], gid[4::9] = -1, 4
    return s, X, gid


@pytest.mark.parametrize("name", ("ragged groups", "depth-0 group only",
                                  "empty wave", "out-of-range gids"))
def test_predict_grouped_matches_reference_bitwise(name):
    """On the CPU, the plain version of the fused grouped kernel equals
    ``repro``'s ``predict_grouped`` bit for bit on the rows with a group;
    a row whose gid lies outside ``[0, G)`` is NaN."""
    s, X, gid = _predict_case(name)
    t = _t(s)
    got = forest_eval.predict_grouped(
        torch.from_numpy(X), torch.from_numpy(gid), *(t[k] for k in FIELDS),
        t["depth"]).numpy()
    assert got.shape == (len(X),) and got.dtype == np.float64
    ok = (gid >= 0) & (gid < 4)
    assert np.isnan(got[~ok]).all() and (name != "out-of-range gids"
                                         or (~ok).sum() >= 10)
    want = ref.predict_grouped(X[ok], gid[ok], *(s[k] for k in FIELDS),
                               depth=s["depth"], backend="numpy")
    np.testing.assert_array_equal(got[ok], want)


@pytest.mark.parametrize("rows", (0, 1, 61))
def test_predict_single_matches_reference_bitwise(rows):
    """The plain version of the fused single-forest kernel equals
    ``repro``'s ``predict`` bit for bit, for every forest of a ragged
    stack, the depth-0 one included, and on no rows."""
    forests, _ = _stack(seed=16)
    X = np.random.default_rng(rows).uniform(-2, 2, size=(rows, 4))
    for f in forests:
        got = forest_eval.predict(
            torch.from_numpy(X), *(torch.from_numpy(getattr(f, k))
                                   for k in FIELDS), depth=f.depth)
        want = ref.predict(X, f.feat, f.thr, f.left, f.right, f.value,
                           depth=f.depth, backend="numpy")
        assert got.shape == (rows,)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("grouped,m", [
    (True, 1), (True, 76), (True, 512), (True, 1024), (True, 4096),
    (False, 12), (False, 1024), (False, 1025), (False, 4096)])
def test_predict_fuses_exactly_where_the_shared_route_is_taken(
        monkeypatch, grouped, m):
    """The predictions launch the fused kernel with the plan of
    :func:`route_plan` (read with the fused kernels' occupancy) where it
    picks the shared route, and the global traversal followed by the tree
    mean where it picks none. The launchers are replaced by recorders, so
    this runs without a card at the paper grid's shapes."""
    G, T, N, D = (12 if grouped else 1), 60, 461, 33
    calls = []

    def record(what):
        def fake(*a, **kw):
            calls.append((what, kw.get("plan", a[-1] if what == "fused"
                                       else None)))
            return torch.zeros(m if what in ("fused", "mean") else (T, m),
                               dtype=torch.float64)
        return fake

    def resident(grouped_, smem, device, *, mean=False):
        assert grouped_ == grouped and mean
        return _h100_resident(grouped)(smem)

    monkeypatch.setattr(_build, "route", lambda x, backend: "kernel")
    monkeypatch.setattr(forest_eval, "resident_blocks", resident)
    monkeypatch.setattr(forest_eval, "tree_mean", record("mean"))
    for fn in ("_predict_grouped_shared", "_predict_shared"):
        monkeypatch.setattr(forest_eval, fn, record("fused"))
    for fn in ("_leaf_values_grouped_global", "_leaf_values_global"):
        monkeypatch.setattr(forest_eval, fn, record("global"))
    X = torch.zeros((m, D), dtype=torch.float64)
    arrays = [torch.zeros(((G,) if grouped else ()) + (T, N), dtype=dt)
              for dt in (torch.int32, torch.float64, torch.int32,
                         torch.int32, torch.float64)]
    if grouped:
        forest_eval.predict_grouped(
            X, torch.zeros(m, dtype=torch.int64), *arrays,
            torch.zeros(G, dtype=torch.int64))
    else:
        forest_eval.predict(X, *arrays, depth=3)
    plan = forest_eval.route_plan(G, T, N, m, D, _h100_resident(grouped))
    if plan is None:
        assert calls == [("global", None), ("mean", None)]
    else:
        assert calls == [("fused", plan)]


def test_tile_counters_sized_to_row_tiles():
    """One buffer of int32 zeros per (device, stream), ceil(m / R) counters
    when first asked, grown only when a launch has more row tiles, never
    shared between two streams."""
    forest_eval._COUNTERS.clear()
    grouped = forest_eval.tile_plan(12, 60, 461, 76, 33)
    single = forest_eval.tile_plan(1, 60, 461, 1000, 33)
    assert (grouped.R, single.R) == (1536, 128)
    a = forest_eval.tile_counters(76, grouped, "cpu", 7)
    assert a.dtype == torch.int32 and a.numel() == 1 and not a.any()
    assert forest_eval.tile_counters(1536, grouped, "cpu", 7) is a
    b = forest_eval.tile_counters(1000, single, "cpu", 7)
    assert b.numel() == 8 and not b.any()
    assert forest_eval.tile_counters(4000, grouped, "cpu", 7) is b
    c = forest_eval.tile_counters(1537, grouped, "cpu", 8)
    assert c.numel() == 2 and c.data_ptr() != b.data_ptr()
    assert len(forest_eval._COUNTERS) == 2
    forest_eval._COUNTERS.clear()


def _counters_zero():
    return all(not bool(b.any()) for b in forest_eval._COUNTERS.values())


def _fused_routes(X, gid, args, depth):
    G, T, N = args[0].shape
    return forest_eval._predict_grouped_shared(
        X, gid, *args, depth, forest_eval.tile_plan(G, T, N, *X.shape))


@pytest.mark.cuda
def test_cuda_fused_grouped_matches_plain_bitwise():
    """On the card: the fused grouped kernel, forced whatever the shape,
    equals its plain version bit for bit (NaN rows where gids are out of
    range) on waves with groups absent from a tile, rows no multiple of
    R, several row tiles and one row; after every launch its tile counters
    read back zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    s, cases = _card_cases()
    t = {k: v.cuda() for k, v in _t(s).items()}
    args = [t[k] for k in FIELDS]
    for name, X, g in cases:
        X, g = torch.from_numpy(X).cuda(), torch.from_numpy(g).cuda()
        want = forest_eval.predict_grouped(X, g, *args, t["depth"],
                                           backend="torch")
        got = _fused_routes(X, g, args, t["depth"])
        torch.cuda.synchronize()
        assert _bitwise_with_nan(got, want), name
        assert _counters_zero(), name
        assert _bitwise_with_nan(
            forest_eval.predict_grouped(X, g, *args, t["depth"]), want), name


@pytest.mark.cuda
def test_cuda_fused_single_matches_plain_bitwise():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    forests, _ = _stack(seed=14)
    rng = np.random.default_rng(23)
    for f in forests:
        a = [torch.from_numpy(np.ascontiguousarray(getattr(f, k))).cuda()
             for k in FIELDS]
        for m in (1, 12, 129, 1000, 2100):
            X = torch.from_numpy(rng.uniform(-2, 2, size=(m, 4))).cuda()
            want = forest_eval.predict(X, *a, depth=f.depth, backend="torch")
            got = forest_eval._predict_shared(
                X, *a, depth=f.depth,
                plan=forest_eval.tile_plan(1, *a[0].shape, m, 4))
            torch.cuda.synchronize()
            assert torch.equal(got, want), (f.depth, m)
            assert _counters_zero(), (f.depth, m)
            assert torch.equal(forest_eval.predict(X, *a, depth=f.depth),
                               want), (f.depth, m)


@pytest.mark.cuda
def test_cuda_fused_graph_replays_repeat_bits():
    """Ten replays of a CUDA graph that holds one fused launch of several
    row tiles give the plain version's bits each time, and leave the
    counters at zero: no memset between replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    s, cases = _card_cases()
    t = {k: v.cuda() for k, v in _t(s).items()}
    args = [t[k] for k in FIELDS]
    _, X, g = cases[5]  # 2,100 rows: 5 tiles of 512
    X, g = torch.from_numpy(X).cuda(), torch.from_numpy(g).cuda()
    want = forest_eval.predict_grouped(X, g, *args, t["depth"],
                                       backend="torch")
    assert torch.equal(_fused_routes(X, g, args, t["depth"]), want)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _fused_routes(X, g, args, t["depth"])
    for _ in range(10):
        out.fill_(0.0)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        assert _counters_zero()


@pytest.mark.cuda
def test_cuda_fused_on_two_streams_at_once():
    """Fused launches issued on two streams in turns, without waiting for
    each other, each give the plain answer: each stream has its own
    counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    s, cases = _card_cases()
    t = {k: v.cuda() for k, v in _t(s).items()}
    args = [t[k] for k in FIELDS]
    inputs = [(torch.from_numpy(X).cuda(), torch.from_numpy(g).cuda())
              for _, X, g in (cases[4], cases[5])]
    wants = [forest_eval.predict_grouped(X, g, *args, t["depth"],
                                         backend="torch")
             for X, g in inputs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(_fused_routes(*inputs[i], args, t["depth"]))
    torch.cuda.synchronize()
    handles = {st.cuda_stream for st in streams}
    bufs = [b for (_, _, h), b in forest_eval._COUNTERS.items()
            if h in handles]
    assert len(bufs) == 2 and bufs[0].data_ptr() != bufs[1].data_ptr()
    for i in range(2):
        assert all(torch.equal(o, wants[i]) for o in outs[i])
    assert _counters_zero()
