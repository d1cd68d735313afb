"""The port's forest kernels' plain versions (``repro_torch.kernels.
forest_eval``) against the reference traversals of ``repro.kernels.
forest_eval``.

Tolerances: routing is a pure float64 comparison and the tree mean adds
trees in the same order with the same float64 operations, so every
comparison with the float64 numpy reference is bitwise. Against the Pallas
kernels (float32, interpret mode) the forests and inputs are first
quantized to float32, so routing agrees exactly there too, and the float32
leaf values compare exactly. The CUDA kernels themselves run only on the
card: the ``cuda``-marked test skips here.
"""
import numpy as np
import pytest
import torch

from repro.core.regressors import RandomForestRegressor
from repro.kernels import forest_eval as ref
from repro_torch.kernels import forest_eval


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


def test_cpu_calls_launch_nothing_and_cuda_backend_raises():
    _, s = _stack(seed=8)
    t = _t(s)
    X = torch.zeros((3, 4), dtype=torch.float64)
    gid = torch.zeros(3, dtype=torch.int64)
    before = dict(forest_eval.launches)
    forest_eval.predict_grouped(X, gid, *(t[k] for k in FIELDS), t["depth"])
    assert forest_eval.launches == before
    with pytest.raises(ValueError, match="backend='cuda' needs CUDA"):
        forest_eval.leaf_values_grouped(X, gid, *(t[k] for k in FIELDS),
                                        t["depth"], backend="cuda")
    with pytest.raises(ValueError, match="backend='cuda' needs CUDA"):
        forest_eval.leaf_values(X, *(t[k][0] for k in FIELDS), depth=2,
                                backend="cuda")
    with pytest.raises(ValueError, match="backend='cuda' needs CUDA"):
        forest_eval.tree_mean(torch.zeros((4, 3), dtype=torch.float64),
                              backend="cuda")
    with pytest.raises(ValueError, match="unknown forest_eval backend"):
        forest_eval.tree_mean(torch.zeros((4, 3), dtype=torch.float64),
                              backend="pallas")


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


@pytest.mark.cuda
def test_cuda_grouped_kernel_out_of_range_gid_gives_nan_rows():
    """On the card: the kernel's own range guard gives the plain version's
    NaN rows and leaves the other rows bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    _, s = _stack(seed=10)
    t, X, gid = _out_of_range_rows(s, "cuda")
    args = [t[k] for k in FIELDS]
    got = forest_eval.leaf_values_grouped(X, gid, *args, t["depth"],
                                          backend="cuda")
    want = forest_eval.leaf_values_grouped(X, gid, *args, t["depth"],
                                           backend="torch")
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got[:, [2, 5]]).all()
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """On the card: each kernel bitwise equal to its plain version, each
    launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    _, s = _stack(seed=9)
    t = {k: v.cuda() for k, v in _t(s).items()}
    rng = np.random.default_rng(4)
    X = torch.from_numpy(rng.uniform(-2, 2, size=(77, 4))).cuda()
    gid = torch.from_numpy(rng.integers(0, 4, size=77)).cuda()
    forest_eval.reset_launches()
    args = [t[k] for k in FIELDS]
    got = forest_eval.leaf_values_grouped(X, gid, *args, t["depth"])
    want = forest_eval.leaf_values_grouped(X, gid, *args, t["depth"],
                                           backend="torch")
    assert torch.equal(got, want)
    got1 = forest_eval.leaf_values(X, *(a[1] for a in args),
                                   depth=int(s["depth"][1]))
    want1 = forest_eval.leaf_values(X, *(a[1] for a in args),
                                    depth=int(s["depth"][1]),
                                    backend="torch")
    assert torch.equal(got1, want1)
    assert torch.equal(forest_eval.tree_mean(got),
                       forest_eval.tree_mean(got, backend="torch"))
    assert forest_eval.launches == {"leaf_values_grouped": 1,
                                    "leaf_values": 1, "tree_mean": 1}
