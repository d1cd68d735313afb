"""The AdamW kernel's host side on the CPU (``repro_torch.kernels.adamw``):
its chunk table, the table kept across steps, its registered ops against
the plain versions and through their fakes, and the optimizer's route and
counters. The kernel itself runs on the card
(``tests/test_torch_train_cuda.py``).
"""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import spans
from repro_torch.analysis.opcount import OpCounter
from repro_torch.configs import base as CB
from repro_torch.kernels import adamw as AW
from repro_torch.models import model as M
from repro_torch.train import optimizer as OPT


def _mamba_shapes():
    """mamba2-130m's parameters: 314 tensors, 313 of them decaying."""
    model = M.build(CB.get_config("mamba2-130m"), device="meta")
    return [(tuple(p.shape), OPT.decays(k, p))
            for k, p in model.named_parameters()]


SIZES = {
    "edges": [((1,), True), ((3,), False), ((4095,), True),
              ((2 ** 16 + 5,), False)],
    "mamba2-130m": "mamba",
    "mixed": [((3, 7), True), ((0,), True), ((2 ** 15,), False),
              ((2 ** 15 + 1,), True), ((24,), False), ((1000, 70), True)],
}


def _shapes(case):
    spec = SIZES[case]
    return _mamba_shapes() if spec == "mamba" else spec


def _tensors(shapes, seed=0, state_dtype=torch.float32):
    rng = np.random.default_rng(seed)
    mk = lambda s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    ps = [mk(s) for s, _ in shapes]
    gs = [mk(s) for s, _ in shapes]
    ms = [(0.1 * mk(s)).to(state_dtype) for s, _ in shapes]
    vs = [(0.01 * mk(s) ** 2).to(state_dtype) for s, _ in shapes]
    return ps, gs, ms, vs


def _scalars():
    return (torch.tensor(0.75), torch.tensor(3e-4), torch.tensor(0.271),
            torch.tensor(0.1426))


HP = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


@pytest.mark.parametrize("case", list(SIZES))
def test_chunk_table_covers_every_element_once(case):
    shapes = _shapes(case)
    ps, gs, ms, vs = _tensors(shapes)
    flags = [d for _, d in shapes]
    reps = [1 + i % 3 for i in range(len(shapes))]
    ptrs = [(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr())
            for p, g, m, v in zip(ps, gs, ms, vs)]
    sizes = [p.numel() for p in ps]
    rows, table = AW.plan(ptrs, sizes, flags, reps, torch.device("cpu"))
    rows, chunks = rows.numpy(), table.chunks.numpy()
    assert rows.shape == (len(shapes), AW.ROW_WIDTH)
    assert [tuple(r) for r in rows[:, AW.ROW_P:AW.ROW_V + 1]] == ptrs
    assert list(rows[:, AW.ROW_N]) == sizes
    assert list(rows[:, AW.ROW_DECAY]) == [int(d) for d in flags]
    assert list(rows[:, AW.ROW_REPLICAS]) == reps
    assert table.nchunks == len(chunks) \
        == sum(-(-n // AW.CHUNK) for n in sizes)
    assert table.partials.shape == (len(chunks),) and int(table.done) == 0
    seen = [np.zeros(n, dtype=np.int64) for n in sizes]
    for row, offset, length in chunks:
        assert 0 < length <= AW.CHUNK and offset % AW.CHUNK == 0
        seen[row][offset:offset + length] += 1
    assert all((s == 1).all() for s in seen)
    # rows in order, so each tensor's chunks are one run of the grid
    assert (np.diff(chunks[:, 0]) >= 0).all()


def test_table_is_kept_across_steps_and_rebuilt_when_a_pointer_moves():
    shapes = SIZES["mixed"]
    ps, gs, ms, vs = _tensors(shapes)
    flags = [d for _, d in shapes]

    def get(grads, decays=flags):
        return AW.plan([(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                         v.data_ptr()) for p, g, m, v in
                        zip(ps, grads, ms, vs)], [g.numel() for g in grads],
                       decays, [1] * len(ps), torch.device("cpu"))

    AW._TABLES.clear()
    AW._ROWS.clear()
    AW.reset_launches()
    first = get(gs)
    assert AW.tables_built == {"chunks": 1, "rows": 1}
    again = get(gs)
    assert again[0] is first[0] and again[1] is first[1]
    assert AW.tables_built == {"chunks": 1, "rows": 1}
    moved = list(gs)
    moved[2] = gs[2].clone()                  # a new gradient's storage
    second = get(moved)
    assert second[0] is not first[0] and second[1] is first[1]
    assert AW.tables_built == {"chunks": 1, "rows": 2}
    assert second[0][2, AW.ROW_G] == moved[2].data_ptr()
    assert get(gs)[0] is first[0]             # the first is still kept
    assert get(gs, [not d for d in flags])[0] is not first[0]
    assert AW.tables_built == {"chunks": 1, "rows": 3}
    grown = [torch.zeros(5)] + list(gs[1:])   # another size: a new table
    assert get(grown)[1] is not first[1]
    assert AW.tables_built == {"chunks": 2, "rows": 4}


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
def test_update_op_equals_plain_version_bit_for_bit(state_dtype):
    shapes = SIZES["mixed"]
    flags = [d for _, d in shapes]
    got = _tensors(shapes, seed=1, state_dtype=state_dtype)
    want = _tensors(shapes, seed=1, state_dtype=state_dtype)
    torch.ops.repro_torch.adamw_update(got[0], got[1], got[2], got[3], flags,
                                       *_scalars(), *HP.values())
    AW.update_plain(*want, flags, *_scalars(), *HP.values())
    for a, b in zip(got[0] + got[2] + got[3], want[0] + want[2] + want[3]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not torch.equal(got[0][0], _tensors(shapes, seed=1)[0][0])


def test_sumsq_op_equals_plain_version():
    _, gs, _, _ = _tensors(SIZES["mixed"], seed=2)
    reps = [1, 2, 1, 4, 1, 2]
    got = torch.ops.repro_torch.adamw_sumsq(gs, reps)
    assert got.shape == () and got.dtype == torch.float32
    assert torch.equal(got, AW.sumsq_plain(gs, reps))
    assert torch.equal(OPT.global_norm(dict(enumerate(gs))),
                       torch.sqrt(AW.sumsq_plain(gs, [1] * len(gs))))


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
def test_ops_trace_through_their_fakes(state_dtype):
    AW.reset_launches()
    with FakeTensorMode():
        ps = [torch.empty(4096, 64), torch.empty(7)]
        ms = [torch.empty_like(p, dtype=state_dtype) for p in ps]
        with OpCounter() as c:
            sq = AW.sumsq_op(ps, [1, 1])
            AW.update_op(ps, ps, ms, ms, [True, False], sq, sq, sq, sq,
                         *HP.values())
    assert sq.shape == () and sq.dtype == torch.float32
    assert c.kernel_nodes("adamw_sumsq") == 1
    assert c.kernel_nodes("adamw_update") == 1
    assert set(c.summary.by_opcode) == {"repro_torch.adamw_sumsq",
                                        "repro_torch.adamw_update"}
    assert AW.launches == {"adamw_sumsq": 0, "adamw_update": 0}


def _problem(shapes, state_dtype="float32"):
    ps, gs, _, _ = _tensors(shapes, seed=3)
    names = [f"blocks.{i}.w" if d else f"top{i}" for i, (_, d) in
             enumerate(shapes)]
    params = dict(zip(names, ps))
    grads = dict(zip(names, gs))
    hp = OPT.OptHParams(state_dtype=state_dtype, warmup_steps=2)
    return params, grads, OPT.init_state(params, hp), hp


def _fake_step(shapes):
    with FakeTensorMode():
        params, grads, state, hp = _problem(shapes, "bfloat16")
        with OpCounter() as c:
            OPT.apply_updates(params, grads, state, hp)
    return c, sum(p.numel() for p in params.values())


def test_apply_updates_on_fake_tensors_is_two_kernel_nodes():
    """The dry-run's trace of the optimizer: the norm and the update one
    node each, and the same ops whatever the number of tensors (the
    schedule's and the clip's scalars), no eager chain per tensor."""
    c, n = _fake_step(SIZES["mixed"])
    small, _ = _fake_step(SIZES["edges"])
    assert c.kernel_nodes("adamw_sumsq") == 1
    assert c.kernel_nodes("adamw_update") == 1
    counts = lambda k: {op: r["count"]  # noqa: E731
                        for op, r in k.summary.by_opcode.items()}
    assert counts(c) == counts(small)
    rec = c.summary.by_opcode
    assert rec["repro_torch.adamw_sumsq"]["bytes"] == 4 * n
    assert rec["repro_torch.adamw_update"]["bytes"] == 20 * n


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_apply_updates_counts_its_elements(backend):
    """CPU tensors take the eager version, through the ops or not: the
    counters show every element updated and none by a launch of the kernel
    (which counts its own, on the card)."""
    params, grads, state, hp = _problem(SIZES["mixed"])
    spans.drain()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        OPT.apply_updates(params, grads, state, hp, backend=backend)
    counters = spans.drain()
    n = sum(p.numel() for p in params.values())
    assert counters["optimizer/elements"] == n
    assert "optimizer/kernel_elements" not in counters


def test_no_counts_without_a_profiler():
    params, grads, state, hp = _problem(SIZES["edges"])
    spans.drain()
    OPT.apply_updates(params, grads, state, hp)
    assert spans.drain() == {}


@pytest.mark.parametrize("backend,want", [("auto", 1), ("torch", 0),
                                          ("xla", ValueError),
                                          ("triton", ValueError)])
def test_optimizer_ops_on_cpu_tensors(backend, want):
    """``"auto"`` calls the ops on every device (their CPU version is the
    plain one), ``"torch"`` never, any other backend raises."""
    params, grads, state, hp = _problem(SIZES["edges"])
    if want is ValueError:
        with pytest.raises(ValueError, match="unknown backend"):
            OPT.apply_updates(params, grads, state, hp, backend=backend)
        return
    with OpCounter() as c:
        OPT.apply_updates(params, grads, state, hp, backend=backend)
    assert c.kernel_nodes("adamw_sumsq") == c.kernel_nodes(
        "adamw_update") == want


def test_kernel_on_cpu_tensors_raises():
    params, grads, state, hp = _problem(SIZES["edges"])
    ps, gs = list(params.values()), list(grads.values())
    ms, vs = list(state["m"].values()), list(state["v"].values())
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        AW.kernel_sumsq(gs, [1] * len(gs))
    one = torch.ones(())
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        AW.kernel_update(ps, gs, ms, vs, [True] * len(ps), one, one, one,
                         one, 0.9, 0.95, 1e-8, 0.1)


_X = torch.zeros(64, 64)


@pytest.mark.parametrize("t,want", [
    (_X, True), (_X.t(), True), (_X[:, ::2], False), (_X[::2], False),
    (_X[:1], True), (torch.zeros(0, 5), True), (torch.zeros(()), True),
    (torch.zeros(3, 1, 4).permute(2, 1, 0), True),
    (_X.expand(2, 64, 64), False), (torch.zeros(4, 4)[1:3], True),
    (torch.zeros(4, 4)[:, 1:3], False)])
def test_dense_is_torchs_rule(t, want):
    """The kernel walks a tensor in memory order: what it takes is what
    torch calls non-overlapping and dense."""
    from torch._prims_common import is_non_overlapping_and_dense_or_false
    assert AW.dense(t) == want == is_non_overlapping_and_dense_or_false(t)
