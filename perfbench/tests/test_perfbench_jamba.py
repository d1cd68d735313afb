"""The ``jamba2-3b.train`` cell's own files and yardsticks on the CPU: every
file found by name, the three new per-layer metrics among the cell's and
reported by no accepted cell, the selective scan's operations and bytes
against a hand count, each reader on a hand-made trace and counters and
None without them, and the fp8 control coming out not correct at the SMOKE
size (the planted faults are ``test_perfbench_faults.py``'s, over every
cell)."""
from __future__ import annotations

import pytest
import torch

from perfbench.tests._small import ROOT, small  # noqa: F401
from perfbench.lib import catalog, cell as CELL, compare, tracing
from perfbench.lib.cell import RunRecord

CELL_NAME = "jamba2-3b.train"
NEW_METRICS = ("selective_scan_roofline", "selective_scan_backward_ms",
               "selective_scan_kernel_share")
ACCEPTED = ("dbrx-132b.train", "mamba2-130m.train",
            "granite-4.0-h-small.train")
WORK = catalog.module("metrics", "selective_scan_work")


def test_catalog_finds_every_new_file():
    wl = catalog.workload(CELL_NAME)
    assert (wl["config"], wl["traffic"], wl["chips"]) == (
        "jamba2-3b", "train-b1-s16384", 1)
    conf = catalog.config(wl["config"])
    m = conf["model"]
    assert m["family"] == "jamba" and conf["reduced"] == {}
    assert (m["num_layers"], m["d_model"], m["ssm_state"], m["ssm_dt_rank"],
            m["num_heads"], m["num_kv_heads"], m["head_dim"], m["d_ff"],
            m["vocab_size"]) == (28, 2560, 16, 160, 20, 1, 128, 8192, 65536)
    assert m["ssm_expand"] * m["d_model"] == 5120
    pat = m["hybrid_pattern"]
    assert [i for i in range(28) if pat[i % len(pat)] == "attention"] \
        == [7, 21]
    # the catalog's published configuration, every number as published
    assert (conf["num_hidden_layers"], conf["attn_layer_offset"],
            conf["attn_layer_period"], conf["mamba_dt_rank"],
            conf["mamba_d_state"], conf["num_key_value_heads"]) \
        == (28, 7, 14, 160, 16, 1)
    traffic = catalog.traffic(wl["traffic"])
    assert (traffic["global_batch"], traffic["seq_len"],
            traffic["microbatches"]) == (1, 16384, 1)
    assert catalog.limits(CELL_NAME)
    from perfbench.reference import train as RT
    assert RT.family("jamba").accumulate_grads
    per_layer = {m["name"] for m in catalog.metrics_of(CELL_NAME,
                                                       "per_layer")}
    # the new metrics are the cell's; a later benchmark may list the cell
    # under accepted metrics too, so the set is not pinned
    assert per_layer >= set(NEW_METRICS)
    for name in NEW_METRICS:
        assert callable(catalog.reader(name))
    for cell in ACCEPTED:
        names = {m["name"] for m in catalog.metrics_of(cell, "per_layer")}
        assert not names & set(NEW_METRICS)


@pytest.mark.parametrize("size", ["smoke", "cell"])
def test_scan_work_by_hand(size):
    """The frozen counts against a hand count and the port's own."""
    from repro_torch.kernels import selective_scan as SS
    if size == "smoke":
        conf, traffic = small(CELL_NAME)
        m = conf["model"]
    else:
        wl = catalog.workload(CELL_NAME)
        m = catalog.config(wl["config"])["model"]
        traffic = catalog.traffic(wl["traffic"])
    B, S = traffic["global_batch"], traffic["seq_len"]
    Dc, N = m["ssm_expand"] * m["d_model"], m["ssm_state"]
    nbytes, ops = WORK.work(B, S, Dc, N, 2)
    assert nbytes == 2 * (4 * B * S * Dc + 2 * B * S * N) \
        + 4 * (Dc * N + 2 * Dc)
    assert ops == B * S * Dc * (7 * N + 11)
    u = torch.empty(B, S, Dc, dtype=torch.bfloat16, device="meta")
    Bm = torch.empty(B, S, N, dtype=torch.bfloat16, device="meta")
    assert SS.work(u, Bm) == (nbytes, ops)
    if size == "cell":     # 0.67 GB and 10.3 GFLOP: bytes bound, 0.20 ms
        assert (nbytes, ops) == (672_505_856, 10_317_987_840)


def _record(model, traffic, spans=None, counters=None, busy=0.5):
    tr = tracing.Trace(window_s=1.0, busy_s=busy, steps=2, spans=spans or {},
                       device_ops=[], idle_gaps=[])
    if counters is not None:
        tr.counters = counters
    return RunRecord(model=model, traffic=traffic, itemsize=2,
                     window_steps=10, window_s=5.0, trace=tr)


def test_counters_of_a_smoke_step_with_the_spans_on():
    """A SMOKE train step under the profiler on the CPU: every Mamba layer
    calls the scan twice (the forward and its remat recompute) and runs
    its backward once, and no kernel launches."""
    from repro_torch import spans
    conf, traffic = small(CELL_NAME, dtype="float32")
    trainer = CELL.build_program(torch, conf, traffic, 2 ** 31 + 5, "cpu")
    spans.drain()
    tr = tracing.capture(torch, lambda: trainer.train_one(), 1)
    counters = spans.drain()
    m = conf["model"]
    pat = m["hybrid_pattern"]
    mamba = sum(pat[i % len(pat)] == "mamba1" for i in range(m["num_layers"]))
    assert counters["selective_scan/calls"] == 3 * mamba
    assert "selective_scan/kernel_calls" not in counters
    assert tr.spans["SelectiveScanBackward"][1] == mamba
    run = _record(m, traffic, counters=counters)
    assert catalog.reader("selective_scan_kernel_share")(run) == 0.0


def test_readers_on_a_hand_made_trace():
    wl = catalog.workload(CELL_NAME)
    m = catalog.config(wl["config"])["model"]
    traffic = catalog.traffic(wl["traffic"])
    op = "repro_torch::selective_scan"
    run = _record(m, traffic,
                  spans={op: (0.104, 104),
                         "SelectiveScanBackward": (0.26, 52)},
                  counters={"selective_scan/calls": 156,
                            "selective_scan/kernel_calls": 156})
    nbytes, ops = WORK.work(1, 16384, 5120, 16, 2)
    bound = max(ops / 67e12, nbytes / 3.35e12)
    assert catalog.reader("selective_scan_roofline")(run) == pytest.approx(
        100 * bound / 1e-3)
    assert catalog.reader("selective_scan_backward_ms")(run) \
        == pytest.approx(130.0)
    assert catalog.reader("selective_scan_kernel_share")(run) == 100.0
    # nothing to read: None, never 0 (no trace, no card, a program without
    # the op, the node or the counters)
    for name in NEW_METRICS:
        assert catalog.reader(name)(_record(m, traffic)) is None
        assert catalog.reader(name)(RunRecord(
            model=m, traffic=traffic, itemsize=2, window_steps=10,
            window_s=5.0, trace=None)) is None
    assert catalog.reader("selective_scan_kernel_share")(_record(
        m, traffic, counters={"selective_scan/calls": 4}, busy=0.0)) is None


def test_control_fails_at_the_smoke_size():
    """The reference in fp8 against the reference in float32, under the
    cell's own limits, at the SMOKE size."""
    conf, traffic = small(CELL_NAME)
    seed = 2 ** 31 + 777
    steps = traffic["compare_steps"]
    ref = CELL.reference_readings(conf, traffic, seed, steps, "cpu")
    fp8 = CELL.reference_readings(conf, traffic, seed, steps, "cpu",
                                  prec="fp8")
    ok, checks = compare.verdict(compare.numbers(fp8, ref),
                                 catalog.limits(CELL_NAME))
    assert not ok, checks
