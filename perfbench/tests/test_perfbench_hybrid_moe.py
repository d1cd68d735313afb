"""The ``granite-4.0-h-small.train`` cell's own files and yardsticks on the
CPU: every file found by name, the step's model FLOPs against a hand count
at the SMOKE size, the readers of the held experts' time and slot fill
against what a SMOKE step with the spans on records, and the fp8 control
coming out not correct at the SMOKE size (the planted faults are
``test_perfbench_faults.py``'s, over every cell)."""
from __future__ import annotations

import pytest
import torch

from perfbench.tests._small import ROOT, small  # noqa: F401
from perfbench.lib import catalog, cell as CELL, compare, tracing
from perfbench.lib.cell import RunRecord

CELL_NAME = "granite-4.0-h-small.train"
NEW_METRICS = ("hybrid_train_mfu", "moe_experts_ms", "expert_share_fill")
WORK = catalog.module("metrics", "hybrid_step_work")


def test_catalog_finds_every_new_file():
    wl = catalog.workload(CELL_NAME)
    assert (wl["config"], wl["traffic"], wl["chips"]) == (
        "granite-4.0-h-small-p1", "train-b4-s4096", 1)
    conf = catalog.config(wl["config"])
    assert conf["model"]["family"] == "hybrid_moe"
    assert (conf["model"]["num_layers"], conf["model"]["num_experts"],
            conf["model"]["router_experts"]) == (10, 9, 72)
    # the catalog's published configuration, every number as published
    assert (conf["num_hidden_layers"], conf["num_local_experts"],
            conf["num_experts_per_tok"]) == (40, 72, 10)
    traffic = catalog.traffic(wl["traffic"])
    assert (traffic["global_batch"], traffic["seq_len"],
            traffic["microbatches"]) == (4, 4096, 1)
    assert catalog.limits(CELL_NAME)
    from perfbench.reference import train as RT
    assert RT.family("hybrid_moe").accumulate_grads
    per_layer = {m["name"] for m in catalog.metrics_of(CELL_NAME,
                                                       "per_layer")}
    assert per_layer == set(NEW_METRICS)
    for name in NEW_METRICS:
        assert callable(catalog.reader(name))
    # and no accepted cell reports them
    for cell in ("dbrx-132b.train", "mamba2-130m.train"):
        names = {m["name"] for m in catalog.metrics_of(cell, "per_layer")}
        assert not names & set(NEW_METRICS)


def test_model_flops_by_hand_at_the_smoke_size():
    conf, traffic = small(CELL_NAME)
    m = conf["model"]
    # d 64, d_inner 128 (8 SSD heads of 16), N 16; 4 kv-grouped heads of 16
    # (2 kv); router 8, 2 of 8 experts held top-3 of width 32, shared 48;
    # layers mamba, mamba, attention, mamba; head over 256 ids
    mamba = 64 * (2 * 128 + 2 * 16 + 8) + 128 * 64
    attn = 2 * 64 * 4 * 16 + 2 * 64 * 2 * 16
    ffn = 64 * 8 + 3 * 64 * 48 + 3 * 2 * 3 * 64 * 32 / 8
    hand = 3 * mamba + attn + 4 * ffn + 64 * 256
    assert WORK.matmul_params(m) == hand
    B, S = traffic["global_batch"], traffic["seq_len"]
    ssd = catalog.module("metrics", "ssd_scan_work").work(
        B, S, 8, 16, 16, 32, 2)[1]
    att = 4 * 16 * B * 4 * S * (S + 1) // 2
    assert WORK.step_flops(m, traffic) == 6 * hand * B * S + 3 * (
        3 * ssd + att)
    # at the cell's own size: 1.68 G parameters a token, 1.717e14 a step
    wl = catalog.workload(CELL_NAME)
    m = catalog.config(wl["config"])["model"]
    assert WORK.matmul_params(m) == 1_682_767_872
    assert round(WORK.step_flops(m, catalog.traffic(wl["traffic"])) / 1e12,
                 1) == 171.7


def _record(model, traffic, spans=None, counters=None, busy=0.5):
    tr = tracing.Trace(window_s=1.0, busy_s=busy, steps=2, spans=spans or {},
                       device_ops=[], idle_gaps=[])
    if counters is not None:
        tr.counters = counters
    return RunRecord(model=model, traffic=traffic, itemsize=2,
                     window_steps=10, window_s=5.0, trace=tr)


def test_readers_against_a_smoke_step_with_the_spans_on():
    """A SMOKE train step under the profiler: the share's counters and the
    spans the readers take, then the readers on a trace holding them."""
    from repro_torch import spans
    conf, traffic = small(CELL_NAME, dtype="float32")
    trainer = CELL.build_program(torch, conf, traffic, 2 ** 31 + 5, "cpu")
    spans.drain()
    tr = tracing.capture(torch, lambda: trainer.train_one(), 1)
    counters = spans.drain()
    m = conf["model"]
    C = max(1, int(traffic["seq_len"] * m["num_experts_per_tok"]
                   / m["router_experts"] * m["capacity_factor"]))
    slots = m["num_layers"] * traffic["global_batch"] * m["num_experts"] * C
    assert counters["moe/held_slots"] == slots
    assert 0 < counters["moe/held_kept"] <= counters["moe/held_choices"]
    # the forward and each layer's remat recompute run the span; the
    # backward is one autograd node per layer
    assert tr.spans["moe/experts"][1] == 2 * m["num_layers"]
    assert tr.spans["MoEExpertsBackward"][1] == m["num_layers"]
    assert tr.spans["moe/shared"][1] == 2 * m["num_layers"]
    run = _record(m, traffic, spans={"moe/experts": (0.030, 20),
                                     "MoEExpertsBackward": (0.050, 10)},
                  counters=counters)
    assert catalog.reader("expert_share_fill")(run) == pytest.approx(
        100 * counters["moe/held_kept"] / slots)
    assert catalog.reader("moe_experts_ms")(run) == pytest.approx(40.0)
    step = WORK.step_flops(m, traffic)
    assert catalog.reader("hybrid_train_mfu")(run) == pytest.approx(
        100 * step / 0.5 / 989e12)
    # nothing to read: none, never 0 (no card, a program without the
    # share, another family)
    assert catalog.reader("expert_share_fill")(
        _record(m, traffic, counters=counters, busy=0.0)) is None
    assert catalog.reader("expert_share_fill")(
        _record(m, traffic, counters={"moe/kept": 3})) is None
    assert catalog.reader("moe_experts_ms")(_record(m, traffic)) is None
    dbrx = catalog.config("dbrx-132b-l1")["model"]
    assert catalog.reader("hybrid_train_mfu")(_record(dbrx, traffic)) is None


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
