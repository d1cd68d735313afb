"""The train step by phase (``lib/phases.py``) on hand-made intervals, the
readers of the program's spans and counters (``data_wait_ms``,
``step_launches``, ``moe_slot_fill``) on hand-made traces, the parent
program's case among them, and ``tools/trace_phases.py`` on the CPU at the
SMOKE size."""
from __future__ import annotations

import sys

import pytest

from perfbench.tests._small import small
from perfbench.lib import catalog, phases, tracing
from perfbench.lib.cell import RunRecord

# two steps: data, forward, backward, optimizer, readback in each
SPANS = [("train_step", 0, 100), ("train_step/data", 0, 10),
         ("train_step/forward", 10, 40), ("train_step/backward", 40, 80),
         ("train_step/optimizer", 80, 95), ("train_step/readback", 95, 100),
         ("train_step", 110, 200), ("train_step/forward", 110, 150),
         ("aten::mm", 120, 130)]


def test_pieces_take_the_innermost_span():
    segs = phases.pieces(SPANS)
    assert segs[:5] == [[0, 10, "train_step/data"],
                        [10, 40, "train_step/forward"],
                        [40, 80, "train_step/backward"],
                        [80, 95, "train_step/optimizer"],
                        [95, 100, "train_step/readback"]]
    assert segs[5:] == [[110, 120, "train_step/forward"],
                        [120, 130, "aten::mm"],
                        [130, 150, "train_step/forward"],
                        [150, 200, "train_step"]]


def test_gaps_split_by_overlap_and_outside_takes_the_rest():
    gaps = [(5, 15), (38, 42), (90, 115), (140, 160), (205, 210)]
    got = phases.split_idle(gaps, SPANS)
    # (5, 15) across data and forward; (90, 115) across the optimizer,
    # the readback, the time between steps and the next forward; (140,
    # 160) into the step's own tail
    assert got == {"train_step/data": 5, "train_step/forward": 5 + 2 + 5 + 10,
                   "train_step/backward": 2, "train_step/optimizer": 5,
                   "train_step/readback": 5, phases.OUTSIDE: 10 + 5,
                   "train_step": 10}
    assert sum(got.values()) == sum(b - a for a, b in gaps)


def test_launches_by_the_span_their_start_falls_in():
    starts = [1, 12, 45, 46, 47, 99, 105, 125, 160, 250]
    got = phases.count_launches(starts, SPANS)
    assert got == {"train_step/data": 1, "train_step/forward": 1,
                   "train_step/backward": 3, "train_step/readback": 1,
                   phases.OUTSIDE: 2, "aten::mm": 1, "train_step": 1}


def test_table_keeps_the_phases_alone():
    got = phases.table([(5, 15), (205, 210)], SPANS, [45, 125])
    assert set(got) == set(phases.PHASES) | {phases.OUTSIDE}
    # aten::mm's stretch and its launch go to the phase around it
    assert got["train_step/forward"] == {
        "host_s": 70e-6, "idle_s": pytest.approx(5e-6), "launches": 1,
        "calls": 2}
    assert got["train_step"]["calls"] == 2
    assert got[phases.OUTSIDE]["idle_s"] == pytest.approx(5e-6)


def _record(cell, spans=None, busy=0.5, counters=None, steps=3):
    wl = catalog.workload(cell)
    tr = tracing.Trace(window_s=1.0, busy_s=busy, steps=steps,
                       spans=spans or {}, device_ops=[], idle_gaps=[])
    if counters is not None:
        tr.counters = counters
    return RunRecord(model=catalog.config(wl["config"])["model"],
                     traffic=catalog.traffic(wl["traffic"]), itemsize=2,
                     window_steps=10, window_s=5.0, trace=tr)


def test_readers_of_the_programs_spans_and_counters():
    spans = {"train_step": (1.7, 3), "cudaLaunchKernel": (0.0, 5400),
             "cuLaunchKernelEx": (0.0, 600), "aten::mm": (0.2, 30)}
    counters = {"train_step/data:host_ns": 4_500_000,
                "train_step/data:calls": 3, "moe/kept": 70_000,
                "moe/choices": 98_304, "moe/slots": 122_880}
    run = _record("dbrx-132b.train", spans, counters=counters)
    read = lambda name: catalog.reader(name)(run)  # noqa: E731
    assert read("data_wait_ms") == pytest.approx(1.5)
    assert read("step_launches") == 2000
    assert read("moe_slot_fill") == pytest.approx(100 * 70_000 / 122_880)
    # nothing to read: no value, never 0
    run.trace.counters = {"train_step/data:host_ns": 4_500_000}
    assert read("moe_slot_fill") is None
    run.trace = None
    for name in ("data_wait_ms", "step_launches", "moe_slot_fill"):
        assert read(name) is None


def test_readers_give_none_on_a_program_without_spans(monkeypatch):
    """The parent program: no ``repro_torch.spans``, no ``train_step``
    span; the trace has the accepted fields alone."""
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    run = _record("dbrx-132b.train", {"train_step/optimizer": (0.8, 3),
                                      "cudaLaunchKernel": (0.0, 5400)})
    assert not hasattr(run.trace, "counters")
    for name in ("data_wait_ms", "step_launches", "moe_slot_fill"):
        assert catalog.reader(name)(run) is None
    assert run.trace.counters == {}


def test_readers_give_none_without_the_card():
    run = _record("dbrx-132b.train", {"train_step": (0.0, 3)}, busy=0.0,
                  counters={"train_step/data:host_ns": 10, "moe/slots": 5,
                            "moe/kept": 4})
    for name in ("data_wait_ms", "step_launches", "moe_slot_fill"):
        assert catalog.reader(name)(run) is None


def test_trace_phases_on_the_cpu():
    """The tool's measurement at the SMOKE size: every phase found, the
    phases' idle time the whole of the traced interval's (nothing ran on a
    device), two steps' spans, and the MoE's choices counted once a
    forward."""
    import torch
    tool = catalog.module("tools", "trace_phases")
    conf, traffic = small("dbrx-132b.train", dtype="float32")
    traffic = dict(traffic, compare_steps=1)
    res = tool.measure(torch, conf, traffic, 7, "cpu", warm=0, steps=2)
    table = res["phases"]
    assert set(phases.PHASES) <= set(table)
    assert {p: table[p]["calls"] for p in phases.PHASES} == {
        "train_step": 2, "train_step/data": 2, "train_step/forward": 2,
        "train_step/backward": 2, "train_step/optimizer": 2,
        "train_step/readback": 2}
    assert res["busy_s"] == 0
    held = sum(v["idle_s"] for v in table.values())
    assert held == pytest.approx(res["idle_s"]) and res["idle_s"] > 0
    assert res["idle_s"] == pytest.approx(res["traced_s"])
    m = conf["model"]
    assert res["counters"]["moe/choices"] == (
        2 * traffic["global_batch"] * traffic["seq_len"]
        * m["num_experts_per_tok"] * m["num_layers"])
    assert 0 < res["per_step"]["moe_slot_fill"] <= 100
    assert res["counters"]["train_step/data:calls"] == 2
