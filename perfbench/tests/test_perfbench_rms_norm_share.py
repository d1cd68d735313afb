"""The norm kernel's share (``metrics/rms_norm_kernel_share.py``) on
hand-made traces, and the program's counters it reads on the CPU, where
every norm runs the eager chain."""
from __future__ import annotations

import pytest

from perfbench.tests._small import ROOT  # noqa: F401  (puts src on the path)
from perfbench.lib import catalog, tracing
from perfbench.lib.cell import RunRecord

CELLS = ("dbrx-132b.train", "mamba2-130m.train")


def _record(cell, counters=None, busy=0.5):
    wl = catalog.workload(cell)
    tr = tracing.Trace(window_s=1.0, busy_s=busy, steps=2, spans={},
                       device_ops=[], idle_gaps=[])
    if counters is not None:
        tr.counters = counters
    return RunRecord(model=catalog.config(wl["config"])["model"],
                     traffic=catalog.traffic(wl["traffic"]), itemsize=2,
                     window_steps=10, window_s=5.0, trace=tr)


READ = catalog.reader("rms_norm_kernel_share")


@pytest.mark.parametrize("counters,want", [
    ({"norm/rows": 4096, "norm/kernel_rows": 4096}, 100.0),
    ({"norm/rows": 4096}, 0.0),
    # dbrx under remat: ln1 twice and the final norm through the kernel,
    # ln2 twice through add_norm's float32 sum
    ({"norm/rows": 5 * 8192, "norm/kernel_rows": 3 * 8192}, 60.0),
    ({"ssd/backward_calls": 4}, None),   # a program without the counters
    ({}, None)])
def test_share_of_rows_through_the_kernel(counters, want):
    for cell in CELLS:
        assert READ(_record(cell, counters)) == want


def test_share_is_none_without_the_card():
    run = _record("mamba2-130m.train", {"norm/rows": 2,
                                        "norm/kernel_rows": 2}, busy=0.0)
    assert READ(run) is None


def test_metric_lists_dbrx_and_mamba():
    """Listed in the two cells whose per-layer sets are open: the set of
    ``granite-4.0-h-small.train`` is held exact by
    ``test_perfbench_hybrid_moe.py``, so that cell leaves it out, though
    its counters read as the others' do."""
    (m,) = [m for m in catalog.benchmark()["per_layer"]
            if m["name"] == "rms_norm_kernel_share"]
    assert m["workloads"] == list(CELLS)
    assert "rms_norm_kernel_share" not in {
        m["name"] for m in catalog.metrics_of("granite-4.0-h-small.train",
                                              "per_layer")}
    assert (m["moves"], m["unit"], m["source"]) == (
        "train_tokens_s", "%", "program_counter")
    assert m["layer"] == "norms (models/layers.py)"


def test_cpu_norms_count_rows_and_no_kernel_rows():
    """On the CPU the models' norm runs the eager chain: under the
    profiler the program counts its rows, and the share reads 0."""
    import torch
    from repro_torch import spans
    from repro_torch.models import layers as L
    x = torch.randn((2, 8, 64)).bfloat16()
    w = torch.ones(64)
    spans.drain()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        L.rms_norm(x, w, 1e-5)
        L.rms_norm(x, w, 1e-5, gate=x)
    counters = spans.drain()
    assert counters == {"norm/rows": 32}
    assert READ(_record("mamba2-130m.train", counters)) == 0.0
