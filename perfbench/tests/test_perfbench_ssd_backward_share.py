"""The SSD backward kernel's share (``metrics/ssd_backward_kernel_share.py``)
on hand-made traces, and the program's counters it reads on the CPU, where
every backward recomputes ``ssd_chunked``."""
from __future__ import annotations

import pytest

from perfbench.tests._small import ROOT  # noqa: F401  (puts src on the path)
from perfbench.lib import catalog, tracing
from perfbench.lib.cell import RunRecord

CELLS = ("mamba2-130m.train", "granite-4.0-h-small.train")


def _record(cell, counters=None, busy=0.5):
    wl = catalog.workload(cell)
    tr = tracing.Trace(window_s=1.0, busy_s=busy, steps=2, spans={},
                       device_ops=[], idle_gaps=[])
    if counters is not None:
        tr.counters = counters
    return RunRecord(model=catalog.config(wl["config"])["model"],
                     traffic=catalog.traffic(wl["traffic"]), itemsize=2,
                     window_steps=10, window_s=5.0, trace=tr)


READ = catalog.reader("ssd_backward_kernel_share")


@pytest.mark.parametrize("counters,want", [
    ({"ssd/backward_calls": 48, "ssd/backward_kernel_calls": 48}, 100.0),
    ({"ssd/backward_calls": 48}, 0.0),
    ({"ssd/backward_calls": 18, "ssd/backward_kernel_calls": 9}, 50.0),
    ({"optimizer/elements": 4}, None),   # a program without the counters
    ({}, None)])
def test_share_of_backwards_through_the_kernel(counters, want):
    for cell in CELLS:
        assert READ(_record(cell, counters)) == want


def test_share_is_none_without_the_card():
    run = _record("mamba2-130m.train", {"ssd/backward_calls": 2,
                                        "ssd/backward_kernel_calls": 2},
                  busy=0.0)
    assert READ(run) is None


def test_metric_lists_both_mamba_cells():
    """The metric is listed in ``mamba2-130m.train`` alone: the per-layer
    set of ``granite-4.0-h-small.train`` is held exact by
    ``test_perfbench_hybrid_moe.py``, so that cell leaves it out, though
    its counters read as the other's do (the test above)."""
    (m,) = [m for m in catalog.benchmark()["per_layer"]
            if m["name"] == "ssd_backward_kernel_share"]
    assert m["workloads"] == ["mamba2-130m.train"]
    assert "ssd_backward_kernel_share" not in {
        m["name"] for m in catalog.metrics_of("granite-4.0-h-small.train",
                                              "per_layer")}
    assert m["moves"] == "train_tokens_s"
    assert m["layer"] == "SSD kernel (kernels/ssd_scan.py)"


def test_cpu_backward_counts_a_call_and_no_kernel_launch():
    """On the CPU the SSD scan's backward recomputes ``ssd_chunked``: under
    the profiler the program counts the call, and the share reads 0."""
    import torch
    from repro_torch import spans
    from repro_torch.kernels import ssd_scan as ssd
    g = torch.Generator().manual_seed(0)
    X = torch.randn((1, 32, 2, 16), generator=g, requires_grad=True)
    Adt = -torch.rand((1, 32, 2), generator=g)
    Bc = torch.randn((1, 32, 16), generator=g)
    spans.drain()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        ssd.ssd_scan(X, Adt, Bc, Bc, chunk=16).sum().backward()
    counters = spans.drain()
    assert counters == {"ssd/backward_calls": 1}
    assert READ(_record("mamba2-130m.train", counters)) == 0.0
