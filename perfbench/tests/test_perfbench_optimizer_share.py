"""The optimizer's kernel share (``metrics/optimizer_kernel_share.py``) on
hand-made traces, and the program's counters it reads on the CPU's eager
path."""
from __future__ import annotations

import pytest

from perfbench.tests._small import ROOT  # noqa: F401  (puts src on the path)
from perfbench.lib import catalog, tracing
from perfbench.lib.cell import RunRecord


def _record(cell, counters=None, busy=0.5):
    wl = catalog.workload(cell)
    tr = tracing.Trace(window_s=1.0, busy_s=busy, steps=2, spans={},
                       device_ops=[], idle_gaps=[])
    if counters is not None:
        tr.counters = counters
    return RunRecord(model=catalog.config(wl["config"])["model"],
                     traffic=catalog.traffic(wl["traffic"]), itemsize=2,
                     window_steps=10, window_s=5.0, trace=tr)


READ = catalog.reader("optimizer_kernel_share")


@pytest.mark.parametrize("counters,want", [
    ({"optimizer/elements": 900, "optimizer/kernel_elements": 900}, 100.0),
    ({"optimizer/elements": 900, "optimizer/kernel_elements": 0}, 0.0),
    ({"optimizer/elements": 800, "optimizer/kernel_elements": 200}, 25.0),
    ({"moe/kept": 4}, None),            # a program without the counters
    ({}, None)])
def test_share_of_the_kernels_elements(counters, want):
    for cell in ("dbrx-132b.train", "mamba2-130m.train"):
        assert READ(_record(cell, counters)) == want


def test_share_is_none_without_the_card():
    run = _record("mamba2-130m.train", {"optimizer/elements": 9,
                                        "optimizer/kernel_elements": 9},
                  busy=0.0)
    assert READ(run) is None


def test_eager_steps_count_every_element_and_none_by_the_kernel():
    """The CPU's trainer takes the eager update: under the profiler the
    program counts the elements it updated, and the share reads 0."""
    import torch
    from repro_torch import spans
    from repro_torch.train import optimizer as OPT
    params = {"blocks.0.w": torch.ones(6, 5), "final_norm": torch.ones(5)}
    hp = OPT.OptHParams()
    state = OPT.init_state(params, hp)
    grads = {k: torch.full_like(p, 0.5) for k, p in params.items()}
    spans.drain()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        OPT.apply_updates(params, grads, state, hp)
    counters = spans.drain()
    assert counters == {"optimizer/elements": 35}
    assert READ(_record("dbrx-132b.train", counters)) == 0.0
