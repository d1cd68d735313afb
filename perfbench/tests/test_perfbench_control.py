"""The comparison's control: the reference computed with its products in
fp8 (the precision below the configuration's bfloat16), put in the
program's place, has to come out not correct under each cell's limits.
On the CPU at the SMOKE sizes; on the card (``-m cuda``) at the cell's
own sizes."""
from __future__ import annotations

import pytest
import torch

from perfbench.tests._small import cells, small
from perfbench.lib import catalog, cell as CELL, compare

SEED = 2 ** 31 + 777


def _control_fails(cell, conf, traffic, device):
    steps = traffic["compare_steps"]
    ref = CELL.reference_readings(conf, traffic, SEED, steps, device)
    fp8 = CELL.reference_readings(conf, traffic, SEED, steps, device,
                                  prec="fp8")
    ok, checks = compare.verdict(compare.numbers(fp8, ref),
                                 catalog.limits(cell))
    return not ok, checks


@pytest.mark.parametrize("cell", ["dbrx-132b.train", "mamba2-130m.train"])
def test_control_fails_at_the_smoke_size(cell):
    conf, traffic = small(cell)
    failed, checks = _control_fails(cell, conf, traffic, "cpu")
    assert failed, checks


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control at the cell's own size")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_control_fails_at_the_cells_size(cell, card):
    wl = catalog.workload(cell)
    conf = catalog.config(wl["config"])
    traffic = catalog.traffic(wl["traffic"])
    failed, checks = _control_fails(cell, conf, traffic, card)
    assert failed, checks
