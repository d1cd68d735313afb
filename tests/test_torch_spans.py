"""The port's spans and counters (``repro_torch.spans``) on the CPU: the
train step's six spans and their nesting under ``train_step`` in a
profiler's trace, the MoE dispatch's slot counters (forward only, not
doubled by the remat recompute), nothing counted with no profiler, and the
trainer's one-copy readback equal to one ``float`` per metric."""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import base as TCB
from repro_torch.models import moe
from repro_torch.train.trainer import Trainer, TrainConfig

PHASES = ("train_step/data", "train_step/forward", "train_step/backward",
          "train_step/optimizer", "train_step/readback")


def _trainer(arch, **tc):
    cfg = TCB.get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, **tc.pop("cfg", {}))
    return Trainer(cfg, TrainConfig(seq_len=32, global_batch=4, num_steps=1,
                                    log_every=0, **tc), device="cpu")


def _traced_step(tr):
    spans.drain()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.enabled()
        tr.train_one()
    assert not spans.enabled()
    return prof, spans.drain()


def test_train_step_spans_nest_under_train_step():
    tr = _trainer("llama3_2_1b", microbatches=2)
    prof, counters = _traced_step(tr)
    events = [e for e in prof.events()
              if e.name == "train_step" or e.name in PHASES]
    calls = {n: sum(e.name == n for e in events)
             for n in ("train_step",) + PHASES}
    assert calls == {"train_step": 1, "train_step/data": 1,
                     "train_step/forward": 2, "train_step/backward": 2,
                     "train_step/optimizer": 1, "train_step/readback": 1}
    (step,) = [e for e in events if e.name == "train_step"]
    order = []
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e is step:
            continue
        assert step.time_range.start <= e.time_range.start
        assert e.time_range.end <= step.time_range.end, e.name
        order.append(e.name)
    assert order == ["train_step/data", "train_step/forward",
                     "train_step/backward", "train_step/forward",
                     "train_step/backward", "train_step/optimizer",
                     "train_step/readback"]
    # each span's host wall time and calls, kept while the profiler ran
    for name, n in calls.items():
        assert counters[f"{name}:calls"] == n
        assert counters[f"{name}:host_ns"] > 0
    inner = sum(counters[f"{n}:host_ns"] for n in PHASES)
    assert inner <= counters["train_step:host_ns"]


@pytest.mark.parametrize("microbatches", [1, 2])
def test_moe_counters_count_the_forward_once(microbatches):
    """With remat on, each MoE block's forward runs again inside the
    backward; the counters take the forward alone: the choices and slots
    of the step exactly, the kept choices equal to the step's without
    remat (same weights, same batch, same routing)."""
    got = {}
    for remat in (True, False):
        tr = _trainer("dbrx_132b", microbatches=microbatches,
                      cfg={"remat": remat})
        _, counters = _traced_step(tr)
        got[remat] = counters
    cfg, layers = tr.cfg, tr.cfg.num_layers
    B, S, k, E = 4, 32, cfg.num_experts_per_tok, cfg.num_experts
    C = moe.capacity(cfg, S)
    for counters in got.values():
        assert counters["moe/choices"] == B * S * k * layers
        assert counters["moe/slots"] == B * E * C * layers
        assert 0 < counters["moe/kept"] <= counters["moe/choices"]
    assert got[True]["moe/kept"] == got[False]["moe/kept"]
    # the recompute's routing still shows as a span
    assert got[True]["moe/route:calls"] == 2 * got[False]["moe/route:calls"]


def test_nothing_is_counted_without_a_profiler():
    tr = _trainer("dbrx_132b")
    spans.drain()
    tr.train_one()
    assert spans.drain() == {}
    spans.count("x", torch.ones((), dtype=torch.int64))
    spans.count("y", 3)
    with spans.span("z"):
        pass
    assert spans.drain() == {}


def test_count_and_drain():
    spans.drain()
    with profile(activities=[ProfilerActivity.CPU]):
        spans.count("kept", torch.tensor([True, False, True]).sum())
        spans.count("kept", torch.tensor(4))
        spans.count("slots", 5)
        spans.count("slots", 2)
    assert spans.drain() == {"kept": 6, "slots": 7}
    assert spans.drain() == {}


def test_readback_is_one_float_per_metric():
    """The trainer's stacked readback gives each metric's ``float`` bit for
    bit: a twin trainer from the same seed calls the step function and
    reads each metric on its own."""
    tr, twin = _trainer("dbrx_132b"), _trainer("dbrx_132b")
    for _ in range(2):
        batch = next(tr.data)
        got = tr.train_one(batch)
        _, twin.opt_state, met = twin._step_fn(
            twin.model, twin.opt_state, twin._device_batch(batch))
        want = {k: float(v) for k, v in met.items()}
        assert {k: got[k] for k in want} == want
        assert set(got) == set(want) | {"step_time_s"}
