"""A run driven past the look for a card, at the SMOKE sizes on the CPU
and in float32 (where the sound program agrees with the reference to
rounding), with the timed path broken underneath: ``correct`` has to come
out false under the cell's own limits for each fault a training cell can
have (a step that returns its state unchanged; half of the batch left
out, the mean taken over the rest), and true for the sound program."""
from __future__ import annotations

import pytest
import torch

from perfbench.tests._small import cells, small
from perfbench import run as RUN

SEED = 2 ** 31 + 4242


def _result(cell):
    conf, traffic = small(cell, dtype="float32")
    return RUN.result(cell, SEED, 0.3, False, device="cpu", conf=conf,
                      traffic=traffic)


@pytest.mark.parametrize("cell", cells())
def test_sound_run_is_correct(cell):
    out = _result(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"train_tokens_s", "train_peak_gb",
                                   "setup_s"}


def _unchanged(params, grads, state, hp):
    from repro_torch.train import optimizer as OPT
    return params, state, {"grad_norm": OPT.global_norm(grads),
                           "lr": OPT.lr_schedule(hp, state["step"] + 1)}


@pytest.mark.parametrize("cell", cells())
def test_step_that_leaves_the_state_unchanged_is_caught(cell, monkeypatch):
    from repro_torch.train import optimizer as OPT
    monkeypatch.setattr(OPT, "apply_updates", _unchanged)
    out = _result(cell)
    assert not out["correct"]
    assert out["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", cells())
def test_half_of_the_batch_left_out_is_caught(cell, monkeypatch):
    from repro_torch.train.trainer import Trainer
    whole = Trainer._device_batch

    def half(self, batch):
        out = whole(self, batch)
        return {k: v[:v.shape[0] // 2] for k, v in out.items()}

    monkeypatch.setattr(Trainer, "_device_batch", half)
    out = _result(cell)
    assert not out["correct"], out["checks"]


def test_result_names_its_device():
    out = _result("mamba2-130m.train")
    assert out["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0}
    assert torch.cuda.is_available() or out["metrics"]["train_peak_gb"][
        "value"] == 0


def test_traced_result_on_the_cpu():
    """``--trace 1``'s line: the per-layer metrics the CPU can give (the
    step's utilization; no device time, so no device metric), the busy
    time and the breakdown; the compared numbers last."""
    conf, traffic = small("dbrx-132b.train", dtype="float32")
    out = RUN.result("dbrx-132b.train", SEED, 0.3, True, device="cpu",
                     conf=conf, traffic=traffic)
    assert out["correct"]
    assert set(out["metrics"]) == {"train_mfu"}
    assert out["device"]["busy_s"] == 0 and out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(out)[-1] == "checks"
