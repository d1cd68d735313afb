"""The benchmark's yardsticks: the kernels' FLOP and byte counters against
the kernel table's numbers and the port's own counters, the model FLOPs
formula against a hand count, and the readers on a trace made by hand."""
from __future__ import annotations

import math

import pytest
import torch

from perfbench.tests._small import ROOT  # noqa: F401  (puts src on the path)
from perfbench.lib import catalog, modelflops, peaks, tracing
from perfbench.lib.cell import RunRecord

FLASH = catalog.module("metrics", "flash_attention_work").work
SSD = catalog.module("metrics", "ssd_scan_work").work


def test_flash_counter_at_dbrx_shape():
    nbytes, ops = FLASH(4, 2048, 48, 8, 128, 2)
    assert round(ops / 1e9, 1) == 206.3
    assert round(nbytes / 1e6, 1) == 234.9


def test_ssd_counter_at_mamba_shape():
    nbytes, ops = SSD(4, 2048, 24, 64, 128, 256, 2)
    assert round(ops / 1e9, 2) == 16.14
    assert round(nbytes / 1e6, 1) == 55.3


@pytest.mark.parametrize("shape", [(4, 2048, 48, 8, 128), (2, 448, 6, 6, 64),
                                   (1, 4096, 32, 8, 64)])
def test_flash_counter_is_the_ports(shape):
    from repro_torch.kernels import flash_attention as FA
    B, S, H, KV, D = shape
    q = torch.empty((B, S, H, D), dtype=torch.bfloat16, device="meta")
    k = torch.empty((B, S, KV, D), dtype=torch.bfloat16, device="meta")
    assert FLASH(B, S, H, KV, D, 2) == FA.work(q, k)


@pytest.mark.parametrize("shape", [(4, 2048, 24, 64, 128, 256),
                                   (16, 2048, 24, 64, 128, 256),
                                   (2, 512, 8, 32, 64, 128)])
def test_ssd_counter_is_the_ports(shape):
    from repro_torch.kernels import ssd_scan as SS
    B, S, H, P, N, Q = shape
    X = torch.empty((B, S, H, P), dtype=torch.bfloat16, device="meta")
    Bc = torch.empty((B, S, N), dtype=torch.bfloat16, device="meta")
    assert SSD(B, S, H, P, N, Q, 2) == SS.work(X, Bc, Q)


def test_model_flops_by_hand():
    dbrx = catalog.config("dbrx-132b-l1")["model"]
    # attention 2*6144*48*128 + 2*6144*8*128, router 6144*16, 4 of 16
    # experts 3*6144*10752 each, head 6144*100352
    hand = (2 * 6144 * 48 * 128 + 2 * 6144 * 8 * 128 + 6144 * 16
            + 4 * 3 * 6144 * 10752 + 6144 * 100352)
    assert hand == 1_497_464_832
    assert modelflops.matmul_params(dbrx) == hand
    tokens = 4 * 2048
    att = 4 * 128 * 4 * 48 * 2048 * 2049 // 2
    assert modelflops.step_flops(dbrx, {"global_batch": 4, "seq_len": 2048}) \
        == 6 * hand * tokens + 3 * att
    mamba = catalog.config("mamba2-130m")["model"]
    # in_proj x, z (1536 each), B, C (128 each), dt (24); out_proj; the
    # tied head over 50,432 padded ids
    hand = 24 * (768 * (2 * 1536 + 2 * 128 + 24) + 1536 * 768) + 768 * 50432
    assert modelflops.matmul_params(mamba) == hand
    per_chunk = 256 * 257 * (128 + 64) + 4 * 256 * 128 * 64
    ssd = 24 * 16 * 24 * 8 * per_chunk
    assert modelflops.step_flops(mamba, {"global_batch": 16, "seq_len": 2048}) \
        == 6 * hand * 16 * 2048 + 3 * ssd


def _record(cell, spans, busy=0.5, window=1.0, steps=2, wsteps=10, ws=5.0):
    wl = catalog.workload(cell)
    tr = tracing.Trace(window_s=window, busy_s=busy, steps=steps, spans=spans,
                       device_ops=[], idle_gaps=[])
    return RunRecord(model=catalog.config(wl["config"])["model"],
                     traffic=catalog.traffic(wl["traffic"]), itemsize=2,
                     window_steps=wsteps, window_s=ws, trace=tr)


def test_readers_on_a_hand_made_trace():
    spans = {"train_step/optimizer": (0.8, 2), "FlashAttentionBackward": (0.1, 2),
             "repro_torch::flash_attention": (4e-3, 4)}
    run = _record("dbrx-132b.train", spans)
    read = lambda name: catalog.reader(name)(run)  # noqa: E731
    assert read("device_idle_share") == pytest.approx(50.0)
    assert read("optimizer_ms") == pytest.approx(400.0)
    assert read("attention_backward_ms") == pytest.approx(50.0)
    nbytes, ops = FLASH(4, 2048, 48, 8, 128, 2)
    bound = max(ops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_S)
    assert read("flash_attention_roofline") == pytest.approx(100 * bound / 1e-3)
    flops = modelflops.step_flops(run.model, run.traffic)
    assert read("train_mfu") == pytest.approx(100 * flops / 0.5 / 989e12)
    # nothing to read: no value, never 0
    assert read("ssd_scan_roofline") is None
    assert read("ssd_backward_ms") is None
    run.trace = None
    assert read("optimizer_ms") is None and read("device_idle_share") is None


def test_roofline_under_accumulation_takes_the_microbatch():
    run = _record("dbrx-132b.train",
                  {"repro_torch::flash_attention": (16e-3, 16)})
    run.traffic = dict(run.traffic, global_batch=32, microbatches=8)
    nbytes, ops = FLASH(4, 2048, 48, 8, 128, 2)
    bound = max(ops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_S)
    value = catalog.reader("flash_attention_roofline")(run)
    assert value == pytest.approx(100 * bound / 1e-3)


def test_busy_is_a_union_and_gaps_are_labelled():
    merged = tracing._merge([(0, 10), (5, 20), (30, 40), (40, 45)])
    assert merged == [[0, 20], [30, 45]]
    gaps = [(20, 30), (45, 60)]
    host = [("step", 0, 100), ("aten::copy_", 18, 32), ("sync", 44, 61)]
    assert tracing._label_gaps(gaps, host) == {
        "aten::copy_": pytest.approx(10e-6), "sync": pytest.approx(15e-6)}
    assert math.isclose(sum(b - a for a, b in merged), 35)
