"""On the card: the flash-attention and SSD-scan CUDA kernels against their
plain versions, and the LM prefill going through them.

Every test here needs an NVIDIA GPU (the CUDA kernels have no CPU mode)
and skips without one. The file imports no JAX, so on a GPU machine it
runs with ``--noconftest``:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_lm_cuda.py

Bars are those of ``tests/test_kernels.py``: f32 atol 2e-5 / rtol 1e-4,
bf16 atol 6e-3 / rtol 3e-2; SSD outputs divided by max |ref| first. The
bf16 cases cover the tensor-core kernels' edges: S not a multiple of their
64-row tiles, every head dim, MQA, GQA and KV == H; SSD head dims 32 to
128, state 64 and 128, chunks below, at and above the tile, and 16 chunks
through the state pass.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import base as CB
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch.steps import make_prefill_step, prefill_batch
from repro_torch.models import layers as L
from repro_torch.models import model as M

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _tol(dtype):
    return dict(atol=6e-3, rtol=3e-2) if dtype == torch.bfloat16 \
        else dict(atol=2e-5, rtol=1e-4)


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(device=device, dtype=dtype)


@pytest.mark.parametrize("B,S,H,KV,D,dtype", [
    (2, 256, 4, 2, 64, torch.float32),     # GQA
    (1, 512, 8, 8, 128, torch.bfloat16),   # KV == H
    (2, 128, 4, 1, 64, torch.bfloat16),    # MQA
    (1, 300, 4, 2, 32, torch.float32),     # ragged S
    (2, 77, 4, 2, 16, torch.bfloat16),     # ragged S, smallest D
    (1, 300, 8, 2, 64, torch.bfloat16),    # GQA, ragged S
    (1, 1000, 8, 1, 16, torch.bfloat16),   # MQA, ragged S, D 16
    (2, 300, 4, 4, 32, torch.bfloat16),    # KV == H, D 32
    (1, 1000, 4, 2, 128, torch.bfloat16),  # GQA, D 128
])
def test_flash_kernel_matches_plain(cuda, B, S, H, KV, D, dtype):
    rng = np.random.default_rng(S)
    q = _randn(rng, (B, S, H, D), dtype, cuda)
    k = _randn(rng, (B, S, KV, D), dtype, cuda)
    v = _randn(rng, (B, S, KV, D), dtype, cuda)
    fa.reset_launches()
    out = ops.flash_attention(q, k, v)
    assert fa.launches == {"flash_attention": 1}
    want = ops.flash_attention(q, k, v, backend="torch")
    torch.cuda.synchronize()
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), want.float(), **_tol(dtype))


def test_flash_kernel_reads_strided_operands(cuda):
    """q, k, v as views into one packed tensor (no copy, no transpose)."""
    rng = np.random.default_rng(1)
    packed = _randn(rng, (2, 130, 3, 4, 64), torch.float32, cuda)
    q, k, v = packed[:, :, 0], packed[:, :, 1, :2], packed[:, :, 2, :2]
    torch.testing.assert_close(ops.flash_attention(q, k, v),
                               ops.flash_attention(q, k, v, backend="torch"),
                               **_tol(torch.float32))


def test_flash_kernel_reads_strided_bf16_operands(cuda):
    """The bf16 kernel's 16-byte copies through strided views."""
    rng = np.random.default_rng(2)
    packed = _randn(rng, (2, 130, 3, 4, 64), torch.bfloat16, cuda)
    q, k, v = packed[:, :, 0], packed[:, :, 1, :2], packed[:, :, 2, :2]
    torch.testing.assert_close(
        ops.flash_attention(q, k, v).float(),
        ops.flash_attention(q, k, v, backend="torch").float(),
        **_tol(torch.bfloat16))


@pytest.mark.parametrize("B,S,H,P,N,dtype,chunk", [
    (2, 256, 4, 64, 128, torch.float32, 128),
    (1, 512, 8, 64, 128, torch.bfloat16, 256),
    (2, 128, 2, 32, 64, torch.float32, 64),
    (1, 256, 1, 128, 32, torch.float32, 256),
    (1, 96, 2, 16, 16, torch.float32, 32),
    (1, 512, 4, 32, 64, torch.bfloat16, 64),     # P 32, N 64
    (2, 512, 2, 128, 128, torch.bfloat16, 128),  # P 128
    (1, 4096, 2, 64, 128, torch.bfloat16, 256),  # 16 chunks
    (1, 4096, 1, 128, 64, torch.bfloat16, 256),  # 16 chunks, P 128, N 64
    (1, 96, 2, 16, 16, torch.bfloat16, 32),      # chunk below the tile
])
def test_ssd_kernel_matches_plain(cuda, B, S, H, P, N, dtype, chunk):
    rng = np.random.default_rng(S + P)
    X = _randn(rng, (B, S, H, P), dtype, cuda)
    Adt = -torch.nn.functional.softplus(
        _randn(rng, (B, S, H), torch.float32, cuda)) * 0.5
    Bc = _randn(rng, (B, S, N), dtype, cuda)
    Cc = _randn(rng, (B, S, N), dtype, cuda)
    ssd.reset_launches()
    out = ops.ssd_scan(X, Adt, Bc, Cc, chunk=chunk)
    assert ssd.launches == {"ssd_scan": 1, "ssd_scan_backward": 0}
    want = ops.ssd_scan(X, Adt, Bc, Cc, chunk=chunk, backend="torch")
    torch.cuda.synchronize()
    scale = want.float().abs().max()
    torch.testing.assert_close(out.float() / scale, want.float() / scale,
                               **_tol(dtype))


def test_bf16_kernels_are_deterministic(cuda):
    """Two bf16 launches on the same inputs give the same bits: no atomics,
    a fixed order of every sum."""
    rng = np.random.default_rng(3)
    q = _randn(rng, (2, 300, 8, 64), torch.bfloat16, cuda)
    k = _randn(rng, (2, 300, 2, 64), torch.bfloat16, cuda)
    v = _randn(rng, (2, 300, 2, 64), torch.bfloat16, cuda)
    assert torch.equal(ops.flash_attention(q, k, v),
                       ops.flash_attention(q, k, v))
    X = _randn(rng, (2, 1024, 4, 64), torch.bfloat16, cuda)
    Adt = -torch.nn.functional.softplus(
        _randn(rng, (2, 1024, 4), torch.float32, cuda)) * 0.5
    Bc = _randn(rng, (2, 1024, 128), torch.bfloat16, cuda)
    Cc = _randn(rng, (2, 1024, 128), torch.bfloat16, cuda)
    assert torch.equal(ops.ssd_scan(X, Adt, Bc, Cc, chunk=256),
                       ops.ssd_scan(X, Adt, Bc, Cc, chunk=256))


@pytest.mark.parametrize("arch,S", [("llama3_2_1b", 200),
                                    ("mamba2_130m", 128)])
def test_prefill_launches_one_kernel_per_block(cuda, arch, S):
    """The prefill step on the card goes through the family's kernel once
    per block and gives the plain versions' next tokens' logits."""
    cfg = dataclasses.replace(CB.get_config(arch, smoke=True),
                              dtype="float32")
    model = M.init(cfg, seed=0, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, S))).to(cuda)
    kern = fa if cfg.family == "dense" else ssd
    name = "flash_attention" if cfg.family == "dense" else "ssd_scan"
    kern.reset_launches()
    logits, _ = M.forward(model, cfg, {"tokens": tokens})
    assert kern.launches[name] == cfg.num_layers
    plain, _ = M.forward(model, cfg, {"tokens": tokens}, backend="torch")
    assert kern.launches[name] == cfg.num_layers
    torch.testing.assert_close(logits, plain, atol=1e-4, rtol=1e-4)
    step = make_prefill_step(cfg)
    assert torch.equal(step(model, {"tokens": tokens}),
                       torch.argmax(plain[:, -1:], -1).to(torch.int32))


@pytest.mark.parametrize("arch,S", [("dbrx_132b", 200),
                                    ("llama3_2_vision_90b", 200),
                                    ("whisper_tiny", 200),
                                    ("recurrentgemma_2b", 48)])
def test_later_families_prefill_on_the_card(cuda, arch, S):
    """The moe, vlm, audio and hybrid prefill on the card: one flash launch
    per causal self-attention layer (the Whisper decoder's; none for the
    hybrid, whose local attention is plain), float32 logits within 1e-4 of
    the plain path's and within 1e-5 x max |logit| of the same model's on
    the CPU (vlm gates set to 0.5 and -0.3)."""
    cfg = dataclasses.replace(CB.get_config(arch, smoke=True),
                              dtype="float32")
    model = M.init(cfg, seed=0, device="cpu")
    for cb in getattr(model, "cross_blocks", ()):
        cb.gate_attn.fill_(0.5)
        cb.gate_mlp.fill_(-0.3)
    batch = prefill_batch(cfg, 2, S, device="cpu")
    card = copy.deepcopy(model).to(cuda)
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    fa.reset_launches()
    logits, _ = M.forward(card, cfg, on_card)
    want = 0 if cfg.family == "hybrid" else cfg.num_layers
    assert fa.launches["flash_attention"] == want
    plain, _ = M.forward(card, cfg, on_card, backend="torch")
    torch.testing.assert_close(logits, plain, atol=1e-4, rtol=1e-4)
    cpu, _ = M.forward(model, cfg, batch)
    scale = float(cpu.abs().max())
    assert float((logits.cpu() - cpu).abs().max()) <= 1e-5 * scale


def test_causal_attention_outside_the_kernel_head_dims_raises(cuda):
    """The hybrid's head dim 256 is outside the flash kernel's: its layers
    route by their window to the plain local attention, and a causal layer
    at that head dim still raises rather than leaving the kernel."""
    cfg = dataclasses.replace(CB.get_config("recurrentgemma_2b", smoke=True),
                              head_dim=256, dtype="bfloat16")
    model = M.cast(M.init(cfg, seed=0, device=cuda), cfg)
    p = model.groups[0].attn.attn
    x = torch.randn(1, 32, cfg.d_model, device=cuda, dtype=torch.bfloat16)
    pos = torch.arange(32, device=cuda, dtype=torch.int32)[None]
    fa.reset_launches()
    out = L.attention_apply(p, x, cfg, positions=pos, window=16)
    assert out.shape == x.shape and fa.launches["flash_attention"] == 0
    with pytest.raises(ValueError, match="head dims"):
        L.attention_apply(p, x, cfg, positions=pos)
