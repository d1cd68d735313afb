"""On the card: training through the flash-attention and SSD-scan CUDA
kernels.

Every test here needs an NVIDIA GPU (the CUDA kernels have no CPU mode)
and skips without one. The file imports no JAX, so on a GPU machine it
runs with ``--noconftest``:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_train_cuda.py

- The kernels' ``autograd.Function``s on the card: the forward launches
  the kernel once, and the gradients equal the direct autograd of the
  reference's own function (``reference_attention`` / ``ssd_chunked``) on
  the same inputs, bit for bit: the backward recomputes exactly that.
- A kernel launch on grad-requiring inputs outside the Function raises.
- One train step of a SMOKE model in float32 on the card and on the CPU:
  loss and grad norm within 1e-4 relative.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import base as CB
from repro_torch.data import pipeline as DP
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ref import reference_attention
from repro_torch.launch import steps as ST
from repro_torch.models import model as M
from repro_torch.train import optimizer as OPT

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(device=device, dtype=dtype)


@pytest.mark.parametrize("S,dtype", [(300, torch.float32),
                                     (300, torch.bfloat16),
                                     (1100, torch.bfloat16)])
def test_flash_function_on_the_card(cuda, S, dtype):
    rng = np.random.default_rng(S)
    q, k, v = (_randn(rng, (2, S, h, 64), dtype, cuda).requires_grad_()
               for h in (8, 2, 2))
    go = _randn(rng, (2, S, 8, 64), dtype, cuda)
    fa.reset_launches()
    out = fa.flash_attention(q, k, v)
    assert fa.launches["flash_attention"] == 1
    got = torch.autograd.grad(out, (q, k, v), go)
    assert fa.backward_recomputes["flash_attention"] == 1
    want = torch.autograd.grad(reference_attention(q, k, v), (q, k, v), go)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_function_on_the_card(cuda, dtype):
    rng = np.random.default_rng(5)
    B, S, H, P, N, chunk = 2, 512, 4, 64, 128, 256
    X = _randn(rng, (B, S, H, P), dtype, cuda).requires_grad_()
    Adt = (-torch.nn.functional.softplus(
        _randn(rng, (B, S, H), torch.float32, cuda)) * 0.5).requires_grad_()
    Bc = _randn(rng, (B, S, N), dtype, cuda).requires_grad_()
    Cc = _randn(rng, (B, S, N), dtype, cuda).requires_grad_()
    ins = (X, Adt, Bc, Cc)
    go = _randn(rng, (B, S, H, P), dtype, cuda)
    ssd.reset_launches()
    out = ssd.ssd_scan(*ins, chunk=chunk)
    assert ssd.launches["ssd_scan"] == 1
    got = torch.autograd.grad(out, ins, go)
    assert ssd.backward_recomputes["ssd_scan"] == 1
    want = torch.autograd.grad(ssd.ssd_chunked(*ins, chunk)[0], ins, go)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_kernel_outside_the_function_raises_on_the_card(cuda):
    rng = np.random.default_rng(6)
    q = _randn(rng, (1, 64, 4, 64), torch.bfloat16, cuda).requires_grad_()
    k = v = _randn(rng, (1, 64, 4, 64), torch.bfloat16, cuda)
    fa.reset_launches()
    with pytest.raises(RuntimeError, match="cut every gradient"):
        fa.kernel_forward(q, k, v)
    X = _randn(rng, (1, 64, 2, 64), torch.bfloat16, cuda).requires_grad_()
    Adt = torch.zeros((1, 64, 2), device=cuda)
    Bc = Cc = _randn(rng, (1, 64, 128), torch.bfloat16, cuda)
    with pytest.raises(RuntimeError, match="cut every gradient"):
        ssd.kernel_forward(X, Adt, Bc, Cc, chunk=64)
    assert fa.launches["flash_attention"] == 0
    with torch.no_grad():
        fa.kernel_forward(q, k, v)
    assert fa.launches["flash_attention"] == 1


@pytest.mark.parametrize("arch,S", [("llama3.2-1b", 64),
                                    ("mamba2-130m", 64)])
def test_smoke_train_step_card_against_cpu(cuda, arch, S):
    cfg = dataclasses.replace(CB.get_config(arch, smoke=True),
                              dtype="float32")
    hp = OPT.OptHParams(warmup_steps=2, decay_steps=10)
    batch = DP.make_pipeline(cfg, seq_len=S, global_batch=4).batch_at(0)
    out = {}
    for dev in ("cpu", cuda):
        model = M.init(cfg, seed=0, device="cpu").to(dev).requires_grad_(True)
        state = OPT.init_state(dict(model.named_parameters()), hp)
        _, _, m = ST.make_train_step(cfg, hp)(
            model, state, {k: torch.from_numpy(v).to(dev)
                           for k, v in batch.items()})
        out[str(dev)] = {k: float(v) for k, v in m.items()}
    for k in ("loss", "grad_norm"):
        assert abs(out["cuda"][k] - out["cpu"][k]) <= \
            1e-4 * abs(out["cpu"][k]), (k, out)
