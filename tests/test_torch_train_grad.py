"""Gradients through the LM kernels' ``autograd.Function``s on the CPU, the
plain forward standing in for the kernel (``backend="torch"`` goes through
the same Function as the card's kernel):

- ``FlashAttention``'s gradients (softmax attention's, taken a block of
  queries at a time) equal the direct autograd of ``reference_attention``
  (the reference's train-time attention, both its ``_sdpa`` and blocked
  regimes) to the rounding of the inputs' dtype, and lie as close to that
  autograd in float64 as the reference's own do; ``SSDScan``'s, for all
  four of X, Adt, Bc and Cc, equal the direct autograd of
  ``ssd_chunked`` bit for bit, since the backward recomputes exactly that
  function from the saved inputs; a float64 ``gradcheck`` passes for
  both at a tiny size;
- a kernel launch on grad-requiring inputs outside the Function raises;
- a whole model through the Functions gives the reference route's
  parameter gradients (float32, atol 1e-6 of each tensor's largest), and
  with ``cfg.remat`` each block's kernel forward runs twice per step (the
  forward and the recompute) and its backward once.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import base as TCB
from repro_torch.data import pipeline as DP
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ref import reference_attention
from repro_torch.models import model as M

from _torch_state import one_torch_thread  # noqa: F401


def _randn(rng, shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape)).to(dtype)


def _grads(out, inputs, grad_out):
    return torch.autograd.grad(out, inputs, grad_out)


# each gradient's norm gap from the reference's autograd in the inputs'
# dtype: 16 units of float32's roundoff (2**-24), 4 of bfloat16's (2**-8),
# for two sums of the same terms in another order and rounding; float64 at
# float32's 2**-40 of it
FLASH_GRAD_BAR = {torch.float32: 2.0 ** -20, torch.bfloat16: 2.0 ** -6,
                  torch.float64: 2.0 ** -40}


def _gap(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("S,dtype", [(24, torch.float32),
                                     (1100, torch.float32),
                                     (24, torch.bfloat16),
                                     (1100, torch.bfloat16),
                                     (24, torch.float64),
                                     (1100, torch.float64)])
def test_flash_function_grads_equal_reference_autograd(S, dtype):
    """S 24: the reference's ``_sdpa``; S 1100: its blocked online softmax
    with a short last block, and three of the backward's query blocks (a
    short last one). Each gradient within ``FLASH_GRAD_BAR`` of the
    reference's autograd in the same dtype, and no further than twice the
    reference's own gap from the float64 autograd of the same inputs: the
    Function's gradient is as accurate as the one it replaces."""
    rng = np.random.default_rng(0)
    q, k, v = (_randn(rng, (1, S, h, 16), dtype).requires_grad_()
               for h in (4, 2, 2))
    go = _randn(rng, (1, S, 4, 16), dtype)
    fa.reset_launches()
    out = fa.flash_attention(q, k, v, backend="torch")
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = _grads(out, (q, k, v), go)
    want = _grads(reference_attention(q, k, v), (q, k, v), go)
    wide = [t.detach().double().requires_grad_() for t in (q, k, v)]
    true = _grads(reference_attention(*wide), wide, go.double())
    for a, b, t in zip(got, want, true):
        assert a.dtype == dtype
        assert _gap(a, b) <= FLASH_GRAD_BAR[dtype]
        assert _gap(a, t) <= 2 * _gap(b, t) or _gap(a, t) <= 2.0 ** -48
    assert fa.backward_recomputes["flash_attention"] == 1
    assert fa.launches["flash_attention"] == 0     # the plain forward


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_function_grads_equal_ssd_chunked_autograd(dtype):
    rng = np.random.default_rng(1)
    B, S, H, P, N, chunk = 2, 64, 3, 16, 16, 32
    X = _randn(rng, (B, S, H, P), dtype).requires_grad_()
    Adt = (-torch.nn.functional.softplus(_randn(rng, (B, S, H)))
           * 0.5).requires_grad_()
    Bc = _randn(rng, (B, S, N), dtype).requires_grad_()
    Cc = _randn(rng, (B, S, N), dtype).requires_grad_()
    go = _randn(rng, (B, S, H, P), dtype)
    ins = (X, Adt, Bc, Cc)
    ssd.reset_launches()
    out = ssd.ssd_scan(*ins, chunk=chunk, backend="torch")
    assert type(out.grad_fn).__name__ == "SSDScanBackward"
    got = _grads(out, ins, go)
    want = _grads(ssd.ssd_chunked(*ins, chunk)[0], ins, go)
    for a, b, t in zip(got, want, ins):
        assert a.dtype == t.dtype
        assert bool(a.abs().max() > 0)
        assert torch.equal(a, b)
    assert ssd.backward_recomputes["ssd_scan"] == 1
    # only the inputs that require grad get one
    X2 = X.detach()
    g = _grads(ssd.ssd_scan(X2, Adt, Bc, Cc, chunk=chunk, backend="torch"),
               (Adt,), go)[0]
    torch.testing.assert_close(g, want[1], rtol=0, atol=0)


def test_functions_pass_float64_gradcheck():
    rng = np.random.default_rng(2)
    q, k, v = (_randn(rng, (1, 6, h, 4), torch.float64).requires_grad_()
               for h in (4, 2, 2))
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.flash_attention(q, k, v, backend="torch"),
        (q, k, v))
    X = _randn(rng, (1, 8, 2, 4), torch.float64).requires_grad_()
    Adt = (-torch.nn.functional.softplus(
        _randn(rng, (1, 8, 2), torch.float64))).requires_grad_()
    Bc, Cc = (_randn(rng, (1, 8, 4), torch.float64).requires_grad_()
              for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda *a: ssd.ssd_scan(*a, chunk=4, backend="torch"),
        (X, Adt, Bc, Cc))


def test_kernel_launch_outside_the_function_raises_on_grad_inputs():
    rng = np.random.default_rng(3)
    q = _randn(rng, (1, 8, 2, 16)).requires_grad_()
    k = v = _randn(rng, (1, 8, 2, 16))
    with pytest.raises(RuntimeError, match="cut every gradient"):
        fa.kernel_forward(q, k, v)
    X = _randn(rng, (1, 8, 2, 16))
    Adt = torch.zeros((1, 8, 2), requires_grad=True)
    Bc = Cc = _randn(rng, (1, 8, 16))
    with pytest.raises(RuntimeError, match="cut every gradient"):
        ssd.kernel_forward(X, Adt, Bc, Cc, chunk=8)
    # without grad the guard lets it through to the device check: the
    # kernels take CUDA tensors only
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fa.kernel_forward(q, k, v)


@pytest.mark.parametrize("arch,S", [("llama3_2_1b", 32),
                                    ("mamba2_130m", 64)])
@pytest.mark.parametrize("remat", [True, False])
def test_model_grads_through_functions_equal_reference_functions(
        arch, S, remat, monkeypatch):
    """One step's parameter gradients with every block's kernel call
    through its Function (``backend="torch"``) against the reference route
    (``backend="auto"`` on the CPU: autograd straight through
    ``reference_attention`` / ``ssd_chunked``),
    and the kernel forwards and backward recomputes per step."""
    cfg = dataclasses.replace(TCB.get_config(arch, smoke=True),
                              dtype="float32", remat=remat)
    mod = fa if cfg.family == "dense" else ssd
    name = "flash_attention" if cfg.family == "dense" else "ssd_scan"
    forwards = []
    plain = mod._forward
    monkeypatch.setattr(mod, "_forward",
                        lambda *a: forwards.append(1) or plain(*a))
    batch = {k: torch.from_numpy(v) for k, v in DP.make_pipeline(
        cfg, seq_len=S, global_batch=2).batch_at(0).items()}
    grads = {}
    for backend in ("torch", "auto"):
        model = M.init(cfg, seed=0, device="cpu").requires_grad_(True)
        mod.reset_launches()
        forwards.clear()
        loss, _ = M.loss_fn(model, cfg, batch, backend=backend)
        loss.backward()
        grads[backend] = {k: p.grad for k, p in model.named_parameters()}
        n = cfg.num_layers
        if backend == "torch":
            assert len(forwards) == (2 * n if remat else n)
            assert mod.backward_recomputes[name] == n
        else:
            assert len(forwards) == 0
            assert mod.backward_recomputes[name] == 0
    for k, want in grads["auto"].items():
        got = grads["torch"][k]
        assert bool(torch.isfinite(got).all()) and bool(got.abs().max() > 0)
        assert float((got - want).abs().max()) <= \
            1e-6 * float(want.abs().max()), k
