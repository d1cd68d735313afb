"""The SSD scan's backward (``repro_torch.kernels.ssd_scan``) on the CPU.

- :func:`ssd_chunked_backward`, the decomposition the CUDA backward
  follows, against ``torch.autograd.grad`` of ``ssd_chunked`` in float64:
  all four gradients within 1e-10 of the largest, over one chunk and
  several, P 16 and 64, N 16 and 128, one head and three.
- The registered op ``repro_torch::ssd_scan_backward``: its CPU
  implementation is that function bit for bit, its fake implementation
  gives the four shapes and dtypes, and ``opcount`` counts it as one node
  of ``work_backward``.
- ``SSDScan``'s route: the op for bfloat16 inputs on the card (fake ones
  in a trace), the recompute of ``ssd_chunked`` for CPU tensors, float32
  inputs and ``backend="torch"``; gradients only for the inputs that
  require them.

The kernel itself runs only on the card (``tests/test_torch_train_cuda.py``,
``chip_smoke.py`` phase 21).
"""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.analysis.opcount import OpCounter
from repro_torch.kernels import _build
from repro_torch.kernels import ssd_scan as ssd


def _inputs(B, S, H, P, N, dtype=torch.float64, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s)).to(dtype)
    Adt = -torch.from_numpy(np.logaddexp(rng.standard_normal((B, S, H)), 0.0)
                            * 0.5).to(torch.float64 if dtype == torch.float64
                                      else torch.float32)
    return mk(B, S, H, P), Adt, mk(B, S, N), mk(B, S, N), mk(B, S, H, P)


def _autograd(X, Adt, Bc, Cc, dY, chunk, which=(0, 1, 2, 3)):
    ins = [t.detach().requires_grad_(i in which)
           for i, t in enumerate((X, Adt, Bc, Cc))]
    want = [ins[i] for i in which]
    return torch.autograd.grad(ssd.ssd_chunked(*ins, chunk)[0], want, dY)


@pytest.mark.parametrize("S,chunk", [(32, 32), (96, 32)],
                         ids=["one-chunk", "three-chunks"])
@pytest.mark.parametrize("P", [16, 64])
@pytest.mark.parametrize("N", [16, 128])
@pytest.mark.parametrize("H", [1, 3])
def test_plain_backward_equals_autograd_in_float64(S, chunk, P, N, H):
    X, Adt, Bc, Cc, dY = _inputs(2, S, H, P, N, seed=S + P + N + H)
    got = ssd.ssd_chunked_backward(X, Adt, Bc, Cc, dY, chunk)
    want = _autograd(X, Adt, Bc, Cc, dY, chunk)
    for name, g, w in zip(("dX", "dAdt", "dBc", "dCc"), got, want):
        assert g.dtype == w.dtype == torch.float64 and g.shape == w.shape
        scale = float(w.abs().max())
        assert scale > 0
        assert float((g - w).abs().max()) <= 1e-10 * scale, name


@pytest.mark.parametrize("which", [(0,), (1,), (2, 3), (0, 1)])
def test_plain_backward_matches_a_subset_of_inputs(which):
    """autograd over only some inputs gives the same gradients as the
    plain backward's for those."""
    X, Adt, Bc, Cc, dY = _inputs(1, 64, 2, 16, 32, seed=9)
    got = ssd.ssd_chunked_backward(X, Adt, Bc, Cc, dY, 16)
    want = _autograd(X, Adt, Bc, Cc, dY, 16, which)
    for i, w in zip(which, want):
        assert float((got[i] - w).abs().max()) \
            <= 1e-10 * float(w.abs().max())


def test_plain_backward_keeps_the_input_dtypes():
    """bfloat16 X, Bc, Cc and dY with float32 Adt, as the model passes them:
    computed in float32, returned as bfloat16 and float32 (dAdt)."""
    X, Adt, Bc, Cc, dY = _inputs(1, 64, 2, 16, 16, torch.bfloat16)
    got = ssd.ssd_chunked_backward(X, Adt, Bc, Cc, dY, 32)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.bfloat16, torch.bfloat16]
    want = ssd.ssd_chunked_backward(*(t.double() for t in (X, Adt, Bc, Cc,
                                                           dY)), 32)
    for g, w in zip(got, want):
        assert float((g.double() - w).abs().max()) \
            <= 2 ** -7 * float(w.abs().max())


def test_op_on_the_cpu_is_the_plain_version_bit_for_bit():
    X, Adt, Bc, Cc, dY = _inputs(2, 64, 3, 16, 16, torch.float32)
    got = torch.ops.repro_torch.ssd_scan_backward(X, Adt, Bc, Cc, dY, 16)
    want = ssd.ssd_chunked_backward(X, Adt, Bc, Cc, dY, 16)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert torch.equal(g, w) and g.is_contiguous()
    assert ssd.launches["ssd_scan_backward"] == 0


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_fake_op_gives_four_shapes_and_dtypes(device):
    with FakeTensorMode():
        X = torch.empty(4, 4096, 128, 64, dtype=torch.bfloat16, device=device)
        Adt = torch.empty(4, 4096, 128, dtype=torch.float32, device=device)
        Bc = torch.empty(4, 4096, 128, dtype=torch.bfloat16, device=device)
        dX, dA, dB, dC = torch.ops.repro_torch.ssd_scan_backward(
            X, Adt, Bc, Bc, X, 256)
    assert [tuple(t.shape) for t in (dX, dA, dB, dC)] == [
        (4, 4096, 128, 64), (4, 4096, 128), (4, 4096, 128), (4, 4096, 128)]
    assert [t.dtype for t in (dX, dA, dB, dC)] == [
        torch.bfloat16, torch.float32, torch.bfloat16, torch.bfloat16]
    assert all(t.device.type == device for t in (dX, dA, dB, dC))


def test_counter_counts_the_backward_as_one_node_of_its_work():
    """A bf16 SSD call traced under fake mode with grad: one forward and one
    backward node, the latter counted as ``work_backward``; no recompute."""
    ssd.reset_launches()
    with FakeTensorMode():
        X = torch.empty(2, 512, 4, 64, dtype=torch.bfloat16,
                        requires_grad=True)
        Adt = torch.empty(2, 512, 4, requires_grad=True)
        Bc = torch.empty(2, 512, 128, dtype=torch.bfloat16,
                         requires_grad=True)
        Cc = torch.empty(2, 512, 128, dtype=torch.bfloat16,
                         requires_grad=True)
        with OpCounter() as c:
            y = ssd.ssd_scan(X, Adt, Bc, Cc, chunk=256)
            grads = torch.autograd.grad(y, (X, Adt, Bc, Cc), torch.ones_like(y))
    assert c.kernel_nodes("ssd_scan") == 1
    assert c.kernel_nodes("ssd_scan_backward") == 1
    nbytes, flops = ssd.work_backward(X, Bc, 256)
    rec = c.summary.by_opcode["repro_torch.ssd_scan_backward"]
    assert (rec["bytes"], rec["flops"]) == (nbytes, flops)
    assert [g.dtype for g in grads] == [torch.bfloat16, torch.float32,
                                        torch.bfloat16, torch.bfloat16]
    assert ssd.backward_recomputes["ssd_scan"] == 0
    assert ssd.launches == {"ssd_scan": 0, "ssd_scan_backward": 0}


def test_backward_work_at_the_train_cells():
    """About 2.8 times the forward's operations at mamba2-130m's and
    granite-4.0-h-small's train steps."""
    for shape, flops in (((16, 2048, 24, 64, 128), 180_791_279_616),
                         ((4, 4096, 128, 64, 128), 482_110_078_976)):
        B, S, H, P, N = shape
        X = torch.empty(B, S, H, P, dtype=torch.bfloat16, device="meta")
        Bc = torch.empty(B, S, N, dtype=torch.bfloat16, device="meta")
        nbytes, got = ssd.work_backward(X, Bc, 256)
        assert got == flops
        assert nbytes == (3 * B * S * H * P + 4 * B * S * N) * 2 \
            + 2 * B * S * H * 4
        assert 2.5 < got / ssd.work(X, Bc, 256)[1] < 3


def _backward_nodes(X, Adt, Bc, backend) -> tuple:
    """(backward op nodes, recomputes) of one backward of SSDScan."""
    ins = [t.requires_grad_() for t in (X, Adt, Bc, Bc.clone())]
    ssd.reset_launches()
    with OpCounter() as c:
        ssd.ssd_scan(*ins, chunk=32, backend=backend).sum().backward()
    return (c.kernel_nodes("ssd_scan_backward"),
            ssd.backward_recomputes["ssd_scan"])


@pytest.mark.parametrize("dtype,backend,kernel", [
    (torch.bfloat16, "auto", True), (torch.float32, "torch", False),
    (torch.bfloat16, "torch", False), (torch.float32, "auto", False)])
def test_route_depends_on_device_and_dtype(dtype, backend, kernel):
    """Fake tensors stand for the card: bf16 takes the op unless the backend
    is ``"torch"``; float32 recomputes. Real CPU tensors always recompute."""
    with FakeTensorMode():
        X = torch.empty(1, 64, 2, 16, dtype=dtype)
        Adt = torch.empty(1, 64, 2)
        Bc = torch.empty(1, 64, 16, dtype=dtype)
        assert _backward_nodes(X, Adt, Bc, backend) == (
            (1, 0) if kernel else (0, 1))
    X, Adt, Bc, _, _ = _inputs(1, 64, 2, 16, 16, dtype)
    assert _backward_nodes(X, Adt, Bc, backend) == (0, 1)


@pytest.mark.parametrize("needs", [(True, False, False, False),
                                   (False, True, True, False),
                                   (True, True, True, True)])
def test_function_on_fake_bf16_returns_only_wanted_gradients(needs):
    """Through the op, SSDScan returns a gradient for each input that
    requires one and None for the others."""
    with FakeTensorMode():
        ins = [torch.empty(1, 64, 2, 16, dtype=torch.bfloat16),
               torch.empty(1, 64, 2),
               torch.empty(1, 64, 16, dtype=torch.bfloat16),
               torch.empty(1, 64, 16, dtype=torch.bfloat16)]
        ins = [t.requires_grad_(n) for t, n in zip(ins, needs)]
        y = ssd.ssd_scan(*ins, chunk=32)
        y.sum().backward()
        got = [t.grad is not None for t in ins]
    assert got == list(needs)


def test_cpu_function_keeps_the_recompute_bit_for_bit():
    """Real CPU tensors (bf16 too) take the recompute: gradients equal to
    autograd of ``ssd_chunked``, one recompute, no kernel launch."""
    X, Adt, Bc, Cc, dY = _inputs(1, 64, 2, 16, 16, torch.bfloat16)
    ins = [t.requires_grad_() for t in (X, Adt, Bc, Cc)]
    ssd.reset_launches()
    got = torch.autograd.grad(ssd.ssd_scan(*ins, chunk=32), ins, dY)
    want = torch.autograd.grad(ssd.ssd_chunked(*ins, 32)[0], ins, dY)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ssd.backward_recomputes["ssd_scan"] == 1
    assert ssd.launches == {"ssd_scan": 0, "ssd_scan_backward": 0}


def test_backward_smem_fits_hopper():
    """The backward's largest block fits the 227 KB a block may use at every
    P, N and chunk the configs and tests build."""
    assert ssd.backward_smem_bytes(256, 64, 128) == 82_176
    for P in ssd.HEAD_DIMS:
        for N in (16, 32, 64, 128):
            for chunk in (32, 48, 64, 100, 128, 256):
                assert ssd.backward_smem_bytes(chunk, P, N) \
                    <= _build.SMEM_PER_BLOCK


def test_kernel_backward_raises_without_a_card():
    X, Adt, Bc, Cc, dY = _inputs(1, 64, 2, 16, 16, torch.bfloat16)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ssd.kernel_backward(X, Adt, Bc, Cc, dY, chunk=32)
