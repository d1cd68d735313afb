"""The RMS norm kernel (``kernels/rms_norm.py``) and the model's norm
(``models/layers.rms_norm``) that routes to it.

On the CPU:

- ``L.rms_norm`` takes the registered op for bfloat16 fake tensors (the
  card's route in a trace), gated and plain, one node forward and one
  backward; it keeps the eager chain, no op, for float32 inputs,
  ``backend="torch"``, CPU tensors (bit for bit the chain the models ran
  before the kernel) and a ``DTensor`` sharded on the normed dimension
  (a fake 2-rank mesh in a subprocess, beside one sharded on the batch,
  which takes the op on each rank's rows).
- The ops' fake shapes, their CPU implementations (the plain versions)
  against autograd of the plain forward, and their work.
- Under the profiler the CPU counts ``norm/rows`` and no
  ``norm/kernel_rows``.

On the card (``cuda``-marked; the file imports no JAX, so there it runs
with ``--noconftest``): the kernel against the eager chain at widths 768,
1,536, 4,096, 6,144 and 8,192, gated and plain, for the output, dx, dz and
dw, by the bf16 bar ``|kernel - plain| <= 2^-6 * (the terms' magnitude +
|plain|)``; dw the same bits on two calls; decode-sized inputs of 1 to 4
rows; misfit inputs raising.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import spans
from repro_torch.analysis.opcount import OpCounter
from repro_torch.kernels import rms_norm as rn
from repro_torch.models import layers as L

ROOT = pathlib.Path(__file__).resolve().parents[1]
EPS = 1e-5
# the bf16 bar, as chip_smoke.py's CELL_BAR: four units of bf16 roundoff
BAR = 2.0 ** -6


def _inputs(shape, dtype, *, gate: bool, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)

    def mk(*s, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(s)).astype(np.float32)).to(
                device=device, dtype=dtype)
    x = mk(*shape, scale=2.0)
    z = mk(*shape) if gate else None
    w = (1 + 0.3 * torch.from_numpy(
        rng.standard_normal(shape[-1]).astype(np.float32))).to(device)
    dout = mk(*shape)
    return x, z, w, dout


def _eager(x, scale, eps, gate=None):
    """The models' norm before the kernel, as they wrote it."""
    if gate is not None:
        x = x * F.silu(gate)
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dtype)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------


def _nodes(x, w, gate, **kw):
    with OpCounter() as c:
        y = L.rms_norm(x, w, EPS, gate=gate, **kw)
        if y.requires_grad:
            y.float().sum().backward()
    return c.kernel_nodes("rms_norm"), c.kernel_nodes("rms_norm_backward")


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("width", [768, 1536, 8192])
def test_bf16_fake_tensors_take_the_op(width, gate):
    """A trace holds what the card runs: one forward node and one backward
    node, of x's shape and dtype, the gradients of x, gate and w."""
    with FakeTensorMode():
        x = torch.empty(2, 64, width, dtype=torch.bfloat16,
                        requires_grad=True)
        z = torch.empty_like(x, requires_grad=True) if gate else None
        w = torch.empty(width, requires_grad=True)
        assert _nodes(x, w, z) == (1, 1)
        assert x.grad.shape == x.shape and x.grad.dtype == torch.bfloat16
        assert w.grad.shape == w.shape and w.grad.dtype == torch.float32
        if gate:
            assert z.grad.shape == z.shape


def test_bf16_scale_is_read_as_float32():
    """A model cast to bfloat16 for serving holds its norm scales in
    bfloat16: the op reads them as float32, as the eager chain's
    ``scale.float()`` does, and the gradient comes back in bfloat16."""
    with FakeTensorMode():
        x = torch.empty(2, 8, 64, dtype=torch.bfloat16, requires_grad=True)
        w = torch.empty(64, dtype=torch.bfloat16, requires_grad=True)
        assert _nodes(x, w, None) == (1, 1)
        assert w.grad.dtype == torch.bfloat16
    x, z, w, _ = _inputs((3, 64), torch.bfloat16, gate=True)
    assert torch.equal(rn.rms_norm(x, w.bfloat16(), EPS, gate=z),
                       _eager(x, w.bfloat16(), EPS, gate=z))


@pytest.mark.parametrize("case", ["float32", "torch", "cpu"])
@pytest.mark.parametrize("gate", [False, True])
def test_plain_path_keeps_the_eager_chain(case, gate):
    """float32 inputs (``add_norm``'s unrounded sum), ``backend="torch"``
    and CPU tensors take no op."""
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    kw = {"backend": "torch"} if case == "torch" else {}
    if case == "cpu":
        x, z, w, _ = _inputs((2, 8, 64), dtype, gate=gate)
        x.requires_grad_()
        assert _nodes(x, w, z, **kw) == (0, 0)
        return
    with FakeTensorMode():
        x = torch.empty(2, 8, 64, dtype=dtype, requires_grad=True)
        z = torch.empty_like(x) if gate else None
        w = torch.empty(64, requires_grad=True)
        assert _nodes(x, w, z, **kw) == (0, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gate", [False, True])
def test_cpu_path_is_the_eager_chain_bit_for_bit(dtype, gate):
    """On the CPU the models' norm is the chain they ran before the
    kernel: the same values and gradients, bit for bit."""
    x, z, w, dout = _inputs((3, 5, 96), dtype, gate=gate, seed=4)
    got_in = [t.clone().requires_grad_() for t in (x, w)] + (
        [z.clone().requires_grad_()] if gate else [])
    want_in = [t.clone().requires_grad_() for t in (x, w)] + (
        [z.clone().requires_grad_()] if gate else [])
    got = L.rms_norm(got_in[0], got_in[1], EPS,
                     gate=got_in[2] if gate else None)
    want = _eager(want_in[0], want_in[1], EPS,
                  gate=want_in[2] if gate else None)
    assert torch.equal(got, want)
    for a, b in zip(torch.autograd.grad(got, got_in, dout),
                    torch.autograd.grad(want, want_in, dout)):
        assert torch.equal(a, b)


def test_unknown_backend_raises():
    x, _, w, _ = _inputs((2, 64), torch.bfloat16, gate=False)
    with pytest.raises(ValueError, match="unknown backend 'xla'"):
        L.rms_norm(x, w, EPS, backend="xla")


_MESH_SCRIPT = r"""
import json, sys
sys.path.insert(0, "src")
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.analysis.opcount import OpCounter
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.models import layers as L

mesh = make_fake_mesh((2,), ("model",), device="cpu")
out = {}
for name, pl in (("last", Shard(2)), ("batch", Shard(0))):
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(4, 8, 64, dtype=torch.bfloat16),
                              mesh, (pl,), src_data_rank=None)
        z = distribute_tensor(torch.empty(4, 8, 64, dtype=torch.bfloat16),
                              mesh, (pl,), src_data_rank=None)
        w = distribute_tensor(torch.empty(64), mesh, (Replicate(),),
                              src_data_rank=None)
        for gate in (None, z):
            with OpCounter() as c:
                y = L.rms_norm(x, w, 1e-5, gate=gate)
            out[f"{name}/{gate is not None}"] = {
                "nodes": c.kernel_nodes("rms_norm"),
                "shape": list(y.shape), "placements": str(y.placements)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def mesh_norms():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _MESH_SCRIPT],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("sharded,nodes", [("last", 0), ("batch", 1)])
def test_dtensor_sharded_on_the_normed_dim_keeps_its_reduction(
        mesh_norms, sharded, nodes, gate):
    """On a fake 2-rank mesh: a ``DTensor`` whose last dim is split keeps
    the eager chain, whose mean DTensor reduces across ranks; one split on
    the batch takes the op on each rank's rows. Either way the output has
    x's shape and placements."""
    got = mesh_norms[f"{sharded}/{gate}"]
    want_pl = "(Shard(dim=2),)" if sharded == "last" else "(Shard(dim=0),)"
    assert got == {"nodes": nodes, "shape": [4, 8, 64],
                   "placements": want_pl}


# ---------------------------------------------------------------------------
# the ops on the CPU and their work
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gate", [False, True])
def test_ops_fake_shapes(gate):
    with FakeTensorMode():
        x = torch.empty(3, 7, 1536, dtype=torch.bfloat16)
        z = torch.empty_like(x) if gate else None
        w = torch.empty(1536)
        out, rstd = torch.ops.repro_torch.rms_norm(x, z, w, EPS)
        dx, dz, dw = torch.ops.repro_torch.rms_norm_backward(x, x, z, w,
                                                             rstd)
    assert (out.shape, out.dtype) == (x.shape, torch.bfloat16)
    assert (rstd.shape, rstd.dtype) == ((3, 7), torch.float32)
    assert (dx.shape, dx.dtype) == (x.shape, torch.bfloat16)
    assert tuple(dz.shape) == ((3, 7, 1536) if gate else (0,))
    assert (dw.shape, dw.dtype) == ((1536,), torch.float32)


@pytest.mark.parametrize("gate", [False, True])
def test_cpu_ops_are_the_plain_versions(gate):
    """The ops' CPU implementations: the forward is the eager chain bit
    for bit; the backward, the kernel's decomposition in float32, within
    float32 rounding of autograd through the plain forward."""
    x, z, w, dout = _inputs((4, 6, 128), torch.float32, gate=gate, seed=7)
    out, rstd = torch.ops.repro_torch.rms_norm(x, z, w, EPS)
    assert torch.equal(out, _eager(x, w, EPS, gate=z))
    assert torch.equal(rstd, torch.rsqrt(torch.mean(
        (x if z is None else x * F.silu(z)) ** 2, dim=-1) + EPS))
    ins = [t.double().requires_grad_() for t in (x, w)] + (
        [z.double().requires_grad_()] if gate else [])
    want = torch.autograd.grad(
        _eager(ins[0], ins[1], EPS, gate=ins[2] if gate else None),
        ins, dout.double())
    dx, dz, dw = torch.ops.repro_torch.rms_norm_backward(dout, x, z, w, rstd)
    got = [dx, dw] + ([dz] if gate else [])
    for g, w_ in zip(got, want):
        assert float((g.double() - w_).abs().max()) \
            <= 1e-5 * float(w_.abs().max())
    if not gate:
        assert dz.shape == (0,)


def test_function_on_cpu_tensors_takes_both_ops():
    """The wrapper called directly on CPU tensors under ``"auto"``: the
    forward op and, through ``RMSNorm``, the backward op, each the plain
    version; ``"torch"`` runs the plain version without an op."""
    rn.reset_launches()
    x, z, w, dout = _inputs((2, 5, 64), torch.bfloat16, gate=True, seed=2)
    x.requires_grad_()
    with OpCounter() as c:
        y = rn.rms_norm(x, w, EPS, gate=z)
        y.backward(dout)
    assert (c.kernel_nodes("rms_norm"), c.kernel_nodes("rms_norm_backward")) \
        == (1, 1)
    assert torch.equal(y, _eager(x.detach(), w, EPS, gate=z))
    with OpCounter() as c:
        rn.rms_norm(x, w, EPS, gate=z, backend="torch")
    assert c.kernel_nodes("rms_norm") == 0
    assert rn.launches == {"rms_norm": 0, "rms_norm_backward": 0}


def test_kernel_entry_on_cpu_tensors_raises():
    x, z, w, dout = _inputs((2, 64), torch.bfloat16, gate=True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rn.kernel_forward(x, w, EPS, z)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rn.kernel_backward(dout, x, z, w, torch.ones(2))


@pytest.mark.parametrize("gate", [False, True])
def test_counter_counts_the_ops_as_their_work(gate):
    """The forward reads x (and gate) and writes the output once, w and
    rstd in float32; the backward reads dout, x (and gate) and writes dx
    (and dgate), w, rstd and dw once."""
    rows, D = 6, 64
    x, z, w, dout = _inputs((rows, D), torch.bfloat16, gate=gate)
    with OpCounter() as c:
        out, rstd = torch.ops.repro_torch.rms_norm(x, z, w, EPS)
    n = rows * D
    assert c.summary.hbm_bytes == (3 if gate else 2) * 2 * n + 4 * D \
        + 4 * rows
    assert c.summary.flops == n * (9 if gate else 4)
    with OpCounter() as c:
        torch.ops.repro_torch.rms_norm_backward(dout, x, z, w, rstd)
    assert c.summary.hbm_bytes == (5 if gate else 3) * 2 * n + 8 * D \
        + 4 * rows
    assert c.summary.flops == n * (21 if gate else 10)


def test_cpu_counts_rows_and_no_kernel_rows():
    """Under the profiler every forward call of the models' norm counts its
    rows; on the CPU no kernel launches, so ``norm/kernel_rows`` is not
    counted. Without the profiler nothing is counted."""
    x, z, w, _ = _inputs((3, 4, 64), torch.bfloat16, gate=True)
    spans.drain()
    L.rms_norm(x, w, EPS)
    assert spans.drain() == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        L.rms_norm(x, w, EPS)
        L.rms_norm(x, w, EPS, gate=z)
        L.rms_norm(x.float(), w, EPS)
    assert spans.drain() == {"norm/rows": 36}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _through(x, z, w, dout, backend):
    ins = [t.clone().requires_grad_() for t in (x, w)] + (
        [z.clone().requires_grad_()] if z is not None else [])
    y = L.rms_norm(ins[0], ins[1], EPS, gate=ins[2] if z is not None
                   else None, backend=backend)
    dx, dw, *dz = torch.autograd.grad(y, ins, dout)
    return [y.detach(), dx] + dz + [dw]


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("width", [768, 1536, 4096, 6144, 8192])
@pytest.mark.parametrize("rows", [1, 3, 4, 1031])
def test_kernel_against_the_eager_chain(cuda, width, gate, rows):
    """The output, dx, dz and dw through the kernel against autograd of
    the eager chain on the same bf16 inputs, by the bar; 1 to 4 rows are
    a decode step's."""
    x, z, w, dout = _inputs((rows, width), torch.bfloat16, gate=gate,
                            seed=width + rows, device=cuda)
    rn.reset_launches()
    got = _through(x, z, w, dout, "auto")
    assert rn.launches == {"rms_norm": 1, "rms_norm_backward": 1}
    want = _through(x, z, w, dout, "torch")
    for name, k, p, m in zip(["out", "dx"] + (["dz"] if gate else [])
                             + ["dw"], got, want,
                             rn.magnitudes(dout, x, z, w, EPS)):
        err = (k.float() - p.float()).abs()
        worst = float((err - BAR * (m + p.float().abs())).max())
        assert worst <= 0, f"{name}: max abs err {float(err.max()):.3e}"


@pytest.mark.cuda
def test_served_model_norm_on_the_card(cuda):
    """A model cast to bfloat16 for serving: its bf16 scale through the
    kernel, one token a row of a decode step, against the eager chain."""
    x, z, w, _ = _inputs((4, 1, 1536), torch.bfloat16, gate=True, seed=5,
                         device=cuda)
    wb = w.bfloat16()
    for gate in (None, z):
        got = L.rms_norm(x, wb, EPS, gate=gate)
        want = L.rms_norm(x, wb, EPS, gate=gate, backend="torch")
        mag = rn.magnitudes(torch.zeros_like(x), x, gate, wb.float(),
                            EPS)[0]
        assert bool(((got.float() - want.float()).abs()
                     <= BAR * (mag + want.float().abs())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [False, True])
def test_dw_same_bits_twice(cuda, gate):
    """dw's partial rows are added in a fixed order: the same inputs give
    the same bits, as do dx and dz."""
    x, z, w, dout = _inputs((4096, 1536), torch.bfloat16, gate=gate,
                            seed=11, device=cuda)
    _, rstd = rn.kernel_forward(x, w, EPS, z)
    first = rn.kernel_backward(dout, x, z, w, rstd)
    again = rn.kernel_backward(dout, x, z, w, rstd)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_kernel_refuses_misfit_inputs(cuda):
    x, z, w, _ = _inputs((4, 64), torch.bfloat16, gate=True, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        rn.kernel_forward(x.float(), w, EPS)
    with pytest.raises(ValueError, match="multiple of 8"):
        rn.kernel_forward(x[:, :60], w[:60], EPS)
    with pytest.raises(ValueError, match="8 to 8192"):
        rn.kernel_forward(torch.ones(2, 8200, dtype=torch.bfloat16,
                                     device=cuda),
                          torch.ones(8200, device=cuda), EPS)
    with pytest.raises(ValueError, match="float32 scale"):
        rn.kernel_forward(x, w.bfloat16(), EPS)
    with pytest.raises(ValueError, match="does not fit"):
        rn.kernel_forward(x, w, EPS, z[:2])
    with pytest.raises(ValueError, match="16 bytes"):
        flat = torch.ones(4 * 64 + 1, dtype=torch.bfloat16, device=cuda)
        rn.kernel_forward(flat[1:].view(4, 64), w, EPS)
    with pytest.raises(RuntimeError, match="raw pointer"):
        rn.kernel_forward(x.clone().requires_grad_(), w, EPS)
