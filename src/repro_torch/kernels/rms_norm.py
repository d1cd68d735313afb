"""RMS norm of bfloat16 rows on the card, plain or with a SiLU gate, forward
and backward: a hand-written CUDA kernel pair (``repro_torch/csrc/
rms_norm.cu``) with its plain PyTorch version beside it and a launch
counter.

Replaces no Pallas kernel: the reference's norm (``repro.models.layers.
rms_norm``) is jnp code that XLA fuses. The port's eager norm
(``models/layers.py``) runs a chain of launches over float32 temporaries
of each row; the kernel reads each row once and writes it once.

:func:`rms_norm` computes ``bf16(g * rsqrt(mean(g**2) + eps) * w)`` over
the last dimension, with ``g = x``, or ``g = bf16(x * bf16(silu(gate)))``
with a gate (the Mamba mixer's ``rms_norm(y * silu(z))``); ``w`` is the
float32 parameter. These are the eager chain's own roundings; only the
order of the row's sum differs. Inputs: bfloat16 ``x`` (and ``gate`` of its
shape) whose rows of ``D`` elements start on 16 bytes, ``8 <= D <=``
:data:`MAX_WIDTH` and ``D % 8 == 0``, ``w`` float32 ``(D,)``, all on one
CUDA device. A kernel entry given any other CUDA input raises.

Two registered ops: ``torch.ops.repro_torch.rms_norm`` (x, gate, w, eps)
-> (out, rstd), rstd float32 of x's leading shape, and
``torch.ops.repro_torch.rms_norm_backward`` (dout, x, gate, w, rstd) ->
(dx, dgate, dw), dgate empty without a gate. Their CUDA implementations
launch the kernels (:func:`kernel_forward`, :func:`kernel_backward`: one
launch, and two, the second adding dw's per-block partial rows in a fixed
order, so the same inputs give the same bits); their CPU implementations
are the plain versions :func:`rms_norm_plain` and
:func:`rms_norm_backward_plain`, the kernels' arithmetic in eager ops; their
fake implementations give the shapes, so ``FakeTensorMode`` traces each as
one node, which ``repro_torch.analysis.opcount`` counts as :func:`work` and
:func:`work_backward`.

Dispatch (``backend``) by ``_build.route``: the ops for ``"auto"``, through
:class:`RMSNorm` when grad is enabled and an input requires it (it saves x,
gate, w and rstd; its backward is the backward op); the plain version
without an op for ``"torch"``. The model's norm (``models/layers.py``)
calls :func:`rms_norm` only for bfloat16 inputs on the card. While a
profiler records, each launch of the forward kernel adds its rows to the
counter ``norm/kernel_rows``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.kernels import _build

# launches of the kernels in this process (the plain versions count none)
launches: Dict[str, int] = {"rms_norm": 0, "rms_norm_backward": 0}

MAX_WIDTH = 8192       # widest row the kernel takes

_SIGNATURES = {
    # x, gate, w, out, rstd, rows, D, 1 / D, eps, stream
    "rms_norm_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int]
    + [ctypes.c_float] * 2 + [ctypes.c_void_p],
    # dout, x, gate, w, rstd, dx, dgate, dw, partials, nparts, rows, D,
    # 1 / D, stream
    "rms_norm_bwd": [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 2
    + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    # rows, D, gated: the backward's grid (0 where the kernel cannot run)
    "rms_norm_bwd_blocks": [ctypes.c_longlong, ctypes.c_int, ctypes.c_int],
}


def reset_launches() -> None:
    launches["rms_norm"] = 0
    launches["rms_norm_backward"] = 0


def library() -> ctypes.CDLL:
    """The kernel's shared library, built from source at first use."""
    return _build.load("rms_norm", _SIGNATURES)


@functools.lru_cache(maxsize=64)
def backward_blocks(device: int, rows: int, width: int, gated: bool) -> int:
    """Blocks of the backward's persistent grid on CUDA device ``device``:
    as many as fit on the card at once, at most one a block of rows. Its
    dw partial rows are as many."""
    with torch.cuda.device(device):
        return int(library().rms_norm_bwd_blocks(rows, width, int(gated)))


# ---------------------------------------------------------------------------
# plain versions: the kernels' arithmetic in eager ops
# ---------------------------------------------------------------------------


def _gated(x, gate):
    """(g, s): the normed value, x or bf16(x * bf16(silu(gate))), and the
    gate's SiLU (None without a gate), in x's dtype."""
    if gate is None:
        return x, None
    s = F.silu(gate)
    return x * s, s


def rms_norm_plain(x, w, eps: float, gate=None) -> tuple:
    """(out, rstd): the norm in x's dtype and the float32 ``rsqrt(mean(g**2)
    + eps)`` of each row (x's shape, its last dim 1), by the models' eager
    chain (``models/layers.rms_norm`` off the kernel)."""
    g, _ = _gated(x, gate)
    g32 = g.float()
    rstd = torch.rsqrt(torch.mean(g32 * g32, dim=-1, keepdim=True) + eps)
    return ((g32 * rstd) * w.float()).to(g.dtype), rstd


def rms_norm_backward_plain(dout, x, gate, w, rstd) -> tuple:
    """(dx, dgate, dw) of :func:`rms_norm_plain`'s output given dout, by the
    kernel's decomposition in float32: gh = g * rstd, a = dout * w,
    dg = rstd * (a - gh * mean(a * gh)); dx = dg (times the gate's SiLU),
    dgate = dg * x * silu'(gate), dw = the sum over rows of dout * gh.
    dgate is empty without a gate."""
    g, s = _gated(x, gate)
    r = rstd[..., None]
    gh = g.float() * r
    d32 = dout.float()
    a = d32 * w
    dg = r * (a - gh * torch.mean(a * gh, dim=-1, keepdim=True))
    dw = (d32 * gh).reshape(-1, x.shape[-1]).sum(0)
    if gate is None:
        return dg.to(x.dtype), x.new_empty((0,)), dw
    z = gate.float()
    sig = torch.sigmoid(z)
    dx = (dg * s.float()).to(x.dtype)
    dz = (dg * x.float() * (sig * (1 + z * (1 - sig)))).to(gate.dtype)
    return dx, dz, dw


def magnitudes(dout, x, gate, w, eps: float) -> list:
    """The terms' magnitude of each of out, dx, (dgate,) dw: the scale of
    the bf16 bar the tests and ``chip_smoke.py`` hold the kernel to, as the
    other kernels' plain versions on |inputs| give theirs. |g| rstd |w| for
    the output; rstd (|a| + |gh| mean(|a gh|)) for dx, times |s| with a
    gate, and times |x silu'(gate)| for dgate; the sum of |dout gh| for dw
    (g the normed value, s = silu(gate), gh = g rstd, a = dout w)."""
    g, s = _gated(x, gate)
    g32 = g.float()
    r = torch.rsqrt(torch.mean(g32 * g32, dim=-1, keepdim=True) + eps)
    gh, a = (g32 * r).abs(), (dout.float() * w).abs()
    dg = r * (a + gh * (a * gh).mean(-1, keepdim=True))
    out = [gh * w.abs(), dg if gate is None else dg * s.float().abs()]
    if gate is not None:
        z = gate.float()
        sig = torch.sigmoid(z)
        out.append(dg * x.float().abs() * (sig * (1 + z * (1 - sig))).abs())
    return out + [(dout.float().abs() * gh).reshape(-1, x.shape[-1]).sum(0)]


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _check(x, gate, w) -> None:
    """Raise unless x, gate and w fit the kernel."""
    _build.check_cuda("rms_norm", x)
    D = x.shape[-1] if x.dim() else 0
    if x.dtype != torch.bfloat16 or (gate is not None
                                     and gate.dtype != torch.bfloat16):
        raise ValueError(f"the rms_norm kernel takes bfloat16 x and gate; "
                         f"got {x.dtype}, "
                         f"{None if gate is None else gate.dtype}")
    if gate is not None and (gate.shape != x.shape
                             or gate.device != x.device):
        raise ValueError(f"gate {tuple(gate.shape)} on {gate.device} does "
                         f"not fit x {tuple(x.shape)} on {x.device}")
    if D % 8 or not 8 <= D <= MAX_WIDTH:
        raise ValueError(f"the rms_norm kernel takes rows of 8 to "
                         f"{MAX_WIDTH} elements, a multiple of 8; got {D}")
    if w.dtype != torch.float32 or tuple(w.shape) != (D,) \
            or w.device != x.device:
        raise ValueError(f"the rms_norm kernel takes a float32 scale of "
                         f"shape ({D},) on {x.device}; got {w.dtype} "
                         f"{tuple(w.shape)} on {w.device}")


def kernel_forward(x, w, eps: float, gate=None) -> tuple:
    """Launch the forward kernel on CUDA tensors: (out, rstd), out in x's
    shape and dtype, rstd float32 of x's leading shape, both contiguous.
    No autograd: raises when grad is enabled and an input requires it (call
    :func:`rms_norm`, which routes such inputs through :class:`RMSNorm`)."""
    _build.check_no_grad("rms_norm", x, w,
                         *(() if gate is None else (gate,)))
    _check(x, gate, w)
    x = x.contiguous()
    gate = None if gate is None else gate.contiguous()
    w = w.contiguous()
    D = x.shape[-1]
    rows = x.numel() // D
    out = torch.empty_like(x)
    rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    if not rows:
        return out, rstd
    _build.check_16_byte_rows(("x", x), ("w", w),
                              *(() if gate is None else (("gate", gate),)))
    with torch.cuda.device(x.device):
        _build.raise_on(library().rms_norm_fwd(
            x.data_ptr(), 0 if gate is None else gate.data_ptr(),
            w.data_ptr(), out.data_ptr(), rstd.data_ptr(), rows, D,
            float(np.float32(1) / np.float32(D)), eps,
            torch.cuda.current_stream().cuda_stream), "rms_norm_fwd")
    launches["rms_norm"] += 1
    spans.count("norm/kernel_rows", rows)
    return out, rstd


def kernel_backward(dout, x, gate, w, rstd) -> tuple:
    """Launch the backward kernels on CUDA tensors: (dx, dgate, dw), dx and
    dgate in x's dtype and shape (dgate empty without a gate), dw float32
    (D,). Its scratch, one float32 row of D for each block of the
    persistent grid (:func:`backward_blocks`), lives only for the call."""
    _check(x, gate, w)
    if dout.shape != x.shape or dout.dtype != x.dtype \
            or rstd.dtype != torch.float32 \
            or tuple(rstd.shape) != tuple(x.shape[:-1]) \
            or dout.device != x.device or rstd.device != x.device:
        raise ValueError(f"the rms_norm backward takes a dout of x's shape "
                         f"and dtype and a float32 rstd of x's leading shape,"
                         f" on x's device; got dout {dout.dtype} "
                         f"{tuple(dout.shape)} on {dout.device}, rstd "
                         f"{rstd.dtype} {tuple(rstd.shape)} on {rstd.device}")
    dout, x, w, rstd = (t.contiguous() for t in (dout, x, w, rstd))
    gate = None if gate is None else gate.contiguous()
    D = x.shape[-1]
    rows = x.numel() // D
    dx = torch.empty_like(x)
    dgate = x.new_empty((0,)) if gate is None else torch.empty_like(gate)
    if not rows:
        return dx, dgate, torch.zeros(D, dtype=torch.float32,
                                      device=x.device)
    dw = torch.empty(D, dtype=torch.float32, device=x.device)
    _build.check_16_byte_rows(("dout", dout), ("x", x), ("w", w),
                              *(() if gate is None else (("gate", gate),)))
    nparts = backward_blocks(x.get_device(), rows, D, gate is not None)
    partials = torch.empty((nparts, D), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _build.raise_on(library().rms_norm_bwd(
            dout.data_ptr(), x.data_ptr(),
            0 if gate is None else gate.data_ptr(), w.data_ptr(),
            rstd.data_ptr(), dx.data_ptr(),
            0 if gate is None else dgate.data_ptr(), dw.data_ptr(),
            partials.data_ptr(), nparts, rows, D,
            float(np.float32(1) / np.float32(D)),
            torch.cuda.current_stream().cuda_stream), "rms_norm_bwd")
    launches["rms_norm_backward"] += 1
    return dx, dgate, dw


# ---------------------------------------------------------------------------
# the registered ops and their work
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::rms_norm", mutates_args=(),
                         device_types="cpu")
def rms_norm_op(x: torch.Tensor, gate: Optional[torch.Tensor],
                w: torch.Tensor, eps: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The registered op: the plain version on the CPU, the kernel on the
    card (:func:`kernel_forward`); contiguous, as the kernel writes them."""
    out, rstd = rms_norm_plain(x, w, eps, gate)
    return out.contiguous(), rstd.squeeze(-1).contiguous()


@rms_norm_op.register_kernel("cuda")
def _rms_norm_cuda(x, gate, w, eps):
    return kernel_forward(x, w, eps, gate)


@rms_norm_op.register_fake
def _rms_norm_fake(x, gate, w, eps):
    return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
            torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device))


@torch.library.custom_op("repro_torch::rms_norm_backward", mutates_args=(),
                         device_types="cpu")
def rms_norm_backward_op(dout: torch.Tensor, x: torch.Tensor,
                         gate: Optional[torch.Tensor], w: torch.Tensor,
                         rstd: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The registered backward: (dx, dgate, dw), the plain version on the
    CPU, the kernel on the card (:func:`kernel_backward`)."""
    return tuple(t.contiguous() for t in
                 rms_norm_backward_plain(dout, x, gate, w, rstd))


@rms_norm_backward_op.register_kernel("cuda")
def _rms_norm_backward_cuda(dout, x, gate, w, rstd):
    return kernel_backward(dout, x, gate, w, rstd)


@rms_norm_backward_op.register_fake
def _rms_norm_backward_fake(dout, x, gate, w, rstd):
    return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
            (x.new_empty((0,)) if gate is None else
             torch.empty(gate.shape, dtype=gate.dtype, device=gate.device)),
            torch.empty(w.shape, dtype=torch.float32, device=w.device))


class RMSNorm(torch.autograd.Function):
    """The forward op, saving x, gate, w and rstd; the backward op."""

    @staticmethod
    def forward(ctx, x, w, eps, gate):
        out, rstd = rms_norm_op(x, gate, w, eps)
        ctx.save_for_backward(x, gate, w, rstd)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        x, gate, w, rstd = ctx.saved_tensors
        dx, dgate, dw = rms_norm_backward_op(grad_out.contiguous(), x, gate,
                                             w, rstd)
        needs = ctx.needs_input_grad
        return (dx if needs[0] else None, dw if needs[1] else None, None,
                dgate if gate is not None and needs[3] else None)


def rms_norm(x, w, eps: float, *, gate=None, backend: str = "auto"):
    """The RMS norm of x's rows (times bf16(silu(gate)) first where a gate
    is given) scaled by w, in x's dtype. Differentiable through
    :class:`RMSNorm` when grad is enabled and an input requires it. A
    bfloat16 w (a model cast for serving) is read as its float32 value, as
    the eager chain's ``w.float()`` reads it."""
    if _build.route(x, backend) == "plain":
        return rms_norm_plain(x, w, eps, gate)[0]
    w = w.float()
    ins = (x, w) if gate is None else (x, w, gate)
    if _build.needs_grad(*ins):
        return RMSNorm.apply(x, w, eps, gate)
    return rms_norm_op(x, gate, w, eps)[0]


# operations of one element: the forward's square, sum and two products;
# the gate's SiLU (negate, exp, add, divide) and product; the backward's
# recomputed gh, dout * w, the two row sums' multiply-adds and dg (three);
# with a gate its recomputed g, dx's product and dz's five
NORM_OPS, GATE_OPS = 4, 5
BACKWARD_OPS, BACKWARD_GATE_OPS = 10, 11


def work(x, gate) -> tuple:
    """(bytes, operations) of the forward: x (and gate) read once, the
    output written once, w read once (float32) and rstd written (float32
    a row)."""
    D = x.shape[-1]
    n, rows = x.numel(), x.numel() // max(D, 1)
    tensors = 2 if gate is None else 3
    nbytes = tensors * n * x.element_size() + 4 * D + 4 * rows
    return nbytes, n * (NORM_OPS + (0 if gate is None else GATE_OPS))


def work_backward(x, gate) -> tuple:
    """(bytes, operations) of the backward: dout, x (and gate) read once,
    dx (and dgate) written once, w and rstd read and dw written once
    (float32)."""
    D = x.shape[-1]
    n, rows = x.numel(), x.numel() // max(D, 1)
    tensors = 3 if gate is None else 5
    nbytes = tensors * n * x.element_size() + 8 * D + 4 * rows
    return nbytes, n * (BACKWARD_OPS
                        + (0 if gate is None else BACKWARD_GATE_OPS))
