"""Mamba-1 selective scan on the card, forward and backward: a hand-written
CUDA kernel pair (``repro_torch/csrc/selective_scan.cu``) with its plain
PyTorch version beside it and a launch counter.

Replaces no Pallas kernel: the JAX package has no Mamba-1 mixer, and the
SSD kernel (``kernels/ssd_scan.py``) computes another recurrence (one
scalar decay per head, B and C shared by the head's channels). Jamba's
mixer (``models/jamba.py``) decays every (channel, state) pair on its own::

    delta_t = softplus(delta_raw_t + delta_bias)                  (B, S, Dc)
    s_t[c, n] = exp(delta_t[c] A[c, n]) s_{t-1}[c, n] + delta_t[c] B_t[n] u_t[c]
    y_t[c] = (sum_n C_t[n] s_t[c, n] + D[c] u_t[c]) * silu(z_t[c])

from a zero state. u, delta_raw, z are (B, S, Dc), B and C (B, S, N), A
(Dc, N), D and delta_bias (Dc,); the recurrence runs in float32 (or in the
inputs' wider dtype, float64 in the tests) and y comes out in u's dtype.

The kernel takes bfloat16 u, delta_raw, z, B, C with a contiguous last
dimension (their rows may be strided; those of u, delta_raw and z start on
16 bytes, as the kernel stages each chunk's rows in shared memory 16 bytes
at a time), float32 A, D and delta_bias, N =
:data:`STATE` and Dc a multiple of 128, all on one CUDA device; a kernel
entry given anything else raises. It reads each input once, writes y once
and keeps the state on the chip within each chunk of :data:`CHUNK` steps
(three launches); for the backward it writes the state before every
:data:`KEEP`-th step, float32 (B, ceil(S / KEEP), N, Dc). The backward
(five launches) recomputes the states from those, :data:`KEEP` steps at a
time, and runs the reverse-time scan; its sums over channels and time run
in a fixed order, with no atomics, so the same inputs give the same
bits.

The plain version, :func:`selective_scan_plain`, is a chunked scan with the
state carried between chunks: within each chunk of ``chunk`` steps the
recurrence runs step by step for all chunks at once from a zero state,
then a pass over the chunks carries each chunk's entering state, which is
added to the chunk's states times the decays accumulated since its start.
:func:`selective_scan_backward_plain` is its gradient by the same
decomposition the backward kernel follows, without autograd.

Two registered ops: ``torch.ops.repro_torch.selective_scan`` (u, delta_raw,
delta_bias, A, B, C, D, z) -> (y, the kept states) and
``torch.ops.repro_torch.selective_scan_backward`` (the same, the kept
states, dy) ->
(du, ddelta_raw, ddelta_bias, dA, dB, dC, dD, dz). Their CUDA
implementations launch the kernels (:func:`kernel_forward`,
:func:`kernel_backward`); their CPU implementations are the plain versions;
their fake implementations give the shapes, so that
``FakeTensorMode`` traces each as one node, which
``repro_torch.analysis.opcount`` counts as :func:`work` and
:func:`work_backward`.

Dispatch (``backend``) by ``_build.route``: the ops for ``"auto"``, the
plain version without an op for ``"torch"``; when grad is enabled and an
input requires it, through :class:`SelectiveScan`, whose backward is the
backward op (the kernel on the card, the plain backward off it) for
``"auto"``, and the plain backward for ``"torch"``. While a
profiler records, every forward call of :func:`selective_scan` and every
backward of :class:`SelectiveScan` add one to the counter
``selective_scan/calls``, and each launch of either kernel one to
``selective_scan/kernel_calls``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.kernels import _build

# launches of the kernels in this process (the plain versions count none)
launches: Dict[str, int] = {"selective_scan": 0,
                            "selective_scan_backward": 0}

STATE = 16          # the state width N the kernel is built for
CHUNK = 64          # steps a thread of the kernel walks
KEEP = 8            # steps between the states the forward keeps
CHANNEL_TILE = 128  # the kernel's channels come in blocks of this many
BWD_TILE = 64       # channels of a block of the backward's main pass

_PTR = ctypes.c_void_p
_SIGNATURES = {
    # u, draw, bias, A, B, C, D, z, y, kept, ends, sdelta, Bt, S, Dc,
    # strides[10], stream
    "ss_fwd": [_PTR] * 12 + [ctypes.c_longlong] * 3 + [_PTR, _PTR],
    # u, draw, bias, A, B, C, D, z, kept, dout, du, ddraw, dz, dbias, dA,
    # dB, dC, dD, gbuf, sdelta, delta, bc_part, dA_part, dD_part,
    # dbias_part, Bt, S, Dc, strides[10], stream
    "ss_bwd": [_PTR] * 25 + [ctypes.c_longlong] * 3 + [_PTR, _PTR],
}


def reset_launches() -> None:
    launches["selective_scan"] = 0
    launches["selective_scan_backward"] = 0


def library() -> ctypes.CDLL:
    """The kernel's shared library, built from source at first use."""
    return _build.load("selective_scan", _SIGNATURES)


def chunks(S: int, chunk: int = CHUNK) -> int:
    return -(-S // chunk)


# ---------------------------------------------------------------------------
# plain version: the chunked scan in eager ops
# ---------------------------------------------------------------------------


def _compute_dtype(*tensors) -> torch.dtype:
    ct = torch.float32
    for t in tensors:
        ct = torch.promote_types(ct, t.dtype)
    return ct


def _pad_chunks(t, S: int, chunk: int):
    """t (B, S, ...) padded with zeros to whole chunks along S."""
    pad = chunks(S, chunk) * chunk - S
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t


def _scan_states(delta, u, B, A, chunk: int) -> tuple:
    """(every step's state (B, nc * chunk, Dc, N), the state entering each
    chunk (B, nc, Dc, N), the decays exp(delta A) (B, nc, chunk, Dc, N)) of
    the recurrence on delta, u (B, S, Dc), B (B, S, N) in their dtype, the
    sequence padded to whole chunks with delta 0 (decay 1, no input), which
    leaves the state as it was."""
    Bt, S, Dc = u.shape
    N = A.shape[-1]
    nc = chunks(S, chunk)
    delta, u, B = (_pad_chunks(t, S, chunk) for t in (delta, u, B))
    delta = delta.reshape(Bt, nc, chunk, Dc)
    decay = torch.exp(delta[..., None] * A)               # (Bt, nc, Q, Dc, N)
    inflow = (delta * u.reshape(Bt, nc, chunk, Dc))[..., None] \
        * B.reshape(Bt, nc, chunk, 1, N)
    h = torch.zeros((Bt, nc, Dc, N), dtype=u.dtype, device=u.device)
    since = torch.ones_like(h)
    hs, sinces = [], []
    for j in range(chunk):                 # every chunk at once, from zero
        h = decay[:, :, j] * h + inflow[:, :, j]
        since = since * decay[:, :, j]
        hs.append(h)
        sinces.append(since)
    carry = torch.zeros((Bt, Dc, N), dtype=u.dtype, device=u.device)
    entering = []
    for k in range(nc):
        entering.append(carry)
        carry = sinces[-1][:, k] * carry + hs[-1][:, k]
    s_in = torch.stack(entering, dim=1)                   # (Bt, nc, Dc, N)
    s = torch.stack(hs, dim=2) + torch.stack(sinces, dim=2) * s_in[:, :, None]
    return s.reshape(Bt, nc * chunk, Dc, N), s_in, decay


def selective_scan_plain(u, delta_raw, delta_bias, A, B, C, D, z, *,
                         chunk: int = CHUNK) -> tuple:
    """(y in u's dtype, the state before every :data:`KEEP`-th step (B,
    ceil(S / KEEP), N, Dc)), computed in float32 or the inputs' wider
    dtype."""
    ct = _compute_dtype(u, delta_raw, delta_bias, A, B, C, D, z)
    S = u.shape[1]
    delta = F.softplus(delta_raw.to(ct) + delta_bias.to(ct))
    uu = u.to(ct)
    s, _, _ = _scan_states(delta, uu, B.to(ct), A.to(ct), chunk)
    s = s[:, :S]
    y = torch.einsum("bsdn,bsn->bsd", s, C.to(ct)) + D.to(ct) * uu
    out = y * F.silu(z.to(ct))
    before = F.pad(s[:, :-1], (0, 0, 0, 0, 1, 0))[:, ::KEEP]
    return out.to(u.dtype), before.transpose(-1, -2).contiguous()


def selective_scan_backward_plain(u, delta_raw, delta_bias, A, B, C, D, z,
                                  dy, *, chunk: int = CHUNK) -> tuple:
    """(du, ddelta_raw, ddelta_bias, dA, dB, dC, dD, dz) of
    :func:`selective_scan_plain`'s y given dy, each in its input's dtype, by
    the decomposition the backward kernel follows, explicit and without
    autograd: the states again (:func:`_scan_states`); the gate's dz and
    the scan's dy_s = dy silu(z); the adjoint g_t = dy_s,t C_t + a_{t+1}
    g_{t+1} by a reverse chunked scan (within each chunk from zero, then a
    pass over the chunks that carries the adjoint of each chunk's last
    state, added to the chunk's adjoints times the decays after each
    step); then with a_t = exp(delta_t A) and s_{t-1} the state before
    step t, ddelta = sum_n g s_{t-1} a A + u sum_n g B, du = delta sum_n g
    B + dy_s D, dA = sum_t g s_{t-1} a delta, dB = sum_c g delta u, dC =
    sum_c dy_s s, dD = sum_t dy_s u, ddelta_raw = ddelta sigmoid(delta_raw
    + delta_bias) and ddelta_bias its sum over steps."""
    ct = _compute_dtype(u, delta_raw, delta_bias, A, B, C, D, z, dy)
    Bt, S, Dc = u.shape
    N = A.shape[-1]
    nc = chunks(S, chunk)
    x = delta_raw.to(ct) + delta_bias.to(ct)
    delta = F.softplus(x)
    uu, Bm, Cm, zz, A_ = u.to(ct), B.to(ct), C.to(ct), z.to(ct), A.to(ct)
    s, _, decay = _scan_states(delta, uu, Bm, A_, chunk)
    sz = torch.sigmoid(zz)
    y = torch.einsum("bsdn,bsn->bsd", s[:, :S], Cm) + D.to(ct) * uu
    dz = dy.to(ct) * y * (sz * (1 + zz * (1 - sz)))
    dys = dy.to(ct) * (zz * sz)
    inflow = (_pad_chunks(dys, S, chunk)[..., None]
              * _pad_chunks(Cm, S, chunk)[:, :, None, :]
              ).reshape(Bt, nc, chunk, Dc, N)
    g = torch.zeros((Bt, nc, Dc, N), dtype=ct, device=u.device)
    after = torch.ones_like(g)             # the decays after each step
    gs, afters = [None] * chunk, [None] * chunk
    for j in reversed(range(chunk)):
        g = g + inflow[:, :, j]
        gs[j], afters[j] = g, after
        after = after * decay[:, :, j]
        g = decay[:, :, j] * g
    carry = torch.zeros((Bt, Dc, N), dtype=ct, device=u.device)
    leaving = [None] * nc
    for k in reversed(range(nc)):
        leaving[k] = carry
        carry = g[:, k] + after[:, k] * carry
    G = torch.stack(leaving, dim=1)[:, :, None]           # (Bt, nc, 1, Dc, N)
    g = (torch.stack(gs, dim=2) + torch.stack(afters, dim=2) * G
         ).reshape(Bt, nc * chunk, Dc, N)[:, :S]
    a = decay.reshape(Bt, nc * chunk, Dc, N)[:, :S]
    s = s[:, :S]
    s_prev = F.pad(s[:, :-1], (0, 0, 0, 0, 1, 0))
    ga = g * s_prev * a
    gB = torch.einsum("bsdn,bsn->bsd", g, Bm)
    ddelta = torch.einsum("bsdn,dn->bsd", ga, A_) + uu * gB
    ddraw = ddelta * torch.sigmoid(x)
    grads = (delta * gB + dys * D.to(ct), ddraw, ddraw.sum((0, 1)),
             torch.einsum("bsdn,bsd->dn", ga, delta),
             torch.einsum("bsdn,bsd->bsn", g, delta * uu),
             torch.einsum("bsdn,bsd->bsn", s, dys),
             (dys * uu).sum((0, 1)), dz)
    return tuple(gr.to(t.dtype) for gr, t in zip(
        grads, (u, delta_raw, delta_bias, A, B, C, D, z)))


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_NAMES = ("u", "delta_raw", "delta_bias", "A", "B", "C", "D", "z")


def _check(u, delta_raw, delta_bias, A, B, C, D, z) -> None:
    """Raise unless the inputs' shapes, dtypes, devices and layouts fit the
    kernel."""
    if u.dim() != 3:
        raise ValueError(f"u must be (B, S, Dc); got {tuple(u.shape)}")
    Bt, S, Dc = u.shape
    if delta_raw.shape != u.shape or z.shape != u.shape:
        raise ValueError(f"delta_raw {tuple(delta_raw.shape)} and z "
                         f"{tuple(z.shape)} must be u's shape "
                         f"{tuple(u.shape)}")
    if tuple(B.shape) != (Bt, S, STATE) or C.shape != B.shape:
        raise ValueError(f"the kernel takes B and C of shape (B, S, {STATE})"
                         f"; got {tuple(B.shape)}, {tuple(C.shape)}")
    if tuple(A.shape) != (Dc, STATE) or tuple(D.shape) != (Dc,) \
            or tuple(delta_bias.shape) != (Dc,):
        raise ValueError(f"A must be ({Dc}, {STATE}), D and delta_bias "
                         f"({Dc},); got {tuple(A.shape)}, {tuple(D.shape)}, "
                         f"{tuple(delta_bias.shape)}")
    if Dc % CHANNEL_TILE:
        raise ValueError(f"the kernel takes channels in blocks of "
                         f"{CHANNEL_TILE}; got Dc={Dc}")
    wrong = [n for n, t in zip(_NAMES, (u, delta_raw, delta_bias, A, B, C,
                                        D, z))
             if t.dtype != (torch.float32 if n in ("delta_bias", "A", "D")
                            else torch.bfloat16)]
    if wrong:
        raise ValueError(f"the kernel takes bfloat16 u, delta_raw, B, C, z "
                         f"and float32 delta_bias, A, D; wrong dtype: "
                         f"{wrong}")
    if any(t.device != u.device for t in (delta_raw, delta_bias, A, B, C, D,
                                          z)):
        raise ValueError("the selective scan's inputs must be on one device")
    if any(t.stride(-1) != 1 for t in (u, delta_raw, B, C, z)) and u.numel():
        raise ValueError("the kernel reads u, delta_raw, B, C and z with a "
                         "contiguous last dimension")
    if u.numel():
        _build.check_16_byte_rows(("u", u), ("delta_raw", delta_raw),
                                  ("z", z))


def _strides(u, delta_raw, B, C, z):
    return (ctypes.c_longlong * 10)(*(s for t in (u, delta_raw, z, B, C)
                                      for s in t.stride()[:2]))


def kernel_forward(u, delta_raw, delta_bias, A, B, C, D, z) -> tuple:
    """Launch the forward kernels on CUDA tensors: (y (B, S, Dc) bfloat16,
    the state before every :data:`KEEP`-th step (B, ceil(S / KEEP), N, Dc)
    float32), both contiguous. No autograd: raises when grad is enabled and
    an input requires it (call :func:`selective_scan`, which routes such
    inputs through :class:`SelectiveScan`)."""
    ins = (u, delta_raw, delta_bias, A, B, C, D, z)
    _build.check_no_grad("selective_scan", *ins)
    _build.check_cuda("selective_scan", u)
    _check(*ins)
    A, D, delta_bias = A.contiguous(), D.contiguous(), delta_bias.contiguous()
    Bt, S, Dc = u.shape
    nc = chunks(S)
    f32 = dict(dtype=torch.float32, device=u.device)
    y = torch.empty((Bt, S, Dc), dtype=u.dtype, device=u.device)
    kept = torch.empty((Bt, chunks(S, KEEP), STATE, Dc), **f32)
    if not u.numel():
        return y, kept
    ends = torch.empty((Bt, nc, STATE, Dc), **f32)
    sdelta = torch.empty((Bt, nc, Dc), **f32)
    with torch.cuda.device(u.device):
        _build.raise_on(library().ss_fwd(
            u.data_ptr(), delta_raw.data_ptr(), delta_bias.data_ptr(),
            A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
            z.data_ptr(), y.data_ptr(), kept.data_ptr(), ends.data_ptr(),
            sdelta.data_ptr(), Bt, S, Dc, _strides(u, delta_raw, B, C, z),
            torch.cuda.current_stream().cuda_stream), "ss_fwd")
    launches["selective_scan"] += 1
    spans.count("selective_scan/kernel_calls", 1)
    return y, kept


def kernel_backward(u, delta_raw, delta_bias, A, B, C, D, z, kept,
                    dy) -> tuple:
    """Launch the backward kernels on CUDA tensors: (du, ddelta_raw,
    ddelta_bias, dA, dB, dC, dD, dz) of y given dy, from the states the
    forward kept; du, ddelta_raw, dz, dB, dC bfloat16 and the others
    float32, each contiguous. Its float32 scratch lives only for the call:
    the chunks' adjoints and dA parts (B, S / CHUNK, N, Dc), their delta
    sums, dD and bias parts (B, S / CHUNK, Dc), each step's delta (B, S,
    Dc) and the dB / dC rows of each 64-channel tile (B, S, Dc / 64, 2 N);
    687 MB at Jamba2-3B's (1, 16384, 5120)."""
    ins = (u, delta_raw, delta_bias, A, B, C, D, z)
    _build.check_cuda("selective_scan", u)
    _check(*ins)
    Bt, S, Dc = u.shape
    nc, nk = chunks(S), chunks(S, KEEP)
    if dy.shape != u.shape or dy.dtype != u.dtype or dy.device != u.device \
            or tuple(kept.shape) != (Bt, nk, STATE, Dc) \
            or kept.dtype != torch.float32 or kept.device != u.device:
        raise ValueError(f"the selective scan's backward takes a dy of u's "
                         f"shape and dtype and float32 kept states ({Bt}, "
                         f"{nk}, {STATE}, {Dc}) on u's device; got dy "
                         f"{dy.dtype} {tuple(dy.shape)}, kept {kept.dtype} "
                         f"{tuple(kept.shape)}")
    A, D, delta_bias = A.contiguous(), D.contiguous(), delta_bias.contiguous()
    dy, kept = dy.contiguous(), kept.contiguous()
    f32 = dict(dtype=torch.float32, device=u.device)
    bf = dict(dtype=u.dtype, device=u.device)
    du, ddraw, dz = (torch.empty((Bt, S, Dc), **bf) for _ in range(3))
    dB, dC = (torch.empty((Bt, S, STATE), **bf) for _ in range(2))
    dbias, dD = torch.empty(Dc, **f32), torch.empty(Dc, **f32)
    dA = torch.empty((Dc, STATE), **f32)
    outs = (du, ddraw, dbias, dA, dB, dC, dD, dz)
    if not u.numel():
        for t in (dbias, dD, dA):
            t.zero_()
        return outs
    gbuf = torch.empty((Bt, nc, STATE, Dc), **f32)
    dA_part = torch.empty((Bt, nc, STATE, Dc), **f32)
    sdelta, dD_part, dbias_part = (torch.empty((Bt, nc, Dc), **f32)
                                   for _ in range(3))
    delta = torch.empty((Bt, S, Dc), **f32)
    bc_part = torch.empty((Bt, S, Dc // BWD_TILE, 2 * STATE), **f32)
    with torch.cuda.device(u.device):
        _build.raise_on(library().ss_bwd(
            *(t.data_ptr() for t in ins), kept.data_ptr(), dy.data_ptr(),
            du.data_ptr(), ddraw.data_ptr(), dz.data_ptr(), dbias.data_ptr(),
            dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), dD.data_ptr(),
            gbuf.data_ptr(), sdelta.data_ptr(), delta.data_ptr(),
            bc_part.data_ptr(), dA_part.data_ptr(), dD_part.data_ptr(),
            dbias_part.data_ptr(), Bt, S, Dc,
            _strides(u, delta_raw, B, C, z),
            torch.cuda.current_stream().cuda_stream), "ss_bwd")
    launches["selective_scan_backward"] += 1
    spans.count("selective_scan/kernel_calls", 1)
    return outs


# ---------------------------------------------------------------------------
# the registered ops and their work
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::selective_scan", mutates_args=(),
                         device_types="cpu")
def selective_scan_op(u: torch.Tensor, delta_raw: torch.Tensor,
                      delta_bias: torch.Tensor, A: torch.Tensor,
                      B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                      z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The registered op: (y, the kept states); the plain version on the
    CPU, the kernel on the card (:func:`kernel_forward`); contiguous, as the
    kernel writes them."""
    y, states = selective_scan_plain(u, delta_raw, delta_bias, A, B, C, D, z)
    return y.contiguous(), states.to(torch.float32)


@selective_scan_op.register_kernel("cuda")
def _selective_scan_cuda(u, delta_raw, delta_bias, A, B, C, D, z):
    return kernel_forward(u, delta_raw, delta_bias, A, B, C, D, z)


@selective_scan_op.register_fake
def _selective_scan_fake(u, delta_raw, delta_bias, A, B, C, D, z):
    Bt, S, Dc = u.shape
    return (torch.empty(u.shape, dtype=u.dtype, device=u.device),
            torch.empty((Bt, chunks(S, KEEP), A.shape[-1], Dc),
                        dtype=torch.float32, device=u.device))


@torch.library.custom_op("repro_torch::selective_scan_backward",
                         mutates_args=(), device_types="cpu")
def selective_scan_backward_op(
        u: torch.Tensor, delta_raw: torch.Tensor, delta_bias: torch.Tensor,
        A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
        z: torch.Tensor, states: torch.Tensor, dy: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The registered backward: (du, ddelta_raw, ddelta_bias, dA, dB, dC,
    dD, dz), the plain version on the CPU, the kernel on the card
    (:func:`kernel_backward`); contiguous."""
    return tuple(g.contiguous() for g in selective_scan_backward_plain(
        u, delta_raw, delta_bias, A, B, C, D, z, dy))


@selective_scan_backward_op.register_kernel("cuda")
def _selective_scan_backward_cuda(u, delta_raw, delta_bias, A, B, C, D, z,
                                  states, dy):
    return kernel_backward(u, delta_raw, delta_bias, A, B, C, D, z, states,
                           dy)


@selective_scan_backward_op.register_fake
def _selective_scan_backward_fake(u, delta_raw, delta_bias, A, B, C, D, z,
                                  states, dy):
    return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                 for t in (u, delta_raw, delta_bias, A, B, C, D, z))


def _forward(ins, backend: str) -> tuple:
    if _build.route(ins[0], backend) == "plain":
        return selective_scan_plain(*ins)
    return selective_scan_op(*ins)


class SelectiveScan(torch.autograd.Function):
    """The forward (the op, or the plain version for ``"torch"``), saving
    its inputs and the kept states; the backward op, or for ``"torch"``
    the plain backward."""

    @staticmethod
    def forward(ctx, u, delta_raw, delta_bias, A, B, C, D, z, backend):
        ins = (u, delta_raw, delta_bias, A, B, C, D, z)
        y, states = _forward(ins, backend)
        ctx.save_for_backward(*ins, states)
        ctx.backend = backend
        return y

    @staticmethod
    def backward(ctx, dy):
        spans.count("selective_scan/calls", 1)
        *ins, states = ctx.saved_tensors
        if _build.route(ins[0], ctx.backend) == "plain":
            grads = selective_scan_backward_plain(*ins, dy)
        else:
            grads = selective_scan_backward_op(*ins, states, dy.contiguous())
        return (*(g if n else None
                  for g, n in zip(grads, ctx.needs_input_grad)), None)


def selective_scan(u, delta_raw, delta_bias, A, B, C, D, z, *,
                   backend: str = "auto"):
    """The selective scan's y (module docstring). Differentiable through
    :class:`SelectiveScan` when grad is enabled and an input requires it."""
    spans.count("selective_scan/calls", 1)
    ins = (u, delta_raw, delta_bias, A, B, C, D, z)
    if _build.needs_grad(*ins):
        return SelectiveScan.apply(*ins, backend)
    return _forward(ins, backend)[0]


# operations of one (step, channel, state): delta A, its exp, the decayed
# state, delta u B and the sum, C s and the sum into y; of one (step,
# channel): the softplus (add, exp, log1p), delta u, D u and its add, the
# gate's SiLU (negate, exp, add, divide) and product
STATE_OPS, CHANNEL_OPS = 7, 11
# the backward, of one (step, channel, state): the states again (5) and,
# for the adjoint pass, the decay and its product (3), g += dy C (2),
# g s_{t-1} a (2),
# its products with A and delta into ddelta and dA (4), g delta u and dy s
# for dB and dC (3) and their sums over channels (2), g B and its sum (2),
# the decayed g (1); of one (step, channel): the softplus (3) and delta u
# (1), the gate's sigmoid and SiLU (4) and dy (1) twice, y's D u and add
# (2), dz (5), ddelta (2), ddelta_raw (3), du (3), the dD and bias sums (3)
BACKWARD_STATE_OPS, BACKWARD_CHANNEL_OPS = 24, 32


def work(u, B) -> tuple:
    """(bytes, operations) of the forward, what the scan itself must move
    (not the states the kernel keeps for its backward): u, delta_raw and z
    read once, y written once (u's dtype); B and C read once; A, D and
    delta_bias read once (float32)."""
    Bt, S, Dc = u.shape
    N = B.shape[-1]
    it = u.element_size()
    nbytes = (4 * Bt * S * Dc + 2 * Bt * S * N) * it \
        + 4 * (Dc * N + 2 * Dc)
    return nbytes, Bt * S * Dc * (N * STATE_OPS + CHANNEL_OPS)


def work_backward(u, B) -> tuple:
    """(bytes, operations) of the backward, what the gradient itself must
    move (not the states the forward kept): u, delta_raw, z and dy read
    once, du, ddelta_raw and dz written once; B and C read and dB, dC
    written once (u's dtype); A, D, delta_bias read once, dA, dD and
    ddelta_bias written once (float32)."""
    Bt, S, Dc = u.shape
    N = B.shape[-1]
    it = u.element_size()
    nbytes = (7 * Bt * S * Dc + 4 * Bt * S * N) * it \
        + 4 * (2 * Dc * N + 4 * Dc)
    return nbytes, Bt * S * Dc * (N * BACKWARD_STATE_OPS
                                  + BACKWARD_CHANNEL_OPS)
