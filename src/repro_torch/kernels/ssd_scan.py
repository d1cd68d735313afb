"""Mamba-2 chunked SSD scan on the card: a hand-written CUDA kernel
(``repro_torch/csrc/ssd_scan.cu``) with its plain PyTorch version beside it
and a launch counter.

Replaces ``repro.kernels.ssd_scan.ssd_scan`` (the Pallas kernel, :70). X is
``(B, S, H, P)`` (inputs times dt), Adt ``(B, S, H)`` float32 (log decay
per step), Bc and Cc ``(B, S, N)`` shared across heads; the output Y is
``(B, S, H, P)`` in X's dtype, computed in float32, and the final state is
not returned. ``S % chunk == 0`` with ``chunk = min(chunk, S)``. The kernel
is built for P in :data:`HEAD_DIMS`, N a multiple of 16 up to 128, and
float32 or bfloat16 X, Bc, Cc of one dtype.

bfloat16 runs three launches, parallel over chunks, on the tensor cores:
the chunks' state contributions into a float32 scratch buffer
(:func:`scratch_bytes`, allocated here), a pass over the chunks that turns
them into the state entering each chunk, and the chunks' outputs; X, Bc
and Cc must start on 16 bytes with strides that are multiples of 8
elements. It rounds ``x * decay``, the decayed scores and the incoming
state to bfloat16 as the products' operands. float32 runs one launch per
call on the CUDA cores, one block per (b, h) walking its chunks in order.
Either way a call counts one launch of ``ssd_scan``.

The plain version is :func:`ssd_chunked`, the port of
``repro.models.ssm.ssd_chunked`` (the chunked einsum form the model runs);
``repro_torch.kernels.ref.ssd_scan_ref`` (the sequential recurrence) is
the second oracle of the tests.

Dispatch (``backend``) by ``_build.route``, through one registered op,
``torch.ops.repro_torch.ssd_scan``: its CUDA implementation is the kernel
(the three bf16 launches or the float32 one), its CPU implementation the
plain version, and its fake implementation gives Y's shape, so that
``FakeTensorMode`` traces a call as one node on either device and
``repro_torch.analysis.opcount`` counts it as :func:`work`.
``backend="torch"`` calls the plain version without the op.

Gradients: :func:`ssd_chunked` has two roles. It is the kernel's plain
version, and it is the reference's own train-time function (the
reference's train step differentiates ``ssm.ssd_chunked``; there is no
Pallas backward kernel to port). Whenever grad is enabled and an input
requires it, :func:`ssd_scan` goes through :class:`SSDScan`: its forward
is the kernel (all three bf16 launches, or the float32 one; the plain
version for CPU tensors and ``backend="torch"``), saving X, Adt, Bc and
Cc. Its backward, for bfloat16 X, Bc, Cc on the card (or fake ones, in a
dry-run's trace), is a second registered op,
``torch.ops.repro_torch.ssd_scan_backward`` (X, Adt, Bc, Cc, dY, chunk)
-> (dX, dAdt, dBc, dCc): its CUDA implementation is the
hand-written backward (:func:`kernel_backward`, seven launches that count
one ``ssd_scan_backward``), its CPU implementation
:func:`ssd_chunked_backward`, the same decomposition in plain PyTorch,
and its fake implementation the four shapes (one node, counted as
:func:`work_backward`). For CPU tensors, float32 inputs and
``backend="torch"`` the backward recomputes :func:`ssd_chunked` from the
saved inputs in its second role and returns autograd's gradients for all
four; :data:`backward_recomputes` counts these. Either way Adt carries the
gradient on to ``A_log`` and ``dt``. While a profiler records, every
backward adds one to the counter ``ssd/backward_calls`` and every launch
of the backward kernel one to ``ssd/backward_kernel_calls``. The forward
on the card never runs :func:`ssd_chunked`. Launching the kernel on such
inputs any other way (:func:`kernel_forward` under grad) raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch import spans
from repro_torch.kernels import _build

# launches of the kernels in this process (the plain versions count none)
launches: Dict[str, int] = {"ssd_scan": 0, "ssd_scan_backward": 0}
# backward passes of SSDScan that recompute ssd_chunked under autograd
backward_recomputes: Dict[str, int] = {"ssd_scan": 0}

DEFAULT_CHUNK = 128
TILE = 64                          # rows of the kernel's query and key tiles
HEAD_DIMS = (16, 32, 64, 128)      # head dims P the kernel is built for
MAX_STATE = 128                    # largest state width N it takes

_SIGNATURES = {
    # X, Adt, Bc, Cc, Y, B, S, H, P, N, Q, strides[10], dtype, stream
    "ssd_scan_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 6
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    # X, Adt, Bc, states, decay, B, S, H, P, N, Q, strides[10], stream
    "ssd_chunk_states_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 6
    + [ctypes.c_void_p, ctypes.c_void_p],
    # states, decay, B * H, chunks, P * N, stream
    "ssd_state_pass_fwd": [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3
    + [ctypes.c_void_p],
    # X, Adt, Bc, Cc, states, Y, B, S, H, P, N, Q, strides[10], stream
    "ssd_chunk_scan_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 6
    + [ctypes.c_void_p, ctypes.c_void_p],
    # X, Adt, Bc, Cc, dY, dX, dAdt, dBc, dCc, states, decay, dstates, cs,
    # rowpart, B, S, H, P, N, Q, strides[10], stream
    "ssd_scan_bwd": [ctypes.c_void_p] * 14 + [ctypes.c_longlong] * 6
    + [ctypes.c_void_p, ctypes.c_void_p],
}


def reset_launches() -> None:
    launches["ssd_scan"] = 0
    launches["ssd_scan_backward"] = 0
    backward_recomputes["ssd_scan"] = 0


def library() -> ctypes.CDLL:
    """The kernel's shared library, built from source at first use."""
    return _build.load("ssd_scan", _SIGNATURES)


def smem_bytes(chunk: int, head_dim: int, state: int,
               dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory of the largest block of the kernel for ``dtype``.

    bfloat16: the larger of the chunk-state pass (``states_smem_bytes``)
    and the chunk-scan pass (``scan_smem_bytes``): the C tile and two
    stages of B and X tiles in bf16 with rows padded by 8 (the (P, N)
    incoming state borrows the second stage), then the chunk's cumsum and
    4 warp totals in f32; 71,696 B at mamba2-130m (Q, P, N) = (256, 64,
    128). float32 (``smem_floats``): the (P, N) state and the C and B tiles
    with rows padded to N + 1 floats, the chunk's cumsum, the X tile and
    the 64 x 65 score tile, 133,120 B there."""
    P, N, Q = head_dim, state, chunk
    if dtype == torch.bfloat16:
        states = 2 * 2 * TILE * (min(P, TILE) + 8 + N + 8) + 4 * (Q + 4)
        scan = 2 * (3 * TILE * (N + 8) + 2 * TILE * (P + 8)) + 4 * (Q + 4)
        return max(states, scan)
    return 4 * (P * (N + 1) + Q + 2 * TILE * (N + 1) + TILE * P
                + TILE * (TILE + 1))


def scratch_bytes(batch: int, seq: int, heads: int, chunk: int,
                  head_dim: int, state: int) -> int:
    """Device memory the bfloat16 kernel's wrapper allocates per call: the
    float32 (B, H, S / Q, P, N) chunk states and (B, H, S / Q) chunk decays
    (25,168,896 B at the mamba2-130m prefill (4, 2048, 24, 256, 64,
    128))."""
    return 4 * batch * heads * (seq // chunk) * (head_dim * state + 1)


def backward_smem_bytes(chunk: int, head_dim: int, state: int) -> int:
    """Shared memory of the backward kernel's largest block (bfloat16): the
    larger of the forward's chunk-state pass (which the backward also runs
    for the state gradient's contributions), the dX pass (the key tile's B
    and X, two stages of the query tile's C and dY, the chunk's cumsum and
    5 x 64 f32 column sums) and the dB / dC pass (two stages of two (64,
    P) tiles and their 2 x 64 cumsums, two (64, N) tiles); 82,176 B at
    mamba2-130m (Q, P, N) = (256, 64, 128)."""
    P, N, Q = head_dim, state, chunk
    states = 2 * 2 * TILE * (min(P, TILE) + 8 + N + 8) + 4 * (Q + 4)
    dx = 2 * 3 * TILE * (N + 8 + P + 8) + 4 * -(-Q // 4) * 4 + 4 * 5 * TILE
    dbc = 2 * (2 * 2 * TILE * (P + 8) + 4 * 2 * TILE) + 2 * 2 * TILE * (N + 8)
    return max(states, dx, dbc)


# ---------------------------------------------------------------------------
# plain version: the chunked SSD of repro.models.ssm
# ---------------------------------------------------------------------------


def segsum(x):
    """x: (..., Q) -> (..., Q, Q) lower-triangular segment sums:
    out[i, j] = sum_{j < k <= i} x[k], -inf above diagonal."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -torch.inf)


def ssd_chunked(X, A, Bc, Cc, chunk: int, init_state=None):
    """Chunked SSD.

    X:  (b, l, h, p)  inputs (already multiplied by dt)
    A:  (b, l, h)     per-step log decay (dt * A, negative)
    Bc: (b, l, n)     input projection onto state (shared across heads)
    Cc: (b, l, n)     state read-out
    Returns (Y: (b, l, h, p) in X.dtype, final_state: (b, h, p, n) f32).
    The products run in the operands' promoted dtype, as ``jnp.einsum``
    promotes them (float32 for the model's bf16 X, Bc, Cc and f32 A);
    float64 operands keep float64 throughout, states included.
    """
    b, l, h, p = X.shape
    n = Bc.shape[-1]
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the SSD "
                         f"chunk {chunk}")
    ct = torch.promote_types(torch.promote_types(X.dtype, A.dtype),
                             torch.promote_types(Bc.dtype, Cc.dtype))
    st = torch.promote_types(ct, torch.float32)     # the states' dtype
    c, q = l // chunk, chunk
    Xc = X.to(ct).reshape(b, c, q, h, p)
    Ac = A.to(ct).reshape(b, c, q, h).movedim(-1, 1)       # (b, h, c, q)
    Bb = Bc.to(ct).reshape(b, c, q, n)
    Cb = Cc.to(ct).reshape(b, c, q, n)

    A_cum = torch.cumsum(Ac, dim=-1)                       # (b, h, c, q)
    Lm = torch.exp(segsum(Ac))                             # (b, h, c, q, q)

    # intra-chunk (quadratic, "attention-like")
    Y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", Cb, Bb, Lm, Xc)

    # chunk -> state contributions
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)      # (b, h, c, q)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bb, decay_states, Xc)
    states = states.to(st)

    # inter-chunk recurrence
    chunk_decay = torch.exp(A_cum[..., -1]).to(st)         # (b, h, c)
    carry = (torch.zeros((b, h, p, n), dtype=st, device=X.device)
             if init_state is None else init_state.to(st))
    prev = []
    for ci in range(c):                 # emit the state *before* each chunk
        prev.append(carry)
        carry = carry * chunk_decay[:, :, ci, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                 # (b, c, h, p, n)

    state_decay_out = torch.exp(A_cum)                     # (b, h, c, q)
    Y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cb,
                         prev_states.to(ct), state_decay_out)
    Y = (Y_diag + Y_off).reshape(b, l, h, p)
    return Y.to(X.dtype), carry


def ssd_chunked_backward(X, A, Bc, Cc, dY, chunk: int):
    """The gradients of :func:`ssd_chunked`'s Y (no initial state) with
    respect to X, A, Bc and Cc, given dY: ``(dX, dA, dBc, dCc)`` in the
    inputs' dtypes, by the decomposition the backward kernel follows,
    explicit and without autograd. Per chunk, with cs the inclusive cumsum
    of A over the chunk, L[i, j] = exp(cs_i - cs_j) (j <= i), e = exp(cs),
    w = exp(cs_last - cs):

    (a) the state entering each chunk, S_in, as :func:`ssd_chunked` has it;
    (b) each chunk's contribution to the state gradient, sum_i e_i dY_i C_i^T;
    (c) a reverse pass over the chunks: G, the gradient of the state
        leaving each chunk (zero for the last);
    (d) the chunk's terms: dX_j = sum_i (C_i.B_j) L_ij dY_i + w_j G B_j,
        dC_i = sum_h sum_j (dY_i.X_j) L_ij B_j + e_i S_in^T dY_i, dB_j the
        same with C_i and w_j X_j^T G, and d(cs)_k = sum_j M_kj - sum_i M_ik
        + dY_k.(e_k S_in C_k) - X_k.(w_k G B_k), M_ij = (C_i.B_j)(dY_i.X_j)
        L_ij; dA is d(cs) summed from the chunk's end, plus <G, S_out>.

    The products run in the operands' promoted dtype, the states in it or
    float32, as :func:`ssd_chunked`'s do."""
    b, l, h, p = X.shape
    n = Bc.shape[-1]
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the SSD "
                         f"chunk {chunk}")
    ct = torch.promote_types(
        torch.promote_types(torch.promote_types(X.dtype, A.dtype),
                            torch.promote_types(Bc.dtype, Cc.dtype)),
        dY.dtype)
    st = torch.promote_types(ct, torch.float32)
    c, q = l // chunk, chunk
    Xc = X.to(ct).reshape(b, c, q, h, p)
    dYc = dY.to(ct).reshape(b, c, q, h, p)
    Ac = A.to(ct).reshape(b, c, q, h).movedim(-1, 1)       # (b, h, c, q)
    Bb = Bc.to(ct).reshape(b, c, q, n)
    Cb = Cc.to(ct).reshape(b, c, q, n)
    cs = torch.cumsum(Ac, dim=-1)
    e = torch.exp(cs)                                      # exp(cs_i)
    w = torch.exp(cs[..., -1:] - cs)                       # exp(cs_last - cs_j)
    chunk_decay = torch.exp(cs[..., -1]).to(st)            # (b, h, c)

    # (a) the state entering each chunk, and the one leaving it
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bb, w, Xc).to(st)
    carry = torch.zeros((b, h, p, n), dtype=st, device=X.device)
    s_in, s_out = [], []
    for ci in range(c):
        s_in.append(carry)
        carry = carry * chunk_decay[:, :, ci, None, None] + states[:, ci]
        s_out.append(carry)
    S_in = torch.stack(s_in, dim=1)                        # (b, c, h, p, n)
    S_out = torch.stack(s_out, dim=1)

    # (b) each chunk's contribution to the state gradient, (c) the reverse
    # pass: G[ci] is the gradient of the state leaving chunk ci
    contrib = torch.einsum("bclhp,bhcl,bcln->bchpn", dYc, e, Cb).to(st)
    carry = torch.zeros((b, h, p, n), dtype=st, device=X.device)
    grads = [None] * c
    for ci in reversed(range(c)):
        grads[ci] = carry
        carry = carry * chunk_decay[:, :, ci, None, None] + contrib[:, ci]
    G = torch.stack(grads, dim=1)                          # (b, c, h, p, n)

    # (d) the chunk's terms
    Lm = torch.exp(segsum(Ac))                             # (b, h, c, i, j)
    SL = torch.einsum("bcin,bcjn->bcij", Cb, Bb)[:, None] * Lm
    dP = torch.einsum("bcihp,bcjhp->bhcij", dYc, Xc)
    dPL = dP * Lm
    Sc, Gc = S_in.to(ct), G.to(ct)
    dX = torch.einsum("bhcij,bcihp->bcjhp", SL, dYc) \
        + torch.einsum("bhcj,bcjn,bchpn->bcjhp", w, Bb, Gc)
    dC = torch.einsum("bhcij,bcjn->bcin", dPL, Bb) \
        + torch.einsum("bhci,bcihp,bchpn->bcin", e, dYc, Sc)
    dB = torch.einsum("bhcij,bcin->bcjn", dPL, Cb) \
        + torch.einsum("bhcj,bcjhp,bchpn->bcjn", w, Xc, Gc)
    M = SL * dP                                            # S o dP o L
    y_off = torch.einsum("bhci,bcin,bchpn->bcihp", e, Cb, Sc)
    dx_off = torch.einsum("bhcj,bcjn,bchpn->bcjhp", w, Bb, Gc)
    dcs = M.sum(-1) - M.sum(-2) \
        + torch.einsum("bcihp,bcihp->bhci", dYc, y_off) \
        - torch.einsum("bcjhp,bcjhp->bhcj", Xc, dx_off)
    leaving = torch.einsum("bchpn,bchpn->bhc", G, S_out).to(ct)
    dA = torch.flip(torch.cumsum(torch.flip(dcs, (-1,)), -1), (-1,)) \
        + leaving[..., None]
    return (dX.reshape(b, l, h, p).to(X.dtype),
            dA.movedim(1, -1).reshape(b, l, h).to(A.dtype),
            dB.reshape(b, l, n).to(Bc.dtype),
            dC.reshape(b, l, n).to(Cc.dtype))


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _check(X, Adt, Bc, Cc, chunk: int) -> None:
    if X.dim() != 4:
        raise ValueError(f"X must be (B, S, H, P); got {tuple(X.shape)}")
    B, S, H, P = X.shape
    N = Bc.shape[-1]
    if chunk <= 0 or S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the SSD "
                         f"chunk {chunk}")
    if tuple(Adt.shape) != (B, S, H) or Bc.dim() != 3 \
            or tuple(Bc.shape[:2]) != (B, S) or Cc.shape != Bc.shape:
        raise ValueError(f"Adt {tuple(Adt.shape)}, Bc {tuple(Bc.shape)}, Cc "
                         f"{tuple(Cc.shape)} do not fit X {tuple(X.shape)}")
    if X.dtype not in _build.DTYPE_CODES or Bc.dtype != X.dtype \
            or Cc.dtype != X.dtype or Adt.dtype != torch.float32:
        raise ValueError(f"the kernel takes float32 or bfloat16 X, Bc, Cc of "
                         f"one dtype and float32 Adt; got {X.dtype}, "
                         f"{Bc.dtype}, {Cc.dtype}, {Adt.dtype}")
    if P not in HEAD_DIMS or N % 16 or not 0 < N <= MAX_STATE:
        raise ValueError(f"the kernel is built for P in {HEAD_DIMS} and N a "
                         f"multiple of 16 up to {MAX_STATE}; got P={P}, N={N}")
    if any(t.device != X.device for t in (Adt, Bc, Cc)):
        raise ValueError("X, Adt, Bc, Cc must be on one device")
    if any(t.stride(-1) != 1 for t in (X, Adt, Bc, Cc)) and B * S:
        raise ValueError("the kernel reads X, Adt, Bc, Cc with a contiguous "
                         "last dimension")
    smem = smem_bytes(chunk, P, N, X.dtype)
    if smem > _build.SMEM_PER_BLOCK:
        raise ValueError(f"chunk {chunk} at P={P}, N={N} needs {smem} B of "
                         f"shared memory; a block may use "
                         f"{_build.SMEM_PER_BLOCK}")
    if X.dtype == torch.bfloat16 and B * S:
        _build.check_16_byte_rows(("X", X), ("Bc", Bc), ("Cc", Cc))


def ssd_scan(X, Adt, Bc, Cc, *, chunk: int = DEFAULT_CHUNK,
             backend: str = "auto") -> torch.Tensor:
    """Chunked SSD scan. X: (B,S,H,P); Adt: (B,S,H); Bc/Cc: (B,S,N).
    Differentiable through :class:`SSDScan` when grad is enabled and an
    input requires it."""
    S = X.shape[1]
    chunk = min(chunk, S)
    if chunk <= 0 or S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the SSD "
                         f"chunk {chunk}")
    if _build.needs_grad(X, Adt, Bc, Cc):
        return SSDScan.apply(X, Adt, Bc, Cc, chunk, backend)
    return _forward(X, Adt, Bc, Cc, chunk, backend)


def work(X, Bc, chunk: int) -> tuple:
    """(bytes, operations) of the chunked SSD scan: X, Adt (f32), Bc, Cc
    read once and Y written once; per (b, h, chunk) C.B^T (2 N) and
    scores.X (2 P) for each (position, position j <= it) pair of the chunk,
    as ``flash_attention.work`` counts only the causal pairs, plus C.S^T
    and the state update (2 Q N P each)."""
    B, S, H, P = X.shape
    N = Bc.shape[-1]
    nbytes = (2 * B * S * H * P + 2 * B * S * N) * X.element_size() \
        + B * S * H * 4
    per_chunk = chunk * (chunk + 1) * (N + P) + 4 * chunk * N * P
    return nbytes, B * H * (S // chunk) * per_chunk


def work_backward(X, Bc, chunk: int) -> tuple:
    """(bytes, operations) of the chunked SSD scan's backward: X, Adt (f32),
    Bc, Cc and dY read once, dX, dAdt (f32), dBc and dCc written once; per
    (b, h, chunk) and (position, position j <= it) pair of the chunk C.B^T
    (2 N), dY.X^T (2 P), dX's scores.dY (2 P), dC's and dB's (2 N each),
    as :func:`work` counts the causal pairs, plus six (Q, P, N) products
    (2 Q N P each): the recomputed states, the state gradient's
    contributions, the inter-chunk terms of dX, dC and dB, and the incoming
    state read out for d(cs)."""
    B, S, H, P = X.shape
    N = Bc.shape[-1]
    nbytes = (3 * B * S * H * P + 4 * B * S * N) * X.element_size() \
        + 2 * B * S * H * 4
    per_chunk = chunk * (chunk + 1) // 2 * (6 * N + 4 * P) \
        + 12 * chunk * N * P
    return nbytes, B * H * (S // chunk) * per_chunk


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=(),
                         device_types="cpu")
def ssd_scan_op(X: torch.Tensor, Adt: torch.Tensor, Bc: torch.Tensor,
                Cc: torch.Tensor, chunk: int) -> torch.Tensor:
    """The registered op: the plain version on the CPU, the kernel on the
    card (:func:`kernel_forward`); contiguous, as the kernel writes it."""
    return ssd_chunked(X, Adt, Bc, Cc, chunk)[0].contiguous()


@ssd_scan_op.register_kernel("cuda")
def _ssd_scan_cuda(X, Adt, Bc, Cc, chunk):
    return kernel_forward(X, Adt, Bc, Cc, chunk=chunk)


@ssd_scan_op.register_fake
def _ssd_scan_fake(X, Adt, Bc, Cc, chunk):
    return torch.empty(X.shape, dtype=X.dtype, device=X.device)


@torch.library.custom_op("repro_torch::ssd_scan_backward", mutates_args=(),
                         device_types="cpu")
def ssd_scan_backward_op(X: torch.Tensor, Adt: torch.Tensor,
                         Bc: torch.Tensor, Cc: torch.Tensor,
                         dY: torch.Tensor, chunk: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """The registered backward: (dX, dAdt, dBc, dCc) of Y given dY, the
    plain version on the CPU, the kernel on the card
    (:func:`kernel_backward`); contiguous, as the kernel writes them."""
    return tuple(g.contiguous()
                 for g in ssd_chunked_backward(X, Adt, Bc, Cc, dY, chunk))


@ssd_scan_backward_op.register_kernel("cuda")
def _ssd_scan_backward_cuda(X, Adt, Bc, Cc, dY, chunk):
    return kernel_backward(X, Adt, Bc, Cc, dY, chunk=chunk)


@ssd_scan_backward_op.register_fake
def _ssd_scan_backward_fake(X, Adt, Bc, Cc, dY, chunk):
    return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                 for t in (X, Adt, Bc, Cc))


def _forward(X, Adt, Bc, Cc, chunk: int, backend: str) -> torch.Tensor:
    if _build.route(X, backend) == "plain":
        return ssd_chunked(X, Adt, Bc, Cc, chunk)[0]
    return ssd_scan_op(X, Adt, Bc, Cc, chunk)


class SSDScan(torch.autograd.Function):
    """The kernel's forward; the backward is the backward op where the
    kernel runs (``_build.route``) on bfloat16 X, Bc, Cc and float32 Adt,
    else it recomputes :func:`ssd_chunked` from the saved X, Adt, Bc, Cc
    and returns its autograd gradients."""

    @staticmethod
    def forward(ctx, X, Adt, Bc, Cc, chunk, backend):
        ctx.save_for_backward(X, Adt, Bc, Cc)
        ctx.chunk, ctx.backend = chunk, backend
        return _forward(X, Adt, Bc, Cc, chunk, backend)

    @staticmethod
    def backward(ctx, grad_y):
        spans.count("ssd/backward_calls", 1)
        saved, needs = ctx.saved_tensors, ctx.needs_input_grad[:4]
        X, Adt, Bc, Cc = saved
        if _build.route(X, ctx.backend) == "kernel" \
                and X.dtype == Bc.dtype == Cc.dtype == torch.bfloat16 \
                and Adt.dtype == torch.float32:
            grads = ssd_scan_backward_op(*saved, grad_y.contiguous(),
                                         ctx.chunk)
            grads = [g if n else None for g, n in zip(grads, needs)]
        else:
            backward_recomputes["ssd_scan"] += 1
            grads = _build.recompute_grads(
                lambda *a: ssd_chunked(*a, ctx.chunk)[0], saved, needs,
                grad_y)
        return (*grads, None, None)


def kernel_forward(X, Adt, Bc, Cc, *, chunk: int) -> torch.Tensor:
    """Launch the CUDA kernel (``chunk`` at most S, dividing it) on CUDA
    tensors. No autograd: raises when grad is enabled and an input
    requires it (call :func:`ssd_scan`, which routes such inputs through
    :class:`SSDScan`)."""
    _build.check_no_grad("ssd_scan", X, Adt, Bc, Cc)
    _build.check_cuda("ssd_scan", X)
    _check(X, Adt, Bc, Cc, chunk)
    B, S, H, P = X.shape
    Y = torch.empty((B, S, H, P), dtype=X.dtype, device=X.device)
    if Y.numel() == 0:
        return Y
    N = Bc.shape[-1]
    strides = (ctypes.c_longlong * 10)(*X.stride()[:3], *Adt.stride(),
                                       *Bc.stride()[:2], *Cc.stride()[:2])
    with torch.cuda.device(X.device):
        lib, stream = library(), torch.cuda.current_stream().cuda_stream
        if X.dtype == torch.bfloat16:
            nc = S // chunk
            states = torch.empty((B, H, nc, P, N), dtype=torch.float32,
                                 device=X.device)
            decay = torch.empty((B, H, nc), dtype=torch.float32,
                                device=X.device)
            _build.raise_on(lib.ssd_chunk_states_fwd(
                X.data_ptr(), Adt.data_ptr(), Bc.data_ptr(),
                states.data_ptr(), decay.data_ptr(), B, S, H, P, N, chunk,
                strides, stream), "ssd_chunk_states_fwd")
            _build.raise_on(lib.ssd_state_pass_fwd(
                states.data_ptr(), decay.data_ptr(), B * H, nc, P * N,
                stream), "ssd_state_pass_fwd")
            _build.raise_on(lib.ssd_chunk_scan_fwd(
                X.data_ptr(), Adt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                states.data_ptr(), Y.data_ptr(), B, S, H, P, N, chunk,
                strides, stream), "ssd_chunk_scan_fwd")
        else:
            _build.raise_on(lib.ssd_scan_fwd(
                X.data_ptr(), Adt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                Y.data_ptr(), B, S, H, P, N, chunk, strides,
                _build.DTYPE_CODES[X.dtype], stream), "ssd_scan_fwd")
    launches["ssd_scan"] += 1
    return Y


def kernel_backward(X, Adt, Bc, Cc, dY, *, chunk: int) -> tuple:
    """Launch the CUDA backward on bfloat16 CUDA tensors: (dX, dAdt, dBc,
    dCc) of the scan's Y given dY, dAdt float32, the others bfloat16, each
    contiguous. The forward's state passes run again, then the state
    gradient's contributions, the reverse pass over the chunks, the dX,
    the dB / dC and the dAdt passes (seven launches, one count of
    ``ssd_scan_backward``). Its float32 scratch lives only for the call:
    the recomputed (B, H, S / Q, P, N) states and (B, H, S / Q) decays,
    the state gradients (B, H, S / Q, P, N), the cumsums (B, H, S) and the
    d(cs) parts of each 64-row key tile (B, H, S / Q, ceil(Q / 64), Q);
    217 MB at mamba2-130m's train step, 580 MB at granite's."""
    _build.check_cuda("ssd_scan", X)
    _check(X, Adt, Bc, Cc, chunk)
    if X.dtype != torch.bfloat16 or dY.dtype != X.dtype \
            or dY.shape != X.shape or dY.device != X.device:
        raise ValueError(f"the backward kernel takes bfloat16 X, Bc, Cc and "
                         f"a dY of X's shape and dtype; got X {X.dtype}, dY "
                         f"{dY.dtype} {tuple(dY.shape)}")
    B, S, H, P = X.shape
    N = Bc.shape[-1]
    smem = backward_smem_bytes(chunk, P, N)
    if smem > _build.SMEM_PER_BLOCK:
        raise ValueError(f"chunk {chunk} at P={P}, N={N} needs {smem} B of "
                         f"shared memory in the backward; a block may use "
                         f"{_build.SMEM_PER_BLOCK}")
    dY = dY.contiguous()
    outs = (torch.empty((B, S, H, P), dtype=X.dtype, device=X.device),
            torch.empty((B, S, H), dtype=torch.float32, device=X.device),
            torch.empty((B, S, N), dtype=X.dtype, device=X.device),
            torch.empty((B, S, N), dtype=X.dtype, device=X.device))
    if X.numel() == 0:
        return outs
    nc, tiles = S // chunk, -(-chunk // TILE)
    f32 = dict(dtype=torch.float32, device=X.device)
    states = torch.empty((B, H, nc, P, N), **f32)
    decay = torch.empty((B, H, nc), **f32)
    dstates = torch.empty((B, H, nc, P, N), **f32)
    cs = torch.empty((B, H, nc, chunk), **f32)
    rowpart = torch.empty((B, H, nc, tiles, chunk), **f32)
    strides = (ctypes.c_longlong * 10)(*X.stride()[:3], *Adt.stride(),
                                       *Bc.stride()[:2], *Cc.stride()[:2])
    with torch.cuda.device(X.device):
        lib, stream = library(), torch.cuda.current_stream().cuda_stream
        _build.raise_on(lib.ssd_scan_bwd(
            X.data_ptr(), Adt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            dY.data_ptr(), *(t.data_ptr() for t in outs), states.data_ptr(),
            decay.data_ptr(), dstates.data_ptr(), cs.data_ptr(),
            rowpart.data_ptr(), B, S, H, P, N, chunk, strides, stream),
            "ssd_scan_bwd")
    launches["ssd_scan_backward"] += 1
    spans.count("ssd/backward_kernel_calls", 1)
    return outs
