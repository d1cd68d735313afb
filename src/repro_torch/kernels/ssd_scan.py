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

Dispatch (``backend``) as :mod:`repro_torch.kernels._build` describes it.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build

# launches of the kernel in this process (the plain version counts none)
launches: Dict[str, int] = {"ssd_scan": 0}

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
}


def reset_launches() -> None:
    launches["ssd_scan"] = 0


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
    promotes them (float32 for the model's bf16 X, Bc, Cc and f32 A).
    """
    b, l, h, p = X.shape
    n = Bc.shape[-1]
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the SSD "
                         f"chunk {chunk}")
    ct = torch.promote_types(torch.promote_types(X.dtype, A.dtype),
                             torch.promote_types(Bc.dtype, Cc.dtype))
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
    states = states.float()

    # inter-chunk recurrence
    chunk_decay = torch.exp(A_cum[..., -1]).float()        # (b, h, c)
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32, device=X.device)
             if init_state is None else init_state.float())
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


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _check(X, Adt, Bc, Cc, chunk: int) -> None:
    if X.dim() != 4:
        raise ValueError(f"X must be (B, S, H, P); got {tuple(X.shape)}")
    B, S, H, P = X.shape
    N = Bc.shape[-1]
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
    """Chunked SSD scan. X: (B,S,H,P); Adt: (B,S,H); Bc/Cc: (B,S,N)."""
    S = X.shape[1]
    chunk = min(chunk, S)
    if chunk <= 0 or S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the SSD "
                         f"chunk {chunk}")
    if not _build.use_kernel(X, backend, "ssd_scan"):
        return ssd_chunked(X, Adt, Bc, Cc, chunk)[0]
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
