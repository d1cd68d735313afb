"""Causal GQA flash attention on the card: a hand-written CUDA kernel
(``repro_torch/csrc/flash_attention.cu``) with its plain PyTorch version
beside it and a launch counter.

Replaces ``repro.kernels.flash_attention.flash_attention`` (the Pallas
kernel, :74). q is ``(B, S, H, D)``, k and v ``(B, S, KV, D)`` with
``H % KV == 0``; the output is ``(B, S, H, D)`` in q's dtype, with scores,
softmax and accumulator in float32. The kernel reads the three operands
through their strides (only the last dimension must be contiguous) and
takes any S; it is built for D in :data:`HEAD_DIMS` and float32 or
bfloat16 inputs. bfloat16 runs on the tensor cores and rounds the
probabilities to bfloat16 before P.V, as the reference model does; its
operands must start on 16 bytes with strides that are multiples of 8
elements. float32 runs on the CUDA cores. The plain version is
``flash_attention_ref`` (materialized f32 scores, ``tril`` mask, softmax,
P.V).

Dispatch (``backend``) as :mod:`repro_torch.kernels._build` describes it.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

# launches of the kernel in this process (the plain version counts none)
launches: Dict[str, int] = {"flash_attention": 0}

BLOCK_Q = BLOCK_KV = 64            # rows of the kernel's query and key tiles
HEAD_DIMS = (16, 32, 64, 128)      # head dims the kernel is built for

_SIGNATURES = {
    # q, k, v, out, B, S, H, KV, D, strides[9], scale, dtype, stream
    "flash_attention_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 5
    + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}


def reset_launches() -> None:
    launches["flash_attention"] = 0


def library() -> ctypes.CDLL:
    """The kernel's shared library, built from source at first use."""
    return _build.load("flash_attention", _SIGNATURES)


def smem_bytes(head_dim: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory of one block of the kernel for ``dtype``. bfloat16
    (``smem_bf16_elems``): the q tile and two stages of k and v tiles, bf16
    rows padded by 8. float32 (``smem_floats``): q and k tiles with rows
    padded to D + 4 floats, the v tile and the probabilities."""
    if dtype == torch.bfloat16:
        return 2 * 5 * BLOCK_Q * (head_dim + 8)
    return 4 * (2 * BLOCK_Q * (head_dim + 4) + BLOCK_KV * head_dim
                + BLOCK_Q * BLOCK_KV)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, S, H, D) and k, v (B, S, KV, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    KV = k.shape[2]
    if k.shape[:2] != (B, S) or k.shape[3] != D or KV == 0 or H % KV:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H % KV must be 0)")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"the kernel takes float32 or bfloat16 q, k, v of "
                         f"one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel is built for head dims {HEAD_DIMS}; "
                         f"got {D}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the kernel reads q, k, v with a contiguous last "
                         "dimension")
    if q.dtype == torch.bfloat16:
        _build.check_16_byte_rows(("q", q), ("k", k), ("v", v))


def flash_attention(q, k, v, *, backend: str = "auto") -> torch.Tensor:
    """Causal GQA attention. q: (B, S, H, D); k, v: (B, S, KV, D)."""
    if not _build.use_kernel(q, backend, "flash_attention"):
        return flash_attention_ref(q, k, v)
    _check(q, k, v)
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    with torch.cuda.device(q.device):
        rc = library().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, k.shape[2], D, strides, 1.0 / math.sqrt(D),
            _build.DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, "flash_attention_fwd")
    launches["flash_attention"] += 1
    return out
