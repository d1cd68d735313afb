"""Causal GQA flash attention on the card: a hand-written CUDA kernel
(``repro_torch/csrc/flash_attention.cu``) with its plain PyTorch version
beside it and a launch counter.

Replaces ``repro.kernels.flash_attention.flash_attention`` (the Pallas
kernel, :74). q is ``(B, S, H, D)``, k and v ``(B, S, KV, D)`` with
``H % KV == 0``; the output is ``(B, S, H, D)`` in q's dtype, with scores,
softmax and accumulator in float32. The kernel reads the three operands
through their strides (only the last dimension must be contiguous) and
takes any S; it is built for D in :data:`HEAD_DIMS` and float32 or
bfloat16 inputs. The scores are scaled by ``scale``, 1/sqrt(D) unless
given. bfloat16 runs on the tensor cores and rounds the
probabilities to bfloat16 before P.V, as the reference model does; its
operands must start on 16 bytes with strides that are multiples of 8
elements. float32 runs on the CUDA cores. The plain version is
``flash_attention_ref`` (materialized f32 scores, ``tril`` mask, softmax,
P.V).

Dispatch (``backend``) by ``_build.route``, through one registered op,
``torch.ops.repro_torch.flash_attention``: its CUDA implementation launches
the kernel, its CPU implementation is the plain version, and its fake
implementation gives the output's shape, so that ``FakeTensorMode`` traces
a call as one node on either device and ``repro_torch.analysis.opcount``
counts it as :func:`work`. ``backend="torch"`` calls the plain version
without the op.

Gradients: the kernel writes its output through a raw pointer, so a
tensor it fills has no ``grad_fn``. Whenever grad is enabled and an input
requires it, :func:`flash_attention` goes through :class:`FlashAttention`
instead: its forward is the kernel (or, for CPU tensors and
``backend="torch"``, the plain version), saving q, k and v; its backward
recomputes the scores from them and takes the gradients of the
reference's causal softmax attention (``ref.reference_attention``, which
the reference's train step differentiates; there is no Pallas backward
kernel to port) directly, :data:`BACKWARD_BLOCK` queries at a time
(:func:`blockwise_grads`), so that one block's scores live at a time
(:data:`backward_recomputes` counts these backwards). Launching the
kernel on such inputs any other way (:func:`kernel_forward` under grad)
raises, so no caller can cut the gradient silently.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import _acc_dtype, flash_attention_ref

# launches of the kernel in this process (the plain version counts none)
launches: Dict[str, int] = {"flash_attention": 0}
# backward passes of FlashAttention (each recomputes the scores)
backward_recomputes: Dict[str, int] = {"flash_attention": 0}

BLOCK_Q = BLOCK_KV = 64            # rows of the kernel's query and key tiles
HEAD_DIMS = (16, 32, 64, 128)      # head dims the kernel is built for
# queries a block of the backward takes: one block's scores live at a time
# (on an H100 at the train cells' shapes 1,024 is no faster, with twice
# the scratch)
BACKWARD_BLOCK = 512

_SIGNATURES = {
    # q, k, v, out, B, S, H, KV, D, strides[9], scale, dtype, stream
    "flash_attention_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 5
    + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}


def reset_launches() -> None:
    launches["flash_attention"] = 0
    backward_recomputes["flash_attention"] = 0


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


def flash_attention(q, k, v, *, backend: str = "auto",
                    scale: Optional[float] = None) -> torch.Tensor:
    """Causal GQA attention. q: (B, S, H, D); k, v: (B, S, KV, D); the
    scores scaled by ``scale`` (1/sqrt(D) when None). Differentiable
    through :class:`FlashAttention` when grad is enabled and an input
    requires it."""
    if _build.needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, backend, scale)
    return _forward(q, k, v, backend, scale)


def work(q, k) -> tuple:
    """(bytes, operations) of causal attention: q, k, v read once and the
    output written once; 4 D operations for each (query, key <= query)
    pair of a head (q.k and p.v)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    nbytes = (2 * B * S * H * D + 2 * B * S * KV * D) * q.element_size()
    return nbytes, 4 * D * B * H * S * (S + 1) // 2


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: Optional[float] = None) -> torch.Tensor:
    """The registered op: the plain version on the CPU, the kernel on the
    card (:func:`kernel_forward`); contiguous, as the kernel writes it."""
    return flash_attention_ref(q, k, v, scale).contiguous()


@flash_attention_op.register_kernel("cuda")
def _flash_attention_cuda(q, k, v, scale=None):
    return kernel_forward(q, k, v, scale=scale)


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, scale=None):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def _forward(q, k, v, backend: str, scale=None) -> torch.Tensor:
    if _build.route(q, backend) == "plain":
        return flash_attention_ref(q, k, v, scale)
    return flash_attention_op(q, k, v, scale)


class FlashAttention(torch.autograd.Function):
    """The kernel's forward; the backward recomputes the scores from the
    saved q, k, v and returns the gradients of ``reference_attention``
    (:func:`blockwise_grads`)."""

    @staticmethod
    def forward(ctx, q, k, v, backend, scale=None):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _forward(q, k, v, backend, scale)

    @staticmethod
    def backward(ctx, grad_out):
        backward_recomputes["flash_attention"] += 1
        grads = blockwise_grads(*ctx.saved_tensors, grad_out, ctx.scale,
                                ctx.needs_input_grad[:3])
        return (*grads, None, None)


def blockwise_grads(q, k, v, grad_out, scale, needs) -> list:
    """The gradients of causal softmax attention with respect to q, k, v
    (None where ``needs`` says no) given grad_out, one block of
    :data:`BACKWARD_BLOCK` queries at a time over the keys up to its last
    query. Per block, with the products in q's dtype and the softmax in
    float32 (float64 for float64 inputs), as ``reference_attention``
    rounds them (the scores out of the activations' dtype product, the
    probabilities P rounded to it before each product): S = Q K^T scale,
    P = softmax(S), O = P V, dV += P^T dO, dP = dO V^T, dS = P (dP -
    rowsum(dO O)), dQ = dS K scale, dK += dS^T Q scale; a kv head takes the
    sum over its query heads; dK and dV are summed over the blocks in
    order, in the softmax's dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    dt, f32 = q.dtype, _acc_dtype(q.dtype)
    dq = torch.empty_like(q) if needs[0] else None
    dk = torch.zeros(k.shape, dtype=f32, device=k.device)
    dv = torch.zeros(v.shape, dtype=f32, device=v.device)
    pos = torch.arange(S, device=q.device)
    for q0 in range(0, S, BACKWARD_BLOCK):
        q1 = min(q0 + BACKWARD_BLOCK, S)
        qi = q[:, q0:q1].reshape(B, q1 - q0, KV, G, hd)
        do = grad_out[:, q0:q1].to(dt).reshape(B, q1 - q0, KV, G, hd)
        ki, vi = k[:, :q1], v[:, :q1]
        s = torch.einsum("bqcgd,bkcd->bcgqk", qi, ki).to(f32) * scale
        s = s.masked_fill(pos[q0:q1, None] < pos[None, :q1], -math.inf)
        p = torch.softmax(s, dim=-1)
        del s
        pd = p.to(dt)
        o = torch.einsum("bcgqk,bkcd->bqcgd", pd, vi).to(f32)
        dv[:, :q1] += torch.einsum("bcgqk,bqcgd->bkcd", pd, do).to(f32)
        del pd
        rows = (do.to(f32) * o).sum(-1).permute(0, 2, 3, 1)   # b c g q
        dp = torch.einsum("bqcgd,bkcd->bcgqk", do, vi).to(f32)
        ds = (p * (dp - rows[..., None])).to(dt)
        del p, dp
        if needs[0]:
            dq[:, q0:q1] = (torch.einsum("bcgqk,bkcd->bqcgd", ds, ki)
                            .to(f32) * scale).reshape(B, q1 - q0, H, hd)
        dk[:, :q1] += torch.einsum("bcgqk,bqcgd->bkcd", ds, qi).to(f32) \
            * scale
        del ds
    return [dq, dk.to(k.dtype) if needs[1] else None,
            dv.to(v.dtype) if needs[2] else None]


def kernel_forward(q, k, v, *, scale: Optional[float] = None
                   ) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors, the scores scaled by
    ``scale`` (1/sqrt(D) when None). No autograd: raises when grad is
    enabled and an input requires it (call :func:`flash_attention`, which
    routes such inputs through :class:`FlashAttention`)."""
    _build.check_no_grad("flash_attention", q, k, v)
    _build.check_cuda("flash_attention", q)
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
            H, k.shape[2], D, strides,
            1.0 / math.sqrt(D) if scale is None else scale,
            _build.DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on(rc, "flash_attention_fwd")
    launches["flash_attention"] += 1
    return out
