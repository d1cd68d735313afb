"""The LM models' entry into the attention and SSD kernels.

Port of ``repro.kernels.ops``: :func:`flash_attention` and :func:`ssd_scan`
dispatch to the hand-written CUDA kernels for CUDA tensors and to their
plain versions for CPU tensors (``backend``, as
:mod:`repro_torch.kernels._build` describes it). The reference's
``vmem_bytes_*`` budgets of the TPU's VMEM become the kernels' shared-memory
budgets, ``flash_attention.smem_bytes`` and ``ssd_scan.smem_bytes``, each
held under ``_build.SMEM_PER_BLOCK``.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd


def flash_attention(q, k, v, *, backend: str = "auto"):
    """Causal GQA attention. q: (B,S,H,D); k, v: (B,S,KV,D)."""
    return _fa.flash_attention(q, k, v, backend=backend)


def ssd_scan(X, Adt, Bc, Cc, *, chunk: int = _ssd.DEFAULT_CHUNK,
             backend: str = "auto"):
    """Mamba-2 chunked SSD scan. X: (B,S,H,P); Adt: (B,S,H); Bc/Cc: (B,S,N)."""
    return _ssd.ssd_scan(X, Adt, Bc, Cc, chunk=chunk, backend=backend)
