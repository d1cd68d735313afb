"""Plain PyTorch oracles of the attention and SSD kernels (the ground truth
the tests hold the kernels and their plain versions against).

Ports of ``repro.kernels.ref``: same shapes, same float32 arithmetic.
"""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v):
    """Causal GQA attention, materialized scores (the O(S^2) oracle).

    q: (B, S, H, D); k, v: (B, S, KV, D) with H % KV == 0.
    Returns (B, S, H, D) in q.dtype; softmax/accumulate in f32.
    """
    B, S, H, D = q.shape
    KV = k.shape[2]
    if KV != H:
        k = torch.repeat_interleave(k, H // KV, dim=2)
        v = torch.repeat_interleave(v, H // KV, dim=2)
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def ssd_scan_ref(X, Adt, Bc, Cc, init_state=None):
    """Sequential SSD recurrence (Mamba-2), the linear-time oracle.

    X:   (B, S, H, P) inputs (pre-multiplied by dt)
    Adt: (B, S, H)    log-decay per step (negative)
    Bc:  (B, S, N)    write projection (shared across heads)
    Cc:  (B, S, N)    read projection
    Returns (Y: (B, S, H, P) in X.dtype, final_state: (B, H, P, N) f32).
    """
    B, S, H, P = X.shape
    N = Bc.shape[-1]
    state = (torch.zeros((B, H, P, N), dtype=torch.float32, device=X.device)
             if init_state is None else init_state.float())
    x, a, b, c = X.float(), Adt.float(), Bc.float(), Cc.float()
    ys = []
    for t in range(S):
        state = state * torch.exp(a[:, t])[..., None, None] + \
            torch.einsum("bhp,bn->bhpn", x[:, t], b[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", state, c[:, t]))
    Y = torch.stack(ys, dim=1) if ys else torch.zeros_like(x)
    return Y.to(X.dtype), state
