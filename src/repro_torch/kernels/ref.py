"""Plain PyTorch oracles of the attention and SSD kernels (the ground truth
the tests hold the kernels and their plain versions against), and the
reference model's own attention (:func:`reference_attention`).

``flash_attention_ref`` and ``ssd_scan_ref`` are ports of
``repro.kernels.ref``: same shapes, same float32 arithmetic (float64 inputs
stay float64). :func:`reference_attention` is the reference model's
``causal_attention`` (``repro.models.layers``), the function its train
step differentiates; it lives here, beside the plain versions, so that the
flash-attention wrapper can recompute its gradient without importing
``repro_torch.models`` (``models.layers`` imports the kernels and keeps the
name).
"""
from __future__ import annotations

import math

import torch


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, the reference's accumulation type, or float64 for float64
    inputs (the tests' ``gradcheck``)."""
    return torch.promote_types(dtype, torch.float32)


def flash_attention_ref(q, k, v, scale=None):
    """Causal GQA attention, materialized scores (the O(S^2) oracle).

    q: (B, S, H, D); k, v: (B, S, KV, D) with H % KV == 0.
    Returns (B, S, H, D) in q.dtype; softmax/accumulate in f32. The scores
    are scaled by ``scale``, 1/sqrt(D) when None.
    """
    B, S, H, D = q.shape
    KV = k.shape[2]
    if KV != H:
        k = torch.repeat_interleave(k, H // KV, dim=2)
        v = torch.repeat_interleave(v, H // KV, dim=2)
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    acc = _acc_dtype(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(acc))
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


# ---------------------------------------------------------------------------
# the reference model's attention (repro.models.layers.causal_attention)
# ---------------------------------------------------------------------------


# the reference's causal_attention: _sdpa up to this many positions, blocks
# of BLOCK_Q queries against BLOCK_KV keys above
BLOCK_Q, BLOCK_KV = 512, 1024


def repeat_kv(k, num_heads):
    """(B,S,KV,hd) -> (B,S,H,hd) by repeating each kv head."""
    kv = k.shape[2]
    if kv == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // kv, dim=2)


def _sdpa(q, k, v, mask, scale):
    """The reference's plain attention (``layers._sdpa``), k and v already
    repeated to H heads; mask: (Sq, Sk) bool, or None for no mask."""
    scores = torch.einsum("bqhk,bshk->bhqs", q, k).to(
        _acc_dtype(q.dtype)) * scale
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshk->bqhk", probs, v)


def reference_attention(q, k, v, scale=None):
    """The reference's ``causal_attention``: ``_sdpa`` while S fits one
    block, else an online softmax over blocks of :data:`BLOCK_Q` queries
    and :data:`BLOCK_KV` keys (every key block, masked ones included), with
    the scores of each block from the activations' dtype product and its
    unnormalised probabilities rounded to that dtype before P.V. A last
    block may be short (the reference's blocks divide S). Differentiable:
    the reference's train step takes its gradient through this function.
    The scores are scaled by ``scale``, 1/sqrt(hd) when None."""
    B, S, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    acc_dtype = _acc_dtype(q.dtype)
    k = repeat_kv(k, H)
    v = repeat_kv(v, H)
    if S <= max(BLOCK_Q, BLOCK_KV):
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        return _sdpa(q, k, v, mask, scale)
    pos = torch.arange(S, device=q.device)
    out = []
    for q0 in range(0, S, BLOCK_Q):
        qi, qp = q[:, q0:q0 + BLOCK_Q], pos[q0:q0 + BLOCK_Q]
        acc = torch.zeros((B, H, qi.shape[1], hd), dtype=acc_dtype,
                          device=q.device)
        m = torch.full((B, H, qi.shape[1]), -1e30, dtype=acc_dtype,
                       device=q.device)
        l = torch.zeros_like(m)
        for k0 in range(0, S, BLOCK_KV):
            s = torch.einsum("bqhk,bshk->bhqs", qi,
                             k[:, k0:k0 + BLOCK_KV]).to(acc_dtype) * scale
            s = torch.where(qp[:, None] >= pos[None, k0:k0 + BLOCK_KV], s,
                            -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqs,bshk->bhqk", p.to(qi.dtype),
                v[:, k0:k0 + BLOCK_KV]).to(acc_dtype)
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        out.append(o.movedim(1, 2).to(q.dtype))
    return torch.cat(out, dim=1)
