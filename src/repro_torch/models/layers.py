"""Shared LM layers, ported from ``repro.models.layers``: RMS norm, RoPE,
GQA attention (prefill through the flash-attention kernel, one-token
decode against a KV cache), SwiGLU MLP, embeddings.

Parameters live in ``nn.Module``s whose attribute names and tensor shapes
are the reference's pytree keys and shapes, so ``repro_torch.convert``
carries them across by name. The apply functions are plain functions over
those modules, as the reference's are over its dicts, and cast each weight
to the activations' dtype where they use it. Parameters are float32
(``param_dtype``) when made; the serving paths cast them to bfloat16. The
port serves only: no parameter requires grad.

Out of this port so far (``ROADMAP.md``): ``local_attention`` (sliding
window, the hybrid family), cross attention (vlm) and the loss.
``causal_attention`` runs the flash kernel on the card and, on the CPU,
the reference's own two regimes (``_sdpa`` and online-softmax blocks) with
their roundings. ``constrain`` and ``remat_wrap`` have
no meaning on one card without a mesh and are dropped.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def empty(shape, device) -> nn.Parameter:
    """An uninitialised float32 parameter (``param_dtype``)."""
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


def dense_init_(w: torch.Tensor, generator: torch.Generator,
                scale: float | None = None) -> None:
    """Truncated-normal fan-in init in place: ``scale`` times a standard
    normal cut to [-2, 2], ``scale = 1/sqrt(fan_in)`` unless given (the
    reference's ``dense_init``)."""
    shape = w.shape
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    w.mul_(scale)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Rotates
    split halves in float32, frequencies ``exp(-i * ln(theta) / half)``."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=x.device)
        * (math.log(theta) / half))
    angles = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention parameters
# ---------------------------------------------------------------------------


class AttentionParams(nn.Module):
    """wq (d, H, hd), wk / wv (d, KV, hd), wo (H, hd, d); with ``qkv_bias``
    bq (H, hd), bk / bv (KV, hd)."""

    def __init__(self, d_model, num_heads, num_kv_heads, head_dim,
                 qkv_bias=False, *, device=None):
        super().__init__()
        self.wq = empty((d_model, num_heads, head_dim), device)
        self.wk = empty((d_model, num_kv_heads, head_dim), device)
        self.wv = empty((d_model, num_kv_heads, head_dim), device)
        self.wo = empty((num_heads, head_dim, d_model), device)
        if qkv_bias:
            self.bq = empty((num_heads, head_dim), device)
            self.bk = empty((num_kv_heads, head_dim), device)
            self.bv = empty((num_kv_heads, head_dim), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv):
            dense_init_(w, generator)
        H, hd = self.wo.shape[:2]
        dense_init_(self.wo, generator, scale=1.0 / math.sqrt(H * hd))
        if hasattr(self, "bq"):
            for b in (self.bq, self.bk, self.bv):
                b.zero_()


def _project_qkv(p, x, positions, theta):
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p.wk.to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p.wv.to(x.dtype))
    if hasattr(p, "bq"):
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta), v


def _repeat_kv(k, num_heads):
    """(B,S,KV,hd) -> (B,S,H,hd) by repeating each kv head."""
    kv = k.shape[2]
    if kv == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // kv, dim=2)


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------


# the reference's causal_attention: _sdpa up to this many positions, blocks
# of BLOCK_Q queries against BLOCK_KV keys above
BLOCK_Q, BLOCK_KV = 512, 1024


def causal_attention(q, k, v, *, backend: str = "auto"):
    """Causal GQA attention. q: (B,S,H,hd); k, v: (B,S,KV,hd).

    On the card, and wherever ``backend`` names one, it runs the
    flash-attention kernel's wrapper (``ops.flash_attention``). In
    bfloat16 the kernel rounds the unnormalised probabilities of each
    64-key tile to bfloat16 before P.V and keeps scores, row sums and the
    accumulator in float32; its plain version (``backend="torch"``, like
    the Pallas kernel) keeps the probabilities in float32 too.

    On the CPU with ``backend="auto"``, the model's plain path, it follows
    the reference's ``causal_attention`` op for op
    (:func:`reference_attention`), rounding where it rounds: the scores
    come out of the activations' dtype product, and the probabilities are
    cast to it before P.V. In float32 the two paths agree to rounding; in
    bfloat16 only this one follows the reference's rounding order."""
    if backend == "auto" and not q.is_cuda:
        return reference_attention(q, k, v)
    return ops.flash_attention(q, k, v, backend=backend)


def _sdpa(q, k, v, mask, scale):
    """The reference's plain attention (``layers._sdpa``), k and v already
    repeated to H heads; mask: (Sq, Sk) bool."""
    scores = torch.einsum("bqhk,bshk->bhqs", q, k).float() * scale
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshk->bqhk", probs, v)


def reference_attention(q, k, v):
    """The reference's ``causal_attention``: ``_sdpa`` while S fits one
    block, else an online softmax over blocks of :data:`BLOCK_Q` queries
    and :data:`BLOCK_KV` keys (every key block, masked ones included), with
    the scores of each block from the activations' dtype product and its
    unnormalised probabilities rounded to that dtype before P.V. A last
    block may be short (the reference's blocks divide S)."""
    B, S, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    k = _repeat_kv(k, H)
    v = _repeat_kv(v, H)
    if S <= max(BLOCK_Q, BLOCK_KV):
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        return _sdpa(q, k, v, mask, scale)
    pos = torch.arange(S, device=q.device)
    out = []
    for q0 in range(0, S, BLOCK_Q):
        qi, qp = q[:, q0:q0 + BLOCK_Q], pos[q0:q0 + BLOCK_Q]
        acc = torch.zeros((B, H, qi.shape[1], hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, H, qi.shape[1]), -1e30, device=q.device)
        l = torch.zeros_like(m)
        for k0 in range(0, S, BLOCK_KV):
            s = torch.einsum("bqhk,bshk->bhqs", qi,
                             k[:, k0:k0 + BLOCK_KV]).float() * scale
            s = torch.where(qp[:, None] >= pos[None, k0:k0 + BLOCK_KV], s,
                            -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqs,bshk->bhqk", p.to(qi.dtype),
                v[:, k0:k0 + BLOCK_KV]).float()
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        out.append(o.movedim(1, 2).to(q.dtype))
    return torch.cat(out, dim=1)


def decode_attention(q, cache_k, cache_v, cur_len):
    """One-token decode vs a KV cache.

    q: (B, 1, H, hd); cache_k/v: (B, Smax, KV, hd); cur_len: () or (B,)
    int32 — number of valid cache positions per sequence (the new token's
    K/V must already be written at cur_len - 1).
    """
    B, _, H, hd = q.shape
    S = cache_k.shape[1]
    k = _repeat_kv(cache_k, H)
    v = _repeat_kv(cache_v, H)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqhk,bshk->bhqs", q, k).float() * scale
    lens = cur_len.reshape(-1, 1, 1, 1)
    valid = torch.arange(S, device=q.device)[None, None, None, :] < lens
    s = torch.where(valid, s, -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshk->bqhk", p, v)


# ---------------------------------------------------------------------------
# full attention layer (prefill / decode)
# ---------------------------------------------------------------------------


def _check_window(cfg) -> None:
    if cfg.attn_window:
        raise NotImplementedError(
            "local (sliding-window) attention is not ported yet "
            "(ROADMAP.md: hybrid family with local_attention)")


def attention_apply(p, x, cfg, *, positions, backend: str = "auto"):
    """Prefill attention over full sequences."""
    _check_window(cfg)
    q, k, v = _project_qkv(p, x, positions, cfg.rope_theta)
    ctx = causal_attention(q, k, v, backend=backend)
    return torch.einsum("bshk,hkd->bsd", ctx, p.wo.to(x.dtype))


def _onehot_cache_write(cache, new, write_at):
    """Write ``new`` (B,1,KV,hd) at seq position ``write_at`` with a one-hot
    select, the reference's form: ``write_at`` is a scalar or (B,) for
    per-slot positions (continuous batching), and a position past the
    cache writes nothing."""
    S = cache.shape[1]
    write_at = write_at.reshape(-1, 1, 1, 1)
    hot = torch.arange(S, device=cache.device).reshape(1, S, 1, 1) == write_at
    return torch.where(hot, new.to(cache.dtype), cache)


def attention_decode_apply(p, x, cfg, *, cache_k, cache_v, cur_len):
    """One-token decode; ``cur_len`` a scalar or (B,) int32 tensor, per slot
    (continuous batching). Returns (out, new_cache_k, new_cache_v)."""
    _check_window(cfg)
    B = x.shape[0]
    pos = (cur_len.expand(B, 1) if cur_len.dim() == 0
           else cur_len[:, None])
    q, k, v = _project_qkv(p, x, pos, cfg.rope_theta)
    S = cache_k.shape[1]
    cache_k = _onehot_cache_write(cache_k, k, cur_len)
    cache_v = _onehot_cache_write(cache_v, v, cur_len)
    n_valid = torch.clamp(cur_len + 1, max=S)
    ctx = decode_attention(q, cache_k.to(x.dtype), cache_v.to(x.dtype),
                           n_valid)
    out = torch.einsum("bshk,hkd->bsd", ctx, p.wo.to(x.dtype))
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


class MLPParams(nn.Module):
    """SwiGLU: wi, wu (d, d_ff), wd (d_ff, d)."""

    def __init__(self, d_model, d_ff, *, device=None):
        super().__init__()
        self.wi = empty((d_model, d_ff), device)
        self.wu = empty((d_model, d_ff), device)
        self.wd = empty((d_ff, d_model), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wi, self.wu, self.wd):
            dense_init_(w, generator)


def silu(x):
    """SiLU. On the card ``F.silu`` (one rounding to x's dtype). On the
    CPU, the model's plain path, the reference's rounding order:
    ``jax.nn.silu`` is ``x * sigmoid(x)``, and XLA computes a bfloat16
    sigmoid as ``1 / (1 + exp(-x))`` rounding after every op, so each op
    here runs in x's dtype (in bfloat16 the two orders round many elements
    differently; in float32 they agree to rounding)."""
    if x.is_cuda:
        return F.silu(x)
    return x * torch.reciprocal(1 + torch.exp(-x))


def mlp_apply(p, x):
    g = x @ p.wi.to(x.dtype)
    u = x @ p.wu.to(x.dtype)
    return (silu(g) * u) @ p.wd.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

VOCAB_PAD_MULTIPLE = 256


def padded_vocab(vocab_size: int) -> int:
    m = VOCAB_PAD_MULTIPLE
    return (vocab_size + m - 1) // m * m


class EmbeddingParams(nn.Module):
    """tok (padded vocab, d); untied, also out (d, padded vocab). The padded
    rows are initialised like the rest and take part in the unembedding,
    as in the reference."""

    def __init__(self, vocab_size, d_model, tie: bool, *, device=None):
        super().__init__()
        pv = padded_vocab(vocab_size)
        self.tok = empty((pv, d_model), device)
        if not tie:
            self.out = empty((d_model, pv), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        # 1/sqrt(d) keeps tied-unembedding logits O(1) at init
        dense_init_(self.tok, generator,
                    scale=1.0 / math.sqrt(self.tok.shape[1]))
        if hasattr(self, "out"):
            dense_init_(self.out, generator)


def embed_apply(p, tokens, dtype):
    # gather, then cast: the same values as casting the table first
    return F.embedding(tokens.long(), p.tok).to(dtype)


def unembed_apply(p, x):
    """Logits over the padded vocabulary."""
    if hasattr(p, "out"):
        return x @ p.out.to(x.dtype)
    return x @ p.tok.to(x.dtype).T
