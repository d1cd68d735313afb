"""Shared LM layers, ported from ``repro.models.layers``: RMS norm, RoPE,
GQA attention (prefill and training through the flash-attention kernel,
one-token decode against a KV cache), SwiGLU MLP, embeddings, and the
training loss (:func:`cross_entropy_loss`).

Parameters live in ``nn.Module``s whose attribute names and tensor shapes
are the reference's pytree keys and shapes, so ``repro_torch.convert``
carries them across by name. The apply functions are plain functions over
those modules, as the reference's are over its dicts, and cast each weight
to the activations' dtype where they use it. Parameters are float32
(``param_dtype``) when made, and none requires grad: serving (which
casts them to bfloat16) builds no autograd graph. Training makes them
trainable itself (``repro_torch.train.trainer.Trainer`` calls
``model.requires_grad_(True)``).

Out of this port so far (``ROADMAP.md``): ``local_attention`` (sliding
window, the hybrid family) and cross attention (vlm).
``causal_attention`` runs the flash kernel on the card and, on the CPU,
the reference's own two regimes (``_sdpa`` and online-softmax blocks) with
their roundings. ``constrain`` has no meaning on one card without a mesh
and is dropped; ``remat_wrap`` becomes ``torch.utils.checkpoint`` per
block in the families' ``forward``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.kernels.ref import (BLOCK_KV, BLOCK_Q,  # noqa: F401
                                     reference_attention)
from repro_torch.kernels.ref import repeat_kv as _repeat_kv

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


def remat_apply(cfg, fn, *args):
    """``fn(*args)``, one block; with ``cfg.remat`` and grad enabled its
    activations are not kept but recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant): the reference's
    ``remat_wrap`` at its default ``"full"`` policy (``"dots"`` is not
    ported)."""
    if cfg.remat and torch.is_grad_enabled():
        if cfg.remat_policy != "full":
            raise NotImplementedError(
                f"remat_policy {cfg.remat_policy!r} is not ported; 'full' is")
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


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


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------


def reference_route(x: torch.Tensor, backend: str) -> bool:
    """Whether a block runs the reference's own functions
    (:func:`reference_attention`, ``ssm.ssd_chunked``, autograd straight
    through them) rather than a kernel wrapper: for ``backend="auto"`` on
    the CPU."""
    return backend == "auto" and not x.is_cuda


def causal_attention(q, k, v, *, backend: str = "auto"):
    """Causal GQA attention. q: (B,S,H,hd); k, v: (B,S,KV,hd).

    On the card, and wherever ``backend`` names one, it runs the
    flash-attention kernel's wrapper (``ops.flash_attention``); when grad
    is enabled and an input requires it, the wrapper goes through its
    ``autograd.Function`` (the kernel forward, the gradient of
    :func:`reference_attention` recomputed in the backward). In
    bfloat16 the kernel rounds the unnormalised probabilities of each
    64-key tile to bfloat16 before P.V and keeps scores, row sums and the
    accumulator in float32; its plain version (``backend="torch"``, like
    the Pallas kernel) keeps the probabilities in float32 too.

    On the CPU with ``backend="auto"``, the model's plain path, it follows
    the reference's ``causal_attention`` op for op
    (:func:`reference_attention`, autograd straight through it), rounding
    where it rounds: the scores come out of the activations' dtype
    product, and the probabilities are cast to it before P.V. In float32 the two paths agree to rounding; in bfloat16
    only this one follows the reference's rounding order."""
    if reference_route(q, backend):
        return reference_attention(q, k, v)
    return ops.flash_attention(q, k, v, backend=backend)


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


def cross_entropy_loss(logits, labels, vocab_size):
    """Mean NLL over tokens, in float32; the padded-vocabulary tail of the
    logits is masked to -1e30 first (the reference's, ``layers.py:481``)."""
    pv = logits.shape[-1]
    logits = logits.float()
    if pv != vocab_size:
        pad_mask = torch.arange(pv, device=logits.device) < vocab_size
        logits = torch.where(pad_mask, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)
