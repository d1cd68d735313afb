"""Shared LM layers, ported from ``repro.models.layers``: RMS norm, RoPE,
GQA attention (causal prefill and training through the flash-attention
kernel, sliding-window ``local_attention``, unmasked ``cross_attention``
to a context, one-token decode against a KV cache, rolling when the cache
is one window long), SwiGLU MLP, embeddings, and the training loss
(:func:`cross_entropy_loss`).

Parameters live in ``nn.Module``s whose attribute names and tensor shapes
are the reference's pytree keys and shapes, so ``repro_torch.convert``
carries them across by name. The apply functions are plain functions over
those modules, as the reference's are over its dicts, and cast each weight
to the activations' dtype where they use it. Parameters are float32
(``param_dtype``) when made, and none requires grad: serving (which
casts them to bfloat16) builds no autograd graph. Training makes them
trainable itself (``repro_torch.train.trainer.Trainer`` calls
``model.requires_grad_(True)``).

``causal_attention`` runs the flash kernel on the card and, on the CPU,
the reference's own two regimes (``_sdpa`` and online-softmax blocks) with
their roundings. ``local_attention`` and ``cross_attention`` are not
Pallas functions in the reference (and the hybrid's head dim 256 is
outside the flash kernel's): they are plain torch on both devices, with
``_sdpa``'s roundings. Which of them a layer runs follows its ``window``
alone. ``remat_wrap`` becomes ``torch.utils.checkpoint`` per block in
the families' ``forward``.

Under a mesh (``repro_torch.distributed``) the parameters and the batch
are ``DTensor``s, each module's ``AXES`` names its parameters' logical
dims (``models.model.param_axes``), and the reference's ``constrain``
calls stand at its sites: each redistributes a ``DTensor`` activation and
leaves a plain tensor as it is, so the one-device paths are unchanged.
The attention kernel runs on each rank's local shard of the batch and of
the query heads (:func:`causal_attention`), as the reference's
``shard_map`` regions run theirs.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import spans
from repro_torch.distributed.sharding import (WHOLE, all_reduce, constrain,
                                               is_dtensor, local, mesh_dim_of,
                                               shard_local, unshard)
from repro_torch.kernels import _build, ops
from repro_torch.kernels import rms_norm as _rms_norm
from repro_torch.kernels.ref import (BLOCK_KV, BLOCK_Q,  # noqa: F401
                                     _sdpa, reference_attention)
from repro_torch.kernels.ref import repeat_kv as _repeat_kv
from repro_torch.spans import span

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


def rms_norm(x, scale, eps: float = 1e-5, *, gate=None,
             backend: str = "auto"):
    """The RMS norm of x's last dimension times ``scale`` (float32), in x's
    dtype; with a ``gate``, the norm of ``x * silu(gate)``, the Mamba
    mixer's gated norm. For bfloat16 x on the card (``_build.route``
    answers ``"kernel"``; fake tensors too) whose last dimension is whole
    on each device, the hand-written kernel (``kernels/rms_norm.py``), on
    each rank's own rows under a mesh; else the eager chain in float32:
    float32 inputs (``add_norm``'s unrounded sum), the CPU,
    ``backend="torch"``, and a ``DTensor`` sharded on the normed dimension,
    whose mean DTensor reduces across ranks. While a profiler records, each
    call adds its rows (this rank's) to the counter ``norm/rows``."""
    if spans.enabled():
        rows = local(x)
        spans.count("norm/rows", rows.numel() // max(rows.shape[-1], 1))
    if x.dtype == torch.bfloat16 and _build.route(x, backend) == "kernel" \
            and mesh_dim_of(x, x.dim() - 1) is None:
        return _norm_kernel(x, scale, eps, gate, backend)
    return _rms_norm.rms_norm_plain(x, scale, eps, gate)[0]


def _norm_kernel(x, scale, eps, gate, backend):
    """The kernel's norm; under a mesh on each rank's rows, the scale whole
    on every rank (its gradient summed over the ranks that split the
    rows), the gate laid out as x."""
    if not is_dtensor(x):
        return _rms_norm.rms_norm(x, scale, eps, gate=gate, backend=backend)
    rows = 1 if x.dim() >= 3 else None     # (batch, seq, ...): seq may split
    args, dims = (x, scale), (rows, WHOLE)
    if gate is not None:
        args, dims = args + (gate,), dims + (rows,)

    def per_rank(xl, sl, *gl, heads):
        return _rms_norm.rms_norm(xl, sl, eps, gate=gl[0] if gl else None,
                                  backend=backend)
    return shard_local(per_rank, args, dims)


def add_norm(x, a, scale, eps):
    """``x + a`` for the residual stream, rounded to x's dtype, and the RMS
    norm of that sum taken from its float32 value: the reference's
    compiled model fuses a residual add into the next norm's float32 cast
    and keeps the sum's excess precision there (XLA's default), so in
    bfloat16 the norm sees the unrounded sum while the residual carries
    the rounded one. In float32 this is ``x + a`` and its norm."""
    s = x.float() + a.float()
    return s.to(x.dtype), rms_norm(s, scale, eps).to(x.dtype)


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

    AXES = {"wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "kv_heads", "kv_head_dim"),
            "wv": ("embed", "kv_heads", "kv_head_dim"),
            "wo": ("heads", "head_dim", "embed"),
            "bq": ("heads", "head_dim"),
            "bk": ("kv_heads", "kv_head_dim"),
            "bv": ("kv_heads", "kv_head_dim")}

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


def project_heads(x, w):
    """(B,S,D) x (D,heads,hd) -> (B,S,heads,hd), in x's dtype. Under a
    mesh, wk and wv shard their head_dim (``kv_head_dim``), and the
    einsum's view flattens (heads, hd), which DTensor before torch 2.13
    refuses with the inner dim sharded: so a sharded head_dim of the
    weight is gathered first (D x KV x hd, less than the k and v whose
    head_dim the reference gathers at its ``kv_heads`` constraints). A
    weight whose heads are whole (wk and wv: ``kv_heads`` is replicated)
    is gathered whole and applied to each rank's rows (``shard_local``):
    left to DTensor, the product may shard its (heads x hd) columns over
    ``model``, and 8 kv heads cannot be unflattened from 16 shards (the
    (16, 16) production mesh)."""
    if is_dtensor(x) and mesh_dim_of(w, 1) is None:
        return shard_local(lambda xl, wl, heads: torch.einsum(
            "bsd,dhk->bshk", xl, wl.to(xl.dtype)), (x, w), (None, WHOLE))
    return torch.einsum("bsd,dhk->bshk", x, unshard(w, 2).to(x.dtype))


def project_out(ctx, wo):
    """(B,S,H,hd) x (H,hd,D) -> (B,S,D), in ctx's dtype. Under a mesh, a
    ``ctx`` whose heads are whole is multiplied on each rank's rows by the
    whole ``wo`` (``shard_local``): left to DTensor, the backward
    unflattens the (heads x hd) columns of a product sharded over
    ``model``, which torch 2.11 refuses where the heads do not divide it
    (whisper-tiny's 6 heads over 16)."""
    def local(c, w, heads=None):
        return torch.einsum("bshk,hkd->bsd", c, w.to(c.dtype))
    if is_dtensor(ctx) and mesh_dim_of(ctx, 2) is None:
        return shard_local(local, (ctx, wo), (None, WHOLE))
    return local(ctx, wo)


def _project_qkv(p, x, positions, theta, *, decode=False):
    """q, k, v of x; rotated by RoPE at ``positions``, or not at all when
    ``positions`` is None (no positional embedding)."""
    q = project_heads(x, p.wq)
    k = project_heads(x, p.wk)
    v = project_heads(x, p.wv)
    if hasattr(p, "bq"):
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    if positions is not None:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    if decode:
        # one-token decode: the reference keeps the heads replicated (its
        # KV cache is seq-sharded over the model axis)
        q = constrain(q, "batch", None, None, None)
        k = constrain(k, "batch", None, None, None)
        v = constrain(v, "batch", None, None, None)
    else:
        q = constrain(q, "batch", "seq", "heads", None)
        k = constrain(k, "batch", "seq", "kv_heads", None)
        v = constrain(v, "batch", "seq", "kv_heads", None)
    return q, k, v


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------


def causal_attention(q, k, v, *, backend: str = "auto", scale=None):
    """Causal GQA attention. q: (B,S,H,hd); k, v: (B,S,KV,hd); the scores
    scaled by ``scale`` (1/sqrt(hd) when None).

    On the card, and for ``backend="torch"``, it runs the
    flash-attention kernel's wrapper (``ops.flash_attention``); when grad
    is enabled and an input requires it, the wrapper goes through its
    ``autograd.Function`` (the kernel forward, the gradient of
    :func:`reference_attention` taken a block of queries at a time from
    the recomputed scores in the backward). In
    bfloat16 the kernel rounds the unnormalised probabilities of each
    64-key tile to bfloat16 before P.V and keeps scores, row sums and the
    accumulator in float32; its plain version (``backend="torch"``, like
    the Pallas kernel) keeps the probabilities in float32 too.

    On the CPU with ``backend="auto"`` (``_build.route`` answers
    ``"reference"``), the model's plain path, it follows
    the reference's ``causal_attention`` op for op
    (:func:`reference_attention`, autograd straight through it), rounding
    where it rounds: the scores come out of the activations' dtype
    product, and the probabilities are cast to it before P.V. In float32 the two paths agree to rounding; in bfloat16
    only this one follows the reference's rounding order."""
    if is_dtensor(q):
        return _per_rank_heads(lambda *a: causal_attention(
            *a, backend=backend, scale=scale), q, k, v)
    if _build.route(q, backend) == "reference":
        return reference_attention(q, k, v, scale)
    return ops.flash_attention(q, k, v, backend=backend, scale=scale)


def _per_rank_heads(fn, q, k, v):
    """``fn(q, k, v)`` of ``DTensor``s run by each rank on its own batch
    rows and query heads, as the reference's ``shard_map`` regions run
    their kernels (and DTensor before torch 2.13 cannot run the plain
    versions' einsums with the batch and the heads both sharded). k and v
    come replicated over the heads' mesh axes, and the rank keeps the kv
    heads its query heads read (GQA by index: local head h reads kv head
    h // (H_local / KV_local) of what it is given)."""
    H, KV = q.shape[2], k.shape[2]
    return shard_local(
        lambda ql, kl, vl, heads: fn(ql, *_kv_of_heads(kl, vl, heads,
                                                       H // KV)),
        (q, k, v), (2, None, None))


def _kv_of_heads(k, v, heads, group: int):
    """The kv heads that query heads ``[h0, h0 + n)`` read, ``heads = (h0,
    n)``, out of all KV of ``k`` and ``v`` (B, S, KV, hd), ``group`` query
    heads to a kv head."""
    h0, n = heads
    if n == k.shape[2] * group:
        return k, v
    if n % group and group % n:
        raise ValueError(f"{n} local query heads cut kv groups of {group}")
    lo, cnt = h0 // group, max(n // group, 1)
    return k[:, :, lo:lo + cnt], v[:, :, lo:lo + cnt]


def local_attention(q, k, v, window: int):
    """Sliding-window causal attention (the reference's ``local_attention``):
    each query sees itself and the ``window - 1`` keys before it. Up to
    ``window`` positions this is the causal ``_sdpa``; above, S must be a
    multiple of ``window`` and each block of ``window`` queries attends to
    its own block and the one before (block 0 to its own alone). Plain
    torch on both devices, under the profiler range ``attention/local``;
    under a mesh, per rank (:func:`_per_rank_heads`)."""
    if is_dtensor(q):
        return _per_rank_heads(lambda *a: local_attention(*a, window),
                               q, k, v)
    B, S, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    with span("attention/local"):
        k = _repeat_kv(k, H)
        v = _repeat_kv(v, H)
        if S <= window:
            mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                         device=q.device))
            return _sdpa(q, k, v, mask, scale)
        if S % window:
            raise ValueError(f"local attention over {S} positions needs a "
                             f"multiple of the window {window}")
        i = torch.arange(window, device=q.device)[:, None]
        j = torch.arange(2 * window, device=q.device)[None, :]
        mask = ((j - window) <= i) & ((i + window - j) < window)  # (w, 2w)
        first_mask = mask & (j >= window)     # block 0: no previous block
        out = []
        for b0 in range(0, S, window):
            lo = max(b0 - window, 0)
            out.append(_sdpa(q[:, b0:b0 + window], k[:, lo:b0 + window],
                             v[:, lo:b0 + window],
                             mask if b0 else first_mask[:, window:], scale))
        return torch.cat(out, dim=1)


def cross_attention(q, k, v):
    """Full (unmasked) attention to a fixed context, e.g. encoder outputs:
    q (B,S,H,hd), k and v (B,Sc,KV,hd). The reference's ``_sdpa`` without
    a mask, with its roundings; under a mesh, per rank
    (:func:`_per_rank_heads`)."""
    if is_dtensor(q):
        return _per_rank_heads(cross_attention, q, k, v)
    H, hd = q.shape[2], q.shape[3]
    return _sdpa(q, _repeat_kv(k, H), _repeat_kv(v, H), None,
                 1.0 / math.sqrt(hd))


def decode_attention(q, cache_k, cache_v, cur_len):
    """One-token decode vs a (possibly seq-sharded) KV cache.

    q: (B, 1, H, hd); cache_k/v: (B, Smax, KV, hd); cur_len: () or (B,)
    int32 — number of valid cache positions per sequence (the new token's
    K/V must already be written at cur_len - 1).

    Where the cache is a ``DTensor`` whose sequence is sharded (the
    ``seq_shard`` axis of ``cache_axes``), each rank attends over its own
    slice of the cache and the scores stay sharded, as the reference's
    comment says its compiler lowers the softmax: the rank masks its
    positions by their global index, takes its local max and exp-sum and
    one all-reduce of each over the mesh dim that shards the sequence
    ((B, H, 1, 1) each), rounds the normalised probabilities to q's dtype
    where the reference does and contracts them with its value shard in
    that dtype, and the (B, 1, H, hd) partial outputs are summed in
    float32 over that mesh dim (:func:`_seq_sharded_decode`).
    Neither the cache nor the scores are gathered. The batch stays split
    over the data axes as it is.
    """
    md = mesh_dim_of(cache_k, 1)
    if md is not None:
        return _seq_sharded_decode(q, cache_k, cache_v, cur_len, md)
    return _decode_local(q, cache_k, cache_v, cur_len, 0, None)


def _decode_local(q, cache_k, cache_v, lens, start: int, group):
    """:func:`decode_attention` over the cache positions ``[start, start +
    cache_k.shape[1])``, plain tensors. Without ``group`` this is the
    reference's function op for op over the whole cache. With ``group``
    (mesh, mesh dim) the other positions lie on the other ranks of that
    mesh dim: the softmax's max and sum and the output are all-reduced
    over it, the partial outputs summed in float32 and returned so; each
    query head meets its kv head by a grouped product, so the rank's
    cache is read as it lies (not repeated H / KV times, nor cast)."""
    B, _, H, hd = q.shape
    S = cache_k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    pos = torch.arange(start, start + S, device=q.device)
    valid = pos[None, None, None, :] < lens.reshape(-1, 1, 1, 1)
    if group is None:
        k = _repeat_kv(cache_k, H)
        v = _repeat_kv(cache_v, H)
        s = torch.einsum("bqhk,bshk->bhqs", q, k).float() * scale
        s = constrain(s, "batch", None, None, "seq_shard")
        s = torch.where(valid, s, -1e30)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.einsum("bhqs,bshk->bqhk", p, v)
    KV = cache_k.shape[2]
    qg = q.reshape(B, 1, KV, H // KV, hd)     # head h reads kv head h // G
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, cache_k).float() * scale
    s = torch.where(valid, s.reshape(B, H, 1, S), -1e30)
    m = all_reduce(s.amax(dim=-1, keepdim=True), "max", *group)
    e = torch.exp(s - m)
    z = all_reduce(e.sum(dim=-1, keepdim=True), "sum", *group)
    p = (e / z).to(q.dtype).reshape(B, KV, H // KV, 1, S)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, cache_v)
    return all_reduce(out.reshape(B, 1, H, hd).float(), "sum", *group)


def _seq_sharded_decode(q, cache_k, cache_v, cur_len, md: int):
    """:func:`decode_attention` with the cache's sequence sharded over mesh
    dim ``md``: each rank on its own batch rows and cache positions
    (``sharding.shard_local`` with the sequence as the split dim), q
    whole over its heads on every rank of ``md``, the result whole over
    ``md`` in q's dtype."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh, S = cache_k.device_mesh, cache_k.shape[1]
    lens = cur_len
    if not is_dtensor(lens):
        lens = DTensor.from_local(lens, mesh, (Replicate(),) * mesh.ndim,
                                  run_check=False)

    def local(k, v, ql, ll, heads):
        start, n = heads
        if n == S:    # the shard_local gathered an uneven split
            return _decode_local(ql, k, v, ll, 0, None)
        return _decode_local(ql, k, v, ll, start, (mesh, md)).to(ql.dtype)

    return shard_local(local, (cache_k, cache_v, q, lens),
                       (1, 1, None, WHOLE if lens.dim() == 0 else None),
                       reduced=True)


# ---------------------------------------------------------------------------
# full attention layer (prefill / decode)
# ---------------------------------------------------------------------------


def attention_apply(p, x, cfg, *, positions, window: int = 0,
                    backend: str = "auto"):
    """Prefill attention over full sequences: with a ``window``, the plain
    :func:`local_attention`; without, :func:`causal_attention` (the flash
    kernel on the card; ``backend`` goes to it), the scores scaled by
    ``cfg.attn_scale`` where it is set. ``cfg.use_rope`` False leaves q
    and k unrotated."""
    q, k, v = _project_qkv(p, x, positions if cfg.use_rope else None,
                           cfg.rope_theta)
    if window:
        ctx = local_attention(q, k, v, window)
    else:
        ctx = causal_attention(q, k, v, backend=backend,
                               scale=cfg.attn_scale or None)
    ctx = constrain(ctx, "batch", "seq", "heads", None)
    out = project_out(ctx, p.wo)
    return constrain(out, "batch", "seq", None)


def _onehot_cache_write(cache, new, write_at):
    """Write ``new`` (B,1,KV,hd) at seq position ``write_at`` with a one-hot
    select, the reference's form: ``write_at`` is a scalar or (B,) for
    per-slot positions (continuous batching), and a position past the
    cache writes nothing."""
    S = cache.shape[1]
    write_at = write_at.reshape(-1, 1, 1, 1)
    hot = torch.arange(S, device=cache.device).reshape(1, S, 1, 1) == write_at
    return torch.where(hot, new.to(cache.dtype), cache)


def attention_decode_apply(p, x, cfg, *, cache_k, cache_v, cur_len,
                           window: int = 0):
    """One-token decode; ``cur_len`` a scalar or (B,) int32 tensor, per slot
    (continuous batching). With a ``window`` and a cache exactly one window
    long, the cache is a rolling buffer: the new K/V go to ``cur_len %
    window``, and once it is full every entry is valid (each key carries
    its own RoPE position). Returns (out, new_cache_k, new_cache_v)."""
    B = x.shape[0]
    pos = (cur_len.expand(B, 1) if cur_len.dim() == 0
           else cur_len[:, None])
    q, k, v = _project_qkv(p, x, pos, cfg.rope_theta, decode=True)
    S = cache_k.shape[1]
    write_at = torch.remainder(cur_len, window) if window and S == window \
        else cur_len
    cache_k = _onehot_cache_write(cache_k, k, write_at)
    cache_v = _onehot_cache_write(cache_v, v, write_at)
    n_valid = torch.clamp(cur_len + 1, max=S)
    ctx = decode_attention(q, cache_k.to(x.dtype), cache_v.to(x.dtype),
                           n_valid)
    out = project_out(ctx, p.wo)
    return out, cache_k, cache_v


def cross_attention_apply(p, x, context):
    """x: (B,S,D) queries; context: (B,Sc,D), the keys' and values' source.
    No RoPE and no bias (the reference's ``cross_attention_init`` is
    ``attention_init`` without ``qkv_bias``)."""
    q = project_heads(x, p.wq)
    k = project_heads(context, p.wk)
    v = project_heads(context, p.wv)
    q = constrain(q, "batch", "seq", "heads", None)
    ctx = cross_attention(q, k, v)
    out = project_out(ctx, p.wo)
    return constrain(out, "batch", "seq", None)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


class MLPParams(nn.Module):
    """SwiGLU: wi, wu (d, d_ff), wd (d_ff, d)."""

    AXES = {"wi": ("embed", "mlp"), "wu": ("embed", "mlp"),
            "wd": ("mlp", "embed")}

    def __init__(self, d_model, d_ff, *, device=None):
        super().__init__()
        self.wi = empty((d_model, d_ff), device)
        self.wu = empty((d_model, d_ff), device)
        self.wd = empty((d_ff, d_model), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wi, self.wu, self.wd):
            dense_init_(w, generator)


class _ReferenceSilu(torch.autograd.Function):
    """``x * s`` with ``s = 1 / (1 + exp(-x))``, each op in x's dtype; the
    backward is the reference's derivative in its rounding order (the
    logistic's ``s * (1 - s)``, then ``g * s + (g * x) * that``), not
    autograd's through the reciprocal, which rounds a bfloat16 gradient
    differently in most elements."""

    @staticmethod
    def forward(ctx, x):
        s = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (g * x) * (s * (1 - s))


def silu(x):
    """SiLU. On the card ``F.silu`` (one rounding to x's dtype), and for
    fake tensors (``_build.on_card``). On the CPU, the model's plain path,
    the reference's rounding order (:class:`_ReferenceSilu`):
    ``jax.nn.silu`` is ``x * sigmoid(x)``, and XLA computes a bfloat16
    sigmoid as ``1 / (1 + exp(-x))`` rounding after every op, so each op
    here runs in x's dtype (in bfloat16 the two orders round many elements
    differently; in float32 they agree to rounding), and so does the
    gradient."""
    if _build.on_card(x):
        return F.silu(x)
    return _ReferenceSilu.apply(x)


def gelu_tanh(x):
    """GELU, tanh approximation (``jax.nn.gelu``'s default). On the card
    ``F.gelu(x, approximate="tanh")`` (one rounding to x's dtype), and for
    fake tensors (``_build.on_card``). On the
    CPU, the model's plain path, the reference's own formula and rounding
    order: ``jax.nn.gelu`` computes ``x * (0.5 * (1 + tanh(sqrt(2/pi) * (x
    + 0.044715 * x**3))))`` in x's dtype, its two constants rounded to it
    (0.796875 and 0.0446777 in bfloat16) and every op rounded."""
    if _build.on_card(x):
        return F.gelu(x, approximate="tanh")
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
    c3 = torch.tensor(0.044715, dtype=x.dtype)
    inner = c * (x + c3 * (x * x * x))
    return x * (0.5 * (1 + torch.tanh(inner)))


def mlp_apply(p, x):
    g = x @ p.wi.to(x.dtype)
    u = x @ p.wu.to(x.dtype)
    h = constrain(silu(g) * u, "batch", "seq", "mlp")
    return constrain(h @ p.wd.to(x.dtype), "batch", "seq", None)


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

    AXES = {"tok": ("vocab", None), "out": ("embed", "vocab")}

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
    if mesh_dim_of(p.tok, 0) is not None:
        x = _embed_vocab_parallel(p.tok, tokens)
    else:
        x = F.embedding(tokens.long(), p.tok)
    return constrain(x.to(dtype), "batch", "seq", None)


def unembed_apply(p, x):
    """Logits over the padded vocabulary."""
    if hasattr(p, "out"):
        logits = x @ p.out.to(x.dtype)
    else:
        logits = x @ p.tok.to(x.dtype).T
    return constrain(logits, "batch", "seq", "vocab")


def cross_entropy_loss(logits, labels, vocab_size):
    """Mean NLL over tokens, in float32; the padded-vocabulary tail of the
    logits is masked to -1e30 first (the reference's, ``layers.py:481``).
    With the vocab sharded over a mesh axis each rank keeps its columns
    (:func:`_nll_vocab_parallel`)."""
    if mesh_dim_of(logits, 2) is not None:
        return torch.mean(_nll_vocab_parallel(logits, labels, vocab_size))
    pv = logits.shape[-1]
    logits = constrain(logits, "batch", None, None).float()
    if pv != vocab_size:
        pad_mask = torch.arange(pv, device=logits.device) < vocab_size
        logits = torch.where(pad_mask, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


# ---------------------------------------------------------------------------
# the vocab-sharded embedding and loss under a mesh
# ---------------------------------------------------------------------------
#
# DTensor has no rule for a gather along a sharded dim (the embedding
# lookup, the loss's gold logit). Each rank instead works on its own rows
# (columns) of the vocab and one all-reduce over the vocab's mesh axis
# combines them, as the reference's compiled lookup and loss do: neither
# the table nor the logits come whole to a rank.


class _VocabEmbed(torch.autograd.Function):
    """Lookup of ``ids`` in this rank's rows ``[v0, v0 + rows)`` of the
    table, zero for the other ids, summed over ``group``. The backward
    adds each token's gradient to its row, on the rank that holds it."""

    @staticmethod
    def forward(ctx, rows, ids, v0, group):
        local = ids.long() - v0
        hit = (local >= 0) & (local < rows.shape[0])
        idx = torch.where(hit, local, 0)
        out = torch.where(hit[..., None], F.embedding(idx, rows), 0.0)
        dist.all_reduce(out, group=group)
        ctx.save_for_backward(idx, hit)
        ctx.rows = rows.shape
        return out

    @staticmethod
    def backward(ctx, g):
        idx, hit = ctx.saved_tensors
        grad = g.new_zeros(ctx.rows)
        grad.index_add_(0, idx.reshape(-1), torch.where(
            hit[..., None], g, 0.0).reshape(-1, g.shape[-1]))
        return grad, None, None, None


class _VocabNLL(torch.autograd.Function):
    """Per-token NLL from this rank's columns ``[v0, v0 + cols)`` of the
    logits (float32; columns at or past ``vocab_size`` masked to -1e30):
    the row max, the sum of exponentials and the gold logit are each one
    all-reduce over ``group``. The backward is ``softmax - onehot`` on the
    rank's own columns, with no collective."""

    @staticmethod
    def forward(ctx, logits, labels, v0, vocab_size, group):
        x = logits.float()
        cols = torch.arange(v0, v0 + x.shape[-1], device=x.device)
        x = torch.where(cols < vocab_size, x, -1e30)
        m = x.amax(-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(x - m[..., None])
        total = e.sum(-1)
        dist.all_reduce(total, group=group)
        local = labels.long() - v0
        hit = (local >= 0) & (local < x.shape[-1])
        idx = torch.where(hit, local, 0)[..., None]
        gold = torch.where(hit, torch.gather(x, -1, idx)[..., 0], 0.0)
        dist.all_reduce(gold, group=group)
        ctx.save_for_backward(e, total, idx, hit)
        ctx.dtype = logits.dtype
        return m + torch.log(total) - gold

    @staticmethod
    def backward(ctx, g):
        e, total, idx, hit = ctx.saved_tensors
        grad = e * (g / total)[..., None]
        grad.scatter_add_(-1, idx, -torch.where(hit, g, 0.0)[..., None])
        return grad.to(ctx.dtype), None, None, None, None


def _vocab_layout(x, dim: int, rows_of):
    """The mesh dim ``vd`` that shards ``x``'s vocab ``dim``, and the
    placements that keep it there and shard nothing else of ``x`` but the
    batch rows of the ``DTensor`` ``rows_of`` (None: no batch dim)."""
    from torch.distributed.tensor import Replicate, Shard
    vd = mesh_dim_of(x, dim)
    pl = []
    for md in range(x.device_mesh.ndim):
        if md == vd:
            pl.append(Shard(dim))
        elif rows_of is not None and rows_of.placements[md].is_shard(0):
            pl.append(Shard(0))
        else:
            pl.append(Replicate())
    return vd, tuple(pl)


def _rows(t, vd):
    """The batch-first ``DTensor`` ``t`` as this rank's local rows, whole
    over mesh dim ``vd``, and the placements of a batch-first result with
    those rows."""
    from torch.distributed.tensor import Replicate
    t = unshard(t, 1)
    if not t.placements[vd].is_replicate():
        t = t.redistribute(t.device_mesh, tuple(
            Replicate() if md == vd else p
            for md, p in enumerate(t.placements)))
    return t.to_local(), tuple(t.placements)


def _embed_vocab_parallel(table, tokens):
    """The lookup of :func:`embed_apply` with the table's rows sharded
    over a mesh axis: masked local lookups, one all-reduce."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = table.device_mesh
    vd, pl = _vocab_layout(table, 0, None)
    if tuple(table.placements) != pl:
        table = table.redistribute(mesh, pl)
    ids, out_pl = _rows(tokens, vd)
    # each rank's rows take the gradients of its own batch rows: summed
    # over the mesh dims that shard the batch
    grad_pl = tuple(p if md == vd else (
        Partial() if out_pl[md].is_shard() else Replicate())
        for md, p in enumerate(pl))
    rows = table.to_local(grad_placements=grad_pl)
    v0 = mesh.get_local_rank(vd) * rows.shape[0]
    out = _VocabEmbed.apply(rows, ids, v0, mesh.get_group(vd))
    return DTensor.from_local(out, mesh, out_pl, run_check=False)


def _nll_vocab_parallel(logits, labels, vocab_size):
    """Per-token NLL of :func:`cross_entropy_loss` with the logits' vocab
    sharded over a mesh axis, laid out as ``labels``."""
    from torch.distributed.tensor import DTensor
    mesh = logits.device_mesh
    vd, pl = _vocab_layout(logits, 2, labels)
    if tuple(logits.placements) != pl:
        logits = logits.redistribute(mesh, pl)
    lab, out_pl = _rows(labels, vd)
    local = logits.to_local(grad_placements=pl)
    v0 = mesh.get_local_rank(vd) * local.shape[-1]
    nll = _VocabNLL.apply(local, lab, v0, vocab_size, mesh.get_group(vd))
    return DTensor.from_local(nll, mesh, out_pl, run_check=False)
