"""Mamba-2 (SSD, state-space duality) blocks, attention-free LM, ported from
``repro.models.ssm``.

Prefill and training run the chunked SSD algorithm through the SSD-scan
kernel (``repro_torch.kernels.ops.ssd_scan``, differentiable through its
``autograd.Function``); on the CPU through :func:`ssd_chunked` itself,
the reference's ``ssd_chunked``, with autograd straight through it. With
``cfg.remat`` each block is recomputed in the backward
(``torch.utils.checkpoint``, the reference's ``remat_wrap``), so a train
step runs the kernel twice per block. Decode is the constant-memory
recurrent state update. Caches keep the reference's stacked layout:
``conv`` (layers, batch, W-1, C) bfloat16 and ``ssm`` (layers, batch, H,
P, N) float32.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (WHOLE, constrain, is_dtensor,
                                               merge_heads, shard_local,
                                               split_heads)
from repro_torch.kernels import _build, ops
from repro_torch.kernels.ref import ssd_scan_ref
from repro_torch.kernels.ssd_scan import segsum, ssd_chunked  # noqa: F401
from repro_torch.models import layers as L

# the batch dim of each cache tensor (Engine resets a slot along it)
CACHE_BATCH_DIMS = {"conv": 1, "ssm": 1}


def ssd_reference(X, A, Bc, Cc, init_state=None):
    """Sequential recurrence oracle (Y, final state in X's dtype)."""
    Y, final = ssd_scan_ref(X, A, Bc, Cc, init_state)
    return Y, final.to(X.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 block
# ---------------------------------------------------------------------------


class SSMBlock(nn.Module):
    """The reference's block tree: projections w_x, w_z (d, di), w_B, w_C
    (d, N), w_dt (d, H) and its bias b_dt (H,), the depthwise conv conv_w
    (W, di + 2N) and conv_b, A_log and D (H,), the gated norm (di,), w_out
    (di, d) and the input norm ln (d,). With ``norm=False`` the mixer
    alone, without ``ln``, for a layer that norms its own input
    (``models.hybrid_moe``)."""

    AXES = {"w_x": ("embed", "ssm_inner"), "w_z": ("embed", "ssm_inner"),
            "w_B": ("embed", "ssm_state"), "w_C": ("embed", "ssm_state"),
            "w_dt": ("embed", "ssm_heads"), "b_dt": ("ssm_heads",),
            "conv_w": ("conv_width", "ssm_inner"), "conv_b": ("ssm_inner",),
            "A_log": ("ssm_heads",), "D": ("ssm_heads",),
            "norm": ("ssm_inner",), "w_out": ("ssm_inner", "embed"),
            "ln": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device=None, norm: bool = True):
        super().__init__()
        d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        conv_ch = di + 2 * n
        self.w_x = L.empty((d, di), device)
        self.w_z = L.empty((d, di), device)
        self.w_B = L.empty((d, n), device)
        self.w_C = L.empty((d, n), device)
        self.w_dt = L.empty((d, h), device)
        self.b_dt = L.empty((h,), device)
        self.conv_w = L.empty((cfg.ssm_conv_width, conv_ch), device)
        self.conv_b = L.empty((conv_ch,), device)
        self.A_log = L.empty((h,), device)
        self.D = L.empty((h,), device)
        self.norm = L.empty((di,), device)
        self.w_out = L.empty((di, d), device)
        if norm:
            self.ln = L.empty((d,), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.w_x, self.w_z, self.w_B, self.w_C, self.w_dt):
            L.dense_init_(w, generator)
        # dt = softplus(b_dt) log-uniform in [1e-3, 1e-1]
        self.b_dt.uniform_(math.log(1e-3), math.log(1e-1),
                           generator=generator)
        self.b_dt.copy_(torch.log(torch.expm1(torch.exp(self.b_dt))))
        L.dense_init_(self.conv_w, generator, scale=1.0)
        self.conv_b.zero_()
        self.A_log.copy_(torch.log(torch.arange(
            1, self.A_log.shape[0] + 1, dtype=torch.float32)))
        self.D.fill_(1.0)
        self.norm.fill_(1.0)
        L.dense_init_(self.w_out, generator)
        if hasattr(self, "ln"):
            self.ln.fill_(1.0)


class MambaLM(nn.Module):
    """embed, blocks[num_layers], final_norm: the reference's param tree."""

    AXES = {"final_norm": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.embed = L.EmbeddingParams(cfg.vocab_size, cfg.d_model,
                                       cfg.tie_embeddings, device=device)
        self.blocks = nn.ModuleList(SSMBlock(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = L.empty((cfg.d_model,), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embed.reset_parameters(generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        self.final_norm.fill_(1.0)


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (B,S,C); w: (W,C). Taps summed in order
    in x's dtype, as the reference sums them. Under a mesh each rank
    convolves its own batch rows, all channels (the taps run along the
    sequence, which no rule shards)."""
    if is_dtensor(x):
        return shard_local(lambda xl, wl, bl, heads: _causal_conv(xl, wl, bl),
                           (x, w, b), (None, WHOLE, WHOLE))
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(W))
    return out + b[None, None, :]


def _ssm_pre(p, x, cfg):
    """Shared projections. x: (B,S,D) -> (xs, z, Bc, Cc, dt)."""
    dtype = x.dtype
    xin = x @ p.w_x.to(dtype)
    z = x @ p.w_z.to(dtype)
    Bc = x @ p.w_B.to(dtype)
    Cc = x @ p.w_C.to(dtype)
    dt_raw = x @ p.w_dt.to(dtype)
    dt = F.softplus(dt_raw.float() + p.b_dt)
    return xin, z, Bc, Cc, dt


def _ssm_block_apply(p, x, cfg: ModelConfig, backend: str):
    """Full-sequence (prefill) Mamba-2 block: the input norm, the mixer,
    the residual add."""
    h_in = L.rms_norm(x, p.ln, cfg.norm_eps, backend=backend)
    return x + ssm_mixer(p, h_in, cfg, backend).to(x.dtype)


def ssm_mixer(p, h_in, cfg: ModelConfig, backend: str):
    """The Mamba-2 mixer over full sequences on the normed input h_in
    (B, S, D): projections, causal conv, SSD scan, gated norm and the
    output projection, in h_in's dtype."""
    xin, z, Bc, Cc, dt = _ssm_pre(p, h_in, cfg)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p.conv_w.to(h_in.dtype),
                                   p.conv_b.to(h_in.dtype)))
    di, n = cfg.d_inner, cfg.ssm_state
    xin, Bc, Cc = conv_out.split([di, n, n], dim=-1)
    xin = constrain(xin, "batch", "seq", "ssm_inner")

    H, P_ = cfg.ssm_heads, cfg.ssm_head_dim
    S = h_in.shape[1]
    Xh = split_heads(xin, H, P_)
    A = -torch.exp(p.A_log)                                 # (H,)
    Adt = (dt * A).float()                                  # (B,S,H), < 0
    Xdt = Xh * dt[..., None].to(Xh.dtype)
    Y = ssd_y(Xdt, Adt, Bc, Cc, min(cfg.ssm_chunk, S), backend)
    Y = Y + Xh * p.D.to(Xh.dtype)[None, None, :, None]
    y = merge_heads(Y)
    y = L.rms_norm(y, p.norm, cfg.norm_eps, gate=z, backend=backend)
    out = y @ p.w_out.to(h_in.dtype)
    return constrain(out, "batch", "seq", None)


def ssd_y(X, A, Bc, Cc, chunk: int, backend: str):
    """The chunked SSD scan's Y: the kernel's wrapper
    (``ops.ssd_scan``), or on the CPU with ``backend="auto"`` the
    reference's :func:`ssd_chunked`. Under a mesh each rank scans its own
    batch rows and SSD heads (independent per head), B and C whole."""
    if is_dtensor(X):
        return shard_local(
            lambda x, a, b, c, heads: ssd_y(x, a, b, c, chunk, backend),
            (X, A, Bc, Cc), (2, 2, None, None))
    if _build.route(X, backend) == "reference":
        return ssd_chunked(X, A, Bc, Cc, chunk)[0]
    return ops.ssd_scan(X, A, Bc, Cc, chunk=chunk, backend=backend)


def _ssd_decode(Xh, dt1, state, b, c, A, D):
    """One token of the SSD recurrence: Xh (B,H,P), dt1 (B,H), state
    (B,H,P,N), b and c (B,N), A and D (H,). Returns (Y (B,H,P), new
    state)."""
    decay = torch.exp((dt1 * A).float())                    # (B,H)
    upd = torch.einsum("bhp,bn->bhpn", Xh * dt1[..., None].to(Xh.dtype), b)
    state = state * decay[..., None, None].to(state.dtype) \
        + upd.to(state.dtype)
    Yh = torch.einsum("bhpn,bn->bhp", state.to(Xh.dtype), c)
    return Yh + Xh * D.to(Xh.dtype)[None, :, None], state


def _ssm_block_decode(p, x, cfg, conv_state, ssm_state):
    """Single-token decode. conv_state: (B, W-1, C); ssm_state: (B,H,P,N).
    The window's taps are summed in order in float32 and rounded once, as
    the reference's dot does."""
    h_in = L.rms_norm(x, p.ln, cfg.norm_eps)
    xin, z, Bc, Cc, dt = _ssm_pre(p, h_in, cfg)
    di, n = cfg.d_inner, cfg.ssm_state
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)              # (B,1,C)
    window = torch.cat([conv_state, conv_in], dim=1)        # (B,W,C)
    w = p.conv_w.to(x.dtype)
    taps = window[:, 0].float() * w[0].float()
    for i in range(1, w.shape[0]):
        taps = taps + window[:, i].float() * w[i].float()
    conv_out = F.silu(taps.to(torch.promote_types(window.dtype, w.dtype))
                      [:, None, :] + p.conv_b.to(x.dtype)[None, None, :])
    new_conv_state = window[:, 1:, :]
    xin, Bc, Cc = conv_out.split([di, n, n], dim=-1)
    # the SSD heads over model, as the state's: no rank gathers the state
    xin = constrain(xin, "batch", None, "ssm_inner")

    H, P_ = cfg.ssm_heads, cfg.ssm_head_dim
    Xh = split_heads(xin, H, P_)[:, 0]                      # (B,H,P)
    A = -torch.exp(p.A_log)
    args = (Xh, dt[:, 0, :], ssm_state, Bc[:, 0, :], Cc[:, 0, :], A, p.D)
    if is_dtensor(Xh):   # per rank: its batch rows and SSD heads
        Yh, ssm_state = shard_local(
            lambda *a, heads: _ssd_decode(*a[:5], *(
                t[heads[0]:heads[0] + heads[1]] for t in a[5:])),
            args, (1, 1, 1, None, None, WHOLE, WHOLE))
    else:
        Yh, ssm_state = _ssd_decode(*args)
    y = merge_heads(Yh)[:, None, :]
    y = L.rms_norm(y, p.norm, cfg.norm_eps, gate=z)
    out = y @ p.w_out.to(x.dtype)
    return x + out.to(x.dtype), new_conv_state, ssm_state


# ---------------------------------------------------------------------------
# model API
# ---------------------------------------------------------------------------


def forward(model: MambaLM, cfg: ModelConfig, batch, *,
            backend: str = "auto"):
    """batch: {"tokens": (B,S) int}, S a multiple of min(ssm_chunk, S).
    Returns (logits over the padded vocabulary, {}). ``backend`` goes to
    the SSD and norm kernels."""
    x = L.embed_apply(model.embed, batch["tokens"], getattr(torch, cfg.dtype))
    for blk in model.blocks:
        x = L.remat_apply(cfg, _ssm_block_apply, blk, x, cfg, backend)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps, backend=backend)
    return L.unembed_apply(model.embed, x), {}


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               device) -> Dict[str, torch.Tensor]:
    del max_len  # constant-size state — the point of the SSM family
    Lr = cfg.num_layers
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((Lr, batch_size, cfg.ssm_conv_width - 1,
                             conv_ch), dtype=torch.bfloat16, device=device),
        "ssm": torch.zeros((Lr, batch_size, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state), dtype=torch.float32,
                           device=device),
    }


def cache_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The logical axes of :func:`init_cache`'s tensors, the reference's."""
    return {"conv": ("layers", "batch", None, "ssm_inner"),
            "ssm": ("layers", "batch", "ssm_heads", None, None)}


def decode_step(model: MambaLM, cfg: ModelConfig, cache, tokens, cur_len):
    del cur_len  # state carries all history
    x = L.embed_apply(model.embed, tokens, getattr(torch, cfg.dtype))
    convs, ssms = [], []
    for i, blk in enumerate(model.blocks):
        x, conv_s, ssm_s = _ssm_block_decode(blk, x, cfg, cache["conv"][i],
                                             cache["ssm"][i])
        convs.append(conv_s)
        ssms.append(ssm_s)
    cache = dict(cache, conv=torch.stack(convs), ssm=torch.stack(ssms))
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return L.unembed_apply(model.embed, x), cache
