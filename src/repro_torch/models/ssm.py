"""Mamba-2 (SSD, state-space duality) blocks, attention-free LM, ported from
``repro.models.ssm``.

Prefill runs the chunked SSD algorithm through the SSD-scan kernel
(``repro_torch.kernels.ops.ssd_scan``; on the CPU its plain version,
:func:`ssd_chunked`, which is the reference's ``ssd_chunked``); decode is
the constant-memory recurrent state update. Caches keep the reference's
stacked layout: ``conv`` (layers, batch, W-1, C) bfloat16 and ``ssm``
(layers, batch, H, P, N) float32.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_scan_ref
from repro_torch.kernels.ssd_scan import segsum, ssd_chunked  # noqa: F401
from repro_torch.models import layers as L


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
    (di, d) and the input norm ln (d,)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
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
        self.ln.fill_(1.0)


class MambaLM(nn.Module):
    """embed, blocks[num_layers], final_norm: the reference's param tree."""

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
    in x's dtype, as the reference sums them."""
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
    """Full-sequence (prefill) Mamba-2 block."""
    h_in = L.rms_norm(x, p.ln, cfg.norm_eps)
    xin, z, Bc, Cc, dt = _ssm_pre(p, h_in, cfg)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p.conv_w.to(x.dtype),
                                   p.conv_b.to(x.dtype)))
    di, n = cfg.d_inner, cfg.ssm_state
    xin, Bc, Cc = conv_out.split([di, n, n], dim=-1)

    H, P_ = cfg.ssm_heads, cfg.ssm_head_dim
    B, S, _ = x.shape
    Xh = xin.reshape(B, S, H, P_)
    A = -torch.exp(p.A_log)                                 # (H,)
    Adt = (dt * A).float()                                  # (B,S,H), < 0
    Xdt = Xh * dt[..., None].to(Xh.dtype)
    Y = ops.ssd_scan(Xdt, Adt, Bc, Cc, chunk=min(cfg.ssm_chunk, S),
                     backend=backend)
    Y = Y + Xh * p.D.to(Xh.dtype)[None, None, :, None]
    y = Y.reshape(B, S, di)
    y = L.rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    out = y @ p.w_out.to(x.dtype)
    return x + out.to(x.dtype)


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

    H, P_ = cfg.ssm_heads, cfg.ssm_head_dim
    B = x.shape[0]
    Xh = xin.reshape(B, H, P_)
    A = -torch.exp(p.A_log)
    dt1 = dt[:, 0, :]                                       # (B,H)
    decay = torch.exp((dt1 * A).float())                    # (B,H)
    upd = torch.einsum("bhp,bn->bhpn", Xh * dt1[..., None].to(Xh.dtype),
                       Bc[:, 0, :])
    ssm_state = ssm_state * decay[..., None, None].to(ssm_state.dtype) \
        + upd.to(ssm_state.dtype)
    Yh = torch.einsum("bhpn,bn->bhp", ssm_state.to(Xh.dtype), Cc[:, 0, :])
    Yh = Yh + Xh * p.D.to(Xh.dtype)[None, :, None]
    y = Yh.reshape(B, 1, di)
    y = L.rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    out = y @ p.w_out.to(x.dtype)
    return x + out.to(x.dtype), new_conv_state, ssm_state


# ---------------------------------------------------------------------------
# model API
# ---------------------------------------------------------------------------


def forward(model: MambaLM, cfg: ModelConfig, batch, *,
            backend: str = "auto"):
    """batch: {"tokens": (B,S) int}, S a multiple of min(ssm_chunk, S).
    Returns (logits over the padded vocabulary, {}). ``backend`` goes to
    the SSD kernel."""
    x = L.embed_apply(model.embed, batch["tokens"], getattr(torch, cfg.dtype))
    for blk in model.blocks:
        x = _ssm_block_apply(blk, x, cfg, backend)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
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
