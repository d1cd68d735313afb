"""RecurrentGemma-style hybrid (the ``hybrid`` family): RG-LRU recurrent
blocks and local sliding-window attention in a repeating (rglru, rglru,
attn) pattern, each followed by an MLP; ported from
``repro.models.rglru``.

The RG-LRU is a gated diagonal linear recurrence

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(lam) * r_t),

run over the sequence in float32 by :func:`_rglru_scan`, a log-depth
doubling scan (ceil(log2 S) steps of whole-tensor ops, 11 at S = 2048), the
counterpart of the reference's ``jax.lax.associative_scan``; it sums in
another order, so the two agree to float32 rounding, not bit for bit.
Nothing here is a Pallas function in the reference: the scan, the gates and
``layers.local_attention`` (head dim 256, outside the flash kernel's) are
plain torch on both devices, under the profiler ranges ``rglru/scan`` and
``attention/local``.

Layers: ``num_layers // 3`` groups (``groups``: r1, m1, r2, m2, attn, m3)
and, when ``num_layers % 3 == 2``, trailing rglru layers (``extra``: r,
m). Decode keeps a rolling KV cache of ``min(attn_window, max_len)``
positions per attention layer (``k``, ``v``: (groups, batch, window, KV,
hd) bfloat16), each recurrent layer's last 3 conv inputs (``conv``:
(rec, batch, 3, W) bfloat16) and its state (``rec``: (rec, batch, W)
float32), rec = 2 * groups + extra.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models.ssm import _causal_conv
from repro_torch.spans import span

_C = 8.0  # RG-LRU sharpness constant (paper value)

# the batch dim of each cache tensor (Engine resets a slot along it)
CACHE_BATCH_DIMS = {"k": 1, "v": 1, "conv": 1, "rec": 1}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


class RGLRUBlock(nn.Module):
    """w_x, w_y (d, W); the causal conv conv_w (4, W), conv_b (W,); the
    gates' w_r, b_r, w_i, b_i (W,); lam (W,); w_out (W, d); ln (d,)."""

    AXES = {"w_x": ("embed", "rglru_width"), "w_y": ("embed", "rglru_width"),
            "conv_w": ("conv_width", "rglru_width"),
            **{n: ("rglru_width",)
               for n in ("conv_b", "w_r", "b_r", "w_i", "b_i", "lam")},
            "w_out": ("rglru_width", "embed"), "ln": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d, w = cfg.d_model, cfg.rglru_width or cfg.d_model
        self.w_x = L.empty((d, w), device)
        self.w_y = L.empty((d, w), device)
        self.conv_w = L.empty((4, w), device)
        for name in ("conv_b", "w_r", "b_r", "w_i", "b_i", "lam"):
            setattr(self, name, L.empty((w,), device))
        self.w_out = L.empty((w, d), device)
        self.ln = L.empty((d,), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        L.dense_init_(self.w_x, generator)
        L.dense_init_(self.w_y, generator)
        L.dense_init_(self.conv_w, generator, scale=1.0)
        for b in (self.conv_b, self.w_r, self.b_r, self.w_i, self.b_i):
            b.zero_()
        self.lam.fill_(2.0)
        L.dense_init_(self.w_out, generator)
        self.ln.fill_(1.0)


class MLPSub(nn.Module):
    """mlp and its input norm ln."""

    AXES = {"ln": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.mlp = L.MLPParams(cfg.d_model, cfg.d_ff, device=device)
        self.ln = L.empty((cfg.d_model,), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mlp.reset_parameters(generator)
        self.ln.fill_(1.0)


class AttnSub(nn.Module):
    """attn (local attention) and its input norm ln."""

    AXES = {"ln": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.attn = L.AttentionParams(cfg.d_model, cfg.num_heads,
                                      cfg.num_kv_heads, cfg.head_dim,
                                      device=device)
        self.ln = L.empty((cfg.d_model,), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn.reset_parameters(generator)
        self.ln.fill_(1.0)


class Group(nn.Module):
    """One (rglru, rglru, attn) group, each sub-block followed by an MLP."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.r1 = RGLRUBlock(cfg, device=device)
        self.m1 = MLPSub(cfg, device=device)
        self.r2 = RGLRUBlock(cfg, device=device)
        self.m2 = MLPSub(cfg, device=device)
        self.attn = AttnSub(cfg, device=device)
        self.m3 = MLPSub(cfg, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for sub in (self.r1, self.m1, self.r2, self.m2, self.attn, self.m3):
            sub.reset_parameters(generator)


class Extra(nn.Module):
    """A trailing rglru layer and its MLP."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.r = RGLRUBlock(cfg, device=device)
        self.m = MLPSub(cfg, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.r.reset_parameters(generator)
        self.m.reset_parameters(generator)


def _n_groups(cfg) -> int:
    if cfg.num_layers % 3 not in (0, 2):
        raise ValueError(f"the hybrid pattern needs num_layers % 3 in (0, "
                         f"2); got {cfg.num_layers}")
    return cfg.num_layers // 3


def _n_extra(cfg) -> int:
    return cfg.num_layers - 3 * _n_groups(cfg)  # trailing rglru layers


class HybridLM(nn.Module):
    """embed, groups[num_layers // 3], extra[num_layers % 3] (when 2),
    final_norm: the reference's param tree."""

    AXES = {"final_norm": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.embed = L.EmbeddingParams(cfg.vocab_size, cfg.d_model,
                                       cfg.tie_embeddings, device=device)
        self.groups = nn.ModuleList(Group(cfg, device=device)
                                    for _ in range(_n_groups(cfg)))
        if _n_extra(cfg):
            self.extra = nn.ModuleList(Extra(cfg, device=device)
                                       for _ in range(_n_extra(cfg)))
        self.final_norm = L.empty((cfg.d_model,), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embed.reset_parameters(generator)
        for sub in (*self.groups, *getattr(self, "extra", ())):
            sub.reset_parameters(generator)
        self.final_norm.fill_(1.0)


def _rglru_gates(p, x):
    """x: (..., W) conv output -> (a, gated input), float32."""
    xf = x.float()
    r = torch.sigmoid(p.w_r * xf + p.b_r)
    i = torch.sigmoid(p.w_i * xf + p.b_i)
    log_a = -_C * F.softplus(p.lam) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6))
    return a, beta * (i * xf)


def _rglru_scan(a, b):
    """h_t = a_t h_{t-1} + b_t over axis 1 (seq), h_{-1} = 0; a, b: (B, S,
    W) float32. Doubling steps: after the step of shift d each position
    holds the composition of the d * 2 steps ending there, (a1, b1) then
    (a2, b2) composing to (a1 a2, a2 b1 + b2)."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _rglru_out(p, h_in, cfg):
    """The RG-LRU block's output (before the residual add) for its normed
    input h_in (B,S,D)."""
    dtype = h_in.dtype
    xb = h_in @ p.w_x.to(dtype)
    yb = h_in @ p.w_y.to(dtype)
    xb = constrain(xb, "batch", "seq", "rglru_width")
    xb = _causal_conv(xb, p.conv_w.to(dtype), p.conv_b.to(dtype))
    a, gi = _rglru_gates(p, xb)
    with span("rglru/scan"):
        h = _rglru_scan(a, gi).to(dtype)
    h = constrain(h, "batch", "seq", "rglru_width")
    out = (h * L.gelu_tanh(yb)) @ p.w_out.to(dtype)
    return constrain(out, "batch", "seq", None)


def _rglru_out_decode(p, h_in, cfg, conv_state, rec_state):
    """One token: h_in (B,1,D) normed input; conv_state (B,3,W); rec_state
    (B,W) float32. Returns (the block's output before the residual add,
    new conv_state, new rec_state). The window's taps are summed in order
    in float32 and rounded once, as the reference's dot does."""
    dtype = h_in.dtype
    xb = h_in @ p.w_x.to(dtype)
    yb = h_in @ p.w_y.to(dtype)
    window = torch.cat([conv_state, xb], dim=1)             # (B,4,W)
    w = p.conv_w.to(dtype)
    taps = window[:, 0].float() * w[0].float()
    for j in range(1, w.shape[0]):
        taps = taps + window[:, j].float() * w[j].float()
    xc = taps.to(torch.promote_types(window.dtype, w.dtype)) \
        + p.conv_b.to(dtype)[None, :]
    a, gi = _rglru_gates(p, xc)                             # (B,W)
    rec_state = a * rec_state + gi
    h = rec_state.to(dtype)[:, None, :]
    return (h * L.gelu_tanh(yb)) @ p.w_out.to(dtype), window[:, 1:, :], \
        rec_state


# ---------------------------------------------------------------------------
# model API
# ---------------------------------------------------------------------------


# Every sub-block adds its output to the residual stream and the next one
# norms it: ``L.add_norm`` does both, with the reference's rounding.


def _group_apply(gp, x, cfg, positions, backend):
    eps = cfg.norm_eps
    h = L.rms_norm(x, gp.r1.ln, eps, backend=backend)
    x, h = L.add_norm(x, _rglru_out(gp.r1, h, cfg), gp.m1.ln, eps)
    x, h = L.add_norm(x, L.mlp_apply(gp.m1.mlp, h), gp.r2.ln, eps)
    x, h = L.add_norm(x, _rglru_out(gp.r2, h, cfg), gp.m2.ln, eps)
    x, h = L.add_norm(x, L.mlp_apply(gp.m2.mlp, h), gp.attn.ln, eps)
    x, h = L.add_norm(x, L.attention_apply(gp.attn.attn, h, cfg,
                                           positions=positions,
                                           window=cfg.attn_window),
                      gp.m3.ln, eps)
    return x + L.mlp_apply(gp.m3.mlp, h)


def _extra_apply(ep, x, cfg, backend):
    h = L.rms_norm(x, ep.r.ln, cfg.norm_eps, backend=backend)
    x, h = L.add_norm(x, _rglru_out(ep.r, h, cfg), ep.m.ln, cfg.norm_eps)
    return x + L.mlp_apply(ep.m.mlp, h)


def forward(model: HybridLM, cfg: ModelConfig, batch, *,
            backend: str = "auto"):
    """batch: {"tokens": (B,S) int}; above ``attn_window`` positions S must
    be a multiple of it. Returns (logits over the padded vocabulary, {}).
    ``backend`` goes to the norm kernel (the block's first norm and the
    final one; ``add_norm`` norms a float32 sum)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.embed_apply(model.embed, tokens, getattr(torch, cfg.dtype))
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    for gp in model.groups:
        x = L.remat_apply(cfg, _group_apply, gp, x, cfg, positions,
                          backend)
    for ep in getattr(model, "extra", ()):
        x = L.remat_apply(cfg, _extra_apply, ep, x, cfg, backend)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps, backend=backend)
    return L.unembed_apply(model.embed, x), {}


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               device) -> Dict[str, torch.Tensor]:
    """Rolling-window KV cache for the attention layers and the recurrent
    layers' conv windows and states, all zero."""
    ng, ne = _n_groups(cfg), _n_extra(cfg)
    w = cfg.rglru_width or cfg.d_model
    win = min(cfg.attn_window or max_len, max_len)
    n_rec = 2 * ng + ne
    kv = (ng, batch_size, win, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(kv, dtype=torch.bfloat16, device=device),
        "v": torch.zeros(kv, dtype=torch.bfloat16, device=device),
        "conv": torch.zeros((n_rec, batch_size, 3, w), dtype=torch.bfloat16,
                            device=device),
        "rec": torch.zeros((n_rec, batch_size, w), dtype=torch.float32,
                           device=device),
    }


def cache_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The logical axes of :func:`init_cache`'s tensors, the reference's."""
    kv = ("groups", "batch", "seq_shard", "kv_heads", None)
    return {"k": kv, "v": kv, "conv": ("groups", "batch", None, "rglru_width"),
            "rec": ("groups", "batch", "rglru_width")}


def decode_step(model: HybridLM, cfg: ModelConfig, cache, tokens, cur_len):
    """tokens: (B,1) int; cur_len: () or (B,) int32 tensor. Returns
    (logits, new cache)."""
    eps = cfg.norm_eps
    x = L.embed_apply(model.embed, tokens, getattr(torch, cfg.dtype))
    ks, vs, convs, recs = [], [], [], []

    def rec_out(p, h):
        i = len(convs)
        out, c, r = _rglru_out_decode(p, h, cfg, cache["conv"][i],
                                      cache["rec"][i])
        convs.append(c)
        recs.append(r)
        return out

    for g, gp in enumerate(model.groups):
        h = L.rms_norm(x, gp.r1.ln, eps)
        x, h = L.add_norm(x, rec_out(gp.r1, h), gp.m1.ln, eps)
        x, h = L.add_norm(x, L.mlp_apply(gp.m1.mlp, h), gp.r2.ln, eps)
        x, h = L.add_norm(x, rec_out(gp.r2, h), gp.m2.ln, eps)
        x, h = L.add_norm(x, L.mlp_apply(gp.m2.mlp, h), gp.attn.ln, eps)
        a, ck, cv = L.attention_decode_apply(
            gp.attn.attn, h, cfg, cache_k=cache["k"][g],
            cache_v=cache["v"][g], cur_len=cur_len, window=cfg.attn_window)
        x, h = L.add_norm(x, a, gp.m3.ln, eps)
        x = x + L.mlp_apply(gp.m3.mlp, h)
        ks.append(ck)
        vs.append(cv)
    for ep in getattr(model, "extra", ()):
        h = L.rms_norm(x, ep.r.ln, eps)
        x, h = L.add_norm(x, rec_out(ep.r, h), ep.m.ln, eps)
        x = x + L.mlp_apply(ep.m.mlp, h)
    cache = dict(cache, k=torch.stack(ks), v=torch.stack(vs),
                 conv=torch.stack(convs), rec=torch.stack(recs))
    x = L.rms_norm(x, model.final_norm, eps)
    return L.unembed_apply(model.embed, x), cache
