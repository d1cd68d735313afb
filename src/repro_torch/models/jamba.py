"""Jamba's hybrid LM (the ``jamba`` family: AI21-Jamba2-3B): Mamba-1 and
attention mixers by ``cfg.hybrid_pattern``, every layer's FFN a SwiGLU MLP.

Each layer (transformers' ``JambaMambaDecoderLayer`` and
``JambaAttentionDecoderLayer``)::

    h = x + mixer(rms(x))
    y = h + mlp(rms(h))                    # mlp: down(silu(gate h) * up h)

The ``"mamba1"`` mixer (``JambaMambaMixer``), without projection biases::

    u, z = h W_x, h W_z                                 # d -> d_inner each
    u = silu(causal_conv(u) + conv_b)                   # depthwise, taps W
    dt, B, C = u W_xproj                                # d_inner -> R + 2 N
    dt, B, C = rms(dt), rms(B), rms(C)                  # dt_norm, B_norm, C_norm
    y = selective_scan(u, dt W_dt, b_dt, -exp(A_log), B, C, D, z)
    out = y W_out

where the scan (``kernels/selective_scan.py``: the hand-written kernel on
the card) takes ``delta = softplus(dt W_dt + b_dt)`` per channel and
decays each (channel, state) pair by ``exp(delta A)``; its y is already
gated by ``silu(z)``. The ``"attention"`` mixer is causal attention
without a positional embedding (``cfg.use_rope`` False), the flash kernel
on the card. Every product, conv tap and residual add rounds to the
activations' dtype; the norms work in float32 and the scan's recurrence
too. With ``cfg.remat`` each layer is recomputed in the backward.

Decoding through a cache is not ported for this family: ``init_cache``
and ``decode_step`` raise.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import selective_scan as SS
from repro_torch.models import layers as L
from repro_torch.models.ssm import _causal_conv

CACHE_BATCH_DIMS: dict = {}
MIXERS = ("mamba1", "attention")


def layer_kinds(cfg: ModelConfig):
    """Each layer's mixer, ``"mamba1"`` or ``"attention"``: the pattern
    repeated over the layers."""
    pat = cfg.hybrid_pattern
    kinds = [pat[i % len(pat)] for i in range(cfg.num_layers)]
    bad = set(kinds) - set(MIXERS)
    if bad:
        raise ValueError(f"jamba layers are 'mamba1' or 'attention', not "
                         f"{sorted(bad)}")
    return kinds


class Mamba1Mixer(nn.Module):
    """w_x, w_z (d, di); the depthwise conv conv_w (W, di) and conv_b;
    w_xproj (di, R + 2N) and the norms of its three parts dt_norm (R,),
    B_norm and C_norm (N,); w_dt (R, di) and its bias b_dt (di,); A_log
    (di, N); D (di,); w_out (di, d)."""

    AXES = {"w_x": ("embed", "ssm_inner"), "w_z": ("embed", "ssm_inner"),
            "conv_w": ("conv_width", "ssm_inner"), "conv_b": ("ssm_inner",),
            "w_xproj": ("ssm_inner", None), "dt_norm": (None,),
            "B_norm": ("ssm_state",), "C_norm": ("ssm_state",),
            "w_dt": (None, "ssm_inner"), "b_dt": ("ssm_inner",),
            "A_log": ("ssm_inner", "ssm_state"), "D": ("ssm_inner",),
            "w_out": ("ssm_inner", "embed")}

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d, di, n, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_dt_rank
        self.w_x = L.empty((d, di), device)
        self.w_z = L.empty((d, di), device)
        self.conv_w = L.empty((cfg.ssm_conv_width, di), device)
        self.conv_b = L.empty((di,), device)
        self.w_xproj = L.empty((di, r + 2 * n), device)
        self.dt_norm = L.empty((r,), device)
        self.B_norm = L.empty((n,), device)
        self.C_norm = L.empty((n,), device)
        self.w_dt = L.empty((r, di), device)
        self.b_dt = L.empty((di,), device)
        self.A_log = L.empty((di, n), device)
        self.D = L.empty((di,), device)
        self.w_out = L.empty((di, d), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.w_x, self.w_z, self.w_xproj, self.w_dt, self.w_out):
            L.dense_init_(w, generator)
        L.dense_init_(self.conv_w, generator, scale=1.0)
        self.conv_b.zero_()
        for w in (self.dt_norm, self.B_norm, self.C_norm, self.D):
            w.fill_(1.0)
        # delta = softplus(b_dt) log-uniform in [1e-3, 1e-1], Mamba's
        self.b_dt.uniform_(math.log(1e-3), math.log(1e-1),
                           generator=generator)
        self.b_dt.copy_(torch.log(torch.expm1(torch.exp(self.b_dt))))
        # A = -(1, 2, ..., N) on every channel, Mamba's S4D-real
        n = self.A_log.shape[1]
        self.A_log.copy_(torch.log(torch.arange(
            1, n + 1, dtype=torch.float32)).expand_as(self.A_log))


class JambaBlock(nn.Module):
    """One layer: the mixer (``mamba``, a Mamba-1 mixer, or ``attn``),
    ``mlp`` and the norms ln1 (before the mixer) and ln2 (before the
    MLP)."""

    AXES = {"ln1": ("embed",), "ln2": ("embed",)}

    def __init__(self, cfg: ModelConfig, kind: str, *, device=None):
        super().__init__()
        if kind == "mamba1":
            self.mamba = Mamba1Mixer(cfg, device=device)
        else:
            self.attn = L.AttentionParams(cfg.d_model, cfg.num_heads,
                                          cfg.num_kv_heads, cfg.head_dim,
                                          cfg.qkv_bias, device=device)
        self.mlp = L.MLPParams(cfg.d_model, cfg.d_ff, device=device)
        self.ln1 = L.empty((cfg.d_model,), device)
        self.ln2 = L.empty((cfg.d_model,), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        (self.mamba if hasattr(self, "mamba") else self.attn
         ).reset_parameters(generator)
        self.mlp.reset_parameters(generator)
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)


class JambaLM(nn.Module):
    """embed (tied or not), blocks[num_layers], final_norm."""

    AXES = {"final_norm": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.embed = L.EmbeddingParams(cfg.vocab_size, cfg.d_model,
                                       cfg.tie_embeddings, device=device)
        self.blocks = nn.ModuleList(JambaBlock(cfg, kind, device=device)
                                    for kind in layer_kinds(cfg))
        self.final_norm = L.empty((cfg.d_model,), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embed.reset_parameters(generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        self.final_norm.fill_(1.0)


def mamba1_mixer(p: Mamba1Mixer, h, cfg: ModelConfig, backend: str):
    """The Mamba-1 mixer over full sequences on the normed input h (B, S,
    d), in h's dtype."""
    dtype = h.dtype
    u = h @ p.w_x.to(dtype)
    z = h @ p.w_z.to(dtype)
    u = F.silu(_causal_conv(u, p.conv_w.to(dtype), p.conv_b.to(dtype)))
    r, n = cfg.ssm_dt_rank, cfg.ssm_state
    dt, Bm, Cm = (u @ p.w_xproj.to(dtype)).split([r, n, n], dim=-1)
    eps = cfg.norm_eps
    dt = L.rms_norm(dt, p.dt_norm, eps, backend=backend)
    Bm = L.rms_norm(Bm, p.B_norm, eps, backend=backend)
    Cm = L.rms_norm(Cm, p.C_norm, eps, backend=backend)
    delta_raw = dt @ p.w_dt.to(dtype)
    y = SS.selective_scan(u, delta_raw, p.b_dt, -torch.exp(p.A_log), Bm, Cm,
                          p.D, z, backend=backend)
    return y @ p.w_out.to(dtype)


def _layer_apply(p, x, cfg, positions, backend):
    h = L.rms_norm(x, p.ln1, cfg.norm_eps, backend=backend)
    if hasattr(p, "mamba"):
        mixed = mamba1_mixer(p.mamba, h, cfg, backend)
    else:
        mixed = L.attention_apply(p.attn, h, cfg, positions=positions,
                                  backend=backend)
    x = x + mixed
    h = L.rms_norm(x, p.ln2, cfg.norm_eps, backend=backend)
    return x + L.mlp_apply(p.mlp, h)


def forward(model: JambaLM, cfg: ModelConfig, batch, *,
            backend: str = "auto"):
    """batch: {"tokens": (B, S) int}. Returns (logits over the padded
    vocabulary, {}). ``backend`` goes to the selective-scan, attention and
    norm kernels."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.embed_apply(model.embed, tokens, getattr(torch, cfg.dtype))
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    for blk in model.blocks:
        x = L.remat_apply(cfg, _layer_apply, blk, x, cfg, positions, backend)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps, backend=backend)
    return L.unembed_apply(model.embed, x), {}


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               device):
    raise NotImplementedError("decoding through a cache is not ported for "
                              "the jamba family")


def cache_axes(cfg: ModelConfig):
    raise NotImplementedError("decoding through a cache is not ported for "
                              "the jamba family")


def decode_step(model, cfg, cache, tokens, cur_len):
    raise NotImplementedError("decoding through a cache is not ported for "
                              "the jamba family")
