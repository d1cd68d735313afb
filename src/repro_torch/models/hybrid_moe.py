"""Granite-4.0-H's hybrid mixture-of-experts LM (the ``hybrid_moe`` family):
Mamba-2 and attention mixers by ``cfg.hybrid_pattern``, every layer's FFN
a top-k mixture of experts beside a shared SwiGLU expert, and the
published scalar multipliers.

Each layer (``GraniteMoeHybridDecoderLayer``), with r the
``residual_multiplier``::

    h = x + r * mixer(rms(x))
    y = h + r * (moe(rms(h)) + shared(rms(h)))

The mixer is ``models.ssm.ssm_mixer`` (the SSD-scan kernel on the card) or
causal attention without a positional embedding when ``cfg.use_rope`` is
False, its scores scaled by ``cfg.attn_scale`` (the flash kernel on the
card). The MoE is ``models.moe.moe_apply``: routed over
``cfg.num_router_experts``, of which a device may hold a share
(``cfg.num_experts`` from ``cfg.first_expert``), and ``moe.shared_apply``.
The embedding is multiplied by ``cfg.embedding_multiplier`` and the
logits divided by ``cfg.logits_scaling``, each in the activations' dtype
as the published model does in bfloat16 (one rounding each; a division
by 16 is exact); every product, residual add and scale rounds to that
dtype, the norms and the router work in float32. ``forward`` sums the
layers' load-balance and router-z losses, as the ``moe`` family's does.
With ``cfg.remat`` each layer is recomputed in the backward.

Decoding through a cache is not ported for this family: ``init_cache``
and ``decode_step`` raise.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

CACHE_BATCH_DIMS: dict = {}


def layer_kinds(cfg: ModelConfig):
    """Each layer's mixer, ``"mamba"`` or ``"attention"``: the pattern
    repeated over the layers."""
    pat = cfg.hybrid_pattern
    kinds = [pat[i % len(pat)] for i in range(cfg.num_layers)]
    bad = set(kinds) - {"mamba", "attention"}
    if bad:
        raise ValueError(f"hybrid_moe layers are 'mamba' or 'attention', "
                         f"not {sorted(bad)}")
    return kinds


class HybridMoEBlock(nn.Module):
    """One layer: the mixer (``mamba``, a Mamba-2 mixer without its own
    norm, or ``attn``), ``moe`` (router and the held experts), ``shared``
    (the shared expert) and the norms ln1 (before the mixer) and ln2
    (before the experts)."""

    AXES = {"ln1": ("embed",), "ln2": ("embed",)}

    def __init__(self, cfg: ModelConfig, kind: str, *, device=None):
        super().__init__()
        if kind == "mamba":
            self.mamba = SSM.SSMBlock(cfg, device=device, norm=False)
        else:
            self.attn = L.AttentionParams(cfg.d_model, cfg.num_heads,
                                          cfg.num_kv_heads, cfg.head_dim,
                                          cfg.qkv_bias, device=device)
        self.moe = MOE.MoEParams(cfg.d_model, cfg.d_ff, cfg.num_experts,
                                 device=device,
                                 router_experts=cfg.router_experts)
        if cfg.shared_d_ff:
            self.shared = L.MLPParams(cfg.d_model, cfg.shared_d_ff,
                                      device=device)
        self.ln1 = L.empty((cfg.d_model,), device)
        self.ln2 = L.empty((cfg.d_model,), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        (self.mamba if hasattr(self, "mamba") else self.attn
         ).reset_parameters(generator)
        self.moe.reset_parameters(generator)
        if hasattr(self, "shared"):
            self.shared.reset_parameters(generator)
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)


class HybridMoELM(nn.Module):
    """embed (tied or not), blocks[num_layers], final_norm."""

    AXES = {"final_norm": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.embed = L.EmbeddingParams(cfg.vocab_size, cfg.d_model,
                                       cfg.tie_embeddings, device=device)
        self.blocks = nn.ModuleList(HybridMoEBlock(cfg, kind, device=device)
                                    for kind in layer_kinds(cfg))
        self.final_norm = L.empty((cfg.d_model,), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embed.reset_parameters(generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        self.final_norm.fill_(1.0)


def _layer_apply(p, x, cfg, positions, backend):
    r = cfg.residual_multiplier
    h = L.rms_norm(x, p.ln1, cfg.norm_eps, backend=backend)
    if hasattr(p, "mamba"):
        mixed = SSM.ssm_mixer(p.mamba, h, cfg, backend)
    else:
        mixed = L.attention_apply(p.attn, h, cfg, positions=positions,
                                  backend=backend)
    x = x + mixed * r
    h = L.rms_norm(x, p.ln2, cfg.norm_eps, backend=backend)
    out, aux = MOE.moe_apply(p.moe, h, cfg)
    if hasattr(p, "shared"):
        out = out + MOE.shared_apply(p.shared, h)
    return x + out * r, aux


def forward(model: HybridMoELM, cfg: ModelConfig, batch, *,
            backend: str = "auto"):
    """batch: {"tokens": (B, S) int}, S a multiple of min(ssm_chunk, S).
    Returns (logits over the padded vocabulary, the summed
    ``load_balance`` and ``router_z``). ``backend`` goes to the SSD and
    attention kernels."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dtype = getattr(torch, cfg.dtype)
    x = L.embed_apply(model.embed, tokens, dtype) * cfg.embedding_multiplier
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    aux = {"load_balance": torch.zeros((), device=tokens.device),
           "router_z": torch.zeros((), device=tokens.device)}
    for blk in model.blocks:
        x, a = L.remat_apply(cfg, _layer_apply, blk, x, cfg, positions,
                             backend)
        aux = {k: aux[k] + a[k] for k in aux}
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps, backend=backend)
    return L.unembed_apply(model.embed, x) / cfg.logits_scaling, aux


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               device):
    raise NotImplementedError("decoding through a cache is not ported for "
                              "the hybrid_moe family")


def cache_axes(cfg: ModelConfig):
    raise NotImplementedError("decoding through a cache is not ported for "
                              "the hybrid_moe family")


def decode_step(model, cfg, cache, tokens, cur_len):
    raise NotImplementedError("decoding through a cache is not ported for "
                              "the hybrid_moe family")
