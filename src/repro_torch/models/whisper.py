"""Whisper-style encoder-decoder transformer (the ``audio`` family), ported
from ``repro.models.whisper``.

The conv audio frontend is a stub, as in the reference: ``batch["frames"]``
holds precomputed frame embeddings (B, encoder_seq, d_model), as if the two
conv layers had already run (the data pipeline's ``frames``). The encoder
is bidirectional self-attention without RoPE (``layers.cross_attention``
of the frames to themselves, plain torch on both devices). Each decoder
block is causal self-attention (``layers.attention_apply``: the flash
kernel on the card), cross attention to the encoder's output, and an MLP,
each behind its own norm.

Decode keeps the encoder's output in the cache (``enc_out``, (B, F, D)
bfloat16, batch dim 0). ``init_cache`` makes it zeros and nothing in the
serving path fills it, as in the reference's ``Engine``; a caller that
wants the frames heard writes ``encode(model, cfg, frames)`` into it.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

# the batch dim of each cache tensor (Engine resets a slot along it)
CACHE_BATCH_DIMS = {"k": 1, "v": 1, "enc_out": 0}


class EncoderBlock(nn.Module):
    """attn (no bias), mlp, ln1, ln2."""

    AXES = {"ln1": ("embed",), "ln2": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.attn = L.AttentionParams(cfg.d_model, cfg.num_heads,
                                      cfg.num_kv_heads, cfg.head_dim,
                                      device=device)
        self.mlp = L.MLPParams(cfg.d_model, cfg.d_ff, device=device)
        self.ln1 = L.empty((cfg.d_model,), device)
        self.ln2 = L.empty((cfg.d_model,), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)


class DecoderBlock(nn.Module):
    """attn (causal self-attention), xattn (to the encoder's output), mlp,
    ln1, ln2, ln3."""

    AXES = {"ln1": ("embed",), "ln2": ("embed",), "ln3": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.attn = L.AttentionParams(cfg.d_model, cfg.num_heads,
                                      cfg.num_kv_heads, cfg.head_dim,
                                      device=device)
        self.xattn = L.AttentionParams(cfg.d_model, cfg.num_heads,
                                       cfg.num_kv_heads, cfg.head_dim,
                                       device=device)
        self.mlp = L.MLPParams(cfg.d_model, cfg.d_ff, device=device)
        for name in ("ln1", "ln2", "ln3"):
            setattr(self, name, L.empty((cfg.d_model,), device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn.reset_parameters(generator)
        self.xattn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)
        for ln in (self.ln1, self.ln2, self.ln3):
            ln.fill_(1.0)


class WhisperLM(nn.Module):
    """embed, encoder[encoder_layers], enc_norm, decoder[num_layers],
    final_norm: the reference's param tree."""

    AXES = {"enc_norm": ("embed",), "final_norm": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.embed = L.EmbeddingParams(cfg.vocab_size, cfg.d_model,
                                       cfg.tie_embeddings, device=device)
        self.encoder = nn.ModuleList(EncoderBlock(cfg, device=device)
                                     for _ in range(cfg.encoder_layers))
        self.enc_norm = L.empty((cfg.d_model,), device)
        self.decoder = nn.ModuleList(DecoderBlock(cfg, device=device)
                                     for _ in range(cfg.num_layers))
        self.final_norm = L.empty((cfg.d_model,), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embed.reset_parameters(generator)
        for blk in (*self.encoder, *self.decoder):
            blk.reset_parameters(generator)
        self.enc_norm.fill_(1.0)
        self.final_norm.fill_(1.0)


def _enc_block_apply(p, x, cfg, backend):
    h = L.rms_norm(x, p.ln1, cfg.norm_eps, backend=backend)
    q = L.project_heads(h, p.attn.wq)
    k = L.project_heads(h, p.attn.wk)
    v = L.project_heads(h, p.attn.wv)
    ctx = L.cross_attention(q, k, v)  # bidirectional (unmasked)
    x, h = L.add_norm(x, L.project_out(ctx, p.attn.wo), p.ln2,
                     cfg.norm_eps)
    return x + L.mlp_apply(p.mlp, h)


def encode(model: WhisperLM, cfg: ModelConfig, frames, *,
           backend: str = "auto"):
    """frames: (B, F, D) stub frontend output -> (B, F, D) encoder states in
    the model's dtype; ``backend`` goes to the norm kernel."""
    x = frames.to(getattr(torch, cfg.dtype))
    for blk in model.encoder:
        x = L.remat_apply(cfg, _enc_block_apply, blk, x, cfg, backend)
    return L.rms_norm(x, model.enc_norm, cfg.norm_eps, backend=backend)


def _dec_block_apply(p, x, cfg, positions, enc_out, backend):
    h = L.rms_norm(x, p.ln1, cfg.norm_eps, backend=backend)
    x, h = L.add_norm(x, L.attention_apply(p.attn, h, cfg, positions=positions,
                                          backend=backend), p.ln2,
                     cfg.norm_eps)
    x, h = L.add_norm(x, L.cross_attention_apply(p.xattn, h, enc_out), p.ln3,
                     cfg.norm_eps)
    return x + L.mlp_apply(p.mlp, h)


def forward(model: WhisperLM, cfg: ModelConfig, batch, *,
            backend: str = "auto"):
    """batch: {"tokens": (B,S) int, "frames": (B,F,D)}. Returns (logits
    over the padded vocabulary, {}); ``backend`` goes to the decoder's
    attention kernel."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    enc_out = encode(model, cfg, batch["frames"], backend=backend)
    x = L.embed_apply(model.embed, tokens, getattr(torch, cfg.dtype))
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    for blk in model.decoder:
        x = L.remat_apply(cfg, _dec_block_apply, blk, x, cfg, positions,
                          enc_out, backend)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps, backend=backend)
    return L.unembed_apply(model.embed, x), {}


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               device) -> Dict[str, torch.Tensor]:
    """Zero bfloat16 decoder KV cache (layers, batch, max_len, KV, hd) and
    encoder output ``enc_out`` (batch, encoder_seq, d_model)."""
    kv = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads,
          cfg.head_dim)
    return {"k": torch.zeros(kv, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(kv, dtype=torch.bfloat16, device=device),
            "enc_out": torch.zeros((batch_size, cfg.encoder_seq,
                                    cfg.d_model), dtype=torch.bfloat16,
                                   device=device)}


def cache_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The logical axes of :func:`init_cache`'s tensors, the reference's."""
    kv = ("layers", "batch", "seq_shard", "kv_heads", None)
    return {"k": kv, "v": kv, "enc_out": ("batch", None, None)}


def decode_step(model: WhisperLM, cfg: ModelConfig, cache, tokens,
                cur_len):
    """tokens: (B,1) int; cur_len: () or (B,) int32 tensor. Returns
    (logits, new cache); ``enc_out`` is read, never written."""
    x = L.embed_apply(model.embed, tokens, getattr(torch, cfg.dtype))
    enc_out = cache["enc_out"].to(x.dtype)
    ks, vs = [], []
    for i, blk in enumerate(model.decoder):
        h = L.rms_norm(x, blk.ln1, cfg.norm_eps)
        a, ck, cv = L.attention_decode_apply(
            blk.attn, h, cfg, cache_k=cache["k"][i], cache_v=cache["v"][i],
            cur_len=cur_len)
        x, h = L.add_norm(x, a, blk.ln2, cfg.norm_eps)
        x, h = L.add_norm(x, L.cross_attention_apply(blk.xattn, h, enc_out),
                         blk.ln3, cfg.norm_eps)
        x = x + L.mlp_apply(blk.mlp, h)
        ks.append(ck)
        vs.append(cv)
    cache = dict(cache, k=torch.stack(ks), v=torch.stack(vs))
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return L.unembed_apply(model.embed, x), cache
