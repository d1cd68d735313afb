"""Decoder-only transformer LM, the ``dense`` family, ported from
``repro.models.transformer``.

The reference stacks every block leaf on a leading ``layers`` axis and runs
the blocks with ``jax.lax.scan``; here the blocks are an ``nn.ModuleList``
run in a Python loop (``repro_torch.convert`` slices the stacked arrays
per layer). With ``cfg.remat`` each block is recomputed in the backward
(``torch.utils.checkpoint``, the reference's ``remat_wrap``), so a train
step runs the flash kernel twice per block. The KV cache keeps the
reference's stacked layout, ``(layers, batch, max_len, KV, hd)``
bfloat16.

The ``moe`` and ``vlm`` families of the reference's module are not ported
yet (``ROADMAP.md``): building or running one raises NotImplementedError.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP.md, "
            f"modules to port)")


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.attn = L.AttentionParams(cfg.d_model, cfg.num_heads,
                                      cfg.num_kv_heads, cfg.head_dim,
                                      cfg.qkv_bias, device=device)
        self.ffn = L.MLPParams(cfg.d_model, cfg.d_ff, device=device)
        self.ln1 = L.empty((cfg.d_model,), device)
        self.ln2 = L.empty((cfg.d_model,), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn.reset_parameters(generator)
        self.ffn.reset_parameters(generator)
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)


class DenseLM(nn.Module):
    """embed, blocks[num_layers], final_norm: the reference's param tree."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        _check_family(cfg)
        self.embed = L.EmbeddingParams(cfg.vocab_size, cfg.d_model,
                                       cfg.tie_embeddings, device=device)
        self.blocks = nn.ModuleList(Block(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = L.empty((cfg.d_model,), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embed.reset_parameters(generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        self.final_norm.fill_(1.0)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def _add_norm(x, a, scale, eps):
    """``x + a`` for the residual stream, rounded to x's dtype, and the RMS
    norm of that sum taken from its float32 value: the reference's
    compiled block fuses the add into the norm's float32 cast and keeps
    the sum's excess precision there (XLA's default), so in bfloat16 the
    norm sees the unrounded sum while the residual carries the rounded
    one. In float32 this is ``x + a`` and its norm."""
    s = x.float() + a.float()
    return s.to(x.dtype), L.rms_norm(s, scale, eps).to(x.dtype)


def _block_apply(p, x, cfg, positions, backend):
    h = L.rms_norm(x, p.ln1, cfg.norm_eps)
    x, h = _add_norm(x, L.attention_apply(p.attn, h, cfg, positions=positions,
                                          backend=backend), p.ln2,
                     cfg.norm_eps)
    return x + L.mlp_apply(p.ffn, h)


def forward(model: DenseLM, cfg: ModelConfig, batch, *,
            backend: str = "auto"):
    """batch: {"tokens": (B,S) int}. Returns (logits over the padded
    vocabulary, aux losses: none for the dense family). ``backend`` goes
    to the attention kernel."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dtype = getattr(torch, cfg.dtype)
    x = L.embed_apply(model.embed, tokens, dtype)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    for blk in model.blocks:
        x = L.remat_apply(cfg, _block_apply, blk, x, cfg, positions,
                          backend)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return L.unembed_apply(model.embed, x), {}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               device) -> Dict[str, torch.Tensor]:
    """Zero bfloat16 KV cache, (layers, batch, max_len, KV, hd) each."""
    shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def decode_step(model: DenseLM, cfg: ModelConfig, cache, tokens, cur_len):
    """tokens: (B,1) int; cur_len: () or (B,) int32 tensor. Returns
    (logits, new cache)."""
    x = L.embed_apply(model.embed, tokens, getattr(torch, cfg.dtype))
    ks, vs = [], []
    for i, blk in enumerate(model.blocks):
        h = L.rms_norm(x, blk.ln1, cfg.norm_eps)
        a, ck, cv = L.attention_decode_apply(
            blk.attn, h, cfg, cache_k=cache["k"][i], cache_v=cache["v"][i],
            cur_len=cur_len)
        x, h = _add_norm(x, a, blk.ln2, cfg.norm_eps)
        x = x + L.mlp_apply(blk.ffn, h)
        ks.append(ck)
        vs.append(cv)
    cache = dict(cache, k=torch.stack(ks), v=torch.stack(vs))
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return L.unembed_apply(model.embed, x), cache
