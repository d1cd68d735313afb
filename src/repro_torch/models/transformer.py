"""Decoder-only transformer LM covering the ``dense``, ``moe`` and ``vlm``
families, ported from ``repro.models.transformer``.

The reference stacks every block leaf on a leading ``layers`` axis and runs
the blocks with ``jax.lax.scan``; here the blocks are an ``nn.ModuleList``
run in a Python loop (``repro_torch.convert`` slices the stacked arrays
per layer). With ``cfg.remat`` each block is recomputed in the backward
(``torch.utils.checkpoint``, the reference's ``remat_wrap``), so a train
step runs the flash kernel twice per block. The KV cache keeps the
reference's stacked layout, ``(layers, batch, max_len, KV, hd)``
bfloat16.

- ``moe``: each block's FFN is ``models.moe`` (top-k routing over
  ``num_experts``); ``forward`` sums the blocks' load-balance and router-z
  losses, in float32.
- ``vlm``: after every ``cross_attn_every`` self blocks comes one cross
  block (``cross_blocks``): tanh-gated cross attention to the image
  context (``batch["patches"]``, the stub patch-embed frontend's output)
  and a tanh-gated MLP. Both gates start at 0, so a fresh cross block adds
  exactly nothing. Decode reads the context from the cache's ``context``
  (B, P, D), whose batch is dim 0.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE

# the batch dim of each cache tensor (Engine resets a slot along it)
CACHE_BATCH_DIMS = {"k": 1, "v": 1, "context": 0}


class Block(nn.Module):
    AXES = {"ln1": ("embed",), "ln2": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.attn = L.AttentionParams(cfg.d_model, cfg.num_heads,
                                      cfg.num_kv_heads, cfg.head_dim,
                                      cfg.qkv_bias, device=device)
        self.ffn = (MOE.MoEParams(cfg.d_model, cfg.d_ff, cfg.num_experts,
                                  device=device,
                                  router_experts=cfg.router_experts)
                    if cfg.family == "moe"
                    else L.MLPParams(cfg.d_model, cfg.d_ff, device=device))
        self.ln1 = L.empty((cfg.d_model,), device)
        self.ln2 = L.empty((cfg.d_model,), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn.reset_parameters(generator)
        self.ffn.reset_parameters(generator)
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)


class CrossBlock(nn.Module):
    """The vlm's image layer: xattn (no bias), mlp, ln1, ln2 and the two
    tanh gates gate_attn, gate_mlp (scalars, 0 at init)."""

    AXES = {"ln1": ("embed",), "ln2": ("embed",), "gate_attn": (),
            "gate_mlp": ()}

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.xattn = L.AttentionParams(cfg.d_model, cfg.num_heads,
                                       cfg.num_kv_heads, cfg.head_dim,
                                       device=device)
        self.mlp = L.MLPParams(cfg.d_model, cfg.d_ff, device=device)
        self.ln1 = L.empty((cfg.d_model,), device)
        self.ln2 = L.empty((cfg.d_model,), device)
        self.gate_attn = L.empty((), device)
        self.gate_mlp = L.empty((), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.xattn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)
        self.gate_attn.zero_()
        self.gate_mlp.zero_()


class TransformerLM(nn.Module):
    """embed, blocks[num_layers], final_norm and, for the vlm family,
    cross_blocks[num_layers // cross_attn_every]: the reference's param
    tree."""

    AXES = {"final_norm": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"the transformer builds the dense, moe and "
                             f"vlm families, not {cfg.family!r}")
        self.embed = L.EmbeddingParams(cfg.vocab_size, cfg.d_model,
                                       cfg.tie_embeddings, device=device)
        self.blocks = nn.ModuleList(Block(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        if cfg.family == "vlm":
            self.cross_blocks = nn.ModuleList(
                CrossBlock(cfg, device=device)
                for _ in range(cfg.num_layers // cfg.cross_attn_every))
        self.final_norm = L.empty((cfg.d_model,), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embed.reset_parameters(generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        for blk in getattr(self, "cross_blocks", ()):
            blk.reset_parameters(generator)
        self.final_norm.fill_(1.0)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def _ffn(p, h, cfg):
    """The block's FFN and its aux losses (none for a dense MLP)."""
    if cfg.family == "moe":
        return MOE.moe_apply(p, h, cfg)
    return L.mlp_apply(p, h), {}


def _block_apply(p, x, cfg, positions, backend):
    sp = cfg.seq_parallel

    def to_sp(t):    # residual-stream layout (seq sharded over model)
        return constrain(t, "batch", "seq_shard", None) if sp else t

    def to_full(t):  # attention/MLP layout (seq replicated, TP inside)
        return constrain(t, "batch", "seq", None) if sp else t

    x = to_sp(x)
    h = to_full(L.rms_norm(x, p.ln1, cfg.norm_eps, backend=backend))
    x, h = L.add_norm(x, to_sp(L.attention_apply(
        p.attn, h, cfg, positions=positions, window=cfg.attn_window,
        backend=backend)), p.ln2, cfg.norm_eps)
    out, aux = _ffn(p.ffn, to_full(h), cfg)
    return x + to_sp(out), aux


def _cross_block_apply(p, x, cfg, context, backend="auto"):
    h = L.rms_norm(x, p.ln1, cfg.norm_eps, backend=backend)
    x, h = L.add_norm(x, torch.tanh(p.gate_attn).to(x.dtype)
                      * L.cross_attention_apply(p.xattn, h, context), p.ln2,
                      cfg.norm_eps)
    return x + torch.tanh(p.gate_mlp).to(x.dtype) * L.mlp_apply(p.mlp, h)


def _groups(model, cfg):
    """(self blocks, the cross block after them or None) in order: one
    group of all blocks, or for the vlm ``cross_attn_every`` self blocks
    and their cross block."""
    if cfg.family != "vlm":
        return [(model.blocks, None)]
    every = cfg.cross_attn_every
    return [(model.blocks[g * every:(g + 1) * every], cb)
            for g, cb in enumerate(model.cross_blocks)]


def forward(model: TransformerLM, cfg: ModelConfig, batch, *,
            backend: str = "auto"):
    """batch: {"tokens": (B,S) int, and for the vlm "patches": (B,P,D)}.
    Returns (logits over the padded vocabulary, aux losses: the summed
    ``load_balance`` and ``router_z`` for the moe family, else none).
    ``backend`` goes to the attention kernel."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dtype = getattr(torch, cfg.dtype)
    x = L.embed_apply(model.embed, tokens, dtype)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    aux = ({"load_balance": torch.zeros((), device=tokens.device),
            "router_z": torch.zeros((), device=tokens.device)}
           if cfg.family == "moe" else {})
    context = (batch["patches"].to(dtype) if cfg.family == "vlm" else None)
    for blocks, cross in _groups(model, cfg):
        for blk in blocks:
            x, a = L.remat_apply(cfg, _block_apply, blk, x, cfg, positions,
                                 backend)
            aux = {k: aux[k] + a[k] for k in aux}
        if cross is not None:
            x = L.remat_apply(cfg, _cross_block_apply, cross, x, cfg,
                              context, backend)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps, backend=backend)
    return L.unembed_apply(model.embed, x), aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               device) -> Dict[str, torch.Tensor]:
    """Zero bfloat16 KV cache, (layers, batch, max_len, KV, hd) each; the
    vlm adds the image ``context`` (batch, num_patches, d_model)."""
    shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads,
             cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
             "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}
    if cfg.family == "vlm":
        cache["context"] = torch.zeros(
            (batch_size, cfg.num_patches, cfg.d_model), dtype=torch.bfloat16,
            device=device)
    return cache


def cache_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The logical axes of :func:`init_cache`'s tensors, the reference's
    (``transformer.py:162-168``): the sequence is sharded over ``model``."""
    kv = ("layers", "batch", "seq_shard", "kv_heads", None)
    axes = {"k": kv, "v": kv}
    if cfg.family == "vlm":
        axes["context"] = ("batch", None, None)
    return axes


def decode_step(model: TransformerLM, cfg: ModelConfig, cache, tokens,
                cur_len):
    """tokens: (B,1) int; cur_len: () or (B,) int32 tensor. Returns
    (logits, new cache). The moe family's FFN routes the one token with
    its own capacity (never dropping at S = 1); its aux losses are
    dropped, as in the reference."""
    dtype = getattr(torch, cfg.dtype)
    x = L.embed_apply(model.embed, tokens, dtype)
    context = cache["context"].to(dtype) if cfg.family == "vlm" else None
    ks, vs = [], []
    for blocks, cross in _groups(model, cfg):
        for blk in blocks:
            i = len(ks)
            h = L.rms_norm(x, blk.ln1, cfg.norm_eps)
            a, ck, cv = L.attention_decode_apply(
                blk.attn, h, cfg, cache_k=cache["k"][i],
                cache_v=cache["v"][i], cur_len=cur_len,
                window=cfg.attn_window)
            x, h = L.add_norm(x, a, blk.ln2, cfg.norm_eps)
            x = x + _ffn(blk.ffn, h, cfg)[0]
            ks.append(ck)
            vs.append(cv)
        if cross is not None:
            x = _cross_block_apply(cross, x, cfg, context)
    cache = dict(cache, k=torch.stack(ks), v=torch.stack(vs))
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return L.unembed_apply(model.embed, x), cache
