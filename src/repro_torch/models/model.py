"""Model dispatcher, ported from ``repro.models.model``: family ->
(build, forward, init_cache, decode_step), and ``loss_fn`` (next-token
cross entropy plus the auxiliary losses of ``AUX_COEFS``).

Ported families: ``dense`` (``transformer``) and ``ssm`` (``ssm``). The
``moe`` and ``vlm`` families (in ``transformer``), ``hybrid`` and
``audio`` raise NotImplementedError naming their ``ROADMAP.md`` item. The
dry-run's abstract init is not ported.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

AUX_COEFS = {"load_balance": 0.01, "router_z": 0.001}

_NOT_PORTED = {"hybrid": "models/rglru.py with local attention",
               "audio": "models/whisper.py",
               "moe": "models/moe.py",
               "vlm": "vlm cross-attention blocks"}


def _family_module(cfg: ModelConfig):
    if cfg.family == "dense":
        from repro_torch.models import transformer as mod
    elif cfg.family == "ssm":
        from repro_torch.models import ssm as mod
    elif cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP.md, "
            f"modules to port: {_NOT_PORTED[cfg.family]})")
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return mod


def build(cfg: ModelConfig, *, device="cuda") -> nn.Module:
    """The family's module with uninitialised float32 parameters
    (``device="meta"`` allocates nothing)."""
    mod = _family_module(cfg)
    cls = mod.DenseLM if cfg.family == "dense" else mod.MambaLM
    return cls(cfg, device=resolve_device(device))


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> nn.Module:
    """Random float32 parameters with the reference's shapes and scales,
    drawn on ``device`` from a ``torch.Generator`` seeded with ``seed``
    (not ``jax.random``'s numbers)."""
    dev = resolve_device(device)
    model = build(cfg, device=dev)
    with torch.no_grad():
        model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    return model


def cast(model: nn.Module, cfg: ModelConfig, dtype=torch.bfloat16):
    """A copy of ``model`` with every floating parameter cast to ``dtype``
    (the serving paths' bf16 params); ``model`` itself is left as it is,
    and returned when it is already cast."""
    if all(p.dtype == dtype for p in model.parameters()
           if p.is_floating_point()):
        return model
    out = build(cfg, device="meta")
    out.load_state_dict({k: v.to(dtype) if v.is_floating_point() else v
                         for k, v in model.state_dict().items()},
                        assign=True)
    return out


def forward(model: nn.Module, cfg: ModelConfig, batch, *,
            backend: str = "auto"):
    """(logits over the padded vocabulary, aux losses); ``backend`` goes to
    the family's kernel (flash attention or SSD scan)."""
    return _family_module(cfg).forward(model, cfg, batch, backend=backend)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               device) -> Dict[str, torch.Tensor]:
    """Zero decode cache; the batch is dim 1 of every tensor in it."""
    return _family_module(cfg).init_cache(cfg, batch_size, max_len,
                                          device=device)


def decode_step(model: nn.Module, cfg: ModelConfig, cache, tokens,
                cur_len):
    """One token for every sequence: tokens (B,1) int; cur_len a () or (B,)
    int32 tensor. Returns (logits, new cache)."""
    return _family_module(cfg).decode_step(model, cfg, cache, tokens,
                                           cur_len)


def loss_fn(model: nn.Module, cfg: ModelConfig, batch, *,
            backend: str = "auto"):
    """Next-token loss. batch: {"tokens", "labels", + modality extras}.
    Returns (loss, {"nll": loss, **aux}); the dense and ssm families have
    no auxiliary losses (the MoE family's add ``AUX_COEFS`` terms)."""
    logits, aux = forward(model, cfg, batch, backend=backend)
    loss = L.cross_entropy_loss(logits, batch["labels"], cfg.vocab_size)
    for name, coef in AUX_COEFS.items():
        if name in aux:
            loss = loss + coef * aux[name] / max(cfg.num_layers, 1)
    return loss, {"nll": loss, **aux}
