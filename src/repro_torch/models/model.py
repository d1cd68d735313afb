"""Model dispatcher, ported from ``repro.models.model``: family ->
(build, forward, init_cache, decode_step), and ``loss_fn`` (next-token
cross entropy plus the auxiliary losses of ``AUX_COEFS``).

Every family of the reference is ported: ``dense``, ``moe`` and ``vlm``
(``transformer``), ``ssm`` (``ssm``), ``hybrid`` (``rglru``) and
``audio`` (``whisper``); ``hybrid_moe`` (``hybrid_moe``, Granite-4.0-H)
and ``jamba`` (``jamba``, Jamba2) are the port's own, with no counterpart
in the reference. :func:`abstract_init` and :func:`abstract_cache`
build the model and the decode cache as fake tensors for the dry-run
(``repro_torch.launch.dryrun``): shapes, dtypes and devices, no memory.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

AUX_COEFS = {"load_balance": 0.01, "router_z": 0.001}

# each family's model class in its module
_CLASSES = {"dense": "TransformerLM", "moe": "TransformerLM",
            "vlm": "TransformerLM", "ssm": "MambaLM", "hybrid": "HybridLM",
            "audio": "WhisperLM", "hybrid_moe": "HybridMoELM",
            "jamba": "JambaLM"}

# the top-level parameter trees whose leaves the reference stacks on a
# leading layer axis; the port keeps one module per layer under them
# (``<tree>.<i>.<rest>``)
STACKED = ("blocks", "cross_blocks", "encoder", "decoder", "groups",
           "extra")


def stacked(name: str) -> bool:
    """Whether the port's parameter ``name`` is one layer's slice of a
    stacked array of the reference."""
    return name.split(".", 1)[0] in STACKED


def _family_module(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models import transformer as mod
    elif cfg.family == "ssm":
        from repro_torch.models import ssm as mod
    elif cfg.family == "hybrid":
        from repro_torch.models import rglru as mod
    elif cfg.family == "audio":
        from repro_torch.models import whisper as mod
    elif cfg.family == "hybrid_moe":
        from repro_torch.models import hybrid_moe as mod
    elif cfg.family == "jamba":
        from repro_torch.models import jamba as mod
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return mod


def build(cfg: ModelConfig, *, device="cuda") -> nn.Module:
    """The family's module with uninitialised float32 parameters
    (``device="meta"`` allocates nothing)."""
    cls = getattr(_family_module(cfg), _CLASSES[cfg.family])
    return cls(cfg, device=resolve_device(device))


def param_axes(model: nn.Module) -> Dict[str, tuple]:
    """Each parameter's logical axes by name: the reference's axes tree
    (``init``'s second result) with the stacked ``"layers"`` axis dropped,
    as the port keeps one tensor per layer. Every parameter module names
    its own in its ``AXES``; ``distributed.sharding.validate_axes`` holds
    the result against ``model``. The modules carry what the config
    decided (e.g. the MoE partition mode), so no config is needed."""
    out = {}
    for mname, module in model.named_modules():
        for pname, _ in module.named_parameters(recurse=False):
            axes = getattr(module, "AXES", {})
            if pname not in axes:
                raise KeyError(f"{type(module).__name__} names no axes for "
                               f"its parameter {pname!r}")
            out[f"{mname}.{pname}" if mname else pname] = axes[pname]
    return out


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> nn.Module:
    """Random float32 parameters with the reference's shapes and scales,
    drawn on ``device`` from a ``torch.Generator`` seeded with ``seed``
    (not ``jax.random``'s numbers)."""
    dev = resolve_device(device)
    model = build(cfg, device=dev)
    with torch.no_grad():
        model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    return model


def fake_mode():
    """The active ``FakeTensorMode``, or a new one: what :func:`abstract_init`
    and :func:`abstract_cache` build under, so that a caller inside a mode
    gets tensors of that mode."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    return detect_fake_mode() or FakeTensorMode()


def abstract_init(cfg: ModelConfig, *, device="cuda"):
    """(model, :func:`param_axes`) with the model's float32 parameters
    fake tensors on ``device`` (never allocated; the reference's
    ``abstract_init`` gives ShapeDtypeStructs). For the dry-run."""
    dev = resolve_device(device)
    with fake_mode():
        model = build(cfg, device=dev)
    return model, param_axes(model)


def abstract_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
                   device="cuda"):
    """(decode cache of fake tensors on ``device``, its logical axes by
    name: the family's ``cache_axes``)."""
    dev = resolve_device(device)
    with fake_mode():
        cache = init_cache(cfg, batch_size, max_len, device=dev)
    return cache, cache_axes(cfg)


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
    """Zero decode cache; :func:`cache_batch_dims` says where the batch is
    in each of its tensors."""
    return _family_module(cfg).init_cache(cfg, batch_size, max_len,
                                          device=device)


def cache_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The logical axes of each tensor of the family's decode cache, the
    reference's (``init_cache``'s second result there)."""
    return _family_module(cfg).cache_axes(cfg)


def cache_batch_dims(cfg: ModelConfig) -> Dict[str, int]:
    """The batch dim of each tensor of the family's decode cache (the
    reference's ``"batch"`` axis): 1 for the stacked per-layer caches, 0
    for the vlm ``context`` and the audio ``enc_out``."""
    return dict(_family_module(cfg).CACHE_BATCH_DIMS)


def decode_step(model: nn.Module, cfg: ModelConfig, cache, tokens,
                cur_len):
    """One token for every sequence: tokens (B,1) int; cur_len a () or (B,)
    int32 tensor. Returns (logits, new cache)."""
    return _family_module(cfg).decode_step(model, cfg, cache, tokens,
                                           cur_len)


def loss_fn(model: nn.Module, cfg: ModelConfig, batch, *,
            backend: str = "auto"):
    """Next-token loss. batch: {"tokens", "labels", + modality extras}.
    Returns (loss, {"nll": loss, **aux}); only the moe and hybrid_moe
    families have auxiliary losses, each added with its ``AUX_COEFS`` weight divided by
    ``num_layers`` (``forward`` sums them over the layers)."""
    logits, aux = forward(model, cfg, batch, backend=backend)
    loss = L.cross_entropy_loss(logits, batch["labels"], cfg.vocab_size)
    for name, coef in AUX_COEFS.items():
        if name in aux:
            loss = loss + coef * aux[name] / max(cfg.num_layers, 1)
    return loss, {"nll": loss, **aux}
