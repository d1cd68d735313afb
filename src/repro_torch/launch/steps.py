"""Serving step functions, ported from ``repro.launch.steps``: the prefill
step (``forward`` and the argmax at the last position; it runs the
flash-attention or SSD-scan kernel in every block) and the decode step.

The reference's dry-run specs and train step are not ported. The
reference lowers the prefill step with bfloat16 params
(``steps.py:128``); here the caller casts (``repro_torch.models.model.
cast``) before it calls the step.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(model, batch) -> (B, 1) int32`` next tokens: the
    argmax over the padded vocabulary at the last position."""
    def prefill_step(model, batch):
        logits, _ = M.forward(model, cfg, batch)
        return torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``serve_step(model, cache, tokens, cur_len) -> ((B, 1) int32 next
    tokens, new cache)``."""
    def serve_step(model, cache, tokens, cur_len):
        logits, cache = M.decode_step(model, cfg, cache, tokens, cur_len)
        nxt = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
        return nxt, cache

    return serve_step
