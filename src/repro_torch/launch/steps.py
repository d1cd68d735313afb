"""Step functions, ported from ``repro.launch.steps``: the train step
(``make_train_step``: loss, backward, AdamW, with gradient accumulation
over microbatches), the prefill step
(``forward`` and the argmax at the last position) and the decode step.
The train and prefill steps run the flash-attention kernel in every
causal self-attention layer (dense, moe and vlm blocks, the Whisper
decoder) and the SSD-scan kernel in every Mamba-2 block; the hybrid's
local attention and recurrence, cross attention and the MoE dispatch are
plain torch. The train step's backward recomputes each block
(``cfg.remat``) and takes the kernels' gradients through their
``autograd.Function``s. :func:`prefill_batch` builds a prefill batch with
the family's stub inputs (``patches``, ``frames``).

The reference's dry-run specs (``batch_specs``, ``build_cell``) wait for
the dry-run port (``ROADMAP.md`` B7). The reference lowers the prefill
step with bfloat16 params (``steps.py:128``); here the caller casts
(``repro_torch.models.model.cast``) before it calls the step.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import make_pipeline
from repro_torch.distributed.sharding import full, is_dtensor
from repro_torch.models import model as M
from repro_torch.train import optimizer as OPT

BIG_MODEL_PARAMS = 1.5e11  # above this, store Adam moments in bf16


def make_opt_hparams(cfg: ModelConfig, **overrides) -> OPT.OptHParams:
    state_dtype = "bfloat16" if cfg.param_count() > BIG_MODEL_PARAMS \
        else "float32"
    return OPT.OptHParams(state_dtype=state_dtype, **overrides)


def make_train_step(cfg: ModelConfig, hp: OPT.OptHParams,
                    microbatches: int = 1):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: one AdamW step on the batch's next-token loss. The model's
    parameters must require grad; they and the optimizer state are updated
    in place (the reference returns new trees). ``batch`` holds tensors on
    the model's device (``tokens`` and ``labels``, (B, S) int, and the
    family's ``patches`` or ``frames``). Metrics are
    0-d tensors: ``loss``, ``nll``, the family's aux losses, ``grad_norm``
    (before clipping) and ``lr``. Each parameter's ``.grad`` is left set
    after the step, as the gradient of this batch.

    With ``microbatches`` > 1 (gradient accumulation, the reference's
    ``trainer._accumulate_train_step``) the batch is cut into that many
    sequential slices along its first axis; their float32 gradients are
    summed in order (``.grad`` accumulates), then divided by their number,
    and the loss and metrics are averaged over the slices.

    Under a mesh (``DTensor`` parameters and batch, called inside
    ``distributed.sharding.use_mesh``) each gradient is brought to its
    parameter's placements before the optimizer, and the metrics come back
    whole on every rank.

    Each slice's forward and the optimizer are profiler ranges
    (``train_step/forward``, ``train_step/optimizer``; the backward runs on
    autograd's own thread, so a range around it would hold none of its
    work); a range costs nothing when no profiler runs."""
    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        size = next(iter(batch.values())).shape[0] // microbatches
        loss_sum, mets = 0.0, []
        for i in range(microbatches):
            one = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            with record_function("train_step/forward"):
                loss, met = M.loss_fn(model, cfg, one)
            loss.backward()   # .grad accumulates: g_1 + g_2 + ...
            loss_sum = loss_sum + loss.detach()
            mets.append({k: v.detach() for k, v in met.items()})
        for p in params.values():
            if is_dtensor(p) and p.grad.placements != p.placements:
                p.grad = p.grad.redistribute(p.device_mesh, p.placements)
        if microbatches > 1:
            for p in params.values():
                p.grad.div_(microbatches)
        grads = {k: p.grad for k, p in params.items()}
        with record_function("train_step/optimizer"):
            _, opt_state, opt_metrics = OPT.apply_updates(params, grads,
                                                          opt_state, hp)
        mets = [{k: full(v) for k, v in m.items()} for m in mets]
        metrics = {k: torch.stack([m[k] for m in mets]).mean()
                   for k in mets[0]}
        return model, opt_state, {"loss": full(loss_sum) / microbatches,
                                  **metrics, **opt_metrics}

    return train_step


def prefill_batch(cfg: ModelConfig, batch_size: int, seq_len: int, *,
                  seed: int = 0, device="cuda") -> dict:
    """A prefill batch on ``device``: batch 0 of the data pipeline
    (``data.pipeline``, seeded) without its labels, so ``tokens`` (B, S)
    int32 and, for the vlm and audio families, the stub frontends'
    ``patches`` (B, num_patches, d_model) or ``frames`` (B, encoder_seq,
    d_model) cast to the model's dtype (the reference's prefill specs give
    them the activations' dtype)."""
    dev = resolve_device(device)
    b = make_pipeline(cfg, seq_len=seq_len, global_batch=batch_size,
                      seed=seed).batch_at(0)
    out = {"tokens": torch.from_numpy(b["tokens"]).to(dev)}
    for k in ("patches", "frames"):
        if k in b:
            out[k] = torch.from_numpy(b[k]).to(
                dev, getattr(torch, cfg.dtype))
    return out


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
