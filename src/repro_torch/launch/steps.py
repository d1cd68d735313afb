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

The prefill and decode steps take bfloat16 params, as the reference
lowers them (``steps.py:128``): the caller casts
(``repro_torch.models.model.cast``) before it calls the step.

The dry-run's specs (:func:`batch_specs`, :class:`DryrunSpec`,
:func:`build_cell`) build one (architecture x shape) cell's step and its
arguments as fake tensors on a mesh, ``DTensor``s with the reference's
placements, for ``repro_torch.launch.dryrun`` to trace.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as SH
from repro_torch.data.pipeline import make_pipeline
from repro_torch.distributed.sharding import full, is_dtensor
from repro_torch.models import model as M
from repro_torch.spans import span
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

    Each slice's forward and backward and the optimizer are spans
    (``repro_torch.spans``: ``train_step/forward``, ``train_step/backward``,
    ``train_step/optimizer``). The backward's work runs on autograd's own
    thread, so its device time sits under its autograd nodes, not under
    ``train_step/backward``; that span holds the host's wall time until
    ``loss.backward()`` returns, which places the device's idle gaps of
    the backward in time. A span costs what ``record_function`` costs when
    no profiler runs."""
    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        size = next(iter(batch.values())).shape[0] // microbatches
        loss_sum, mets = 0.0, []
        for i in range(microbatches):
            one = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            with span("train_step/forward"):
                loss, met = M.loss_fn(model, cfg, one)
            with span("train_step/backward"):
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
        with span("train_step/optimizer"):
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


def next_tokens(logits) -> torch.Tensor:
    """(B, 1) int32: the argmax over the padded vocabulary at the last
    position. Under a mesh that position's (B, 1, V) logits are gathered
    over the vocabulary shards first (one all-gather), so that every torch
    version takes a plain argmax (DTensor's sharded argmax differs between
    them and cannot run on fake tensors)."""
    last = SH.unshard(logits[:, -1:, :], 2)
    return torch.argmax(last, dim=-1).to(torch.int32)


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(model, batch) -> (B, 1) int32`` next tokens
    (:func:`next_tokens`)."""
    def prefill_step(model, batch):
        logits, _ = M.forward(model, cfg, batch)
        return next_tokens(logits)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``serve_step(model, cache, tokens, cur_len) -> ((B, 1) int32 next
    tokens, new cache)``."""
    def serve_step(model, cache, tokens, cur_len):
        logits, cache = M.decode_step(model, cfg, cache, tokens, cur_len)
        return next_tokens(logits), cache

    return serve_step


# ---------------------------------------------------------------------------
# the dry-run's cells: the step and its arguments as fake tensors on a mesh
# ---------------------------------------------------------------------------


def _sds(shape, dtype, device):
    """A zero tensor: under ``FakeTensorMode`` a fake one, which allocates
    nothing (the reference's ``ShapeDtypeStruct``)."""
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, *, with_labels: bool,
                device):
    """(batch tensors, their logical axes) of a cell: int32 ``tokens`` (and
    ``labels``) (global_batch, seq_len), and the vlm's ``patches`` or the
    audio family's ``frames`` in bfloat16."""
    gb, s = shape.global_batch, shape.seq_len
    specs = {"tokens": _sds((gb, s), torch.int32, device)}
    axes = {"tokens": ("batch", "seq")}
    if with_labels:
        specs["labels"] = _sds((gb, s), torch.int32, device)
        axes["labels"] = ("batch", "seq")
    if cfg.family == "vlm":
        specs["patches"] = _sds((gb, cfg.num_patches, cfg.d_model),
                                torch.bfloat16, device)
        axes["patches"] = ("batch", None, None)
    if cfg.family == "audio":
        specs["frames"] = _sds((gb, cfg.encoder_seq, cfg.d_model),
                               torch.bfloat16, device)
        axes["frames"] = ("batch", None, None)
    return specs, axes


def _cast_tree(model, cfg: ModelConfig, dtype=torch.bfloat16):
    """The model with its floating parameters in ``dtype`` (the serving
    steps' bf16 params), placements kept."""
    return M.cast(model, cfg, dtype)


@dataclasses.dataclass
class DryrunSpec:
    """Everything needed to run one cell: ``fn(*args)`` inside
    ``sharding.use_mesh``. ``args`` are ``DTensor``s (fake ones for the
    dry-run) that carry the placements ``in_shardings`` names (placements
    by name, per argument); ``out_shardings`` are the placements of what
    ``fn`` returns, None where the step leaves them to DTensor. The
    reference's ``donate_argnums`` has no counterpart: the train step
    updates the model's parameters and the optimizer state in place."""
    fn: Any
    args: Tuple
    in_shardings: Tuple
    out_shardings: Any


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               seed=None, hp: OPT.OptHParams = None) -> DryrunSpec:
    """The step and its arguments for one (arch x shape) cell on ``mesh``
    (a ``DeviceMesh``; tensors on its device type). A train cell's
    optimizer takes ``hp``, by default :func:`make_opt_hparams` (whose
    ``state_dtype`` sets the Adam moments' bytes).

    With ``seed`` None every tensor is fake (built under the active
    ``FakeTensorMode``, or a new one): the dry-run's trace. With a seed the
    same cell is built for real, the model's random init drawn from it and
    the batch all zeros, so that the same step can run and be counted
    beside its trace (``chip_smoke.py`` phase 16)."""
    dev = torch.device(mesh.device_type)
    with (M.fake_mode() if seed is None else contextlib.nullcontext()):
        if seed is None:
            model, axes = M.abstract_init(cfg, device=dev)
        else:
            model = M.init(cfg, seed=seed, device=dev)
            axes = M.param_axes(model)
        shapes = {k: p.shape for k, p in model.named_parameters()}
        p_sh = SH.tree_param_shardings(axes, mesh, shapes)
        SH.distribute_params(model, mesh, p_sh)

        def act(tensors, axes_tree):
            shapes_ = {k: v.shape for k, v in tensors.items()}
            pl = SH.tree_act_shardings(axes_tree, mesh, shapes_)
            return SH.distribute_tree(tensors, mesh, pl), pl

        if shape.kind == "train":
            hp = hp or make_opt_hparams(cfg)
            model.requires_grad_(True)
            opt = OPT.init_state(dict(model.named_parameters()), hp)
            opt_axes = OPT.state_axes(axes)
            o_sh = {"m": SH.tree_param_shardings(opt_axes["m"], mesh, shapes),
                    "v": SH.tree_param_shardings(opt_axes["v"], mesh, shapes),
                    "step": SH.spec_placements("act", (), (), mesh)}
            batch, b_sh = act(*batch_specs(cfg, shape, with_labels=True,
                                           device=dev))
            return DryrunSpec(fn=make_train_step(cfg, hp),
                              args=(model, opt, batch),
                              in_shardings=(p_sh, o_sh, b_sh),
                              out_shardings=(p_sh, o_sh, None))

        serve = _cast_tree(model, cfg)
        if shape.kind == "prefill":
            batch, b_sh = act(*batch_specs(cfg, shape, with_labels=False,
                                           device=dev))
            return DryrunSpec(fn=make_prefill_step(cfg), args=(serve, batch),
                              in_shardings=(p_sh, b_sh), out_shardings=None)

        # decode: one new token against a seq_len-deep cache
        if seed is None:
            cache, _ = M.abstract_cache(cfg, shape.global_batch,
                                        shape.seq_len, device=dev)
        else:
            cache = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 device=dev)
        tokens = _sds((shape.global_batch, 1), torch.int32, dev)
        args, (_, c_sh, tok_sh, len_sh) = place_decode_args(
            cfg, mesh, serve, cache, tokens, _sds((), torch.int32, dev))
        return DryrunSpec(fn=make_decode_step(cfg), args=args,
                          in_shardings=(p_sh, c_sh, tok_sh, len_sh),
                          out_shardings=(tok_sh, c_sh))


def place_decode_args(cfg: ModelConfig, mesh, model, cache, tokens,
                      cur_len):
    """The decode step's arguments on ``mesh`` and their placements by
    name: ``((model, cache, tokens, cur_len), (model's, cache's, tokens',
    cur_len's))``. The bf16 model by ``param_axes`` (a copy of the
    module whose parameters are ``DTensor``s, sharing the caller's
    storage; a model whose parameters are all ``DTensor``s already is
    left as it is), the cache by the family's ``cache_axes``, the (B, 1)
    tokens on ``("batch", None)``, ``cur_len`` (() or (B,)) replicated.
    A tensor that is a ``DTensor`` already is left as it is, so the
    serving engine passes the cache a step returned straight back. Every
    rank passes the same whole values and keeps its own shards: no
    collective. The dry-run's decode cells and ``serve.engine.Engine``
    place their arguments here."""
    model, p_sh = place_model(cfg, mesh, model)
    c_axes = M.cache_axes(cfg)
    c_sh = SH.tree_act_shardings(c_axes, mesh,
                                 {k: v.shape for k, v in cache.items()})
    tok_sh = SH.spec_placements("act", ("batch", None), tokens.shape, mesh)
    len_sh = SH.spec_placements("act", (None,) * cur_len.dim(),
                                cur_len.shape, mesh)

    def place(tensors, placements):
        plain = {k: t for k, t in tensors.items() if not is_dtensor(t)}
        return {**tensors, **SH.distribute_tree(plain, mesh, {
            k: placements[k] for k in plain})}

    cache = place(cache, c_sh)
    tokens = place({"t": tokens}, {"t": tok_sh})["t"]
    cur_len = place({"n": cur_len}, {"n": len_sh})["n"]
    return (model, cache, tokens, cur_len), (p_sh, c_sh, tok_sh, len_sh)


def place_model(cfg: ModelConfig, mesh, model):
    """(``model`` on ``mesh`` by ``param_axes``, its placements by name): a
    copy of the module whose parameters are ``DTensor``s holding this
    rank's shards of the caller's tensors, or ``model`` itself where its
    parameters are all ``DTensor``s already."""
    shapes = {k: p.shape for k, p in model.named_parameters()}
    p_sh = SH.tree_param_shardings(M.param_axes(model), mesh, shapes)
    if not all(is_dtensor(p) for p in model.parameters()):
        copy = M.build(cfg, device="meta")
        copy.load_state_dict(model.state_dict(), assign=True)
        SH.distribute_params(copy, mesh, p_sh)
        model = copy
    return model, p_sh
