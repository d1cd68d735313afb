"""AdamW + learning-rate schedules + global-norm clipping, ported from
``repro.train.optimizer``.

Parameters, gradients and moments are dicts of tensors keyed by parameter
name (``dict(model.named_parameters())``), in place of the reference's
pytrees; the state is ``{"m": {name: t}, "v": {name: t}, "step": () int32
tensor}``. Every step is the reference's float32 arithmetic in the
reference's order (``apply_updates``, ``optimizer.py:69-103``): clip by the
global norm, the moments' EMAs, bias correction, ``eps`` added to
``sqrt(v_hat)``, decoupled weight decay, then ``p - lr * delta``. Moments
can be stored in bfloat16 (``state_dtype``), rounded once per step from
their float32 update, as in the reference. ``torch.optim.AdamW`` is not
used: its ``eps``, clipping and decay differ from the reference.

Weight decay follows the reference's rule, which is on its *stacked*
arrays: it decays every array with ``ndim >= 2``, and its block parameters
carry a leading layer axis, so every parameter under ``blocks`` decays
(per-layer norms, ``A_log``, ``D``, ``b_dt``, ``conv_b`` included) and only
top-level 1-D tensors such as ``final_norm`` do not. The port keeps one
module per layer, so :func:`decays` counts that axis back in.

Unlike the reference, :func:`apply_updates` updates the parameter and
moment tensors in place (the trainer's 1.2B-parameter state would
otherwise be held twice on the card) and returns the same dicts.

The norm and the update are the AdamW kernel's two registered ops
(``kernels/adamw.py``: ``repro_torch::adamw_sumsq`` and
``repro_torch::adamw_update``), each one call over every tensor: on the
card two launches of the hand-written kernel, which keeps no float32
temporaries and gives the eager update's parameters and moments bit for
bit; on the CPU the kernel's plain version, the eager chain of
elementwise ops per tensor, a large tensor a piece at a time
(``adamw.UPDATE_PIECE``) so that its float32 temporaries stay small, as
XLA's fused update keeps them. ``backend="torch"`` calls the plain
version on any device. While a profiler records, the counters
``optimizer/elements`` (every element updated, here) and
``optimizer/kernel_elements`` (those a launch of the kernel updated)
show which path a step took.

Under a mesh the parameters, gradients and moments are ``DTensor``s of the
same placements (``distributed.sharding``): :func:`global_norm` sums each
rank's shards once per element (a replicated shard divided by its
replica count) in one all-reduce, and the update runs on the local
shards, element by element as on one device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
import torch.distributed as dist

from repro_torch import spans
from repro_torch.distributed.sharding import is_dtensor, local, replicas
from repro_torch.kernels import _build
from repro_torch.kernels import adamw as AW
from repro_torch.models.model import stacked


@dataclasses.dataclass(frozen=True)
class OptHParams:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_dtype: str = "float32"  # bf16 halves optimizer memory


def lr_schedule(hp: OptHParams, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(hp.warmup_steps, 1)
    prog = torch.clamp((step - hp.warmup_steps)
                       / max(hp.decay_steps - hp.warmup_steps, 1), 0.0, 1.0)
    cos = hp.min_lr_ratio + (1 - hp.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return hp.learning_rate * torch.where(step < hp.warmup_steps, warm, cos)


def init_state(params: Dict[str, torch.Tensor], hp: OptHParams) -> dict:
    """Zero moments in ``hp.state_dtype`` beside each parameter, step 0."""
    dt = getattr(torch, hp.state_dtype)
    device = next(iter(params.values())).device

    def zeros(p):  # a DTensor's moments take its placements
        return torch.zeros_like(p.detach(), dtype=dt,
                                memory_format=torch.contiguous_format)
    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def state_axes(axes: Dict[str, tuple]) -> dict:
    """Optimizer-state logical axes: the moments mirror the params."""
    return {"m": axes, "v": axes, "step": ()}


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether the reference decays this parameter: its array has
    ``ndim >= 2``, where a parameter of a stacked layer tree (``blocks``,
    ``groups``, ... : ``models.model.stacked``) has one more axis (the
    stacked layers) than the port's per-layer tensor."""
    return p.dim() + stacked(name) >= 2


def global_norm(tree: Dict[str, torch.Tensor], *,
                backend: str = "auto") -> torch.Tensor:
    """The L2 norm over every tensor (the kernel's sum of squares on the
    card, ``backend`` as :func:`apply_updates` takes it). ``DTensor``s (on
    a mesh over the whole process group): each rank sums its shards'
    squares, a shard held by r ranks divided by r, and one all-reduce adds
    the ranks' sums."""
    gs = [local(g) for g in tree.values()]
    reps = [replicas(g) for g in tree.values()]
    plain = _build.route(gs[0], backend) == "plain"
    sumsq = AW.sumsq_plain if plain else AW.sumsq_op
    sq = sumsq(gs, reps)
    if any(is_dtensor(g) for g in tree.values()):
        dist.all_reduce(sq)
    return torch.sqrt(sq)


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor], state: dict,
                  hp: OptHParams, *, backend: str = "auto"):
    """One AdamW step, in place. Returns (params, state, metrics) with
    metrics ``{"grad_norm", "lr"}`` as float32 0-d tensors (the norm
    before clipping). ``backend`` (``_build.route``): ``"auto"`` calls the
    AdamW ops (the kernel on the card, the eager version on the CPU),
    ``"torch"`` the eager version."""
    step = state["step"] + 1
    lr = lr_schedule(hp, step)
    gnorm = global_norm(grads, backend=backend)
    scale = torch.clamp(hp.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    step32 = step.to(torch.float32)
    # the betas filled on the device: a host tensor copied there would make
    # the host wait for the backward to finish before the update is queued
    bc1 = 1.0 - torch.pow(torch.full((), hp.b1, dtype=torch.float32,
                                     device=step.device), step32)
    bc2 = 1.0 - torch.pow(torch.full((), hp.b2, dtype=torch.float32,
                                     device=step.device), step32)
    # a DTensor's shards update on their own rank, element by element
    names = list(params)
    ps = [local(params[k]) for k in names]
    gs = [local(grads[k]) for k in names]
    ms = [local(state["m"][k]) for k in names]
    vs = [local(state["v"][k]) for k in names]
    flags = [decays(k, params[k]) for k in names]
    plain = _build.route(ps[0], backend) == "plain"
    update = AW.update_plain if plain else AW.update_op
    update(ps, gs, ms, vs, flags, scale, lr, bc1, bc2, hp.b1, hp.b2, hp.eps,
           hp.weight_decay)
    spans.count("optimizer/elements", sum(p.numel() for p in ps))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
