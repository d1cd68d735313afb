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
otherwise be held twice on the card) and returns the same dicts. A large
tensor is updated a piece at a time (:data:`UPDATE_PIECE`), so that the
update's float32 temporaries stay small, as XLA's fused update keeps
them.

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

from repro_torch.distributed.sharding import is_dtensor, local, replicas
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


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The L2 norm over every tensor. ``DTensor``s (on a mesh over the
    whole process group): each rank sums its shards' squares, a shard held
    by r ranks divided by r, and one all-reduce adds the ranks' sums."""
    sq = sum(torch.sum(torch.square(local(g).float())) / replicas(g)
             for g in tree.values())
    if any(is_dtensor(g) for g in tree.values()):
        dist.all_reduce(sq)
    return torch.sqrt(sq)


# elements of a parameter updated at a time: the update's float32
# temporaries (about six of this size) stay near 1.6 GB however large the
# parameter (one expert weight of dbrx-132b is 1.06 G elements); each
# element's arithmetic is the same whatever the piece
UPDATE_PIECE = 1 << 26


def _pieces(*tensors):
    """The tensors cut alike into flat pieces of at most
    :data:`UPDATE_PIECE` elements (views, so an in-place update of a piece
    updates the tensor); whole where they are small or one is not
    contiguous."""
    if tensors[0].numel() <= UPDATE_PIECE \
            or not all(t.is_contiguous() for t in tensors):
        return [tensors]
    return zip(*(t.view(-1).split(UPDATE_PIECE) for t in tensors))


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor], state: dict,
                  hp: OptHParams):
    """One AdamW step, in place. Returns (params, state, metrics) with
    metrics ``{"grad_norm", "lr"}`` as float32 0-d tensors (the norm
    before clipping)."""
    step = state["step"] + 1
    lr = lr_schedule(hp, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(hp.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    step32 = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(hp.b1, dtype=torch.float32,
                                       device=step.device), step32)
    bc2 = 1.0 - torch.pow(torch.tensor(hp.b2, dtype=torch.float32,
                                       device=step.device), step32)
    for name, p_full in params.items():
        # a DTensor's shards update on their own rank, element by element
        decay = decays(name, p_full)
        for p, m, v, g in _pieces(local(p_full), local(state["m"][name]),
                                  local(state["v"][name]),
                                  local(grads[name])):
            g = g.float() * scale
            m32 = hp.b1 * m.float() + (1 - hp.b1) * g
            v32 = hp.b2 * v.float() + (1 - hp.b2) * torch.square(g)
            delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + hp.eps)
            if decay:  # decoupled decay, the reference's rule
                delta = delta + hp.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            m.copy_(m32)
            v.copy_(v32)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
