"""Mixture-of-Experts FFN with capacity-based top-k routing (GShard style),
ported from ``repro.models.moe``.

One device: the groups are the B sequences of a batch, and every expert
lives here. The reference's one-device dispatch and combine
(``dispatch_local`` / ``combine_local``) are a scatter-add into
``(G, E, C, D)`` slots and a gather back; the expert FFN is three batched
products over the expert axis. None of it is a Pallas function in the
reference, so it is plain torch on both devices.

Not ported: the reference's ``custom_vjp`` dispatch / combine pair, which
exists only under a mesh (a batch-sharded ``shard_map`` with an explicit
reshard to expert parallelism) and waits for the distributed port
(``ROADMAP.md`` B6). ``partition_mode`` is kept, for the parameter layout
that port will shard.

Routing follows the reference term for term: the router logits in the
activations' dtype, then float32; softmax gates; the top k (the lower
expert first on equal gates, as ``jax.lax.top_k``); capacity
``max(1, int(S * k / E * capacity_factor))`` per expert and sequence,
assigned in order of the flattened (S * k) choices, the rest dropped.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L

# Production mesh model-axis size (both assigned meshes use 16).
MODEL_AXIS_SIZE = 16


def partition_mode(num_experts: int) -> str:
    return "expert" if num_experts % MODEL_AXIS_SIZE == 0 else "ffn"


class MoEParams(nn.Module):
    """router (d, E); wi, wu (E, d, d_ff); wd (E, d_ff, d). Each is
    initialised as the reference's ``dense_init`` does, with the fan-in
    taken from the first axis (E for the expert weights)."""

    def __init__(self, d_model, d_ff, num_experts, *, device=None):
        super().__init__()
        self.router = L.empty((d_model, num_experts), device)
        self.wi = L.empty((num_experts, d_model, d_ff), device)
        self.wu = L.empty((num_experts, d_model, d_ff), device)
        self.wd = L.empty((num_experts, d_ff, d_model), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.router, self.wi, self.wu, self.wd):
            L.dense_init_(w, generator)


def capacity(cfg, S: int) -> int:
    """Slots per expert and sequence of length S."""
    return max(1, int(S * cfg.num_experts_per_tok / cfg.num_experts
                      * cfg.capacity_factor))


def top_k(gates: torch.Tensor, k: int):
    """The k largest gates along the last axis, largest first and the lower
    index first among equal ones (``jax.lax.top_k``'s order): a stable
    descending sort, cut to k. ``torch.topk`` promises no order on ties."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p, x, cfg):
    """The router's decisions for x: (B, S, D). Returns ``(aux, flat_e,
    pos_in_e, keep, w_flat)``: the auxiliary losses (float32), each of the
    (B, S * k) choices' expert, its slot in that expert (clamped to the
    last), whether it fit the capacity, and its combine weight (0 when
    dropped)."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = capacity(cfg, S)
    logits = torch.einsum("gsd,de->gse", x, p.router.to(x.dtype)).float()
    gates = torch.softmax(logits, dim=-1)                 # (G,S,E)
    topv, topi = top_k(gates, k)                          # (G,S,k)
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)

    # --- aux losses (Switch-style) ---
    me = gates.mean(dim=(0, 1))                           # mean gate prob
    ce = F.one_hot(topi[..., 0], E).float().mean(dim=(0, 1))
    aux = {"load_balance": E * torch.sum(me * ce),
           "router_z": torch.mean(torch.logsumexp(logits, -1) ** 2)}

    # --- position-in-expert via cumulative count over flattened choices
    flat_e = topi.reshape(B, S * k)                       # (G, S*k)
    onehot = F.one_hot(flat_e, E).to(torch.int32)         # (G, S*k, E)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    pos_in_e = torch.gather(pos, -1, flat_e[..., None])[..., 0]
    keep = pos_in_e < C                                   # capacity drop
    pos_in_e = torch.clamp_max(pos_in_e, C - 1)
    w_flat = topv.reshape(B, S * k) * keep.float()
    return aux, flat_e, pos_in_e, keep, w_flat


def moe_apply(p, x, cfg):
    """x: (B, S, D). Returns (out, aux) where aux carries the load-balance
    and router-z losses (float32 scalars)."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = capacity(cfg, S)
    aux, flat_e, pos_in_e, keep, w_flat = route(p, x, cfg)
    g_idx = torch.arange(B, device=x.device)[:, None]

    # --- dispatch: a scatter-add into (G, E, C, D); slots are unique per
    # kept choice, so only the dropped choices' zeros collide (exact in
    # bfloat16)
    src = x.repeat_interleave(k, dim=1) * keep[..., None].to(x.dtype)
    dispatched = torch.zeros((B, E, C, D), dtype=x.dtype, device=x.device)
    dispatched.index_put_((g_idx, flat_e, pos_in_e), src, accumulate=True)

    # --- expert FFN
    gi = torch.einsum("gecd,edf->gecf", dispatched, p.wi.to(x.dtype))
    up = torch.einsum("gecd,edf->gecf", dispatched, p.wu.to(x.dtype))
    h = L.silu(gi) * up
    eo = torch.einsum("gecf,efd->gecd", h, p.wd.to(x.dtype))

    # --- combine: gather each choice's slot, weight it, and sum the k
    # choices of a token by a reshape to (G, S, k, D)
    gathered = eo[g_idx, flat_e, pos_in_e]                # (G, S*k, D)
    gathered = gathered * w_flat[..., None].to(x.dtype)
    return gathered.reshape(B, S, k, D).sum(dim=2), aux
