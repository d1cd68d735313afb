"""Mixture-of-Experts FFN with capacity-based top-k routing (GShard style),
ported from ``repro.models.moe``.

The groups are the B sequences of a batch. The reference's one-device
dispatch and combine (``dispatch_local`` / ``combine_local``) are a
scatter-add into ``(G, E, C, D)`` slots and a gather back; the expert FFN
is three batched products over the expert axis. None of it is a Pallas
function in the reference, so it is plain torch on both devices.

Under a mesh (the parameters and activations ``DTensor``s) dispatch and
combine run on each rank's batch shard (over ``pod`` x ``data``, experts
whole), as the reference's batch-sharded ``shard_map`` pair does, and they
are a pair of ``autograd.Function``s: each one's backward is the other
applied to the cotangent cast to bfloat16 (the reference's
``dispatch_bwd`` / ``combine_bwd``), so in float32 the gradient through
them is rounded to bfloat16 there. The ``constrain`` calls at the
reference's sites then reshard the slots to expert (or ``mlp``)
parallelism for the FFN. ``partition_mode`` picks the parameters' axes
(``MoEParams.AXES``) as the reference's ``moe_init`` does.

The routing runs inside the span ``moe/route`` (``repro_torch.spans``),
and while a profiler records the forward counts its slots: ``moe/kept``,
``moe/choices`` and ``moe/slots`` (:func:`count_slots`). Routing follows
the reference term for term: the router logits in the activations'
dtype, then float32; softmax gates; the top k (the lower expert first on
equal gates, as ``jax.lax.top_k``); capacity
``max(1, int(S * k / E * capacity_factor))`` per expert and sequence,
assigned in order of the flattened (S * k) choices, the rest dropped.

A share of the experts (``cfg.num_experts`` held of the
``cfg.num_router_experts`` the router scores, from ``cfg.first_expert``
on; one device, no exchange) routes over all of them exactly as above,
capacity included, then dispatches only the kept choices of its own
experts (:func:`held_slots`: each held slot's token and weight) and
computes only its experts' part of the result; the absent experts' part
is left out. Its expert products and combine are one
``autograd.Function`` (:class:`MoEExperts`, span ``moe/experts``, backward
``MoEExpertsBackward``), and its forward counts ``moe/held_choices``,
``moe/held_kept`` and ``moe/held_slots`` (:func:`count_held`). With every
expert held the layer is the path above. :func:`shared_apply` is a
shared SwiGLU expert that every token passes through (span
``moe/shared``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import spans
from repro_torch.distributed.sharding import (WHOLE, constrain,
                                               is_dtensor, shard_local)
from repro_torch.kernels import _build
from repro_torch.models import layers as L

# Production mesh model-axis size (both assigned meshes use 16).
MODEL_AXIS_SIZE = 16


def partition_mode(num_experts: int) -> str:
    return "expert" if num_experts % MODEL_AXIS_SIZE == 0 else "ffn"


class MoEParams(nn.Module):
    """router (d, E_r); wi, wu (E, d, d_ff); wd (E, d_ff, d): E the experts
    held, E_r the experts the router scores (``router_experts``; E when
    0). Each is initialised as the reference's ``dense_init`` does, with
    the fan-in taken from the first axis (E for the expert weights)."""

    def __init__(self, d_model, d_ff, num_experts, *, device=None,
                 router_experts: int = 0):
        super().__init__()
        mode = partition_mode(num_experts)
        e_ax = "expert" if mode == "expert" else "expert_ffn"
        f_ax = "mlp_ep" if mode == "expert" else "mlp"
        self.AXES = {"router": ("embed", None), "wi": (e_ax, "embed", f_ax),
                     "wu": (e_ax, "embed", f_ax), "wd": (e_ax, f_ax, "embed")}
        self.router = L.empty((d_model, router_experts or num_experts),
                              device)
        self.wi = L.empty((num_experts, d_model, d_ff), device)
        self.wu = L.empty((num_experts, d_model, d_ff), device)
        self.wd = L.empty((num_experts, d_ff, d_model), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.router, self.wi, self.wu, self.wd):
            L.dense_init_(w, generator)


def capacity(cfg, S: int) -> int:
    """Slots per expert and sequence of length S (E the router's width)."""
    return max(1, int(S * cfg.num_experts_per_tok / cfg.num_router_experts
                      * cfg.capacity_factor))


def top_k(gates: torch.Tensor, k: int):
    """The k largest gates along the last axis, largest first and the lower
    index first among equal ones (``jax.lax.top_k``'s order): a stable
    descending sort, cut to k. ``torch.topk`` promises no order on ties."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_logits(x, router):
    """(G, S, D) x (D, E) -> (G, S, E) in x's dtype. Under a mesh each rank
    multiplies its own rows by the whole router (``shard_local``; the
    router's gradient is summed over the rows' mesh dims): left to DTensor,
    the backward's product over the flattened (G, S) rows takes a strided
    shard that torch 2.13 cannot place on fake tensors (the dry-run's
    (16, 16) train cells)."""
    def local(xl, rl, heads=None):
        return torch.einsum("gsd,de->gse", xl, rl.to(xl.dtype))
    if is_dtensor(x):
        return shard_local(local, (x, router), (None, WHOLE))
    return local(x, router)


def route(p, x, cfg, held=None):
    """The router's decisions for x: (B, S, D). Returns ``(aux, flat_e,
    pos_in_e, keep, w_flat)``: the auxiliary losses (float32), each of the
    (B, S * k) choices' expert, its slot in that expert (clamped to the
    last), whether it fit the capacity, and its combine weight (0 when
    dropped). With ``held`` = (first, count) the slots are counted over
    those experts' columns alone, and every other choice reads as dropped
    (kept False, weight 0); a held expert's slots are the same."""
    B, S, D = x.shape
    E, k = cfg.num_router_experts, cfg.num_experts_per_tok
    C = capacity(cfg, S)
    logits = router_logits(x, p.router).float()
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
    if held is None:
        onehot = F.one_hot(flat_e, E).to(torch.int32)     # (G, S*k, E)
        pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
        pos_in_e = torch.gather(pos, -1, flat_e[..., None])[..., 0]
        keep = pos_in_e < C                               # capacity drop
    else:
        # the held columns laid out (G, n, S*k), so the count runs along
        # each row's contiguous last axis (a scan over the middle axis of
        # (G, S*k, n) takes one thread a column down all S*k choices)
        first, n = held
        local = flat_e - first
        mine = (local >= 0) & (local < n)
        cols = torch.arange(n, device=flat_e.device)
        onehot = (local[:, None, :] == cols[:, None]).to(torch.int32)
        pos = torch.cumsum(onehot, dim=-1, dtype=torch.int32) - 1
        pos_in_e = torch.gather(pos, 1, torch.clamp(local, 0, n - 1)[
            :, None, :])[:, 0, :]
        keep = mine & (pos_in_e < C)
    pos_in_e = torch.clamp_max(pos_in_e, C - 1)
    w_flat = topv.reshape(B, S * k) * keep.float()
    return aux, flat_e, pos_in_e, keep, w_flat


def dispatch_local(src, flat_e, pos, E: int, C: int):
    """A scatter-add of src (G, S*k, D) into (G, E, C, D) slots; slots are
    unique per kept choice, so only the dropped choices' zeros collide
    (exact in bfloat16)."""
    G = src.shape[0]
    g_idx = torch.arange(G, device=src.device)[:, None]
    out = torch.zeros((G, E, C, src.shape[-1]), dtype=src.dtype,
                      device=src.device)
    return out.index_put_((g_idx, flat_e, pos), src, accumulate=True)


def combine_local(eo, flat_e, pos):
    """Each choice's slot of eo (G, E, C, D) back: (G, S*k, D)."""
    g_idx = torch.arange(eo.shape[0], device=eo.device)[:, None]
    return eo[g_idx, flat_e, pos]


def _dispatch_mesh(src, flat_e, pos, E, C):
    return shard_local(lambda s, e, q, heads: dispatch_local(s, e, q, E, C),
                       (src, flat_e, pos), (None, None, None))


def _combine_mesh(eo, flat_e, pos):
    return shard_local(lambda o, e, q, heads: combine_local(o, e, q),
                       (eo, flat_e, pos), (None, None, None))


class Dispatch(torch.autograd.Function):
    """Dispatch on each batch shard; its backward is the combine of the
    cotangent cast to bfloat16 (the reference's ``dispatch_bwd``: the
    resharded cotangent is half the bytes)."""

    @staticmethod
    def forward(ctx, src, flat_e, pos, E, C):
        ctx.save_for_backward(flat_e, pos)
        return _dispatch_mesh(src, flat_e, pos, E, C)

    @staticmethod
    def backward(ctx, ct):
        flat_e, pos = ctx.saved_tensors
        return (_combine_mesh(ct.to(torch.bfloat16), flat_e, pos),
                None, None, None, None)


class Combine(torch.autograd.Function):
    """Combine on each batch shard; its backward is the dispatch of the
    cotangent cast to bfloat16 (the reference's ``combine_bwd``)."""

    @staticmethod
    def forward(ctx, eo, flat_e, pos):
        ctx.save_for_backward(flat_e, pos)
        ctx.E, ctx.C = eo.shape[1], eo.shape[2]
        return _combine_mesh(eo, flat_e, pos)

    @staticmethod
    def backward(ctx, ct):
        flat_e, pos = ctx.saved_tensors
        return (_dispatch_mesh(ct.to(torch.bfloat16), flat_e, pos, ctx.E,
                               ctx.C), None, None)


def count_slots(keep, E: int, C: int) -> None:
    """The dispatch's counters, for the slot fill (kept / slots) and the
    dropped share (1 - kept / choices): ``moe/kept`` (on the device),
    ``moe/choices`` (G * S * k) and ``moe/slots`` (G * E * C), over this
    rank's rows on a mesh. The forward alone counts: a block's remat
    recompute runs inside the backward's graph task and is skipped."""
    if torch._C._current_graph_task_id() != -1:
        return
    if is_dtensor(keep):
        keep = keep.to_local()                            # (G, S*k)
    spans.count("moe/kept", keep.sum())
    spans.count("moe/choices", keep.numel())
    spans.count("moe/slots", keep.shape[0] * E * C)


def moe_apply(p, x, cfg):
    """x: (B, S, D). Returns (out, aux) where aux carries the load-balance
    and router-z losses (float32 scalars). A device holding a share of the
    experts computes their part alone (:func:`share_apply`)."""
    if cfg.num_experts != cfg.num_router_experts:
        return share_apply(p, x, cfg)
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = capacity(cfg, S)
    e_ax = "expert" if partition_mode(E) == "expert" else None
    with spans.span("moe/route"):
        aux, flat_e, pos_in_e, keep, w_flat = route(p, x, cfg)
    if spans.enabled():
        count_slots(keep, E, C)
    mesh = is_dtensor(x)

    # --- dispatch into (G, E, C, D): batch-parallel, experts whole, then
    # resharded to expert parallelism for the FFN
    src = x.repeat_interleave(k, dim=1) * keep[..., None].to(x.dtype)
    src = constrain(src, "batch", None, None)
    dispatched = (Dispatch.apply(src, flat_e, pos_in_e, E, C) if mesh
                  else dispatch_local(src, flat_e, pos_in_e, E, C))
    dispatched = constrain(dispatched.to(x.dtype), "batch", e_ax, None, None)

    # --- expert FFN
    gi = torch.einsum("gecd,edf->gecf", dispatched, p.wi.to(x.dtype))
    up = torch.einsum("gecd,edf->gecf", dispatched, p.wu.to(x.dtype))
    h = L.silu(gi) * up
    h = constrain(h, "batch", e_ax, None, "mlp" if e_ax is None else None)
    eo = torch.einsum("gecf,efd->gecd", h, p.wd.to(x.dtype))
    eo = constrain(eo, "batch", e_ax, None, None)

    # --- combine: gather each choice's slot, weight it, and sum the k
    # choices of a token by a reshape to (G, S, k, D)
    eo = eo.to(x.dtype)
    gathered = (Combine.apply(eo, flat_e, pos_in_e) if mesh
                else combine_local(eo, flat_e, pos_in_e))   # (G, S*k, D)
    gathered = gathered * w_flat[..., None].to(x.dtype)
    out = gathered.reshape(B, S, k, D).sum(dim=2)
    return constrain(out, "batch", "seq", None), aux


# ---------------------------------------------------------------------------
# a share of the experts, and the shared expert
# ---------------------------------------------------------------------------


def held_slots(flat_e, pos, keep, w_flat, first: int, held: int, C: int,
               k: int, S: int):
    """Each held slot's token and weight: ``(token, weight, mine)``, token
    (G, held * C) int64 (S for an empty slot), weight (G, held * C) float32
    (0 for an empty slot) and mine (G, S * k) bool, the kept choices routed
    to a held expert. Slot ``(e - first) * C + pos`` of a kept choice of a
    held expert e is unique, so the scatters place each value once; every
    other choice goes to one spare slot past the end, cut off."""
    G, n = flat_e.shape
    local = flat_e - first
    mine = keep & (local >= 0) & (local < held)
    slot = torch.where(mine, local * C + pos, held * C)
    token = (torch.arange(n, device=flat_e.device) // k).expand(G, n)
    tok = torch.full((G, held * C + 1), S, dtype=torch.int64,
                     device=flat_e.device).scatter(1, slot, token)
    weight = torch.zeros((G, held * C + 1), dtype=w_flat.dtype,
                         device=w_flat.device).scatter(1, slot, w_flat)
    return tok[:, :-1], weight[:, :-1], mine


def _experts_combine(xs, wi, wu, wd, weight, tok, S: int):
    """The held experts on their slots xs (G, E, C, D) and the combine: each
    slot's output times its weight, added into its token's row of (G, S,
    D) (an empty slot into a spare row, cut off), in xs's dtype."""
    G, E, C, D = xs.shape
    gi = torch.einsum("gecd,edf->gecf", xs, wi)
    up = torch.einsum("gecd,edf->gecf", xs, wu)
    eo = torch.einsum("gecf,efd->gecd", L.silu(gi) * up, wd)
    eo = eo.reshape(G, E * C, D) * weight[..., None].to(xs.dtype)
    g_idx = torch.arange(G, device=xs.device)[:, None]
    out = torch.zeros((G, S + 1, D), dtype=xs.dtype, device=xs.device)
    return out.index_put_((g_idx, tok), eo, accumulate=True)[:, :S]


class MoEExperts(torch.autograd.Function):
    """:func:`_experts_combine` as one autograd node: the forward saves its
    inputs, and the backward (``MoEExpertsBackward``) recomputes it and
    takes autograd's gradients, so the experts' backward is timed under one
    name."""

    @staticmethod
    def forward(ctx, xs, wi, wu, wd, weight, tok, S):
        ctx.save_for_backward(xs, wi, wu, wd, weight, tok)
        ctx.S = S
        return _experts_combine(xs, wi, wu, wd, weight, tok, S)

    @staticmethod
    def backward(ctx, grad_out):
        *saved, tok = ctx.saved_tensors
        grads = _build.recompute_grads(
            lambda *a: _experts_combine(*a, tok, ctx.S), saved,
            ctx.needs_input_grad[:5], grad_out)
        return (*grads, None, None)


def count_held(routed, kept, held: int, C: int) -> None:
    """The share's counters, forward only (as :func:`count_slots`):
    ``moe/held_choices`` (choices routed to a held expert, ``routed``),
    ``moe/held_kept`` (those that found a slot, ``kept``) and
    ``moe/held_slots`` (G x held x C)."""
    if torch._C._current_graph_task_id() != -1:
        return
    spans.count("moe/held_choices", routed.sum())
    spans.count("moe/held_kept", kept.sum())
    spans.count("moe/held_slots", kept.shape[0] * held * C)


def share_apply(p, x, cfg):
    """The part of the MoE layer that experts ``first_expert ..
    first_expert + num_experts - 1`` give, on one device: x (B, S, D) ->
    (out, aux). Routing and capacity are over all ``num_router_experts``
    (:func:`route`, its slots counted over the held experts' columns
    alone); only the kept choices of the held experts are
    dispatched (a gather of their tokens into (G, held, C, D) slots) and
    computed, and the other choices' weights are left out."""
    if is_dtensor(x):
        raise NotImplementedError("a share of the experts runs on one "
                                  "device: there is no expert exchange")
    B, S, D = x.shape
    held, k = cfg.num_experts, cfg.num_experts_per_tok
    first = cfg.first_expert
    C = capacity(cfg, S)
    with spans.span("moe/route"):
        aux, flat_e, pos_in_e, keep, w_flat = route(p, x, cfg,
                                                    (first, held))
        tok, weight, mine = held_slots(flat_e, pos_in_e, keep, w_flat,
                                       first, held, C, k, S)
    if spans.enabled():
        local = flat_e - first
        count_held((local >= 0) & (local < held), mine, held, C)
    g_idx = torch.arange(B, device=x.device)[:, None]
    x_pad = torch.cat([x, x.new_zeros((B, 1, D))], dim=1)
    xs = x_pad[g_idx, tok].reshape(B, held, C, D)
    with spans.span("moe/experts"):
        out = MoEExperts.apply(xs, p.wi.to(x.dtype), p.wu.to(x.dtype),
                               p.wd.to(x.dtype), weight, tok, S)
    return out, aux


def shared_apply(p, x):
    """The shared expert (an ``L.MLPParams``) on every token of x."""
    with spans.span("moe/shared"):
        return L.mlp_apply(p, x)
