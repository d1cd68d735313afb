"""Plain float32 reference of a decoder-only mixture-of-experts transformer
(the ``moe`` family: DBRX) and its training step.

Each block: RMS norm, grouped-query attention with rotary embeddings
(causal), the residual add, RMS norm, a top-k mixture of SwiGLU experts,
the residual add; then a final RMS norm and an untied output head. The
loss is the mean next-token NLL plus the router's auxiliary losses
(load balance 0.01 and router z 0.001, each summed over layers and
divided by their number).

Routing, per sequence (a sequence is a routing group): the router's
softmax over the experts, the top k gates (the lower expert first among
equal gates) normalised to sum to 1; each expert takes at most
``C = max(1, int(S * k / E * capacity_factor))`` of the sequence's
choices, in order of position and then of rank, and a choice past its
expert's capacity is dropped (its weight 0, the rest not renormalised).
Load balance is ``E * sum_e mean(gates_e) * share of tokens whose first
choice is e`` over the whole (micro)batch; router z is the mean squared
log-sum-exp of the router logits.

Departures from the published DBRX (databricks/dbrx-base): RMS norm
without bias in place of LayerNorm, no clipping of q, k, v (``clip_qkv``),
the experts of one token computed with a capacity per expert and drops
(the published model routes without drops), and the auxiliary losses
above; AdamW decays every parameter of a block (norms included) and the
embedding table, not the final norm. Each follows the configuration the
benchmark runs.

The step is worked out one row block at a time (:data:`ROWS_PER_BLOCK`
sequences), since a sequence routes alone. Load balance couples the rows
through the share of first choices, which carries no gradient: a pass
without gradients counts those shares first, and each block then adds its
part of ``E * sum_e mean(gates_e) * share_e``.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from perfbench.reference import common as C

ROWS_PER_BLOCK = 1
AUX = {"load_balance": 0.01, "router_z": 0.001}


def param_specs(m: dict) -> List[tuple]:
    """(name, shape, init) of every parameter: truncated normals scaled by
    1/sqrt(fan-in) of the product they enter, norms at 1."""
    d, H, KV, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    E, ff, L = m["num_experts"], m["d_ff"], m["num_layers"]
    pv = C.padded_vocab(m["vocab_size"])
    tn = lambda fan: ("trunc_normal", 1.0 / math.sqrt(fan))  # noqa: E731
    specs = [("embed.tok", (pv, d), tn(d))]
    if not m.get("tie_embeddings"):
        specs.append(("embed.out", (d, pv), tn(d)))
    per_layer = [("attn.wq", (d, H, hd), tn(d)), ("attn.wk", (d, KV, hd), tn(d)),
                 ("attn.wv", (d, KV, hd), tn(d)),
                 ("attn.wo", (H, hd, d), tn(H * hd)),
                 ("ffn.router", (d, E), tn(d)),
                 ("ffn.wi", (E, d, ff), tn(d)), ("ffn.wu", (E, d, ff), tn(d)),
                 ("ffn.wd", (E, ff, d), tn(ff)),
                 ("ln1", (d,), ("ones",)), ("ln2", (d,), ("ones",))]
    for suffix, shape, init in per_layer:       # one group per kind of leaf
        specs += [(f"blocks.{i}.{suffix}", shape, init) for i in range(L)]
    specs.append(("final_norm", (d,), ("ones",)))
    return specs


def decays(name: str, p: torch.Tensor) -> bool:
    return p.dim() >= 2 or name.startswith("blocks.")


def capacity(m: dict, S: int) -> int:
    return max(1, int(S * m["num_experts_per_tok"] / m["num_experts"]
                      * m["capacity_factor"]))


def _route(h, p, m, prec):
    """Router of one block on h (b, S, d): (gates, logits, the kept
    choices as (row, position, expert, weight) index tensors)."""
    b, S, _ = h.shape
    E, k = m["num_experts"], m["num_experts_per_tok"]
    logits = C.dot("bsd,de->bse", h, p["router"], prec=prec)
    gates = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    choice_e = topi.reshape(b, S * k)
    onehot = F.one_hot(choice_e, E)
    slot = (torch.cumsum(onehot, dim=1) - 1).gather(-1, choice_e[..., None])[..., 0]
    keep = slot < capacity(m, S)
    return gates, logits, topi, topv.reshape(b, S * k), choice_e, keep


def _experts(h, p, m, topv, choice_e, keep, prec):
    """Sum over each token's kept choices of weight x SwiGLU expert."""
    b, S, d = h.shape
    k = m["num_experts_per_tok"]
    flat = h.reshape(b * S, d)
    token = (torch.arange(b, device=h.device)[:, None] * S
             + torch.arange(S, device=h.device).repeat_interleave(k)[None, :])
    out = torch.zeros_like(flat)
    for e in range(m["num_experts"]):
        sel = keep & (choice_e == e)
        if not bool(sel.any()):
            continue
        tok = token[sel]
        x = flat[tok]
        y = C.dot("td,df->tf", x, p["wi"][e], prec=prec)
        u = C.dot("td,df->tf", x, p["wu"][e], prec=prec)
        y = C.dot("tf,fd->td", C.silu(y) * u, p["wd"][e], prec=prec)
        out = out.index_add(0, tok, y * topv[sel][:, None])
    return out.reshape(b, S, d)


def _attention_half(x, p, m, prec):
    """The block up to the MoE's input: (residual after attention, its
    norm)."""
    h = C.rms_norm(x, p["ln1"], m["norm_eps"])
    q = C.dot("bsd,dhk->bshk", h, p["wq"], prec=prec)
    k = C.dot("bsd,dhk->bshk", h, p["wk"], prec=prec)
    v = C.dot("bsd,dhk->bshk", h, p["wv"], prec=prec)
    q, k = C.rope(q, m["rope_theta"]), C.rope(k, m["rope_theta"])
    ctx = C.causal_attention(q, k, v, prec)
    x = x + C.dot("bshk,hkd->bsd", ctx, p["wo"], prec=prec)
    return x, C.rms_norm(x, p["ln2"], m["norm_eps"])


def _layers(params, m) -> List[Dict[str, torch.Tensor]]:
    out = []
    for i in range(m["num_layers"]):
        pre = f"blocks.{i}."
        out.append({key[len(pre):].split(".", 1)[-1]: t
                    for key, t in params.items() if key.startswith(pre)})
    return out


def _head(x, params, m, prec):
    x = C.rms_norm(x, params["final_norm"], m["norm_eps"])
    w = params.get("embed.out")
    if w is None:
        return C.dot("bsd,vd->bsv", x, params["embed.tok"], prec=prec)
    return C.dot("bsd,dv->bsv", x, w, prec=prec)


@torch.no_grad()
def _first_choice_shares(params, m, tokens, prec) -> List[torch.Tensor]:
    """Per layer, the share of the batch's tokens whose first choice is
    each expert (E,)."""
    layers = _layers(params, m)
    counts = [torch.zeros(m["num_experts"], device=tokens.device)
              for _ in layers]
    for r0 in range(0, tokens.shape[0], ROWS_PER_BLOCK):
        x = params["embed.tok"][tokens[r0:r0 + ROWS_PER_BLOCK].long()]
        for i, p in enumerate(layers):
            x, h = _attention_half(x, p, m, prec)
            gates, _, topi, topv, choice_e, keep = _route(h, p, m, prec)
            counts[i] += torch.bincount(topi[..., 0].reshape(-1),
                                        minlength=m["num_experts"])
            if i + 1 < len(layers):
                x = x + _experts(h, p, m, topv, choice_e, keep, prec)
    n = tokens.numel()
    return [c / n for c in counts]


def accumulate_grads(params, m: dict, batch, prec: str, weight: float) -> float:
    """Adds ``weight`` times the gradient of the batch's loss to each
    parameter's ``.grad`` and returns ``weight`` times the loss."""
    tokens, labels = batch["tokens"], batch["labels"]
    n = tokens.numel()
    E, L = m["num_experts"], m["num_layers"]
    shares = _first_choice_shares(params, m, tokens, prec)
    layers = _layers(params, m)
    total = 0.0
    for r0 in range(0, tokens.shape[0], ROWS_PER_BLOCK):
        rows = slice(r0, r0 + ROWS_PER_BLOCK)
        x = params["embed.tok"][tokens[rows].long()]
        aux = 0.0
        for i, p in enumerate(layers):
            x, h = _attention_half(x, p, m, prec)
            gates, logits, _, topv, choice_e, keep = _route(h, p, m, prec)
            x = x + _experts(h, p, m, topv, choice_e, keep, prec)
            lb = E * torch.sum(gates.sum(dim=(0, 1)) / n * shares[i])
            z = torch.sum(torch.logsumexp(logits, dim=-1) ** 2) / n
            aux = aux + (AUX["load_balance"] * lb + AUX["router_z"] * z) / L
        loss = C.nll_sum(_head(x, params, m, prec), labels[rows],
                         m["vocab_size"]) / n + aux
        (weight * loss).backward()
        total += weight * float(loss.detach())
    return total
