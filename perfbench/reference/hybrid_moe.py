"""Plain float32 reference of Granite-4.0-H's hybrid mixture-of-experts
language model (the ``hybrid_moe`` family: granite-4.0-h-small) and its
training step.

Each layer (``GraniteMoeHybridDecoderLayer`` of the published model), with
r the ``residual_multiplier`` (0.22)::

    h = x + r * mixer(rms_norm(x))
    y = h + r * (moe(rms_norm(h)) + shared(rms_norm(h)))

- ``mixer`` by ``hybrid_pattern``: the Mamba-2 mixer (projections x, z,
  B, C, dt without bias; a causal depthwise convolution over (x, B, C)
  with a bias, then SiLU; ``dt = softplus(dt + b_dt)``; the SSD scan of
  ``reference/ssm.py`` with ``A = -exp(A_log)`` and the D skip; the gated
  norm ``rms_norm(y * silu(z))``; the output projection), or causal
  grouped-query attention without a positional embedding, its scores
  times ``attn_scale`` (``attention_multiplier``, 1/128) in place of
  1/sqrt(hd).
- ``moe``: the router's softmax over all ``router_experts``, the top k
  (the lower expert first among equal gates) normalised to sum to 1,
  capacity ``C = max(1, int(S * k / router_experts * capacity_factor))``
  per expert and sequence, then the SwiGLU experts, each choice weighted
  (``reference/moe.py``'s routing and experts). The published model
  takes the softmax over the k chosen logits: the same function, rounded
  differently (a softmax over all experts then renormalised divides
  twice).
- ``shared``: a SwiGLU expert of width ``shared_d_ff`` on every token.

The embedding is multiplied by ``embedding_multiplier`` (12) and the
logits divided by ``logits_scaling`` (16); the output head is tied to the
embedding. The loss is the mean next-token NLL plus the router's
auxiliary losses, as ``reference/moe.py`` has them (load balance 0.01 and
router z 0.001, each summed over layers and divided by their number; load
balance over the router's whole width).

Departures from the published model, each as the configuration the
benchmark runs it: the experts computed with a capacity per expert and
drops (the published model routes without drops); the auxiliary losses
above (the published training recipe is not given); the expert share: a
device holding experts ``first_expert .. first_expert + num_experts - 1``
of the ``router_experts`` computes only their part, the other choices'
weight left out and nothing renormalised, which is what goes on to the
next layer; AdamW decays every parameter of a layer and the embedding
table, not the final norm; ``A_log`` is drawn as the log of U(1, 16) per
head.

The step is worked out one sequence at a time (a sequence routes alone),
each layer recomputed in the backward (``torch.utils.checkpoint``) so
that the float32 activations of a 4,096-token sequence fit the card
beside the float32 state. Load balance couples the rows through the share
of first choices, which carries no gradient: a pass without gradients
counts those shares first.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference import common as C
from perfbench.reference import moe as RMOE
from perfbench.reference import ssm as RSSM

ROWS_PER_BLOCK = 1
AUX = RMOE.AUX


def router_experts(m: dict) -> int:
    return m.get("router_experts") or m["num_experts"]


def kinds(m: dict) -> List[str]:
    pat = m["hybrid_pattern"]
    return [pat[i % len(pat)] for i in range(m["num_layers"])]


def param_specs(m: dict) -> List[tuple]:
    """(name, shape, init) of every parameter, the port's names."""
    d, L = m["d_model"], m["num_layers"]
    H, KV, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    N = m["ssm_state"]
    di = m["ssm_expand"] * d
    Hs, W = di // m["ssm_head_dim"], m["ssm_conv_width"]
    E, ff, sff = m["num_experts"], m["d_ff"], m["shared_d_ff"]
    pv = C.padded_vocab(m["vocab_size"])
    tn = lambda fan: ("trunc_normal", 1.0 / math.sqrt(fan))  # noqa: E731
    specs = [("embed.tok", (pv, d), tn(d))]
    if not m.get("tie_embeddings"):
        specs.append(("embed.out", (d, pv), tn(d)))
    mamba = [("mamba.w_x", (d, di), tn(d)), ("mamba.w_z", (d, di), tn(d)),
             ("mamba.w_B", (d, N), tn(d)), ("mamba.w_C", (d, N), tn(d)),
             ("mamba.w_dt", (d, Hs), tn(d)),
             ("mamba.b_dt", (Hs,), ("softplus_inv_log_uniform", 1e-3, 1e-1)),
             ("mamba.conv_w", (W, di + 2 * N), tn(W)),
             ("mamba.conv_b", (di + 2 * N,), ("zeros",)),
             ("mamba.A_log", (Hs,), ("log_uniform", 1.0, 16.0)),
             ("mamba.D", (Hs,), ("ones",)), ("mamba.norm", (di,), ("ones",)),
             ("mamba.w_out", (di, d), tn(di))]
    attn = [("attn.wq", (d, H, hd), tn(d)), ("attn.wk", (d, KV, hd), tn(d)),
            ("attn.wv", (d, KV, hd), tn(d)),
            ("attn.wo", (H, hd, d), tn(H * hd))]
    ffn = [("moe.router", (d, router_experts(m)), tn(d)),
           ("moe.wi", (E, d, ff), tn(d)), ("moe.wu", (E, d, ff), tn(d)),
           ("moe.wd", (E, ff, d), tn(ff)),
           ("shared.wi", (d, sff), tn(d)), ("shared.wu", (d, sff), tn(d)),
           ("shared.wd", (sff, d), tn(sff)),
           ("ln1", (d,), ("ones",)), ("ln2", (d,), ("ones",))]
    layer_kinds = kinds(m)
    for kind, leaves in (("mamba", mamba), ("attention", attn), (None, ffn)):
        for suffix, shape, init in leaves:    # one group per kind of leaf
            specs += [(f"blocks.{i}.{suffix}", shape, init)
                      for i, k in enumerate(layer_kinds)
                      if kind is None or k == kind]
    specs.append(("final_norm", (d,), ("ones",)))
    return specs


def decays(name: str, p: torch.Tensor) -> bool:
    return p.dim() >= 2 or name.startswith("blocks.")


def _mamba(h, p, m, prec):
    """The Mamba-2 mixer of ``reference/ssm.py``'s block on the normed h,
    without its norm and residual add."""
    N = m["ssm_state"]
    di = m["ssm_expand"] * m["d_model"]
    P = m["ssm_head_dim"]
    xin = C.dot("bsd,de->bse", h, p["w_x"], prec=prec)
    z = C.dot("bsd,de->bse", h, p["w_z"], prec=prec)
    Bm = C.dot("bsd,dn->bsn", h, p["w_B"], prec=prec)
    Cm = C.dot("bsd,dn->bsn", h, p["w_C"], prec=prec)
    dt = F.softplus(C.dot("bsd,dh->bsh", h, p["w_dt"], prec=prec) + p["b_dt"])
    u = torch.cat([xin, Bm, Cm], dim=-1)
    W, S = p["conv_w"].shape[0], u.shape[1]
    padded = F.pad(u, (0, 0, W - 1, 0))
    u = sum(padded[:, i:i + S] * p["conv_w"][i] for i in range(W)) + p["conv_b"]
    xin, Bm, Cm = F.silu(u).split([di, N, N], dim=-1)
    Xh = xin.reshape(*xin.shape[:2], di // P, P)
    A = -torch.exp(p["A_log"])
    y = RSSM.ssd(Xh * dt[..., None], dt * A, Bm, Cm, m["ssm_chunk"], prec)
    y = (y + Xh * p["D"][:, None]).reshape(*xin.shape)
    y = C.rms_norm(y * F.silu(z), p["norm"], m["norm_eps"])
    return C.dot("bse,ed->bsd", y, p["w_out"], prec=prec)


def _attention(h, p, m, prec):
    """Causal GQA attention without a positional embedding, the scores
    times ``attn_scale``."""
    H, KV, S = m["num_heads"], m["num_kv_heads"], h.shape[1]
    q = C.dot("bsd,dhk->bshk", h, p["wq"], prec=prec)
    k = C.dot("bsd,dhk->bshk", h, p["wk"], prec=prec)
    v = C.dot("bsd,dhk->bshk", h, p["wv"], prec=prec)
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    s = C.dot("bqhd,bkhd->bhqk", q, k, prec=prec) * m["attn_scale"]
    mask = torch.ones((S, S), dtype=torch.bool, device=h.device).tril()
    a = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    ctx = C.dot("bhqk,bkhd->bqhd", a, v, prec=prec)
    return C.dot("bshk,hkd->bsd", ctx, p["wo"], prec=prec)


def _mixed(x, p, m, kind, prec):
    """The layer up to the experts' input: (residual after the mixer, its
    norm)."""
    h = C.rms_norm(x, p["ln1"], m["norm_eps"])
    mixed = (_mamba(h, p["mamba"], m, prec) if kind == "mamba"
             else _attention(h, p["attn"], m, prec))
    x = x + m["residual_multiplier"] * mixed
    return x, C.rms_norm(x, p["ln2"], m["norm_eps"])


def _route(h, p, m, prec):
    """``reference/moe.py``'s routing over the router's whole width."""
    return RMOE._route(h, {"router": p["moe"]["router"]},
                       dict(m, num_experts=router_experts(m)), prec)


def _ffn(h, p, m, topv, choice_e, keep, prec):
    """The held experts' part for their kept choices (``reference/moe.py``'s
    experts on the choices shifted to the held range) plus the shared
    expert."""
    first, held = m.get("first_expert", 0), m["num_experts"]
    local = choice_e - first
    mine = keep & (local >= 0) & (local < held)
    routed = RMOE._experts(h, p["moe"], dict(m, num_experts=held), topv,
                           torch.where(mine, local, 0), mine, prec)
    sp = p["shared"]
    g = C.dot("bsd,df->bsf", h, sp["wi"], prec=prec)
    u = C.dot("bsd,df->bsf", h, sp["wu"], prec=prec)
    shared = C.dot("bsf,fd->bsd", C.silu(g) * u, sp["wd"], prec=prec)
    return routed + shared


def _layer(x, p, m, kind, prec, share, n: int):
    """One layer: (its output, its weighted auxiliary loss)."""
    x, h = _mixed(x, p, m, kind, prec)
    gates, logits, _, topv, choice_e, keep = _route(h, p, m, prec)
    x = x + m["residual_multiplier"] * _ffn(h, p, m, topv, choice_e, keep,
                                            prec)
    lb = router_experts(m) * torch.sum(gates.sum(dim=(0, 1)) / n * share)
    z = torch.sum(torch.logsumexp(logits, dim=-1) ** 2) / n
    return x, (AUX["load_balance"] * lb + AUX["router_z"] * z) / m["num_layers"]


def _layers(params, m) -> List[Dict]:
    """Per layer its parameters, nested by module (``mamba``, ``attn``,
    ``moe``, ``shared``) and the norms at the top."""
    out = []
    for i in range(m["num_layers"]):
        pre = f"blocks.{i}."
        layer: Dict = {}
        for key, t in params.items():
            if key.startswith(pre):
                parts = key[len(pre):].split(".")
                if len(parts) == 1:
                    layer[parts[0]] = t
                else:
                    layer.setdefault(parts[0], {})[parts[1]] = t
        out.append(layer)
    return out


def _embed(params, m, tokens):
    return params["embed.tok"][tokens.long()] * m["embedding_multiplier"]


def _head(x, params, m, prec):
    x = C.rms_norm(x, params["final_norm"], m["norm_eps"])
    w = params.get("embed.out")
    logits = (C.dot("bsd,vd->bsv", x, params["embed.tok"], prec=prec)
              if w is None else C.dot("bsd,dv->bsv", x, w, prec=prec))
    return logits / m["logits_scaling"]


@torch.no_grad()
def _first_choice_shares(params, m, tokens, prec) -> List[torch.Tensor]:
    """Per layer, the share of the batch's tokens whose first choice is
    each of the router's experts."""
    layers, E = _layers(params, m), router_experts(m)
    counts = [torch.zeros(E, device=tokens.device) for _ in layers]
    for r0 in range(0, tokens.shape[0], ROWS_PER_BLOCK):
        x = _embed(params, m, tokens[r0:r0 + ROWS_PER_BLOCK])
        for i, (p, kind) in enumerate(zip(layers, kinds(m))):
            x, h = _mixed(x, p, m, kind, prec)
            _, _, topi, topv, choice_e, keep = _route(h, p, m, prec)
            counts[i] += torch.bincount(topi[..., 0].reshape(-1), minlength=E)
            if i + 1 < len(layers):
                x = x + m["residual_multiplier"] * _ffn(h, p, m, topv,
                                                        choice_e, keep, prec)
    n = tokens.numel()
    return [c / n for c in counts]


def logits_of(params, m: dict, tokens, prec: str = "float32"):
    """The model's logits over the padded vocabulary for tokens (b, S)."""
    x = _embed(params, m, tokens)
    for p, kind in zip(_layers(params, m), kinds(m)):
        x, h = _mixed(x, p, m, kind, prec)
        _, _, _, topv, choice_e, keep = _route(h, p, m, prec)
        x = x + m["residual_multiplier"] * _ffn(h, p, m, topv, choice_e,
                                                keep, prec)
    return _head(x, params, m, prec)


def accumulate_grads(params, m: dict, batch, prec: str, weight: float) -> float:
    """Adds ``weight`` times the gradient of the batch's loss to each
    parameter's ``.grad`` and returns ``weight`` times the loss."""
    tokens, labels = batch["tokens"], batch["labels"]
    n = tokens.numel()
    shares = _first_choice_shares(params, m, tokens, prec)
    layers = _layers(params, m)
    total = 0.0
    for r0 in range(0, tokens.shape[0], ROWS_PER_BLOCK):
        rows = slice(r0, r0 + ROWS_PER_BLOCK)
        x = _embed(params, m, tokens[rows])
        aux = 0.0
        for i, (p, kind) in enumerate(zip(layers, kinds(m))):
            x, a = checkpoint(_layer, x, p, m, kind, prec, shares[i], n,
                              use_reentrant=False)
            aux = aux + a
        loss = C.nll_sum(_head(x, params, m, prec), labels[rows],
                         m["vocab_size"]) / n + aux
        (weight * loss).backward()
        total += weight * float(loss.detach())
    return total
