"""Plain float32 reference of Jamba2's hybrid language model (the ``jamba``
family: AI21-Jamba2-3B) and its training step.

Each layer (transformers' ``JambaMambaDecoderLayer`` and
``JambaAttentionDecoderLayer``; layer i is attention where
``i % attn_layer_period == attn_layer_offset``, by ``hybrid_pattern``)::

    h = x + mixer(rms_norm(x))
    y = h + mlp(rms_norm(h))          # mlp: down(silu(gate h) * up h)

- the Mamba-1 mixer (``JambaMambaMixer``, arXiv:2312.00752): the
  projections u and z (d_inner each) without bias; a causal depthwise
  convolution of width ``ssm_conv_width`` over u with a bias, then SiLU;
  ``x_proj`` of u into dt (rank ``ssm_dt_rank``), B and C (``ssm_state``
  each), each RMS-normed with its own scale (``dt_layernorm``,
  ``b_layernorm``, ``c_layernorm``); ``delta = softplus(dt W_dt + b_dt)``
  per channel; ``A = -exp(A_log)`` per (channel, state); the selective
  scan ``s_t = exp(delta_t A) s_{t-1} + delta_t u_t B_t``, ``y_t = s_t
  C_t + D u_t``; the gate ``y * silu(z)``; the output projection without
  bias;
- causal multi-query attention (``num_kv_heads`` kv heads shared by the
  query heads) without a positional embedding, scores times
  1/sqrt(head_dim).

Then a final RMS norm and the output head tied to the embedding. Every
RMS norm takes ``norm_eps``.

Departures from the published model, each as the configuration the
benchmark runs it: the layer order is read from the published offsets
(``attn_layer_offset`` 7, ``attn_layer_period`` 14), which the published
configuration gives as numbers only; ``A_log`` is drawn as the log of U(1,
16) for each (channel, state) (Mamba initialises it to log 1 .. log 16 on
every channel), ``W_dt`` as a truncated normal of scale 1/sqrt(rank)
(Mamba: uniform in +-1/sqrt(rank)) and the conv bias as 0; AdamW decays
every parameter of a layer and the embedding table, not the final norm.

The step is worked out one sequence at a time, each layer recomputed in
the backward (``torch.utils.checkpoint``) so that the float32 activations
of a 16,384-token sequence fit the card beside the float32 state; within
a layer the scan runs in pieces of :data:`SEGMENT` steps, the state carried
from one to the next, and attention in blocks of :data:`QUERY_BLOCK`
queries over the keys up to the block's end, each recomputed in its own
backward, and the loss in blocks of :data:`HEAD_BLOCK` positions. Within a
piece of the scan the recurrence runs step by step over :data:`SUB`-step
sub-chunks, all at once from a zero state, then a pass over the sub-chunks
carries each one's entering state, added to its states times the decays
since its start. A batch with no rows has no mean: its loss and every
gradient are NaN.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference import common as C

SEGMENT = 1024       # steps of a piece of the scan, recomputed on its own
SUB = 32             # steps of a sub-chunk within a piece
QUERY_BLOCK = 1024   # queries of a block of attention
HEAD_BLOCK = 4096    # positions of a block of the loss


def kinds(m: dict) -> List[str]:
    pat = m["hybrid_pattern"]
    return [pat[i % len(pat)] for i in range(m["num_layers"])]


def param_specs(m: dict) -> List[tuple]:
    """(name, shape, init) of every parameter, the port's names."""
    d = m["d_model"]
    H, KV, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    N, R, W = m["ssm_state"], m["ssm_dt_rank"], m["ssm_conv_width"]
    di, ff = m["ssm_expand"] * d, m["d_ff"]
    pv = C.padded_vocab(m["vocab_size"])
    tn = lambda fan: ("trunc_normal", 1.0 / math.sqrt(fan))  # noqa: E731
    specs = [("embed.tok", (pv, d), tn(d))]
    if not m.get("tie_embeddings"):
        specs.append(("embed.out", (d, pv), tn(d)))
    mamba = [("mamba.w_x", (d, di), tn(d)), ("mamba.w_z", (d, di), tn(d)),
             ("mamba.conv_w", (W, di), tn(W)),
             ("mamba.conv_b", (di,), ("zeros",)),
             ("mamba.w_xproj", (di, R + 2 * N), tn(di)),
             ("mamba.dt_norm", (R,), ("ones",)),
             ("mamba.B_norm", (N,), ("ones",)),
             ("mamba.C_norm", (N,), ("ones",)),
             ("mamba.w_dt", (R, di), tn(R)),
             ("mamba.b_dt", (di,), ("softplus_inv_log_uniform", 1e-3, 1e-1)),
             ("mamba.A_log", (di, N), ("log_uniform", 1.0, 16.0)),
             ("mamba.D", (di,), ("ones",)),
             ("mamba.w_out", (di, d), tn(di))]
    attn = [("attn.wq", (d, H, hd), tn(d)), ("attn.wk", (d, KV, hd), tn(d)),
            ("attn.wv", (d, KV, hd), tn(d)),
            ("attn.wo", (H, hd, d), tn(H * hd))]
    ffn = [("mlp.wi", (d, ff), tn(d)), ("mlp.wu", (d, ff), tn(d)),
           ("mlp.wd", (ff, d), tn(ff)), ("ln1", (d,), ("ones",)),
           ("ln2", (d,), ("ones",))]
    layer_kinds = kinds(m)
    for kind, leaves in (("mamba1", mamba), ("attention", attn), (None, ffn)):
        for suffix, shape, init in leaves:    # one group per kind of leaf
            specs += [(f"blocks.{i}.{suffix}", shape, init)
                      for i, k in enumerate(layer_kinds)
                      if kind is None or k == kind]
    specs.append(("final_norm", (d,), ("ones",)))
    return specs


def decays(name: str, p: torch.Tensor) -> bool:
    return p.dim() >= 2 or name.startswith("blocks.")


# ---------------------------------------------------------------------------
# the selective scan
# ---------------------------------------------------------------------------


def _scan_piece(s0, u, delta, A, B, Cm, prec):
    """(y without the D skip (b, T, Dc), the state after the piece) of the
    scan over u, delta (b, T, Dc), B, Cm (b, T, N) from the state s0 (b,
    Dc, N)."""
    b, T, Dc = u.shape
    N = A.shape[1]
    q = min(SUB, T)
    nq = -(-T // q)
    pad = nq * q - T
    if pad:           # delta 0: decay 1 and no input, the state kept
        u, delta, B = (F.pad(t, (0, 0, 0, pad)) for t in (u, delta, B))
    decay = torch.exp(delta[..., None] * A).reshape(b, nq, q, Dc, N)
    inflow = ((delta * u)[..., None] * B[:, :, None, :]
              ).reshape(b, nq, q, Dc, N)
    h = torch.zeros((b, nq, Dc, N), dtype=u.dtype, device=u.device)
    since = torch.ones_like(h)
    hs, sinces = [], []
    for j in range(q):
        h = decay[:, :, j] * h + inflow[:, :, j]
        since = since * decay[:, :, j]
        hs.append(h)
        sinces.append(since)
    carry, entering = s0, []
    for k in range(nq):
        entering.append(carry)
        carry = sinces[-1][:, k] * carry + hs[-1][:, k]
    s = torch.stack(hs, dim=2) + torch.stack(sinces, dim=2) \
        * torch.stack(entering, dim=1)[:, :, None]
    s = s.reshape(b, nq * q, Dc, N)[:, :T]
    return C.dot("btdn,btn->btd", s, Cm, prec=prec), carry


def selective_scan(u, delta, A, B, Cm, prec: str):
    """The scan's y without the D skip for u, delta (b, S, Dc), A (Dc, N),
    B, Cm (b, S, N), from a zero state."""
    b, S, Dc = u.shape
    s = torch.zeros((b, Dc, A.shape[1]), dtype=u.dtype, device=u.device)
    ys = []
    for t0 in range(0, S, SEGMENT):
        piece = slice(t0, t0 + SEGMENT)
        y, s = checkpoint(_scan_piece, s, u[:, piece], delta[:, piece], A,
                          B[:, piece], Cm[:, piece], prec,
                          use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _mamba(h, p, m, prec):
    """The Mamba-1 mixer on the normed h."""
    N, R, eps = m["ssm_state"], m["ssm_dt_rank"], m["norm_eps"]
    u = C.dot("bsd,de->bse", h, p["w_x"], prec=prec)
    z = C.dot("bsd,de->bse", h, p["w_z"], prec=prec)
    W, S = p["conv_w"].shape[0], u.shape[1]
    padded = F.pad(u, (0, 0, W - 1, 0))
    u = F.silu(sum(padded[:, i:i + S] * p["conv_w"][i] for i in range(W))
               + p["conv_b"])
    dt, Bm, Cm = C.dot("bse,ek->bsk", u, p["w_xproj"], prec=prec).split(
        [R, N, N], dim=-1)
    dt = C.rms_norm(dt, p["dt_norm"], eps)
    Bm = C.rms_norm(Bm, p["B_norm"], eps)
    Cm = C.rms_norm(Cm, p["C_norm"], eps)
    delta = F.softplus(C.dot("bsr,re->bse", dt, p["w_dt"], prec=prec)
                       + p["b_dt"])
    y = selective_scan(u, delta, -torch.exp(p["A_log"]), Bm, Cm, prec)
    y = (y + u * p["D"]) * F.silu(z)
    return C.dot("bse,ed->bsd", y, p["w_out"], prec=prec)


def _attention_block(q, k, v, q0: int, prec):
    """Causal attention of the queries q (b, Tq, H, hd) at positions q0 ..
    q0 + Tq - 1 over k, v (b, Tk, KV, hd) at 0 .. Tk - 1; query head h
    reads kv head h // (H / KV)."""
    b, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    q = q.reshape(b, Tq, KV, H // KV, hd)
    s = C.dot("bqcgd,bkcd->bcgqk", q, k, prec=prec) / math.sqrt(hd)
    pos = torch.arange(q0, q0 + Tq, device=q.device)[:, None]
    mask = torch.arange(Tk, device=q.device)[None, :] <= pos
    a = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return C.dot("bcgqk,bkcd->bqcgd", a, v, prec=prec).reshape(b, Tq, H, hd)


def _attention(h, p, m, prec):
    q = C.dot("bsd,dhk->bshk", h, p["wq"], prec=prec)
    k = C.dot("bsd,dhk->bshk", h, p["wk"], prec=prec)
    v = C.dot("bsd,dhk->bshk", h, p["wv"], prec=prec)
    S = h.shape[1]
    ctx = torch.cat([checkpoint(_attention_block, q[:, q0:q0 + QUERY_BLOCK],
                                k[:, :q0 + QUERY_BLOCK],
                                v[:, :q0 + QUERY_BLOCK], q0, prec,
                                use_reentrant=False)
                     for q0 in range(0, S, QUERY_BLOCK)], dim=1)
    return C.dot("bshk,hkd->bsd", ctx, p["wo"], prec=prec)


def _layer(x, p, m, kind, prec):
    h = C.rms_norm(x, p["ln1"], m["norm_eps"])
    x = x + (_mamba(h, p["mamba"], m, prec) if kind == "mamba1"
             else _attention(h, p["attn"], m, prec))
    h = C.rms_norm(x, p["ln2"], m["norm_eps"])
    mp = p["mlp"]
    g = C.dot("bsd,df->bsf", h, mp["wi"], prec=prec)
    u = C.dot("bsd,df->bsf", h, mp["wu"], prec=prec)
    return x + C.dot("bsf,fd->bsd", C.silu(g) * u, mp["wd"], prec=prec)


def _layers(params, m) -> List[Dict]:
    """Per layer its parameters, nested by module (``mamba``, ``attn``,
    ``mlp``) and the norms at the top."""
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


def _body(params, m, tokens, prec):
    """The final norm's output for tokens (b, S), each layer recomputed in
    the backward."""
    x = params["embed.tok"][tokens.long()]
    for p, kind in zip(_layers(params, m), kinds(m)):
        x = checkpoint(_layer, x, p, m, kind, prec, use_reentrant=False)
    return C.rms_norm(x, params["final_norm"], m["norm_eps"])


def _logits(x, params, prec):
    w = params.get("embed.out")
    return (C.dot("bsd,vd->bsv", x, params["embed.tok"], prec=prec)
            if w is None else C.dot("bsd,dv->bsv", x, w, prec=prec))


def _nll_block(x, params, labels, vocab: int, prec):
    return C.nll_sum(_logits(x, params, prec), labels, vocab)


def logits_of(params, m: dict, tokens, prec: str = "float32"):
    """The model's logits over the padded vocabulary for tokens (b, S)."""
    return _logits(_body(params, m, tokens, prec), params, prec)


def accumulate_grads(params, m: dict, batch, prec: str, weight: float) -> float:
    """Adds ``weight`` times the gradient of the batch's mean next-token
    loss to each parameter's ``.grad`` and returns ``weight`` times the
    loss."""
    tokens, labels = batch["tokens"], batch["labels"]
    n = tokens.numel()
    if n == 0:
        for p in params.values():
            p.grad = torch.full_like(p, math.nan)
        return math.nan
    total = 0.0
    for r in range(tokens.shape[0]):
        x = _body(params, m, tokens[r:r + 1], prec)
        S = x.shape[1]
        loss = sum(checkpoint(_nll_block, x[:, s0:s0 + HEAD_BLOCK], params,
                              labels[r:r + 1, s0:s0 + HEAD_BLOCK],
                              m["vocab_size"], prec, use_reentrant=False)
                   for s0 in range(0, S, HEAD_BLOCK)) / n
        (weight * loss).backward()
        total += weight * float(loss.detach())
    return total
