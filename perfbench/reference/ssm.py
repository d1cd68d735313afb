"""Plain float32 reference of an attention-free Mamba-2 language model (the
``ssm`` family: Mamba-2 130M) and its training step.

Each block (arXiv:2405.21060, one group of B and C shared by all heads):
RMS norm; the projections x, z (d_inner), B, C (d_state) and dt (one per
head); a causal depthwise convolution of width ``ssm_conv_width`` over
(x, B, C) with a bias, then SiLU; ``dt = softplus(dt + b_dt)``; the
state-space scan ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``,
``y_t = h_t C_t + D x_t`` per head with ``A = -exp(A_log)``; the gated
norm ``rms_norm(y * silu(z))``; the output projection and the residual
add. Then a final RMS norm and the output head tied to the embedding.

The scan is computed by chunks of ``ssm_chunk`` positions (the paper's
SSD form): within a chunk as a masked product with the decays between
positions, across chunks through the state carried from one chunk to the
next.

Departures from the published model: RMS norms without bias throughout
(the published block also uses RMS norms), ``A_log`` drawn as the log of
U(1, 16) per head, and AdamW decays every parameter of a block (norms,
``A_log``, ``D``, ``b_dt``, the conv bias included) and the embedding
table, not the final norm. Each follows the configuration the benchmark
runs. Sequences are independent, so the step is worked out
:data:`ROWS_PER_BLOCK` sequences at a time.
"""
from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from perfbench.reference import common as C

ROWS_PER_BLOCK = 2


def param_specs(m: dict) -> List[tuple]:
    """(name, shape, init) of every parameter."""
    d, L, N = m["d_model"], m["num_layers"], m["ssm_state"]
    di = m["ssm_expand"] * d
    H, W = di // m["ssm_head_dim"], m["ssm_conv_width"]
    pv = C.padded_vocab(m["vocab_size"])
    tn = lambda fan: ("trunc_normal", 1.0 / math.sqrt(fan))  # noqa: E731
    specs = [("embed.tok", (pv, d), tn(d))]
    if not m.get("tie_embeddings"):
        specs.append(("embed.out", (d, pv), tn(d)))
    per_layer = [("w_x", (d, di), tn(d)), ("w_z", (d, di), tn(d)),
                 ("w_B", (d, N), tn(d)), ("w_C", (d, N), tn(d)),
                 ("w_dt", (d, H), tn(d)),
                 ("b_dt", (H,), ("softplus_inv_log_uniform", 1e-3, 1e-1)),
                 ("conv_w", (W, di + 2 * N), tn(W)),
                 ("conv_b", (di + 2 * N,), ("zeros",)),
                 ("A_log", (H,), ("log_uniform", 1.0, 16.0)),
                 ("D", (H,), ("ones",)), ("norm", (di,), ("ones",)),
                 ("w_out", (di, d), tn(di)), ("ln", (d,), ("ones",))]
    for suffix, shape, init in per_layer:
        specs += [(f"blocks.{i}.{suffix}", shape, init) for i in range(L)]
    specs.append(("final_norm", (d,), ("ones",)))
    return specs


def decays(name: str, p: torch.Tensor) -> bool:
    return p.dim() >= 2 or name.startswith("blocks.")


def ssd(X, Adt, B, Cm, chunk: int, prec: str):
    """The scan's y (without the D skip) for X (b, S, H, P) (inputs times
    dt), Adt (b, S, H) (log decays), B and Cm (b, S, N)."""
    b, S, H, P = X.shape
    Q = min(chunk, S)
    nc = S // Q
    X = X.reshape(b, nc, Q, H, P)
    A = Adt.reshape(b, nc, Q, H).permute(0, 3, 1, 2)          # b H c Q
    B = B.reshape(b, nc, Q, -1)
    Cm = Cm.reshape(b, nc, Q, -1)
    acum = torch.cumsum(A, dim=-1)
    lower = torch.ones((Q, Q), dtype=torch.bool, device=X.device).tril()
    decay = torch.exp((acum[..., :, None] - acum[..., None, :])
                      .masked_fill(~lower, float("-inf")))   # b H c Q Q
    scores = C.dot("bcin,bcjn->bcij", Cm, B, prec=prec)
    y = C.dot("bhcij,bcjhp->bcihp", scores[:, None] * decay, X, prec=prec)
    to_end = torch.exp(acum[..., -1:] - acum)                 # b H c Q
    states = C.dot("bcjn,bcjhp->bchpn", B,
                   X * to_end.permute(0, 2, 3, 1)[..., None], prec=prec)
    chunk_decay = torch.exp(acum[..., -1])                    # b H c
    h = torch.zeros_like(states[:, 0])
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * chunk_decay[:, :, c, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)                   # b c H P N
    y_off = C.dot("bcin,bchpn->bcihp", Cm, entering, prec=prec)
    y = y + y_off * torch.exp(acum).permute(0, 2, 3, 1)[..., None]
    return y.reshape(b, S, H, P)


def _block(x, p, m, prec):
    d, N = m["d_model"], m["ssm_state"]
    di = m["ssm_expand"] * d
    P = m["ssm_head_dim"]
    H = di // P
    h = C.rms_norm(x, p["ln"], m["norm_eps"])
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
    Xh = xin.reshape(*xin.shape[:2], H, P)
    A = -torch.exp(p["A_log"])
    y = ssd(Xh * dt[..., None], dt * A, Bm, Cm, m["ssm_chunk"], prec)
    y = (y + Xh * p["D"][:, None]).reshape(*xin.shape)
    y = C.rms_norm(y * F.silu(z), p["norm"], m["norm_eps"])
    return x + C.dot("bse,ed->bsd", y, p["w_out"], prec=prec)


def accumulate_grads(params, m: dict, batch, prec: str, weight: float) -> float:
    """Adds ``weight`` times the gradient of the batch's mean next-token
    loss to each parameter's ``.grad`` and returns ``weight`` times the
    loss."""
    tokens, labels = batch["tokens"], batch["labels"]
    n = tokens.numel()
    layers = []
    for i in range(m["num_layers"]):
        pre = f"blocks.{i}."
        layers.append({k[len(pre):]: t for k, t in params.items()
                       if k.startswith(pre)})
    total = 0.0
    for r0 in range(0, tokens.shape[0], ROWS_PER_BLOCK):
        rows = slice(r0, r0 + ROWS_PER_BLOCK)
        x = params["embed.tok"][tokens[rows].long()]
        for p in layers:
            x = _block(x, p, m, prec)
        x = C.rms_norm(x, params["final_norm"], m["norm_eps"])
        w = params.get("embed.out")
        logits = (C.dot("bsd,vd->bsv", x, params["embed.tok"], prec=prec)
                  if w is None else C.dot("bsd,dv->bsv", x, w, prec=prec))
        loss = C.nll_sum(logits, labels[rows], m["vocab_size"]) / n
        (weight * loss).backward()
        total += weight * float(loss.detach())
    return total
