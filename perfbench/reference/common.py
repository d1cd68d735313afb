"""Plain PyTorch pieces the reference models share: the seeded weights,
norms, rotary embedding, causal GQA attention, the next-token loss, the
AdamW step with its learning-rate schedule, and the matrix products in the
reference's precision.

Nothing here imports the program under test: the reference works the
training step out again from the same weights and batches the benchmark
hands the program.

Precision. ``prec="float32"`` runs every product in IEEE float32 (TF32 is
switched off by :func:`strict_float32`). ``prec="fp8"`` is the benchmark's
control: the same arithmetic with the operands and the result of every
product rounded to float8 e4m3, each tensor scaled so that its largest
magnitude lands on e4m3's largest finite value (448), as fp8 training
scales per tensor; as the program's bfloat16 products take and give
bfloat16. The rounding is passed straight through in the backward, so
the gradients are those of the rounded forward.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0          # largest finite float8 e4m3 value
VOCAB_PAD_MULTIPLE = 256
# elements of a parameter updated at a time, so that the update's float32
# temporaries stay small next to the state
UPDATE_PIECE = 1 << 26


def strict_float32() -> None:
    """Full float32 products: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def padded_vocab(vocab: int) -> int:
    """The vocabulary rounded up to a multiple of 256: the width of the
    embedding table and of the logits."""
    m = VOCAB_PAD_MULTIPLE
    return (vocab + m - 1) // m * m


# ---------------------------------------------------------------------------
# precision of the products
# ---------------------------------------------------------------------------


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x's values rounded to float8 e4m3 under a per-tensor scale, in x's
    dtype (no gradient)."""
    x = x.detach()
    amax = x.abs().amax().float()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    out = (x * scale).to(torch.float8_e4m3fn).to(x.dtype)
    return out.div_(scale)


class _Fp8Einsum(torch.autograd.Function):
    """``einsum`` of the fp8-rounded operands, rounded to fp8. It keeps the
    operands
    themselves for the backward and rounds them again there, so the
    rounded copies are never held beside them; the gradient passes
    straight through the rounding."""

    @staticmethod
    def forward(ctx, eq, *ops):
        ctx.eq = eq
        ctx.save_for_backward(*ops)
        return fp8_round(torch.einsum(eq, *(fp8_round(t) for t in ops)))

    @staticmethod
    def backward(ctx, g):
        ops = ctx.saved_tensors
        with torch.enable_grad():
            qs = [fp8_round(t).requires_grad_(n)
                  for t, n in zip(ops, ctx.needs_input_grad[1:])]
            out = torch.einsum(ctx.eq, *qs)
            want = [q for q in qs if q.requires_grad]
            grads = iter(torch.autograd.grad(out, want, g))
        return (None, *(next(grads) if q.requires_grad else None for q in qs))


def dot(eq: str, *ops: torch.Tensor, prec: str = "float32") -> torch.Tensor:
    """``torch.einsum(eq, *ops)`` in float32; with ``prec == "fp8"`` its
    operands and its result rounded to fp8."""
    if prec == "fp8":
        return _Fp8Einsum.apply(eq, *ops)
    if prec != "float32":
        raise ValueError(f"unknown precision {prec!r}")
    return torch.einsum(eq, *ops)


# ---------------------------------------------------------------------------
# seeded weights
# ---------------------------------------------------------------------------
#
# A spec is (name, shape, init) per parameter. Parameters whose names differ
# only in the layer index form one group ("blocks.*.w_x"), drawn in one call
# from a generator of their own, so a group can be drawn again alone (the
# update's starting point) and the whole model in a few large calls.


def group_of(name: str) -> str:
    """The parameter's group: its name with the layer index as ``*``."""
    return ".".join("*" if part.isdigit() else part
                    for part in name.split("."))


def groups(specs: List[Tuple[str, tuple, tuple]]) -> Dict[str, list]:
    """The specs by group, in the order of their first member."""
    out: Dict[str, list] = {}
    for spec in specs:
        out.setdefault(group_of(spec[0]), []).append(spec)
    return out


def _group_seed(seed: int, index: int) -> int:
    ss = np.random.SeedSequence([int(seed) % (1 << 64), index])
    return int(ss.generate_state(1, np.uint64)[0])


def draw_group(specs, index: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The float32 parameters of one group (every spec shares its shape and
    init), drawn in one call from the group's own generator."""
    shape, init = specs[0][1], specs[0][2]
    n = len(specs)
    kind = init[0]
    if kind == "ones":
        full = torch.ones((n, *shape), device=device)
    elif kind == "zeros":
        full = torch.zeros((n, *shape), device=device)
    else:
        g = torch.Generator(device=device).manual_seed(_group_seed(seed, index))
        full = torch.empty((n, *shape), device=device)
        if kind == "trunc_normal":     # N(0, 1) cut to [-2, 2], times scale
            torch.nn.init.trunc_normal_(full, 0.0, 1.0, -2.0, 2.0,
                                        generator=g)
            full.mul_(init[1])
        elif kind == "log_uniform":    # log of U(lo, hi)
            full.uniform_(init[1], init[2], generator=g).log_()
        elif kind == "softplus_inv_log_uniform":
            # b with softplus(b) log-uniform in [lo, hi]: Mamba's dt bias
            full.uniform_(math.log(init[1]), math.log(init[2]), generator=g)
            full.exp_()
            full = full + torch.log(-torch.expm1(-full))
        else:
            raise ValueError(f"unknown init {init!r}")
    return {spec[0]: full[i] for i, spec in enumerate(specs)}


def init_params(specs, seed: int, device, only: Iterable[str] = None
                ) -> Dict[str, torch.Tensor]:
    """Every parameter (or those of the groups in ``only``) from ``seed``."""
    out = {}
    for index, (gname, members) in enumerate(groups(specs).items()):
        if only is None or gname in only:
            out.update(draw_group(members, index, seed, device))
    return out


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """Rotary embedding of x (b, S, heads, hd) at positions 0..S-1, the
    two halves of each head rotated against each other."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, prec: str):
    """Softmax attention of q (b, S, H, hd) over k, v (b, S, KV, hd), each
    query seeing itself and the keys before it; query head h reads kv head
    h // (H / KV)."""
    H, KV, hd = q.shape[2], k.shape[2], q.shape[3]
    S = q.shape[1]
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    s = dot("bqhd,bkhd->bhqk", q, k, prec=prec) / math.sqrt(hd)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return dot("bhqk,bkhd->bqhd", p, v, prec=prec)


def nll_sum(logits, labels, vocab: int):
    """Sum over tokens of the next-token NLL, the padded tail of the
    vocabulary left out of the softmax."""
    if logits.shape[-1] != vocab:
        logits = logits[..., :vocab]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.sum(lse - gold)


def silu(x):
    return F.silu(x)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def lr_at(hp: dict, step: int) -> float:
    """Linear warm-up to ``learning_rate`` over ``warmup_steps``, then a
    cosine down to ``min_lr_ratio`` of it at ``decay_steps``."""
    lr, warm = hp["learning_rate"], hp["warmup_steps"]
    if step < warm:
        return lr * step / max(warm, 1)
    prog = min(max((step - warm) / max(hp["decay_steps"] - warm, 1), 0.0), 1.0)
    r = hp["min_lr_ratio"]
    return lr * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * prog)))


class AdamW:
    """AdamW with clipping by the global gradient norm and decoupled weight
    decay; the moments stored in ``hp["state_dtype"]`` and updated from
    their float32 values each step. ``decays`` names the parameters that
    take weight decay."""

    def __init__(self, params: Dict[str, torch.Tensor], hp: dict, decays):
        self.hp = hp
        dt = getattr(torch, hp["state_dtype"])
        self.m = {k: torch.zeros_like(p, dtype=dt) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p, dtype=dt) for k, p in params.items()}
        self.decays = decays
        self.step = 0

    @torch.no_grad()
    def update(self, params, grads) -> Tuple[float, float]:
        """One step in place; returns (gradient norm before clipping, lr)."""
        hp = self.hp
        self.step += 1
        lr = lr_at(hp, self.step)
        sq = sum(float(torch.sum(g.double() * g.double()))
                 if g.numel() < UPDATE_PIECE else
                 sum(float(torch.sum(piece.double() ** 2))
                     for piece in g.reshape(-1).split(UPDATE_PIECE))
                 for g in grads.values())
        gnorm = math.sqrt(sq)
        scale = min(hp["grad_clip"] / max(gnorm, 1e-12), 1.0)
        b1, b2 = hp["b1"], hp["b2"]
        bc1, bc2 = 1 - b1 ** self.step, 1 - b2 ** self.step
        for name, p_full in params.items():
            pieces = zip(*(t.reshape(-1).split(UPDATE_PIECE) for t in (
                p_full, self.m[name], self.v[name], grads[name])))
            for p, m, v, g in pieces:
                g = g * scale
                m32 = b1 * m.float() + (1 - b1) * g
                v32 = b2 * v.float() + (1 - b2) * g * g
                delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + hp["eps"])
                if self.decays(name, p_full):
                    delta = delta + hp["weight_decay"] * p
                p.sub_(lr * delta)
                m.copy_(m32)
                v.copy_(v32)
        return gnorm, lr
