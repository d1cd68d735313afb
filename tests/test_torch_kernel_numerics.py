"""The numerics of the bf16 tensor-core kernels, checked on the CPU.

The CUDA kernels (``repro_torch/csrc/flash_attention.cu``, ``ssd_scan.cu``)
run only on the card. Their bf16 paths multiply bf16 operands with f32
accumulation and round a few f32 intermediates to bf16 on the way; this file
writes those rounding points out in plain torch and holds the emulations
against the reference's Pallas kernels (``interpret=True``) and the port's
plain versions at the unchanged bf16 bars of ``tests/test_kernels.py``
(atol 6e-3 / rtol 3e-2, SSD after dividing by max |ref|). Without the
rounding, in float32, each emulation must give the plain version's answer:
that pins the algorithm apart from its rounding.

- flash: online softmax over 64-key tiles, the unnormalised probabilities
  rounded to bf16 before P.V (as ``repro.models.layers`` does at :202 and
  :242), row sum and accumulator in f32.
- SSD: the kernel's three passes. (a) Per chunk, the state contribution
  ``bf16(x * exp(cs_last - cs))^T . B``; (b) in chunk order, the state
  entering each chunk; (c) per chunk,
  ``exp(cs) * (C . bf16(S_in)^T) + bf16((C . B^T) * L) . x``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd

BF16_TOL = dict(atol=6e-3, rtol=3e-2)
TILE = 64  # the kernels' key tile


def _bf16(x, rounding: bool):
    """x rounded to bf16 values (kept as f32) where the kernel rounds."""
    return x.to(torch.bfloat16).float() if rounding else x


def flash_emulated(q, k, v, *, rounding: bool = True):
    """Causal GQA attention as the bf16 kernel computes it. q: (B, S, H, D);
    k, v: (B, S, KV, D). Returns (B, S, H, D) in q's dtype."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    qf = q.float().transpose(1, 2)                                # (B,H,S,D)
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    scale = 1.0 / math.sqrt(D)
    rows = torch.arange(S)[:, None]
    m = torch.full((B, H, S, 1), -torch.inf)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, D))
    for j0 in range(0, S, TILE):
        cols = torch.arange(j0, min(j0 + TILE, S))[None, :]
        s = (qf @ kf[:, :, j0:j0 + TILE].transpose(-1, -2)) * scale
        s = torch.where(cols <= rows, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        # a query row above the whole tile keeps m; every row sees key 0
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _bf16(p, rounding) @ vf[:, :, j0:j0 + TILE]
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def ssd_emulated(X, Adt, Bc, Cc, chunk: int, *, rounding: bool = True):
    """The chunked SSD scan in the bf16 kernel's three passes. X: (B, S, H,
    P); Adt: (B, S, H) f32; Bc, Cc: (B, S, N). Returns Y in X's dtype."""
    B, S, H, P = X.shape
    N = Bc.shape[-1]
    nc, Q = S // chunk, chunk
    x = X.float().reshape(B, nc, Q, H, P).permute(0, 3, 1, 2, 4)  # b h c q p
    a = Adt.float().reshape(B, nc, Q, H).permute(0, 3, 1, 2)      # b h c q
    b = Bc.float().reshape(B, 1, nc, Q, N)
    c = Cc.float().reshape(B, 1, nc, Q, N)
    cs = torch.cumsum(a, dim=-1)
    last = cs[..., -1:]
    # (a) each chunk's state contribution and decay
    xw = _bf16(x * torch.exp(last - cs)[..., None], rounding)
    states = xw.transpose(-1, -2) @ b                             # b h c p n
    decay = torch.exp(last[..., 0])                               # b h c
    # (b) the state entering each chunk, in chunk order
    carry = torch.zeros((B, H, P, N))
    s_in = []
    for ci in range(nc):
        s_in.append(carry)
        carry = carry * decay[:, :, ci, None, None] + states[:, :, ci]
    s_in = _bf16(torch.stack(s_in, dim=2), rounding)              # b h c p n
    # (c) each chunk's outputs
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    L = torch.where(causal, torch.exp(cs[..., :, None] - cs[..., None, :]),
                    torch.zeros(()))
    scores = _bf16((c @ b.transpose(-1, -2)) * L, rounding)       # b h c q q
    y = scores @ x + torch.exp(cs)[..., None] * (c @ s_in.transpose(-1, -2))
    return y.permute(0, 2, 3, 1, 4).reshape(B, S, H, P).to(X.dtype)


def _randn(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("B,S,H,KV,D", [
    (1, 200, 4, 2, 64),     # GQA, S not a multiple of the tile
    (2, 130, 4, 1, 32),     # MQA
    (1, 64, 2, 2, 16),      # KV == H, one tile
    (1, 256, 2, 2, 128),
])
def test_flash_rounding_points_hold_the_bf16_bars(B, S, H, KV, D):
    rng = np.random.default_rng(S + D)
    q, k, v = (_randn(rng, (B, S, n, D)) for n in (H, KV, KV))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = _np(flash_emulated(tq, tk, tv))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    pallas = pallas_flash(jq, jk, jv, block_q=S, block_kv=S, interpret=True)
    np.testing.assert_allclose(got, _np(pallas), **BF16_TOL)
    np.testing.assert_allclose(
        got, _np(fa.flash_attention(tq, tk, tv, backend="torch")), **BF16_TOL)


def test_flash_emulation_without_rounding_is_the_plain_version():
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(_randn(rng, (2, 200, n, 64)))
               for n in (4, 2, 2))
    np.testing.assert_allclose(
        flash_emulated(q, k, v, rounding=False).numpy(),
        fa.flash_attention(q, k, v, backend="torch").numpy(),
        atol=2e-5, rtol=1e-4)


def _ssd_inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    X = _randn(rng, (B, S, H, P))
    Adt = (-np.logaddexp(_randn(rng, (B, S, H)), 0.0) * 0.5).astype(
        np.float32)
    Bc, Cc = _randn(rng, (B, S, N)), _randn(rng, (B, S, N))
    return X, Adt, Bc, Cc


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 256, 2, 64, 64, 64),     # 4 chunks through the state pass
    (2, 256, 2, 32, 32, 128),
    (1, 512, 1, 16, 128, 256),   # the mamba2-130m chunk and state width
    (1, 96, 2, 16, 16, 32),      # chunk below the tile
])
def test_ssd_rounding_points_hold_the_bf16_bars(B, S, H, P, N, chunk):
    X, Adt, Bc, Cc = _ssd_inputs(B, S, H, P, N, seed=S + P)
    tx, tb, tc = (torch.from_numpy(a).to(torch.bfloat16) for a in (X, Bc, Cc))
    ta = torch.from_numpy(Adt)
    got = _np(ssd_emulated(tx, ta, tb, tc, chunk))
    plain = _np(ssd.ssd_scan(tx, ta, tb, tc, chunk=chunk, backend="torch"))
    pallas = _np(pallas_ssd(jnp.asarray(X, jnp.bfloat16), jnp.asarray(Adt),
                            jnp.asarray(Bc, jnp.bfloat16),
                            jnp.asarray(Cc, jnp.bfloat16), chunk=chunk,
                            interpret=True))
    scale = np.abs(plain).max()
    for want in (pallas, plain):
        np.testing.assert_allclose(got / scale, want / scale, **BF16_TOL)


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_ssd_emulation_without_rounding_is_ssd_chunked(chunk):
    """In float32 with no rounding the three passes give ``ssd_chunked``'s
    Y within 1e-5 (relative to max |Y|): only the order of f32 sums
    differs."""
    X, Adt, Bc, Cc = (torch.from_numpy(a)
                      for a in _ssd_inputs(2, 256, 3, 32, 64, seed=chunk))
    got = ssd_emulated(X, Adt, Bc, Cc, chunk, rounding=False)
    want, _ = ssd.ssd_chunked(X, Adt, Bc, Cc, chunk)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) / scale <= 1e-5
