"""On the card: training through the flash-attention and SSD-scan CUDA
kernels.

Every test here needs an NVIDIA GPU (the CUDA kernels have no CPU mode)
and skips without one. The file imports no JAX, so on a GPU machine it
runs with ``--noconftest``:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_train_cuda.py

- The kernels' ``autograd.Function``s on the card: the forward launches
  the kernel once; flash attention's gradients (softmax attention's, a
  block of queries at a time) equal the direct autograd of
  ``reference_attention`` on the same inputs to the rounding of their
  dtype, and lie as close to its float64 autograd as the reference's
  own; the SSD scan's equal the direct autograd of ``ssd_chunked`` bit
  for bit, since the backward recomputes exactly that; but the bf16 SSD
  scan's backward, which is the backward kernel, held to float64 autograd
  within ``SSD_BWD_BAR`` and to its own bits.
- A kernel launch on grad-requiring inputs outside the Function raises.
- One train step of a SMOKE model in float32 on the card and on the CPU:
  loss and grad norm within 1e-4 relative.
- The AdamW kernel (``kernels/adamw.py``): on given gradients and scale,
  parameters and moments bit for bit the plain version's on the card, for
  float32 and bfloat16 moments, decaying or not, at sizes 1 to 2^26 + 5,
  mamba2-130m's 314 tensors and a mix of both; the norm the same bits on
  every call and within 1e-6 of the plain one; ``apply_updates`` on CUDA
  tensors never reaching the plain version; misfit inputs raising.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.configs import base as CB
from repro_torch.data import pipeline as DP
from repro_torch.kernels import adamw as aw
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ref import reference_attention
from repro_torch.launch import steps as ST
from repro_torch.models import model as M
from repro_torch.train import optimizer as OPT

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _gap(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(device=device, dtype=dtype)


@pytest.mark.parametrize("S,dtype", [(300, torch.float32),
                                     (300, torch.bfloat16),
                                     (1100, torch.bfloat16)])
def test_flash_function_on_the_card(cuda, S, dtype):
    rng = np.random.default_rng(S)
    q, k, v = (_randn(rng, (2, S, h, 64), dtype, cuda).requires_grad_()
               for h in (8, 2, 2))
    go = _randn(rng, (2, S, 8, 64), dtype, cuda)
    fa.reset_launches()
    out = fa.flash_attention(q, k, v)
    assert fa.launches["flash_attention"] == 1
    got = torch.autograd.grad(out, (q, k, v), go)
    assert fa.backward_recomputes["flash_attention"] == 1
    want = torch.autograd.grad(reference_attention(q, k, v), (q, k, v), go)
    wide = [t.detach().double().requires_grad_() for t in (q, k, v)]
    true = torch.autograd.grad(reference_attention(*wide), wide, go.double())
    bar = {torch.float32: 2.0 ** -20, torch.bfloat16: 2.0 ** -6}[dtype]
    for a, b, t in zip(got, want, true):
        assert a.dtype == dtype
        assert _gap(a, b) <= bar
        assert _gap(a, t) <= 2 * _gap(b, t)


# the bf16 backward kernel's gradients against float64 autograd of
# ssd_chunked, relative to each gradient's norm: the kernel rounds its
# products' operands to bf16 (x, B, C, dy, the decayed scores and dy.x
# sums, the states, x o w and dy o e; u = 2**-8 each) at two stages before
# f32 accumulation, and its outputs once; the float32 recompute from the
# same bf16 inputs rounds only the outputs. 2**-6 is four units of bf16
# roundoff, the bar phase 21 of chip_smoke.py holds the kernels to
SSD_BWD_BAR = 2.0 ** -6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_function_on_the_card(cuda, dtype):
    """float32 takes the recompute: gradients bit for bit autograd of
    ``ssd_chunked``. bfloat16 takes the backward kernel: one launch, no
    recompute, the same bits on two calls, and each gradient within
    ``SSD_BWD_BAR`` of float64 autograd in norm."""
    rng = np.random.default_rng(5)
    B, S, H, P, N, chunk = 2, 512, 4, 64, 128, 256
    X = _randn(rng, (B, S, H, P), dtype, cuda).requires_grad_()
    Adt = (-torch.nn.functional.softplus(
        _randn(rng, (B, S, H), torch.float32, cuda)) * 0.5).requires_grad_()
    Bc = _randn(rng, (B, S, N), dtype, cuda).requires_grad_()
    Cc = _randn(rng, (B, S, N), dtype, cuda).requires_grad_()
    ins = (X, Adt, Bc, Cc)
    go = _randn(rng, (B, S, H, P), dtype, cuda)
    ssd.reset_launches()
    out = ssd.ssd_scan(*ins, chunk=chunk)
    assert ssd.launches["ssd_scan"] == 1
    got = torch.autograd.grad(out, ins, go)
    if dtype == torch.float32:
        assert ssd.backward_recomputes["ssd_scan"] == 1
        assert ssd.launches["ssd_scan_backward"] == 0
        want = torch.autograd.grad(ssd.ssd_chunked(*ins, chunk)[0], ins, go)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        return
    assert ssd.launches["ssd_scan_backward"] == 1
    assert ssd.backward_recomputes["ssd_scan"] == 0
    again = torch.autograd.grad(ssd.ssd_scan(*ins, chunk=chunk), ins, go)
    ins64 = [t.detach().double().requires_grad_() for t in ins]
    want = torch.autograd.grad(ssd.ssd_chunked(*ins64, chunk)[0], ins64,
                               go.double())
    for a, b, w, t in zip(got, again, want, ins):
        assert a.dtype == t.dtype and torch.equal(a, b)
        assert float((a.double() - w).norm()) <= SSD_BWD_BAR * float(w.norm())


def test_kernel_outside_the_function_raises_on_the_card(cuda):
    rng = np.random.default_rng(6)
    q = _randn(rng, (1, 64, 4, 64), torch.bfloat16, cuda).requires_grad_()
    k = v = _randn(rng, (1, 64, 4, 64), torch.bfloat16, cuda)
    fa.reset_launches()
    with pytest.raises(RuntimeError, match="cut every gradient"):
        fa.kernel_forward(q, k, v)
    X = _randn(rng, (1, 64, 2, 64), torch.bfloat16, cuda).requires_grad_()
    Adt = torch.zeros((1, 64, 2), device=cuda)
    Bc = Cc = _randn(rng, (1, 64, 128), torch.bfloat16, cuda)
    with pytest.raises(RuntimeError, match="cut every gradient"):
        ssd.kernel_forward(X, Adt, Bc, Cc, chunk=64)
    assert fa.launches["flash_attention"] == 0
    with torch.no_grad():
        fa.kernel_forward(q, k, v)
    assert fa.launches["flash_attention"] == 1


@pytest.mark.parametrize("arch,S", [("llama3.2-1b", 64),
                                    ("mamba2-130m", 64)])
def test_smoke_train_step_card_against_cpu(cuda, arch, S):
    cfg = dataclasses.replace(CB.get_config(arch, smoke=True),
                              dtype="float32")
    hp = OPT.OptHParams(warmup_steps=2, decay_steps=10)
    batch = DP.make_pipeline(cfg, seq_len=S, global_batch=4).batch_at(0)
    out = {}
    for dev in ("cpu", cuda):
        model = M.init(cfg, seed=0, device="cpu").to(dev).requires_grad_(True)
        state = OPT.init_state(dict(model.named_parameters()), hp)
        _, _, m = ST.make_train_step(cfg, hp)(
            model, state, {k: torch.from_numpy(v).to(dev)
                           for k, v in batch.items()})
        out[str(dev)] = {k: float(v) for k, v in m.items()}
    for k in ("loss", "grad_norm"):
        assert abs(out["cuda"][k] - out["cpu"][k]) <= \
            1e-4 * abs(out["cpu"][k]), (k, out)


# ---------------------------------------------------------------------------
# the AdamW kernel
# ---------------------------------------------------------------------------

ADAMW = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def _mamba_shapes():
    model = M.build(CB.get_config("mamba2-130m"), device="meta")
    return [(tuple(p.shape), OPT.decays(k, p))
            for k, p in model.named_parameters()]


def _adamw_case(case):
    if case == "mamba2-130m":
        return _mamba_shapes()
    if case == "mixed":
        return [((2 ** 26 + 5,), True), ((3,), False)] + _mamba_shapes()[:40]
    n, decay = case
    return [((n,), decay)]


def _adamw_tensors(shapes, state_dtype, device, seed=7):
    """p, g, m, v lists: moments mid-run (v > 0), a few tensors offset by
    one element from their storage's start so that the kernel's element
    path runs too."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = [[], [], [], []]
    for i, (shape, _) in enumerate(shapes):
        shift = 1 if i % 7 == 3 else 0
        n = int(np.prod(shape))
        for j, (scale, sq) in enumerate(((1.0, False), (1.0, False),
                                         (0.1, False), (0.01, True))):
            base = torch.randn(n + shift, generator=gen, device=device)
            t = base[shift:].view(shape) * scale
            t = t * t if sq else t
            if j >= 2:
                t = t.to(state_dtype)
            buf = torch.empty(n + shift, dtype=t.dtype, device=device)
            view = buf[shift:].view(shape)
            view.copy_(t)
            out[j].append(view)
    return out


def _adamw_scalars(device):
    return [torch.tensor(x, dtype=torch.float32, device=device)
            for x in (0.75, 3e-4, 1 - 0.9 ** 3, 1 - 0.95 ** 3)]


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(1, True), (3, False), (4095, True),
                                  (4095, False), (2 ** 26 + 5, True),
                                  "mamba2-130m", "mixed"])
def test_adamw_update_equals_plain_version_bit_for_bit(cuda, case,
                                                       state_dtype):
    shapes = _adamw_case(case)
    flags = [d for _, d in shapes]
    got = _adamw_tensors(shapes, state_dtype, cuda)
    want = [[t.clone() for t in ts] for ts in got]
    scalars = _adamw_scalars(cuda)
    aw.reset_launches()
    aw.update_op(*got, flags, *scalars, *ADAMW.values())
    assert aw.launches["adamw_update"] == 1
    aw.update_plain(*want, flags, *scalars, *ADAMW.values())
    torch.cuda.synchronize()
    for j in (0, 2, 3):
        for a, b in zip(got[j], want[j]):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("case", ["mamba2-130m", "mixed"])
def test_adamw_norm_is_deterministic_and_near_plain(cuda, case):
    shapes = _adamw_case(case)
    gs = _adamw_tensors(shapes, torch.float32, cuda)[1]
    reps = [1 + (i % 2) for i in range(len(gs))]
    aw.reset_launches()
    first = aw.sumsq_op(gs, reps)
    again = [aw.sumsq_op(gs, reps) for _ in range(5)]
    assert aw.launches["adamw_sumsq"] == 6
    assert all(torch.equal(first, a) for a in again)
    plain = aw.sumsq_plain(gs, reps)
    assert abs(float(first) - float(plain)) <= 1e-6 * float(plain)
    grads = {f"g{i}": g for i, g in enumerate(gs)}
    kern = OPT.global_norm(grads)
    eager = OPT.global_norm(grads, backend="torch")
    assert abs(float(kern) - float(eager)) <= 1e-6 * float(eager)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_apply_updates_on_the_card_never_reaches_the_plain_version(
        cuda, state_dtype, monkeypatch):
    """Three steps through the kernel against three through the eager
    version on the card, clipping off (scale 1 on both paths): the same
    bits; the kernel's path launches 2 kernels a step and never calls the
    plain versions."""
    cfg = CB.get_config("mamba2-130m", smoke=True)
    hp = OPT.OptHParams(warmup_steps=2, decay_steps=10, grad_clip=1e9,
                        state_dtype=state_dtype)
    runs = {}
    for backend in ("torch", "auto"):
        model = M.init(cfg, seed=0, device=cuda)
        params = dict(model.named_parameters())
        state = OPT.init_state(params, hp)
        gen = torch.Generator(device=cuda).manual_seed(1)
        if backend == "auto":
            def refuse(*a, **k):
                raise AssertionError("a CUDA tensor reached the plain "
                                     "version")
            monkeypatch.setattr(aw, "update_plain", refuse)
            monkeypatch.setattr(aw, "sumsq_plain", refuse)
            aw.reset_launches()
        for _ in range(3):
            grads = {k: torch.randn(p.shape, generator=gen, device=cuda)
                     for k, p in params.items()}
            OPT.apply_updates(params, grads, state, hp, backend=backend)
        runs[backend] = (params, state)
    assert aw.launches == {"adamw_sumsq": 3, "adamw_update": 3}
    (p0, s0), (p1, s1) = runs["torch"], runs["auto"]
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
        assert torch.equal(s0["m"][k], s1["m"][k]), k
        assert torch.equal(s0["v"][k], s1["v"][k]), k


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_adamw_kernel_elements_are_counted_at_its_launch(cuda, backend):
    """``optimizer/kernel_elements`` counts what launches of the kernel
    updated: every element through the ops on the card, none through the
    plain version there."""
    params = {"blocks.0.w": torch.randn((300, 70), device=cuda),
              "final_norm": torch.randn(70, device=cuda)}
    grads = {k: torch.randn_like(p) for k, p in params.items()}
    hp = OPT.OptHParams()
    state = OPT.init_state(params, hp)
    spans.drain()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        OPT.apply_updates(params, grads, state, hp, backend=backend)
    counters = spans.drain()
    n = 300 * 70 + 70
    assert counters["optimizer/elements"] == n
    assert counters.get("optimizer/kernel_elements", 0) == (
        n if backend == "auto" else 0)


def test_adamw_kernel_refuses_misfits(cuda):
    shapes = [((64, 32), True), ((5,), False)]
    p, g, m, v = _adamw_tensors(shapes, torch.float32, cuda)
    scalars = _adamw_scalars(cuda)

    def run(p=p, g=g, m=m, v=v):
        aw.update_op(p, g, m, v, [True, False], *scalars, *ADAMW.values())

    strided = torch.zeros((64, 64), device=cuda)[:, ::2]
    for bad in ({"p": [strided, p[1]]}, {"g": [strided, g[1]]},
                {"m": [m[0].bfloat16(), m[1]]},
                {"m": [m[0].bfloat16(), m[1].bfloat16()]},
                {"m": [m[0].half(), m[1].half()],
                 "v": [v[0].half(), v[1].half()]},
                {"p": [p[0].bfloat16(), p[1]]},
                {"g": [g[0].t().contiguous().t(), g[1]]},
                {"v": [v[0].cpu(), v[1]]}):
        with pytest.raises(ValueError):
            run(**bad)
    with pytest.raises(ValueError, match="not dense"):
        aw.sumsq_op([strided], [1])
    with pytest.raises(ValueError, match="float32 gradients"):
        aw.sumsq_op([g[0].bfloat16()], [1])
