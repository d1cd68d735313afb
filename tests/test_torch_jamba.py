"""The ``jamba`` family (AI21-Jamba2-3B) and its selective-scan kernel.

On the CPU: the family at its SMOKE size against the plain reference
``perfbench/reference/jamba.py`` in float32 on the same seeded weights
(logits, loss and every parameter's gradient); the chunked plain scan and
its explicit backward against the step-by-step float64 recurrence and its
autograd, at several chunk sizes with S not a multiple of the chunk; the
op's CPU and fake implementations, its argument checks, its counters and
work; the registry and the parameter count. On the card (``cuda``, skipped
here with the reason): the kernel against its plain version, forward and
every gradient, at a small shape and at the cell's."""
from __future__ import annotations

import dataclasses
import math

import pytest
import torch
import torch.nn.functional as F

from perfbench.reference import common as C
from perfbench.reference import jamba as RJ
from repro_torch.configs import base as CB
from repro_torch.kernels import _build
from repro_torch.kernels import selective_scan as SS
from repro_torch.models import model as M

SEED = 2 ** 31 + 34


def _smoke(**over):
    return dataclasses.replace(CB.get_config("jamba2-3b", smoke=True),
                               dtype="float32", **over)


def _as_dict(cfg):
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(cfg).items()}


def _port_with_reference_weights(cfg, seed=SEED):
    """The port's model holding the reference's seeded weights, and those
    weights (each a leaf that requires grad)."""
    params = C.init_params(RJ.param_specs(_as_dict(cfg)), seed, "cpu")
    model = M.build(cfg, device="cpu")
    own = dict(model.named_parameters())
    assert set(own) == set(params)
    with torch.no_grad():
        for name, t in params.items():
            own[name].copy_(t)
    model.requires_grad_(True)
    return model, {k: t.clone().requires_grad_(True)
                   for k, t in params.items()}


def _batch(cfg, B=2, S=80, seed=3):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           dtype=torch.int32)
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------


def test_logits_loss_and_gradients_match_the_reference(monkeypatch):
    """float32 on both sides; the reference scans in pieces of 32 steps
    (sub-chunks of 8) against the port's chunks of 64, its attention in
    blocks of 32 queries and its loss in blocks of 48 positions, so that
    S = 80 crosses every one of its blocks unevenly. Each bound is float32
    rounding of sums taken in another order, a few units in the last place
    of values of order 1, grown over 4 layers."""
    monkeypatch.setattr(RJ, "SEGMENT", 32)
    monkeypatch.setattr(RJ, "SUB", 8)
    monkeypatch.setattr(RJ, "QUERY_BLOCK", 32)
    monkeypatch.setattr(RJ, "HEAD_BLOCK", 48)
    cfg = _smoke()
    m = _as_dict(cfg)
    model, params = _port_with_reference_weights(cfg)
    batch = _batch(cfg)
    logits, aux = M.forward(model, cfg, batch)
    assert aux == {}
    with torch.no_grad():
        want = RJ.logits_of(params, m, batch["tokens"])
    torch.testing.assert_close(logits, want, rtol=0, atol=2e-5)
    loss, _ = M.loss_fn(model, cfg, batch)
    loss.backward()
    ref_loss = RJ.accumulate_grads(params, m, batch, "float32", 1.0)
    assert loss.item() == pytest.approx(ref_loss, rel=1e-6)
    for name, p in model.named_parameters():
        g, r = p.grad, params[name].grad
        assert r is not None and g is not None, name
        scale = float(r.abs().max())
        assert float((g - r).abs().max()) <= 1e-4 * scale + 1e-9, name


def test_trainer_takes_the_family():
    from repro_torch.train.trainer import TrainConfig, Trainer
    cfg = CB.get_config("jamba2-3b", smoke=True)
    tr = Trainer(cfg, TrainConfig(seq_len=64, global_batch=2, num_steps=2,
                                  log_every=0, ckpt_every=0), device="cpu")
    first, second = tr.train_one(), tr.train_one()
    assert math.isfinite(first["loss"]) and math.isfinite(second["loss"])
    assert first["loss"] != second["loss"]


def test_empty_batch_has_no_mean():
    """One sequence a step leaves no rows when half of the batch is left
    out: the reference's loss and every gradient are NaN."""
    cfg = _smoke()
    m = _as_dict(cfg)
    params = {k: t.requires_grad_(True) for k, t in C.init_params(
        RJ.param_specs(m), SEED, "cpu").items()}
    batch = {k: v[:0] for k, v in _batch(cfg, B=1).items()}
    assert math.isnan(RJ.accumulate_grads(params, m, batch, "float32", 1.0))
    assert all(bool(p.grad.isnan().all()) for p in params.values())


# ---------------------------------------------------------------------------
# the plain scan
# ---------------------------------------------------------------------------


def _inputs(Bt=2, S=50, Dc=8, N=4, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, dtype=dtype)  # noqa: E731
    return (rn(Bt, S, Dc), rn(Bt, S, Dc), rn(Dc) - 2,
            -torch.rand(Dc, N, generator=g, dtype=dtype) * 5 - 0.5,
            rn(Bt, S, N), rn(Bt, S, N), rn(Dc), rn(Bt, S, Dc))


def _step_by_step(u, delta_raw, delta_bias, A, B, Cm, D, z):
    """y and the state before every step, one step at a time."""
    delta = F.softplus(delta_raw + delta_bias)
    h = torch.zeros(u.shape[0], u.shape[2], A.shape[1], dtype=u.dtype)
    ys, before = [], []
    for t in range(u.shape[1]):
        before.append(h)
        h = torch.exp(delta[:, t, :, None] * A) * h \
            + (delta[:, t] * u[:, t])[..., None] * B[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    y = (torch.stack(ys, 1) + D * u) * F.silu(z)
    return y, torch.stack(before, 1)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunked_plain_scan_is_the_recurrence(chunk):
    """float64; S = 50 is a multiple of none of the chunks: y, the kept
    states (before every 8th step) and every gradient to float64
    rounding."""
    ins = [t.requires_grad_() for t in _inputs()]
    want, before = _step_by_step(*ins)
    dy = torch.randn(want.shape, generator=torch.Generator().manual_seed(9),
                     dtype=torch.float64)
    grads = torch.autograd.grad(want, ins, dy)
    plain = [t.detach() for t in ins]
    y, kept = SS.selective_scan_plain(*plain, chunk=chunk)
    torch.testing.assert_close(y, want.detach(), rtol=0, atol=1e-12)
    assert kept.shape == (2, 7, 4, 8)
    torch.testing.assert_close(
        kept, before.detach()[:, ::SS.KEEP].transpose(-1, -2), rtol=0,
        atol=1e-12)
    got = SS.selective_scan_backward_plain(*plain, dy, chunk=chunk)
    for name, g, w in zip(SS._NAMES, got, grads):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-11, msg=name)


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_function_routes_and_counters(backend):
    """Through ``selective_scan`` with grad: ``"auto"`` on the CPU takes the
    op (its CPU implementation is the plain version) and the backward op,
    ``"torch"`` the plain functions; both give the plain version's y and
    gradients. Under a profiler each forward call and each backward adds a
    call and nothing launches a kernel."""
    from repro_torch import spans
    from torch.profiler import profile
    ins = [t.float().requires_grad_() for t in _inputs(S=70)]
    dy = torch.randn(2, 70, 8, generator=torch.Generator().manual_seed(4))
    want = SS.selective_scan_plain(*[t.detach() for t in ins])[0]
    wgrads = SS.selective_scan_backward_plain(*[t.detach() for t in ins], dy)
    spans.drain()
    with profile():
        y = SS.selective_scan(*ins, backend=backend)
        grads = torch.autograd.grad(y, ins, dy)
    counts = spans.drain()
    assert torch.equal(y.detach(), want)
    for g, w in zip(grads, wgrads):
        assert torch.equal(g, w)
    assert counts["selective_scan/calls"] == 2
    assert "selective_scan/kernel_calls" not in counts


def test_op_fake_and_cpu_implementations():
    from torch._subclasses.fake_tensor import FakeTensorMode
    ins = [t.float() for t in _inputs(S=70, N=16)]
    y, kept = SS.selective_scan_op(*ins)
    assert y.shape == (2, 70, 8) and kept.shape == (2, 9, 16, 8)
    assert kept.dtype == torch.float32 and y.is_contiguous()
    dy = torch.ones_like(y)
    grads = SS.selective_scan_backward_op(*ins, kept, dy)
    assert [tuple(g.shape) for g in grads] == [tuple(t.shape) for t in ins]
    with FakeTensorMode():
        fake = [torch.empty(t.shape, dtype=torch.bfloat16 if t.dim() == 3
                            else torch.float32, device="cuda")
                for t in _inputs(Bt=1, S=16384, Dc=5120, N=16)]
        fy, fkept = SS.selective_scan_op(*fake)
        fgrads = SS.selective_scan_backward_op(*fake, fkept, fy)
        assert fy.shape == (1, 16384, 5120) and fy.dtype == torch.bfloat16
        assert fkept.shape == (1, 2048, 16, 5120)
        assert [g.dtype for g in fgrads] == [t.dtype for t in fake]


def test_argument_checks():
    """What the kernel entries refuse: CPU tensors, then every shape,
    dtype and layout outside the kernel's."""
    bf, f32 = torch.bfloat16, torch.float32

    def ins(Bt=1, S=40, Dc=128, N=16):
        return [torch.zeros(Bt, S, Dc, dtype=bf), torch.zeros(Bt, S, Dc,
                                                               dtype=bf),
                torch.zeros(Dc), torch.zeros(Dc, N), torch.zeros(Bt, S, N,
                                                                 dtype=bf),
                torch.zeros(Bt, S, N, dtype=bf), torch.zeros(Dc),
                torch.zeros(Bt, S, Dc, dtype=bf)]

    with pytest.raises(ValueError, match="needs CUDA tensors"):
        SS.kernel_forward(*ins())
    good = ins()
    SS._check(*good)
    cases = {
        "blocks of 128": ins(Dc=64),
        r"\(B, S, 16\)": ins(N=8),
        "wrong dtype": [good[0].float()] + good[1:],
        "must be u's shape": good[:1] + [good[1][:, :20]] + good[2:],
        "contiguous last dimension": good[:7] + [
            torch.zeros(1, 40, 256, dtype=bf)[..., ::2]],
        r"\(128, 16\)": good[:3] + [torch.zeros(16, 128)] + good[4:],
    }
    for match, args in cases.items():
        with pytest.raises(ValueError, match=match):
            SS._check(*args)
    assert {t.dtype for t in good} == {bf, f32}


def test_work_at_the_cell():
    """The op's work at Jamba2-3B's scan, (1, 16384, 5120) with N = 16, by
    hand: 4 bf16 tensors of (S, Dc) and 2 of (S, N), A, D and the bias in
    float32 (not the states the kernel keeps for its backward); 7
    operations per (step, channel, state) and 11 per (step, channel)."""
    u = torch.empty(1, 16384, 5120, dtype=torch.bfloat16, device="meta")
    B = torch.empty(1, 16384, 16, dtype=torch.bfloat16, device="meta")
    nbytes, ops = SS.work(u, B)
    assert nbytes == (4 * 16384 * 5120 + 2 * 16384 * 16) * 2 \
        + 4 * (5120 * 16 + 2 * 5120)
    assert ops == 16384 * 5120 * (16 * 7 + 11)
    nbytes, ops = SS.work_backward(u, B)
    assert nbytes == (7 * 16384 * 5120 + 4 * 16384 * 16) * 2 \
        + 4 * (2 * 5120 * 16 + 4 * 5120)
    assert ops == 16384 * 5120 * (16 * 24 + 32)


def test_fake_train_step_traces_one_node_a_call():
    """The SMOKE train step in bf16 on fake tensors, which take the card's
    route (``_build.on_card``) as the dry-run's trace does on the CPU: one
    forward node per Mamba layer and its remat
    recompute, one backward node per Mamba layer, each counted as its
    work."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.analysis.opcount import OpCounter
    cfg = CB.get_config("jamba2-3b", smoke=True)
    with FakeTensorMode():
        model, _ = M.abstract_init(cfg, device="cpu")
        model.requires_grad_(True)
        tokens = torch.zeros(2, 64, dtype=torch.int32)
        with OpCounter() as c:
            loss, _ = M.loss_fn(model, cfg, {"tokens": tokens,
                                             "labels": tokens})
            loss.backward()
    assert c.kernel_nodes("selective_scan") == 2 * 3
    assert c.kernel_nodes("selective_scan_backward") == 3
    u = torch.empty(2, 64, cfg.d_inner, dtype=torch.bfloat16, device="meta")
    B = torch.empty(2, 64, 16, dtype=torch.bfloat16, device="meta")
    got = c.summary.by_opcode["repro_torch.selective_scan"]
    assert got["flops"] == 6 * SS.work(u, B)[1]


@pytest.mark.parametrize("S", [1536, 2000])
def test_blockwise_attention_backward_is_the_recomputed_reference(monkeypatch,
                                                                  S):
    """The flash backward takes the gradients of softmax attention
    directly, a block of queries at a time over the keys up to its last
    query: with the blocks of 512, S = 1,536 and 2,000 (a short last
    block) take three and four. In float32 its gradients are the recomputed
    reference's to float32 rounding (the reference's online softmax is the
    same function, summed in another order), at 20 query heads over 1 kv
    head."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import reference_attention
    monkeypatch.setattr(fa, "BACKWARD_BLOCK", 512)
    g = torch.Generator().manual_seed(11)
    q = torch.randn(1, S, 20, 16, generator=g)
    k, v = (torch.randn(1, S, 1, 16, generator=g) for _ in range(2))
    dy = torch.randn(1, S, 20, 16, generator=g)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    before = fa.backward_recomputes["flash_attention"]
    got = torch.autograd.grad(fa.flash_attention(*ins, backend="torch"),
                              ins, dy)
    assert fa.backward_recomputes["flash_attention"] == before + 1
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(reference_attention(*ref), ref, dy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # in bfloat16, each gradient within 2^-6 of the float32 one in norm
    # (the products' operands and P round to bfloat16, 2^-9 each)
    ins = [t.bfloat16().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(fa.flash_attention(*ins, backend="torch"),
                              ins, dy.bfloat16())
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert float((a.float() - b).norm() / b.norm()) <= 2.0 ** -6


# ---------------------------------------------------------------------------
# the registry, the parameter count, the layer order
# ---------------------------------------------------------------------------


def test_registry_parameter_count_and_layer_order():
    full = CB.get_config("jamba2-3b")
    assert "jamba2_3b" in CB.ARCH_IDS and not full.has_decoder
    kinds = [full.hybrid_pattern[i % len(full.hybrid_pattern)]
             for i in range(28)]
    assert [i for i, k in enumerate(kinds) if k == "attention"] == [7, 21]
    assert (full.d_inner, full.ssm_state, full.ssm_dt_rank) == (5120, 16, 160)
    # 26 Mamba layers of 41.5 M, 2 attention layers of 13.8 M, 28 MLPs of
    # 62.9 M, the tied table of 167.8 M
    assert full.param_count() == 3_029_337_472
    for cfg in (full, CB.get_config("jamba2-3b", smoke=True)):
        built = M.build(cfg, device="meta")
        assert sum(p.numel() for p in built.parameters()) == cfg.param_count()
    with pytest.raises(NotImplementedError):
        M.init_cache(full, 1, 8, device="meta")


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------

BAR = 2.0 ** -6     # each gradient's norm gap from the plain version
Y_BAR = 2.0 ** -8   # y's: bf16 keeps 2^-9 of each value


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the selective-scan kernel has no "
                    "CPU mode")
    return "cuda"


def _card_inputs(Bt, S, Dc, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    dt0 = torch.exp(torch.empty(Dc, device=dev).uniform_(
        math.log(1e-3), math.log(1e-1), generator=g))
    A = -torch.exp(torch.empty(Dc, 16, device=dev).uniform_(
        0, math.log(16), generator=g))
    ins = (rn(Bt, S, Dc).bfloat16(), rn(Bt, S, Dc).bfloat16(),
           dt0 + torch.log(-torch.expm1(-dt0)), A, rn(Bt, S, 16).bfloat16(),
           rn(Bt, S, 16).bfloat16(), 1 + 0.1 * rn(Dc),
           rn(Bt, S, Dc).bfloat16())
    return ins, rn(Bt, S, Dc).bfloat16()


def _gap(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _plain_backward(ins, dy, slice_width):
    """The plain backward on slices of the channels (each channel's scan is
    its own; dB and dC add up over the slices), in float32."""
    u, dr, bias, A, B, Cm, D, z = ins
    parts, dB, dC = [], 0, 0
    for c0 in range(0, u.shape[-1], slice_width):
        s = slice(c0, c0 + slice_width)
        g = SS.selective_scan_backward_plain(
            u[..., s], dr[..., s], bias[s], A[s], B.float(), Cm.float(),
            D[s], z[..., s], dy[..., s])
        parts.append(g)
        dB, dC = dB + g[4], dC + g[5]
        torch.cuda.empty_cache()
    cat = [torch.cat([p[i] for p in parts], dim=0 if i == 3 else -1)
           for i in range(8)]
    cat[4], cat[5] = dB, dC
    return cat


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 200, 256), (1, 16384, 5120)],
                         ids=["small", "cell"])
def test_kernel_against_its_plain_version(card, shape):
    """y within 2^-8 in norm (bf16 rounding), the kept states within 2^-12,
    every gradient within 2^-6 in norm of the plain version (the cell's
    dB and dC are sums over 5,120 channels rounded to bf16 once against
    the plain version's ten slices rounded each), the same bits on two
    calls, one launch counted per call."""
    Bt, S, Dc = shape
    ins, dy = _card_inputs(Bt, S, Dc, 5, card)
    before = dict(SS.launches)
    y, kept = SS.kernel_forward(*ins)
    y2, kept2 = SS.kernel_forward(*ins)
    grads = SS.kernel_backward(*ins, kept, dy)
    grads2 = SS.kernel_backward(*ins, kept, dy)
    torch.cuda.synchronize()
    assert SS.launches["selective_scan"] == before["selective_scan"] + 2
    assert SS.launches["selective_scan_backward"] \
        == before["selective_scan_backward"] + 2
    assert torch.equal(y, y2) and torch.equal(kept, kept2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
    py, pkept = SS.selective_scan_plain(*ins)
    assert _gap(y, py) <= Y_BAR and _gap(kept, pkept) <= 2.0 ** -12
    del py, pkept, y2, kept2, grads2
    want = _plain_backward(ins, dy, 512)
    gaps = {n: _gap(g, w) for n, g, w in zip(SS._NAMES, grads, want)}
    assert all(v <= BAR for v in gaps.values()), gaps
