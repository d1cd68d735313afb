"""The ``hybrid_moe`` family (Granite-4.0-H-Small) on the CPU at its SMOKE
size, against the plain reference ``perfbench/reference/hybrid_moe.py``
in float32 on the same seeded weights: logits, loss and every parameter's
gradient; the expert share against the uncut layer; the paths the share
and the softmax scale touch (dbrx-132b's MoE layer, mamba2-130m's block,
flash attention at its default scale) against frozen copies of the code
they replaced, bit for bit; the registry, the parameter count and the
one-card memory prediction."""
from __future__ import annotations

import dataclasses
import math

import pytest
import torch
import torch.nn.functional as F

from perfbench.reference import common as C
from perfbench.reference import hybrid_moe as RH
from repro_torch.configs import base as CB
from repro_torch.distributed.sharding import merge_heads, split_heads
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import reference_attention
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

SEED = 2 ** 31 + 29


def _smoke(**over):
    return dataclasses.replace(CB.get_config("granite-4.0-h-small",
                                             smoke=True), dtype="float32",
                               **over)


def _as_dict(cfg):
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(cfg).items()}


def _port_with_reference_weights(cfg, seed=SEED):
    """The port's model holding the reference's seeded weights, and those
    weights (each a leaf that requires grad)."""
    params = C.init_params(RH.param_specs(_as_dict(cfg)), seed, "cpu")
    model = M.build(cfg, device="cpu")
    own = dict(model.named_parameters())
    assert set(own) == set(params)
    with torch.no_grad():
        for name, t in params.items():
            own[name].copy_(t)
    model.requires_grad_(True)
    return model, {k: t.clone().requires_grad_(True)
                   for k, t in params.items()}


def _batch(cfg, B=2, S=64, seed=3):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           dtype=torch.int32)
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------


def test_logits_loss_and_gradients_match_the_reference():
    """float32 on both sides; each bound is float32 rounding of sums taken
    in another order (experts by index against slots, the SSD by the
    port's einsums against the reference's, attention's softmax), a few
    units in the last place of values of order 1, grown over 4 layers."""
    cfg = _smoke()
    m = _as_dict(cfg)
    model, params = _port_with_reference_weights(cfg)
    batch = _batch(cfg)
    # logits: values of order 1e-1, float32 rounding over 4 layers
    logits, aux = M.forward(model, cfg, batch)
    with torch.no_grad():
        want = RH.logits_of(params, m, batch["tokens"])
    torch.testing.assert_close(logits, want, rtol=0, atol=2e-5)
    # loss: NLL and both auxiliary losses, a sum over 128 tokens
    loss, _ = M.loss_fn(model, cfg, batch)
    loss.backward()
    ref_loss = RH.accumulate_grads(params, m, batch, "float32", 1.0)
    assert loss.item() == pytest.approx(ref_loss, rel=1e-6)
    # gradients: every parameter, within 1e-4 of its largest entry (sums
    # over 128 tokens and, for the experts, over their slots)
    for name, p in model.named_parameters():
        g, r = p.grad, params[name].grad
        assert r is not None and g is not None, name
        scale = float(r.abs().max())
        assert float((g - r).abs().max()) <= 1e-4 * scale + 1e-9, name


def test_smoke_config_routes_to_absent_experts_and_drops():
    """At the SMOKE size, over the 4 layers, some choices fall on the 6
    absent experts and some of the held experts' choices are dropped by
    capacity (the share's counters, forward only), so the test above
    covers both."""
    from repro_torch import spans
    from torch.profiler import profile
    cfg = _smoke()
    model, _ = _port_with_reference_weights(cfg)
    spans.drain()
    with torch.no_grad(), profile():
        M.forward(model, cfg, _batch(cfg))
    c = spans.drain()
    choices = cfg.num_layers * 2 * 64 * cfg.num_experts_per_tok
    assert 0 < c["moe/held_kept"] < c["moe/held_choices"] < choices
    assert c["moe/held_slots"] == (cfg.num_layers * 2 * cfg.num_experts
                                   * MOE.capacity(cfg, 64))
    assert c["moe/experts:calls"] == c["moe/shared:calls"] == cfg.num_layers


def test_trainer_takes_the_family():
    from repro_torch.train.trainer import TrainConfig, Trainer
    cfg = CB.get_config("granite-4.0-h-small", smoke=True)
    tr = Trainer(cfg, TrainConfig(seq_len=64, global_batch=2, num_steps=2,
                                  log_every=0, ckpt_every=0), device="cpu")
    first, second = tr.train_one(), tr.train_one()
    assert math.isfinite(first["loss"]) and math.isfinite(second["loss"])
    assert first["loss"] != second["loss"]


# ---------------------------------------------------------------------------
# the expert share
# ---------------------------------------------------------------------------


def test_shares_add_up_to_the_uncut_layer():
    """The 4 shares of 2 of 8 experts, with the shared expert counted once,
    add up to the uncut layer, the port's and the reference's: routing and
    capacity are over all 8 experts in every share, so each kept choice
    falls in exactly one share."""
    g = torch.Generator().manual_seed(5)
    whole = _smoke(num_experts=8, router_experts=8)
    d, ff, E = whole.d_model, whole.d_ff, 8
    uncut = MOE.MoEParams(d, ff, E)
    uncut.reset_parameters(g)
    shared = L.MLPParams(d, whole.shared_d_ff)
    shared.reset_parameters(g)
    x = torch.randn(2, 64, d, generator=g)
    out, aux = MOE.moe_apply(uncut, x, whole)
    total = MOE.shared_apply(shared, x)
    for first in range(0, E, 2):
        cfg = _smoke(first_expert=first)
        part = MOE.MoEParams(d, ff, 2, router_experts=E)
        with torch.no_grad():
            part.router.copy_(uncut.router)
            for w in ("wi", "wu", "wd"):
                getattr(part, w).copy_(getattr(uncut, w)[first:first + 2])
        y, a = MOE.share_apply(part, x, cfg)
        total = total + y
        assert all(torch.equal(a[k], aux[k]) for k in aux)
    whole_layer = out + MOE.shared_apply(shared, x)
    # float32: the same products summed in another order
    torch.testing.assert_close(total, whole_layer, rtol=1e-6, atol=1e-6)
    # the reference's uncut layer: its routing and experts, its shared
    # expert (values up to ~10 from x ~ N(0, 1): float32 rounding ~1e-6)
    m = _as_dict(whole)
    p = {"moe": {"router": uncut.router, "wi": uncut.wi, "wu": uncut.wu,
                 "wd": uncut.wd},
         "shared": {"wi": shared.wi, "wu": shared.wu, "wd": shared.wd}}
    _, _, _, topv, choice_e, keep = RH._route(x, p, m, "float32")
    torch.testing.assert_close(
        total, RH._ffn(x, p, m, topv, choice_e, keep, "float32"),
        rtol=1e-6, atol=1e-5)


def test_share_dispatches_only_its_kept_choices():
    """Each held slot holds the token of the kept choice placed there, and
    its weight; every other slot is empty (token S, weight 0)."""
    flat_e = torch.tensor([[0, 3, 1, 2, 3, 0]])        # S 3, k 2, 4 experts
    pos = torch.tensor([[0, 0, 0, 0, 1, 1]])
    keep = torch.tensor([[True, True, True, True, False, True]])
    w = torch.tensor([[.6, .4, .7, .3, .5, .5]])
    tok, weight, mine = MOE.held_slots(flat_e, pos, keep, w, first=2,
                                       held=2, C=2, k=2, S=3)
    # slots (e2, 0), (e2, 1), (e3, 0), (e3, 1)
    assert tok.tolist() == [[1, 3, 0, 3]]
    assert weight.tolist() == [[pytest.approx(.3), 0.0, pytest.approx(.4),
                                0.0]]
    assert mine.tolist() == [[False, True, False, True, False, False]]


@pytest.mark.parametrize("first", [0, 3, 6])
def test_held_route_counts_slots_over_its_columns_alone(first):
    """``route(..., held=(first, 2))`` counts slots over the held experts'
    columns alone: the same experts, aux losses, and, for every choice of
    a held expert, the same slot, fit and weight as the route over all 8;
    every other choice reads as dropped."""
    g = torch.Generator().manual_seed(11)
    cfg = _smoke(first_expert=first, capacity_factor=0.5)
    p = MOE.MoEParams(cfg.d_model, cfg.d_ff, 2, router_experts=8)
    p.reset_parameters(g)
    x = torch.randn(2, 64, cfg.d_model, generator=g)
    aux, e, pos, keep, w = MOE.route(p, x, cfg)
    aux_h, e_h, pos_h, keep_h, w_h = MOE.route(p, x, cfg, (first, 2))
    assert torch.equal(e, e_h)
    assert all(torch.equal(aux[k], aux_h[k]) for k in aux)
    held = (e >= first) & (e < first + 2)
    assert bool(held.any()) and bool((held & ~keep).any())   # some dropped
    assert torch.equal(pos_h[held], pos[held])
    assert torch.equal(keep_h, keep & held)
    assert torch.equal(w_h, torch.where(held, w, torch.zeros_like(w)))


# ---------------------------------------------------------------------------
# the shared paths, bit for bit against the code they replaced
# ---------------------------------------------------------------------------


def _parent_moe_apply(p, x, cfg):
    """``models.moe.moe_apply`` (one device) as it was before the expert
    share: routing and capacity over ``cfg.num_experts``."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C_ = max(1, int(S * k / E * cfg.capacity_factor))
    logits = MOE.router_logits(x, p.router).float()
    gates = torch.softmax(logits, dim=-1)
    topv, topi = MOE.top_k(gates, k)
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    me = gates.mean(dim=(0, 1))
    ce = F.one_hot(topi[..., 0], E).float().mean(dim=(0, 1))
    aux = {"load_balance": E * torch.sum(me * ce),
           "router_z": torch.mean(torch.logsumexp(logits, -1) ** 2)}
    flat_e = topi.reshape(B, S * k)
    onehot = F.one_hot(flat_e, E).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    pos_in_e = torch.gather(pos, -1, flat_e[..., None])[..., 0]
    keep = pos_in_e < C_
    pos_in_e = torch.clamp_max(pos_in_e, C_ - 1)
    w_flat = topv.reshape(B, S * k) * keep.float()
    src = x.repeat_interleave(k, dim=1) * keep[..., None].to(x.dtype)
    dispatched = MOE.dispatch_local(src, flat_e, pos_in_e, E, C_).to(x.dtype)
    gi = torch.einsum("gecd,edf->gecf", dispatched, p.wi.to(x.dtype))
    up = torch.einsum("gecd,edf->gecf", dispatched, p.wu.to(x.dtype))
    eo = torch.einsum("gecf,efd->gecd", L.silu(gi) * up, p.wd.to(x.dtype))
    gathered = MOE.combine_local(eo.to(x.dtype), flat_e, pos_in_e)
    gathered = gathered * w_flat[..., None].to(x.dtype)
    return gathered.reshape(B, S, k, D).sum(dim=2), aux


def _parent_ssm_block_apply(p, x, cfg, backend):
    """``models.ssm._ssm_block_apply`` as it was before the mixer was split
    from its norm and residual add."""
    h_in = L.rms_norm(x, p.ln, cfg.norm_eps)
    xin, z, Bc, Cc, dt = SSM._ssm_pre(p, h_in, cfg)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    conv_out = F.silu(SSM._causal_conv(conv_in, p.conv_w.to(x.dtype),
                                       p.conv_b.to(x.dtype)))
    di, n = cfg.d_inner, cfg.ssm_state
    xin, Bc, Cc = conv_out.split([di, n, n], dim=-1)
    H, P_ = cfg.ssm_heads, cfg.ssm_head_dim
    S = x.shape[1]
    Xh = split_heads(xin, H, P_)
    A = -torch.exp(p.A_log)
    Adt = (dt * A).float()
    Xdt = Xh * dt[..., None].to(Xh.dtype)
    Y = SSM.ssd_y(Xdt, Adt, Bc, Cc, min(cfg.ssm_chunk, S), backend)
    Y = Y + Xh * p.D.to(Xh.dtype)[None, None, :, None]
    y = merge_heads(Y)
    y = L.rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    return x + (y @ p.w_out.to(x.dtype)).to(x.dtype)


def _same_bits(fn_new, fn_old, module, x):
    """Outputs and the gradients of x and of every parameter, equal bit for
    bit."""
    outs = []
    for fn in (fn_new, fn_old):
        module.zero_grad(set_to_none=True)
        xi = x.detach().clone().requires_grad_(True)
        out = fn(xi)
        y = out[0] if isinstance(out, tuple) else out
        extra = sum(v for v in out[1].values()) if isinstance(out, tuple) \
            else 0.0
        (y.float().square().sum() + extra).backward()
        outs.append((out, xi.grad, {n: q.grad.clone() for n, q in
                                    module.named_parameters()}))
    (a, ga, pa), (b, gb, pb) = outs
    if isinstance(a, tuple):
        assert torch.equal(a[0], b[0])
        assert all(torch.equal(a[1][k], b[1][k]) for k in a[1])
    else:
        assert torch.equal(a, b)
    assert torch.equal(ga, gb)
    assert set(pa) == set(pb) and all(torch.equal(pa[n], pb[n]) for n in pa)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dbrx_moe_layer_is_the_parents_bit_for_bit(dtype):
    cfg = CB.get_config("dbrx-132b", smoke=True)
    assert cfg.num_router_experts == cfg.num_experts
    g = torch.Generator().manual_seed(11)
    p = MOE.MoEParams(cfg.d_model, cfg.d_ff, cfg.num_experts)
    p.reset_parameters(g)
    p.requires_grad_(True)
    assert tuple(p.router.shape) == (cfg.d_model, cfg.num_experts)
    x = torch.randn(2, 64, cfg.d_model, generator=g).to(dtype)
    _same_bits(lambda t: MOE.moe_apply(p, t, cfg),
               lambda t: _parent_moe_apply(p, t, cfg), p, x)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mamba_block_is_the_parents_bit_for_bit(dtype):
    cfg = CB.get_config("mamba2-130m", smoke=True)
    g = torch.Generator().manual_seed(12)
    p = SSM.SSMBlock(cfg)
    p.reset_parameters(g)
    p.requires_grad_(True)
    x = torch.randn(2, 64, cfg.d_model, generator=g).to(dtype)
    _same_bits(lambda t: SSM._ssm_block_apply(p, t, cfg, "auto"),
               lambda t: _parent_ssm_block_apply(p, t, cfg, "auto"), p, x)


# ---------------------------------------------------------------------------
# the softmax scale of the attention kernel's op
# ---------------------------------------------------------------------------


def _qkv(dtype=torch.float32, B=2, S=96, H=4, KV=2, D=16, seed=7):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B, S, n, D, generator=g).to(dtype)
            for n in (H, KV, KV)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_default_scale_is_the_same_computation(dtype):
    q, k, v = _qkv(dtype)
    op = torch.ops.repro_torch.flash_attention
    assert torch.equal(op(q, k, v), op(q, k, v, 1.0 / math.sqrt(16)))
    assert torch.equal(fa.flash_attention(q, k, v),
                       fa.flash_attention(q, k, v, scale=None))
    assert torch.equal(reference_attention(q, k, v),
                       reference_attention(q, k, v, 1.0 / math.sqrt(16)))


def test_another_scale_matches_the_reference_with_that_scale():
    """float32: the op's plain version (materialised scores) and the
    reference's blockwise attention agree to rounding at scale 1/16, and
    differ from the default scale; the backward recomputes the reference
    with the same scale."""
    q, k, v = _qkv()
    s = 1.0 / 16
    got = torch.ops.repro_torch.flash_attention(q, k, v, s)
    want = reference_attention(q, k, v, s)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert float((got - reference_attention(q, k, v)).abs().max()) > 1e-2
    qs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*qs, scale=s)
    out.square().sum().backward()
    rs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    reference_attention(*rs, s).square().sum().backward()
    for a, b in zip(qs, rs):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernel has no CPU mode")
    return "cuda"


@pytest.mark.cuda
def test_kernel_scale_on_the_card(card):
    """The kernel launched with the default scale and with 1/sqrt(D) gives
    the same bits; at 1/D it matches the plain version at 1/D within 2**-6
    (four units of bf16 roundoff, ``chip_smoke.py`` phase 21's bar) of
    each element's terms' magnitude (the plain version on |v|) and its
    own."""
    for D in (128, 16):
        q, k, v = (t.to(card) for t in _qkv(torch.bfloat16, S=256, D=D))
        before = fa.launches["flash_attention"]
        a = fa.kernel_forward(q, k, v)
        b = fa.kernel_forward(q, k, v, scale=1.0 / math.sqrt(D))
        assert fa.launches["flash_attention"] == before + 2
        assert torch.equal(a, b)
        got = fa.kernel_forward(q, k, v, scale=1.0 / D)
        want = fa.flash_attention_ref(q.float(), k.float(), v.float(),
                                      1.0 / D)
        mag = fa.flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                     1.0 / D)
        err = (got.float() - want).abs()
        assert bool((err <= 2.0 ** -6 * (mag + want.abs())).all()), \
            float((err / (mag + want.abs())).max())


# ---------------------------------------------------------------------------
# the registry, the parameter count, the dry-run
# ---------------------------------------------------------------------------


def test_registry_and_parameter_count():
    assert "granite_4_0_h_small" in CB.ARCH_IDS
    full = CB.get_config("granite-4.0-h-small")
    assert (full.num_layers, full.num_experts, full.num_router_experts) \
        == (40, 72, 72)
    assert [i for i in range(40) if full.hybrid_pattern[i % 10]
            == "attention"] == [5, 15, 25, 35]
    assert full.param_count() == 32_207_337_984
    cut = dataclasses.replace(full, num_layers=10, num_experts=9,
                              router_experts=72)
    # 9 Mamba layers of 102.3 M, 1 attention layer of 41.9 M, each layer's
    # 9 held experts 84.9 M, router 0.29 M, shared expert 18.9 M, norms;
    # the tied table 411.0 M
    assert cut.param_count() == 2_414_692_992
    for cfg in (full, cut, CB.get_config("granite-4.0-h-small", smoke=True)):
        built = M.build(cfg, device="meta")
        assert sum(p.numel() for p in built.parameters()) == cfg.param_count()


def test_full_config_places_on_the_production_meshes():
    """The 40-layer configuration (every expert held) on ``device="meta"``:
    every parameter names its axes, and each takes a placement on the
    16x16 and 2x16x16 production meshes; 72 experts do not divide the
    16-wide model axis, so the experts take the ``ffn`` partition."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_abstract_mesh
    model = M.build(CB.get_config("granite-4.0-h-small"), device="meta")
    params = dict(model.named_parameters())
    axes = M.param_axes(model)
    SH.validate_axes(params, axes)
    assert axes["blocks.0.moe.wi"] == ("expert_ffn", "embed", "mlp")
    assert axes["blocks.5.attn.wq"] == ("embed", "heads", "head_dim")
    for shape, names in (((16, 16), ("data", "model")),
                         ((2, 16, 16), ("pod", "data", "model"))):
        pl = SH.tree_param_shardings(axes, make_abstract_mesh(shape, names),
                                     params)
        assert set(pl) == set(params)
        assert all(len(v) == len(shape) for v in pl.values())


def test_one_card_prediction_at_the_smoke_size():
    from repro_torch.launch import dryrun as DR
    from repro_torch.train import optimizer as OPT
    cfg = CB.get_config("granite-4.0-h-small", smoke=True)
    rec = DR.one_card_train(cfg, OPT.OptHParams(), 2, 64, device="cpu")
    # float32 parameters and two float32 moments, the int32 step, two
    # int32 (2, 64) arrays
    assert rec["argument_bytes"] == (12 * cfg.param_count() + 4
                                     + 2 * 2 * 64 * 4)
    # the gradients alone are 4 bytes a parameter
    assert rec["temp_bytes"] > 4 * cfg.param_count()
    assert rec["flops"] > 6 * 2 * 64 * cfg.param_count() / 10


_MESH_SCRIPT = r"""
import dataclasses, json, sys
sys.path.insert(0, "src")
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import base as CB
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_fake_mesh

mesh = make_fake_mesh((4, 2), ("data", "model"), device="cpu")
# every expert held: the mesh takes the MoE's existing sharding
cfg = dataclasses.replace(CB.get_config("granite-4.0-h-small", smoke=True),
                          num_experts=8)
out = {}
for kind in ("train", "prefill"):
    with FakeTensorMode():
        spec = ST.build_cell(cfg, CB.ShapeConfig("t", 64, 8, kind), mesh)
        c = DR.count_step(spec, mesh)
    out[kind] = {"flops": c.summary.flops, "coll": c.summary.collective_bytes,
                 "flash": c.kernel_nodes("flash_attention"),
                 "ssd": c.kernel_nodes("ssd_scan"), "temp": c.peak_bytes}
print(json.dumps(out))
"""


def test_uncut_smoke_cells_trace_on_a_fake_4x2_mesh():
    """With every expert held the family takes the dry-run's mesh: the
    train and prefill steps trace on a fake (4, 2) mesh (in a subprocess:
    the process group stays there), one flash node per attention layer and
    one SSD node per Mamba layer in a forward, twice in a train step
    (remat)."""
    import json
    import os
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", _MESH_SCRIPT],
                         capture_output=True, text=True, cwd=root, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert (rec["prefill"]["flash"], rec["prefill"]["ssd"]) == (1, 3)
    assert (rec["train"]["flash"], rec["train"]["ssd"]) == (2, 6)
    assert rec["train"]["coll"] > 0 and rec["train"]["temp"] > 0
    assert ("granite_4_0_h_small", "train_4k") in CB.cells()
    assert ("granite_4_0_h_small", "decode_32k") not in CB.cells()
