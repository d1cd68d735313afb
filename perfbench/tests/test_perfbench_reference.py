"""The plain reference against ``repro_torch`` at the SMOKE sizes on the
CPU: the same parameters by name and shape at the published sizes, the
SSD by chunks against the step-by-step recurrence, and the first
training steps of each cell in float32, where the two must agree to
rounding."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from perfbench.tests._small import ARCH, cells, small
from perfbench.lib import catalog, cell as CELL, compare
from perfbench.reference import common as C
from perfbench.reference import ssm as RSSM
from perfbench.reference import train as RT


@pytest.mark.parametrize("name", sorted(ARCH))
def test_parameters_are_the_ports_at_full_size(name):
    from repro_torch.models import model as M
    m = catalog.config(name)["model"]
    port = {k: tuple(p.shape) for k, p in
            M.build(CELL.model_config(m), device="meta").named_parameters()}
    ours = {n: tuple(shape) for n, shape, _ in
            RT.family(m["family"]).param_specs(m)}
    assert ours == port


def test_ssd_by_chunks_is_the_recurrence():
    g = torch.Generator().manual_seed(3)
    b, S, H, P, N = 2, 96, 3, 4, 5
    X = torch.randn(b, S, H, P, generator=g, dtype=torch.float64)
    A = -torch.rand(b, S, H, generator=g, dtype=torch.float64)
    B = torch.randn(b, S, N, generator=g, dtype=torch.float64)
    Cm = torch.randn(b, S, N, generator=g, dtype=torch.float64)
    h = torch.zeros(b, H, P, N, dtype=torch.float64)
    ys = []
    for t in range(S):
        h = h * torch.exp(A[:, t])[..., None, None] \
            + torch.einsum("bhp,bn->bhpn", X[:, t], B[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    want = torch.stack(ys, 1)
    for chunk in (32, 96):
        got = RSSM.ssd(X, A, B, Cm, chunk, "float32")
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


def test_weights_are_drawn_by_group_from_the_seed():
    m = catalog.config("mamba2-130m")["model"]
    m = dict(m, num_layers=2, d_model=32, ssm_state=16, ssm_head_dim=16,
             vocab_size=100)
    specs = RSSM.param_specs(m)
    big = 2 ** 31 + 977
    a = C.init_params(specs, big, "cpu")
    b = C.init_params(specs, big, "cpu", only=("blocks.*.w_x",))
    assert set(b) == {"blocks.0.w_x", "blocks.1.w_x"}
    assert torch.equal(a["blocks.1.w_x"], b["blocks.1.w_x"])
    assert not torch.equal(a["blocks.0.w_x"], a["blocks.1.w_x"])
    c = C.init_params(specs, big + 1, "cpu", only=("blocks.*.w_x",))
    assert not torch.equal(a["blocks.0.w_x"], c["blocks.0.w_x"])
    dt = torch.nn.functional.softplus(a["blocks.0.b_dt"])
    assert bool(((dt >= 1e-3 * 0.999) & (dt <= 0.1 * 1.001)).all())


@pytest.mark.parametrize("cell", cells())
def test_reference_follows_the_program_in_float32(cell):
    """The port's train steps in float32 (the model's products in float32,
    TF32 off) against the reference: every number within 1e-5, capacity
    drops, router auxiliaries, accumulation and AdamW included."""
    conf, traffic = small(cell, dtype="float32")
    seed = 2 ** 31 + 11
    trainer = CELL.build_program(torch, conf, traffic, seed, "cpu")
    prog = CELL.program_readings(torch, trainer, conf, seed,
                                 traffic["compare_steps"], "cpu")
    ref = CELL.reference_readings(conf, traffic, seed,
                                  traffic["compare_steps"], "cpu")
    nums = compare.numbers(prog, ref)
    assert max(nums[k] for k in compare.NUMBERS) < 1e-5, nums
    np.testing.assert_allclose(prog["grad_norm"], ref["grad_norm"], rtol=1e-5)


def test_moe_cell_drops_choices_at_the_smoke_size():
    """The MoE reference's capacity drops choices at the SMOKE size, so the
    float32 agreement above covers the drops."""
    from perfbench.reference import moe as RMOE
    conf, traffic = small("dbrx-132b.train", dtype="float32")
    m = conf["model"]
    params = C.init_params(RMOE.param_specs(m), 5, "cpu")
    from perfbench.lib.traffic import TokenBatches
    tokens = torch.from_numpy(TokenBatches(traffic, m["vocab_size"], 5)
                              .batch_at(0)["tokens"])
    x = params["embed.tok"][tokens.long()]
    p = RMOE._layers(params, m)[0]
    _, h = RMOE._attention_half(x, p, m, "float32")
    *_, keep = RMOE._route(h, p, m, "float32")
    assert 0 < int((~keep).sum()) < keep.numel()
    assert dataclasses.is_dataclass(CELL.model_config(m))
